# Copied from src/repro/configs/__init__.py; imports rebound to repro_torch.
"""Assigned-architecture configs + registry."""
from repro_torch.configs.base import (
    ArchConfig,
    EncoderConfig,
    InputShape,
    INPUT_SHAPES,
    MoEConfig,
    SSMConfig,
    VisionStub,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    build_model,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.constellations import (
    CONSTELLATION_PRESETS,
    GROUND_STATION_PRESETS,
    get_constellation,
    get_ground_stations,
    make_sim_config,
)

__all__ = [
    "CONSTELLATION_PRESETS",
    "GROUND_STATION_PRESETS",
    "get_constellation",
    "get_ground_stations",
    "make_sim_config",
    "ArchConfig",
    "EncoderConfig",
    "InputShape",
    "INPUT_SHAPES",
    "MoEConfig",
    "SSMConfig",
    "VisionStub",
    "ARCH_IDS",
    "build_model",
    "get_config",
    "get_smoke_config",
]
