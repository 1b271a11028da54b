# Copied from src/repro/compute/profiles.py; imports rebound to repro_torch.
"""Device tiers + per-satellite compute/arch assignment.

``DeviceProfile`` describes one class of on-board accelerator by its
roofline axes (peak FLOP/s, HBM bandwidth) plus the achievable MFU and
the payload quantization of the models it ships.  The tiers span the
plausible orbital range: a cubesat flight computer, a Coral-class edge
TPU, an Orin-class radiation-tolerant GPU, and a full TPU-v5e-class
accelerator (matching ``benchmarks/roofline.py``'s constants).

``SatelliteComputeProfile`` assigns every plane — with optional
per-satellite overrides — a ``SatAssignment``: a device tier and a
model architecture from ``configs/registry``.  ``arch=None`` means the
paper's uniform eq. (11) timing for that satellite, so the all-default
profile is the exact degenerate case of an unset ``SimConfig.compute``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One on-board accelerator class, by its roofline axes."""

    name: str
    peak_flops: float            # peak FLOP/s (bf16-equivalent)
    hbm_bytes_per_s: float       # memory bandwidth, bytes/s
    mfu_fraction: float = 0.4    # achievable fraction of peak in training
    bits_per_param: int = 32     # payload quantization of shipped models

    def __post_init__(self) -> None:
        if self.peak_flops <= 0 or self.hbm_bytes_per_s <= 0:
            raise ValueError(
                f"device {self.name!r}: peak_flops and hbm_bytes_per_s "
                "must be > 0"
            )
        if not 0 < self.mfu_fraction <= 1:
            raise ValueError(
                f"device {self.name!r}: mfu_fraction must be in (0, 1]"
            )


# The orbital hardware ladder.  "orbital-tpu-v5e" matches the roofline
# constants in benchmarks/roofline.py (197 TFLOP/s bf16, 819 GB/s).
DEVICE_TIERS: Dict[str, DeviceProfile] = {
    "cubesat-cpu": DeviceProfile(
        "cubesat-cpu", peak_flops=8e9, hbm_bytes_per_s=12.8e9,
        mfu_fraction=0.6,
    ),
    "orbital-edge-tpu": DeviceProfile(
        "orbital-edge-tpu", peak_flops=2e12, hbm_bytes_per_s=25.6e9,
    ),
    "orbital-gpu": DeviceProfile(
        "orbital-gpu", peak_flops=40e12, hbm_bytes_per_s=204.8e9,
    ),
    "orbital-tpu-v5e": DeviceProfile(
        "orbital-tpu-v5e", peak_flops=197e12, hbm_bytes_per_s=819e9,
    ),
}

DEFAULT_DEVICE = "orbital-gpu"

# step-time estimation modes (compute.roofline):
#   analytic — FLOPs/bytes from the arch config's param counts,
#   compiled — XLA cost_analysis of the lowered smoke step (dryrun),
#   measured — wall-clock of one real jitted smoke step on this host
#              (repro.launch.calibrate; the optional calibration path).
MODES = ("analytic", "compiled", "measured")


@dataclasses.dataclass(frozen=True)
class SatAssignment:
    """One satellite's (or plane's) compute assignment.

    ``arch=None`` keeps the paper's uniform eq. (11) timing and payload
    for that satellite — the degenerate tier."""

    arch: Optional[str] = None
    device: str = DEFAULT_DEVICE

    def __post_init__(self) -> None:
        if self.arch is not None and self.arch not in ARCH_IDS:
            raise ValueError(
                f"unknown arch {self.arch!r}; have {sorted(ARCH_IDS)}"
            )
        if self.device not in DEVICE_TIERS:
            raise ValueError(
                f"unknown device tier {self.device!r}; "
                f"have {sorted(DEVICE_TIERS)}"
            )


@dataclasses.dataclass(frozen=True)
class SatelliteComputeProfile:
    """Fleet-wide assignment of device tiers + model archs.

    ``planes[p]`` is plane p's assignment; planes beyond the tuple get
    ``default``; ``sat_overrides`` pins individual (plane, slot)
    satellites.  ``shape`` names the ``INPUT_SHAPES`` training step the
    roofline prices; ``smoke=True`` sizes step costs and payloads from
    the scaled-down smoke configs (the realistic per-satellite shard —
    the full published configs exceed any single eq. 16 window), which
    the ``compiled``/``measured`` modes require (full-size configs
    cannot compile on a CPU host).  ``payload_from_arch`` additionally
    replaces the task's uniform payload with each arch's real
    param-count bits — off by default so enabling heterogeneous *time*
    alone leaves the comm model untouched."""

    planes: Tuple[SatAssignment, ...] = ()
    default: SatAssignment = SatAssignment()
    sat_overrides: Tuple[Tuple[int, int, SatAssignment], ...] = ()
    shape: str = "train_4k"
    mode: str = "analytic"
    smoke: bool = True
    payload_from_arch: bool = False
    bits_per_param: int = 32

    def __post_init__(self) -> None:
        if self.shape not in INPUT_SHAPES:
            raise ValueError(
                f"unknown input shape {self.shape!r}; "
                f"have {sorted(INPUT_SHAPES)}"
            )
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; have {MODES}"
            )
        if self.mode in ("compiled", "measured") and not self.smoke:
            raise ValueError(
                f"mode {self.mode!r} requires smoke=True: full-size "
                "configs cannot compile/run on this host"
            )

    def assignment(self, plane: int, slot: int = 0) -> SatAssignment:
        """The effective assignment of satellite (plane, slot)."""
        for p, s, a in self.sat_overrides:
            if p == plane and s == slot:
                return a
        if 0 <= plane < len(self.planes):
            return self.planes[plane]
        return self.default

    @classmethod
    def uniform(cls, **kwargs: Any) -> "SatelliteComputeProfile":
        """The degenerate profile: every satellite keeps the paper's
        eq. (11) timing (all assignments ``arch=None``)."""
        return cls(**kwargs)

    @classmethod
    def per_plane(
        cls,
        plane_archs: Sequence[Optional[str]],
        *,
        device: str = DEFAULT_DEVICE,
        **kwargs: Any,
    ) -> "SatelliteComputeProfile":
        """One arch per plane on a shared device tier (None entries
        keep the paper timing for that plane)."""
        planes = tuple(
            SatAssignment(arch=a, device=device) for a in plane_archs
        )
        return cls(planes=planes, **kwargs)
