"""Architecture registry: --arch <id> -> config + model factory.

The counterpart of ``src/repro/configs/registry.py``.  Importing it
imports no model module: ``build_model`` imports the one it builds.
Every family is ported.
"""
from __future__ import annotations

import importlib
from typing import Any, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
}

ARCH_IDS = tuple(_MODULES)

def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).smoke_config()


def build_model(
    cfg: ArchConfig,
    *,
    attn_impl: str = "xla",
    ssd_impl: str = "xla",
    dtype: Optional[torch.dtype] = None,
    sliding_window: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Any:
    """Instantiate the model class for a config, on ``device`` (None:
    CUDA, which raises without a card).

    sliding_window: pass cfg.sliding_window to build the sub-quadratic
    long-context variant.
    """
    dtype = dtype or torch.bfloat16
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import Transformer

        return Transformer(cfg, attn_impl=attn_impl, dtype=dtype,
                           sliding_window=sliding_window, device=device)
    if cfg.family == "audio":
        from repro_torch.models.transformer import EncoderDecoder

        return EncoderDecoder(cfg, attn_impl=attn_impl, dtype=dtype,
                              sliding_window=sliding_window, device=device)
    if cfg.family == "ssm":
        from repro_torch.models.mamba2 import Mamba2Model

        return Mamba2Model(cfg, dtype=dtype, ssd_impl=ssd_impl, device=device)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import Zamba2Model

        return Zamba2Model(cfg, dtype=dtype, attn_impl=attn_impl, ssd_impl=ssd_impl,
                           sliding_window=sliding_window, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")
