"""``ArchConfig`` with the fields of the port's own configurations.

``configs/base.py`` is a verbatim copy of the JAX package's schema, so a
field that only the port's models read lives here, on a subclass whose
defaults are what the shared models did before the field existed: a
model reads them with ``getattr(cfg, name, default)`` through the
helpers below, and an ``ArchConfig`` of the JAX package's registry runs
as it always did.

  * ``rms_norm_eps``: every RMSNorm's epsilon (1e-6, the JAX package's).
  * ``hybrid_layer_ids``: the layers of a Zamba2 stack before which a
    shared transformer block runs, in the published layout
    [arXiv:2411.15242]; empty for the JAX package's layout (one shared
    block every ``hybrid_attn_every`` Mamba layers).  With it,
    ``num_mem_blocks`` shared blocks are used in turn, each use with its
    own rank-``adapter_rank`` adapter on the MLP's gate and up product
    and its own output linear (``models/hybrid.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ArchConfig

DEFAULT_RMS_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ExtendedArchConfig(ArchConfig):
    rms_norm_eps: float = DEFAULT_RMS_NORM_EPS
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0


def rms_norm_eps(cfg: ArchConfig) -> float:
    return getattr(cfg, "rms_norm_eps", DEFAULT_RMS_NORM_EPS)


def hybrid_layer_ids(cfg: ArchConfig) -> Tuple[int, ...]:
    return tuple(getattr(cfg, "hybrid_layer_ids", ()))
