"""Plain PyTorch versions of the Mamba2 block's fused elementwise chains.

Each is the chain the block ran before the kernels of
``csrc/mamba_fused.cu``, through the block's own pieces
(``mamba2._causal_conv``, ``nn.apply_rmsnorm``), operation for
operation: the CPU branch of ``mamba_fused_ops`` runs them, so a CPU
prefill computes what it computed before, to the bit, and the block's
training and decode routes run ``gated_rmsnorm_ref`` for both its norms.
The card tests and ``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import mamba2, nn


def causal_conv_silu_ref(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu of the causal conv of ``xbc`` (B, S, C) from a zero history."""
    return F.silu(mamba2._causal_conv(xbc, w, b)[0])


def gated_rmsnorm_ref(y: torch.Tensor, scale: torch.Tensor, x: Optional[torch.Tensor] = None,
                      D: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                      eps: float = 1e-6, group_size: Optional[int] = None) -> torch.Tensor:
    """rmsnorm((y + D[head] * x) * silu(z)) * scale over each group of
    ``group_size`` columns (the whole row where None) of the last axis of
    ``y`` (B, S, E); the skip and the gate left out where None."""
    if x is not None:
        bsz, s, e = y.shape
        h = D.shape[0]
        y = y.reshape(bsz, s, h, e // h)
        y = y + D[None, None, :, None].to(y.dtype) * x.reshape(bsz, s, h, e // h)
        y = y.reshape(bsz, s, e)
    if z is not None:
        y = y * F.silu(z)
    if group_size is not None and group_size != y.shape[-1]:
        groups = y.reshape(*y.shape[:-1], -1, group_size)
        out = nn.apply_rmsnorm({"scale": scale.reshape(-1, group_size)}, groups, eps)
        return out.reshape(y.shape)
    return nn.apply_rmsnorm({"scale": scale}, y, eps)
