"""Dispatch for the Mamba2 block's fused elementwise chains; the block
calls these on its prefill with ``ssd_impl="pallas"``, the route on
which it runs the SSD kernel.

CUDA tensors go to the kernels (``mamba_fused``); CPU tensors go to the
plain chains (``mamba_fused_ref``), which compute what the block
computed before the kernels, to the bit.  Any other device raises.

The kernels have no backward pass and launch outside autograd, so a
backward pass through them would drop the gradients without a word.
Under grad mode, with an input that requires grad, the dispatch raises
on every device instead: training runs ``ssd_impl="xla"``, which never
reaches it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import mamba_fused
from repro_torch.kernels.mamba_fused_ref import causal_conv_silu_ref, gated_rmsnorm_ref


def _route(name: str, *tensors: Optional[torch.Tensor]) -> str:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward pass: train with ssd_impl='xla', "
            "or call it under torch.no_grad()"
        )
    kind = tensors[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no {name} path for device {tensors[0].device}")
    return kind


def causal_conv_silu(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu of the causal depthwise conv of ``xbc`` (B, S, C), taps ``w``
    (W, C), bias ``b`` (C,), from a zero history."""
    if _route("causal_conv_silu", xbc, w, b) == "cuda":
        return mamba_fused.causal_conv_silu(xbc, w, b)
    return causal_conv_silu_ref(xbc, w, b)


def gated_rmsnorm(y: torch.Tensor, scale: torch.Tensor, x: Optional[torch.Tensor] = None,
                  D: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                  eps: float = 1e-6, group_size: Optional[int] = None) -> torch.Tensor:
    """rmsnorm((y + D[head] * x) * silu(z)) * scale over each group of
    ``group_size`` columns (the whole row where None) of the last axis
    of ``y`` (B, S, E); without x, D and z the plain RMSNorm.  ``eps`` as
    ``nn.apply_rmsnorm``'s."""
    if _route("gated_rmsnorm", y, scale, x, D, z) == "cuda":
        return mamba_fused.gated_rmsnorm(y, scale, x, D, z, eps, group_size)
    return gated_rmsnorm_ref(y, scale, x, D, z, eps, group_size)
