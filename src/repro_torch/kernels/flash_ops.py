"""Dispatch for flash attention; the model layer calls this when
``attn_impl="pallas"``.

The counterpart of ``src/repro/kernels/flash_ops.py``.  CUDA tensors go
to the kernel at every sequence length (it bounds-checks a ragged last
tile, so there is no fallback for S that no block divides); CPU tensors
go to the plain version; any other device raises.

The kernel has no backward pass (nor has the reference's), and it
launches outside autograd, so a backward pass through it would drop
the attention's gradients without a word.  Under grad mode, with an
input that requires grad, the dispatch raises on every device instead:
training runs ``attn_impl="xla"`` or ``"chunked"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash import flash_attention as _flash_kernel
from repro_torch.kernels.flash_ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward pass: train with attn_impl='xla' or "
            "'chunked', or call it under torch.no_grad()"
        )
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, causal, window, logit_soft_cap, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, logit_soft_cap, scale)
    raise ValueError(f"no flash-attention path for device {q.device}")
