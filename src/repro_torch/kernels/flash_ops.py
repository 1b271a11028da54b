"""Dispatch for flash attention; the model layer calls this when
``attn_impl="pallas"``.

The counterpart of ``src/repro/kernels/flash_ops.py``.  CUDA tensors go
to the kernel at every sequence length (it bounds-checks a ragged last
tile, so there is no fallback for S that no block divides); CPU tensors
go to the plain version; any other device raises.
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
) -> torch.Tensor:
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, causal, window, logit_soft_cap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, logit_soft_cap)
    raise ValueError(f"no flash-attention path for device {q.device}")
