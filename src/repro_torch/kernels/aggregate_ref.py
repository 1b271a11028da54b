"""Plain PyTorch version of the aggregation kernel.

The counterpart of ``src/repro/kernels/aggregate_ref.py``.  The CPU
branch of ``aggregate_ops`` uses it, and the tests and ``chip_smoke.py``
hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def aggregate_flat_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_k w[k] x[k, n], accumulated in fp32, in ``x.dtype``."""
    return (w.float() @ x.float()).to(x.dtype)


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance between two bfloat16 tensors in units in the
    last place: the number of representable bfloat16 values from one to
    the other (+0 and -0 are the same value)."""

    def ordered(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)

    return (ordered(a) - ordered(b)).abs()
