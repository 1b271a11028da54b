"""Dispatch for the SSD scan; the Mamba2 block calls this when
``ssd_impl="pallas"``.

The counterpart of ``src/repro/kernels/ssd_ops.py``, without its two
faults: CUDA tensors go to the kernel at every sequence length, in one
launch that gives y and the final state (the reference recomputes the
final state with a second full pass, and for S that the chunk does not
divide calls a chunked scan that asserts).  CPU tensors go to the plain
chunked scan, with a ragged tail padded by exact no-op steps
(``ssd_ref.ssd_padded``).  Any other device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd import ssd_scan as _ssd_kernel
from repro_torch.kernels.ssd_ref import ssd_padded


def ssd(x, dt, A, Bm, Cm, chunk: int = 128,
        initial_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,H,P), final_state (B,H,P,N) float32) of the SSD scan."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if x.device.type == "cuda":
        return _ssd_kernel(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    if x.device.type == "cpu":
        return ssd_padded(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    raise ValueError(f"no SSD path for device {x.device}")
