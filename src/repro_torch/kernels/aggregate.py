"""CUDA kernel: weighted model aggregation (FedLEO eqs. 4/9).

``aggregate_flat(x, w)`` computes out[n] = sum_k w[k] * x[k, n] for K
stacked flattened parameter vectors, accumulating in fp32 and writing
``x.dtype``.  It launches ``csrc/aggregate.cu`` (the port of the Pallas
kernel ``src/repro/kernels/aggregate.py::aggregate_flat``) on the
current CUDA stream; the library is built with ``nvcc`` at first use
(``kernels/build.py``).  The kernel is memory-bound: it moves
(K + 1) * N * sizeof(dtype) bytes.

The wrapper takes CUDA tensors only and raises on anything the kernel
does not take; the plain version is ``aggregate_ref.aggregate_flat_ref``.
``aggregate_flat.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SYMBOLS = {torch.float32: "aggregate_flat_f32",
            torch.bfloat16: "aggregate_flat_bf16"}
_fns: dict = {}


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        lib = build.load("aggregate")
        fn = getattr(lib, _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.aggregate_error_string.argtypes = [ctypes.c_int]
        lib.aggregate_error_string.restype = ctypes.c_char_p
        _fns[dtype] = fn
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"aggregate_flat runs on CUDA tensors, got x on {x.device}; "
            "the plain version is aggregate_ref.aggregate_flat_ref"
        )
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"aggregate_flat takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] < 2**31:
        raise ValueError(f"x must be (K, N) with 1 <= K < 2^31, got {tuple(x.shape)}")
    if w.dtype != torch.float32 or w.shape != (x.shape[0],):
        raise ValueError(
            f"w must be float32 of shape ({x.shape[0]},), got "
            f"{w.dtype} {tuple(w.shape)}"
        )
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def aggregate_flat(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the leading axis of a (K, N) CUDA tensor;
    returns (N,) in ``x.dtype``."""
    _check(x, w)
    k, n = x.shape
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n, stream)
    if err != 0:
        msg = build.load("aggregate").aggregate_error_string(err).decode()
        raise RuntimeError(f"aggregate_flat launch failed: {msg} ({err})")
    aggregate_flat.launches += 1
    return out


aggregate_flat.launches = 0   # type: ignore[attr-defined]
