"""CUDA kernel: grouped-query flash attention, forward.

``flash_attention(q, k, v, causal, window, logit_soft_cap, scale)``
computes softmax attention for q ``(B, S, H, D)`` over k, v
``(B, S, G, D)``, query head ``h`` reading key/value head
``h // (H // G)``, the scores scaled by ``scale`` (D^-1/2 where None),
with an optional causal mask, sliding window (``q - k < window``) and
tanh logit soft-cap; scores, running max, denominator and accumulator are
float32 and the output is ``q.dtype``.  It launches ``csrc/flash.cu``
(the port of the Pallas kernel
``src/repro/kernels/flash.py::flash_attention``) on the current CUDA
stream; the library is built with ``nvcc`` at first use
(``kernels/build.py``).  q, k and v are read in place through their
strides (the last axis must be contiguous), at any S.

The dtype picks the kernel (``KERNELS``): bfloat16 runs on the tensor
cores (``flash_fwd_tc_kernel``, rows on 16-byte boundaries: strides a
multiple of 8 elements and 16-byte aligned pointers), float32 on the
CUDA cores (``flash_fwd_kernel``).

The wrapper takes CUDA tensors only and raises on anything the kernel
does not take; the plain version is ``flash_ref.flash_attention_ref``.
``flash_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 112, 128, 224, 256)
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
# the device kernel each dtype launches, as a profiler names it
KERNELS = {torch.float32: "flash_fwd_kernel", torch.bfloat16: "flash_fwd_tc_kernel"}
# bytes a row start must be aligned to
_ROW_ALIGN = {torch.float32: 4, torch.bfloat16: 16}
_fns: dict = {}


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        lib = build.load("flash")
        fn = getattr(lib, _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        _fns[dtype] = fn
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], logit_soft_cap: Optional[float],
           scale: Optional[float]) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention runs on CUDA tensors, got q on {q.device}; "
            "the plain version is flash_ref.flash_attention_ref"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention takes float32 or bfloat16 q, k and v of one type, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "q must be (B, S, H, D) and k, v (B, S, G, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    g = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % g != 0:
        raise ValueError(
            f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} (need H % G == 0)"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, got {d}")
    if not (1 <= b < 2**16 and 1 <= h < 2**16 and 1 <= s < 2**31):
        raise ValueError(f"shape {tuple(q.shape)} is outside the kernel's grid")
    align = _ROW_ALIGN[q.dtype]
    elems = align // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along its last axis")
        if any(st % elems for st in t.stride()[:3]) or t.data_ptr() % align:
            raise ValueError(f"{name}'s rows must start on {align}-byte boundaries")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_soft_cap is not None and not logit_soft_cap > 0:
        raise ValueError(f"logit_soft_cap must be > 0, got {logit_soft_cap}")
    if scale is not None and not 0 < scale < float("inf"):
        raise ValueError(f"scale must be finite and > 0, got {scale}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of CUDA tensors q (B, S, H, D) over k, v (B, S, G, D);
    returns a contiguous (B, S, H, D) tensor in ``q.dtype``."""
    _check(q, k, v, window, logit_soft_cap, scale)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel_fn(q.dtype)
    # a window at least S long masks nothing; clamping keeps it an int32
    win = 0 if window is None else min(int(window), s)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, h, k.shape[2], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(bool(causal)), win,
                 0.0 if logit_soft_cap is None else float(logit_soft_cap),
                 0.0 if scale is None else float(scale), stream)
    if err != 0:
        msg = build.load("flash").flash_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # type: ignore[attr-defined]
