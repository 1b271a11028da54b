"""CUDA kernel: the Mamba2 SSD chunked scan.

``ssd_scan(x, dt, A, Bm, Cm, chunk, initial_state)`` runs the SSD
recurrence over x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)`` and
B, C ``(B, S, G, N)``, head ``h`` reading the B/C group
``h // (H // G)``, from ``initial_state`` ``(B, H, P, N)`` (zeros when
None), and returns ``(y, final_state)``: y ``(B, S, H, P)`` in x's type
and the float32 final state, both from one launch.  It launches
``csrc/ssd.cu`` (the port of the Pallas kernel
``src/repro/kernels/ssd.py::ssd_scan``) on the current CUDA stream; the
library is built with ``nvcc`` at first use (``kernels/build.py``).
x, dt, B and C are read in place through their strides (the last axis
must be contiguous), at any S.  The kernel walks the sequence in tiles
of 64 steps whatever ``chunk`` is: the result does not depend on the
chunking beyond rounding.

The dtype picks the kernel (``KERNELS``): bfloat16 runs on the tensor
cores (``ssd_scan_tc_kernel``, rows of x, B and C on 16-byte
boundaries: strides a multiple of 8 elements and 16-byte aligned
pointers), float32 on the CUDA cores (``ssd_scan_kernel``).

The wrapper takes CUDA tensors only and raises on anything the kernel
does not take; the plain version is ``ssd_ref.ssd_ref``.
``ssd_scan.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64)
MAX_STATE_DIM = 128
_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
# the device kernel each dtype launches, as a profiler names it
KERNELS = {torch.float32: "ssd_scan_kernel", torch.bfloat16: "ssd_scan_tc_kernel"}
# bytes a row start of x, B and C must be aligned to
_ROW_ALIGN = {torch.float32: 4, torch.bfloat16: 16}
_fns: dict = {}


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        lib = build.load("ssd")
        fn = getattr(lib, _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _fns[dtype] = fn
    return fn


def _check(x, dt, A, Bm, Cm, chunk, initial_state) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"ssd_scan runs on CUDA tensors, got x on {x.device}; "
            "the plain version is ssd_ref.ssd_ref"
        )
    others = [dt, A, Bm, Cm] + ([] if initial_state is None else [initial_state])
    if any(t.device != x.device for t in others):
        raise ValueError("x, dt, A, Bm, Cm and initial_state must lie on one device")
    if x.dtype not in _SYMBOLS or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(
            "ssd_scan takes float32 or bfloat16 x, Bm and Cm of one type, "
            f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}"
        )
    if dt.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt, got {dt.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(
            "x must be (B, S, H, P), dt (B, S, H) and Bm, Cm (B, S, G, N), got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}"
        )
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (b, s, h) or Bm.shape[:2] != x.shape[:2] or h % g != 0:
        raise ValueError(
            f"dt {tuple(dt.shape)} and Bm {tuple(Bm.shape)} do not fit x "
            f"{tuple(x.shape)} (need H % G == 0)"
        )
    if tuple(A.shape) != (h,):
        raise ValueError(f"A must be ({h},), got {tuple(A.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan takes head_dim P in {HEAD_DIMS}, got {p}")
    if not 1 <= n <= MAX_STATE_DIM:
        raise ValueError(f"ssd_scan takes state_dim N up to {MAX_STATE_DIM}, got {n}")
    if not (1 <= b < 2**16 and 1 <= h < 2**16 and 1 <= s < 2**31):
        raise ValueError(f"shape {tuple(x.shape)} is outside the kernel's grid")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    align = _ROW_ALIGN[x.dtype]
    elems = align // x.element_size()
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along its last axis")
        if any(st % elems for st in t.stride()[:3]) or t.data_ptr() % align:
            raise ValueError(f"{name}'s rows must start on {align}-byte boundaries")
    if initial_state is not None and (
            tuple(initial_state.shape) != (b, h, p, n)
            or initial_state.dtype != torch.float32):
        raise ValueError(
            f"initial_state must be float32 ({b}, {h}, {p}, {n}), got "
            f"{initial_state.dtype} {tuple(initial_state.shape)}"
        )


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of CUDA tensors; returns (y, final_state): y a
    contiguous (B, S, H, P) tensor in ``x.dtype``, the final state a
    float32 (B, H, P, N) tensor."""
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    a32 = A.to(torch.float32).contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a32.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), None if init is None else init.data_ptr(),
                 y.data_ptr(), final.data_ptr(),
                 b, s, h, g, p, n,
                 *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
                 stream)
    if err != 0:
        msg = build.load("ssd").ssd_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({err})")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0   # type: ignore[attr-defined]
