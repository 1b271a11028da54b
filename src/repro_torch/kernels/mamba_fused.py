"""CUDA kernels: the Mamba2 block's elementwise chains on the prefill path.

``causal_conv_silu(xbc, w, b)`` (K4) is the depthwise causal convolution
of width 4 over the x|B|C channels ``(B, S, C)``, from a zero history,
plus the bias, through SiLU; ``gated_rmsnorm(y, scale, x, D, z, eps,
group_size)`` (K5) is ``rmsnorm((y + D[head] * x) * silu(z)) * scale``
over each group of ``group_size`` columns of the last axis of
``(B, S, E)`` (the whole row where None), with the skip (x and D) and
the gate (z) left out where they are None: with neither, the block's
input RMSNorm.  Each
launches one kernel of ``csrc/mamba_fused.cu`` on the current CUDA
stream and returns a new contiguous tensor in the input's type; the
library is built with ``nvcc`` at first use (``kernels/build.py``).
They replace no TPU kernel (the reference leaves these chains to XLA's
fusion); the plain versions are ``mamba_fused_ref``.

The inputs are read in place through their batch and sequence strides
(the last axis must be contiguous): in the block, x|B|C and z are column
ranges of the in_proj output and the skip is a column range of the
convolution's output.  Every row starts on a 16-byte boundary and every
width is a whole number of 16-byte vectors (8 bfloat16 or 4 float32); a
head of D covers whole vectors.  Activations are float32 or bfloat16.
The taps, the bias and D are used in the activations' type, as the plain
chain rounds them; the norm's scale in float32, as the plain norm
multiplies by it.  The wrappers take CUDA tensors only and raise on
anything the kernels do not take.  ``causal_conv_silu.launches`` and
``gated_rmsnorm.launches`` count the launches; ``gated_rmsnorm.norm_launches``
counts those of them with neither skip nor gate (the plain RMSNorm).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

CONV_WIDTH = 4      # every configuration's; the kernel's taps
# most 16-byte vectors of a normalised row: 8 per thread, 128 threads
MAX_ROW_VECTORS = 8 * 128
_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the device kernels, as a profiler names them
KERNELS = {"causal_conv_silu": "causal_conv_silu_kernel", "gated_rmsnorm": "gated_rmsnorm_kernel"}
_ALIGN = 16
_fns: dict = {}

_CONV_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]
_NORM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
                  + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])


def _kernel_fn(name: str, dtype: torch.dtype):
    fn = _fns.get((name, dtype))
    if fn is None:
        lib = build.load("mamba_fused")
        fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _CONV_ARGTYPES if name == "causal_conv_silu" else _NORM_ARGTYPES
        fn.restype = ctypes.c_int
        lib.mamba_fused_error_string.argtypes = [ctypes.c_int]
        lib.mamba_fused_error_string.restype = ctypes.c_char_p
        _fns[(name, dtype)] = fn
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = build.load("mamba_fused").mamba_fused_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _check_rows(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """A (B, S, width) activation read in place: on ``device`` in ``dtype``,
    the last axis contiguous, every row on a 16-byte boundary."""
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.stride(2) != 1:
        raise ValueError(f"{name} must be contiguous along its last axis")
    elems = _ALIGN // t.element_size()
    if t.stride(0) % elems or t.stride(1) % elems or t.data_ptr() % _ALIGN:
        raise ValueError(f"{name}'s rows must start on {_ALIGN}-byte boundaries")


def _check_input(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA tensors, got {t.device}; the plain version is "
            f"mamba_fused_ref.{name}_ref"
        )
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 activations, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name} takes (B, S, width) activations, got {tuple(t.shape)}")
    b, s, width = t.shape
    if not (1 <= b and 1 <= s and b * s < 2**31):
        raise ValueError(f"shape {tuple(t.shape)} is outside the kernel's grid")
    vec = _ALIGN // t.element_size()
    if width % vec:
        raise ValueError(f"{name}'s width {width} is not a whole number of {vec}-element "
                         "(16-byte) vectors")


def _param(name: str, p: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    """A per-channel parameter in ``dtype``, contiguous, 16-byte aligned."""
    if p.device != device:
        raise ValueError(f"{name} must lie on {device}, got {p.device}")
    if not p.is_floating_point():
        raise TypeError(f"{name} must be floating point, got {p.dtype}")
    if tuple(p.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(p.shape)}")
    p = p.to(dtype).contiguous()
    if p.data_ptr() % _ALIGN:
        raise ValueError(f"{name} must start on a {_ALIGN}-byte boundary")
    return p


def causal_conv_silu(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(causal depthwise conv of ``xbc`` (B, S, C) with taps ``w``
    (4, C) and bias ``b`` (C,)): a contiguous (B, S, C) tensor in
    ``xbc.dtype``."""
    _check_input("causal_conv_silu", xbc)
    bsz, s, c = xbc.shape
    _check_rows("xbc", xbc, xbc.shape, xbc.dtype, xbc.device)
    w = _param("w", w, (CONV_WIDTH, c), xbc.dtype, xbc.device)
    b = _param("b", b, (c,), xbc.dtype, xbc.device)
    out = torch.empty((bsz, s, c), dtype=xbc.dtype, device=xbc.device)
    fn = _kernel_fn("causal_conv_silu", xbc.dtype)
    with torch.cuda.device(xbc.device):
        stream = torch.cuda.current_stream(xbc.device).cuda_stream
        err = fn(xbc.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, c,
                 CONV_WIDTH, xbc.stride(0), xbc.stride(1), stream)
    _raise_on(err, "causal_conv_silu")
    causal_conv_silu.launches += 1
    return out


def gated_rmsnorm(y: torch.Tensor, scale: torch.Tensor, x: Optional[torch.Tensor] = None,
                  D: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                  eps: float = 1e-6, group_size: Optional[int] = None) -> torch.Tensor:
    """rmsnorm((y + D[head] * x) * silu(z)) * scale over each group of
    ``group_size`` columns (the whole row where None) of the last axis of
    ``y`` (B, S, E), head h of D (H,) covering columns h E/H .. (h+1) E/H
    of x; the skip (x with D) and the gate (z) are left out where None.
    Returns a contiguous (B, S, E) tensor in ``y.dtype``."""
    _check_input("gated_rmsnorm", y)
    bsz, s, e = y.shape
    dev, dtype = y.device, y.dtype
    _check_rows("y", y, y.shape, dtype, dev)
    if (x is None) != (D is None):
        raise ValueError("the skip takes both x and D, or neither")
    width = e if group_size is None else group_size
    vec = _ALIGN // y.element_size()
    if width < 1 or e % width or width % vec:
        raise ValueError(f"group_size {group_size} must divide E = {e} into whole 16-byte "
                         "vectors")
    if width // vec > MAX_ROW_VECTORS:
        raise ValueError(f"gated_rmsnorm takes groups of up to {MAX_ROW_VECTORS} 16-byte "
                         f"vectors, got {width}")
    heads = 0
    if x is not None:
        _check_rows("x", x, y.shape, dtype, dev)
        if D.dim() != 1 or D.shape[0] < 1 or e % D.shape[0]:
            raise ValueError(f"D must be (H,) with H dividing E = {e}, got {tuple(D.shape)}")
        heads = D.shape[0]
        if (e // heads) % (_ALIGN // y.element_size()):
            raise ValueError(f"a head of D covers {e // heads} columns, not whole 16-byte "
                             "vectors")
        D = _param("D", D, (heads,), dtype, dev)
    if z is not None:
        _check_rows("z", z, y.shape, dtype, dev)
    scale = _param("scale", scale, (e,), torch.float32, dev)
    out = torch.empty((bsz, s, e), dtype=dtype, device=dev)
    fn = _kernel_fn("gated_rmsnorm", dtype)
    none = (None, 0, 0)
    xp, x_sb, x_ss = none if x is None else (x.data_ptr(), x.stride(0), x.stride(1))
    zp, z_sb, z_ss = none if z is None else (z.data_ptr(), z.stride(0), z.stride(1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(y.data_ptr(), xp, None if D is None else D.data_ptr(), zp, scale.data_ptr(),
                 out.data_ptr(), bsz, s, e, heads, e // width, float(eps),
                 y.stride(0), y.stride(1), x_sb, x_ss, z_sb, z_ss, stream)
    _raise_on(err, "gated_rmsnorm")
    gated_rmsnorm.launches += 1
    if x is None and z is None:
        gated_rmsnorm.norm_launches += 1
    return out


causal_conv_silu.launches = 0   # type: ignore[attr-defined]
gated_rmsnorm.launches = 0      # type: ignore[attr-defined]
gated_rmsnorm.norm_launches = 0  # type: ignore[attr-defined]
