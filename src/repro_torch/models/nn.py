"""Minimal functional NN building blocks over dict pytrees.

The counterpart of ``src/repro/models/nn.py``.  Every module is a pair
of plain functions::

    params = init_*(rng, ...)        # rng: a torch.Generator
    out    = apply_*(params, x, ...)

Parameters keep the reference layout — conv kernels HWIO, dense weights
``(in, out)`` — and activations are NHWC at every public function, so
reference parameters load unchanged.  Layout changes to PyTorch's NCHW
happen inside ``apply_conv`` and ``max_pool`` only.  Parameters are
drawn on the CPU (the generator's device), so a seed gives the same
weights whatever device the caller then moves them to.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def _uniform_init(
    rng: torch.Generator, shape: Tuple[int, ...], scale: float
) -> torch.Tensor:
    u = torch.rand(shape, generator=rng, dtype=torch.float32)
    return u * (2.0 * scale) - scale


def init_dense(
    rng: torch.Generator, in_dim: int, out_dim: int, use_bias: bool = True
) -> Dict:
    scale = math.sqrt(1.0 / in_dim)
    p = {"w": _uniform_init(rng, (in_dim, out_dim), scale)}
    if use_bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32)
    return p


def apply_dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_conv(
    rng: torch.Generator, in_ch: int, out_ch: int, ksize: int = 3,
    use_bias: bool = True,
) -> Dict:
    scale = math.sqrt(1.0 / (in_ch * ksize * ksize))
    p = {"w": _uniform_init(rng, (ksize, ksize, in_ch, out_ch), scale)}
    if use_bias:
        p["b"] = torch.zeros((out_ch,), dtype=torch.float32)
    return p


def _same_pads(size: int, ksize: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding: the output has ceil(size / stride) positions,
    the extra row or column (if any) goes after."""
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + ksize - size)
    return total // 2, total - total // 2


def apply_conv(
    p: Dict, x: torch.Tensor, stride: int = 1, padding: str = "SAME"
) -> torch.Tensor:
    """x: (B, H, W, C) NHWC; p["w"]: (kh, kw, C, O) HWIO -> (B, H', W', O)."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)           # HWIO -> OIHW
    xc = x.permute(0, 3, 1, 2)                           # NHWC -> NCHW
    if padding == "SAME":
        (t, b) = _same_pads(x.shape[1], w.shape[2], stride)
        (l, r) = _same_pads(x.shape[2], w.shape[3], stride)
        if t == b and l == r:
            y = F.conv2d(xc, w, stride=stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(xc, (l, r, t, b)), w, stride=stride)
    elif padding == "VALID":
        y = F.conv2d(xc, w, stride=stride)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = y.permute(0, 2, 3, 1)                            # NCHW -> NHWC
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """window x window max-pool, stride = window, VALID; NHWC in and out."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride=window)
    return y.permute(0, 2, 3, 1)


def count_params(params: PyTree) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def param_bits(params: PyTree, bits_per_param: int = 32) -> int:
    """Payload size z|N| for the comm model (eq. 7)."""
    return count_params(params) * bits_per_param


def tree_cast(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda p: p.to(dtype), params)
