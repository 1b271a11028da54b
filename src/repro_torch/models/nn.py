"""Minimal functional NN building blocks over dict pytrees.

The counterpart of ``src/repro/models/nn.py``.  Every module is a pair
of plain functions::

    params = init_*(rng, ...)        # rng: a torch.Generator
    out    = apply_*(params, x, ...)

Parameters keep the reference layout — conv kernels HWIO, dense weights
``(in, out)`` — and activations are NHWC at every public function, so
reference parameters load unchanged.  Layout changes to PyTorch's NCHW
happen inside ``apply_conv``, ``apply_conv_transpose`` and ``max_pool``
only.  Every ``init_*`` draws on its generator's device.  The CNN's and
the U-Net's callers pass a CPU generator, so a seed gives the same
weights whatever device they then move them to; the LLM zoo draws on
the card itself (a CPU draw at full width would take tens of GB of host
memory and minutes).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def _uniform_init(
    rng: torch.Generator, shape: Tuple[int, ...], scale: float
) -> torch.Tensor:
    u = torch.rand(shape, generator=rng, dtype=torch.float32, device=rng.device)
    return u * (2.0 * scale) - scale


def init_dense(
    rng: torch.Generator, in_dim: int, out_dim: int, use_bias: bool = True
) -> Dict:
    scale = math.sqrt(1.0 / in_dim)
    p = {"w": _uniform_init(rng, (in_dim, out_dim), scale)}
    if use_bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32, device=rng.device)
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
        p["b"] = torch.zeros((out_ch,), dtype=torch.float32, device=rng.device)
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


def _same_transpose_offset(ksize: int, stride: int) -> int:
    """Where XLA's SAME transposed convolution (``lax.conv_transpose``
    without ``transpose_kernel``) starts inside the full transposed
    convolution: it pads the stride-dilated input with ``before`` zeros
    (and ``ksize + stride - 2 - before`` after), so its first output is
    ``ksize - 1 - before`` positions into the full one."""
    total = ksize + stride - 2
    before = ksize - 1 if stride > ksize - 1 else -(-total // 2)
    return ksize - 1 - before


def apply_conv_transpose(p: Dict, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """x: (B, H, W, C) NHWC; p["w"]: (kh, kw, C, O) HWIO -> (B, sH, sW, O).

    The reference correlates the stride-dilated input with the kernel as
    it is stored; ``F.conv_transpose2d`` scatters with the kernel, so it
    gets the kernel flipped in both spatial axes, and its full output is
    cut to ``stride * size`` positions from XLA's offset.  Where the
    kernel is smaller than the stride the cut runs past the full output;
    those positions see only padding and are zero."""
    w = p["w"].to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)   # HWIO -> (I, O, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride)
    h, wd = stride * x.shape[1], stride * x.shape[2]
    t0 = _same_transpose_offset(w.shape[2], stride)
    l0 = _same_transpose_offset(w.shape[3], stride)
    y = y[:, :, t0:t0 + h, l0:l0 + wd]
    y = F.pad(y, (0, wd - y.shape[3], 0, h - y.shape[2]))
    y = y.permute(0, 2, 3, 1)                            # NCHW -> NHWC
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """window x window max-pool, stride = window, VALID; NHWC in and out."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride=window)
    return y.permute(0, 2, 3, 1)


def init_layernorm(dim: int) -> Dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32),
            "bias": torch.zeros((dim,), dtype=torch.float32)}


def apply_layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Layer normalisation over the last axis (biased variance), in
    ``x.dtype``."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def init_rmsnorm(dim: int, dtype: torch.dtype = torch.float32) -> Dict:
    return {"scale": torch.ones((dim,), dtype=dtype)}


def apply_rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation over the last axis, computed in float32 and
    returned in ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def init_embedding(rng: torch.Generator, vocab: int, dim: int,
                   dtype: torch.dtype = torch.float32) -> Dict:
    table = torch.randn((vocab, dim), generator=rng, device=rng.device)
    return {"table": table.mul_(0.02).to(dtype)}


def apply_embedding(
    p: Dict, tokens: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Rows of the table for ``tokens``, in ``dtype`` (gathered first,
    then cast: the same values as casting the whole table)."""
    return p["table"][tokens].to(dtype)


def init_stacked(rng: torch.Generator, init_one, count: int, device: torch.device) -> PyTree:
    """``count`` draws of ``init_one(rng)`` stacked on a new leading
    axis, filled one at a time on ``device`` (the peak is the stack
    plus one draw), as the reference's ``jax.vmap`` init lays them out.
    A single draw is stacked as a view, with no copy."""
    if count == 1:
        return tree_map(lambda p: p.to(device).unsqueeze(0), init_one(rng))
    stacked = None
    for i in range(count):
        one = init_one(rng)
        if stacked is None:
            stacked = tree_map(lambda p: torch.empty((count, *p.shape), dtype=p.dtype,
                                                     device=device), one)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, one)
        del one         # before the next draw, so at most one is alive
    return stacked


def remat(enabled: bool, fn, *args):
    """``fn(*args)``; with ``enabled`` and grad mode on, its activations
    are dropped after the forward pass and recomputed in the backward
    pass (``jax.checkpoint``'s counterpart, for ``cfg.remat``).  Memory
    changes, values do not; under ``no_grad`` this is a plain call."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def count_params(params: PyTree) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def param_bits(params: PyTree, bits_per_param: int = 32) -> int:
    """Payload size z|N| for the comm model (eq. 7)."""
    return count_params(params) * bits_per_param


def tree_cast(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda p: p.to(dtype), params)
