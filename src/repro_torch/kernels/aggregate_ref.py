"""Plain PyTorch versions of the aggregation kernel.

The counterpart of ``src/repro/kernels/aggregate_ref.py``.  The tests
and ``chip_smoke.py`` hold the CUDA kernel against ``aggregate_flat_ref``
and ``aggregate_leaves_ref``; the CPU branch of ``aggregate_ops`` takes
the cheaper ``weighted_sum_leaves``.

``aggregate_flat_ref`` repeats the kernel's arithmetic exactly: each output
element starts from 0 and takes acc = fmaf(w[k], x[k, n], acc) for
k = 0 .. K-1 in order (``fmaf_ref``: one rounding to float32 per step,
emulated in float64), then one rounding to the leaf's dtype.  So the
kernel and the plain version agree bit for bit, also where the sum
cancels to near zero (a product rounded before its sum lands there many
bfloat16 ulps away), and every output element is computed alone: a
leaf's result does not depend on what other columns share its call (a
BLAS ``w @ x`` on the CPU blocks its columns, and a column's sum then
depends on its position: 6e-8 apart at K = 8).
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def fmaf_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (to nearest even), as CUDA's
    ``fmaf``, elementwise.  The product is exact in float64 (24 + 24
    bits); the sum rounds once in float64 and its error is kept (two-sum);
    the float64 sum's rounding to float32 is then right unless it sits on
    a midpoint between two float32 values, where the kept error decides."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)          # s + err == a * b + c exactly
    r = s.float()
    d = s - r.double()                         # exact: r is s's float32 neighbour
    inf = torch.tensor(float("inf"), device=r.device)
    step = torch.where(d > 0, torch.nextafter(r, inf), torch.nextafter(r, -inf))
    midpoint = (d != 0) & (2 * d.abs() == (step.double() - r.double()).abs()) & torch.isfinite(r)
    beyond = midpoint & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(beyond, step, r)


def _weighted_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w[k] x[k] over x's leading axis: fmaf in float32, k in order."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for k in range(x.shape[0]):
        acc = fmaf_ref(wf[k], xf[k], acc)
    return acc


def aggregate_flat_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_k w[k] x[k, n], accumulated in fp32, in ``x.dtype``."""
    return _weighted_rows(x, w).to(x.dtype)


def aggregate_leaves_ref(xs: Sequence[torch.Tensor], w: torch.Tensor) -> List[torch.Tensor]:
    """``aggregate_flat_ref`` of each (K, n_i) leaf, in its own dtype."""
    return [aggregate_flat_ref(x, w) for x in xs]


def weighted_sum_leaves(xs: Sequence[torch.Tensor], w: torch.Tensor) -> List[torch.Tensor]:
    """sum_k w[k] x[k] of each (K, n_i) leaf in float32, k in order, each
    product rounded before its sum, then one rounding to the leaf's dtype:
    two float32 passes a row where ``aggregate_leaves_ref`` takes about
    fifteen float64 ones.  Every element is computed alone, so a leaf's
    result does not depend on what other leaves share the call.  It
    differs from the kernel's fmaf chain by float32 rounding."""
    wf = w.float()
    outs = []
    for x in xs:
        acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
        for k in range(x.shape[0]):
            acc = acc + wf[k] * x[k].float()
        outs.append(acc.to(x.dtype))
    return outs


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance between two bfloat16 tensors in units in the
    last place: the number of representable bfloat16 values from one to
    the other (+0 and -0 are the same value)."""

    def ordered(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)

    return (ordered(a) - ordered(b)).abs()
