"""K2's yardstick: the least time of one flash-attention launch, from
its shape alone, against the H100's peaks in ``bench/counts.py``.

A frozen copy of ``chip_smoke.py``'s ``flash_bound_ms`` with the causal
mask's visible (q, k) pairs in closed form, s(s+1)/2 a head (s^2 without
the mask), and no window: it counts the same work whatever implements
it, so a change that replaces the kernel does not move its yardstick.
"""
from __future__ import annotations

from bench.counts import BF16_FLOPS_PER_S, HBM_BYTES_PER_S


def flash_bound_ms(b, s, h, g, d, causal, itemsize):
    """Least time for one attention call over (b, s) with h query and g
    key/value heads of d: q, k, v read once and o written once, against
    4*d operations (two products) per visible (q, k) pair and head at the
    bfloat16 tensor-core rate; returns (ms, bound_by, bytes, flops)."""
    nbytes = (2 * b * s * h * d + 2 * b * s * g * d) * itemsize
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)
