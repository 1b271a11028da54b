"""The benchmark's yardstick: the H100's peaks, the least time of each
hand-written kernel's work, and the model FLOPs of a step.

Everything here counts work from shapes alone, against NVIDIA's data
sheet for the H100 SXM (dense rates, 700 W).  It counts the same work
whatever implements it, so a change that replaces a kernel does not
move its own yardstick.  The kernel bounds are frozen copies of
``chip_smoke.py``'s ``aggregate_bound_ms`` and ``ssd_bound_ms``, and of
the byte counts of its ``fused_inputs`` for K4 and K5.  A step's FLOPs
sum its family's terms (``bench/families/``).
"""
from __future__ import annotations

from bench import harness

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bfloat16 tensor cores, dense


def aggregate_bound_ms(k: int, n: int, itemsize: int):
    """Least time for one aggregation: x and w read once, out written
    once, against 2*K*N float32 operations; returns (ms, bound_by, bytes)."""
    nbytes = (k + 1) * n * itemsize + 4 * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * k * n / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def ssd_flops(b, s, h, p, n, chunk) -> float:
    """The SSD scan's operations: the TPU kernel's four products per
    (batch, head, chunk), 2Q^2 N + 2Q^2 P + 4QPN."""
    nchunks = -(-s // chunk)
    return b * h * nchunks * (2.0 * chunk * chunk * n + 2.0 * chunk * chunk * p
                              + 4.0 * chunk * p * n)


def ssd_bound_ms(b, s, h, p, g, n, chunk, itemsize):
    """Least time for one scan: x, dt, B, C read once, y and the float32
    final state written once, against the FLOPs of the TPU kernel's four
    products per (batch, head, chunk), 2Q^2 N + 2Q^2 P + 4QPN, at the
    bfloat16 tensor-core rate; returns (ms, bound_by, bytes, flops)."""
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + 4 * b * s * h + 4 * b * h * p * n
    flops = ssd_flops(b, s, h, p, n, chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def causal_conv_silu_bound_ms(b, s, c, itemsize):
    """Least time for one launch of K4 over (b, s, c) channels: x|B|C read
    once and the output written once (the taps and the bias, a few KB, not
    counted); returns (ms, bound_by, bytes).  Its few operations an element
    take a tenth of that time at the float32 rate."""
    nbytes = 2 * b * s * c * itemsize
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes", nbytes


def gated_rmsnorm_bound_ms(b, s, e, gated, itemsize):
    """Least time for one launch of K5 over (b, s, e): y, with ``gated``
    also the skip's x and the gate z, read once and the output written
    once (the scale and D not counted); returns (ms, bound_by, bytes)."""
    nbytes = (4 if gated else 2) * b * s * e * itemsize
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes", nbytes


# --- model FLOPs ------------------------------------------------------------------------
def train_step_flops(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one training step on b sequences of s tokens:
    3 x the forward pass (the family's ``forward_flops``) with the head
    over every position.  Remat's recompute is not counted."""
    return 3.0 * sum(harness.family(cfg).forward_flops(cfg, b, s, s).values())


def prefill_flops(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one prefill call: the forward pass, the head over
    the last position only (what the call returns)."""
    return sum(harness.family(cfg).forward_flops(cfg, b, s, 1).values())
