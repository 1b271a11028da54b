"""The benchmark's yardstick: the H100's peaks, the least time of each
hand-written kernel's work, and the model FLOPs of a step.

Everything here counts work from shapes alone, against NVIDIA's data
sheet for the H100 SXM (dense rates, 700 W).  It counts the same work
whatever implements it, so a change that replaces a kernel does not
move its own yardstick.  The kernel bounds are frozen copies of
``chip_smoke.py``'s ``aggregate_bound_ms`` and ``ssd_bound_ms``.
"""
from __future__ import annotations

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


# --- model FLOPs ------------------------------------------------------------------------
def ssm_dims(cfg: dict):
    """(d_inner, heads, groups, state, conv channels, in_proj width) of
    a configuration's Mamba2 block."""
    ssm = cfg["ssm"]
    d_inner = ssm["expand"] * cfg["d_model"]
    heads = d_inner // ssm["head_dim"]
    g, n = ssm["num_groups"], ssm["state_dim"]
    conv_ch = d_inner + 2 * g * n
    return d_inner, heads, g, n, conv_ch, 2 * d_inner + 2 * g * n + heads


def forward_flops(cfg: dict, b: int, s: int, head_positions: int) -> dict:
    """Model FLOPs of one forward pass over b sequences of s tokens, by
    term: every product 2*m*n*k (the depthwise conv's taps too), the SSD
    scan's operations as ``ssd_flops`` counts them, and the tied head
    over ``head_positions`` positions of each sequence.  Norms, gates and
    the embedding gather are not products and are not counted."""
    d = cfg["d_model"]
    tokens = b * s
    d_inner, heads, g, n, conv_ch, proj = ssm_dims(cfg)
    ssm = cfg["ssm"]
    layers = cfg["num_layers"]
    return {
        "mamba_proj": layers * tokens * 2.0 * d * (proj + d_inner),
        "mamba_conv": layers * tokens * 2.0 * ssm["conv_width"] * conv_ch,
        "scan": layers * ssd_flops(b, s, heads, ssm["head_dim"], n, ssm["chunk_size"]),
        "head": b * head_positions * 2.0 * d * cfg["vocab_size"],
    }


def train_step_flops(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one training step on b sequences of s tokens:
    3 x the forward pass with the head over every position.  Remat's
    recompute is not counted."""
    return 3.0 * sum(forward_flops(cfg, b, s, s).values())


def prefill_flops(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one prefill call: the forward pass, the head over
    the last position only (what the call returns)."""
    return sum(forward_flops(cfg, b, s, 1).values())


def param_count(cfg: dict) -> int:
    """Parameters of the configuration, counted from its shapes."""
    d = cfg["d_model"]
    d_inner, heads, g, n, conv_ch, proj = ssm_dims(cfg)
    w = cfg["ssm"]["conv_width"]
    block = d + d * proj + w * conv_ch + conv_ch + 3 * heads + d_inner + d_inner * d
    return cfg["num_layers"] * block + cfg["vocab_size"] * d + d
