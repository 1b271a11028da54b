"""Family ``ssm``: attention-free Mamba2 stacks [arXiv:2405.21060].

The layout is the program's ``Mamba2Model`` tree: ``layers`` holds the
Mamba2 blocks stacked on a leading (L,) axis.  The prefill runs three
hand-written kernels in every block: the SSD scan (K3), the causal conv
with its SiLU (K4) and the RMSNorm, gated with the skip (K5) and as the
block's input norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from bench.counts import ssd_flops
from bench.harness import KernelUse
from bench.reference import mamba2 as reference  # noqa: F401  (the family's plain layers)
from bench.weights import Leaf

# the CPU tests' size: two narrow layers, short chunks
SMALL = dict(num_layers=2, d_model=64, vocab_size=96,
             ssm=dict(state_dim=16, head_dim=16, num_groups=1, chunk_size=16, conv_width=4,
                      expand=2))
# Limits at that size, set as the cells' are: between the largest reading
# of sound runs (6 seeds, on the CPU) and the smallest of the float8
# control (6 seeds) or of a fault (3 seeds) that reads above it.
SMALL_LIMITS = {
    "fedleo_train": dict(loss_gap=0.001, grad_gap=0.01, grad_median_gap=0.0012,
                         change_gap=0.035),
    "prefill": dict(served_gap=0.2, logit_err=0.045),
}


def program_config(cfg: dict, **overrides):
    """The program's ``ArchConfig`` holding exactly the sizes of the
    configuration file, for the program's registered architecture."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig

    base = get_config(cfg["arch"])
    if base.family != cfg["family"] or cfg["family"] != "ssm":
        raise ValueError(f"{cfg['arch']}: this family runs Mamba2 (ssm) models; the program "
                         f"has a {base.family} model, the file says {cfg['family']}")
    fields = dict(num_layers=cfg["num_layers"], d_model=cfg["d_model"],
                  vocab_size=cfg["vocab_size"], tie_embeddings=cfg["tie_embeddings"],
                  ssm=SSMConfig(**cfg["ssm"]))
    fields.update(overrides)
    return dataclasses.replace(base, **fields)


def dims(cfg: dict):
    """(d_inner, heads, groups, state, conv channels, in_proj width) of
    a configuration's Mamba2 block."""
    ssm = cfg["ssm"]
    d_inner = ssm["expand"] * cfg["d_model"]
    heads = d_inner // ssm["head_dim"]
    g, n = ssm["num_groups"], ssm["state_dim"]
    conv_ch = d_inner + 2 * g * n
    return d_inner, heads, g, n, conv_ch, 2 * d_inner + 2 * g * n + heads


def mamba_block_leaves(cfg: dict, lead: Tuple[int, ...], prefix: Tuple[str, ...]) -> List[Leaf]:
    """The leaves of Mamba2 blocks stacked on ``lead``, under ``prefix``."""
    d = cfg["d_model"]
    d_inner, heads, g, n, conv_ch, proj = dims(cfg)
    w = cfg["ssm"]["conv_width"]
    return [
        (prefix + ("norm", "scale"), lead + (d,), "scale", 0.1),
        (prefix + ("in_proj",), lead + (d, proj), "normal", 1.0 / math.sqrt(d)),
        (prefix + ("conv_w",), lead + (w, conv_ch), "normal", 0.2),
        (prefix + ("conv_b",), lead + (conv_ch,), "normal", 0.02),
        (prefix + ("A_log",), lead + (heads,), "a_log", 0.0),
        (prefix + ("D",), lead + (heads,), "scale", 0.1),
        (prefix + ("dt_bias",), lead + (heads,), "dt_bias", 0.0),
        (prefix + ("out_norm", "scale"), lead + (d_inner,), "scale", 0.1),
        (prefix + ("out_proj",), lead + (d_inner, d), "normal", 1.0 / math.sqrt(d_inner)),
    ]


def leaves(cfg: dict) -> List[Leaf]:
    return mamba_block_leaves(cfg, (cfg["num_layers"],), ("layers",))


def mamba_block_flops(cfg: dict, b: int, s: int) -> dict:
    """Model FLOPs of one Mamba2 block over b sequences of s tokens, by
    term: the in and out projections and the depthwise conv's taps as
    products (2*m*n*k), the SSD scan as ``ssd_flops`` counts it."""
    d = cfg["d_model"]
    tokens = b * s
    d_inner, heads, g, n, conv_ch, proj = dims(cfg)
    ssm = cfg["ssm"]
    return {
        "mamba_proj": tokens * 2.0 * d * (proj + d_inner),
        "mamba_conv": tokens * 2.0 * ssm["conv_width"] * conv_ch,
        "scan": ssd_flops(b, s, heads, ssm["head_dim"], n, ssm["chunk_size"]),
    }


def forward_flops(cfg: dict, b: int, s: int, head_positions: int) -> dict:
    """Model FLOPs of one forward pass over b sequences of s tokens, by
    term: every block's (``mamba_block_flops``) and the tied head over
    ``head_positions`` positions of each sequence.  Norms, gates and the
    embedding gather are not products and are not counted."""
    layers = cfg["num_layers"]
    out = {k: layers * v for k, v in mamba_block_flops(cfg, b, s).items()}
    out["head"] = b * head_positions * 2.0 * cfg["d_model"] * cfg["vocab_size"]
    return out


def param_count(cfg: dict) -> int:
    """Parameters of the configuration, counted from its shapes."""
    d = cfg["d_model"]
    d_inner, heads, g, n, conv_ch, proj = dims(cfg)
    w = cfg["ssm"]["conv_width"]
    block = d + d * proj + w * conv_ch + conv_ch + 3 * heads + d_inner + d_inner * d
    return cfg["num_layers"] * block + cfg["vocab_size"] * d + d


def mamba_block_kernels(cfg: dict, itemsize: int) -> List[KernelUse]:
    """The prefill's hand-written kernels of a Mamba2 block: K3 (launch
    shape as ``counts.ssd_bound_ms`` takes it), K4 (as
    ``causal_conv_silu_bound_ms``) and K5's two uses, gated and as the
    input norm, counted apart (as ``gated_rmsnorm_bound_ms``)."""
    from repro_torch.kernels import mamba_fused, ssd

    d_inner, heads, g, n, conv_ch, _ = dims(cfg)
    ssm = cfg["ssm"]
    conv, norm = mamba_fused.causal_conv_silu, mamba_fused.gated_rmsnorm
    k5 = (mamba_fused.KERNELS["gated_rmsnorm"],)
    return [
        KernelUse("ssd", tuple(ssd.KERNELS.values()), lambda: ssd.ssd_scan.launches,
                  lambda b, s: (b, s, heads, ssm["head_dim"], g, n, ssm["chunk_size"], itemsize)),
        KernelUse("causal_conv_silu", (mamba_fused.KERNELS["causal_conv_silu"],),
                  lambda: conv.launches, lambda b, s: (b, s, conv_ch, itemsize)),
        KernelUse("gated_rmsnorm", k5, lambda: norm.launches - norm.norm_launches,
                  lambda b, s: (b, s, d_inner, True, itemsize)),
        KernelUse("gated_rmsnorm", k5, lambda: norm.norm_launches,
                  lambda b, s: (b, s, cfg["d_model"], False, itemsize)),
    ]


prefill_kernels = mamba_block_kernels
