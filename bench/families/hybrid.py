"""Family ``hybrid``: Zamba2 stacks in the published layout [arXiv:2411.15242].

The configuration file holds the published ``config.json``'s keys
(``hidden_size``, ``mamba_d_state``, ``hybrid_layer_ids``, ...) and,
beside them, the keys every family gives (``num_layers``, ``d_model``,
``ssm``, ``rms_norm_eps``, ``vocab_size``, ``tie_embeddings``), which
must agree with them (``check``).  The layout is the program's
``Zamba2SharedBlocksModel`` tree: ``mamba`` holds the Mamba2 blocks
stacked on a leading (L,) axis, ``shared`` the ``num_mem_blocks``
shared transformer blocks, ``uses`` each use's adapter and linear.  The
prefill runs the ssm family's kernels in every Mamba2 block (K3, K4, K5
gated over each B/C group, and as the input norm) and flash attention
(K2) in every use of a shared block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

from bench.families import ssm
from bench.harness import KernelUse
from bench.reference import zamba2 as reference  # noqa: F401  (the family's plain layers)
from bench.weights import Leaf


def sized(num_layers: int, d_model: int, vocab_size: int, ssm_sizes: dict, heads: int,
          d_ff: int, adapter_rank: int, hybrid_layer_ids: List[int],
          num_mem_blocks: int) -> dict:
    """The sizes of a configuration, under the family's keys and the
    published config's, each derived the way ``check`` holds them."""
    d_inner = ssm_sizes["expand"] * d_model
    return dict(
        num_layers=num_layers, d_model=d_model, vocab_size=vocab_size, ssm=dict(ssm_sizes),
        num_hidden_layers=num_layers, hidden_size=d_model,
        mamba_d_state=ssm_sizes["state_dim"], mamba_headdim=ssm_sizes["head_dim"],
        mamba_ngroups=ssm_sizes["num_groups"], mamba_expand=ssm_sizes["expand"],
        mamba_d_conv=ssm_sizes["conv_width"], chunk_size=ssm_sizes["chunk_size"],
        n_mamba_heads=d_inner // ssm_sizes["head_dim"],
        num_attention_heads=heads, num_key_value_heads=heads, num_query_groups=heads,
        attention_hidden_size=2 * d_model, attention_head_dim=2 * d_model // heads,
        kv_channels=d_model // heads, intermediate_size=d_ff, ffn_hidden_size=d_ff,
        adapter_rank=adapter_rank, hybrid_layer_ids=list(hybrid_layer_ids),
        num_mem_blocks=num_mem_blocks,
        layers_block_type=["hybrid" if i in hybrid_layer_ids else "mamba"
                           for i in range(num_layers)],
    )


# the CPU tests' size: seven narrow layers, two shared blocks used at three
# uneven layers, two B/C groups
SMALL = sized(num_layers=7, d_model=64, vocab_size=96,
              ssm_sizes=dict(state_dim=16, head_dim=16, num_groups=2, chunk_size=16,
                             conv_width=4, expand=2),
              heads=4, d_ff=128, adapter_rank=8, hybrid_layer_ids=[1, 3, 6], num_mem_blocks=2)
# Limits at that size, set as the ssm family's are: between the largest
# reading of sound runs and the smallest of the float8 control or of a
# fault that reads above it, 6 seeds each on the CPU (sound / control or
# fault): loss_gap 0.0044 / 0.0105, grad_gap 0.046 / 0.114 (half batch),
# grad_median_gap 0.0119 / 0.024, change_gap 0.0175 / 0.41 (no
# aggregation; the control reads 0.0185 and fails the three above);
# served_gap 0.022 / 0.112, logit_err 0.127 / 0.617.
SMALL_LIMITS = {
    "fedleo_train": dict(loss_gap=0.007, grad_gap=0.08, grad_median_gap=0.017,
                         change_gap=0.1),
    "prefill": dict(served_gap=0.06, logit_err=0.3),
}


def check(cfg: dict) -> None:
    """Refuse a file whose published keys disagree with the family's."""
    want = sized(cfg["num_layers"], cfg["d_model"], cfg["vocab_size"], cfg["ssm"],
                 cfg["num_attention_heads"], cfg["intermediate_size"], cfg["adapter_rank"],
                 cfg["hybrid_layer_ids"], cfg["num_mem_blocks"])
    bad = {k: (cfg.get(k), v) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"{cfg['arch']}: keys that disagree (file, derived): {bad}")
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("the published block has as many key/value heads as query heads")


def program_config(cfg: dict, **overrides):
    """The program's ``ArchConfig`` holding exactly the sizes of the
    configuration file, for the program's registered architecture."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig

    check(cfg)
    base = get_config(cfg["arch"])
    if base.family != cfg["family"] or cfg["family"] != "hybrid" or not getattr(
            base, "hybrid_layer_ids", ()):
        raise ValueError(f"{cfg['arch']}: this family runs the published Zamba2 layout; the "
                         f"program has a {base.family} model, the file says {cfg['family']}")
    hd = cfg["attention_head_dim"]
    fields = dict(num_layers=cfg["num_layers"], d_model=cfg["d_model"],
                  vocab_size=cfg["vocab_size"], tie_embeddings=cfg["tie_embeddings"],
                  ssm=SSMConfig(**cfg["ssm"]), num_heads=cfg["num_attention_heads"],
                  num_kv_heads=cfg["num_key_value_heads"], head_dim=hd,
                  d_ff=cfg["intermediate_size"], rope_theta=float(cfg["rope_theta"]),
                  rms_norm_eps=cfg["rms_norm_eps"],
                  hybrid_layer_ids=tuple(cfg["hybrid_layer_ids"]),
                  num_mem_blocks=cfg["num_mem_blocks"], adapter_rank=cfg["adapter_rank"])
    fields.update(overrides)
    return dataclasses.replace(base, **fields)


def _shapes(cfg: dict):
    d = cfg["d_model"]
    return (d, cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["attention_head_dim"], cfg["intermediate_size"], cfg["adapter_rank"],
            len(cfg["hybrid_layer_ids"]), cfg["num_mem_blocks"])


def leaves(cfg: dict) -> List[Leaf]:
    d, h, g, hd, f, r, uses, m = _shapes(cfg)
    return [
        *ssm.mamba_block_leaves(cfg, (cfg["num_layers"],), ("mamba",)),
        (("shared", "ln_attn", "scale"), (m, 2 * d), "scale", 0.1),
        (("shared", "attn", "wq"), (m, 2 * d, h, hd), "normal", 1.0 / math.sqrt(2 * d)),
        (("shared", "attn", "wk"), (m, 2 * d, g, hd), "normal", 1.0 / math.sqrt(2 * d)),
        (("shared", "attn", "wv"), (m, 2 * d, g, hd), "normal", 1.0 / math.sqrt(2 * d)),
        (("shared", "attn", "wo"), (m, h, hd, d), "normal", 1.0 / math.sqrt(h * hd)),
        (("shared", "ln_ffn", "scale"), (m, d), "scale", 0.1),
        (("shared", "ffn", "w_gate"), (m, d, f), "normal", 1.0 / math.sqrt(d)),
        (("shared", "ffn", "w_up"), (m, d, f), "normal", 1.0 / math.sqrt(d)),
        (("shared", "ffn", "w_down"), (m, f, d), "normal", 1.0 / math.sqrt(f)),
        (("uses", "adapter", "down"), (uses, d, r), "normal", 1.0 / math.sqrt(d)),
        (("uses", "adapter", "up"), (uses, r, 2 * f), "normal", 1.0 / math.sqrt(r)),
        (("uses", "linear"), (uses, d, d), "normal", 1.0 / math.sqrt(d)),
    ]


def forward_flops(cfg: dict, b: int, s: int, head_positions: int) -> dict:
    """Model FLOPs of one forward pass over b sequences of s tokens, by
    term: every Mamba2 block's (``ssm.mamba_block_flops``); each use of a
    shared block's products, 2*m*n*k: q, k, v and o, the MLP, its adapter
    and the use's linear, and the causal attention's two products,
    4 b h d s(s+1)/2; the tied head over ``head_positions`` positions of
    each sequence.  Norms, RoPE, gates and the embedding gather are not
    products and are not counted."""
    d, h, g, hd, f, r, uses, _ = _shapes(cfg)
    tokens = b * s
    out = {k: cfg["num_layers"] * v for k, v in ssm.mamba_block_flops(cfg, b, s).items()}
    out["shared_qkvo"] = uses * tokens * 2.0 * (2 * d * (h + 2 * g) * hd + h * hd * d)
    out["shared_attention"] = uses * 4.0 * b * h * hd * s * (s + 1) / 2
    out["shared_mlp"] = uses * tokens * 2.0 * 3 * d * f
    out["adapter"] = uses * tokens * 2.0 * (d * r + r * 2 * f)
    out["linear"] = uses * tokens * 2.0 * d * d
    out["head"] = b * head_positions * 2.0 * d * cfg["vocab_size"]
    return out


def param_count(cfg: dict) -> int:
    """Parameters of the configuration, counted from its shapes."""
    d, h, g, hd, f, r, uses, m = _shapes(cfg)
    mamba = ssm.param_count(dict(cfg, vocab_size=0)) - d            # the blocks alone
    shared = 2 * d + 2 * d * (h + 2 * g) * hd + h * hd * d + d + 3 * d * f
    per_use = d * r + r * 2 * f + d * d
    return mamba + m * shared + uses * per_use + cfg["vocab_size"] * d + d


def prefill_kernels(cfg: dict, itemsize: int) -> List[KernelUse]:
    """The ssm family's kernels of each Mamba2 block (``ssm.mamba_block_kernels``)
    and K2 in each use of a shared block (launch shape as
    ``flash_bound.flash_bound_ms`` takes it)."""
    from repro_torch.kernels import flash

    _, h, g, hd, *_ = _shapes(cfg)
    return [*ssm.mamba_block_kernels(cfg, itemsize),
            KernelUse("flash", tuple(flash.KERNELS.values()),
                      lambda: flash.flash_attention.launches,
                      lambda b, s: (b, s, h, g, hd, True, itemsize))]
