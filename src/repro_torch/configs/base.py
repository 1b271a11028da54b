# Copied from src/repro/configs/base.py; imports rebound to repro_torch.
"""Architecture + input-shape configuration schema.

Every assigned architecture gets one ``<id>.py`` in this package exposing
``CONFIG`` (the exact published dims, citation in ``source``) and
``smoke_config()`` (a reduced same-family variant for CPU smoke tests:
<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01   # load-balance loss weight
    num_shared_experts: int = 0     # always-on shared expert(s) (kimi/deepseek style)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int           # N (ssm_state)
    head_dim: int = 64       # P
    num_groups: int = 1      # B/C groups
    chunk_size: int = 128    # SSD chunk length Q
    conv_width: int = 4
    expand: int = 2          # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (audio) archs; frontend is stubbed."""

    num_layers: int
    max_source_len: int = 1024   # stubbed frame/patch embedding count


@dataclasses.dataclass(frozen=True)
class VisionStub:
    """VLM vision-frontend stub: precomputed patch embeddings."""

    num_patches: int = 256
    embed_dim: Optional[int] = None  # defaults to d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                     # citation (paper/model card)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    activation: str = "silu"        # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    logit_soft_cap: Optional[float] = None
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    moe_every: int = 1              # MoE block every n-th layer (1 = all)
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 6      # hybrid: shared attn block interval
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStub] = None

    # long-context policy for the 500k decode shape (see DESIGN.md §4)
    long_context_mode: str = "sliding_window"   # or "native" (SSM/hybrid)
    sliding_window: int = 8192

    # training-system choices
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    remat: bool = True              # activation checkpointing per layer
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count_estimate(self) -> int:
        """Rough N for MODEL_FLOPS = 6*N*D bookkeeping (dense part exact
        enough for roofline purposes; MoE counts all experts)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        if self.moe is not None:
            moe_layers = sum(
                1 for i in range(self.num_layers)
                if (i % self.moe_every) == self.moe_every - 1
            )
            dense_layers = self.num_layers - moe_layers
            ffn = dense_layers * 3 * d * self.d_ff + moe_layers * (
                self.moe.num_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
            )
        elif self.ssm is not None and self.family == "ssm":
            d_in = self.ssm.expand * d
            ffn = self.num_layers * (
                2 * d * d_in + d_in * d + d_in * self.ssm.state_dim * 2
            )
            attn = 0
        else:
            ffn = self.num_layers * 3 * d * self.d_ff
        layers = self.num_layers * attn if self.family != "ssm" else 0
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return layers + ffn + embed

    def active_param_count_estimate(self) -> int:
        """N_active for MoE (top-k experts instead of all)."""
        if self.moe is None:
            return self.param_count_estimate()
        full = self.param_count_estimate()
        moe_layers = sum(
            1 for i in range(self.num_layers)
            if (i % self.moe_every) == self.moe_every - 1
        )
        all_exp = moe_layers * self.moe.num_experts * 3 * self.d_model * self.moe.d_ff_expert
        act_exp = moe_layers * (self.moe.top_k + self.moe.num_shared_experts) \
            * 3 * self.d_model * self.moe.d_ff_expert
        return full - all_exp + act_exp


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
