# Copied from src/repro/configs/kimi_k2_1t_a32b.py; imports rebound to repro_torch.
"""kimi-k2-1t-a32b [moe] — Kimi K2, trillion-param MoE [arXiv:2501.kimi2].

61L, d_model=7168, 64 heads (GQA kv=8), expert d_ff=2048, vocab=163840,
MoE 384 experts top-8 + 1 shared expert (DeepSeek-V3-style fine-grained
experts).  ~1T total / ~32B active parameters.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,                   # per-expert hidden (fine-grained)
    vocab_size=163840,
    activation="silu",
    rope_theta=50_000.0,
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_ff_expert=2048,
        capacity_factor=1.25,
        num_shared_experts=1,
    ),
    moe_every=1,                 # every layer MoE
    long_context_mode="sliding_window",
    optimizer="adafactor",       # 1T params: factored state mandatory
    learning_rate=6e-5,
)


def smoke_config() -> ArchConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=1.25, num_shared_experts=1),
        moe_every=1,
        remat=False,
    )
