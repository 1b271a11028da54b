# Copied from src/repro/configs/llama4_maverick_400b_a17b.py; imports rebound to repro_torch.
"""llama4-maverick-400b-a17b [moe] — Llama 4 Maverick.

[hf:meta-llama/Llama-4-Scout-17B-16E (family card)]
48L, d_model=5120, 40 heads (GQA kv=8), d_ff=8192, vocab=202048,
MoE 128 experts top-1 interleaved every other layer (Maverick's
interleave_moe_layer_step=2) + 1 shared expert; early fusion multimodal
(text path exercised; vision tokens enter as embeddings).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    activation="silu",
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        capacity_factor=2.0,     # top-1 needs headroom against imbalance
        num_shared_experts=1,
    ),
    moe_every=2,                 # dense / MoE interleave
    long_context_mode="sliding_window",
    optimizer="adafactor",
    learning_rate=1e-4,
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
        d_ff=512,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=256,
                      capacity_factor=2.0, num_shared_experts=1),
        moe_every=2,
        remat=False,
    )
