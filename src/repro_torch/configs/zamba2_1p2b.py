# Copied from src/repro/configs/zamba2_1p2b.py; imports rebound to repro_torch.
"""zamba2-1.2b [hybrid] — Zamba2 [arXiv:2411.15242].

38 Mamba2 layers, d_model=2048, + one SHARED attention block (32 heads,
kv=32, d_ff=8192) re-applied every 6 Mamba layers; vocab=32000,
ssm_state=64.  long_500k: Mamba state is O(1); the shared attention
block uses the sliding-window cache.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, num_groups=1,
                  chunk_size=128, conv_width=4, expand=2),
    hybrid_attn_every=6,
    long_context_mode="native",
    tie_embeddings=True,
    optimizer="adam",
    learning_rate=3e-4,
)


def smoke_config() -> ArchConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, num_groups=1,
                      chunk_size=32, conv_width=4, expand=2),
        hybrid_attn_every=2,
        remat=False,
    )
