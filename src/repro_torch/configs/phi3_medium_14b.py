# Copied from src/repro/configs/phi3_medium_14b.py; imports rebound to repro_torch.
"""phi3-medium-14b [dense] — Phi-3 Medium [arXiv:2404.14219].

40L, d_model=5120, 40 heads (GQA kv=10), d_ff=17920, vocab=100352.
RoPE + SwiGLU + GQA.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    activation="silu",
    long_context_mode="sliding_window",
    optimizer="adam",
    learning_rate=3e-4,
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
        remat=False,
    )
