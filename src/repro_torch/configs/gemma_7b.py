# Copied from src/repro/configs/gemma_7b.py; imports rebound to repro_torch.
"""gemma-7b [dense] — Gemma 7B [arXiv:2403.08295].

28L, d_model=3072, 16 heads (kv=16; the 2b variant uses MQA),
head_dim=256 (attention inner dim 4096 > d_model), d_ff=24576, GeGLU,
vocab=256000, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="gelu",          # GeGLU
    tie_embeddings=True,
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
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        remat=False,
    )
