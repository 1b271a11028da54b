# Copied from src/repro/configs/mistral_large_123b.py; imports rebound to repro_torch.
"""mistral-large-123b [dense] — Mistral Large Instruct 2407.

[hf:mistralai/Mistral-Large-Instruct-2407]
88L, d_model=12288, 96 heads (GQA kv=8), d_ff=28672, vocab=32768.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    activation="silu",
    rope_theta=1_000_000.0,
    long_context_mode="sliding_window",
    optimizer="adafactor",      # 123B: factored state to fit v5e HBM
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
        remat=False,
    )
