# Copied from src/repro/configs/minitron_8b.py; imports rebound to repro_torch.
"""minitron-8b [dense] — Minitron (pruned Nemotron-4) [arXiv:2407.14679].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
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
