# Copied from src/repro/configs/internvl2_26b.py; imports rebound to repro_torch.
"""internvl2-26b [vlm] — InternVL2 26B [arXiv:2404.16821].

InternViT-6B vision encoder + InternLM2-20B language model.  The vision
frontend (ViT + MLP projector) is the allowed STUB: ``input_specs``
provides projected patch embeddings (B, P, d_model); this config covers
the language transformer: 48L, d_model=6144, 48 heads (GQA kv=8),
d_ff=16384, vocab=92553.
"""
from repro_torch.configs.base import ArchConfig, VisionStub

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    activation="silu",
    rope_theta=1_000_000.0,
    vision=VisionStub(num_patches=256),
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
        vision=VisionStub(num_patches=16),
        remat=False,
    )
