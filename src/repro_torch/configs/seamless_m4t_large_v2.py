# Copied from src/repro/configs/seamless_m4t_large_v2.py; imports rebound to repro_torch.
"""seamless-m4t-large-v2 [audio] — SeamlessM4T v2 large [arXiv:2308.11596].

24L encoder + 24L decoder, d_model=1024, 16 heads (kv=16), d_ff=8192,
vocab=256206 (NLLB).  The speech frontend (mel-spectrogram + conformer
conv feature extractor) is the allowed STUB: ``input_specs`` provides
precomputed frame embeddings (B, S_enc, d_model); this config covers the
transformer backbone (encoder + autoregressive text decoder).
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=24,               # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    activation="silu",
    encoder=EncoderConfig(num_layers=24, max_source_len=1024),
    long_context_mode="sliding_window",
    optimizer="adam",
    learning_rate=3e-4,
)


def smoke_config() -> ArchConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        encoder=EncoderConfig(num_layers=2, max_source_len=64),
        remat=False,
    )
