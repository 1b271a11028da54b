# Copied from src/repro/configs/mamba2_780m.py; imports rebound to repro_torch.
"""mamba2-780m [ssm] — Mamba2 / SSD [arXiv:2405.21060].

48L, d_model=1536, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*1536 = 3072, head_dim=64 -> 48 SSD heads.
Runs long_500k natively (O(1) recurrent state).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1536,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, num_groups=1,
                  chunk_size=128, conv_width=4, expand=2),
    long_context_mode="native",
    tie_embeddings=True,
    optimizer="adam",
    learning_rate=3e-4,
)


def smoke_config() -> ArchConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        vocab_size=512,
        ssm=SSMConfig(state_dim=32, head_dim=32, num_groups=1,
                      chunk_size=32, conv_width=4, expand=2),
        remat=False,
    )
