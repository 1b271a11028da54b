"""zamba2-7b [hybrid] — Zamba2-7B-Instruct [arXiv:2411.15242].

The published configuration
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json):
81 Mamba2 layers, d_model=3584, 112 SSD heads of 64, state 64, 2 B/C
groups, chunk 256, vocab 32000, tied head, every RMSNorm at eps 1e-5.
Before each of the 13 ``hybrid_layer_ids`` one of two shared transformer
blocks runs (use j takes block j % 2) on the RMSNorm of the stream
concatenated with the embeddings (7168 wide): 32 heads of 224 with
rotate-half RoPE and scores scaled by (224 / 2) ** -0.5, no residual,
then an RMSNorm and a GeGLU MLP (exact GELU, 3584 -> 2 x 14336 -> 3584)
whose gate and up product take the use's own rank-128 adapter, then the
use's own 3584 x 3584 linear; its output enters that layer's Mamba block
beside the stream, inside the block's input norm only.  7,356,749,648
parameters.  The port's own configuration: the JAX package has no
counterpart, so it is not among ``ARCH_IDS``.
"""
import dataclasses

from repro_torch.configs.base import SSMConfig
from repro_torch.configs.extended import ExtendedArchConfig

CONFIG = ExtendedArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    activation="gelu_exact",
    rope_theta=10000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, num_groups=2,
                  chunk_size=256, conv_width=4, expand=2),
    long_context_mode="native",
    tie_embeddings=True,
    optimizer="adam",
    learning_rate=3e-4,
    rms_norm_eps=1e-5,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
)


def smoke_config() -> ExtendedArchConfig:
    """Seven narrow layers, two shared blocks used three times at uneven
    ids, two B/C groups."""
    return dataclasses.replace(
        CONFIG,
        num_layers=7,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=2 * 64 // 4,
        d_ff=128,
        vocab_size=96,
        ssm=SSMConfig(state_dim=16, head_dim=16, num_groups=2,
                      chunk_size=16, conv_width=4, expand=2),
        hybrid_layer_ids=(1, 3, 6),
        adapter_rank=8,
        remat=False,
    )
