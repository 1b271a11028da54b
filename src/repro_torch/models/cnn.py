"""The paper's evaluation models: a deep CNN (MNIST/CIFAR-10) and a
U-Net (DeepGlobe road extraction), §V-A.

The counterpart of ``src/repro/models/cnn.py``: the same parameter
pytrees, NHWC inputs.  Each ``init_*`` draws its kernels from one
generator in the order the reference splits its keys.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import nn


def init_cnn(
    rng: torch.Generator,
    input_shape: Tuple[int, int, int] = (28, 28, 1),
    num_classes: int = 10,
    widths: Tuple[int, ...] = (32, 64),
    hidden: int = 128,
) -> Dict:
    params: Dict = {"conv": []}
    in_ch = input_shape[-1]
    h, w = input_shape[0], input_shape[1]
    for ch in widths:
        params["conv"].append(nn.init_conv(rng, in_ch, ch))
        in_ch = ch
        h, w = h // 2, w // 2
    flat = h * w * in_ch
    params["fc1"] = nn.init_dense(rng, flat, hidden)
    params["fc2"] = nn.init_dense(rng, hidden, num_classes)
    return params


def apply_cnn(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    for p in params["conv"]:
        x = nn.max_pool(torch.relu(nn.apply_conv(p, x)), 2)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(nn.apply_dense(params["fc1"], x))
    return nn.apply_dense(params["fc2"], x)


# --- U-Net ---------------------------------------------------------------------
def init_unet(
    rng: torch.Generator,
    in_ch: int = 3,
    base: int = 16,
    depth: int = 3,
    num_classes: int = 2,
) -> Dict:
    params: Dict = {"down": [], "up": [], "skipconv": []}
    ch = in_ch
    enc_chs = []
    for d in range(depth):
        out = base * (2**d)
        params["down"].append(
            {"c1": nn.init_conv(rng, ch, out),
             "c2": nn.init_conv(rng, out, out)}
        )
        enc_chs.append(out)
        ch = out
    params["bottleneck"] = {"c1": nn.init_conv(rng, ch, ch * 2)}
    ch = ch * 2
    for d in reversed(range(depth)):
        out = base * (2**d)
        params["up"].append(
            {"t": nn.init_conv(rng, ch, out, ksize=2),
             "c1": nn.init_conv(rng, out + enc_chs[d], out)}
        )
        ch = out
    params["head"] = nn.init_conv(rng, ch, num_classes, ksize=1)
    return params


def apply_unet(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> per-pixel logits (B, H, W, num_classes)."""
    skips = []
    for blk in params["down"]:
        x = torch.relu(nn.apply_conv(blk["c1"], x))
        x = torch.relu(nn.apply_conv(blk["c2"], x))
        skips.append(x)
        x = nn.max_pool(x, 2)
    x = torch.relu(nn.apply_conv(params["bottleneck"]["c1"], x))
    for blk, skip in zip(params["up"], reversed(skips)):
        x = nn.apply_conv_transpose(blk["t"], x, stride=2)
        x = torch.cat([x, skip], dim=-1)
        x = torch.relu(nn.apply_conv(blk["c1"], x))
    return nn.apply_conv(params["head"], x)
