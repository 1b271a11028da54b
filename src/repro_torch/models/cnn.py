"""The paper's deep CNN for MNIST/CIFAR-10 (§V-A).

The counterpart of ``init_cnn``/``apply_cnn`` in
``src/repro/models/cnn.py``: the same parameter pytree, NHWC inputs.
The U-Net is not ported yet.
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
