"""Where the port's entry points run.

``FederatedTask``, ``Transformer`` and ``build_model`` take
``device=None`` and resolve it here, all the same way: CUDA unless the
caller names another device.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  A missing card raises; nothing moves to the CPU
    quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
