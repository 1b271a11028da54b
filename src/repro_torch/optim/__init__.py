"""Functional PyTorch optimizers over dict pytrees."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adam,
    apply_updates,
    clip_by_global_norm,
    get_optimizer,
    momentum,
    sgd,
)

__all__ = [
    "Optimizer",
    "sgd",
    "momentum",
    "adam",
    "adafactor",
    "apply_updates",
    "clip_by_global_norm",
    "get_optimizer",
]
