"""Functional PyTorch optimizers over dict pytrees."""
from repro_torch.optim.optimizers import (
    Optimizer,
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
    "apply_updates",
    "clip_by_global_norm",
    "get_optimizer",
]
