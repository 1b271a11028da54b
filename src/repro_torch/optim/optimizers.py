"""Functional optimizers over dict pytrees: SGD, momentum, Adam.

The counterpart of ``src/repro/optim/optimizers.py``, in the same
optax-like style::

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Every update is elementwise, so the same calls serve parameters stacked
over a leading client axis (the port's stand-in for ``vmap``).
Adafactor is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], Tuple[PyTree, PyTree]]
    name: str = "optimizer"


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


# --- SGD ---------------------------------------------------------------------
def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init=init, update=update, name="sgd")


# --- SGD with momentum --------------------------------------------------------
class MomentumState(NamedTuple):
    velocity: PyTree


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(velocity=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        vel = tree_map(lambda v, g: beta * v + g, state.velocity, grads)
        if nesterov:
            updates = tree_map(lambda v, g: -lr * (beta * v + g), vel, grads)
        else:
            updates = tree_map(lambda v: -lr * v, vel)
        return updates, MomentumState(velocity=vel)

    return Optimizer(init=init, update=update, name="momentum")


# --- Adam ----------------------------------------------------------------------
class AdamState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def adam(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(f32, params),
            nu=tree_map(f32, params),
        )

    def update(grads, state, params=None):
        step = state.step + 1
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.nu, g32
        )
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def upd(m, v):
            return -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

        if weight_decay and params is not None:
            updates = tree_map(
                lambda m, v, p: upd(m, v) - lr * weight_decay * p.float(),
                mu, nu, params,
            )
        else:
            updates = tree_map(upd, mu, nu)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update, name="adam")


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
}
_NOT_PORTED = ("adafactor",)


def get_optimizer(name: str, lr: float, **kwargs) -> Optimizer:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](lr, **kwargs)
