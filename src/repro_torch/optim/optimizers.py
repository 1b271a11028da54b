"""Functional optimizers over dict pytrees: SGD, momentum, Adam, Adafactor.

The counterpart of ``src/repro/optim/optimizers.py``, in the same
optax-like style::

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

SGD, momentum and Adam update each element alone, so the same calls
serve parameters stacked over a leading client axis (``FederatedTask``'s
stand-in for ``vmap``).  Adafactor does not: its factored second moments
average a leaf's rows and columns, ``_is_factorable`` reads a leaf's last
two axes, and its RMS clip averages over the whole leaf, so it takes one
model's tree per call (``train/fedleo_step.py`` calls it per replica).
``clip_by_global_norm`` takes one norm over every leaf and is per model
too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import flatten_up_to, tree_flatten, tree_leaves, tree_map, tree_unflatten

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


# --- Adafactor -------------------------------------------------------------------
class AdafactorState(NamedTuple):
    step: torch.Tensor
    # per-leaf: either (row, col) factored second moments, or full `v`
    factored: PyTree


def _is_factorable(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018, simplified).

    Memory: O(sum of (rows + cols)) for matrix leaves instead of
    O(rows*cols).
    """

    def init(params):
        def leaf(p):
            if _is_factorable(p):
                row = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
                col = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                  device=p.device)
                return (row, col)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdafactorState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            factored=tree_map(leaf, params),
        )

    def update(grads, state, params=None):
        step = state.step + 1
        beta2 = 1.0 - step.float() ** (-decay)

        def leaf(g, f):
            g = g.float()
            g2 = torch.square(g) + eps
            if isinstance(f, tuple):
                row, col = f
                new_row = beta2 * row + (1 - beta2) * torch.mean(g2, dim=-1)
                new_col = beta2 * col + (1 - beta2) * torch.mean(g2, dim=-2)
                # rank-1 reconstruction of the second moment
                denom = torch.mean(new_row, dim=-1, keepdim=True)
                v_hat = new_row[..., :, None] * new_col[..., None, :] / (denom[..., None] + eps)
                u = g / (torch.sqrt(v_hat) + eps)
                new_f = (new_row, new_col)
            else:
                new_v = beta2 * f + (1 - beta2) * g2
                u = g / (torch.sqrt(new_v) + eps)
                new_f = new_v
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr * u, new_f

        flat_g, treedef = tree_flatten(grads)
        flat_f = flatten_up_to(treedef, state.factored)
        outs = [leaf(g, f) for g, f in zip(flat_g, flat_f)]
        updates = tree_unflatten(treedef, [o[0] for o in outs])
        new_factored = tree_unflatten(treedef, [o[1] for o in outs])
        return updates, AdafactorState(step=step, factored=new_factored)

    return Optimizer(init=init, update=update, name="adafactor")


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adafactor": adafactor,
}


def get_optimizer(name: str, lr: float, **kwargs) -> Optimizer:
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](lr, **kwargs)
