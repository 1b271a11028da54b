"""FedLEO's orbit replicas: local steps and the sink + GS aggregation.

The counterpart of ``src/repro/train/fedleo_step.py``.  Each *orbit
replica* r keeps its own copy of the training state (leading axis R on
every leaf) and runs ``tau`` local steps; every tau steps
``make_fedleo_aggregate`` takes the weighted mean over the replica axis
(eqs. 9/4) of the parameters and of the optimizer state.

The reference maps ``train_step`` over the replicas with ``jax.vmap``.
Here ``make_fedleo_local_step`` runs it on each replica in turn, on
views of the stacked state: the global-norm clip, adafactor's
``_is_factorable`` and its RMS clip each see one replica, never the
stack.

Every function here is out of place.  ``replicate_for_orbits`` and the
aggregate give each replica a view of one tensor (``expand``, as the
reference's ``broadcast_to``): nothing may write into them in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.optim import Optimizer
from repro_torch.train.steps import TrainState, make_train_step
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any


def replicate_for_orbits(tree: PyTree, num_orbits: int) -> PyTree:
    """Add the leading orbit-replica axis R to every leaf (a view)."""
    return tree_map(lambda p: p.expand((num_orbits,) + tuple(p.shape)), tree)


def make_fedleo_local_step(
    model, optimizer: Optimizer, grad_clip: Optional[float] = 1.0,
    num_local_steps: int = 1,
) -> Callable:
    """Per-orbit local training: ``train_step`` on each replica in turn.

    state leaves: (R, ...); batch leaves: (R, tau, B_local, ...), of
    which the first ``num_local_steps`` slices of the tau axis are used,
    one a step.  Returns the new stacked state (fresh tensors) and the
    last step's metrics stacked over R.
    """
    train_step = make_train_step(model, optimizer, grad_clip)

    def local_step(state: TrainState, batches: Dict):
        r = tree_leaves(batches)[0].shape[0]
        out = metrics = None
        for i in range(r):
            st = tree_map(lambda x: x[i], state)
            for t in range(num_local_steps):
                st, m = train_step(st, tree_map(lambda b: b[i, t], batches))
            if out is None:
                out = tree_map(lambda x: x.new_empty((r,) + tuple(x.shape)), st)
                metrics = tree_map(lambda x: x.new_empty((r,) + tuple(x.shape)), m)
            tree_map(lambda o, x: o[i].copy_(x), out, st)
            tree_map(lambda o, x: o[i].copy_(x), metrics, m)
            del st      # before the next replica, so one replica's new state is alive
        return out, metrics

    return local_step


def staleness_weights(
    weights: torch.Tensor,
    staleness_s: torch.Tensor,
    *,
    power: float = 0.5,
    time_scale_s: float = 3600.0,
) -> torch.Tensor:
    """Discount replica weights by model staleness (async eq. 12 form):
    w_r / (1 + staleness/scale)^power.  A replica that trained on the
    freshest global model keeps its full sample weight; one acting on an
    hour-old model is discounted by ~2^-power.  Zero staleness returns
    ``weights`` unchanged."""
    age = torch.clamp(staleness_s, min=0.0) / time_scale_s
    return weights / (1.0 + age) ** power


def make_fedleo_aggregate(use_kernel: bool = False) -> Callable:
    """Sink + GS aggregation: weighted mean over the orbit-replica axis.

    weights: (R,) = m_{K_l} / m (eq. 4 over orbit partials).  Optimizer
    state is aggregated the same way, so replicas restart from a common
    point.  A leaf is replicated when its leading axis has R entries;
    other leaves pass through.  The mean is written back to every
    replica as a view of one tensor.

    ``use_kernel`` sends the replicated leaves of the parameters, and
    then those of the optimizer state, to
    ``kernels.aggregate_ops.aggregate_pytree``: one K1 launch for each
    of the two trees that has a replicated leaf (SGD's state ``()`` has
    none).  Leaves of other dtypes (Adam's int32 step counter) go
    through it as float32 and are cast back, truncating, as the
    reference casts them.  Without it the mean is a float32 sum of
    products per leaf.  An optional ``staleness_s`` (R,) discounts each
    replica's weight (``staleness_weights``) before normalizing.
    """

    def aggregate(
        state: TrainState,
        weights: torch.Tensor,
        staleness_s: Optional[torch.Tensor] = None,
    ) -> TrainState:
        if staleness_s is not None:
            weights = staleness_weights(weights, staleness_s)
        w = weights / torch.sum(weights)
        r = w.shape[0]

        def is_replicated(x) -> bool:
            return x.ndim != 0 and x.shape[0] == r

        def mean_leaf(x):
            if not is_replicated(x):
                return x
            wx = w.to(x.device).reshape((r,) + (1,) * (x.ndim - 1)).float()
            m = torch.sum(wx * x.float(), dim=0)
            return m.to(x.dtype).expand(x.shape)

        def mean_tree_kernel(tree: PyTree) -> PyTree:
            """One kernel launch over every replicated leaf; the rest
            (step counters, scalars) pass through untouched."""
            from repro_torch.kernels.aggregate_ops import aggregate_pytree

            leaves, treedef = tree_flatten(tree)
            elig = [i for i, x in enumerate(leaves) if is_replicated(x)]
            if elig:
                agg = aggregate_pytree([leaves[i] for i in elig], w)
                for i, m in zip(elig, agg):
                    leaves[i] = m.expand(leaves[i].shape)
            return tree_unflatten(treedef, leaves)

        with torch.no_grad():
            if use_kernel:
                agg_params = mean_tree_kernel(state.params)
                agg_opt = mean_tree_kernel(state.opt_state)
            else:
                agg_params = tree_map(mean_leaf, state.params)
                agg_opt = tree_map(mean_leaf, state.opt_state)
        return TrainState(params=agg_params, opt_state=agg_opt, step=state.step)

    return aggregate
