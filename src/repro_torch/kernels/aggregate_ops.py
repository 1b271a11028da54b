"""Pytree-level weighted aggregation through the kernel.

The counterpart of ``src/repro/kernels/aggregate_ops.py``.
``aggregate_pytree`` views every leaf in tree order as a (K, n_i)
matrix and aggregates the list in one call: on the card one kernel
launch over all leaves (``aggregate_leaves``), which reads each leaf
where it lies, on the CPU a plain float32 sum (``weighted_sum_leaves``);
any other device raises.  Float32 and bfloat16 leaves go in as they are; a leaf of any other
dtype is cast to the leaves' promoted dtype first, as the reference
casts its whole stream, and every result is cast back to its leaf's
dtype.  The reference concatenates the leaves into one (K, N) stream
because its TPU kernel takes one array; both routes here compute each
element alone, so their results equal those of the same arithmetic on
the concatenation.
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.kernels.aggregate import DTYPES, aggregate_leaves
from repro_torch.kernels.aggregate_ref import weighted_sum_leaves
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any


def aggregate_pytree(stacked: PyTree, weights: torch.Tensor) -> PyTree:
    """stacked: pytree with leaves (K, ...); weights: (K,) normalized.
    Returns the weighted sum, each leaf in its own dtype."""
    leaves, treedef = tree_flatten(stacked)
    k = leaves[0].shape[0]
    device = leaves[0].device
    if device.type == "cuda":
        aggregate = aggregate_leaves
    elif device.type == "cpu":
        aggregate = weighted_sum_leaves
    else:
        raise ValueError(f"no aggregation path for device {device}")
    xs = [l.reshape(k, l.shape[1:].numel()) for l in leaves]
    if any(x.dtype not in DTYPES for x in xs):
        common = functools.reduce(torch.promote_types, [x.dtype for x in xs])
        xs = [x if x.dtype in DTYPES else x.to(common) for x in xs]
    w = weights.to(device=device, dtype=torch.float32).contiguous()
    outs = aggregate(xs, w)
    return tree_unflatten(treedef, [o.reshape(l.shape[1:]) if o.dtype == l.dtype
                                    else o.reshape(l.shape[1:]).to(l.dtype)
                                    for o, l in zip(outs, leaves)])
