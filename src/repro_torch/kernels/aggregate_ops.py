"""Pytree-level weighted aggregation through the kernel.

The counterpart of ``src/repro/kernels/aggregate_ops.py``.
``aggregate_pytree`` flattens every leaf in tree order, casts it to the
leaves' promoted dtype, concatenates everything into one (K, N) stream
(one kernel launch instead of one per leaf) and splits the result back.
A CUDA stream goes to the kernel, a CPU stream to the plain version;
any other device raises.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch.kernels.aggregate import aggregate_flat
from repro_torch.kernels.aggregate_ref import aggregate_flat_ref
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any


def aggregate_pytree(stacked: PyTree, weights: torch.Tensor) -> PyTree:
    """stacked: pytree with leaves (K, ...); weights: (K,) normalized.
    Returns the weighted sum, each leaf in its own dtype."""
    leaves, treedef = tree_flatten(stacked)
    k = leaves[0].shape[0]
    shapes = [l.shape[1:] for l in leaves]
    sizes = [math.prod(s) for s in shapes]
    dtypes = [l.dtype for l in leaves]
    common = functools.reduce(torch.promote_types, dtypes)
    flat = torch.cat([l.reshape(k, -1).to(common) for l in leaves], dim=1)
    w = weights.to(device=flat.device, dtype=torch.float32).contiguous()
    if flat.device.type == "cuda":
        agg = aggregate_flat(flat, w)
    elif flat.device.type == "cpu":
        agg = aggregate_flat_ref(flat, w)
    else:
        raise ValueError(f"no aggregation path for device {flat.device}")
    outs = [
        part.reshape(shape).to(dt)
        for part, shape, dt in zip(torch.split(agg, sizes), shapes, dtypes)
    ]
    return tree_unflatten(treedef, outs)
