"""Parameter/activation sharding rules (FSDP x tensor parallel).

The counterpart of ``src/repro/launch/sharding.py``, with the same
path-regex roles: every pytree leaf gets a ``PartitionSpec`` by its
*name* (path) and trailing shape, then a divisibility guard: a dim is
sharded only if the mesh axis size divides it (e.g. GQA kv-head
projections with 8 kv heads replicate across a 16-way model axis
instead of sharding unevenly).  Leading "extra" dims (stacks (L, ...),
FedLEO orbit replicas) are padded with None on the left.

``PartitionSpec`` is a value-equal tuple of mesh-axis names (None, a
name, or a tuple of names); ``placements`` turns one into DTensor
placements, one per mesh dim.  A tuple axis ``("pod", "data")`` on one
tensor dim shards it over both mesh dims, pod-major, as JAX does.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

PyTree = Any

# name -> base spec for the TRAILING dims, using the roles:
#   F = FSDP axis ("data" [+ "pod"]), T = tensor axis ("model")
_RULES = [
    # attention
    (r"(^|/)wq$", ("F", "T", None)),
    (r"(^|/)wk$", ("F", "T", None)),
    (r"(^|/)wv$", ("F", "T", None)),
    (r"(^|/)wo$", ("T", None, "F")),
    # dense / shared-expert GLU FFN
    (r"(^|/)w_gate$", ("F", "T")),
    (r"(^|/)w_up$", ("F", "T")),
    (r"(^|/)w_down$", ("T", "F")),
    # MoE (leading expert dim -> expert parallel over T)
    (r"moe.*router$|(^|/)router$", ("F", None)),
    # embeddings / lm head
    (r"(^|/)table$", ("T", "F")),
    (r"lm_head.*(^|/)w$", ("F", "T")),
    # mamba2
    (r"(^|/)in_proj$", ("F", "T")),
    (r"(^|/)out_proj$", ("T", "F")),
    (r"(^|/)conv_w$", (None, "T")),
    (r"(^|/)conv_b$", ("T",)),
    # norms & scalars: replicated
    (r"(^|/)(scale|bias|A_log|D|dt_bias)$", None),
]

# MoE expert tensors carry a leading E dim; detect via path containing
# "moe" and 3 trailing dims on w_gate/w_up/w_down.
_MOE_RULES = [
    (r"(^|/)w_gate$", ("T", "F", None)),
    (r"(^|/)w_up$", ("T", "F", None)),
    (r"(^|/)w_down$", ("T", None, "F")),
]


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: ``PartitionSpec("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a ``Mesh``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """An abstract array: a fake tensor of the global shape (it allocates
    nothing) and, on a mesh, its sharding."""

    value: torch.Tensor
    sharding: Optional[NamedSharding] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def placements(spec: PartitionSpec, mesh: Mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that shards tensor dim d, ``Replicate()`` on the rest.  The
    names of a tuple axis must follow the mesh's order (then DTensor's
    default shard order is JAX's: the first name is the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        idx = [mesh.axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {names} of dim {dim} are not in the mesh's order "
                             f"{mesh.axis_names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {mesh.axis_names[i]!r} shards two dims of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _resolve(role, fsdp_axes, model_ax):
    if role == "F":
        if not fsdp_axes:
            return None          # TP-only / ZeRO-1 parameter layout
        return fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    if role == "T":
        return model_ax
    return None


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


def spec_for_leaf(
    path_str: str,
    shape: Tuple[int, ...],
    mesh: Mesh,
    fsdp_axes: Tuple[str, ...] = ("data",),
    model_ax: str = "model",
    leading_replica_axis: Optional[str] = None,
) -> PartitionSpec:
    """PartitionSpec for one leaf; unmatched names are replicated."""
    is_moe_expert = (
        "moe" in path_str
        and re.search(r"(^|/)(w_gate|w_up|w_down)$", path_str)
        and "shared" not in path_str
        and len(shape) >= 3
    )
    rules = _MOE_RULES if is_moe_expert else _RULES
    base = None
    matched = False
    for pat, spec in rules:
        if re.search(pat, path_str):
            base = spec
            matched = True
            break
    if not matched or base is None:
        base = ()

    ndim = len(shape)
    if len(base) > ndim:
        # optimizer-state leaf with reduced rank (adafactor row/col):
        # replicate — it is O(rows + cols), not worth sharding.
        base = ()
    pad = ndim - len(base)
    full = [None] * pad + [
        _resolve(r, fsdp_axes, model_ax) for r in base
    ]
    # divisibility guard
    out = []
    for dim, axis in zip(shape, full):
        if axis is not None and dim % _axis_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    if leading_replica_axis is not None and ndim >= 1:
        rep_size = mesh.shape[leading_replica_axis]
        if shape[0] % rep_size == 0:
            out[0] = leading_replica_axis
    return P(*out)


def tree_shardings(
    tree_shapes: PyTree,
    mesh: Mesh,
    fsdp_axes: Tuple[str, ...] = ("data",),
    model_ax: str = "model",
    leading_replica_axis: Optional[str] = None,
) -> PyTree:
    """NamedSharding tree matching a pytree of tensors or
    ShapeDtypeStructs."""
    pairs, treedef = tree_flatten_with_path(tree_shapes)
    return tree_unflatten(treedef, [
        NamedSharding(mesh, spec_for_leaf(_path_str(path), tuple(leaf.shape), mesh,
                                          fsdp_axes, model_ax, leading_replica_axis))
        for path, leaf in pairs
    ])


def with_shardings(tree_shapes: PyTree, shardings: PyTree) -> PyTree:
    """Pair each fake tensor with its sharding (what the dry run runs on)."""
    return tree_map(
        lambda s, sh: ShapeDtypeStruct(getattr(s, "value", s), sharding=sh),
        tree_shapes,
        shardings,
    )


def batch_sharding(mesh: Mesh, batch_size: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) that divides the batch."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    chosen = []
    size = 1
    for a in axes:
        if batch_size % (size * mesh.shape[a]) == 0:
            chosen.append(a)
            size *= mesh.shape[a]
    return tuple(chosen)
