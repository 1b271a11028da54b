"""Pytree utilities over plain dict/list/tuple containers.

Parameters in the port stay nested dicts and lists of tensors, in the
reference's layout.  Flattening follows ``jax.tree_util`` order — dict
keys sorted, lists and tuples in order, NamedTuples in field order —
so the flattened ``(K, N)`` aggregation stream and the checkpoint's leaf
indices match the reference element for element.  Every object that is
not a dict, list or tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, NamedTuple, Tuple

import torch

PyTree = Any


class _Leaf:
    """Placeholder for a leaf inside a ``TreeDef`` skeleton."""

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


class TreeDef:
    """The container structure of a pytree, with its leaves removed."""

    def __init__(self, skeleton: Any, num_leaves: int):
        self.skeleton = skeleton
        self.num_leaves = num_leaves

    def __eq__(self, other: object) -> bool:
        return isinstance(other, TreeDef) and self.skeleton == other.skeleton

    def __repr__(self) -> str:
        return f"TreeDef({self.skeleton!r})"


def _rebuild(node: Any, children: List[Any]) -> Any:
    if isinstance(node, list):
        return children
    if hasattr(node, "_fields"):            # NamedTuple
        return type(node)(*children)
    return tuple(children)


def _flatten(tree: PyTree, leaves: List[Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [_flatten(t, leaves) for t in tree])
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    skeleton = _flatten(tree, leaves)
    return leaves, TreeDef(skeleton, len(leaves))


def _build(node: Any, leaves: Iterator[Any]) -> Any:
    if node is _LEAF:
        return next(leaves)
    if isinstance(node, dict):
        return {k: _build(v, leaves) for k, v in node.items()}
    return _rebuild(node, [_build(n, leaves) for n in node])


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> PyTree:
    # module-level recursion: a recursive closure is a reference cycle,
    # which would hold every leaf until the cyclic collector runs
    if len(leaves) != treedef.num_leaves:
        raise ValueError(
            f"treedef has {treedef.num_leaves} leaves, got {len(leaves)}"
        )
    return _build(treedef.skeleton, iter(leaves))


class DictKey(NamedTuple):
    key: Any


class SequenceKey(NamedTuple):
    idx: int


class GetAttrKey(NamedTuple):
    name: str


def _flatten_with_path(tree: PyTree, path: Tuple, out: List[Tuple[Tuple, Any]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_path(tree[k], path + (DictKey(k),), out)
    elif hasattr(tree, "_fields") and isinstance(tree, tuple):
        for name, child in zip(tree._fields, tree):
            _flatten_with_path(child, path + (GetAttrKey(name),), out)
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            _flatten_with_path(child, path + (SequenceKey(i),), out)
    else:
        out.append((path, tree))


def tree_flatten_with_path(tree: PyTree) -> Tuple[List[Tuple[Tuple, Any]], TreeDef]:
    """``[(key path, leaf), ...]`` in ``tree_flatten`` order, and the
    treedef.  A key path holds one ``DictKey(key)``, ``SequenceKey(idx)``
    or ``GetAttrKey(name)`` (a NamedTuple field) per level, with the
    attributes ``jax.tree_util.tree_flatten_with_path`` gives."""
    out: List[Tuple[Tuple, Any]] = []
    _flatten_with_path(tree, (), out)
    return out, tree_flatten(tree)[1]


def flatten_up_to(treedef: TreeDef, tree: PyTree) -> List[Any]:
    """The subtrees of ``tree`` found where ``treedef`` has its leaves,
    in order, as ``jax``'s ``treedef.flatten_up_to``: ``tree`` must have
    ``treedef``'s containers down to them."""
    out: List[Any] = []
    _walk_up_to(treedef, treedef.skeleton, tree, out)
    return out


def _walk_up_to(treedef: TreeDef, node: Any, sub: Any, out: List[Any]) -> None:
    if node is _LEAF:
        out.append(sub)
    elif isinstance(node, dict):
        if not isinstance(sub, dict) or sorted(sub) != list(node):
            raise ValueError(f"tree does not match {treedef}: {sub!r}")
        for k, child in node.items():
            _walk_up_to(treedef, child, sub[k], out)
    else:
        if type(sub) is not type(node) or len(sub) != len(node):
            raise ValueError(f"tree does not match {treedef}: {sub!r}")
        for child, s in zip(node, sub):
            _walk_up_to(treedef, child, s, out)


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (which
    must share its structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {r_def}")
        others.append(r_leaves)
    return tree_unflatten(
        treedef, [fn(*xs) for xs in zip(leaves, *others)]
    )


def stack(trees: List[PyTree]) -> PyTree:
    """Stack identically structured pytrees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def index(stacked: PyTree, i: int) -> PyTree:
    """Row ``i`` of every leaf of a stacked pytree."""
    return tree_map(lambda x: x[i], stacked)
