"""npz checkpointing, in the reference's format.

The counterpart of ``src/repro/ckpt/checkpoint.py``.  A pytree's leaves
go to one ``ckpt_{step:08d}.npz``, each under the key
``{i:05d}__{keypath}`` (flatten order, the key path joined with ``/``
and every unsafe character replaced by ``_``), so a checkpoint written
by either package restores in the other against the same template.

A bfloat16 leaf is written as the reference writes it: its raw 2-byte
words, which numpy stores as the void type ``|V2``.  Restore reads any
``|V2`` array back as bfloat16 bit for bit (the reference's own restore
cannot cast ``|V2`` and raises).  Restore returns tensors on the
template's devices, in the template's dtypes.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_flatten_with_path, tree_unflatten

PyTree = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.\-]")
_BF16_WORD = np.dtype("V2")


def _key_str(path) -> str:
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
    return _SAFE.sub("_", "/".join(parts))


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORD)
    return t.numpy()


def _to_leaf(a: np.ndarray, template: Any) -> Any:
    if not isinstance(template, torch.Tensor):
        return np.asarray(a, dtype=template.dtype) if hasattr(template, "dtype") else a
    if a.dtype == _BF16_WORD:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=template.device, dtype=template.dtype)


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    os.makedirs(directory, exist_ok=True)
    leaves = tree_flatten_with_path(tree)[0]
    arrays = {}
    for i, (path, leaf) in enumerate(leaves):
        arrays[f"{i:05d}__{_key_str(path)}"] = _to_numpy(leaf)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.match(r"ckpt_(\d+)\.npz$", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, template: PyTree) -> PyTree:
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        keys = sorted(data.files, key=lambda k: int(k.split("__")[0]))
        arrays = [data[k] for k in keys]
    leaves, treedef = tree_flatten(template)
    if len(arrays) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template {len(leaves)}"
        )
    return tree_unflatten(treedef, [_to_leaf(a, l) for a, l in zip(arrays, leaves)])
