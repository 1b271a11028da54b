"""Carry parameter pytrees between numpy arrays and torch tensors.

The reference package's parameters, turned into numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), load into the port
with ``params_from_numpy``; ``params_to_numpy`` goes the other way.
Both keep the pytree structure, NamedTuples and tuples included, so a
whole ``TrainState`` with its optimizer state (adafactor's ``(row, col)``
pairs too) carries across, and the reference layout (HWIO conv kernels,
``(in, out)`` dense weights).

bfloat16 has no numpy dtype of its own: arrays whose dtype is named
``bfloat16`` (the ``ml_dtypes`` type the reference hands out) are
reinterpreted bit for bit, and ``params_to_numpy`` widens bfloat16
tensors to float32, which is exact.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.tree import tree_map

PyTree = Any


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(
    tree: PyTree, device: Union[str, torch.device]
) -> PyTree:
    """numpy (or array-like) leaves -> tensors on ``device``."""
    dev = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(tree: PyTree) -> PyTree:
    """Tensor leaves -> numpy arrays on the host (bfloat16 as float32)."""
    return tree_map(_to_numpy, tree)
