"""Weighted model aggregation (paper eqs. 4 and 9).

The counterpart of ``src/repro/core/aggregation.py``:

  * ``weighted_average(stacked_params, weights)``: given a pytree whose
    leaves are stacked over a leading client axis and weights, computes
    sum_k a_k * theta_k with the weights normalized in fp32.  With
    ``use_kernel`` it goes through ``kernels.aggregate_ops`` — the CUDA
    kernel for tensors on the card — else through plain tensor ops.
  * ``partial_aggregate``: the sink satellite's per-orbit partial model
    w_{K_l} = sum_{k in K_l} (m_k / m_{K_l}) w_k^I               (9)
  * ``global_aggregate``: the GS's model w^{t+1} = sum_k (m_k / m) w_k
    (4), optionally blended with ``noniid_weights``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import index, stack, tree_leaves, tree_map

PyTree = Any


def _device(stacked: PyTree) -> torch.device:
    return tree_leaves(stacked)[0].device


def weighted_average(
    stacked: PyTree, weights: Any, use_kernel: bool = False
) -> PyTree:
    """sum_k weights[k] * leaf[k] for every leaf (leading axis = clients).

    Args:
      stacked: pytree with leaves of shape (K, ...).
      weights: (K,) nonnegative weights; normalized to sum to 1 in fp32.
      use_kernel: route through the aggregation kernel.

    ``weighted_average.calls`` counts the calls (a caller may reset it):
    with ``use_kernel`` on the card, each makes one aggregation kernel
    launch for a tree of up to ``kernels.aggregate.MAX_LEAVES`` leaves.
    """
    weighted_average.calls += 1
    w = torch.as_tensor(weights, dtype=torch.float32, device=_device(stacked))
    w = w / torch.sum(w)
    if use_kernel:
        from repro_torch.kernels import aggregate_ops

        return aggregate_ops.aggregate_pytree(stacked, w)

    def leaf(x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(w, x.float(), dims=1).to(x.dtype)

    return tree_map(leaf, stacked)


weighted_average.calls = 0


def partial_aggregate(
    stacked: PyTree, sample_counts: Sequence[int], use_kernel: bool = False
) -> PyTree:
    """Eq. (9): sink satellite's partial global model for one orbit."""
    return weighted_average(
        stacked, np.asarray(sample_counts, np.float32), use_kernel=use_kernel
    )


def global_aggregate(
    stacked: PyTree,
    sample_counts: Sequence[int],
    histograms: Optional[np.ndarray] = None,
    noniid_alpha: float = 0.0,
    use_kernel: bool = False,
) -> PyTree:
    """Eq. (4) with optional non-IID correction.

    Args:
      stacked: stacked partial (or client) models, leading axis K.
      sample_counts: m_k (or m_{K_l} for orbit partials).
      histograms: (K, num_classes) label histograms piggybacked during
        model propagation. If given and noniid_alpha > 0, weights are
        blended between data-size weighting and class-coverage-balanced
        weighting.
      noniid_alpha: 0 = pure eq. (4); 1 = fully class-balanced.
    """
    dev = _device(stacked)
    m = torch.as_tensor(np.asarray(sample_counts), dtype=torch.float32, device=dev)
    w = m / torch.sum(m)
    if histograms is not None and noniid_alpha > 0.0:
        w_bal = torch.as_tensor(
            noniid_weights(np.asarray(histograms)), dtype=torch.float32,
            device=dev,
        )
        w = (1.0 - noniid_alpha) * w + noniid_alpha * w_bal
        w = w / torch.sum(w)
    return weighted_average(stacked, w, use_kernel=use_kernel)


def noniid_weights(histograms: np.ndarray) -> np.ndarray:
    """Class-coverage-balanced weights from piggybacked label histograms.

    Each class's total mass is split equally among the contributors that
    hold it; a contributor's weight is its summed class shares.  Orbits
    holding classes nobody else has therefore keep their influence even
    when their m_k is small — the paper's motivation for uploading the
    data distribution with the partial model.
    """
    h = np.asarray(histograms, np.float64)
    class_tot = h.sum(axis=0, keepdims=True)       # (1, C)
    share = np.divide(h, class_tot, out=np.zeros_like(h), where=class_tot > 0)
    w = share.sum(axis=1)
    s = w.sum()
    if s <= 0:
        return np.full(h.shape[0], 1.0 / h.shape[0])
    return w / s


def stack_pytrees(trees: Sequence[PyTree]) -> PyTree:
    """Stack a list of identically-structured pytrees along a new axis 0."""
    return stack(list(trees))


def index_pytree(stacked: PyTree, i: int) -> PyTree:
    return index(stacked, i)
