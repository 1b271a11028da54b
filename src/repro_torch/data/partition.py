# Copied from src/repro/data/partition.py; imports rebound to repro_torch.
"""Federated data partitioning across the constellation.

The paper's §V-A setting:

  * IID: training images randomly shuffled and equally distributed
    across all satellites, each satellite having all 10 classes.
  * non-IID: satellites in two orbits train on 4 classes; satellites in
    the remaining three orbits train on the other 6 classes.

``ClientData`` also carries the per-client label histogram, which FedLEO
piggybacks onto model propagation and uploads with the partial global
model (used by the GS for non-IID-aware weighting).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import Dataset


@dataclasses.dataclass
class ClientData:
    plane: int
    slot: int
    data: Dataset

    @property
    def num_samples(self) -> int:            # m_k
        return len(self.data)

    @property
    def histogram(self) -> np.ndarray:       # piggybacked label distribution
        return label_histogram(self.data)


def label_histogram(ds: Dataset) -> np.ndarray:
    y = ds.y
    if y.ndim > 1:  # segmentation masks -> pixel histogram
        y = y.reshape(-1)
    return np.bincount(y, minlength=ds.num_classes).astype(np.float64)


def partition_iid(
    ds: Dataset,
    num_planes: int,
    sats_per_plane: int,
    seed: int = 0,
) -> List[ClientData]:
    """Shuffle and split evenly; every satellite sees all classes."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    num_clients = num_planes * sats_per_plane
    shards = np.array_split(idx, num_clients)
    clients = []
    for c, shard in enumerate(shards):
        clients.append(
            ClientData(
                plane=c // sats_per_plane,
                slot=c % sats_per_plane,
                data=ds.subset(np.sort(shard)),
            )
        )
    return clients


def partition_noniid_by_orbit(
    ds: Dataset,
    num_planes: int,
    sats_per_plane: int,
    num_planes_first_group: int = 2,
    classes_first_group: int = 4,
    seed: int = 0,
) -> List[ClientData]:
    """Paper's non-IID split: orbit-level class partition.

    Satellites in the first ``num_planes_first_group`` orbits get classes
    [0, classes_first_group); the remaining orbits get the rest.
    """
    rng = np.random.default_rng(seed)
    y = ds.y if ds.y.ndim == 1 else None
    if y is None:
        raise ValueError("non-IID orbit partition requires scalar labels")
    first_classes = set(range(classes_first_group))
    idx_first = np.nonzero(np.isin(ds.y, list(first_classes)))[0]
    idx_second = np.nonzero(~np.isin(ds.y, list(first_classes)))[0]
    rng.shuffle(idx_first)
    rng.shuffle(idx_second)

    n_first_sats = num_planes_first_group * sats_per_plane
    n_second_sats = (num_planes - num_planes_first_group) * sats_per_plane
    shards_first = np.array_split(idx_first, n_first_sats)
    shards_second = np.array_split(idx_second, n_second_sats)

    clients: List[ClientData] = []
    c1 = c2 = 0
    for p in range(num_planes):
        for s in range(sats_per_plane):
            if p < num_planes_first_group:
                shard = shards_first[c1]; c1 += 1
            else:
                shard = shards_second[c2]; c2 += 1
            clients.append(
                ClientData(plane=p, slot=s, data=ds.subset(np.sort(shard)))
            )
    return clients


def stack_client_arrays(
    clients: Sequence[ClientData],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad every client's data to the max m_k and stack for vmap training.

    Returns (x_stack, y_stack, counts): (C, M, ...), (C, M, ...), (C,).
    Padding repeats real samples (cyclic) so masked batching is not
    needed; the weighting uses the true counts m_k.
    """
    m_max = max(c.num_samples for c in clients)
    xs, ys, counts = [], [], []
    for c in clients:
        n = c.num_samples
        reps = np.resize(np.arange(n), m_max)
        xs.append(c.data.x[reps])
        ys.append(c.data.y[reps])
        counts.append(n)
    return np.stack(xs), np.stack(ys), np.asarray(counts, np.int32)
