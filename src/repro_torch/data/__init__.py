"""Data pipeline: synthetic datasets + federated (non-)IID partitioning."""
from repro_torch.data.synthetic import (
    make_classification_dataset,
    make_segmentation_dataset,
    make_token_dataset,
    Dataset,
)
from repro_torch.data.partition import (
    partition_iid,
    partition_noniid_by_orbit,
    label_histogram,
    ClientData,
)

__all__ = [
    "make_classification_dataset",
    "make_segmentation_dataset",
    "make_token_dataset",
    "Dataset",
    "partition_iid",
    "partition_noniid_by_orbit",
    "label_histogram",
    "ClientData",
]
