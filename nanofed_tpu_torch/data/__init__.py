from nanofed_tpu_torch.data.batching import federate, pack_clients, pack_eval, pad_clients
from nanofed_tpu_torch.data.datasets import Dataset, load_mnist, synthetic_classification
from nanofed_tpu_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    label_skew_partition,
    subset_iid,
)

__all__ = [
    "Dataset",
    "dirichlet_partition",
    "federate",
    "iid_partition",
    "label_skew_partition",
    "load_mnist",
    "pack_clients",
    "pack_eval",
    "pad_clients",
    "subset_iid",
    "synthetic_classification",
]
