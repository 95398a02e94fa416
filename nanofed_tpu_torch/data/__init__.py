from nanofed_tpu_torch.data.batching import federate, pack_clients, pack_eval, pad_clients
from nanofed_tpu_torch.data.datasets import (
    CIFAR_MEAN,
    CIFAR_STD,
    Dataset,
    load_cifar,
    load_digits_dataset,
    load_mnist,
    resize_images,
    synthetic_classification,
    synthetic_token_streams,
)
from nanofed_tpu_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    label_skew_partition,
    subset_iid,
)

__all__ = [
    "CIFAR_MEAN",
    "CIFAR_STD",
    "Dataset",
    "dirichlet_partition",
    "federate",
    "iid_partition",
    "label_skew_partition",
    "load_cifar",
    "load_digits_dataset",
    "load_mnist",
    "pack_clients",
    "pack_eval",
    "pad_clients",
    "resize_images",
    "subset_iid",
    "synthetic_classification",
    "synthetic_token_streams",
]
