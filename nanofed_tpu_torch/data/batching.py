"""Pack per-client samples into the padded batched layout (counterpart of
``nanofed_tpu/data/batching.py``, plus ``pad_clients`` from
``nanofed_tpu/parallel/mesh.py``).

Heterogeneous clients become one ``ClientData`` of numpy arrays ``[C, N_cap, ...]``
plus a {0,1} sample mask, identical to the JAX package's; FedAvg weights come from
``mask.sum()``, never from the padded capacity.
"""

from __future__ import annotations

import numpy as np

from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import partition as P
from nanofed_tpu_torch.data.datasets import Dataset


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pack_clients(
    dataset: Dataset,
    partitions: list[np.ndarray],
    batch_size: int = 1,
    capacity: int | None = None,
) -> ClientData:
    """Stacked ``ClientData`` ``[C, N_cap, ...]``; ``N_cap`` is the largest partition
    rounded up to a multiple of ``batch_size``, padded slots carry mask 0."""
    if not partitions:
        raise ValueError("need at least one client partition")
    sizes = [len(p) for p in partitions]
    cap = capacity if capacity is not None else max(1, max(sizes))
    cap = _round_up(cap, batch_size)
    if max(sizes) > cap:
        raise ValueError(f"capacity {cap} < largest partition {max(sizes)}")

    c = len(partitions)
    x = np.zeros((c, cap, *dataset.x.shape[1:]), dtype=dataset.x.dtype)
    y = np.zeros((c, cap), dtype=dataset.y.dtype)
    mask = np.zeros((c, cap), dtype=np.float32)
    for i, idx in enumerate(partitions):
        n = len(idx)
        x[i, :n] = dataset.x[idx]
        y[i, :n] = dataset.y[idx]
        mask[i, :n] = 1.0
    return ClientData(x=x, y=y, mask=mask)


def pack_eval(dataset: Dataset, batch_size: int = 256) -> ClientData:
    """Pack one evaluation dataset into batch-aligned padded arrays."""
    n = len(dataset)
    cap = _round_up(n, batch_size)
    x = np.zeros((cap, *dataset.x.shape[1:]), dtype=dataset.x.dtype)
    y = np.zeros((cap,), dtype=dataset.y.dtype)
    mask = np.zeros((cap,), dtype=np.float32)
    x[:n], y[:n], mask[:n] = dataset.x, dataset.y, 1.0
    return ClientData(x=x, y=y, mask=mask)


def federate(
    dataset: Dataset,
    num_clients: int,
    scheme: str = "iid",
    batch_size: int = 32,
    seed: int = 0,
    **scheme_kwargs,
) -> ClientData:
    """Partition ``dataset`` across ``num_clients`` (``iid`` / ``label_skew`` /
    ``dirichlet``) and pack."""
    if scheme == "iid":
        parts = P.iid_partition(len(dataset), num_clients, seed=seed, **scheme_kwargs)
    elif scheme == "label_skew":
        parts = P.label_skew_partition(dataset.y, num_clients, seed=seed, **scheme_kwargs)
    elif scheme == "dirichlet":
        parts = P.dirichlet_partition(dataset.y, num_clients, seed=seed, **scheme_kwargs)
    else:
        raise ValueError(f"unknown scheme '{scheme}'")
    return pack_clients(dataset, parts, batch_size=batch_size)


def pad_clients(data: ClientData, target: int) -> ClientData:
    """Pad the leading client axis to ``target`` with zero-mask (dummy) clients."""
    c = data.x.shape[0]
    if c == target:
        return data
    if c > target:
        raise ValueError(f"cannot pad {c} clients down to {target}")
    extra = target - c

    def pad(arr):
        widths = [(0, extra)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(np.asarray(arr), widths)

    return ClientData(x=pad(data.x), y=pad(data.y), mask=pad(data.mask))
