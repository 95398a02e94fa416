"""Client partitioners (counterpart of ``nanofed_tpu/data/partition.py``).

Host-side numpy returning per-client index arrays, identical to the JAX package's
for a seed: IID (optionally with unequal proportions), the random IID subset,
pathological label skew, and Dirichlet label splits.
"""

from __future__ import annotations

import numpy as np


def iid_partition(
    n_samples: int, num_clients: int, seed: int = 0, proportions: list[float] | None = None
) -> list[np.ndarray]:
    """Shuffle and split indices across clients; with ``proportions`` (summing to
    <= 1) clients get unequal shares (the tutorial's 12k/4k split is
    ``[0.75, 0.25]`` of 16k)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    if proportions is None:
        return [np.sort(s) for s in np.array_split(perm, num_clients)]
    if len(proportions) != num_clients:
        raise ValueError("len(proportions) must equal num_clients")
    sizes = [int(p * n_samples) for p in proportions]
    if sum(sizes) > n_samples:
        raise ValueError("proportions exceed dataset size")
    out, start = [], 0
    for s in sizes:
        out.append(np.sort(perm[start : start + s]))
        start += s
    return out


def subset_iid(n_samples: int, subset_fraction: float, seed: int = 0) -> np.ndarray:
    """Random IID subset of ``subset_fraction`` of the samples."""
    if not 0.0 < subset_fraction <= 1.0:
        raise ValueError("subset_fraction must be in (0, 1]")
    rng = np.random.default_rng(seed)
    k = int(n_samples * subset_fraction)
    return np.sort(rng.choice(n_samples, size=k, replace=False))


def label_skew_partition(
    labels: np.ndarray, num_clients: int, shards_per_client: int = 2, seed: int = 0
) -> list[np.ndarray]:
    """McMahan et al. 2017's pathological non-IID split: sort by label, cut into
    ``num_clients * shards_per_client`` shards, deal ``shards_per_client`` random
    shards to each client."""
    rng = np.random.default_rng(seed)
    n_shards = num_clients * shards_per_client
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_shards)
    assignment = rng.permutation(n_shards)
    out = []
    for c in range(num_clients):
        mine = assignment[c * shards_per_client : (c + 1) * shards_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in mine])))
    return out


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    min_samples: int = 1,
) -> list[np.ndarray]:
    """Dirichlet(alpha) label split (Hsu et al. 2019), resampled until every client
    has at least ``min_samples``."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _attempt in range(100):
        buckets: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
        for k in range(n_classes):
            idx = np.flatnonzero(labels == k)
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
            for c, part in enumerate(np.split(idx, cuts)):
                buckets[c].append(part)
        out = [np.sort(np.concatenate(b)) if b else np.array([], dtype=int) for b in buckets]
        if min(len(o) for o in out) >= min_samples:
            return out
    raise RuntimeError("dirichlet_partition failed to satisfy min_samples; raise alpha")
