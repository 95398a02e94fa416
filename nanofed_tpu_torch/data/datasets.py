"""Dataset loading (counterpart of ``nanofed_tpu/data/datasets.py``).

Host-side numpy, identical to the JAX package's for a seed: MNIST from IDX files or
an ``.npz`` under ``data_dir``, normalized with mean 0.1307 / std 0.3081, and a
deterministic synthetic fallback with the same shapes (class prototypes plus
Gaussian noise) when no files are present.  The digits, CIFAR and token-stream
loaders come with a later slice.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


@dataclass(frozen=True)
class Dataset:
    """A supervised dataset as host arrays: ``x`` [N, ...] float32, ``y`` [N] int32."""

    x: np.ndarray
    y: np.ndarray
    num_classes: int
    name: str = ""

    def __len__(self) -> int:
        return len(self.y)


def synthetic_classification(
    n: int,
    num_classes: int = 10,
    shape: tuple[int, ...] = (28, 28, 1),
    seed: int = 0,
    noise: float = 0.35,
    name: str = "synthetic",
    proto_seed: int = 1234,
) -> Dataset:
    """Learnable synthetic data: one fixed random prototype per class (keyed by
    ``proto_seed``, so train and test splits share the task) plus Gaussian noise
    (keyed by ``seed``)."""
    protos = (
        np.random.default_rng(proto_seed)
        .normal(0.0, 1.0, size=(num_classes, *shape))
        .astype(np.float32)
    )
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, noise, size=(n, *shape)).astype(np.float32)
    return Dataset(x=x, y=y, num_classes=num_classes, name=name)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(data_dir: Path, stem: str) -> Path | None:
    for cand in (stem, f"{stem}.gz"):
        p = data_dir / cand
        if p.exists():
            return p
    return None


def load_mnist(
    split: str = "train",
    data_dir: str | Path | None = None,
    synthetic_fallback: bool = True,
    synthetic_size: int | None = None,
) -> Dataset:
    """MNIST from IDX files (or ``mnist_<split>.npz`` of raw pixels) under
    ``data_dir``; synthetic MNIST-shaped data when none are present."""
    prefix = "train" if split == "train" else "t10k"
    if data_dir is not None:
        d = Path(data_dir)
        imgs = _find_idx(d, f"{prefix}-images-idx3-ubyte") or _find_idx(d, f"{prefix}-images.idx3-ubyte")
        lbls = _find_idx(d, f"{prefix}-labels-idx1-ubyte") or _find_idx(d, f"{prefix}-labels.idx1-ubyte")
        npz = d / f"mnist_{split}.npz"
        if imgs is not None and lbls is not None:
            x = _read_idx(imgs).astype(np.float32)[..., None] / 255.0
            x = (x - MNIST_MEAN) / MNIST_STD
            y = _read_idx(lbls).astype(np.int32)
            return Dataset(x=x, y=y, num_classes=10, name="mnist")
        if npz.exists():
            # Raw pixels only: integer [0, 255] or float [0, 1].
            z = np.load(npz)
            x = z["x"]
            if x.ndim == 3:
                x = x[..., None]
            if np.issubdtype(x.dtype, np.integer):
                x = x.astype(np.float32) / 255.0
            else:
                x = x.astype(np.float32)
                if x.max() > 1.0 + 1e-6:
                    raise ValueError(
                        f"{npz}: float images must be in [0, 1] (raw pixels); "
                        "got max value > 1"
                    )
            x = (x - MNIST_MEAN) / MNIST_STD
            return Dataset(x=x, y=z["y"].astype(np.int32), num_classes=10, name="mnist")
    if not synthetic_fallback:
        raise FileNotFoundError(f"MNIST not found under {data_dir!r}")
    n = synthetic_size or (60_000 if split == "train" else 10_000)
    return synthetic_classification(
        n, 10, (28, 28, 1), seed=0 if split == "train" else 1, name="mnist-synthetic"
    )
