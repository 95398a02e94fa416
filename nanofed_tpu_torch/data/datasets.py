"""Dataset loading (counterpart of ``nanofed_tpu/data/datasets.py``).

Host-side numpy, identical to the JAX package's for a seed: MNIST from IDX files or
an ``.npz`` under ``data_dir``, normalized with mean 0.1307 / std 0.3081; CIFAR-10/100
from the standard python pickle layout (``cifar-10-batches-py/``,
``cifar-100-python/`` under ``data_dir``), normalized per channel; and a
deterministic synthetic fallback with the same shapes (class prototypes plus
Gaussian noise) when no files are present.  Nothing is downloaded.  Also the
handwritten digits, a bilinear resize, and the seeded Markov-chain token streams of
the causal transformer LM.

The digits ship with the package as ``digits.csv.gz`` (1,797 rows of 64 pixels and a
label): the UCI "Optical Recognition of Handwritten Digits" test set (E. Alpaydin and
C. Kaynak, 1998) as scikit-learn distributes it under the BSD-3-Clause license, byte
for byte, so the loader needs no scikit-learn.  The JAX package reads the same data
through scikit-learn.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import pickle
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], dtype=np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], dtype=np.float32)


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


def synthetic_token_streams(
    n: int,
    vocab: int = 256,
    seq_len: int = 32,
    seed: int = 0,
    temperature: float = 0.35,
    name: str = "synthetic_tokens",
    chain_seed: int = 4321,
) -> Dataset:
    """Learnable token streams for the causal LM: ``x`` is ``[N, seq_len]`` int32 ids
    drawn from a fixed first-order Markov chain, ``y`` the true next token after
    each sequence.  The chain's transition matrix is keyed by ``chain_seed`` apart
    from the sample draw (``seed``), so train and test splits share the language;
    ``temperature`` sets how peaked each row is.  The JAX package's draws, bit for
    bit."""
    if vocab < 2:
        raise ValueError(f"vocab must be >= 2, got {vocab}")
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    chain_rng = np.random.default_rng(chain_seed)
    # Softmax of scaled Gaussians: full support (finite NLL everywhere), most of each
    # row's mass on a few successors.
    logits = chain_rng.normal(0.0, 1.0, size=(vocab, vocab)) / max(temperature, 1e-3)
    logits -= logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    cdf = np.cumsum(probs, axis=1)

    rng = np.random.default_rng(seed)
    tokens = np.empty((n, seq_len + 1), dtype=np.int32)
    tokens[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, seq_len + 1):
        u = rng.random(n)
        # One inverse-CDF step of the chain for the whole batch.
        tokens[:, t] = np.minimum(
            (cdf[tokens[:, t - 1]] < u[:, None]).sum(axis=1), vocab - 1
        ).astype(np.int32)
    return Dataset(x=tokens[:, :seq_len], y=tokens[:, seq_len], num_classes=vocab, name=name)


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


DIGITS_FILE = Path(__file__).resolve().parent / "digits.csv.gz"
DIGITS_SHA256 = "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22"


def load_digits_dataset(split: str = "train", test_fraction: float = 0.2) -> Dataset:
    """The handwritten digits (1,797 real 8x8 images, UCI optdigits) from the bundled
    :data:`DIGITS_FILE`, pixels scaled to [0, 1], split by a seeded shuffle with the
    last ``test_fraction`` held out.  Raises ``FileNotFoundError`` when the file is
    missing and ``ValueError`` when its sha256 is not :data:`DIGITS_SHA256`."""
    try:
        raw = DIGITS_FILE.read_bytes()
    except FileNotFoundError as e:
        raise FileNotFoundError(f"the bundled digits file {DIGITS_FILE} is missing") from e
    digest = hashlib.sha256(raw).hexdigest()
    if digest != DIGITS_SHA256:
        raise ValueError(f"{DIGITS_FILE}: sha256 {digest}, expected {DIGITS_SHA256}")
    table = np.loadtxt(io.BytesIO(gzip.decompress(raw)), delimiter=",")
    x = (table[:, :64].reshape(-1, 8, 8, 1) / 16.0).astype(np.float32)  # pixels are 0..16
    y = table[:, 64].astype(np.int32)
    order = np.random.default_rng(0).permutation(len(y))
    x, y = x[order], y[order]
    cut = int(len(y) * (1.0 - test_fraction))
    if split == "train":
        x, y = x[:cut], y[:cut]
    else:
        x, y = x[cut:], y[cut:]
    return Dataset(x=x, y=y, num_classes=10, name="digits")


def resize_images(ds: Dataset, height: int, width: int) -> Dataset:
    """Bilinearly resize an image dataset (``x`` [N, H, W, C]) to ``height x width``
    with scipy's ``zoom`` (order 1); labels are untouched."""
    from scipy.ndimage import zoom

    n, h, w, c = ds.x.shape
    x = zoom(ds.x, (1, height / h, width / w, 1), order=1).astype(np.float32)
    if x.shape != (n, height, width, c):
        raise ValueError(f"resize to {height}x{width} gave shape {x.shape}")
    return Dataset(
        x=x, y=ds.y, num_classes=ds.num_classes, name=f"{ds.name}@{height}x{width}"
    )


def _load_cifar_batches(files: list[Path], label_key: bytes) -> tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for f in files:
        with open(f, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        xs.append(batch[b"data"])
        ys.append(np.asarray(batch[label_key]))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    x = (x - CIFAR_MEAN) / CIFAR_STD
    return x, np.concatenate(ys).astype(np.int32)


def load_cifar(
    split: str = "train",
    data_dir: str | Path | None = None,
    num_classes: int = 10,
    synthetic_fallback: bool = True,
    synthetic_size: int | None = None,
) -> Dataset:
    """CIFAR-10/100 from the standard python pickle layout under ``data_dir``
    (``cifar-10-batches-py/data_batch_*`` and ``test_batch``; ``cifar-100-python/train``
    and ``test``, fine labels), NHWC and normalized per channel; synthetic
    CIFAR-shaped data (seed 2 for train, 3 for test) when none are present."""
    name = f"cifar{num_classes}"
    if data_dir is not None:
        d = Path(data_dir)
        sub10, sub100 = d / "cifar-10-batches-py", d / "cifar-100-python"
        if num_classes == 10 and sub10.exists():
            files = (
                sorted(sub10.glob("data_batch_*")) if split == "train" else [sub10 / "test_batch"]
            )
            x, y = _load_cifar_batches(files, b"labels")
            return Dataset(x=x, y=y, num_classes=10, name=name)
        if num_classes == 100 and sub100.exists():
            files = [sub100 / ("train" if split == "train" else "test")]
            x, y = _load_cifar_batches(files, b"fine_labels")
            return Dataset(x=x, y=y, num_classes=100, name=name)
    if not synthetic_fallback:
        raise FileNotFoundError(f"CIFAR-{num_classes} not found under {data_dir!r}")
    n = synthetic_size or (50_000 if split == "train" else 10_000)
    return synthetic_classification(
        n, num_classes, (32, 32, 3), seed=(2 if split == "train" else 3), name=f"{name}-synthetic"
    )
