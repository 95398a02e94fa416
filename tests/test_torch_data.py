"""Port data modules against the JAX package's: numpy on both sides, so the same seed
must give identical arrays and masks."""

import numpy as np
import pytest

from nanofed_tpu.data import batching as jb
from nanofed_tpu.data import datasets as jd
from nanofed_tpu.data import partition as jp
from nanofed_tpu.parallel.mesh import pad_clients as jax_pad_clients
from nanofed_tpu_torch.data import batching as tb
from nanofed_tpu_torch.data import datasets as td
from nanofed_tpu_torch.data import partition as tp


def _assert_same_dataset(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert (a.num_classes, a.name) == (b.num_classes, b.name)


def _assert_same_client_data(a, b):
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
        assert np.asarray(fa).dtype == np.asarray(fb).dtype


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_mnist_fallback_is_identical(split):
    _assert_same_dataset(td.load_mnist(split, synthetic_size=300),
                         jd.load_mnist(split, synthetic_size=300))


def test_mnist_readers_are_identical(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(20, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, size=(20,), dtype=np.uint8)
    np.savez(tmp_path / "mnist_train.npz", x=imgs, y=lbls)
    _assert_same_dataset(td.load_mnist("train", tmp_path), jd.load_mnist("train", tmp_path))
    idx_dir = tmp_path / "idx"
    idx_dir.mkdir()
    (idx_dir / "t10k-images-idx3-ubyte").write_bytes(
        np.array([0x0803, 20, 28, 28], ">u4").tobytes() + imgs.tobytes())
    (idx_dir / "t10k-labels-idx1-ubyte").write_bytes(
        np.array([0x0801, 20], ">u4").tobytes() + lbls.tobytes())
    _assert_same_dataset(td.load_mnist("test", idx_dir), jd.load_mnist("test", idx_dir))


def test_partitioners_are_identical():
    labels = jd.synthetic_classification(500, 10, (2,), seed=3).y
    for a, b in [
        (tp.iid_partition(500, 7, seed=1), jp.iid_partition(500, 7, seed=1)),
        (tp.iid_partition(500, 2, seed=1, proportions=[0.75, 0.25]),
         jp.iid_partition(500, 2, seed=1, proportions=[0.75, 0.25])),
        (tp.label_skew_partition(labels, 5, seed=2), jp.label_skew_partition(labels, 5, seed=2)),
        (tp.dirichlet_partition(labels, 6, alpha=0.3, seed=4),
         jp.dirichlet_partition(labels, 6, alpha=0.3, seed=4)),
    ]:
        assert len(a) == len(b)
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(tp.subset_iid(500, 0.3, seed=5), jp.subset_iid(500, 0.3, seed=5))


@pytest.mark.parametrize("scheme", ["iid", "label_skew", "dirichlet"])
def test_federate_pack_and_pad_are_identical(scheme):
    ds_t = td.synthetic_classification(300, 10, (4, 4, 1), seed=6)
    ds_j = jd.synthetic_classification(300, 10, (4, 4, 1), seed=6)
    a = tb.federate(ds_t, 6, scheme=scheme, batch_size=16, seed=7)
    b = jb.federate(ds_j, 6, scheme=scheme, batch_size=16, seed=7)
    _assert_same_client_data(a, b)
    _assert_same_client_data(tb.pad_clients(a, 8), jax_pad_clients(b, 8))
    _assert_same_client_data(tb.pack_eval(ds_t, 64), jb.pack_eval(ds_j, 64))
