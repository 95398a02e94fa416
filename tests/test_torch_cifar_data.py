"""Port data loaders, the runner's dataset choice and the benchmark suite against the
JAX package on the CPU: equal arrays from the same files and seeds, the same
``BENCHMARKS``, and each named benchmark run through both packages at the JAX smoke
sizes (the model overridden to ``mlp``, as the JAX package's own smoke test does).

Benchmark tolerances: 1e-4 for the float32 runs whose clients hold one batch (the
local permutations then only reorder a sum: ``mnist_iid``, ``cross_silo``), 1e-2
for the bfloat16 one (``mnist_1000``: 8 bits of mantissa); the rest (several batches
a client, so permutations from another generator, or central DP noise) must agree on
everything that does not depend on a random draw.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest

import nanofed_tpu.experiments as jax_experiments
from nanofed_tpu import data as jax_data
from nanofed_tpu.benchmarks import BENCHMARKS as JAX_BENCHMARKS
from nanofed_tpu.benchmarks import run_benchmark as jax_run_benchmark
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu_torch import data, experiments
from nanofed_tpu_torch.benchmarks import BENCHMARKS, run_benchmark
from nanofed_tpu_torch.experiments import load_datasets_for
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.utils.trees import from_numpy_params


def _write_batch(path, n, label_key, num_classes, seed):
    rng = np.random.default_rng(seed)
    batch = {b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
             label_key: rng.integers(0, num_classes, size=n).tolist()}
    with open(path, "wb") as fh:
        pickle.dump(batch, fh)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    """CIFAR-10 (two train batches and the test batch) and CIFAR-100 in the standard
    python pickle layout, small."""
    root = tmp_path_factory.mktemp("cifar")
    sub10, sub100 = root / "cifar-10-batches-py", root / "cifar-100-python"
    sub10.mkdir()
    sub100.mkdir()
    for i in (1, 2):
        _write_batch(sub10 / f"data_batch_{i}", 7, b"labels", 10, seed=i)
    _write_batch(sub10 / "test_batch", 5, b"labels", 10, seed=3)
    _write_batch(sub100 / "train", 9, b"fine_labels", 100, seed=4)
    _write_batch(sub100 / "test", 4, b"fine_labels", 100, seed=5)
    return root


def _same(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert (a.num_classes, a.name) == (b.num_classes, b.name)


@pytest.mark.parametrize("num_classes", [10, 100])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_cifar_files_equal_jax(cifar_dir, num_classes, split):
    got = data.load_cifar(split, cifar_dir, num_classes=num_classes)
    _same(got, jax_data.load_cifar(split, cifar_dir, num_classes=num_classes))
    assert got.x.shape[1:] == (32, 32, 3) and got.name == f"cifar{num_classes}"
    np.testing.assert_array_equal(data.CIFAR_MEAN, jax_data.datasets.CIFAR_MEAN)
    np.testing.assert_array_equal(data.CIFAR_STD, jax_data.datasets.CIFAR_STD)


@pytest.mark.parametrize("num_classes", [10, 100])
def test_load_cifar_synthetic_fallback_equals_jax(tmp_path, num_classes):
    for split in ("train", "test"):
        _same(data.load_cifar(split, tmp_path, num_classes=num_classes, synthetic_size=40),
              jax_data.load_cifar(split, tmp_path, num_classes=num_classes,
                                  synthetic_size=40))
    with pytest.raises(FileNotFoundError):
        data.load_cifar("train", tmp_path, num_classes, synthetic_fallback=False)


def test_load_digits_and_resize_equal_jax():
    pytest.importorskip("sklearn")
    for split in ("train", "test"):
        got = data.load_digits_dataset(split)
        _same(got, jax_data.load_digits_dataset(split))
    resized = data.resize_images(got, 28, 28)
    _same(resized, jax_data.datasets.resize_images(got, 28, 28))
    assert resized.x.shape[1:] == (28, 28, 1)


def test_load_digits_without_sklearn_raises_file_not_found(monkeypatch, tmp_path):
    """The port's digits need no scikit-learn (they ship with the package); only a
    missing bundled file raises ``FileNotFoundError``."""
    import sys

    from nanofed_tpu_torch.data import datasets

    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    assert len(data.load_digits_dataset()) == 1437
    monkeypatch.setattr(datasets, "DIGITS_FILE", tmp_path / "digits.csv.gz")
    with pytest.raises(FileNotFoundError, match="digits"):
        data.load_digits_dataset()


@pytest.mark.parametrize("model", ["mnist_cnn", "resnet8", "resnet18", "mlp", "linear"])
def test_load_datasets_for_equals_jax(model, cifar_dir):
    ours = load_datasets_for(get_model(model), None, 60, seed=3)
    theirs = jax_experiments.load_datasets_for(jax_get_model(model), None, 60, seed=3)
    for a, b in zip(ours, theirs):
        _same(a, b)
    if model == "resnet18":  # files under data_dir take precedence
        for a, b in zip(load_datasets_for(get_model(model), str(cifar_dir), 60),
                        jax_experiments.load_datasets_for(jax_get_model(model),
                                                          str(cifar_dir), 60)):
            _same(a, b)


def test_load_datasets_for_digits_equals_jax():
    pytest.importorskip("sklearn")
    for a, b in zip(load_datasets_for(get_model("digits_mlp"), None, None),
                    jax_experiments.load_datasets_for(jax_get_model("digits_mlp"), None,
                                                      None)):
        _same(a, b)


def test_token_streams_are_refused_with_their_item():
    """Token-stream models, which earlier slices refused here, now get the JAX
    runner's token streams: its vocabulary, sequence length and seeds, bit for bit."""
    lm, jax_lm = get_model("transformer_lm"), jax_get_model("transformer_lm")
    for a, b in zip(load_datasets_for(lm, None, 64, seed=2),
                    jax_experiments.load_datasets_for(jax_lm, None, 64, seed=2)):
        _same(a, b)


def test_benchmarks_equal_jax():
    assert BENCHMARKS == JAX_BENCHMARKS


# The JAX package's smoke sizes (tests/integration/test_benchmarks.py).
SMOKE = {
    "mnist_iid": dict(train_size=640, num_rounds=2),
    "mnist_labelskew": dict(train_size=1600, num_rounds=2, num_clients=16),
    "fedprox_cifar10": dict(train_size=512, num_rounds=1, num_clients=8),
    "dp_fedavg_mnist": dict(train_size=640, num_rounds=2),
    "cross_silo": dict(train_size=256, num_rounds=1),
    "mnist_1000": dict(train_size=640, num_rounds=2, num_clients=32, client_chunk=2),
}
NUMERIC_TOL = {"mnist_iid": 1e-4, "cross_silo": 1e-4, "mnist_1000": 1e-2}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_run_benchmark_matches_jax(name, tmp_path, monkeypatch):
    overrides = dict(SMOKE[name], model="mlp")
    jax_init = jax_get_model("mlp").init(jax.random.key(0))
    port_model = dataclasses.replace(
        get_model("mlp"),
        init=lambda gen: from_numpy_params(jax.device_get(jax_init), device="cpu"))
    monkeypatch.setattr(experiments, "get_model", lambda name: port_model)
    got = run_benchmark(name, out_dir=str(tmp_path / "port"), device="cpu", **overrides)
    want = jax_run_benchmark(name, out_dir=str(tmp_path / "jax"), **overrides)
    assert got["benchmark"] == want["benchmark"] == name
    assert got["rounds_completed"] == want["rounds_completed"] >= 1
    assert got["rounds_failed"] == want["rounds_failed"] == 0
    assert got["num_clients"] == want["num_clients"] and got["rounds_per_sec"] > 0
    train, jtrain = got["final_train_metrics"], want["final_train_metrics"]
    for key in ("samples", "participating_clients"):
        assert train[key] == jtrain[key]
    if name == "dp_fedavg_mnist":
        for key in ("epsilon_spent", "delta_spent"):
            np.testing.assert_allclose(got["privacy_spent"][key],
                                       want["privacy_spent"][key], rtol=1e-6)
    else:
        assert "privacy_spent" not in got and "privacy_spent" not in want
    tol = NUMERIC_TOL.get(name)
    if tol is not None:
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(got["final_eval_metrics"][key],
                                       want["final_eval_metrics"][key], rtol=tol, atol=tol)
            np.testing.assert_allclose(train[key], jtrain[key], rtol=tol, atol=tol)


def test_unknown_benchmark_raises():
    with pytest.raises(KeyError):
        run_benchmark("nope", device="cpu")
