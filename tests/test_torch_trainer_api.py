"""The standalone ``Trainer``, its callbacks and personalized evaluation of the port
against the JAX package (``nanofed_tpu.trainer.{api,callbacks,personalization}``) on
the CPU.

Both sides start from the same JAX-initialised ``mlp`` weights (no dropout) and the
port gets the JAX fits' own permutations.  Tolerance 1e-5 (float32 SGD steps summed
in another order); the callbacks' event order, the JSON file's structure and the
split masks exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.api import Trainer as JaxTrainer
from nanofed_tpu.trainer.callbacks import MetricsLogger as JaxMetricsLogger
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu.trainer.personalization import (
    make_personalized_evaluator as jax_make_personalized_evaluator,
)
from nanofed_tpu.trainer.personalization import split_client_data as jax_split_client_data
from nanofed_tpu_torch.core.interfaces import LocalFitFn, ModelProtocol
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.trainer import (
    BaseCallback,
    Callback,
    MetricsLogger,
    TelemetryCallback,
    Trainer,
    TrainingConfig,
    draw_permutations,
    make_local_fit,
    make_personalized_evaluator,
    split_client_data,
)
from nanofed_tpu_torch.utils.trees import from_numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)
MLP = dict(in_features=16, hidden=32, num_classes=4)
HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.1)


def _jax_permutations(rngs, epochs, n):
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


@pytest.fixture(scope="module")
def models():
    jm = jax_get_model("mlp", **MLP)
    jparams = jax.device_get(jm.init(jax.random.key(0)))
    japply = lambda p, x, train=False, rng=None: jm.apply(p, x)  # noqa: E731
    return japply, jparams, get_model("mlp", **MLP), from_numpy_params(jparams, device="cpu")


def _client(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-3:] = 0.0
    return x, y, mask


class Recorder(BaseCallback):
    """Records every hook call, in order."""

    def __init__(self):
        self.events = []

    def on_epoch_start(self, epoch):
        self.events.append(("start", epoch))

    def on_batch_end(self, epoch, batch, metrics):
        self.events.append(("batch", epoch, batch, metrics["loss"]))

    def on_epoch_end(self, epoch, metrics):
        self.events.append(("end", epoch, metrics["loss"], metrics["accuracy"]))


def _close_events(got, want):
    assert [e[:2] if e[0] != "batch" else e[:3] for e in got] == [
        e[:2] if e[0] != "batch" else e[:3] for e in want]
    for g, w in zip(got, want):
        values = g[3:] if g[0] == "batch" else g[2:]
        ref = w[3:] if w[0] == "batch" else w[2:]
        np.testing.assert_allclose(values, ref, **TOL)


def test_trainer_fit_and_evaluate_match_jax(models, tmp_path):
    japply, jparams, model, params = models
    x, y, mask = _client()
    rng = jax.random.key(3)
    jrec, rec = Recorder(), Recorder()
    jtrainer = JaxTrainer(japply, JaxTrainingConfig(**HYPER),
                          callbacks=[jrec, JaxMetricsLogger(tmp_path / "jax.json", "c0")])
    want_params, want = jtrainer.fit(jparams, JaxClientData(*(jnp.asarray(a) for a in
                                                              (x, y, mask))), rng)
    trainer = Trainer(model, TrainingConfig(**HYPER),
                      callbacks=[rec, MetricsLogger(tmp_path / "port.json", "c0")], device="cpu")
    assert trainer.config.collect_batch_metrics  # forced on by the callbacks
    got_params, got = trainer.fit(params, ClientData(x, y, mask),
                                  perms=_jax_permutations([rng], 2, len(y))[0])
    for name, leaf in from_numpy_params(jax.device_get(want_params), device="cpu").items():
        torch.testing.assert_close(got_params[name], leaf, **TOL)
    assert got["samples_processed"] == want["samples_processed"] == 9
    np.testing.assert_allclose([got["loss"], got["accuracy"]],
                               [want["loss"], want["accuracy"]], **TOL)
    _close_events(rec.events, jrec.events)

    jfile = json.loads((tmp_path / "jax.json").read_text())
    pfile = json.loads((tmp_path / "port.json").read_text())
    assert jfile.keys() == pfile.keys() and pfile["client_id"] == "c0"
    for section in ("epochs", "batches"):
        assert [sorted(r) for r in pfile[section]] == [sorted(r) for r in jfile[section]]
        for pr, jr in zip(pfile[section], jfile[section]):
            for key in pr:
                np.testing.assert_allclose(pr[key], jr[key], **TOL)

    ev_x, ev_y, ev_m = _client(n=30, seed=4)
    want_eval = jtrainer.evaluate(jparams, JaxClientData(*(jnp.asarray(a) for a in
                                                           (ev_x, ev_y, ev_m))))
    got_eval = trainer.evaluate(params, ClientData(ev_x, ev_y, ev_m))
    np.testing.assert_allclose([got_eval["loss"], got_eval["accuracy"]],
                               [want_eval["loss"], want_eval["accuracy"]], **TOL)


def test_trainer_fit_is_make_local_fit(models):
    """The Trainer is the round's fit over a stack of one client, bit for bit."""
    _, _, model, params = models
    x, y, mask = _client()
    trainer = Trainer(model, TrainingConfig(**HYPER), device="cpu")
    got, _ = trainer.fit(params, ClientData(x, y, mask), seed=5)
    perms = draw_permutations(torch.Generator().manual_seed(5), 1, 2, 12)
    want = make_local_fit(model, TrainingConfig(**HYPER))(
        params, ClientData(x[None], y[None], mask[None]).to(torch.device("cpu")), perms)
    assert all(torch.equal(got[k], want.params[k][0]) for k in params)


def test_telemetry_callback_feeds_the_registry(models):
    _, _, model, params = models
    x, y, mask = _client()
    registry = MetricsRegistry()
    trainer = Trainer(model, TrainingConfig(**HYPER),
                      callbacks=[TelemetryCallback("c7", registry=registry)], device="cpu")
    _, final = trainer.fit(params, ClientData(x, y, mask), seed=1)
    snap = registry.snapshot()
    epochs = registry.counter("nanofed_local_epochs_total", labels=("client",))
    batches = registry.counter("nanofed_local_batches_total", labels=("client",))
    assert epochs.value(client="c7") == 2 and batches.value(client="c7") == 6
    loss = registry.gauge("nanofed_local_last_loss", labels=("client",)).value(client="c7")
    assert loss == pytest.approx(final["loss"])
    hist = registry.histogram("nanofed_local_epoch_loss", labels=("client",),
                              buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0))
    assert hist.sample_count(client="c7") == 2
    assert "nanofed_local_last_accuracy" in snap
    assert isinstance(trainer.callbacks[0], Callback)


def _population(c=6, n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, n, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(c, n)).astype(np.int32)
    mask = np.ones((c, n), np.float32)
    mask[1, 7:] = 0.0
    mask[2, 1:] = 0.0  # one real sample: it stays on the train side
    mask[3] = 0.0  # a padding client
    return x, y, mask


@pytest.mark.parametrize("fraction,seed", [(0.2, 0), (0.5, 3)])
def test_split_client_data_masks_equal_jax(fraction, seed):
    x, y, mask = _population()
    jtrain, jtest = jax_split_client_data(JaxClientData(x, y, mask), fraction, seed)
    train, test = split_client_data(ClientData(x, y, mask), fraction, seed)
    assert np.array_equal(train.mask, np.asarray(jtrain.mask))
    assert np.array_equal(test.mask, np.asarray(jtest.mask))
    ttrain, ttest = split_client_data(ClientData(x, y, mask).to(torch.device("cpu")),
                                      fraction, seed)
    assert torch.equal(ttrain.mask, torch.from_numpy(train.mask))
    assert torch.equal(ttest.mask, torch.from_numpy(test.mask))
    with pytest.raises(ValueError, match="test_fraction"):
        split_client_data(ClientData(x, y, mask), 1.0)


def test_personalized_evaluator_matches_jax(models):
    japply, jparams, model, params = models
    x, y, mask = _population()
    jtrain, jtest = jax_split_client_data(JaxClientData(x, y, mask), 0.25, 1)
    rng = jax.random.key(6)
    training = dict(batch_size=4, local_epochs=2, learning_rate=0.2)
    want = jax_make_personalized_evaluator(japply, JaxTrainingConfig(**training))(
        jparams, jtrain, jtest, rng)
    train, test = split_client_data(ClientData(x, y, mask).to(torch.device("cpu")), 0.25, 1)
    got = make_personalized_evaluator(model, TrainingConfig(**training))(
        params, train, test, perms=_jax_permutations(stack_rngs(rng, 6), 2, 12))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value), **TOL, err_msg=key)
    assert float(got["test_counts"][3]) == 0.0


def test_protocols_describe_the_port(models):
    _, _, model, _ = models
    assert isinstance(model, ModelProtocol)
    fit: LocalFitFn = make_local_fit(model, TrainingConfig(**HYPER))
    assert fit.supports_lr_scale
