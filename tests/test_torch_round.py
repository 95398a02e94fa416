"""Port round step against the JAX package's ``build_round_step`` on a 1-device CPU
mesh: one 8-client round from the same weights, dropout off, the JAX fit's own
permutations injected.  With dropout on, the port against itself: a client's
dropout masks come from its own key, so neither chunking nor the clients' order may
change the round.

Tolerance 1e-4 (params, metrics, update norms): each client's four SGD steps of
float32 convolutions summed in another order, then an 8-client weighted mean.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.parallel.mesh import make_mesh
from nanofed_tpu.parallel.round_step import build_round_step as jax_build_round_step
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu_torch.aggregation import base
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.parallel import build_round_step, init_server_state
from nanofed_tpu_torch.trainer import TrainingConfig, client_keys
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel

TOL = dict(rtol=1e-4, atol=1e-4)
HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.05, momentum=0.9, prox_mu=0.05)
C, N = 8, 8

STRATEGIES = {
    "fedavg": (jax_base.fedavg_strategy, base.fedavg_strategy),
    "fedavgm": (lambda: jax_base.fedavgm_strategy(0.7, 0.9),
                lambda: base.fedavgm_strategy(0.7, 0.9)),
    "fedadam": (lambda: jax_base.fedadam_strategy(0.05), lambda: base.fedadam_strategy(0.05)),
    "fedyogi": (lambda: jax_base.fedyogi_strategy(0.05), lambda: base.fedyogi_strategy(0.05)),
}


def jax_permutations(rngs, epochs, n):
    """The permutations the JAX local fit draws from each client's key."""
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(C, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(C, N)).astype(np.int32)
    mask = np.ones((C, N), np.float32)
    mask[5, 5:] = 0.0
    weights = mask.sum(1) * np.asarray([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    jp = jax_get_model("mnist_cnn").init(jax.random.key(0))
    rngs = stack_rngs(jax.random.key(1), C)
    return dict(
        x=x, y=y, mask=mask, weights=weights, jax_params=jp, rngs=rngs,
        perms=jax_permutations(rngs, HYPER["local_epochs"], N),
        data=ClientData(x, y, mask).to(torch.device("cpu")),
        params=from_numpy_params(jax.device_get(jp), device="cpu"),
        model=dataclasses.replace(get_model("mnist_cnn"), dropout=()),
    )


def run_jax(s, strategy):
    m = jax_get_model("mnist_cnn")
    step = jax_build_round_step(lambda p, x, train=False, rng=None: m.apply(p, x),
                                JaxTrainingConfig(**HYPER), make_mesh(jax.devices()[:1]),
                                strategy)
    data = JaxClientData(jnp.asarray(s["x"]), jnp.asarray(s["y"]), jnp.asarray(s["mask"]))
    return step(s["jax_params"], jax_init_server_state(strategy, s["jax_params"]), data,
                jnp.asarray(s["weights"]), s["rngs"])


def run_port(s, strategy, client_chunk=None, weights=None, sos=None):
    step = build_round_step(s["model"], TrainingConfig(**HYPER), strategy,
                            client_chunk=client_chunk)
    w = torch.from_numpy(s["weights"] if weights is None else weights)
    sos = init_server_state(strategy, s["params"]) if sos is None else sos
    return step(s["params"], sos, s["data"], w, s["perms"])


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_round_matches_jax(setup, name):
    jax_strategy, port_strategy = STRATEGIES[name]
    want = run_jax(setup, jax_strategy())
    got = run_port(setup, port_strategy())
    for key, leaf in from_numpy_params(jax.device_get(want.params), device="cpu").items():
        torch.testing.assert_close(got.params[key], leaf, **TOL)
    for key in ("loss", "accuracy", "samples", "participating_clients"):
        np.testing.assert_allclose(float(got.metrics[key]), float(want.metrics[key]), **TOL)
    np.testing.assert_allclose(got.update_sq_norms.numpy(), np.asarray(want.update_sq_norms),
                               **TOL)
    np.testing.assert_allclose(got.client_metrics.loss.numpy(),
                               np.asarray(want.client_metrics.loss), **TOL)
    if name == "fedavgm":  # the momentum trace is the aggregated delta after one round
        trace = optax.tree_utils.tree_get(want.server_opt_state, "trace")
        np.testing.assert_allclose(got.server_opt_state["trace"].numpy(),
                                   np.asarray(jax.flatten_util.ravel_pytree(trace)[0]), **TOL)


def test_streamed_round_equals_materialised(setup):
    """client_chunk=2 folds four chunks into one running sum; the result equals the
    one-shot reduce up to float32 summation order (1e-6)."""
    strategy = base.fedavgm_strategy(0.7, 0.9)
    full = run_port(setup, strategy)
    streamed = run_port(setup, strategy, client_chunk=2)
    for key in full.params:
        torch.testing.assert_close(streamed.params[key], full.params[key], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(streamed.update_sq_norms, full.update_sq_norms, rtol=1e-6,
                               atol=1e-6)
    for key in full.metrics:
        torch.testing.assert_close(streamed.metrics[key], full.metrics[key])
    with pytest.raises(ValueError, match="divide"):
        run_port(setup, strategy, client_chunk=3)


@pytest.mark.parametrize("client_chunk", [None, 4])
def test_zero_weight_round_leaves_params_and_server_state(setup, client_chunk):
    strategy = base.fedadam_strategy(0.05)
    first = run_port(setup, strategy)  # a real round: non-trivial Adam moments
    setup_after = dict(setup, params=first.params)
    again = run_port(setup_after, strategy, client_chunk=client_chunk,
                     weights=np.zeros(C, np.float32), sos=first.server_opt_state)
    assert torch.equal(ravel(again.params), ravel(first.params))
    assert again.server_opt_state["count"] == first.server_opt_state["count"] == 1
    for key in ("mu", "nu"):
        assert torch.equal(again.server_opt_state[key], first.server_opt_state[key])
    assert int(again.metrics["participating_clients"]) == 0


def _dropout_round(setup, client_chunk=None, order=None):
    model = get_model("mnist_cnn")  # dropout on
    strategy = base.fedavg_strategy()
    step = build_round_step(model, TrainingConfig(**HYPER), strategy, client_chunk=client_chunk)
    order = torch.arange(C) if order is None else order
    data = setup["data"].select(order)
    return step(setup["params"], init_server_state(strategy, setup["params"]), data,
                torch.from_numpy(setup["weights"])[order], setup["perms"][order],
                client_keys(11, C, "cpu")[order])


def test_dropout_round_is_client_stable_across_chunks(setup):
    """Dropout on: client_chunk=2 runs four chunks, yet every client draws the masks
    of its own key, so the round equals the materialised round to 1e-6."""
    full = _dropout_round(setup)
    streamed = _dropout_round(setup, client_chunk=2)
    for key in full.params:
        torch.testing.assert_close(streamed.params[key], full.params[key], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(streamed.update_sq_norms, full.update_sq_norms, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(streamed.client_metrics.loss, full.client_metrics.loss)
    off = run_port(setup, base.fedavg_strategy())
    assert not torch.allclose(full.client_metrics.loss, off.client_metrics.loss)


def test_dropout_round_does_not_depend_on_the_client_slots(setup):
    """The same clients in reversed slots: the same per-client results, permuted."""
    full = _dropout_round(setup)
    order = torch.arange(C - 1, -1, -1)
    moved = _dropout_round(setup, order=order)
    torch.testing.assert_close(ravel(moved.params), ravel(full.params), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(moved.update_sq_norms, full.update_sq_norms[order],
                               rtol=1e-6, atol=1e-6)
