"""The port's guarded rounds against the JAX package's ``build_round_step`` on a
1-device CPU mesh: update validation (clean, and with one client poisoned to NaN
through ``local_fit=``), central DP (materialised, and streamed with
``client_chunk=2``, the JAX round's own noise draw injected), robust aggregation
(trimmed mean, median, Multi-Krum) and their compositions, from the same weights with
the JAX fit's own permutations and dropout off.

Tolerance 1e-4 (params, metrics, update norms), as for the plain round: each client's
four SGD steps of float32 convolutions summed in another order, then the reduce.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.aggregation.privacy import (
    PrivacyAwareAggregationConfig as JaxPrivacyAwareAggregationConfig,
)
from nanofed_tpu.aggregation.robust import RobustAggregationConfig as JaxRobustConfig
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.parallel.mesh import make_mesh
from nanofed_tpu.parallel.round_step import build_round_step as jax_build_round_step
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.privacy import PrivacyConfig as JaxPrivacyConfig
from nanofed_tpu.security import ValidationConfig as JaxValidationConfig
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import make_local_fit as jax_make_local_fit
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu_torch.aggregation import base
from nanofed_tpu_torch.aggregation.privacy import PrivacyAwareAggregationConfig
from nanofed_tpu_torch.aggregation.robust import RobustAggregationConfig
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.parallel import build_round_step, init_server_state
from nanofed_tpu_torch.privacy import PrivacyConfig
from nanofed_tpu_torch.security import ValidationConfig
from nanofed_tpu_torch.trainer import TrainingConfig, make_local_fit
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel

TOL = dict(rtol=1e-4, atol=1e-4)
HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.05, momentum=0.9)
C, N = 8, 8
POISONED = 3
SENTINEL = 1e6
DP = dict(max_gradient_norm=0.5, noise_multiplier=0.8)
VALIDATION = dict(max_norm=100.0)


def jax_permutations(rngs, epochs, n):
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def jax_noise(rngs, params):
    """The JAX round's standard noise draw (``round_step.py`` ``noise_rng``, then one
    ``fold_in`` per leaf in ``tree_noise``), raveled into the port's order."""
    noise_rng = jax.random.fold_in(rngs[0], 0x5EED)
    leaves = jax.tree.leaves(params)
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(noise_rng, i), leaf.shape))
             for i, leaf in enumerate(leaves)]
    return torch.from_numpy(np.concatenate([d.reshape(-1) for d in draws]).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(C, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(C, N)).astype(np.int32)
    mask = np.ones((C, N), np.float32)
    mask[5, 5:] = 0.0
    weights = mask.sum(1) * np.asarray([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    x_poisoned = x.copy()
    x_poisoned[POISONED, 0, 0, 0, 0] = SENTINEL
    jp = jax_get_model("mnist_cnn").init(jax.random.key(0))
    rngs = stack_rngs(jax.random.key(1), C)
    return dict(
        x=x, x_poisoned=x_poisoned, y=y, mask=mask, weights=weights, jax_params=jp,
        rngs=rngs, perms=jax_permutations(rngs, HYPER["local_epochs"], N),
        noise=jax_noise(rngs, jp),
        params=from_numpy_params(jax.device_get(jp), device="cpu"),
        model=dataclasses.replace(get_model("mnist_cnn"), dropout=()),
    )


def _jax_nan_fit(training):
    m = jax_get_model("mnist_cnn")
    fit = jax_make_local_fit(lambda p, x, train=False, rng=None: m.apply(p, x), training)

    def nan_fit(gp, data, rng):
        res = fit(gp, data, rng)
        poisoned = data.x[0, 0, 0, 0] > 1e5
        nan = lambda t: jnp.where(poisoned, jnp.nan, t)  # noqa: E731
        return res._replace(params=jax.tree.map(nan, res.params),
                            metrics=jax.tree.map(nan, res.metrics))
    return nan_fit


def _port_nan_fit(model, training):
    fit = make_local_fit(model, training)

    def nan_fit(gp, data, perms, keys=None, lr_scale=1.0):
        res = fit(gp, data, perms, keys, lr_scale)
        poisoned = data.x[:, 0, 0, 0, 0] > 1e5
        nan = lambda t: torch.where(  # noqa: E731
            poisoned.view(-1, *[1] * (t.ndim - 1)), torch.nan, t)
        return res._replace(params={k: nan(v) for k, v in res.params.items()},
                            metrics=ClientMetrics(*(nan(m) for m in res.metrics)))
    return nan_fit


def run_jax(s, poisoned=False, validation=False, dp=False, robust=None):
    m = jax_get_model("mnist_cnn")
    training = JaxTrainingConfig(**HYPER)
    strategy = jax_base.fedavg_strategy()
    step = jax_build_round_step(
        lambda p, x, train=False, rng=None: m.apply(p, x), training,
        make_mesh(jax.devices()[:1]), strategy,
        local_fit=_jax_nan_fit(training) if poisoned else None,
        validation=JaxValidationConfig(**VALIDATION) if validation else None,
        central_privacy=(JaxPrivacyAwareAggregationConfig(privacy=JaxPrivacyConfig(**DP))
                         if dp else None),
        robust=JaxRobustConfig(**robust) if robust else None,
    )
    x = s["x_poisoned"] if poisoned else s["x"]
    data = JaxClientData(jnp.asarray(x), jnp.asarray(s["y"]), jnp.asarray(s["mask"]))
    return step(s["jax_params"], jax_init_server_state(strategy, s["jax_params"]), data,
                jnp.asarray(s["weights"]), s["rngs"])


def run_port(s, poisoned=False, validation=False, dp=False, robust=None, client_chunk=None):
    training = TrainingConfig(**HYPER)
    strategy = base.fedavg_strategy()
    step = build_round_step(
        s["model"], training, strategy, client_chunk=client_chunk,
        local_fit=_port_nan_fit(s["model"], training) if poisoned else None,
        validation=ValidationConfig(**VALIDATION) if validation else None,
        central_privacy=(PrivacyAwareAggregationConfig(privacy=PrivacyConfig(**DP))
                         if dp else None),
        robust=RobustAggregationConfig(**robust) if robust else None,
    )
    x = s["x_poisoned"] if poisoned else s["x"]
    data = ClientData(x, s["y"], s["mask"]).to(torch.device("cpu"))
    return step(s["params"], init_server_state(strategy, s["params"]), data,
                torch.from_numpy(s["weights"]), s["perms"],
                noise=s["noise"] if dp else None)


def assert_rounds_agree(got, want):
    for key, leaf in from_numpy_params(jax.device_get(want.params), device="cpu").items():
        assert torch.isfinite(got.params[key]).all()
        torch.testing.assert_close(got.params[key], leaf, **TOL)
    assert set(got.metrics) == set(want.metrics)
    for key in want.metrics:
        np.testing.assert_allclose(float(got.metrics[key]), float(want.metrics[key]),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(got.update_sq_norms.numpy(), np.asarray(want.update_sq_norms),
                               **TOL)
    np.testing.assert_allclose(got.client_metrics.loss.numpy(),
                               np.asarray(want.client_metrics.loss), **TOL)


CASES = {
    "validated": dict(validation=True),
    "validated_nan_client": dict(validation=True, poisoned=True),
    "dp_materialised": dict(dp=True),
    "trimmed_mean": dict(robust=dict(trim_k=1, method="trimmed_mean")),
    "median": dict(robust=dict(method="median")),
    "multi_krum": dict(robust=dict(trim_k=1, method="multi_krum")),
    "validated_nan_client_dp": dict(validation=True, poisoned=True, dp=True),
    "validated_nan_client_trimmed_mean": dict(
        validation=True, poisoned=True, robust=dict(trim_k=1, method="trimmed_mean")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_guarded_round_matches_jax(setup, case):
    kw = CASES[case]
    want = run_jax(setup, **kw)
    got = run_port(setup, **kw)
    assert_rounds_agree(got, want)
    if kw.get("validation"):
        assert isinstance(got.metrics["valid_clients"], torch.Tensor)
        expected_valid = 6 if kw.get("poisoned") else 7  # client 2 has weight 0
        assert int(got.metrics["valid_clients"]) == expected_valid
        assert int(got.metrics["participating_clients"]) == 7
    if kw.get("robust"):
        assert "robust_kept_clients" in got.metrics


def test_streamed_dp_round_matches_jax(setup):
    """client_chunk=2: the DP clip rides B1's accumulate form chunk by chunk."""
    want = run_jax(setup, dp=True)
    got = run_port(setup, dp=True, client_chunk=2)
    assert_rounds_agree(got, want)
    full = run_port(setup, dp=True)
    torch.testing.assert_close(ravel(got.params), ravel(full.params), rtol=1e-6, atol=1e-6)


def test_validated_round_chunks_into_one_buffer(setup):
    """Validation forces materialised deltas: chunked fits fill one buffer, and the
    result equals the one-shot round."""
    full = run_port(setup, validation=True, poisoned=True)
    chunked = run_port(setup, validation=True, poisoned=True, client_chunk=2)
    torch.testing.assert_close(ravel(chunked.params), ravel(full.params), rtol=1e-6, atol=1e-6)
    assert int(chunked.metrics["valid_clients"]) == int(full.metrics["valid_clients"])


def test_refusals_match_jax(setup):
    training = TrainingConfig(**HYPER)
    with pytest.raises(ValueError, match="central_privacy"):
        build_round_step(setup["model"], training,
                         central_privacy=PrivacyAwareAggregationConfig(),
                         robust=RobustAggregationConfig())
    with pytest.raises(ValueError, match="grad_fn"):
        build_round_step(setup["model"], training, grad_fn=lambda *a: None,
                         local_fit=lambda *a: None)
    with pytest.raises(ValueError, match="central_privacy"):
        jax_build_round_step(lambda p, x, train=False, rng=None: x,
                             JaxTrainingConfig(**HYPER), make_mesh(jax.devices()[:1]),
                             central_privacy=JaxPrivacyAwareAggregationConfig(),
                             robust=JaxRobustConfig())
    step = build_round_step(setup["model"], training,
                            central_privacy=PrivacyAwareAggregationConfig())
    data = ClientData(setup["x"], setup["y"], setup["mask"]).to(torch.device("cpu"))
    with pytest.raises(ValueError, match="noise"):
        step(setup["params"], init_server_state(base.fedavg_strategy(), setup["params"]),
             data, torch.from_numpy(setup["weights"]), setup["perms"])
