"""The port's fused multi-round block (``nanofed_tpu_torch.parallel.multi_round``)
against the JAX package's ``build_round_block`` on a 1-device CPU mesh, and against R
calls of the port's own round step.

Against JAX: ``mnist_cnn`` with dropout off, 8 clients of 8 samples, the widths of
``tests/test_torch_round.py``, a 6-of-8 cohort per round with one client dropped and
one padded slot, FedAvgM state carried across rounds and a step lr schedule.  The JAX
fit's own permutations are injected (``fold_in(key(seed), r)`` split per client), so
both packages train on the same batches; tolerance 1e-4, as one round's
(``tests/test_torch_round.py``).  Against the port's round step: the same draws from
the same round seeds, so the block equals R single rounds within 1e-6.

On-device resampling draws from Philox where the JAX block draws from Threefry, so its
cohorts are checked for validity and determinism, not against the JAX ids (a stated
difference).
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
from nanofed_tpu.parallel.multi_round import build_round_block as jax_build_round_block
from nanofed_tpu.parallel.multi_round import stack_round_keys
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu.trainer.schedules import lr_schedule_scales as jax_lr_schedule_scales
from nanofed_tpu_torch.aggregation import base
from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig, RobustAggregationConfig
from nanofed_tpu_torch.aggregation.fedavg import compute_weights
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.parallel import (
    build_round_block,
    build_round_step,
    init_server_state,
    round_seeds,
)
from nanofed_tpu_torch.privacy import PrivacyConfig
from nanofed_tpu_torch.security.validation import ValidationConfig
from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
from nanofed_tpu_torch.trainer.schedules import lr_schedule_scales
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel

TOL = dict(rtol=1e-4, atol=1e-4)
HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.05, momentum=0.9, prox_mu=0.05)
C, N, R, K = 8, 8, 3, 6
SEED = 4
CPU = torch.device("cpu")


def jax_permutations(rngs, epochs, n):
    """The permutations the JAX local fit draws from each client's key."""
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def _cohorts(gated_round=None):
    """Host cohorts in slot order: 6 of 8 sampled per round, the last one dropped, so
    5 survivors and a padded slot aliasing row 0 with weight 0.  ``gated_round`` keeps
    only 2 survivors there (below the 3 the completion gate needs)."""
    idx = np.zeros((R, K), np.int64)
    mask = np.zeros((R, K), np.float32)
    for i in range(R):
        sampled = np.random.default_rng(SEED * 100_003 + i).choice(C, size=K, replace=False)
        survived = sampled[:2] if i == gated_round else sampled[:-1]
        idx[i, : len(survived)] = survived
        mask[i, : len(survived)] = 1.0
    return idx, mask


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(C, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(C, N)).astype(np.int32)
    mask = np.ones((C, N), np.float32)
    mask[5, 5:] = 0.0
    jp = jax_get_model("mnist_cnn").init(jax.random.key(0))
    rounds = list(range(R))
    perms = torch.stack([
        jax_permutations(stack_rngs(jax.random.fold_in(jax.random.key(SEED), r), C),
                         HYPER["local_epochs"], N)
        for r in rounds
    ])
    return dict(
        x=x, y=y, mask=mask, jax_params=jp, perms=perms,
        scales=lr_schedule_scales("step", 0, R, 10, decay_every=1, gamma=0.5),
        data=ClientData(x, y, mask).to(CPU),
        params=from_numpy_params(jax.device_get(jp), device="cpu"),
        model=dataclasses.replace(get_model("mnist_cnn"), dropout=()),
    )


def run_jax(s, strategy, idx, mask):
    m = jax_get_model("mnist_cnn")
    block = jax_build_round_block(
        lambda p, x, train=False, rng=None: m.apply(p, x), JaxTrainingConfig(**HYPER),
        make_mesh(jax.devices()[:1]), strategy, num_clients=C, padded_clients=C,
        step_clients=K, cohort_size=K, cohort_mode=True,
    )
    data = JaxClientData(jnp.asarray(s["x"]), jnp.asarray(s["y"]), jnp.asarray(s["mask"]))
    return block(s["jax_params"], jax_init_server_state(strategy, s["jax_params"]), data,
                 jnp.asarray(s["mask"].sum(1)), stack_round_keys(SEED, list(range(R))),
                 jnp.asarray(s["scales"], jnp.float32), jnp.asarray(idx.astype(np.int32)),
                 jnp.asarray(mask))


def run_port(s, strategy, idx, mask, **kw):
    block = build_round_block(s["model"], TrainingConfig(**HYPER), strategy, num_clients=C,
                              step_clients=K, cohort_size=K, cohort_mode=True, device="cpu",
                              **kw)
    return block(s["params"], init_server_state(strategy, s["params"]), s["data"],
                 s["data"].mask.sum(1), round_seeds(SEED, range(R)), s["scales"],
                 torch.from_numpy(idx), torch.from_numpy(mask), perms=s["perms"])


def _assert_params_equal_jax(got, want):
    for key, leaf in from_numpy_params(jax.device_get(want), device="cpu").items():
        torch.testing.assert_close(got[key], leaf, **TOL)


def test_block_matches_jax_with_carried_fedavgm_state(setup):
    assert setup["scales"] == [1.0, 0.5, 0.25] == jax_lr_schedule_scales(
        "step", 0, R, 10, decay_every=1, gamma=0.5)
    idx, mask = _cohorts()
    want = run_jax(setup, jax_base.fedavgm_strategy(0.7, 0.9), idx, mask)
    got = run_port(setup, base.fedavgm_strategy(0.7, 0.9), idx, mask)
    _assert_params_equal_jax(got.params, want.params)
    trace = optax.tree_utils.tree_get(want.server_opt_state, "trace")
    np.testing.assert_allclose(got.server_opt_state["trace"].numpy(),
                               np.asarray(jax.flatten_util.ravel_pytree(trace)[0]), **TOL)
    for key in ("loss", "accuracy", "participating_clients"):
        np.testing.assert_allclose(got.metrics[key].numpy(), np.asarray(want.metrics[key]),
                                   **TOL, err_msg=key)
    assert got.metrics["participating_clients"].tolist() == [5, 5, 5]
    assert got.survivors.tolist() == np.asarray(want.survivors).tolist() == [5, 5, 5]
    np.testing.assert_allclose(got.update_sq_norms.numpy(), np.asarray(want.update_sq_norms),
                               **TOL)
    np.testing.assert_allclose(got.client_metrics.loss.numpy(),
                               np.asarray(want.client_metrics.loss), **TOL)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=0, atol=0)
    assert got.weights[:, -1].tolist() == [0.0] * R  # the padded slot
    assert got.cohort_ids is None and want.cohort_ids is None  # host cohorts


def test_gated_round_mid_block_is_the_identity_in_both_packages(setup):
    """Round 1 keeps 2 of the 3 clients the gate needs: params and server state pass
    through it, so the block equals the block of rounds 0 and 2 alone, in both
    packages, and Adam's step count advances twice."""
    idx, mask = _cohorts(gated_round=1)
    want = run_jax(setup, jax_base.fedadam_strategy(0.05), idx, mask)
    got = run_port(setup, base.fedadam_strategy(0.05), idx, mask)
    assert got.survivors.tolist() == np.asarray(want.survivors).tolist() == [5, 2, 5]
    assert int(got.metrics["participating_clients"][1]) == 0
    _assert_params_equal_jax(got.params, want.params)
    count = got.server_opt_state["count"]
    assert torch.is_tensor(count) and count.ndim == 0 and int(count) == 2
    assert int(optax.tree_utils.tree_get(want.server_opt_state, "count")) == 2

    keep = [0, 2]
    two = build_round_block(setup["model"], TrainingConfig(**HYPER), base.fedadam_strategy(0.05),
                            num_clients=C, step_clients=K, cohort_size=K, cohort_mode=True,
                            device="cpu")
    strategy = base.fedadam_strategy(0.05)
    ref = two(setup["params"], init_server_state(strategy, setup["params"]), setup["data"],
              setup["data"].mask.sum(1), round_seeds(SEED, keep),
              [setup["scales"][i] for i in keep], torch.from_numpy(idx[keep]),
              torch.from_numpy(mask[keep]), perms=setup["perms"][keep])
    assert torch.equal(ravel(got.params), ravel(ref.params))
    for key in ("mu", "nu"):
        assert torch.equal(got.server_opt_state[key], ref.server_opt_state[key])
    assert ref.server_opt_state["count"] == 2


def _mnist_population(num_clients=8, per_client=8):
    return federate(synthetic_classification(num_clients * per_client, 10, (28, 28, 1), seed=0),
                    num_clients, batch_size=4).to(CPU)


@pytest.mark.parametrize("form", ["materialised", "streamed", "validated"])
def test_block_equals_r_calls_of_the_round_step(form):
    """mnist_cnn WITH dropout: each round draws its permutations and keys from the round
    seed as the coordinator does and gathers the cohort by id; the block equals R
    single-round calls within 1e-6 (streamed: kernel B1's accumulate form; validated:
    kernel B2)."""
    model, training = get_model("mnist_cnn"), TrainingConfig(**HYPER)
    strategy = base.fedavgm_strategy(0.7, 0.9)
    kw = {"streamed": dict(client_chunk=2), "validated": dict(validation=ValidationConfig()),
          "materialised": {}}[form]
    data = _mnist_population()
    ns = data.mask.sum(1)
    idx, mask = _cohorts()
    seeds = round_seeds(SEED, range(R))
    scales = [1.0, 0.5, 0.25]
    params = {k: v for k, v in model.init(torch.Generator().manual_seed(0)).items()}

    step = build_round_step(model, training, strategy, **kw)
    gp, sos = params, init_server_state(strategy, params)
    singles = []
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=CPU).manual_seed(seed)
        perms = draw_permutations(gen, C, training.local_epochs, N)
        keys = client_keys(seed, C, CPU)
        sel = torch.from_numpy(idx[i])
        res = step(gp, sos, data.select(sel), compute_weights(ns[sel], torch.from_numpy(mask[i])),
                   perms[sel], keys[sel], lr_scale=scales[i])
        gp, sos = res.params, res.server_opt_state
        singles.append(res)

    block = build_round_block(model, training, strategy, num_clients=C, step_clients=K,
                              cohort_size=K, cohort_mode=True, device="cpu", **kw)
    got = block(params, init_server_state(strategy, params), data, ns, seeds, scales,
                torch.from_numpy(idx), torch.from_numpy(mask))
    close = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ravel(got.params), ravel(gp), **close)
    torch.testing.assert_close(got.server_opt_state["trace"], sos["trace"], **close)
    for i, res in enumerate(singles):
        for key, value in res.metrics.items():
            torch.testing.assert_close(got.metrics[key][i], value, **close)
        torch.testing.assert_close(got.update_sq_norms[i], res.update_sq_norms, **close)
        torch.testing.assert_close(got.client_metrics.loss[i], res.client_metrics.loss, **close)
    if form == "validated":  # the rounds' own verdicts, compared above
        assert (got.metrics["valid_clients"] <= got.metrics["participating_clients"]).all()


def _linear_block(**kw):
    model = get_model("linear", in_features=10, num_classes=2)
    data = federate(synthetic_classification(16 * 16, 2, (10,), seed=0), 16,
                    batch_size=16).to(CPU)
    params = model.init(torch.Generator().manual_seed(0))
    strategy = base.fedavg_strategy()
    block = build_round_block(model, TrainingConfig(batch_size=16, local_epochs=1), strategy,
                              num_clients=16, device="cpu", **kw)

    def call(rounds, scales=None, **call_kw):
        return block(params, init_server_state(strategy, params), data, data.mask.sum(1),
                     round_seeds(0, rounds), scales or [1.0] * len(rounds), **call_kw)

    return call


def test_device_sampling_is_deterministic_and_valid():
    call = _linear_block(step_clients=8, cohort_size=4)
    res1, res2 = call(range(4)), call(range(4))
    assert res1.survivors.tolist() == [4, 4, 4, 4]
    ids = res1.cohort_ids.numpy()
    assert ids.shape == (4, 8)
    for row in ids:
        assert len(set(row[:4].tolist())) == 4  # without replacement
        assert ((row[:4] >= 0) & (row[:4] < 16)).all()
        assert (row[4:] == 0).all()  # padding slots alias row 0
    assert len({tuple(sorted(r[:4].tolist())) for r in ids}) > 1  # rounds differ
    assert torch.equal(res1.cohort_ids, res2.cohort_ids)
    assert torch.equal(ravel(res1.params), ravel(res2.params))
    assert torch.isfinite(res1.metrics["loss"]).all()
    assert res1.weights[:, 4:].eq(0).all()


def test_device_sampling_respects_cohort_size_at_full_step_width():
    res = _linear_block(cohort_size=4)(range(2))  # step_clients defaults to the 16 rows
    assert res.survivors.tolist() == [4, 4]
    assert res.metrics["participating_clients"].tolist() == [4, 4]
    assert res.cohort_ids.shape == (2, 16)


def test_device_sampling_drops_at_the_dropout_rate():
    res = _linear_block(step_clients=8, cohort_size=8, dropout_rate=0.5,
                        min_completion_rate=0.0)(range(8))
    dropped = 1.0 - res.survivors.sum().item() / (8 * 8)
    assert 0.3 <= dropped <= 0.7
    assert res.metrics["participating_clients"].tolist() == res.survivors.tolist()
    full = _linear_block(dropout_rate=0.5, min_completion_rate=0.0)(range(8))
    assert full.cohort_ids is None  # the whole population, a client-id-ordered mask
    assert 0.3 <= 1.0 - full.survivors.sum().item() / (8 * 16) <= 0.7


def test_collect_client_detail_off_returns_none():
    res = _linear_block(collect_client_detail=False)(range(2),
                                                     cohort_mask=torch.ones((2, 16)))
    assert res.client_metrics is None and res.update_sq_norms is None
    assert res.weights is None and res.cohort_ids is None
    assert res.metrics["loss"].shape == (2,)


@pytest.mark.parametrize("kwargs,error,match", [
    ({"scaffold": True}, ValueError, "SCAFFOLD is not fused"),
    ({"robust": RobustAggregationConfig(trim_k=1)}, ValueError, "robust aggregation"),
    ({"central_privacy": PrivacyAwareAggregationConfig(PrivacyConfig())}, ValueError,
     "central DP"),
    ({"cohort_size": 20}, ValueError, "cohort_size"),
    ({"step_clients": 8, "cohort_size": 4, "cohort_mode": False}, ValueError,
     "full population"),
])
def test_refusals(kwargs, error, match):
    with pytest.raises(error, match=match):
        _linear_block(**kwargs)


def test_frozen_base_builds_and_requires_its_base():
    """``frozen_base=``, which earlier slices refused: the block builds, and a call
    must pass the base exactly when it was built with one (the JAX message)."""
    from nanofed_tpu_torch.parallel import FrozenBase

    block = build_round_block(get_model("linear", in_features=10, num_classes=2),
                              TrainingConfig(batch_size=8), num_clients=16,
                              frozen_base=FrozenBase(None, lambda base: None), device="cpu")
    with pytest.raises(ValueError, match="base_params must be passed exactly"):
        block({}, {}, None, None, [0], [1.0])


def test_call_refusals():
    call = _linear_block(cohort_size=4)
    with pytest.raises(ValueError, match="BOTH cohort_idx and cohort_mask"):
        call(range(2), cohort_mask=torch.ones((2, 16)))
    with pytest.raises(ValueError, match="2 round seeds but 3 lr scales"):
        call(range(2), scales=[1.0] * 3)
    with pytest.raises(ValueError, match="only together with perms"):
        call(range(2), keys=torch.zeros((2, 16), dtype=torch.int32))
    assert round_seeds(3, [0, 5]) == [300_009, 300_014]
