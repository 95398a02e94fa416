"""The port's sharded round (``build_round_step(..., mesh=)``) in a world of 4 ranks
on gloo on the CPU, against the JAX package's ``build_round_step`` on
``make_mesh(devices=jax.devices()[:4], shape=...)`` over the conftest's virtual CPU
devices, with the JAX fit's permutations and the JAX round's noise injected.

One world (``parallel.launch.spawn_world``) runs every case: the plain materialised
round, the streamed round (``client_chunk``), validation with a NaN client, central
DP and the trimmed mean, each on the (4,), (2, 2) and (2, 2, 1) meshes; a model-
sharded FedAdam round and an adapter round with its base sharded on (2, 2); a
(1, 4) mesh, held bit for bit against the same mesh code on one rank; and a fused
block resampling its cohorts on the device, held against the one-device block.

Tolerances: 1e-5 max abs on params after one round, 1e-4 after three (each client's
two SGD steps of float32 products summed in another order, then a sum over ranks in
another association); metrics, update norms and client losses 1e-5 after one round.
Every rank's params are bit-identical after every case.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_world_ranks as W

from nanofed_tpu import adapters as jax_adapters
from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.aggregation.privacy import (
    PrivacyAwareAggregationConfig as JaxPrivacyAwareAggregationConfig,
)
from nanofed_tpu.aggregation.robust import RobustAggregationConfig as JaxRobustConfig
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nanofed_tpu.parallel.round_step import FrozenBase as JaxFrozenBase
from nanofed_tpu.parallel.round_step import build_round_step as jax_build_round_step
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.privacy import PrivacyConfig as JaxPrivacyConfig
from nanofed_tpu.security import ValidationConfig as JaxValidationConfig
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import make_local_fit as jax_make_local_fit
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu_torch.parallel.launch import spawn_world
from nanofed_tpu_torch.parallel.mesh import make_mesh
from nanofed_tpu_torch.utils.trees import flatten_with_names

ONE_ROUND = dict(rtol=0, atol=1e-5)
THREE_ROUNDS = dict(rtol=0, atol=1e-4)
SHAPES = {"4": (4,), "2x2": (2, 2), "2x2x1": (2, 2, 1)}
FORMS = {
    "plain": {},
    "streamed": dict(client_chunk=1),
    "validated_nan_client": dict(validation=True, poisoned=True),
    "central_dp": dict(dp=True),
    "trimmed_mean": dict(robust=dict(trim_k=1, method="trimmed_mean")),
}
CASES = {f"{form}-{sname}": dict(shape=shape, rounds=3, **kw)
         for sname, shape in SHAPES.items() for form, kw in FORMS.items()}
CASES["fedadam_model_sharded-2x2"] = dict(shape=(2, 2), rounds=3, strategy="fedadam")
CASES["adapter_base_sharded-2x2"] = dict(shape=(2, 2), rounds=3, adapter=True)
CASES["fedadam_model_axis-1x4"] = dict(shape=(1, 4), rounds=2, strategy="fedadam")
JAX_CASES = [name for name in CASES if not name.endswith("1x4")]


def jax_permutations(rngs, epochs, n):
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64)


def jax_noise(rngs, params):
    noise_rng = jax.random.fold_in(rngs[0], 0x5EED)
    leaves = jax.tree.leaves(params)
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(noise_rng, i), leaf.shape))
             for i, leaf in enumerate(leaves)]
    return np.concatenate([d.reshape(-1) for d in draws]).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(W.C, W.N, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(W.C, W.N)).astype(np.int32)
    mask = np.ones((W.C, W.N), np.float32)
    mask[5, 5:] = 0.0
    weights = mask.sum(1) * np.asarray([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    x_poisoned = x.copy()
    x_poisoned[W.POISONED, 0, 0, 0, 0] = W.SENTINEL
    jp = jax.device_get(jax_get_model("digits_mlp").init(jax.random.key(0)))
    rngs = stack_rngs(jax.random.key(1), W.C)
    inputs = dict(x=x, x_poisoned=x_poisoned, y=y, mask=mask, weights=weights,
                  perms=jax_permutations(rngs, W.HYPER["local_epochs"], W.N),
                  noise=jax_noise(rngs, jp), params=jp)
    return dict(inputs=inputs, rngs=rngs, jax_params=jp)


@pytest.fixture(scope="module")
def world(setup):
    """The world first, alone: its deadline must not compete with the JAX compiles."""
    return spawn_world(W.mesh_rounds, 4, backend="gloo", device="cpu", timeout_s=120,
                       args=(setup["inputs"], CASES))


@pytest.fixture(scope="module")
def jax_results(setup, world):
    """Every JAX oracle, compiled three at a time after the world."""
    with ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(run_jax, setup, CASES[name]) for name in JAX_CASES}
        return {name: f.result() for name, f in futures.items()}


def run_jax(setup, case):
    """The JAX sharded round, ``case["rounds"]`` times: params after the first and
    the last, and the first round's result."""
    m = jax_get_model("digits_mlp")
    apply = lambda p, x, train=False, rng=None: m.apply(p, x)  # noqa: E731
    training = JaxTrainingConfig(**W.HYPER)
    strategy = (jax_base.fedadam_strategy(0.05) if case.get("strategy") == "fedadam"
                else jax_base.fedavg_strategy())
    shape = case["shape"]
    mesh = jax_make_mesh(jax.devices()[:4], shape=None if len(shape) == 1 else shape)
    params = setup["jax_params"]
    frozen = None
    extra = ()
    local_fit = None
    if case.get("poisoned"):
        fit = jax_make_local_fit(apply, training)

        def local_fit(gp, data, rng):
            res = fit(gp, data, rng)
            nan = lambda t: jnp.where(data.x[0, 0, 0, 0] > 1e5, jnp.nan, t)  # noqa: E731
            return res._replace(params=jax.tree.map(nan, res.params),
                                metrics=jax.tree.map(nan, res.metrics))
    if case.get("adapter"):
        jspec = jax_adapters.AdapterSpec(**W.ADAPTER)
        frozen = JaxFrozenBase(base_like=params, bind=lambda bf: jax_adapters.
                               make_adapter_apply(apply, jspec, bf))
        extra = (params,)
        params = jax.device_get(jax_adapters.init_adapters(jspec, params, rng=1))
    step = jax_build_round_step(
        apply, training, mesh, strategy, local_fit=local_fit,
        validation=JaxValidationConfig(**W.VALIDATION) if case.get("validation") else None,
        central_privacy=(JaxPrivacyAwareAggregationConfig(privacy=JaxPrivacyConfig(**W.DP))
                         if case.get("dp") else None),
        robust=JaxRobustConfig(**case["robust"]) if case.get("robust") else None,
        client_chunk=case.get("client_chunk"), params_like=params, frozen_base=frozen,
    )
    i = setup["inputs"]
    x = i["x_poisoned"] if case.get("poisoned") else i["x"]
    data = JaxClientData(jnp.asarray(x), jnp.asarray(i["y"]), jnp.asarray(i["mask"]))
    sos = jax_init_server_state(strategy, params)
    first = None
    gp = params
    for r in range(case["rounds"]):
        res = step(gp, sos, *extra, data, jnp.asarray(i["weights"]), setup["rngs"])
        gp, sos = res.params, res.server_opt_state
        if r == 0:
            first = res
            params_1 = flatten_with_names(jax.device_get(gp))
    return first, params_1, flatten_with_names(jax.device_get(gp))


def _close(got: dict, want: dict, tol: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), err_msg=key, **tol)


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_round_matches_the_jax_sharded_round(jax_results, world, name):
    first, params_1, params_last = jax_results[name]
    got = world[0][name]
    _close(got["params_1"], params_1, ONE_ROUND)
    _close(got["params_last"], params_last, THREE_ROUNDS)
    assert set(got["metrics"]) == set(first.metrics)
    for key, value in first.metrics.items():
        np.testing.assert_allclose(got["metrics"][key], float(value), err_msg=key,
                                   **ONE_ROUND)
    np.testing.assert_allclose(got["sq_norms"], np.asarray(first.update_sq_norms),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["client_loss"], np.asarray(first.client_metrics.loss),
                               **ONE_ROUND)
    if CASES[name].get("validation"):  # the NaN client is among the rejected
        assert got["metrics"]["valid_clients"] < got["metrics"]["participating_clients"] == 7


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_bit_identical_params(world, name):
    for rank in range(1, 4):
        for key in ("params_1", "params_last"):
            for leaf, value in world[0][name][key].items():
                np.testing.assert_array_equal(world[rank][name][key][leaf], value,
                                              err_msg=f"rank {rank} {key} {leaf}")


def test_model_axis_mesh_equals_one_rank_bit_for_bit(setup, world):
    """(1, 4): every rank gathers, fits all eight clients, reduces over its one
    client shard and updates its quarter; the gathered params equal one rank's
    (no process group) running the same mesh code, bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks run one thread each
    try:
        case = dict(CASES["fedadam_model_axis-1x4"], shape=(1,))
        want = W.run_case(setup["inputs"], case, make_mesh(device="cpu"))
    finally:
        torch.set_num_threads(threads)
    for key in ("params_1", "params_last"):
        for leaf, value in want[key].items():
            np.testing.assert_array_equal(world[0]["fedadam_model_axis-1x4"][key][leaf],
                                          value, err_msg=leaf)


def test_model_axis_holds_a_share_of_the_state_per_rank(world):
    """FedAdam's params plus moments between rounds: each of m=4 ranks holds about a
    quarter of the one-rank state (digits_mlp's 10-wide bias splits in two, not four,
    so it stays whole on every rank)."""
    full = 3 * 4810 * 4  # params, mu, nu in float32
    shard = world[0]["fedadam_model_axis-1x4"]["shard_bytes"]
    assert 0.25 * full <= shard < 0.26 * full


def test_mesh_block_resamples_the_same_cohorts_on_every_rank(setup, world):
    """A fused block on the (4,) mesh resampling its cohorts on the device: every rank
    draws the same Philox ids, the ids one device draws, and the block's params are
    the one-device block's within 1e-5."""
    ids = world[0]["block-4"]["cohort_ids"]
    assert all(np.array_equal(r["block-4"]["cohort_ids"], ids) for r in world)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = W.run_block(setup["inputs"], None)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(ids, want["cohort_ids"])
    _close(world[0]["block-4"]["params"], want["params"], ONE_ROUND)
    np.testing.assert_allclose(world[0]["block-4"]["loss"], want["loss"], **ONE_ROUND)


def test_ranks_import_no_jax(world):
    assert all(r["_imports"] == [] for r in world)
