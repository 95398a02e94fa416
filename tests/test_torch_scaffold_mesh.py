"""SCAFFOLD, program profiling and on-device cohorts across a world of ranks on gloo on
the CPU (``build_scaffold_round_step(..., mesh=)``, ``Coordinator(scaffold=True,
mesh_shape=)``, ``profile_programs()`` on a mesh, ``build_round_block(mesh=)`` drawing
its cohorts on the device over a hosts axis), against the JAX package on
``make_mesh(jax.devices()[:n], shape=...)`` over the conftest's virtual CPU devices.

Two worlds: four ranks on (2, 2, 1), two on (1, 2).  The JAX oracles (the SCAFFOLD
step on both meshes, the SCAFFOLD coordinator and the fused block on (2, 2, 1), never
``strict=True``) compile after the worlds.  Checkpoints travel one rank -> (2, 2, 1)
-> (1, 2) -> one rank.

Tolerances: the step 1e-5 (float32 SGD steps and sums over ranks in another order;
update norms 1e-5 relative); coordinators 1e-4 against JAX after three rounds, 1e-5
against the port on one rank given the same cohorts; a (1, 2) mesh and every resumed
state bit for bit; the block's cohort ids bit for bit against one device, its params
1e-5 against one device and 1e-4 against JAX given the same cohorts (two rounds of
momentum SGD).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_world_ranks as W

from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nanofed_tpu.parallel.multi_round import build_round_block as jax_build_round_block
from nanofed_tpu.parallel.multi_round import stack_round_keys
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.parallel.scaffold_step import (
    build_scaffold_round_step as jax_build_scaffold_round_step,
)
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu_torch.parallel.launch import spawn_world
from nanofed_tpu_torch.persistence import FileStateStore
from nanofed_tpu_torch.utils.trees import flatten_with_names

STEP_TOL = dict(rtol=0, atol=1e-5)
JAX_TOL = dict(rtol=0, atol=1e-4)
ONE_RANK_TOL = dict(rtol=0, atol=1e-5)
BLOCK_ROUNDS = 2
BLOCK_SEED = 7


def jax_permutations(rngs, epochs, n):
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64)


def _flat(tree):
    return np.concatenate([np.asarray(a).ravel() for a in flatten_with_names(tree).values()])


def _stack_flat(tree):
    leaves = list(flatten_with_names(tree).values())
    return np.concatenate([np.asarray(a).reshape(a.shape[0], -1) for a in leaves], axis=1)


def _unflat(flat, like, rows=None):
    """A flat ``[P]`` vector (or ``[rows, P]`` matrix) in ravel order as a tree shaped
    like ``like`` (leaves ``[rows, ...]`` with ``rows``)."""
    leaves, treedef = jax.tree.flatten(like)
    out, at = [], 0
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        part = flat[..., at: at + n]
        out.append(part.reshape(leaf.shape if rows is None else (rows, *leaf.shape)))
        at += n
    return jax.tree.unflatten(treedef, out)


def _assert_same_bits(got, want, what):
    if isinstance(want, dict):
        for leaf, value in want.items():
            np.testing.assert_array_equal(got[leaf], value, err_msg=f"{what} {leaf}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("scaffold_mesh")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(W.C, W.N, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(W.C, W.N)).astype(np.int32)
    mask = np.ones((W.C, W.N), np.float32)
    mask[7, 3:] = 0.0  # a padded client: one of its batches is all padding
    weights = mask.sum(1)
    weights[1] = 0.0  # a dropped client: its control must not move
    jp = jax.device_get(jax_get_model("digits_mlp").init(jax.random.key(0)))
    p = _flat(jp).size
    rngs = stack_rngs(jax.random.key(5), W.C)
    block_perms = np.stack([
        jax_permutations(stack_rngs(jax.random.fold_in(jax.random.key(BLOCK_SEED), r), W.C),
                         W.HYPER["local_epochs"], W.N)
        for r in range(BLOCK_ROUNDS)])
    inputs = dict(
        x=x, y=y, mask=mask, weights=weights, params=jp,
        perms=jax_permutations(rngs, W.SC_HYPER["local_epochs"], W.N),
        c_global=(0.05 * rng.normal(size=p)).astype(np.float32),
        c_stack=(0.05 * rng.normal(size=(W.C, p))).astype(np.float32),
        coord_params=jax.device_get(jax_get_model("digits_mlp").init(
            jax.random.key(W.COORD["seed"]))),
    )
    # The JAX keys stay here: unpickling one in a rank would import JAX there.
    return dict(inputs=inputs, rngs=rngs, block_perms=torch.from_numpy(block_perms))


@pytest.fixture(scope="module")
def one_rank_checkpoint(tmp):
    """Two SCAFFOLD rounds on one rank, checkpointed; the (2, 2, 1) world resumes a copy."""
    coord = W.make_coordinator(tmp / "one", scaffold=True, config=dict(num_rounds=2),
                               state_store=FileStateStore(tmp / "sc_one_ckpt"))
    coord.run()
    shutil.copytree(tmp / "sc_one_ckpt", tmp / "sc_one_to_mesh")
    return W._controls(coord)


@pytest.fixture(scope="module")
def world(setup, tmp, one_rank_checkpoint):
    """The four-rank world first (its deadline must not compete with the JAX compiles),
    then the two-rank world resuming the first world's last checkpoint."""
    four = spawn_world(W.scaffold_world, 4, backend="gloo", device="cpu", timeout_s=120,
                       args=(setup["inputs"], str(tmp), setup["block_perms"]))
    shutil.copytree(tmp / "sc_one_to_mesh", tmp / "sc_mesh_to_1x2")
    two = spawn_world(W.scaffold_model_axis_world, 2, backend="gloo", device="cpu",
                      timeout_s=120, args=(setup["inputs"], str(tmp)))
    return four, two


def run_jax_step(inputs, rngs, devices, shape):
    m = jax_get_model("digits_mlp")
    strategy = jax_base.fedavgm_strategy(0.7, 0.9)
    params = inputs["params"]
    step = jax_build_scaffold_round_step(
        lambda p, x, train=False, rng=None: m.apply(p, x), JaxTrainingConfig(**W.SC_HYPER),
        jax_make_mesh(jax.devices()[:devices], shape=shape), W.SC_POPULATION, strategy,
        params_like=params)
    data = JaxClientData(jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"]),
                         jnp.asarray(inputs["mask"]))
    res = step(params, strategy.server_tx.init(params), _unflat(inputs["c_global"], params),
               _unflat(inputs["c_stack"], params, rows=W.C), data,
               jnp.asarray(inputs["weights"]), rngs)
    return jax.device_get(res)


@pytest.fixture(scope="module")
def jax_steps(setup, world):
    return {"2x2x1": run_jax_step(setup["inputs"], setup["rngs"], 4, (2, 2, 1)),
            "1x2": run_jax_step(setup["inputs"], setup["rngs"], 2, (1, 2))}


def _check_step(got_ranks, want):
    got = got_ranks[0]["step"]
    np.testing.assert_allclose(_flat(got["params"]), _flat(want.params), **STEP_TOL)
    np.testing.assert_allclose(got["c_global"], _flat(want.c_global), **STEP_TOL)
    np.testing.assert_allclose(got["trace"], _flat(want.server_opt_state[0].trace),
                               **STEP_TOL)
    delta_c = np.zeros_like(_stack_flat(want.delta_c))
    for r in got_ranks:
        lo, hi = r["step"]["rows"]
        delta_c[lo:hi] = r["step"]["delta_c"]
    np.testing.assert_allclose(delta_c, _stack_flat(want.delta_c), **STEP_TOL)
    assert not delta_c[1].any()  # the dropped client's control delta is exact zeros
    np.testing.assert_allclose(got["sq_norms"], np.asarray(want.update_sq_norms),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["client_loss"], np.asarray(want.client_metrics.loss),
                               **STEP_TOL)
    for key in ("loss", "accuracy", "samples", "participating_clients"):
        np.testing.assert_allclose(got["metrics"][key], float(want.metrics[key]),
                                   err_msg=key, **STEP_TOL)


@pytest.mark.parametrize("shape", ["2x2x1", "1x2"])
def test_scaffold_step_matches_the_jax_mesh_step(world, jax_steps, shape):
    four, two = world
    _check_step(four if shape == "2x2x1" else two, jax_steps[shape])


def test_every_rank_ends_with_the_same_bits(world):
    for ranks in world:
        for r in ranks[1:]:
            for key in ("coord", "resumed_after"):
                for part in ("params", "c_global", "c_stack"):
                    _assert_same_bits(r[key][part], ranks[0][key][part], f"{key} {part}")


def test_a_rank_holds_its_client_shard_of_the_control_stack(world):
    four, two = world
    assert [r["stack_rows"] for r in four] == [W.COORD["num_clients"] // 4] * 4
    assert [r["stack_rows"] for r in two] == [W.COORD["num_clients"]] * 2  # one shard
    # A (2, 2, 1) cohort's rows cross the clients line: the exchange moved some.
    assert four[0]["exchange_bytes"] > 0


@pytest.fixture(scope="module")
def jax_coordinator(setup, tmp, world):
    c = W.COORD
    jc = JaxCoordinator(
        model=jax_get_model("digits_mlp"),
        train_data=jax_federate(jax_synthetic(c["num_clients"] * c["samples"], 10, (8, 8, 1),
                                              seed=0), c["num_clients"],
                                batch_size=c["samples"]),
        config=JaxCoordinatorConfig(num_rounds=c["rounds"], participation_rate=c["participation"],
                                    seed=c["seed"], base_dir=tmp / "jax", save_metrics=False),
        training=JaxTrainingConfig(batch_size=c["samples"], local_epochs=1, learning_rate=0.1),
        strategy=jax_base.fedadam_strategy(0.05), scaffold=True,
        mesh=jax_make_mesh(jax.devices()[:4], shape=(2, 2, 1)), strict=False,
    )
    cohorts = [jc._sample_cohort(r).tolist() for r in range(c["rounds"])]
    jc.run()
    return dict(cohorts=cohorts, params=flatten_with_names(jax.device_get(jc.params)),
                c_global=_flat(jax.device_get(jc.c_global)),
                c_stack=_stack_flat(jax.device_get(jc.c_stack)))


def test_mesh_scaffold_coordinator_matches_the_jax_one(world, jax_coordinator):
    got, want = world[0][0], jax_coordinator
    assert [c.tolist() for c in got["cohorts"]] == want["cohorts"]  # host-local draws
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["coord"]["params"][key], np.asarray(value),
                                   err_msg=key, **JAX_TOL)
    np.testing.assert_allclose(got["coord"]["c_global"], want["c_global"], **JAX_TOL)
    np.testing.assert_allclose(got["coord"]["c_stack"], want["c_stack"], **JAX_TOL)


def test_mesh_scaffold_coordinator_matches_one_rank_given_its_cohorts(setup, world, tmp):
    """A (2, 2, 1) mesh draws host-locally; one rank given the same cohorts trains the
    same clients the same way (client-stable draws) and sums in another order."""
    got = world[0][0]
    coord = W.make_coordinator(tmp / "one_given", setup["inputs"]["coord_params"],
                               scaffold=True)
    coord._sample_cohort = lambda r: got["cohorts"][r]
    coord.run()
    want = W._controls(coord)
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["coord"]["params"][key], value, err_msg=key,
                                   **ONE_RANK_TOL)
    np.testing.assert_allclose(got["coord"]["c_global"], want["c_global"], **ONE_RANK_TOL)
    np.testing.assert_allclose(got["coord"]["c_stack"], want["c_stack"], **ONE_RANK_TOL)


def test_model_axis_scaffold_coordinator_equals_one_rank_bit_for_bit(setup, world, tmp):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks run one thread each
    try:
        coord = W.make_coordinator(tmp / "one_bits", setup["inputs"]["coord_params"],
                                   scaffold=True)
        coord.run()
    finally:
        torch.set_num_threads(threads)
    want, got = W._controls(coord), world[1][0]["coord"]
    for key, value in want["params"].items():
        np.testing.assert_array_equal(got["params"][key], value, err_msg=key)
    np.testing.assert_array_equal(got["c_global"], want["c_global"])
    np.testing.assert_array_equal(got["c_stack"], want["c_stack"])


def _assert_same_state(got, want):
    for part in ("params", "state", "c_global", "c_stack"):
        _assert_same_bits(got[part], want[part], part)


def test_checkpoints_resume_across_mesh_shapes(world, one_rank_checkpoint, tmp):
    """One rank -> (2, 2, 1) -> (1, 2) -> one rank: each resume restores the state the
    last writer held bit for bit; the (2, 2, 1) run's checkpoint of its own three rounds
    resumes on one rank too."""
    four, two = world
    assert four[0]["resumed_round"] == 2
    _assert_same_state(four[0]["resumed"], one_rank_checkpoint)
    assert two[0]["resumed_round"] == 3
    _assert_same_state(two[0]["resumed"], four[0]["resumed_after"])
    back = W.make_coordinator(tmp / "back", scaffold=True, config=dict(num_rounds=5),
                              state_store=FileStateStore(tmp / "sc_mesh_to_1x2"))
    assert back.current_round == 4
    _assert_same_state(W._controls(back), two[0]["resumed_after"])
    own = W.make_coordinator(tmp / "own", scaffold=True, config=dict(num_rounds=4),
                             state_store=FileStateStore(tmp / "sc_mesh_ckpt"))
    assert own.current_round == 3
    _assert_same_state(W._controls(own), four[0]["coord"])


def test_resumed_mesh_round_matches_one_rank(world, tmp):
    """Round 2 on (2, 2, 1) after the one-rank checkpoint, against round 2 on one rank
    from the same checkpoint with the mesh's cohort."""
    got = world[0][0]
    coord = W.make_coordinator(tmp / "one_again", scaffold=True,
                               state_store=FileStateStore(tmp / "sc_one_ckpt"))
    coord._sample_cohort = lambda r: got["resumed_cohort"]
    coord.run()
    want = W._controls(coord)
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["resumed_after"]["params"][key], value, err_msg=key,
                                   **ONE_RANK_TOL)
    np.testing.assert_allclose(got["resumed_after"]["c_global"], want["c_global"],
                               **ONE_RANK_TOL)
    np.testing.assert_allclose(got["resumed_after"]["c_stack"], want["c_stack"],
                               **ONE_RANK_TOL)


def test_mesh_programs_profile_in_lockstep_and_rank_zero_publishes(world):
    four, _ = world
    programs = ["scaffold_round_step", "round_block", "round_step"]
    for r in four:
        assert [p[0] for p in r["reports"]] == programs
        assert all(n == 4 and flops > 0 and shape == [2, 2, 1]
                   for _, n, flops, shape in r["reports"])
    assert four[0]["published"] == sorted(programs)
    assert all(r["published"] == [] for r in four[1:])


def test_a_rank_out_of_step_fails_every_rank_instead_of_hanging(world):
    _, two = world
    for r in two:
        assert r["skewed"].startswith("the ranks are out of step")
        assert "'extra'" in r["skewed"] and "'round_step'" in r["skewed"]


@pytest.fixture(scope="module")
def one_device_block(setup):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.run_block(setup["inputs"], None, perms=setup["block_perms"])
    finally:
        torch.set_num_threads(threads)


def test_on_device_cohorts_over_hosts_match_one_device(world, one_device_block):
    """(2, 2, 1) draws the one-device block's cohorts bit for bit, fetches the rows
    another host holds in one all-gather a round, and lands within 1e-5 of one device
    (the reduce sums over ranks in another order)."""
    four, _ = world
    drawn = four[0]["block"]
    np.testing.assert_array_equal(drawn["cohort_ids"], one_device_block["cohort_ids"])
    for r in four:
        np.testing.assert_array_equal(r["block"]["cohort_ids"], drawn["cohort_ids"])
    # Some slot's client lives on the other host, so rows crossed hosts.
    ids = drawn["cohort_ids"]
    slot_host = np.arange(ids.shape[1]) // (ids.shape[1] // 2)
    assert ((ids // (W.C // 2)) != slot_host).any()
    assert drawn["exchange_bytes"] > 0 and one_device_block["exchange_bytes"] == 0
    for key, value in one_device_block["params"].items():
        np.testing.assert_allclose(drawn["params"][key], value, err_msg=key, **ONE_RANK_TOL)
    np.testing.assert_allclose(drawn["loss"], one_device_block["loss"], **ONE_RANK_TOL)


def test_on_device_cohorts_over_hosts_match_the_jax_block_given_them(setup, world):
    four, _ = world
    drawn = four[0]["block"]
    i = setup["inputs"]
    m = jax_get_model("digits_mlp")
    k = W.C // 2
    block = jax_build_round_block(
        lambda p, x, train=False, rng=None: m.apply(p, x), JaxTrainingConfig(**W.HYPER),
        jax_make_mesh(jax.devices()[:4], shape=(2, 2, 1)), jax_base.fedavg_strategy(),
        num_clients=W.C, padded_clients=W.C, step_clients=k, cohort_size=k,
        cohort_mode=True, params_like=i["params"])
    res = block(i["params"], jax_init_server_state(jax_base.fedavg_strategy(), i["params"]),
                JaxClientData(jnp.asarray(i["x"]), jnp.asarray(i["y"]), jnp.asarray(i["mask"])),
                jnp.asarray(i["mask"].sum(1)), stack_round_keys(BLOCK_SEED, list(range(BLOCK_ROUNDS))),
                jnp.ones(BLOCK_ROUNDS, jnp.float32),
                jnp.asarray(drawn["cohort_ids"].astype(np.int32)),
                jnp.ones((BLOCK_ROUNDS, k), jnp.float32))
    for key, value in flatten_with_names(jax.device_get(res.params)).items():
        np.testing.assert_allclose(drawn["params"][key], np.asarray(value), err_msg=key,
                                   **JAX_TOL)


def test_runner_takes_scaffold_on_two_hosts(world):
    runner = [r["runner"] for r in world[0]]
    assert runner[0]["mesh_shape"] == [2, 2, 1] and runner[0]["rounds_completed"] == 2
    assert all(r == runner[0] for r in runner)
    assert np.isfinite(runner[0]["final_train_metrics"]["loss"])


def test_ranks_import_no_jax(world):
    assert all(r["_imports"] == [] for ranks in world for r in ranks)
