"""The port's coordinator, runner, tuner and command line over a world of ranks on
gloo on the CPU: ``Coordinator(mesh_shape=(2, 2, 1))`` for three rounds against the
JAX ``Coordinator(mesh=make_mesh(devices[:4], shape=(2, 2, 1)), strict=False)``
(FedAdam, half-participation cohorts drawn host-locally, single-batch clients so the
two packages' permutation streams do not enter), its checkpoint resumed by a one-rank
coordinator and a one-rank checkpoint resumed on a model-sharded (2, 2) mesh,
``run_experiment(hosts=2)``, the autotuner's pick and the retuner's verdict under
rank-dependent measurements, and ``run --distributed --hosts 2`` under
``python -m torch.distributed.run --nproc_per_node 4``.

Tolerance 1e-4 against the JAX coordinator over three rounds (float32 products summed
in another order, then a sum over ranks in another association); resumed state is
bit-equal to the checkpoint it came from; a resumed mesh round is within 1e-5 of the
same round on one rank.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch_world_ranks as W

from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.parallel.launch import spawn_world
from nanofed_tpu_torch.persistence import FileStateStore
from nanofed_tpu_torch.utils.trees import flatten_with_names

REPO = Path(__file__).resolve().parents[1]
JAX_TOL = dict(rtol=0, atol=1e-4)
RESUME_TOL = dict(rtol=0, atol=1e-5)


def _jax_coordinator(base_dir):
    c = W.COORD
    return JaxCoordinator(
        model=jax_get_model("digits_mlp"),
        train_data=jax_federate(jax_synthetic(c["num_clients"] * c["samples"], 10, (8, 8, 1),
                                              seed=0), c["num_clients"],
                                batch_size=c["samples"]),
        config=JaxCoordinatorConfig(num_rounds=c["rounds"],
                                    participation_rate=c["participation"], seed=c["seed"],
                                    base_dir=base_dir),
        training=JaxTrainingConfig(batch_size=c["samples"], local_epochs=1, learning_rate=0.1),
        strategy=jax_base.fedadam_strategy(0.05),
        mesh=jax_make_mesh(jax.devices()[:4], shape=(2, 2, 1)), strict=False,
    )


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_coordinator")


@pytest.fixture(scope="module")
def one_rank(tmp):
    """Round 0 of a one-rank run, checkpointed; the world resumes a copy of it."""
    coord = W.make_coordinator(tmp / "one", config=dict(num_rounds=2),
                               state_store=FileStateStore(tmp / "one_ckpt"))
    next(coord.start_training())
    shutil.copytree(tmp / "one_ckpt", tmp / "one_to_mesh")
    return W._state(coord)


@pytest.fixture(scope="module")
def runs(tmp, one_rank):
    """The world first (its deadline must not compete with JAX), then the JAX
    coordinator's three rounds."""
    jax_params = jax.device_get(jax_get_model("digits_mlp").init(
        jax.random.key(W.COORD["seed"])))
    world = spawn_world(W.coordinator_world, 4, backend="gloo", device="cpu", timeout_s=120,
                        args=(str(tmp), jax_params))
    jc = _jax_coordinator(tmp / "jax")
    cohorts = [jc._sample_cohort(r).tolist() for r in range(W.COORD["rounds"])]
    rounds = jc.run()
    return world, dict(cohorts=cohorts, losses=[m.agg_metrics["loss"] for m in rounds],
                       params=flatten_with_names(jax.device_get(jc.params)))


def test_mesh_coordinator_matches_the_jax_coordinator(runs):
    world, want = runs
    got = world[0]
    assert got["mesh_shape"] == [2, 2, 1]
    assert got["cohorts"] == want["cohorts"]  # host-local stratified draws, bit-equal
    np.testing.assert_allclose(got["losses"], want["losses"], **JAX_TOL)
    assert got["params"].keys() == want["params"].keys()
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["params"][key], np.asarray(value), err_msg=key,
                                   **JAX_TOL)


def test_fused_mesh_run_equals_the_single_round_mesh_run(runs):
    """``rounds_per_block=3`` on the same mesh: the block shares the round's
    collectives and host cohorts, so it ends where the single rounds end (1e-6)."""
    world, _ = runs
    for key, value in world[0]["params"].items():
        np.testing.assert_allclose(world[0]["fused_params"][key], value, rtol=0, atol=1e-6,
                                   err_msg=key)


def test_every_rank_ends_the_run_with_the_same_params(runs):
    world, _ = runs
    for r in world[1:]:
        assert r["cohorts"] == world[0]["cohorts"]
        for key in ("params", "resumed_after"):
            for leaf, value in world[0][key].items():
                np.testing.assert_array_equal(r[key][leaf], value, err_msg=leaf)


def test_only_rank_zero_writes_the_run_files(runs, tmp):
    records = [json.loads(line) for line in (tmp / "mesh" / "telemetry.jsonl").open()]
    topology = [r for r in records if r.get("type", r.get("kind")) == "topology"
                or r.get("record") == "topology"]
    assert len(topology) == 1 and topology[0]["mesh_shape"] == [2, 2, 1]
    assert topology[0]["process_count"] == 4 and topology[0]["hosts"] == 2
    assert sorted(p.name for p in (tmp / "mesh" / "metrics").iterdir()) == [
        f"metrics_round_{r}.json" for r in range(W.COORD["rounds"])]


def test_mesh_checkpoint_resumes_on_one_rank(runs, tmp):
    world, _ = runs
    coord = W.make_coordinator(tmp / "back", state_store=FileStateStore(tmp / "mesh" / "ckpt"))
    assert coord.current_round == W.COORD["rounds"]
    params, state = W._state(coord)
    for key, value in world[0]["params"].items():
        np.testing.assert_array_equal(params[key], value, err_msg=key)
    for key, value in world[0]["state"].items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)


def test_one_rank_checkpoint_resumes_on_a_model_sharded_mesh(runs, one_rank, tmp):
    world, _ = runs
    got = world[0]
    assert got["resumed_round"] == 1
    params, state = one_rank
    for key, value in params.items():
        np.testing.assert_array_equal(got["resumed_params"][key], value, err_msg=key)
    for key, value in state.items():
        np.testing.assert_array_equal(got["resumed_state"][key], value, err_msg=key)
    # Round 1 on the (2, 2) mesh against round 1 on one rank, both from the checkpoint.
    coord = W.make_coordinator(tmp / "one_again", config=dict(num_rounds=2),
                               state_store=FileStateStore(tmp / "one_ckpt"))
    coord.run()
    want, _ = W._state(coord)
    for key, value in want.items():
        np.testing.assert_allclose(got["resumed_after"][key], value, err_msg=key,
                                   **RESUME_TOL)


def test_runner_spans_the_world_on_two_hosts(runs):
    world, _ = runs
    runner = [r["runner"] for r in world]
    assert runner[0]["mesh_shape"] == [2, 2, 1] and runner[0]["rounds_completed"] == 2
    assert all(r == runner[0] for r in runner)  # the same summary on every rank
    assert np.isfinite(runner[0]["final_train_metrics"]["loss"])


def test_every_rank_takes_rank_zero_tuner_pick_and_retune_verdict(runs):
    """Rank 0 ranks client_chunk 2 first, the others 16 (no chunk) first; every rank
    builds rank 0's pick.  The retuner's verdicts differ by rank; every rank records
    rank 0's."""
    world, _ = runs
    assert all(r["pick"] == world[0]["pick"] for r in world)
    assert world[0]["pick"]["client_chunk"] == 2
    assert all(r["retune"] == world[0]["retune"] for r in world)
    assert world[0]["retune"][0]["reason"] == "rank 0 holds"


def test_command_line_runs_two_hosts_under_torchrun(tmp):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
         "--master_port", str(free_port()), "-m", "nanofed_tpu_torch.cli", "run",
         "--distributed", "--hosts", "2", "--device", "cpu", "--model", "linear",
         "--clients", "8", "--rounds", "2", "--epochs", "1", "--batch-size", "8",
         "--train-size", "64", "--out-dir", str(tmp / "cli")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout)  # one summary: rank 0's
    assert summary["mesh_shape"] == [2, 2, 1] and summary["rounds_completed"] == 2
    assert proc.stderr.count("# distributed: process") == 4
