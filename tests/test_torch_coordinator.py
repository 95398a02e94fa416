"""Port Coordinator and runner against the JAX package's, on the CPU: the host-side
cohort and dropout draws must be identical, and a run must write round metrics JSON
with the same keys."""

import json

import jax
import numpy as np
import pytest
import torch

from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import pack_eval as jax_pack_eval
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch import run_experiment
from nanofed_tpu_torch.data import federate, pack_eval, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
from nanofed_tpu_torch.trainer import TrainingConfig

SHAPE = (28, 28, 1)


def _coordinators(tmp_path, num_clients=8, train_size=64, **cfg):
    train = dict(batch_size=8, local_epochs=1, learning_rate=0.05)
    jc = JaxCoordinator(
        model=jax_get_model("mnist_cnn"),
        train_data=jax_federate(jax_synthetic(train_size, 10, SHAPE, seed=0), num_clients,
                                batch_size=8),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **cfg),
        training=JaxTrainingConfig(**train),
        eval_data=jax_pack_eval(jax_synthetic(32, 10, SHAPE, seed=1), 16),
    )
    tc = Coordinator(
        model=get_model("mnist_cnn"),
        train_data=federate(synthetic_classification(train_size, 10, SHAPE, seed=0),
                            num_clients, batch_size=8),
        config=CoordinatorConfig(base_dir=tmp_path / "torch", **cfg),
        training=TrainingConfig(**train),
        eval_data=pack_eval(synthetic_classification(32, 10, SHAPE, seed=1), 16),
        device="cpu",
    )
    return jc, tc


@pytest.mark.parametrize("participation,dropout", [(1.0, 0.0), (0.5, 0.3), (0.3, 0.5)])
def test_cohort_and_dropout_draws_equal_jax(tmp_path, participation, dropout):
    jc, tc = _coordinators(tmp_path, num_clients=10, train_size=80, seed=7,
                           participation_rate=participation, dropout_rate=dropout)
    assert tc.cohort_size == jc.cohort_size
    for round_id in range(6):
        np.testing.assert_array_equal(tc._sample_cohort(round_id), jc._sample_cohort(round_id))


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return type(obj).__name__ if not isinstance(obj, (int, float)) else "number"


def test_two_round_run_writes_the_same_metrics_json_keys(tmp_path):
    jc, tc = _coordinators(tmp_path, num_clients=8, seed=3, num_rounds=2,
                           participation_rate=0.5, eval_every=1)
    j_rounds, t_rounds = jc.run(), tc.run()
    assert [r.status for r in t_rounds] == [RoundStatus.COMPLETED] * 2
    assert [r.num_clients for r in t_rounds] == [r.num_clients for r in j_rounds]
    for round_id in range(2):
        name = f"metrics/metrics_round_{round_id}.json"
        j = json.loads((tmp_path / "jax" / name).read_text())
        t = json.loads((tmp_path / "torch" / name).read_text())
        assert _keys(t) == _keys(j)
        assert set(t["clients"]) == set(j["clients"]) >= {"weights", "update_sq_norms",
                                                          "client_ids"}
        assert all(np.isfinite(t["clients"]["update_sq_norms"]))


def test_completion_gate_fails_the_round_and_keeps_the_model(tmp_path):
    _, tc = _coordinators(tmp_path, num_clients=8, seed=0, num_rounds=1,
                          dropout_rate=0.9, min_completion_rate=1.0)
    before = {k: v.clone() for k, v in tc.params.items()}
    (metrics,) = tc.run()
    assert metrics.status == RoundStatus.FAILED
    assert all(torch.equal(tc.params[k], before[k]) for k in before)
    saved = json.loads((tmp_path / "torch" / "metrics/metrics_round_0.json").read_text())
    assert saved["status"] == "failed" and "clients" not in saved


def test_run_experiment_refuses_later_slice_flags_and_trains(tmp_path):
    with pytest.raises(NotImplementedError, match="scaffold"):
        run_experiment(num_clients=2, device="cpu", scaffold=True, out_dir=tmp_path)
    run_experiment(num_clients=2, device="cpu", scaffold=False, rounds_per_block=1,
                   num_rounds=1, local_epochs=1, batch_size=8, train_size=32,
                   out_dir=tmp_path / "ok")
    summary = run_experiment(num_clients=4, num_rounds=2, local_epochs=1, batch_size=8,
                             train_size=96, client_chunk=2, device="cpu",
                             out_dir=tmp_path / "run", proportions=[0.25] * 4)
    assert summary["rounds_completed"] == 2 and summary["params_device"] == "cpu"
    assert np.isfinite(summary["final_train_metrics"]["loss"])
    assert 0.0 <= summary["final_eval_metrics"]["accuracy"] <= 1.0


def test_jax_is_unaffected_by_the_port():
    """The tests above construct both Coordinators in one process; JAX still runs on
    its CPU devices."""
    assert jax.default_backend() == "cpu"
