"""Port Coordinator and runner against the JAX package's, on the CPU: the host-side
cohort and dropout draws must be identical, a run must write round metrics JSON with
the same keys, and the guarded round's bookkeeping (central-DP accounting and
secrecy, validation counts, the robust floor) must follow the JAX Coordinator's."""

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


def _coordinators(tmp_path, num_clients=8, train_size=64, jax_kw=None, torch_kw=None,
                  **cfg):
    train = dict(batch_size=8, local_epochs=1, learning_rate=0.05)
    jc = JaxCoordinator(
        model=jax_get_model("mnist_cnn"),
        train_data=jax_federate(jax_synthetic(train_size, 10, SHAPE, seed=0), num_clients,
                                batch_size=8),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **cfg),
        training=JaxTrainingConfig(**train),
        eval_data=jax_pack_eval(jax_synthetic(32, 10, SHAPE, seed=1), 16),
        **(jax_kw or {}),
    )
    tc = _torch_coordinator(tmp_path / "torch", num_clients, train_size, **(torch_kw or {}),
                            **cfg)
    return jc, tc


def _torch_coordinator(base_dir, num_clients=8, train_size=64, guards=None, **cfg):
    return Coordinator(
        model=get_model("mnist_cnn"),
        train_data=federate(synthetic_classification(train_size, 10, SHAPE, seed=0),
                            num_clients, batch_size=8),
        config=CoordinatorConfig(base_dir=base_dir, **cfg),
        training=TrainingConfig(batch_size=8, local_epochs=1, learning_rate=0.05),
        eval_data=pack_eval(synthetic_classification(32, 10, SHAPE, seed=1), 16),
        device="cpu",
        **(guards or {}),
    )


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
    """``strict``, the runner flag the analysis slice brought (refused before it): a
    strict run trains and its summary says so, as the JAX runner's does; a plain run's
    summary carries no ``strict`` key."""
    kw = dict(num_clients=2, device="cpu", rounds_per_block=1, num_rounds=1,
              local_epochs=1, batch_size=8, train_size=32)
    strict = run_experiment(strict=True, out_dir=tmp_path / "strict", **kw)
    assert strict["strict"] is True and strict["rounds_completed"] == 1
    plain = run_experiment(strict=False, out_dir=tmp_path / "ok", **kw)
    assert "strict" not in plain and plain["rounds_completed"] == 1
    summary = run_experiment(num_clients=4, num_rounds=2, local_epochs=1, batch_size=8,
                             train_size=96, client_chunk=2, device="cpu",
                             out_dir=tmp_path / "run", proportions=[0.25] * 4)
    assert summary["rounds_completed"] == 2 and summary["params_device"] == "cpu"
    assert np.isfinite(summary["final_train_metrics"]["loss"])
    assert 0.0 <= summary["final_eval_metrics"]["accuracy"] <= 1.0


def test_cohort_round_equals_full_masked_round_with_dropout(tmp_path):
    """Dropout on (mnist_cnn): the gathered cohort round and the full-N round in which
    the same survivors carry the weights release the same params, because every
    client's permutations and dropout masks follow its id, not its slot (the port's
    counterpart of tests/integration/test_end_to_end.py::
    test_cohort_gather_equals_full_mask_round)."""
    def make(name):
        return _torch_coordinator(tmp_path / name, num_clients=8, train_size=96, seed=5,
                                  num_rounds=2, participation_rate=0.5, save_metrics=False)

    gathered, full = make("gathered"), make("full")
    assert gathered._cohort_mode and gathered._step_clients == 4
    full._cohort_mode = False
    full._step_clients = full.num_clients
    g_rounds, f_rounds = gathered.run(), full.run()
    for k in gathered.params:
        torch.testing.assert_close(gathered.params[k], full.params[k], rtol=1e-6, atol=1e-6)
    for g, f in zip(g_rounds, f_rounds):
        assert g.agg_metrics["participating_clients"] == f.agg_metrics["participating_clients"]
        np.testing.assert_allclose(g.agg_metrics["loss"], f.agg_metrics["loss"], rtol=1e-5)


def _dp_configs(jax_side):
    from nanofed_tpu.aggregation.privacy import PrivacyAwareAggregationConfig as JaxCfg
    from nanofed_tpu.privacy import PrivacyConfig as JaxPrivacyConfig
    from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig
    from nanofed_tpu_torch.privacy import PrivacyConfig

    if jax_side:
        return JaxCfg(privacy=JaxPrivacyConfig(max_gradient_norm=1.0, noise_multiplier=1.1))
    return PrivacyAwareAggregationConfig(
        privacy=PrivacyConfig(max_gradient_norm=1.0, noise_multiplier=1.1))


def test_central_dp_accounts_like_jax_and_writes_no_client_detail(tmp_path):
    jc, tc = _coordinators(
        tmp_path, num_clients=8, seed=3, num_rounds=2, participation_rate=0.5,
        jax_kw=dict(central_privacy=_dp_configs(True)),
        torch_kw=dict(guards=dict(central_privacy=_dp_configs(False))),
    )
    jc.run()
    t_rounds = tc.run()
    assert [r.status for r in t_rounds] == [RoundStatus.COMPLETED] * 2
    assert tc.privacy_spent.to_dict() == jc.privacy_spent.to_dict()
    assert tc.privacy_accountant.state_dict() == jc.privacy_accountant.state_dict()
    assert t_rounds[-1].agg_metrics["privacy_epsilon"] == jc.privacy_spent.epsilon_spent
    for round_id in range(2):
        saved = json.loads(
            (tmp_path / "torch" / f"metrics/metrics_round_{round_id}.json").read_text())
        assert "clients" not in saved
        assert {"privacy_epsilon", "privacy_delta"} <= set(saved["agg_metrics"])
        assert np.isfinite(saved["agg_metrics"]["loss"])


def test_central_dp_draws_are_secret(tmp_path):
    """Under DP the round seed (permutations, dropout keys, noise) comes from OS
    entropy, never from config.seed; without DP it is the seed's."""
    tc = _torch_coordinator(tmp_path, seed=3, save_metrics=False,
                            guards=dict(central_privacy=_dp_configs(False)))
    seeds = {tc._round_seed(0), tc._round_seed(0)}
    assert len(seeds) == 2 and 3 * 100_003 not in seeds
    plain = _torch_coordinator(tmp_path, seed=3, save_metrics=False)
    assert plain._round_seed(2) == 3 * 100_003 + 2


def test_accountant_without_central_privacy_is_refused(tmp_path):
    from nanofed_tpu_torch.privacy import RDPAccountant

    with pytest.raises(ValueError, match="accountant"):
        _torch_coordinator(tmp_path, guards=dict(accountant=RDPAccountant()))


def test_robust_floor_is_refused_at_construction_as_jax(tmp_path):
    from nanofed_tpu.aggregation.robust import RobustAggregationConfig as JaxRobust
    from nanofed_tpu_torch.aggregation import RobustAggregationConfig

    with pytest.raises(ValueError, match="cohort of at least 7") as want:
        _coordinators(tmp_path, num_clients=8, participation_rate=0.5,
                      jax_kw=dict(robust=JaxRobust(trim_k=3)))
    with pytest.raises(ValueError, match="cohort of at least 7") as got:
        _torch_coordinator(tmp_path, participation_rate=0.5,
                           guards=dict(robust=RobustAggregationConfig(trim_k=3)))
    assert str(got.value) == str(want.value)


def test_validated_and_robust_rounds_report_their_counts(tmp_path):
    from nanofed_tpu_torch.aggregation import RobustAggregationConfig
    from nanofed_tpu_torch.security import ValidationConfig

    tc = _torch_coordinator(tmp_path / "v", seed=1, num_rounds=1,
                            guards=dict(validation=ValidationConfig()))
    (metrics,) = tc.run()
    agg = metrics.agg_metrics
    assert type(agg["valid_clients"]) is int and type(agg["participating_clients"]) is int
    assert 0 < agg["valid_clients"] <= agg["participating_clients"] == 8
    tc = _torch_coordinator(tmp_path / "r", seed=1, num_rounds=1,
                            guards=dict(robust=RobustAggregationConfig(method="median")))
    (metrics,) = tc.run()
    assert metrics.agg_metrics["robust_kept_clients"] == 8.0


def test_run_experiment_takes_the_guarded_flags(tmp_path):
    summary = run_experiment(num_clients=6, num_rounds=1, local_epochs=1, batch_size=8,
                             train_size=96, device="cpu", out_dir=tmp_path / "r",
                             robust_method="multi_krum")
    assert summary["final_train_metrics"]["robust_kept_clients"] == 5.0
    summary = run_experiment(num_clients=4, num_rounds=2, local_epochs=1, batch_size=8,
                             train_size=64, device="cpu", out_dir=tmp_path / "dp",
                             client_chunk=2, central_privacy=_dp_configs(False))
    assert summary["final_train_metrics"]["privacy_epsilon"] > 0
    with pytest.raises(ValueError, match="unknown robust method"):
        run_experiment(num_clients=4, device="cpu", robust_method="mean", out_dir=tmp_path)


def test_jax_is_unaffected_by_the_port():
    """The tests above construct both Coordinators in one process; JAX still runs on
    its CPU devices."""
    assert jax.default_backend() == "cpu"
