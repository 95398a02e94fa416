"""The port's fused Coordinator (``CoordinatorConfig.rounds_per_block``) on the CPU: a
fused run must be invisible (the single-round run's params, metrics JSON and FAILED
rounds within 1e-6 on the same seed), fall back to single rounds with the JAX
package's reasons, cut blocks at eval boundaries and run ragged tails single, persist
state only at block edges (so a closed run resumes at one), take a retuner's swap to R
and reach the runner.  The cohorts and FAILED statuses are held equal to the JAX
Coordinator's fused run too, since both draw them from the same numpy streams (the
port's counterpart of ``tests/integration/test_fused_rounds.py``)."""

import json

import numpy as np
import pytest
import torch

from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch import run_experiment
from nanofed_tpu_torch.aggregation import (
    PrivacyAwareAggregationConfig,
    RobustAggregationConfig,
    fedadam_strategy,
)
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.data import federate, pack_eval, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
from nanofed_tpu_torch.persistence import FileStateStore
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.tuning import AutotuneResult, CandidateConfig, CandidateOutcome
from nanofed_tpu_torch.utils.trees import ravel

CLOSE = dict(rtol=1e-6, atol=1e-6)
MLP = dict(in_features=16, hidden=32, num_classes=4)


def _data(n=256, seed=0):
    return synthetic_classification(n, 4, (16,), seed=seed)


def _make(tmp_path, sub, num_clients=16, n=256, eval_data=False, strategy=None, **kw):
    guards = {k: kw.pop(k) for k in ("scaffold", "robust", "central_privacy", "state_store",
                                     "client_chunk") if k in kw}
    return Coordinator(
        model=get_model("mlp", **MLP),
        train_data=federate(_data(n), num_clients=num_clients, batch_size=8),
        config=CoordinatorConfig(base_dir=tmp_path / sub, **kw),
        training=TrainingConfig(batch_size=8, local_epochs=2, learning_rate=0.1),
        strategy=strategy,
        eval_data=pack_eval(_data(64, seed=5), batch_size=32) if eval_data else None,
        device="cpu", **guards,
    )


def _round_json(base, r):
    payload = json.loads((base / "metrics" / f"metrics_round_{r}.json").read_text())
    for key in ("duration_s", "timestamp"):
        payload.pop(key)
    return payload


def _assert_same_run(fused, single, fused_rounds, single_rounds, rounds):
    torch.testing.assert_close(ravel(fused.params), ravel(single.params), **CLOSE)
    assert [m.status for m in fused_rounds] == [m.status for m in single_rounds]
    for f, s in zip(fused_rounds, single_rounds):
        assert (f.round_id, f.num_clients) == (s.round_id, s.num_clients)
        assert f.agg_metrics.keys() == s.agg_metrics.keys()
        for key in f.agg_metrics:
            np.testing.assert_allclose(f.agg_metrics[key], s.agg_metrics[key], **CLOSE)
    for r in range(rounds):
        pf, ps = _round_json(fused.base_dir, r), _round_json(single.base_dir, r)
        assert pf.keys() == ps.keys() and pf["status"] == ps["status"]
        if "clients" in ps:
            assert pf["clients"].keys() == ps["clients"].keys()
            for key, value in ps["clients"].items():
                np.testing.assert_allclose(pf["clients"][key], value, **CLOSE)


def _count_blocks(coord):
    calls = []
    block = coord._round_block

    def counted(*a, **k):
        calls.append(len(a[4]))
        return block(*a, **k)

    coord._round_block = counted
    return calls


@pytest.mark.parametrize("strategy", [None, "fedadam"])
def test_fused_run_equals_single_rounds(tmp_path, strategy):
    """rounds_per_block=2 over 4 rounds, a 4-of-16 cohort: the same params, metrics
    and per-client detail (client ids in slot order) as the single-round run."""
    kw = dict(num_rounds=4, participation_rate=0.25, seed=7, lr_schedule="cosine")
    make = (lambda sub, **k: _make(tmp_path, sub, strategy=fedadam_strategy(0.05), **k)) \
        if strategy else (lambda sub, **k: _make(tmp_path, sub, **k))
    fused, single = make("fused", rounds_per_block=2, **kw), make("single", **kw)
    assert fused._round_block is not None and fused._cohort_mode
    blocks = _count_blocks(fused)
    fr, sr = fused.run(), single.run()
    assert blocks == [2, 2]
    _assert_same_run(fused, single, fr, sr, 4)
    if strategy:
        assert fused.server_state["count"] == single.server_state["count"] == 4
    assert _round_json(fused.base_dir, 3)["clients"]["client_ids"] == \
        _round_json(single.base_dir, 3)["clients"]["client_ids"]
    assert [m.round_id for m in fused.history] == [0, 1, 2, 3]
    progress = fused.training_progress
    assert (progress.current_round, progress.completed_rounds, progress.failed_rounds) == (4, 4, 0)


@pytest.mark.parametrize("client_chunk", [None, 4])
def test_cohort_layouts_follow_the_coordinator(tmp_path, client_chunk):
    """A 10-of-16 cohort: gathered into 10 slots, or (a chunk of 4 does not divide
    10) the whole population with a client-id-ordered mask; the block takes the
    coordinator's layout either way."""
    kw = dict(num_rounds=2, participation_rate=0.6, seed=3, client_chunk=client_chunk)
    fused = _make(tmp_path, "fused", rounds_per_block=2, **kw)
    single = _make(tmp_path, "single", **kw)
    assert fused._cohort_mode == (client_chunk is None)
    fr, sr = fused.run(), single.run()
    assert [m.num_clients for m in fr] == [10, 10]
    _assert_same_run(fused, single, fr, sr, 2)


def _jax_coordinator(tmp_path, **kw):
    return JaxCoordinator(
        model=jax_get_model("mlp", **MLP),
        train_data=jax_federate(jax_synthetic(512, 4, (16,), seed=0), num_clients=8,
                                batch_size=64),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **kw),
        training=JaxTrainingConfig(batch_size=64, local_epochs=1),
    )


def test_dropout_fails_the_same_rounds_as_single_and_as_jax(tmp_path):
    kw = dict(num_rounds=6, participation_rate=0.5, dropout_rate=0.9,
              min_completion_rate=0.75, seed=0)
    fused = _make(tmp_path, "fused", num_clients=8, n=512, rounds_per_block=3, **kw)
    single = _make(tmp_path, "single", num_clients=8, n=512, **kw)
    fr, sr = fused.run(), single.run()
    assert any(m.status == RoundStatus.FAILED for m in fr)
    _assert_same_run(fused, single, fr, sr, 6)
    assert "clients" not in _round_json(fused.base_dir, [m.status for m in fr].index(
        RoundStatus.FAILED))
    jr = _jax_coordinator(tmp_path, rounds_per_block=3, **kw).run()
    assert [m.status.value for m in fr] == [m.status.value for m in jr]
    assert [m.num_clients for m in fr] == [m.num_clients for m in jr]


def test_cohorts_equal_the_jax_fused_run(tmp_path):
    kw = dict(num_rounds=4, participation_rate=0.5, dropout_rate=0.25, seed=9)
    fused = _make(tmp_path, "fused", num_clients=8, n=512, rounds_per_block=2, **kw)
    fr = fused.run()
    jr = _jax_coordinator(tmp_path, rounds_per_block=2, **kw).run()
    assert [(m.status.value, m.num_clients) for m in fr] == \
        [(m.status.value, m.num_clients) for m in jr]
    for m in fr:
        if m.status != RoundStatus.COMPLETED:
            continue
        ours = _round_json(fused.base_dir, m.round_id)["clients"]["client_ids"]
        theirs = _round_json(tmp_path / "jax", m.round_id)["clients"]["client_ids"]
        assert ours[: m.num_clients] == theirs[: m.num_clients]


@pytest.mark.parametrize("guard,reason", [
    ({"scaffold": True}, "SCAFFOLD"),
    ({"robust": RobustAggregationConfig(trim_k=1)}, "robust aggregation"),
    ({"central_privacy": PrivacyAwareAggregationConfig()}, "central DP"),
    ({"eval_every": 2}, "eval_every < rounds_per_block"),
])
def test_unfused_configurations_fall_back_with_the_jax_reason(tmp_path, guard, reason):
    coord = _make(tmp_path, "run", num_clients=8, n=256, num_rounds=2, rounds_per_block=4,
                  eval_data=True, **guard)
    assert coord._round_block is None and reason in coord._fused_fallback_reason
    assert "round_block" not in coord.program_catalog.names()
    rounds = coord.run()
    assert [m.status for m in rounds] == [RoundStatus.COMPLETED] * 2


def test_tails_and_eval_boundaries(tmp_path):
    """Blocks end on eval boundaries and the ragged tail runs single: 5 rounds at R=2
    with an eval every 4 run as blocks [0, 1], [2, 3] and the single round 4."""
    coord = _make(tmp_path, "run", num_clients=8, num_rounds=5, rounds_per_block=2,
                  eval_every=4, eval_data=True)
    blocks = _count_blocks(coord)
    rounds = coord.run()
    assert blocks == [2, 2]
    assert [r.round_id for r in rounds] == [0, 1, 2, 3, 4]
    assert "accuracy" in rounds[3].eval_metrics
    assert all(rounds[i].eval_metrics == {} for i in (0, 1, 2, 4))
    single = _make(tmp_path, "single", num_clients=8, num_rounds=5, eval_every=4,
                   eval_data=True)
    sr = single.run()
    _assert_same_run(coord, single, rounds, sr, 5)
    assert rounds[3].eval_metrics == pytest.approx(sr[3].eval_metrics, rel=1e-6)


def test_client_metrics_every_samples_the_detail(tmp_path):
    coord = _make(tmp_path, "run", num_clients=8, num_rounds=4, rounds_per_block=2,
                  client_metrics_every=2)
    coord.run()
    for r in range(4):
        payload = _round_json(coord.base_dir, r)
        if r % 2 == 0:
            assert len(payload["clients"]["weights"]) == 8, r
        else:
            assert "clients" not in payload, r
    never = _make(tmp_path, "never", num_clients=8, num_rounds=2, rounds_per_block=2,
                  client_metrics_every=0)
    never.run()
    assert all("clients" not in _round_json(never.base_dir, r) for r in range(2))


def test_closed_run_resumes_at_the_block_edge(tmp_path):
    kw = dict(num_rounds=4, participation_rate=0.5, rounds_per_block=2, seed=5)
    whole = _make(tmp_path, "whole", strategy=fedadam_strategy(0.05), **kw)
    whole.run()
    store = FileStateStore(tmp_path / "store")
    first = _make(tmp_path, "first", strategy=fedadam_strategy(0.05), state_store=store, **kw)
    rounds = first.start_training()
    assert [next(rounds).round_id for _ in range(2)] == [0, 1]  # one block
    rounds.close()
    assert [m.round_number for m in store.list_checkpoints()] == [1]  # the block's edge
    resumed = _make(tmp_path, "resumed", strategy=fedadam_strategy(0.05),
                    state_store=FileStateStore(tmp_path / "store"), **kw)
    assert resumed.current_round == 2 and resumed.server_state["count"] == 2
    assert [m.round_id for m in resumed.run()] == [2, 3]
    torch.testing.assert_close(ravel(resumed.params), ravel(whole.params), **CLOSE)
    assert resumed.server_state["count"] == whole.server_state["count"] == 4
    for key in ("mu", "nu"):
        torch.testing.assert_close(resumed.server_state[key], whole.server_state[key], **CLOSE)
    for r in (2, 3):
        assert _round_json(resumed.base_dir, r) == _round_json(whole.base_dir, r)


def _table(*cfgs):
    return AutotuneResult(
        winner=cfgs[0], outcomes=[CandidateOutcome(c, True, score=1.0 + i)
                                  for i, c in enumerate(cfgs)],
        scoring_basis="test", platform="cpu", device_kind="cpu", num_devices=1,
        hbm_budget_bytes=None, budget_basis="none", cache_key="k" * 64,
    )


def test_retuner_swaps_to_a_block_and_back(tmp_path):
    """The retuner is told R=2 is far faster: the coordinator swaps at round 2 and
    runs the rest as one block, equal to the unswapped run; a swap back to R=1 drops
    the block program from the catalog."""
    rpb1, rpb2 = CandidateConfig(None, 1, 1, 8), CandidateConfig(None, 2, 1, 8)
    coord = _make(tmp_path, "swapped", num_clients=8, num_rounds=4, retune_every=2, seed=3)
    rt = coord.enable_retuning(_table(rpb1, rpb2), cache_dir=None, current=rpb1)
    rt.observe(rpb2, rounds=100, walltime_s=1e-4)
    coord.run()
    assert [(e["round"], e["swap"], e["applied"]) for e in coord.retune_events] == [
        (2, True, True)]
    assert coord._retune_candidate == rpb2 and coord.config.rounds_per_block == 2
    assert coord._round_block is not None and "round_block" in coord.program_catalog.names()
    ref = _make(tmp_path, "reference", num_clients=8, num_rounds=4, seed=3)
    ref.run()
    torch.testing.assert_close(ravel(coord.params), ravel(ref.params), **CLOSE)
    coord._rebuild_round_programs(None, 1)
    assert coord._round_block is None and coord.config.rounds_per_block == 1
    assert coord.program_catalog.names() == ["round_step"]
    robust = _make(tmp_path, "robust", num_clients=8, num_rounds=4,
                   robust=RobustAggregationConfig(trim_k=1))
    with pytest.raises(NanoFedError, match="robust aggregation"):
        robust._rebuild_round_programs(None, 2)
    assert robust._round_block is None


def test_profiled_block_leaves_the_state_alone(tmp_path):
    coord = _make(tmp_path, "run", num_clients=8, num_rounds=2, rounds_per_block=2,
                  participation_rate=0.5)
    before = ravel(coord.params).clone()
    reports = {r.program: r for r in coord.profile_programs()}
    assert set(reports) == {"round_step", "round_block"}
    assert reports["round_block"].rounds == 2 and reports["round_block"].flops > 0
    assert torch.equal(ravel(coord.params), before)


def test_runner_takes_rounds_per_block(tmp_path):
    summary = run_experiment(model="mlp", num_clients=4, num_rounds=4, local_epochs=1,
                             batch_size=16, train_size=128, rounds_per_block=2,
                             device="cpu", out_dir=tmp_path)
    assert summary["rounds_completed"] == 4
    assert np.isfinite(summary["final_train_metrics"]["loss"])
    with pytest.raises(NanoFedError, match="owns rounds_per_block"):
        run_experiment(model="mlp", num_clients=4, num_rounds=4, train_size=64,
                       rounds_per_block=2, autotune=True, device="cpu", out_dir=tmp_path)
    with pytest.raises(ValueError, match="rounds_per_block must be >= 1"):
        CoordinatorConfig(rounds_per_block=0)
