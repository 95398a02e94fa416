"""The port's tuning slice against the JAX package's, on the CPU.

The pure decision logic must give the JAX package's results on identical inputs: the
default space, its candidates, the ranking and the sweep order, the program names,
the static rejection reasons, artifacts read across, and the online retuner's
decisions and cache write-back.  The sweep itself differs by design (the port runs
and counts each candidate; the JAX package compiles it): it is held to its contract
here (a winner, the JAX artifact keys, stated rejections, a cache hit that profiles
nothing), and the coordinator's retune swap to the unswapped trajectory.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nanofed_tpu.tuning import AutotuneResult as JaxAutotuneResult
from nanofed_tpu.tuning import CandidateConfig as JaxCandidateConfig
from nanofed_tpu.tuning import CandidateOutcome as JaxCandidateOutcome
from nanofed_tpu.tuning import OnlineRetuner as JaxOnlineRetuner
from nanofed_tpu.tuning import PopulationSpec as JaxPopulationSpec
from nanofed_tpu.tuning import TuningSpace as JaxTuningSpace
from nanofed_tpu.tuning import autotuner as jax_autotuner
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch import run_experiment
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability import profiling
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.tuning import (
    AutotuneError,
    AutotuneResult,
    CandidateConfig,
    CandidateOutcome,
    OnlineRetuner,
    PopulationSpec,
    TuningSpace,
    autotune,
    candidate_program_name,
    order_by_predicted_compile_cost,
    rank_candidates,
    resolve_hbm_budget,
)
from nanofed_tpu_torch.tuning import autotuner
from nanofed_tpu_torch.utils.trees import ravel

POPULATIONS = [(8, 32), (1000, 64), (12, 96), (7, 60)]
SWEEP_SPACE = TuningSpace(client_chunks=(None, 2), rounds_per_blocks=(1, 2), model_shards=(1,),
                          batch_sizes=(16, 32))
LINEAR_POP = PopulationSpec(num_clients=8, capacity=32, sample_shape=(10,))


def _as_jax(cfg: CandidateConfig) -> JaxCandidateConfig:
    return JaxCandidateConfig.from_dict(cfg.to_dict())


# ---------------------------------------------------------------------------
# The pure logic, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clients,capacity", POPULATIONS)
@pytest.mark.parametrize("batch_size,num_rounds", [(16, 10), (32, 3), (64, 1)])
def test_default_space_and_candidates_equal_jax(clients, capacity, batch_size, num_rounds):
    pop = PopulationSpec(clients, capacity, (28, 28, 1))
    jpop = JaxPopulationSpec(clients, capacity, (28, 28, 1))
    space = TuningSpace.default(pop, 1, batch_size, num_rounds)
    jspace = JaxTuningSpace.default(jpop, 1, batch_size, num_rounds, hosts=(1,))
    assert space.to_dict() == jspace.to_dict()
    assert [c.to_dict() for c in space.candidates()] == [
        c.to_dict() for c in jspace.candidates()
    ]


def _outcome_lists(rng: np.random.Generator):
    """The same outcome table for both packages: random scores with exact ties,
    peaks, rejected rows."""
    port, jax = [], []
    for chunk in (None, 1, 2, 4):
        for rpb in (1, 2, 4):
            for batch in (16, 32):
                cfg = CandidateConfig(chunk, rpb, 1, batch)
                feasible = bool(rng.random() > 0.2)
                score = float(rng.integers(1, 4)) if feasible else None
                cost = {"peak_bytes": int(rng.integers(0, 3))} if feasible else {}
                reason = None if feasible else "rejected for the test"
                port.append(CandidateOutcome(cfg, feasible, reason, score, dict(cost)))
                jax.append(JaxCandidateOutcome(_as_jax(cfg), feasible, reason, score,
                                               dict(cost)))
    order = rng.permutation(len(port))
    return [port[i] for i in order], [jax[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_and_sweep_order_equal_jax(seed):
    port, jax = _outcome_lists(np.random.default_rng(seed))
    assert [o.to_dict() for o in rank_candidates(port)] == [
        o.to_dict() for o in jax_autotuner.rank_candidates(jax)
    ]
    assert [c.to_dict() for c in order_by_predicted_compile_cost(o.config for o in port)] == [
        c.to_dict() for c in jax_autotuner.order_by_predicted_compile_cost(
            o.config for o in jax)
    ]


@pytest.mark.parametrize("cfg", [
    CandidateConfig(None, 1, 1, 16), CandidateConfig(125, 1, 1, 64),
    CandidateConfig(2, 4, 2, 32, hosts=2), CandidateConfig(None, 1, 1, 16, adapter_rank=8),
])
def test_candidate_program_name_equals_jax(cfg):
    assert candidate_program_name(cfg) == jax_autotuner.candidate_program_name(_as_jax(cfg))


STATIC = [
    # (candidate, num_rounds, eval_every, participation, n_devices): each statically
    # infeasible; the reason must be the JAX package's word for word.
    (CandidateConfig(None, 1, 1, 7), 4, 0, 1.0, 1),  # batch does not divide capacity
    (CandidateConfig(None, 9, 1, 16), 4, 0, 1.0, 1),  # rpb exceeds num_rounds
    (CandidateConfig(None, 4, 1, 16), 8, 2, 1.0, 1),  # rpb > eval_every
    (CandidateConfig(None, 1, 2, 16), 4, 0, 1.0, 1),  # model_shards on one device
    (CandidateConfig(None, 1, 1, 16, hosts=2), 4, 0, 1.0, 1),  # hosts on one device
    (CandidateConfig(3, 1, 1, 16), 4, 0, 1.0, 1),  # chunk does not divide 8 clients
    (CandidateConfig(3, 1, 1, 16), 4, 0, 0.5, 1),  # cohort of 4 falls back to full-N
    (CandidateConfig(4, 1, 1, 16, hosts=2), 4, 0, 1.0, 8),  # chunk exceeds a host shard
    (CandidateConfig(None, 1, 1, 16, adapter_rank=4), 4, 0, 1.0, 1),  # rank, no spec
]


@pytest.mark.parametrize("case", STATIC, ids=[f"static{i}" for i in range(len(STATIC))])
def test_static_rejection_reasons_equal_jax(case):
    cfg, rounds, every, participation, n_dev = case
    jpop = JaxPopulationSpec(8, 32, (10,))
    want = jax_autotuner._evaluate_candidate(
        _as_jax(cfg), None, jpop, JaxTrainingConfig(batch_size=16), participation, rounds,
        every, n_dev, None)
    got = autotuner._evaluate_candidate(
        cfg, None, LINEAR_POP, TrainingConfig(batch_size=16), participation, rounds,
        every, n_dev, None)
    assert not want.feasible and not got.feasible
    assert got.reject_reason == want.reject_reason


@pytest.mark.parametrize("cfg,axis", [
    (CandidateConfig(None, 1, 2, 16), "mesh shape (2, 2) needs 4 devices"),
    (CandidateConfig(None, 1, 1, 16, hosts=2), "mesh shape (2, 2, 1) needs 4 devices"),
])
def test_unported_axes_are_rejected_with_their_slice(cfg, axis):
    """Past the JAX checks (four devices here, so the mesh axes divide), the mesh
    axes are no longer rejected: the candidate is built on its mesh over the world's
    ranks, so outside a world of four it fails at the mesh's own check."""
    model = get_model("linear", in_features=10, num_classes=2)
    with pytest.raises(ValueError, match=axis.replace("(", r"\(").replace(")", r"\)")):
        autotuner._evaluate_candidate(cfg, model, LINEAR_POP, TrainingConfig(batch_size=16),
                                      1.0, 4, 0, 4, None, device="cpu")


@pytest.mark.parametrize("rpb", [1, 2])
def test_adapter_rank_candidate_profiles_the_frozen_base_round(rpb):
    """An ``adapter_rank`` candidate, which earlier slices rejected, profiles the
    frozen-base round (or block) at its rank: feasible, its program named with the
    rank, its counted bytes below the dense candidate's."""
    from nanofed_tpu_torch.adapters import AdapterSpec

    model = get_model("mlp", in_features=10, hidden=64, num_classes=2)
    spec = AdapterSpec(rank=8)
    out = {rank: autotuner._evaluate_candidate(
        CandidateConfig(None, rpb, 1, 16, adapter_rank=rank), model, LINEAR_POP,
        TrainingConfig(batch_size=16), 1.0, 4, 0, 1, None, adapter=spec, device="cpu")
        for rank in (4, None)}
    assert out[4].feasible and out[None].feasible
    assert out[4].cost["bytes_accessed_per_round"] < out[None].cost["bytes_accessed_per_round"]
    assert candidate_program_name(out[4].config).endswith("_r4")


def _jax_result() -> JaxAutotuneResult:
    outcomes = [
        JaxCandidateOutcome(JaxCandidateConfig(None, 1, 1, 16), True, score=2.5,
                            cost={"peak_bytes": 10, "compile_seconds": 1.25,
                                  "verdict": "memory-bound"}),
        JaxCandidateOutcome(JaxCandidateConfig(2, 1, 1, 16), True, score=3.0,
                            cost={"peak_bytes": 8, "compile_seconds": 0.5}),
        JaxCandidateOutcome(JaxCandidateConfig(None, 2, 1, 16), False,
                            reject_reason="rounds_per_block 2 exceeds num_rounds 1"),
    ]
    return JaxAutotuneResult(
        winner=outcomes[0].config, outcomes=outcomes, scoring_basis="basis",
        platform="cpu", device_kind="cpu", num_devices=1, hbm_budget_bytes=None,
        budget_basis="unbounded", cache_key="k" * 64, compiles=2,
        compile_seconds_total=1.75, compile_budget_s=30.0, skipped=1,
        wedged_at="cand_x", space={"client_chunks": [None, 2]},
        population={"num_clients": 8}, epilogues={"flat_size": 10},
    )


def test_jax_artifact_round_trips_through_the_port():
    d = json.loads(json.dumps(_jax_result().to_dict()))
    back = AutotuneResult.from_dict(d)
    assert back.to_dict() == d
    assert back.winner == CandidateConfig(None, 1, 1, 16)
    assert JaxAutotuneResult.from_dict(back.to_dict()).to_dict() == d


def _retune_feed(rt, cfgs):
    rt.observe(cfgs[0], rounds=4, walltime_s=4.0, occupancy=None)
    decisions = [rt.propose(cfgs[0])]
    rt.observe(cfgs[1], rounds=2, walltime_s=0.5)
    decisions.append(rt.propose(cfgs[0]))
    rt.observe(cfgs[1], rounds=0, walltime_s=1.0)  # dropped, as in the JAX retuner
    decisions.append(rt.propose(cfgs[1]))
    return decisions


def test_retuner_decisions_and_write_back_equal_jax(tmp_path):
    jres = _jax_result()
    jres.outcomes = [o for o in jres.outcomes if o.feasible] + [
        JaxCandidateOutcome(JaxCandidateConfig(4, 1, 1, 16), True, score=1.0, cost={}),
        JaxCandidateOutcome(JaxCandidateConfig(None, 1, 1, 32), True, score=0.1, cost={}),
    ]
    entry = json.dumps(jres.to_dict())
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    name = f"autotune_{jres.cache_key[:16]}.json"
    for sub in ("jax", "torch"):
        (tmp_path / sub / name).write_text(entry)
    pres = AutotuneResult.from_dict(json.loads(entry))
    jrt = JaxOnlineRetuner(jres, cache_dir=tmp_path / "jax")
    prt = OnlineRetuner(pres, cache_dir=tmp_path / "torch")
    jd = _retune_feed(jrt, [JaxCandidateConfig(None, 1, 1, 16), JaxCandidateConfig(2, 1, 1, 16)])
    pd = _retune_feed(prt, [CandidateConfig(None, 1, 1, 16), CandidateConfig(2, 1, 1, 16)])
    assert [d.to_dict() for d in pd] == [d.to_dict() for d in jd]
    assert any(d.swap for d in pd)
    assert prt.summary() == jrt.summary()
    assert prt.write_back() is not None and jrt.write_back() is not None
    assert (tmp_path / "torch" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_resolve_hbm_budget(monkeypatch):
    assert resolve_hbm_budget(123)[0] == 123
    monkeypatch.setenv("NANOFED_AUTOTUNE_HBM_BUDGET", "1e9")
    assert resolve_hbm_budget() == (10**9, "NANOFED_AUTOTUNE_HBM_BUDGET environment variable")
    monkeypatch.delenv("NANOFED_AUTOTUNE_HBM_BUDGET")
    budget, basis = resolve_hbm_budget(device="cpu")
    assert budget is None and "unbounded" in basis


def test_resolve_hbm_budget_defaults_to_the_card(monkeypatch):
    """A bare call means the card (``device=None`` is ``"cuda"``): without one it
    raises, never reporting the CPU's "unbounded"."""
    monkeypatch.delenv("NANOFED_AUTOTUNE_HBM_BUDGET", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_hbm_budget()


def test_evaluate_candidate_defaults_to_the_card(monkeypatch):
    """A candidate past the static checks is profiled on the card unless its caller
    names a device: without a card a bare call raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotuner._evaluate_candidate(CandidateConfig(None, 1, 1, 16), None, LINEAR_POP,
                                      TrainingConfig(batch_size=16), 1.0, 4, 0, 1, None)


# ---------------------------------------------------------------------------
# The sweep on the CPU
# ---------------------------------------------------------------------------


def _linear_data(num_clients=8, per_client=32, batch=16):
    return federate(synthetic_classification(num_clients * per_client, 2, (10,), seed=0),
                    num_clients=num_clients, batch_size=batch, seed=0)


def _sweep(tmp_path, **kw):
    args = dict(num_rounds=4, space=SWEEP_SPACE, cache_dir=tmp_path / "cache",
                out_dir=tmp_path / "runs", device="cpu")
    args.update(kw)
    return autotune(get_model("linear"), _linear_data(), TrainingConfig(batch_size=16),
                    **args)


def test_autotune_on_the_cpu_writes_the_jax_artifact_and_hits_its_cache(tmp_path, monkeypatch):
    res = _sweep(tmp_path)
    assert res.winner is not None
    assert res.compiles == 8  # chunk {None, 2} x rpb {1, 2} x batch {16, 32}: all run
    table = json.loads(next((tmp_path / "runs").glob("autotune_*.json")).read_text())
    jax_keys = set(_jax_result().to_dict()) - {"compile_budget_s", "skipped", "wedged_at"}
    assert set(table) == jax_keys
    feasible = [c for c in table["candidates"] if c["feasible"]]
    assert [c["score"] for c in feasible] == sorted(c["score"] for c in feasible)
    assert all(c["cost"]["measured_s_per_round"] > 0 for c in feasible)
    # The rpb-2 rows profiled their two-round blocks: scored per round, as the steps.
    assert not [c for c in table["candidates"] if not c["feasible"]]
    assert {c["config"]["rounds_per_block"] for c in feasible} == {1, 2}
    blocks = [c for c in feasible if c["config"]["rounds_per_block"] == 2]
    assert len(blocks) == 4 and all(c["cost"]["flops_per_round"] > 0 for c in blocks)
    assert "NOT a predicted walltime" in table["scoring_basis"]
    assert set(table["epilogues"]["reports"]) == {
        "q8_epilogue_dequant", "q8_epilogue_reduce", "q8_epilogue_fused",
        "validated_epilogue_sanitize", "validated_epilogue_reduce", "validated_epilogue_fused"}

    def no_profiling(*a, **k):
        raise AssertionError("a cache hit must profile nothing")

    monkeypatch.setattr(profiling, "profile_program", no_profiling)
    again = _sweep(tmp_path)
    assert again.cache_hit and again.compiles == 0
    assert again.winner == res.winner
    assert [o.to_dict() for o in again.outcomes] == [o.to_dict() for o in res.outcomes]


def test_budget_rejection_and_the_all_rejected_error(tmp_path, monkeypatch):
    """The decision logic reads the measured peak: a peak over the budget rejects,
    and a sweep with no survivor raises after writing its artifact (and is never
    cached)."""
    real = profiling.profile_program

    def with_peak(*a, **k):
        import dataclasses

        report = real(*a, **k)
        return dataclasses.replace(report, peak_bytes=1000 * report.attrs["batch_size"])

    monkeypatch.setattr(profiling, "profile_program", with_peak)
    res = _sweep(tmp_path, hbm_budget_bytes=20_000, include_epilogues=False, out_dir=None,
                 cache_dir=None)
    assert res.winner.batch_size == 16
    over = [o for o in res.outcomes if not o.feasible and o.config.rounds_per_block == 1]
    assert {o.config.batch_size for o in over} == {32}
    assert all("exceeds the device HBM budget 20,000 bytes" in o.reject_reason for o in over)
    with pytest.raises(AutotuneError, match="exceeds the device HBM budget"):
        _sweep(tmp_path, hbm_budget_bytes=10, include_epilogues=False)
    table = json.loads(next((tmp_path / "runs").glob("autotune_*.json")).read_text())
    assert table["winner"] is None
    assert not (tmp_path / "cache").exists()


def test_only_out_of_memory_turns_a_candidate_into_a_rejection(tmp_path, monkeypatch):
    real = profiling.profile_program

    def oom_when_chunked(name, fn, *a, **k):
        if k["attrs"]["client_chunk"] is not None:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")
        return real(name, fn, *a, **k)

    monkeypatch.setattr(profiling, "profile_program", oom_when_chunked)
    res = _sweep(tmp_path, include_epilogues=False, cache_dir=None, out_dir=None)
    assert res.winner.client_chunk is None
    oom = [o for o in res.outcomes if o.config.client_chunk == 2 and o.config.rounds_per_block == 1]
    assert all(not o.feasible and o.reject_reason.startswith("out of device memory") for o in oom)

    def kernel_fails(*a, **k):
        raise RuntimeError("dequant_accumulate_flat: CUDA kernel launch failed")

    monkeypatch.setattr(profiling, "profile_program", kernel_fails)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _sweep(tmp_path, include_epilogues=False, cache_dir=None, out_dir=None)


def test_autotune_takes_an_adapter_spec(tmp_path):
    """``autotune(adapter=)``, which earlier slices refused: the default space is the
    JAX rank ladder around the spec's rank, every candidate runs the frozen-base
    round, the cache key carries the spec and the epilogues are sized to the adapter
    payload."""
    from nanofed_tpu_torch.adapters import AdapterSpec, adapter_param_count

    model = get_model("mlp", in_features=10, hidden=64, num_classes=2)
    spec = AdapterSpec(rank=4)
    # The default space's rank ladder; its chunk and batch axes pinned to one value each
    # (they do not enter these checks), so 3 candidates run instead of 27.
    space = dataclasses.replace(
        TuningSpace.default(PopulationSpec(8, 32, (10,)), 1, 16, 1, adapter_rank=4),
        client_chunks=(None,), batch_sizes=(16,))
    res = autotune(model, _linear_data(), TrainingConfig(batch_size=16), num_rounds=1,
                   space=space, cache_dir=tmp_path / "cache", out_dir=None, adapter=spec,
                   device="cpu")
    jspace = JaxTuningSpace.default(JaxPopulationSpec(8, 32, (10,)), 1, 16, 1, adapter_rank=4)
    assert res.space["adapter_ranks"] == list(jspace.adapter_ranks) == [2, 4, 8]
    assert all(o.config.adapter_rank in (2, 4, 8) for o in res.outcomes)
    assert res.winner.adapter_rank in (2, 4, 8)
    params = model.init(torch.Generator().manual_seed(0))
    assert res.epilogues["flat_size"] == adapter_param_count(spec, params)["adapter_params"]
    again = autotune(model, _linear_data(), TrainingConfig(batch_size=16), num_rounds=1,
                     space=dataclasses.replace(space, adapter_ranks=(None,)),
                     cache_dir=tmp_path / "cache", out_dir=None, device="cpu")
    assert not again.cache_hit  # the dense sweep is another cache entry


def test_autotune_telemetry_gets_a_compile_record_per_candidate(tmp_path):
    """``autotune(telemetry=)``: one ``compile`` record per profiled candidate and the
    ``autotune`` record, with the JAX package's fields."""
    from nanofed_tpu_torch.observability import RunTelemetry, summarize_telemetry

    tel = RunTelemetry(tmp_path / "tel", annotate_device=False)
    res = _sweep(tmp_path, telemetry=tel, include_epilogues=False)
    tel.close()
    summary = summarize_telemetry(tmp_path / "tel" / "telemetry.jsonl")
    assert summary["compiles"]["count"] == res.compiles == 8
    assert set(summary["compiles"]["by_program"]) == {
        candidate_program_name(o.config) for o in res.outcomes}
    (digest,) = summary["autotunes"].values()
    assert digest["winner"] == res.winner.to_dict() and digest["cache_hit"] is False


def test_cache_key_follows_population_and_budget():
    model, training = get_model("linear"), TrainingConfig(batch_size=16)
    base = dict(model=model, training=training, space=SWEEP_SPACE, participation=1.0,
                num_rounds=4, eval_every=0, device_kind="cpu", num_devices=1)
    key = autotuner.compute_cache_key(population=LINEAR_POP, **base)
    assert key == autotuner.compute_cache_key(population=LINEAR_POP, **base)
    other = PopulationSpec(16, 32, (10,))
    assert key != autotuner.compute_cache_key(population=other, **base)
    assert key != autotuner.compute_cache_key(population=LINEAR_POP, hbm_budget=10**9, **base)


# ---------------------------------------------------------------------------
# The coordinator and the runner
# ---------------------------------------------------------------------------


def test_run_experiment_autotuned_with_retuning_and_profiling(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the sweep's cache goes to ./.nanofed_torch_cache
    summary = run_experiment(model="mlp", num_clients=4, num_rounds=3, local_epochs=1,
                             batch_size=16, train_size=128, autotune=True, retune_every=1,
                             profile_programs=True, device="cpu", out_dir=tmp_path)
    assert summary["rounds_completed"] == 3
    tuned = summary["tuned_config"]
    assert tuned["used"] == "tuned" and "NOT a predicted walltime" in tuned["scoring_basis"]
    assert set(summary["retunes"]) >= {"decisions", "swaps", "hysteresis", "measured"}
    assert summary["retunes"]["decisions"] >= 1
    assert sum(m["rounds"] for m in summary["retunes"]["measured"].values()) == 3
    profile = summary["program_profiles"]["round_step"]
    assert profile["flops"] > 0 and profile["measured_s"] > 0
    assert not summary["tuned_config"]["cache_hit"]
    assert list((tmp_path / ".nanofed_torch_cache").glob("autotune_*.json"))


@pytest.mark.parametrize("kwargs,match", [
    ({"retune_every": 2}, "retune_every requires autotune"),
    ({"autotune": True, "client_chunk": 2}, "owns client_chunk"),
])
def test_run_experiment_keeps_the_jax_refusals(tmp_path, kwargs, match):
    with pytest.raises(NanoFedError, match=match):
        run_experiment(model="mlp", num_clients=4, num_rounds=1, train_size=64,
                       device="cpu", out_dir=tmp_path, **kwargs)


def test_config_and_from_autotune_refusals(tmp_path):
    with pytest.raises(ValueError, match="retune_every"):
        CoordinatorConfig(retune_every=-1)
    with pytest.raises(NanoFedError, match="owns client_chunk"):
        Coordinator.from_autotune(get_model("linear"), _linear_data(), CoordinatorConfig(),
                                  client_chunk=2, device="cpu")


def test_from_autotune_applies_the_winner_and_attaches_the_retuner(tmp_path):
    space = TuningSpace((2,), (1,), (1,), (32,))  # pinned: one candidate
    coord = Coordinator.from_autotune(
        get_model("linear"), _linear_data(),
        CoordinatorConfig(num_rounds=3, base_dir=tmp_path, retune_every=1),
        TrainingConfig(batch_size=16), tuning_space=space,
        autotune_cache_dir=tmp_path / "cache", device="cpu")
    assert coord._client_chunk == 2 and coord.training.batch_size == 32
    assert coord.tuned_config["client_chunk"] == 2 and coord.retuner is not None
    coord.run()
    entry = json.loads(next((tmp_path / "cache").glob("autotune_*.json")).read_text())
    assert entry["measured"]["table"]["cand_chunk2_rpb1_m1_b32_h1"]["rounds"] == 3


RPB1 = CandidateConfig(None, 1, 1, 8)
CHUNK2 = CandidateConfig(2, 1, 1, 8)
CHUNK3 = CandidateConfig(3, 1, 1, 8)  # does not divide the 8 clients: refused


def _table(*cfgs):
    return AutotuneResult(
        winner=cfgs[0], outcomes=[CandidateOutcome(c, True, score=1.0 + i)
                                  for i, c in enumerate(cfgs)],
        scoring_basis="test", platform="cpu", device_kind="cpu", num_devices=1,
        hbm_budget_bytes=None, budget_basis="none", cache_key="k" * 64,
    )


def _mnist_coordinator(tmp_path, name, **cfg):
    return Coordinator(
        get_model("mnist_cnn"),  # trains with dropout: the keep-masks are client-stable
        federate(synthetic_classification(64, 10, (28, 28, 1), seed=0), 8, batch_size=8),
        CoordinatorConfig(**{"num_rounds": 4, "seed": 3, "base_dir": tmp_path / name,
                             "save_metrics": False, **cfg}),
        training=TrainingConfig(batch_size=8, local_epochs=1, learning_rate=0.05),
        device="cpu",
    )


def test_forced_retune_swap_keeps_the_trajectory(tmp_path):
    """The retuner is told the chunked program is far faster: it swaps at the round-2
    boundary, the rest of the run streams the reduce, and the final params equal the
    unswapped (materialised) run's within 1e-6."""
    coord = _mnist_coordinator(tmp_path, "swapped", retune_every=2)
    rt = coord.enable_retuning(_table(RPB1, CHUNK2), cache_dir=None, current=RPB1)
    rt.observe(CHUNK2, rounds=100, walltime_s=1e-4)
    coord.run()
    assert [(e["round"], e["swap"], e["applied"]) for e in coord.retune_events] == [
        (2, True, True)]
    assert coord._retune_candidate == CHUNK2 and coord._client_chunk == 2
    ref = _mnist_coordinator(tmp_path, "reference")
    ref.run()
    np.testing.assert_allclose(ravel(coord.params).numpy(), ravel(ref.params).numpy(),
                               rtol=0, atol=1e-6)


def test_refused_swap_is_transactional(tmp_path):
    coord = _mnist_coordinator(tmp_path, "refused", retune_every=1)
    rt = coord.enable_retuning(_table(RPB1, CHUNK3), cache_dir=None, current=RPB1)
    rt.observe(RPB1, rounds=4, walltime_s=4.0)
    rt.observe(CHUNK3, rounds=4, walltime_s=0.4)
    coord.current_round = 1
    step, names = coord._round_step, coord.program_catalog.names()
    coord._maybe_retune()
    assert coord.retune_events[-1]["swap"] and not coord.retune_events[-1]["applied"]
    assert coord._round_step is step and coord._retune_candidate == RPB1
    assert coord.program_catalog.names() == names
    with pytest.raises(NanoFedError, match="does not divide"):
        coord._rebuild_round_programs(3, 1)
    assert coord._round_step is step


def test_retune_cadence_counts_from_the_last_verdict(tmp_path):
    coord = _mnist_coordinator(tmp_path, "cadence", retune_every=3, num_rounds=100)
    rt = coord.enable_retuning(_table(RPB1, CHUNK2), cache_dir=None, current=RPB1)
    for r, verdicts in ((1, 0), (2, 0), (3, 1), (5, 1), (6, 2)):
        coord.current_round = r
        coord._maybe_retune()
        assert len(rt.decisions) == verdicts
