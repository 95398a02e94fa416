"""Strict mode and the program audit through the port's entry points, on the CPU:
``Coordinator(strict=True)`` (the contract checks and the audit at construction, the
sync guard around every round-step and block dispatch) trains bit for bit as
``strict=False`` does, single-step and fused, with and without cohorts; a drifted
program or a host read in the round fails construction, naming the leaf or the op and
line; a strict coordinator on a described mesh passes on every rank; ``audit_
programs()``, ``ProgramCatalog.audit/audit_all``, the CLI ``audit`` subcommand and
the runner's ``strict`` work, with their telemetry.  The JAX coordinator's own strict
mode fails under this host's jax, so it is no oracle here; the non-strict port run is
held against the JAX package elsewhere (``tests/test_torch_coordinator.py``,
``tests/test_torch_fused_rounds.py``)."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

from nanofed_tpu_torch import cli
from nanofed_tpu_torch.aggregation import RobustAggregationConfig, fedadam_strategy
from nanofed_tpu_torch.analysis import AUDIT_CHECKS, ContractViolation, strict_mode
from nanofed_tpu_torch.analysis import contracts as contracts_module
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability import summarize_telemetry
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.orchestration import coordinator as coordinator_module
from nanofed_tpu_torch.parallel import round_step as round_step_module
from nanofed_tpu_torch.parallel.mesh import Mesh
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.utils.trees import ravel

TRAINING = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.1)


@pytest.fixture(scope="module")
def population():
    return federate(synthetic_classification(256, 3, (8,), seed=0), num_clients=8,
                    batch_size=16)


def _coord(population, tmp_path, strict, rounds_per_block=1, **kw):
    cfg = {k: kw.pop(k) for k in ("participation_rate", "dropout_rate", "num_rounds")
           if k in kw}
    return Coordinator(
        get_model("mlp", in_features=8, hidden=16, num_classes=3), population,
        CoordinatorConfig(num_rounds=cfg.pop("num_rounds", 4), seed=3,
                          rounds_per_block=rounds_per_block, base_dir=tmp_path,
                          save_metrics=False, **cfg),
        training=TRAINING, device="cpu", strict=strict, **kw)


@pytest.mark.parametrize("rounds_per_block,participation", [(1, 1.0), (2, 1.0), (2, 0.5),
                                                            (1, 0.5)])
def test_strict_runs_bit_equal_to_plain(population, tmp_path, rounds_per_block,
                                        participation, monkeypatch):
    """The same run with and without strict mode: bit-equal params and server state
    (Adam's count rides on the device as a 0-d tensor), the same round metrics, and
    the guard entered once a dispatch (a round step, or a fused block)."""
    entered = []
    real = contracts_module.strict_mode

    @contextlib.contextmanager
    def counting(device=None):
        entered.append(str(device))
        with real(device):
            yield

    monkeypatch.setattr(contracts_module, "strict_mode", counting)
    kw = dict(rounds_per_block=rounds_per_block, participation_rate=participation,
              strategy=fedadam_strategy(0.05), client_chunk=2)
    strict = _coord(population, tmp_path / "s", True, **kw)
    plain = _coord(population, tmp_path / "p", False, **kw)
    s_rounds, p_rounds = strict.run(), plain.run()
    assert torch.equal(ravel(strict.params), ravel(plain.params))
    for key in ("mu", "nu", "count"):
        assert torch.equal(strict.server_state[key], plain.server_state[key])
    assert int(strict.server_state["count"]) == 4
    assert [m.agg_metrics for m in s_rounds] == [m.agg_metrics for m in p_rounds]
    assert entered == ["cpu"] * (4 // rounds_per_block)


@pytest.mark.cuda
def test_strict_mode_raises_on_a_read_of_the_card():
    """On a GPU: ``.item()``, ``bool()`` and a pageable copy to the card raise inside
    the guard; chip_smoke.py's phase (an3) runs the same with a kernel launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the sync guard acts only on the card")
    x = torch.ones(4, device="cuda")
    for read in (lambda: x.sum().item(), lambda: bool(x.sum()),
                 lambda: torch.ones(4).to("cuda")):
        with pytest.raises(RuntimeError), strict_mode():
            read()


def test_a_drifted_round_step_fails_construction_naming_the_leaf(population, tmp_path,
                                                                 monkeypatch):
    real = coordinator_module.build_round_step

    def drifting(*args, **kwargs):
        step = real(*args, **kwargs)

        def round_step(*a, **k):
            res = step(*a, **k)
            return res._replace(params={**res.params, "fc1/bias": res.params["fc1/bias"][:3]})
        return round_step

    monkeypatch.setattr(coordinator_module, "build_round_step", drifting)
    _coord(population, tmp_path / "plain", False)  # built, never checked
    with pytest.raises(ContractViolation, match=r"params/fc1/bias: output is "
                                                r"torch\.float32\(3,\) but the input leaf"):
        _coord(population, tmp_path / "strict", True)


def test_a_host_read_in_the_round_fails_strict_construction(population, tmp_path,
                                                           monkeypatch):
    """A robust estimator that sizes its rank window with the participant count read on
    the host: a strict coordinator refuses it at construction, naming the op and the
    line; a plain one runs it."""
    real = round_step_module.robust_aggregate

    def reading(config, x, participating, like):
        if int(participating.sum()) < 1:
            raise AssertionError("no participant")
        return real(config, x, participating, like)

    monkeypatch.setattr(round_step_module, "robust_aggregate", reading)
    with pytest.raises(ContractViolation,
                       match=r"_local_scalar_dense at tests/test_torch_strict\.py:\d+ "
                             r"\(reading\)"):
        _coord(population, tmp_path, True, robust=RobustAggregationConfig(trim_k=1))
    _coord(population, tmp_path, False, robust=RobustAggregationConfig(trim_k=1)).run()


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "multi_krum"])
def test_strict_robust_rounds_run_bit_equal_to_plain(population, tmp_path, method):
    """The robust estimators keep the participant count on the device, so a strict
    coordinator takes them: its contract check and audit pass, and it trains bit for
    bit as the plain one does."""
    robust = RobustAggregationConfig(trim_k=1, method=method)
    strict = _coord(population, tmp_path / "s", True, robust=robust, num_rounds=2,
                    participation_rate=0.75)
    plain = _coord(population, tmp_path / "p", False, robust=robust, num_rounds=2,
                   participation_rate=0.75)
    s_rounds, p_rounds = strict.run(), plain.run()
    assert torch.equal(ravel(strict.params), ravel(plain.params))
    assert [m.agg_metrics for m in s_rounds] == [m.agg_metrics for m in p_rounds]
    assert all(m.agg_metrics["robust_kept_clients"] > 0 for m in s_rounds)


@pytest.mark.parametrize("shape", [(2,), (2, 2), (2, 2, 1)])
def test_strict_construction_on_every_rank_of_a_described_mesh(population, tmp_path, shape):
    """Each rank's coordinator checks its own program and layout and audits it with its
    collectives recorded, with no world of ranks."""
    for rank in range(int(torch.tensor(shape).prod())):
        coord = _coord(population, tmp_path, True, rounds_per_block=2,
                       mesh=Mesh.describe(shape, rank), participation_rate=0.5)
        (step,) = [r for r in coord.audit_programs() if r.program == "round_step"]
        assert step.ok and "all_reduce@clients" in step.schedule


def test_audit_programs_reach_telemetry_and_the_summary(population, tmp_path):
    coord = _coord(population, tmp_path, False, rounds_per_block=2,
                   mesh=Mesh.describe((2,), 0), telemetry_dir=tmp_path)
    reports = coord.audit_programs()
    assert [r.program for r in reports] == ["round_block", "round_step"]
    assert all(r.ok and r.schedule and r.checks == AUDIT_CHECKS for r in reports)
    coord.telemetry.close()
    summary = summarize_telemetry(tmp_path / "telemetry.jsonl")
    assert summary["audits"]["clean"] == 2 and summary["audits"]["dirty"] == 0
    assert summary["audits"]["programs"]["round_step"]["mesh_axes"] == ["clients"]
    assert summary["phases"]["program-audit"]["count"] == 2


def test_the_catalog_audits_a_coordinators_programs(population, tmp_path):
    coord = _coord(population, tmp_path, False, rounds_per_block=2)
    catalog = coord.program_catalog
    one = catalog.audit("round_step", compile=False)
    assert one.ok and one.schedule == () and one.compiled is False
    assert one.attrs["step_clients"] == 8
    assert [r.program for r in catalog.audit_all()] == ["round_block", "round_step"]
    assert catalog.reports() == []  # auditing profiles nothing


def test_a_retuned_program_is_checked_before_its_first_dispatch(population, tmp_path,
                                                                 monkeypatch):
    coord = _coord(population, tmp_path, True)
    checked = []
    monkeypatch.setattr(coord, "_check_contracts", lambda: checked.append("contract"))
    monkeypatch.setattr(coord, "_audit_strict", lambda: checked.append("audit"))
    coord._rebuild_round_programs(4, 2)
    assert checked == ["contract", "audit"] and coord.config.rounds_per_block == 2


def test_cli_audit_prints_the_reference_catalog_as_json(capsys, tmp_path):
    assert cli.main(["audit", "--device", "cpu", "--json", "--telemetry-dir",
                     str(tmp_path)]) == 0
    reports = json.loads(capsys.readouterr().out)
    assert {r["program"] for r in reports} == {
        "single_step", "fused_block", "scaffold", "fsdp_2d", "hier_3axis", "adapter",
        "drained_ingest"}
    assert all(r["ok"] and r["ranks"] == 8 and r["schedule"] for r in reports)
    assert summarize_telemetry(tmp_path / "telemetry.jsonl")["audits"]["clean"] == 7


def test_run_strict_on_the_command_line_writes_its_telemetry(capsys, tmp_path):
    code = cli.main(["run", "--strict", "--device", "cpu", "--model", "mlp", "--clients",
                     "4", "--rounds", "2", "--rounds-per-block", "2", "--train-size", "64",
                     "--batch-size", "16", "--out-dir", str(tmp_path),
                     "--telemetry-dir", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out)
    assert code == 0 and summary["strict"] is True and summary["rounds_completed"] == 2
    assert summarize_telemetry(tmp_path / "telemetry.jsonl")["rounds"] == {"COMPLETED": 2}
