"""The port's command line (``nanofed_tpu_torch.cli``, the ``nanofed-tpu-torch`` script)
on the CPU: ``run`` and ``bench`` give what the library calls give, ``profile`` (with
``--sweep``) and ``serve`` run through, ``--telemetry-dir`` writes each one's telemetry,
``metrics-summary`` and ``trace`` give what the JAX package's readers give, ``info``
runs nothing, every command that runs something defaults to the card and raises
without one, ``audit`` and ``run --strict`` (the analysis slice, the last whose
subcommand and flag this command line refused) run, and together they are the JAX
command line's subcommands and flags (read from its parser, which is built and never
run)."""

import argparse
import asyncio
import contextlib
import io
import json
import subprocess
import sys
import threading
import tomllib
from pathlib import Path

import pytest
import torch

from nanofed_tpu_torch import cli, run_experiment
from nanofed_tpu_torch.benchmarks import BENCHMARKS, run_benchmark

REPO = Path(__file__).resolve().parents[1]


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    return code, out.getvalue()


def _strip_times(summary):
    return {k: v for k, v in summary.items() if k not in ("round_durations_s",
                                                          "rounds_per_sec")}


def test_run_prints_what_run_experiment_returns(tmp_path):
    code, out = _main(["run", "--device", "cpu", "--model", "mlp", "--clients", "4",
                       "--rounds", "2", "--epochs", "1", "--batch-size", "16",
                       "--train-size", "96", "--participation", "0.5",
                       "--out-dir", str(tmp_path / "cli")])
    assert code == 0
    want = run_experiment(model="mlp", num_clients=4, num_rounds=2, local_epochs=1,
                          batch_size=16, train_size=96, participation=0.5,
                          out_dir=tmp_path / "lib", device="cpu")
    assert _strip_times(json.loads(out)) == json.loads(json.dumps(_strip_times(want)))


def test_run_calibrates_central_dp_like_the_jax_cli(tmp_path, capsys):
    code = cli.main(["run", "--device", "cpu", "--model", "linear", "--clients", "4",
                     "--rounds", "1", "--epochs", "1", "--batch-size", "8",
                     "--train-size", "32", "--dp-epsilon", "4", "--out-dir", str(tmp_path)])
    captured = capsys.readouterr()
    assert code == 0 and "# central DP: sigma=" in captured.err
    spent = json.loads(captured.out)["privacy_spent"]
    assert 0 < spent["epsilon_spent"] <= 4 and 0 < spent["delta_spent"] <= 1e-5


@pytest.mark.parametrize("argv,words", [
    (["--robust-trim", "1", "--dp-epsilon", "2"], "--robust-trim cannot be combined"),
    (["--scaffold", "--robust-method", "median"], "--scaffold cannot be combined"),
    (["--retune-every", "1"], "--retune-every requires --autotune"),
    (["--autotune", "--client-chunk", "2"], "--autotune cannot be combined with --client-chunk"),
])
def test_run_refuses_what_the_jax_cli_refuses(argv, words, capsys):
    assert cli.main(["run", "--device", "cpu", *argv]) == 2
    assert words in capsys.readouterr().err


def test_bench_prints_what_run_benchmark_returns(tmp_path):
    code, out = _main(["bench", "mnist_iid", "--device", "cpu", "--train-size", "160",
                       "--rounds", "1", "--out-dir", str(tmp_path / "cli")])
    assert code == 0
    got = json.loads(out)
    want = run_benchmark("mnist_iid", out_dir=str(tmp_path / "lib"), device="cpu",
                         train_size=160, num_rounds=1)
    assert got["benchmark"] == "mnist_iid" and got["model"] == "mnist_cnn"
    assert got["rounds_per_sec"] > 0
    assert _strip_times(got) == json.loads(json.dumps(_strip_times(want)))
    code, out = _main(["bench", "--list"])
    assert code == 0 and json.loads(out) == sorted(BENCHMARKS)


def test_profile_and_sweep_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the sweep's cache and table land here
    common = ["--device", "cpu", "--model", "linear", "--clients", "4", "--batch-size", "8",
              "--train-size", "64"]
    code, out = _main(["profile", *common, "--rounds-per-block", "2", "--json"])
    assert code == 0
    programs = [r["program"] for r in json.loads(out)]
    assert sorted(programs) == ["round_block", "round_step", "scaffold_round_step"]
    code, out = _main(["profile", *common, "--sweep", "--client-chunk", "2"])
    assert code == 0 and "ranked table written to" in out
    assert list((tmp_path / "runs").glob("autotune_*.json"))


def test_serve_runs_a_round_with_a_client(tmp_path):
    """``serve`` on a free port for one round, one port client submitting the global
    model plus a fixed delta: the round completes and its checkpointed aggregate is
    that model (a float32 weighted mean of one: 1e-6)."""
    from nanofed_tpu_torch.communication import HTTPClient
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.core.exceptions import NanoFedError
    from nanofed_tpu_torch.persistence import FileStateStore
    from nanofed_tpu_torch.utils.trees import from_checkpoint_params

    pytest.importorskip("aiohttp")
    port = free_port()
    result = {}

    def serve():
        result["code"], result["out"] = _main([
            "serve", "--device", "cpu", "--model", "linear", "--port", str(port),
            "--rounds", "1", "--timeout", "60", "--state-dir", str(tmp_path / "state")])

    thread = threading.Thread(target=serve)
    thread.start()

    async def client():
        async with HTTPClient(f"http://127.0.0.1:{port}", "c0", timeout_s=30) as c:
            for _ in range(500):
                try:
                    params, rnd, active = await c.fetch_global_model()
                    break
                except (NanoFedError, OSError):  # the server is still starting
                    await asyncio.sleep(0.02)
            assert active and rnd == 0
            result["sent"] = {k: v + 0.5 for k, v in params.items()}
            assert await c.submit_update(result["sent"], {"num_samples": 3})

    asyncio.run(client())
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert result["code"] == 0
    history = json.loads(result["out"])
    assert [h["status"] for h in history] == ["COMPLETED"]
    restored = FileStateStore(tmp_path / "state").restore_latest()
    assert restored.round_number == 0
    for name, leaf in from_checkpoint_params(restored.params, result["sent"]).items():
        torch.testing.assert_close(leaf, result["sent"][name], rtol=1e-6, atol=1e-6)


CHAOS_PLANS = [
    ["--clients", "8", "--rounds", "4", "--crash-fraction", "0.25", "--seed", "3"],
    ["--clients", "12", "--rounds", "6", "--straggler-fraction", "0.25", "--straggler-delay",
     "2", "--drop-fraction", "0.1", "--duplicate-fraction", "0.2", "--corrupt-fraction",
     "0.1", "--server-kill-round", "3"],
    ["--rounds", "6", "--hosts", "4", "--host-crashes", "1", "--host-stalls", "1",
     "--dcn-degrade-fraction", "0.5", "--dcn-delay", "0.25", "--seed", "9"],
]


@pytest.mark.parametrize("argv", CHAOS_PLANS)
def test_chaos_plan_writes_the_plan_the_jax_cli_writes(argv, tmp_path, capsys):
    from nanofed_tpu import cli as jax_cli

    assert jax_cli.main(["chaos-plan", *argv, "--out", str(tmp_path / "jax.json")]) == 0
    want_out = capsys.readouterr().out
    assert cli.main(["chaos-plan", *argv, "--out", str(tmp_path / "port.json")]) == 0
    got_out = capsys.readouterr().out
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert got_out.replace("port.json", "jax.json") == want_out
    assert cli.main(["chaos-plan", *argv]) == 0  # printed instead of saved
    assert capsys.readouterr().out.strip() == (tmp_path / "jax.json").read_text()


@pytest.mark.parametrize("argv,words", [
    ([], "the requested plan is empty"),
    (["--host-crashes", "1"], "host faults need hosts >= 1"),
    (["--hosts", "1", "--host-crashes", "2"], "cannot fail 2 of 1 hosts"),
])
def test_chaos_plan_exits_2_where_the_jax_cli_does(argv, words, capsys):
    from nanofed_tpu import cli as jax_cli

    assert jax_cli.main(["chaos-plan", *argv]) == 2
    want = capsys.readouterr().err
    assert cli.main(["chaos-plan", *argv]) == 2
    assert words in capsys.readouterr().err and words in want


def test_serve_exits_2_on_an_unreadable_chaos_plan(tmp_path, capsys):
    (tmp_path / "bad.json").write_text("{not json")
    for path in (tmp_path / "missing.json", tmp_path / "bad.json"):
        # Refused before a device is looked for, as the JAX command refuses it.
        assert cli.main(["serve", "--chaos-plan", str(path)]) == 2
        assert "could not load chaos plan" in capsys.readouterr().err


def test_serve_chaos_plan_server_kill_crashes_then_the_state_dir_resumes(tmp_path):
    """``serve --chaos-plan`` with a planned ``server_kill`` in round 1: round 0
    completes with one client, round 1's model is published, then the command prints
    the ``CRASHED`` record with its resume hint and exits 1.  The same ``--state-dir``
    then resumes at round 1 and completes it."""
    from nanofed_tpu.faults import FaultEvent, FaultPlan
    from nanofed_tpu_torch.communication import HTTPClient
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.core.exceptions import NanoFedError

    pytest.importorskip("aiohttp")
    # A plan the JAX package wrote: plans load across packages.
    FaultPlan(seed=4, events=(FaultEvent(kind="server_kill", round=1),)).save(
        tmp_path / "plan.json")
    state = tmp_path / "state"

    def serve_with_a_client(extra, killed_round=None):
        port = free_port()
        result = {}

        def serve():
            result["code"], result["out"] = _main([
                "serve", "--device", "cpu", "--model", "linear", "--port", str(port),
                "--rounds", "2", "--timeout", "60", "--state-dir", str(state), *extra])

        thread = threading.Thread(target=serve)
        thread.start()
        seen = []

        async def client():
            async with HTTPClient(f"http://127.0.0.1:{port}", "c0", timeout_s=30) as c:
                while thread.is_alive():
                    try:
                        params, rnd, active = await c.fetch_global_model()
                    except (NanoFedError, OSError):  # starting, or crashed and gone
                        await asyncio.sleep(0.02)
                        continue
                    if not active:
                        return
                    if rnd not in seen:
                        seen.append(rnd)
                        landed = await c.submit_update({k: v + 0.5 for k, v in params.items()},
                                                       {"num_samples": 3})
                        # The planned kill may land while this round's submit is on the
                        # wire; every other round's submit lands.
                        assert landed or rnd == killed_round
                    await asyncio.sleep(0.02)

        asyncio.run(asyncio.wait_for(client(), timeout=120))
        thread.join(timeout=60)
        assert not thread.is_alive()
        return result["code"], json.loads(result["out"]), seen

    code, out, seen = serve_with_a_client(["--chaos-plan", str(tmp_path / "plan.json")],
                                          killed_round=1)
    assert code == 1 and seen[0] == 0  # round 1 may crash before the client fetches it
    (crashed,) = out
    assert crashed["status"] == "CRASHED" and "mid-round 1" in crashed["error"]
    assert "same --state-dir" in crashed["resume"]
    code, history, seen = serve_with_a_client([])
    assert code == 0 and seen == [1]
    assert [(h["round"], h["status"]) for h in history] == [(1, "COMPLETED")]


@pytest.mark.parametrize("argv,words", [
    (["--secure", "--validate"], "--validate cannot be combined with --secure"),
    (["--dropout-tolerant"], "--dropout-tolerant requires --secure"),
    (["--async-buffer", "2", "--min-clients", "2"], "--min-clients only applies"),
    (["--staleness-window", "2"], "--staleness-window only applies with --async-buffer"),
    (["--ingest-capacity", "8"], "only apply with --ingest-batch"),
])
def test_serve_refuses_what_the_jax_cli_refuses(argv, words, capsys):
    assert cli.main(["serve", "--device", "cpu", *argv]) == 2
    assert words in capsys.readouterr().err


def test_info_reports_torch_and_the_cards_and_runs_nothing():
    code, out = _main(["info"])
    assert code == 0
    info = json.loads(out)
    assert info["torch"] == torch.__version__ and info["cuda"] == torch.version.cuda
    assert info["cuda_available"] == torch.cuda.is_available()
    assert len(info["devices"]) == (torch.cuda.device_count() if info["cuda_available"] else 0)
    assert {"resnet8", "resnet18", "mnist_cnn"} <= set(info["models"])


@pytest.mark.parametrize("argv", [
    ["run", "--train-size", "32"],
    ["bench", "mnist_iid", "--train-size", "64"],
    ["profile", "--model", "linear"],
    ["profile", "--model", "linear", "--sweep"],
    ["serve", "--model", "linear"],
    ["loadtest", "--clients", "4", "--virtual-clock"],
    ["tenants", "--clients", "4", "--virtual-clock"],
])
def test_commands_default_to_the_card_and_raise_without_it(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


@pytest.mark.parametrize("name,item", [
    ("audit", "item 21"),
])
def test_later_subcommands_are_listed_and_refused_with_their_item(name, item, capsys,
                                                                   monkeypatch, tmp_path):
    """The subcommand the analysis slice (ROADMAP ``item``) brings, once refused: it is
    listed, audits the catalog it is given (here one program, and one whose host read
    is a finding: exit 1), prints the JAX JSON shape and writes its telemetry."""
    from nanofed_tpu_torch.analysis import program_audit
    from nanofed_tpu_torch.observability import summarize_telemetry
    from nanofed_tpu_torch.observability.profiling import ProgramCatalog

    def catalog(device=None):
        cat = ProgramCatalog()
        cat.register("scale", lambda x: x * 2.0, args=(torch.ones(4, device=device),))
        return cat

    assert name in cli.build_parser().format_help()
    monkeypatch.setattr(program_audit, "reference_catalog", catalog)
    assert cli.main([name, "--device", "cpu", "--json", "--no-compile",
                     "--telemetry-dir", str(tmp_path)]) == 0
    (report,) = json.loads(capsys.readouterr().out)
    assert report["program"] == "scale" and report["ok"] and report["compiled"] is False
    assert report["checks"] == list(program_audit.AUDIT_CHECKS)
    audits = summarize_telemetry(tmp_path / "telemetry.jsonl")["audits"]
    assert audits["clean"] == 1 and audits["dirty"] == 0

    def dirty(device=None):
        cat = catalog(device)
        cat.register("reads", lambda x: x * float(x.sum()), args=(torch.ones(4),))
        return cat

    monkeypatch.setattr(program_audit, "reference_catalog", dirty)
    assert cli.main([name, "--device", "cpu"]) == 1
    assert "[host-transfer]" in capsys.readouterr().out


@pytest.mark.parametrize("cmd,argv,item", [
    ("run", ["--strict"], "item 21"),
])
def test_later_flags_are_refused_with_their_item(cmd, argv, item, tmp_path):
    """The flag the analysis slice (ROADMAP ``item``) brings, once refused: a strict run
    trains and its summary says so, as the JAX command's does."""
    code, out = _main([cmd, *argv, "--device", "cpu", "--model", "linear", "--clients",
                       "2", "--rounds", "1", "--train-size", "16", "--out-dir",
                       str(tmp_path)])
    summary = json.loads(out)
    assert code == 0 and summary["strict"] is True and summary["rounds_completed"] == 1


@pytest.mark.parametrize("cmd,argv,hosts,shards", [
    ("run", ["--model-shards", "2"], 1, 2),
    ("run", ["--hosts", "2"], 2, 1),
    ("run", ["--distributed", "--hosts", "2"], 2, 1),
    ("profile", ["--model-shards", "2"], 1, 2),
    ("profile", ["--hosts", "2"], 2, 1),
])
def test_mesh_flags_are_validated_against_the_world_as_jax_validates(cmd, argv, hosts,
                                                                     shards, capsys):
    """The mesh flags earlier slices refused: in one process (``--distributed``
    outside ``torchrun`` is the documented single-process no-op) the world has one
    rank, and a mesh of more fails with the JAX validator's message, exit code 2."""
    from nanofed_tpu.parallel.mesh import mesh_shape_for_topology as jax_validator

    with pytest.raises(ValueError) as want:
        jax_validator(hosts, shards, 1)
    assert cli.main([cmd, *argv, "--device", "cpu"]) == 2
    assert str(want.value) in capsys.readouterr().err


def test_mesh_flags_reach_the_runner(monkeypatch):
    from nanofed_tpu_torch import experiments

    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"ok": True}

    monkeypatch.setattr(experiments, "run_experiment", fake_run)
    assert cli.main(["run", "--distributed", "--model-shards", "1", "--hosts", "1",
                     "--device", "cpu"]) == 0
    assert (seen["model_shards"], seen["hosts"]) == (1, 1)


@pytest.mark.parametrize("cmd,argv,reaches", [
    ("run", ["--adapter-rank", "4"], {"adapter_rank": 4, "adapter_alpha": None}),
    ("run", ["--adapter-rank", "4", "--adapter-alpha", "2.0"],
     {"adapter_rank": 4, "adapter_alpha": 2.0}),
    ("profile", ["--adapter-rank", "4"], {"adapter": 4}),
])
def test_adapter_flags_reach_the_runner(cmd, argv, reaches, monkeypatch, capsys):
    """The adapter flags the earlier slices refused: ``run``'s reach
    ``run_experiment`` as the JAX command line passes them, and ``profile``'s builds
    an adapter coordinator (no SCAFFOLD program beside it)."""
    from nanofed_tpu_torch import experiments
    from nanofed_tpu_torch.orchestration import coordinator

    seen = {}
    if cmd == "run":
        def fake_run(**kw):
            seen.update(kw)
            return {"ok": True}

        monkeypatch.setattr(experiments, "run_experiment", fake_run)
        assert cli.main([cmd, *argv, "--device", "cpu"]) == 0
        assert {k: seen[k] for k in reaches} == reaches
        return
    built = []

    class Recorder(coordinator.Coordinator):
        def __init__(self, *a, **kw):
            built.append(kw.get("adapter"))
            super().__init__(*a, **kw)

        def profile_programs(self, force=False):
            return []

    monkeypatch.setattr(coordinator, "Coordinator", Recorder)
    monkeypatch.setattr("nanofed_tpu_torch.orchestration.Coordinator", Recorder)
    assert cli.main([cmd, "--model", "mlp", "--clients", "2", "--train-size", "128",
                     "--rounds-per-block", "1", "--device", "cpu", *argv]) == 1
    assert [a.rank for a in built] == [reaches["adapter"]]


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _jax_parser(monkeypatch):
    """The JAX command line's parser, caught at ``parse_args`` before anything runs."""
    from nanofed_tpu import cli as jax_cli

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught) as caught:
            jax_cli.main([])
    return caught.value.args[0]


def test_every_jax_subcommand_and_flag_is_ported_or_refused(monkeypatch):
    theirs, ours = _subparsers(_jax_parser(monkeypatch)), _subparsers(cli.build_parser())
    assert set(ours) == set(theirs) == set(cli.COMMANDS)  # nothing is refused any more
    assert not hasattr(cli, "LATER_SUBCOMMANDS") and not hasattr(cli, "LATER_SLICE_FLAGS")
    for cmd in cli.COMMANDS:
        jax_flags = set(theirs[cmd]._option_string_actions)
        our_flags = set(ours[cmd]._option_string_actions)
        # --device on every command that runs on a device.
        runs_nothing = cmd in ("info", "metrics-summary", "trace", "chaos-plan")
        assert our_flags - jax_flags == (set() if runs_nothing else {"--device"})
        assert jax_flags <= our_flags
    assert theirs["run"]._option_string_actions["--strict"].default is False
    assert ours["run"]._option_string_actions["--strict"].default is False


def test_later_flags_at_the_jax_default_are_accepted(tmp_path):
    code, out = _main(["run", "--device", "cpu", "--model", "linear", "--clients", "2",
                       "--rounds", "1", "--train-size", "16", "--model-shards", "1",
                       "--hosts", "1", "--out-dir", str(tmp_path)])
    assert code == 0 and json.loads(out)["rounds_completed"] == 1


def test_module_and_script_entry_points():
    proc = subprocess.run([sys.executable, "-m", "nanofed_tpu_torch.cli", "info"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "resnet18" in json.loads(proc.stdout)["models"]
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["nanofed-tpu-torch"] == "nanofed_tpu_torch.cli:main"
    module, attr = scripts["nanofed-tpu-torch"].split(":")
    assert getattr(sys.modules[module], attr) is cli.main


def test_platform_helpers(capsys):
    from nanofed_tpu_torch.utils.platform import deadline, log_stage

    log_stage("stage one", t0=0.0)
    assert "stage one" in capsys.readouterr().err
    with deadline("quick", 30.0):
        pass  # leaving the stage disarms the watchdog
    proc = subprocess.run(
        [sys.executable, "-c",
         "import time; from nanofed_tpu_torch.utils.platform import deadline\n"
         "with deadline('stuck', 0.2, error_json={'ok': False}):\n    time.sleep(30)"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 3 and "stage 'stuck' exceeded" in proc.stderr
    assert json.loads(proc.stdout) == {"ok": False, "error": "stuck timed out after 0s"}


# ---------------------------------------------------------------------------
# Telemetry on the command line: what the refused cases of the observability slice
# became.
# ---------------------------------------------------------------------------

TINY_RUN = ["--device", "cpu", "--model", "linear", "--clients", "2", "--rounds", "2",
            "--epochs", "1", "--batch-size", "8", "--train-size", "32"]


def _telemetry_records(directory):
    lines = (Path(directory) / "telemetry.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def test_run_writes_telemetry_where_telemetry_dir_points(tmp_path):
    code, _ = _main(["run", *TINY_RUN, "--out-dir", str(tmp_path / "out"),
                     "--telemetry-dir", str(tmp_path / "tel")])
    assert code == 0
    records = _telemetry_records(tmp_path / "tel")
    assert [r["status"] for r in records if r["type"] == "round"] == ["COMPLETED"] * 2
    assert records[0]["type"] == "topology" and records[-1]["type"] == "metrics_snapshot"
    assert {r["name"] for r in records if r["type"] == "span"} == {
        "round", "cohort-sample", "cohort-gather", "local-train", "aggregate", "publish"}
    assert not (tmp_path / "out" / "telemetry.jsonl").exists()


def test_metrics_summary_digests_a_run_like_the_jax_reader(tmp_path):
    from nanofed_tpu.observability import summarize_telemetry as jax_summarize

    assert _main(["run", *TINY_RUN, "--out-dir", str(tmp_path)])[0] == 0
    code, out = _main(["metrics-summary", str(tmp_path)])
    assert code == 0
    assert json.loads(out) == jax_summarize(tmp_path / "telemetry.jsonl")
    assert json.loads(out)["rounds"] == {"COMPLETED": 2}
    assert cli.main(["metrics-summary", str(tmp_path / "nothing")]) == 1


def test_trace_merges_the_streams_like_the_jax_reader(tmp_path):
    from nanofed_tpu.observability import federation_timeline as jax_timeline

    for host, skew in ((0, 0.0), (1, 0.25)):
        stream = tmp_path / f"host_{host}" / "telemetry.jsonl"
        stream.parent.mkdir()
        stream.write_text("".join(json.dumps(r) + "\n" for r in (
            {"type": "clock_sync", "host": host, "anchor_wall": 100.0 + skew},
            {"type": "round", "host": host, "round": 0, "status": "COMPLETED",
             "duration_s": 1.0, "start_wall": 100.5 + skew,
             "segments": {"wire_wait": 0.5, "apply": 0.5}, "traces": [f"{host:032x}"]},
        )))
    code, out = _main(["trace", str(tmp_path), "--chrome-out", str(tmp_path / "t.json")])
    assert code == 0
    assert json.loads(out) == jax_timeline(tmp_path)
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1}
    assert cli.main(["trace", str(tmp_path / "nothing")]) == 1


def test_profile_appends_program_profile_records_to_telemetry_dir(tmp_path):
    code, _ = _main(["profile", "--device", "cpu", "--model", "linear", "--clients", "4",
                     "--batch-size", "8", "--train-size", "64", "--rounds-per-block", "1",
                     "--telemetry-dir", str(tmp_path / "tel")])
    assert code == 0
    records = _telemetry_records(tmp_path / "tel")
    assert sorted(r["program"] for r in records if r["type"] == "program_profile") == [
        "round_step", "scaffold_round_step"]
    assert [r["attrs"]["program"] for r in records if r["type"] == "span"] == [
        "round_step", "scaffold_round_step"]
    assert [r["type"] for r in records].count("metrics_snapshot") == 2


def test_serve_writes_telemetry_and_serves_metrics(tmp_path):
    from nanofed_tpu_torch.communication import HTTPClient
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.core.exceptions import NanoFedError

    aiohttp = pytest.importorskip("aiohttp")
    port = free_port()
    result = {}

    def serve():
        result["code"], _ = _main([
            "serve", "--device", "cpu", "--model", "linear", "--port", str(port),
            "--rounds", "1", "--timeout", "60", "--telemetry-dir", str(tmp_path / "tel")])

    thread = threading.Thread(target=serve)
    thread.start()

    async def client():
        url = f"http://127.0.0.1:{port}"
        async with HTTPClient(url, "c0", timeout_s=30) as c:
            for _ in range(500):
                try:
                    params, rnd, active = await c.fetch_global_model()
                    break
                except (NanoFedError, OSError):  # the server is still starting
                    await asyncio.sleep(0.02)
            async with aiohttp.ClientSession() as session:
                async with session.get(f"{url}/metrics") as resp:
                    result["metrics"] = await resp.text()
            assert await c.submit_update(params, {"num_samples": 3})

    asyncio.run(client())
    thread.join(timeout=60)
    assert not thread.is_alive() and result["code"] == 0
    assert 'nanofed_bytes_sent_total{endpoint="model"}' in result["metrics"]
    records = _telemetry_records(tmp_path / "tel")
    assert [r["status"] for r in records if r["type"] == "round"] == ["COMPLETED"]
    assert [r["name"] for r in records if r["type"] == "span"] == [
        "publish", "cohort-sample", "aggregate", "round"]
    assert records[-1]["type"] == "metrics_snapshot"


def test_loadtest_exits_0_and_writes_an_artifact_that_parses(tmp_path):
    code, out = _main(["loadtest", "--device", "cpu", "--clients", "60", "--mode", "both",
                       "--async-buffer", "20", "--rate", "5000", "--virtual-clock",
                       "--out-dir", str(tmp_path), "--telemetry-dir", str(tmp_path)])
    assert code == 0
    artifact = json.loads(out)
    on_disk = json.loads(Path(artifact["artifact_path"]).read_text())
    assert on_disk["record_type"] == "loadtest" and set(on_disk["modes"]) == {
        "per-submit", "ingest"}
    assert all(r["failed_submits"] == 0 and r["clients"] == 60
               for r in on_disk["modes"].values())
    code, out = _main(["metrics-summary", str(tmp_path)])
    assert code == 0 and set(json.loads(out)["loadtests"]) == {"per-submit", "ingest"}


def test_tenants_exits_0_and_writes_an_artifact_that_parses(tmp_path):
    code, out = _main(["tenants", "--device", "cpu", "--tenants", "2", "--rounds", "2",
                       "--clients", "24", "--virtual-clock", "--no-sequential",
                       "--tag", "cli", "--out-dir", str(tmp_path)])
    assert code == 0
    on_disk = json.loads((tmp_path / "tenants_cli.json").read_text())
    assert on_disk["record_type"] == "tenants" and on_disk["chaos_tenant"] == "alpha"
    assert set(on_disk["tenants"]) == {"alpha", "bravo"}
    assert on_disk["isolation"]["zero_rounds_lost"]


def _canned(kind: str, breach: bool) -> dict:
    if kind == "loadtest":
        rec = {"failed_submits": 1 if breach else 0, "submit_latency_s": {"count": 5}}
        return {"modes": {"per-submit": rec, "ingest": dict(rec, failed_submits=0)}}
    return {"isolation": {"zero_rounds_lost": True, "zero_failed_submits": not breach}}


@pytest.mark.parametrize("kind,breach", [("loadtest", False), ("loadtest", True),
                                         ("tenants", False), ("tenants", True)])
def test_exit_codes_are_the_jax_cli_exit_codes(kind, breach, monkeypatch):
    """``loadtest`` exits 1 when a submit was lost outright, ``tenants`` when an
    untargeted tenant lost rounds or submits: each command of both packages given the
    same artifact."""
    import nanofed_tpu.loadgen as jax_loadgen
    import nanofed_tpu.service as jax_service
    from nanofed_tpu import cli as jax_cli

    import nanofed_tpu_torch.loadgen as port_loadgen
    import nanofed_tpu_torch.service as port_service

    fn = "run_loadtest_comparison" if kind == "loadtest" else "run_tenant_service"
    for mod in ((jax_loadgen, port_loadgen) if kind == "loadtest"
                else (jax_service, port_service)):
        monkeypatch.setattr(mod, fn, lambda **kw: _canned(kind, breach))
    argv = [kind, "--virtual-clock"]
    with contextlib.redirect_stdout(io.StringIO()):
        theirs = jax_cli.main(argv)
        ours = cli.main([*argv, "--device", "cpu"])
    assert ours == theirs == (1 if breach else 0)


def test_serve_max_inflight_reaches_the_server(monkeypatch):
    import nanofed_tpu_torch.communication as comm

    seen = {}

    class Stop(Exception):
        pass

    def fake_server(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(comm, "HTTPServer", fake_server)
    with pytest.raises(Stop):
        cli.main(["serve", "--device", "cpu", "--model", "linear", "--max-inflight", "8"])
    assert seen["max_inflight"] == 8
    seen.clear()
    with pytest.raises(Stop):
        cli.main(["serve", "--device", "cpu", "--model", "linear"])
    assert seen["max_inflight"] is None
