"""The port's command line (``nanofed_tpu_torch.cli``, the ``nanofed-tpu-torch`` script)
on the CPU: ``run`` and ``bench`` give what the library calls give, ``profile`` (with
``--sweep``) and ``serve`` run through, ``--telemetry-dir`` writes each one's telemetry,
``metrics-summary`` and ``trace`` give what the JAX package's readers give, ``info``
runs nothing, every command that runs something defaults to the card and raises
without one, and each subcommand and flag of a later slice is refused with its ROADMAP
item, and together they are the JAX command line's subcommands and flags (read from
its parser, which is built and never run)."""

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
])
def test_commands_default_to_the_card_and_raise_without_it(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


@pytest.mark.parametrize("name,item", [
    ("chaos-plan", "item 17"), ("audit", "item 21"), ("loadtest", "item 18"), ("tenants", "item 18"),
])
def test_later_subcommands_are_listed_and_refused_with_their_item(name, item, capsys):
    assert cli.main([name, "--seed", "3", "somewhere"]) == 2
    assert f"`{name}` is not supported" in (err := capsys.readouterr().err) and item in err
    assert name in cli.build_parser().format_help()


@pytest.mark.parametrize("cmd,argv,item", [
    ("run", ["--adapter-rank", "4"], "item 16"),
    ("run", ["--adapter-alpha", "2.0"], "item 16"),
    ("run", ["--model-shards", "2"], "item 9b"),
    ("run", ["--hosts", "2"], "item 9b"),
    ("run", ["--distributed"], "item 9b"),
    ("run", ["--strict"], "item 21"),
    ("profile", ["--adapter-rank", "4"], "item 16"),
    ("profile", ["--model-shards", "2"], "item 9b"),
    ("profile", ["--hosts", "2"], "item 9b"),
    ("serve", ["--chaos-plan", "plan.json"], "item 17"),
    ("serve", ["--max-inflight", "8"], "item 18"),
])
def test_later_flags_are_refused_with_their_item(cmd, argv, item, capsys):
    assert cli.main([cmd, *argv]) == 2  # refused before a device is looked for
    err = capsys.readouterr().err
    assert argv[0] in err and item in err


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
    assert set(ours) == set(theirs)
    assert set(theirs) - set(cli.COMMANDS) == set(cli.LATER_SUBCOMMANDS)
    for cmd in cli.COMMANDS:
        jax_flags = set(theirs[cmd]._option_string_actions)
        our_flags = set(ours[cmd]._option_string_actions)
        # --device on every command that runs on a device.
        runs_nothing = cmd in ("info", "metrics-summary", "trace")
        assert our_flags - jax_flags == (set() if runs_nothing else {"--device"})
        assert jax_flags <= our_flags
        refused = {flag for flag, *_ in cli.LATER_SLICE_FLAGS.get(cmd, {}).values()}
        assert refused <= jax_flags
        for dest, (flag, _, default, _) in cli.LATER_SLICE_FLAGS.get(cmd, {}).items():
            assert theirs[cmd]._option_string_actions[flag].default == default


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
