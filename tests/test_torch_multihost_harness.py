"""``scripts/multihost_harness_torch.py`` on the CPU: the launcher's units of
``tests/integration/test_multihost_harness.py`` against the port script (the
orphan-reaping contract of ``_wait``/``_reap``, the torn-tail progress reader), then
the modes end to end with gloo ranks on a tiny model: ``smoke`` (2 ranks against 1
within ``SMOKE_TOL``), ``bench`` (its artifact), a worker parked by a planned
``host_stall`` dying with its SIGKILLed supervisor (C4), and ``hostchaos`` for a planned
``host_crash`` (with a rejoin) and a ``host_stall`` (stall flagged after 3 s, watchdog
deadline 5 s), and ``federate`` (2 ranks as hosts under a 48-client swarm, every host's
final params against the numpy replay; then a planned kill of host 1 in round 1 under a
400-client swarm).  Each world's timeout is 120 s.  The six runs start together when the
module's first run is asked for, so the file's wall time is the longest drill's."""

import importlib.util
import json
import os
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from nanofed_tpu_torch.observability.telemetry import summarize_telemetry
from nanofed_tpu_torch.parallel.resilience import no_orphans

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "multihost_harness_torch.py"
COMMON = ["--device", "cpu", "--clients", "8", "--timeout", "120"]
DRILL = ["--rounds", "6", "--block-size", "2", "--watchdog-deadline", "5",
         "--stall-timeout", "3", "--compile-grace", "30"]
RUNS = {
    "smoke": ["smoke", *COMMON],
    "bench": ["bench", *COMMON, "--client-chunk", "2", "--rounds", "2"],
    "crash": ["hostchaos", *COMMON, *DRILL, "--host-fault", "crash", "--rejoin-rounds", "2"],
    "stall": ["hostchaos", *COMMON, *DRILL, "--host-fault", "stall", "--rejoin-rounds", "0"],
    # Short beats spread 48 wire clients over several rounds.
    "federate": ["federate", "--device", "cpu", "--clients", "48", "--timeout", "120",
                 "--round-timeout-s", "0.1", "--round-quota", "4", "--ingest-capacity", "64",
                 "--arrival-rate", "20"],
    # A population that outlasts round 1, where the plan kills host 1.
    "federate_kill": ["federate", "--device", "cpu", "--clients", "400", "--timeout", "120",
                      "--round-timeout-s", "0.2", "--round-quota", "4", "--ingest-capacity",
                      "512", "--arrival-rate", "20", "--kill-round", "1", "--reroute-grace",
                      "2", "--federate-watchdog", "30", "--block-size", "1"],
}


@pytest.fixture(scope="module")
def harness():
    spec = importlib.util.spec_from_file_location("multihost_harness_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mode started at once, each in its own directories; a run's result is
    read when a test asks for it."""
    base = tmp_path_factory.mktemp("harness")
    started = {}
    for name, argv in RUNS.items():
        d = base / name
        d.mkdir()
        log = (d / "log.txt").open("w")
        proc = subprocess.Popen(
            [sys.executable, str(SCRIPT), *argv, "--tmp-dir", str(d / "tmp"),
             "--out-dir", str(d / "out")],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        started[name] = (proc, d, log)
    yield started
    for proc, _, log in started.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        log.close()


def _finish(runs, name):
    proc, d, log = runs[name]
    rc = proc.wait(timeout=400)
    log.flush()
    text = (d / "log.txt").read_text()
    assert rc == 0, text[-4000:]
    return d, text


def _artifact(d: Path, pattern: str) -> dict:
    (path,) = sorted((d / "out").glob(pattern))
    return json.loads(path.read_text())


def _sleeper(seconds=60):
    return subprocess.Popen([sys.executable, "-c", f"import time; time.sleep({seconds})"])


def _crasher(rc=3, after_s=0.0):
    return subprocess.Popen([sys.executable, "-c",
                             f"import sys, time; time.sleep({after_s}); sys.exit({rc})"])


def test_wait_reaps_survivors_when_a_worker_crashes(harness):
    survivor, crasher = _sleeper(), _crasher(rc=3, after_s=0.2)
    procs = [survivor, crasher]
    with pytest.raises(SystemExit, match="rc=3"):
        harness._wait(procs, timeout_s=30.0)
    assert all(p.returncode is not None for p in procs)
    assert no_orphans([p.pid for p in procs]) == []


def test_wait_reaps_everyone_on_timeout(harness):
    procs = [_sleeper(), _sleeper()]
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="timed out"):
        harness._wait(procs, timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    assert all(p.returncode is not None for p in procs)
    assert no_orphans([p.pid for p in procs]) == []


def test_wait_returns_when_all_exit_cleanly(harness):
    procs = [_crasher(rc=0), _crasher(rc=0)]
    harness._wait(procs, timeout_s=30.0)
    assert [p.returncode for p in procs] == [0, 0]


def test_reap_escalates_sigterm_to_sigkill(harness):
    stubborn = subprocess.Popen([sys.executable, "-c",
                                 "import signal, time; "
                                 "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                                 "time.sleep(60)"])
    time.sleep(0.3)  # let the handler install
    harness._reap([stubborn], grace_s=0.5)
    assert stubborn.returncode is not None
    assert no_orphans([stubborn.pid]) == []


# A supervisor that starts one hostchaos worker through the harness's own spawn path
# under a plan that stalls host 0 in round 0, prints the worker's pid once the worker
# is ready (it parks right after), and then waits to be killed.
STALLED_WORKER_SUPERVISOR = r"""
import argparse, importlib.util, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("harness", sys.argv[1])
h = importlib.util.module_from_spec(spec)
spec.loader.exec_module(h)
from nanofed_tpu_torch.faults.plan import FaultEvent, FaultPlan
tmp = Path(sys.argv[2])
plan = tmp / "plan.json"
FaultPlan(seed=0, events=(FaultEvent(kind="host_stall", round=0, host=0),)).save(plan)
args = argparse.Namespace(clients=2, capacity=8, batch_size=8, rounds=2, model="digits_mlp",
                          seed=0, client_chunk=None, block_size=2, watchdog_deadline=5.0,
                          compile_grace=30.0, tmp_dir=str(tmp), device="cpu", timeout=60.0)
progress = tmp / "progress.jsonl"
(worker,) = h._spawn_hostchaos(args, [0], rounds=2, hb_dir=h._fresh_dir(tmp / "hb"),
                               ckpt_dir=h._fresh_dir(tmp / "ckpt"), resume=False,
                               plan_path=plan, out=None, progress=progress)
while not any(r.get("event") == "ready" for r in h._read_progress(progress)):
    if worker.poll() is not None:
        sys.exit(f"worker exited rc={worker.returncode}")
    time.sleep(0.1)
print(worker.pid, flush=True)
time.sleep(600)
"""


def _gone(pid: int) -> bool:
    """No such process, or a zombie (dead, its exit status not yet collected)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z"
    except (FileNotFoundError, ProcessLookupError):
        return True


def test_a_stalled_worker_dies_with_its_sigkilled_supervisor(tmp_path):
    """C4: a supervisor killed by SIGKILL runs no ``finally`` and reaps nothing, so its
    worker, parked by a planned ``host_stall``, must go by itself: gone within 10 s."""
    supervisor = subprocess.Popen(
        [sys.executable, "-c", STALLED_WORKER_SUPERVISOR, str(SCRIPT), str(tmp_path)],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    worker = None
    try:
        ready, _, _ = select.select([supervisor.stdout], [], [], 25.0)
        assert ready, "the worker did not report ready within 25 s"
        worker = int(supervisor.stdout.readline())
        os.kill(supervisor.pid, signal.SIGKILL)
        supervisor.wait(timeout=10)
        deadline = time.monotonic() + 10.0
        while not _gone(worker) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(worker), f"worker {worker} outlived its SIGKILLed supervisor by 10 s"
    finally:
        if supervisor.poll() is None:
            supervisor.kill()
            supervisor.wait(timeout=10)
        if worker is not None and not _gone(worker):
            os.kill(worker, signal.SIGKILL)


def test_read_progress_skips_torn_tail(harness, tmp_path):
    p = tmp_path / "progress.jsonl"
    p.write_text(json.dumps({"round": 0, "loss": 2.0, "wall_t": 1.0}) + "\n"
                 + json.dumps({"round": 1, "loss": 1.9, "wall_t": 2.0}) + "\n"
                 + '{"round": 2, "los')  # killed mid-write
    assert [r["round"] for r in harness._read_progress(p)] == [0, 1]
    assert harness._read_progress(tmp_path / "missing.jsonl") == []


def test_each_world_gets_a_fresh_absolute_rendezvous(harness, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    a, b = harness._rendezvous(Path("rel")), harness._rendezvous(Path("rel"))
    assert a.is_absolute() and a.parent == tmp_path / "rel" / "rendezvous"
    assert a != b and not a.exists()


def test_client_rows_are_the_jax_harness_draws(harness):
    spec = importlib.util.spec_from_file_location(
        "multihost_harness", REPO / "scripts" / "multihost_harness.py")
    jax_harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_harness)
    for got, want in zip(harness.client_rows(range(3, 7), 8, (8, 8, 1), 5),
                         jax_harness.client_rows(range(3, 7), 8, (8, 8, 1), 5)):
        assert got.dtype == want.dtype and (got == want).all()


def test_federate_two_ranks_match_the_einsum_oracle(runs):
    """Two gloo ranks as hosts, each a listener and an ingest buffer, one all-reduce a
    round: every host ends on the numpy replay of the drained rounds within
    ``FEDERATE_TOL``, the same bits on both, and no submit is lost."""
    d, text = _finish(runs, "federate")
    art = _artifact(d, "federation_torch_*.json")
    oracle = art["oracle"]
    assert len(oracle["max_abs_gap_by_host"]) == 2 and oracle["hosts_bit_equal"]
    assert max(oracle["max_abs_gap_by_host"]) <= oracle["tolerance"] == 1e-5
    assert art["zero_lost_submits"] and art["wire"]["failed"] == 0
    assert art["wire"]["accepted"] + art["wire"]["duplicates"] >= 48
    assert art["rounds"]["updates_aggregated"] == 48
    assert art["rounds"]["drained_rounds"] >= 2 and art["orphans"] == []
    assert art["topology"]["mesh_shape"] == [2, 1, 1] and art["platform"] == "cpu"
    assert art["trace_resolution"]["resolved"]
    assert "federate OK" in text
    digest = summarize_telemetry(d / "tmp" / "fed_telemetry" / "telemetry.jsonl")
    assert digest["federations"]["count"] == 1
    assert digest["federations"]["zero_lost_submits"]


def test_federate_kill_reroutes_reforms_and_loses_nothing(runs):
    """A planned ``host_crash`` of host 1 in round 1: its clients reroute to host 0 live,
    the world re-forms over host 0 from the newest generation both committed, the dead
    host's clients are re-driven, no submit is lost, and host 0 ends on the replay of
    the rounds kept."""
    d, text = _finish(runs, "federate_kill")
    art = _artifact(d, "federation_torch_*.json")
    chaos = art["chaos"]
    assert chaos["victim"] == 1 and chaos["kill_round"] == 1 and chaos["hosts_after"] == 1
    assert chaos["resumed_round"] <= 1 and chaos["recovery_s"] > 0
    assert art["topology"]["survivors"] == [0]
    assert art["zero_lost_submits"] and art["wire"]["failed"] == 0
    assert art["wire"]["reroutes"] > 0 and art["wire"]["rerouted_updates_drained"] > 0
    assert max(art["oracle"]["max_abs_gap_by_host"]) <= art["oracle"]["tolerance"]
    assert art["orphans"] == [] and "federate OK" in text
    telemetry = d / "tmp" / "fed_telemetry"
    assert len(list(telemetry.glob("host_*/telemetry.jsonl"))) == 2
    digest = summarize_telemetry(telemetry / "telemetry.jsonl")
    assert digest["host_failures"]["by_kind"] == {"host_crash": 1}
    assert digest["recoveries"]["count"] == 1


def test_federate_oracle_sees_a_changed_weight_or_a_lost_round(runs, harness):
    """The replay is sensitive to what it checks: the busiest round's drains with one
    weight scaled 100 times, or without that round (a round a kill lost), miss the hosts'
    params."""
    import numpy as np

    d, _ = _finish(runs, "federate")
    progress = [line for h in (0, 1)
                for line in harness._read_progress(d / "tmp" / f"fed_progress_a_h{h}.jsonl")]
    swarms = {f"h{h}": dict(num_clients=24, arrival="uniform", arrival_rate=20.0,
                            seed=17 * h, client_prefix=f"h{h}", connector_limit=256,
                            canned_payloads=4) for h in (0, 1)}
    final = np.load(d / "tmp" / "fed_result_a_h0.json.params.npy").astype(np.float64)
    want = harness.federate_oracle("digits_mlp", 0, swarms, progress)
    assert np.abs(want - final).max() <= harness.FEDERATE_TOL
    busiest = max(progress, key=lambda line: len(line["drains"]))
    busiest["drains"][0][2] *= 100.0
    assert np.abs(harness.federate_oracle("digits_mlp", 0, swarms, progress)
                  - final).max() > harness.FEDERATE_TOL
    busiest["drains"][0][2] /= 100.0
    kept = [line for line in progress if line["round"] != busiest["round"]]
    assert np.abs(harness.federate_oracle("digits_mlp", 0, swarms, kept)
                  - final).max() > harness.FEDERATE_TOL


def test_smoke_two_ranks_match_one(runs, harness):
    d, text = _finish(runs, "smoke")
    verdict = json.loads(text[text.index("{\n"):text.index("\n}\n") + 2])
    assert verdict["topology"]["process_count"] == 2
    assert verdict["topology"]["mesh_shape"] == [2, 1, 1]
    assert len(verdict["losses_multi"]) == 4  # a warm-up round and three timed
    assert verdict["max_loss_delta"] <= harness.SMOKE_TOL
    assert verdict["max_param_delta"] <= harness.SMOKE_TOL
    assert "multihost-smoke OK" in text


def test_bench_writes_its_artifact(runs):
    d, _ = _finish(runs, "bench")
    record = _artifact(d, "multihost_torch_*_8clients.json")
    assert record["num_clients"] == 8 and record["client_chunk"] == 2
    assert len(record["per_round_s"]) == 2 and record["rounds_per_sec"] > 0
    assert record["platform"] == "cpu" and record["topology"]["mesh_shape"] == [2, 1, 1]
    assert "not a round across several cards" in record["basis"]


def _check_drill(d: Path, kind: str) -> dict:
    art = _artifact(d, "hostchaos_torch_*_2h.json")
    assert art["failure"]["kind"] == kind
    victim = art["failure"]["host"]
    (event,) = art["plan"]["events"]
    assert event["kind"] == kind and event["host"] == victim
    assert art["recovery"]["rounds_lost"] <= art["block_size"]
    assert art["recovery"]["resumed_round"] % art["block_size"] == 0
    assert art["recovered"]["rounds"][-1] == art["rounds"] - 1
    assert art["recovered"]["rounds"][0] == art["recovery"]["resumed_round"]
    assert art["parity"]["ok"] and art["parity"]["max_loss_delta"] <= art["parity"]["tolerance"]
    assert art["orphans"] == []
    assert 0 < art["recovery"]["startup_s"] < art["recovery"]["recovery_s"]
    assert {"reap", "respawn", "bring_up", "first_round"} <= set(art["recovery"]["phases"])
    digest = summarize_telemetry(d / "tmp" / "telemetry" / "telemetry.jsonl")
    assert digest["host_failures"]["by_kind"] == {kind: 1}
    return {"artifact": art, "digest": digest}


def test_hostchaos_recovers_from_a_crash_and_the_host_rejoins(runs):
    d, text = _finish(runs, "crash")
    out = _check_drill(d, "host_crash")
    art = out["artifact"]
    victim = art["failure"]["host"]
    assert art["failure"]["worker_exit_codes"][str(victim)] == 31
    assert art["recovery"]["at_most_one_block"]
    assert art["rejoin"]["rounds"][-1] == art["rounds"] + 1  # two rounds past the run
    assert art["rejoin"]["hosts"] == [0, 1]
    assert out["digest"]["recoveries"]["count"] == 2  # the shrink and the regrow
    assert "hostchaos OK: host_crash" in text


def test_hostchaos_recovers_from_a_stall(runs):
    d, text = _finish(runs, "stall")
    out = _check_drill(d, "host_stall")
    art = out["artifact"]
    # Flagged once the heartbeat froze past the stall timeout, before the survivor's
    # watchdog deadline (the survivor keeps beating while it waits).
    assert 3.0 <= art["failure"]["detection_s"] < 3.0 + 5.0
    assert art["rejoin"] is None
    assert out["digest"]["recoveries"]["count"] == 1
    assert "hostchaos OK: host_stall" in text
