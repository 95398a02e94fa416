"""The port's run telemetry (``RunTelemetry``, ``summarize_telemetry``, the build-event
bridge) and the telemetry both coordinators write, against the JAX package's, on the
CPU.

* Files: a port-written ``telemetry.jsonl`` and a JAX-written one are each digested
  identically by both packages' ``summarize_telemetry`` (exact equality).
* The simulated coordinator: the same 4-client run (narrow ``mlp``, a 3-client cohort,
  2 single rounds, then one ``rounds_per_block=2`` block) gives the same span
  sequence, nesting and attributes and ``round``/``topology`` records with the same
  fields as the JAX Coordinator's, times removed.
* The network coordinator: a 2-round localhost federation of 4 port clients against
  each package's server gives the same ``/metrics`` families, update counts and byte
  counts (exact), and each package's trace header lands in exactly one
  ``submit-decode`` span on the other's server.
"""

import pytest

import asyncio
import json
import re
import threading

import jax
import numpy as np

import nanofed_tpu.observability as jax_obs
import nanofed_tpu_torch.observability as obs
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability import telemetry as port_telemetry
from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.trainer import TrainingConfig

MLP = dict(in_features=16, hidden=32, num_classes=4)
COORD = dict(num_rounds=2, participation_rate=0.75, seed=3)


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _write_every_record_type(pkg, run_dir):
    """A stream holding every record type ``summarize_telemetry`` digests, spans
    from the package's tracer included, closed with its registry snapshot."""
    reg = pkg.MetricsRegistry()
    reg.counter("nanofed_rounds_total", "rounds", labels=("status",)).inc(status="completed")
    reg.counter("nanofed_bytes_received_total", "rx", labels=("endpoint",)).inc(
        123, endpoint="update")
    tel = pkg.RunTelemetry(run_dir, registry=reg, annotate_device=False)
    with tel.span("round", round=0):
        with tel.span("local-train", round=0):
            pass
    fixed = [
        ("topology", dict(process_count=1, hosts=1, mesh_shape=[1], devices=1,
                          num_clients=4)),
        ("round", dict(round=0, status="COMPLETED", num_clients=4, duration_s=0.5,
                       segments={"wire_wait": 0.25, "apply": 0.125})),
        ("round", dict(round=1, status="FAILED", num_clients=1, duration_s=0.25)),
        ("program_profile", dict(program="round_step", rounds=1, flops=10.0,
                                 verdict="memory-bound", compile_seconds=0.5)),
        ("autotune", dict(cache_key="ab" * 16, winner={"client_chunk": 2}, compiles=3,
                          cache_hit=False, best_score=0.25)),
        ("audit", dict(program="round_step", ok=True, findings=[])),
        ("host_failure", dict(kind="host_crash", host=1, round=2)),
        ("recovery", dict(recovery_s=2.5, mttr_phases={"reap": 0.5})),
        ("clock_sync", dict(host=0, anchor_wall=1000.0, process_id=0)),
        ("clock_sync", dict(host=1, anchor_wall=1000.5, process_id=1)),
        ("tenant", dict(tenant="a", rounds_completed=2, p99_s=0.125)),
        ("fleet", dict(profile="mixed", tiers=["a"], accepted_total=3)),
        ("adapter", dict(rank=4, merges=1)),
        ("federation", dict(wire_clients=8, hosts=2, zero_lost_submits=True)),
        ("compile", dict(program="cand_a", seconds=1.25, cache_key="ab" * 8)),
        ("compile", dict(program="cand_b", seconds=0.75, cache_key="ab" * 8)),
        ("retune", dict(round=2, swap=True, applied=False, delta=0.1, basis="measured")),
        ("retune_summary", dict(decisions=1, swaps=1, hysteresis=0.05, measured={})),
        ("loadtest", dict(mode="sync", clients=8, p50_s=0.01, p99_s=0.02)),
    ]
    for record_type, fields in fixed:
        tel.record(record_type, **fields)
    tel.close()
    tel.record("round", round=9)  # after close: a silent no-op
    with (run_dir / pkg.TELEMETRY_FILENAME).open("a") as f:
        f.write('{"type": "round", "torn')  # a crashed writer's tail
    return run_dir / pkg.TELEMETRY_FILENAME


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_both_summaries_digest_a_file_the_same(tmp_path, writer):
    path = _write_every_record_type({"port": obs, "jax": jax_obs}[writer], tmp_path)
    got, want = obs.summarize_telemetry(path), jax_obs.summarize_telemetry(path)
    assert got == want
    assert got["malformed_lines"] == 1 and got["rounds"] == {"COMPLETED": 1, "FAILED": 1}
    assert set(got) >= {"phases", "critical_path", "clock_sync", "program_profiles",
                        "autotunes", "audits", "tenants", "fleets", "federations",
                        "host_failures", "recoveries", "compiles", "retunes",
                        "loadtests", "adapter", "topology", "counters"}


def test_the_two_writers_write_the_same_records(tmp_path):
    def lines(pkg, sub):
        path = _write_every_record_type(pkg, tmp_path / sub)
        return [json.loads(x) for x in path.read_text().splitlines()[:-1]]  # not the torn tail

    def strip(r):
        if r["type"] == "metrics_snapshot":
            return sorted(r["metrics"])  # span sums are times
        drop = {"t", "start_unix", "duration_s"} if r["type"] == "span" else {"t"}
        return {k: v for k, v in r.items() if k not in drop}

    assert [strip(r) for r in lines(obs, "port")] == [strip(r) for r in lines(jax_obs, "jax")]


def test_find_latest_telemetry_like_jax(tmp_path):
    for sub in ("a", "b/c"):
        obs.RunTelemetry(tmp_path / sub, annotate_device=False).close()
    for root in (tmp_path, tmp_path / "a", tmp_path / "a" / obs.TELEMETRY_FILENAME):
        assert obs.find_latest_telemetry(root) == jax_obs.find_latest_telemetry(root)
    assert obs.find_latest_telemetry(tmp_path / "missing") is None


def test_concurrent_writers_never_interleave_a_line(tmp_path):
    sinks = [obs.RunTelemetry(tmp_path, registry=obs.MetricsRegistry(),
                              annotate_device=False) for _ in range(4)]
    payload = "x" * 20_000  # above any stdio buffer: one os.write per record

    def write(i, tel):
        for j in range(50):
            tel.record("round", writer=i, seq=j, blob=payload)

    threads = [threading.Thread(target=write, args=(i, t)) for i, t in enumerate(sinks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tel in sinks:
        tel.close()
    records = _records(tmp_path / obs.TELEMETRY_FILENAME)
    rounds = [r for r in records if r["type"] == "round"]
    assert len(rounds) == 200 and all(r["blob"] == payload for r in rounds)
    assert sorted((r["writer"], r["seq"]) for r in rounds) == [
        (i, j) for i in range(4) for j in range(50)]
    assert sum(r["type"] == "metrics_snapshot" for r in records) == 4


def test_telemetry_in_an_unwritable_place_raises(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file")
    with pytest.raises(OSError):
        obs.RunTelemetry(blocker / "run")
    model = get_model("mlp", **MLP)
    data = federate(synthetic_classification(64, 4, (16,), seed=0), 4, batch_size=8)
    with pytest.raises(OSError):
        Coordinator(model, data, CoordinatorConfig(base_dir=tmp_path, save_metrics=False),
                    device="cpu", telemetry_dir=blocker)


def test_the_build_bridge_publishes_torch_families():
    reg = obs.get_registry()
    assert obs.install_torch_event_bridge() is True
    assert obs.install_torch_event_bridge(obs.MetricsRegistry()) is True  # idempotent
    events = reg.counter(port_telemetry.TORCH_EVENTS_TOTAL, labels=("event",))
    durations = reg.histogram(port_telemetry.TORCH_EVENT_DURATIONS, labels=("event",))
    hits = events.value(event=_build.BUILD_HIT_EVENT)
    misses = events.value(event=_build.BUILD_MISS_EVENT)
    seconds = durations.sample_sum(event=_build.BUILD_SECONDS_EVENT)
    _build._emit(_build.BUILD_HIT_EVENT, name="reduce")
    _build._emit(_build.BUILD_MISS_EVENT, name="quantize", seconds=2.5)
    assert events.value(event=_build.BUILD_HIT_EVENT) == hits + 1
    assert events.value(event=_build.BUILD_MISS_EVENT) == misses + 1
    assert durations.sample_sum(event=_build.BUILD_SECONDS_EVENT) == seconds + 2.5
    text = reg.render_prometheus()
    assert "nanofed_torch_events_total" in text and "nanofed_jax_" not in text
    # The stated difference is in the docstring, family names and all.
    doc = port_telemetry.__doc__
    assert "nanofed_torch_events_total" in doc and "nanofed_torch_event_duration_seconds" in doc


def _port_coordinator(tmp_path, rounds_per_block):
    return Coordinator(
        model=get_model("mlp", **MLP),
        train_data=federate(synthetic_classification(128, 4, (16,), seed=0), 4,
                            batch_size=8),
        config=CoordinatorConfig(base_dir=tmp_path / "port_runs",
                                 rounds_per_block=rounds_per_block, **COORD),
        training=TrainingConfig(batch_size=8, local_epochs=1, learning_rate=0.1),
        device="cpu", telemetry_dir=tmp_path / "port",
    )


def _jax_coordinator(tmp_path, rounds_per_block):
    return JaxCoordinator(
        model=jax_get_model("mlp", **MLP),
        train_data=jax_federate(jax_synthetic(128, 4, (16,), seed=0), 4, batch_size=8),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax_runs",
                                    rounds_per_block=rounds_per_block, **COORD),
        training=JaxTrainingConfig(batch_size=8, local_epochs=1, learning_rate=0.1),
        telemetry_dir=tmp_path / "jax",
    )


def _timeless(records):
    """Every record without its times; spans as (name, depth, parent name, attrs)."""
    names = {r["span_id"]: r["name"] for r in records if r["type"] == "span"}
    out = []
    for r in records:
        if r["type"] == "span":
            parent = names.get(r["parent_id"]) if r["parent_id"] is not None else None
            out.append(("span", r["name"], r["depth"], parent, r.get("attrs")))
        elif r["type"] in ("metrics_snapshot", "topology"):
            # The geometry differs: the port runs on one device, the JAX tests on a
            # virtual 8-device CPU mesh.
            out.append((r["type"], sorted(r)))
        else:
            out.append((r["type"], {k: v for k, v in r.items()
                                    if k not in ("t", "duration_s")}, sorted(r)))
    return out


@pytest.mark.parametrize("rounds_per_block", [1, 2], ids=["single", "block"])
def test_the_coordinator_writes_the_jax_spans_and_records(tmp_path, rounds_per_block):
    port = _port_coordinator(tmp_path, rounds_per_block)
    ref = _jax_coordinator(tmp_path, rounds_per_block)
    assert [m.num_clients for m in port.run()] == [m.num_clients for m in ref.run()]
    got = _records(tmp_path / "port" / obs.TELEMETRY_FILENAME)
    want = _records(tmp_path / "jax" / obs.TELEMETRY_FILENAME)
    assert _timeless(got) == _timeless(want)
    assert obs.summarize_telemetry(tmp_path / "port" / obs.TELEMETRY_FILENAME).keys() == \
        jax_obs.summarize_telemetry(tmp_path / "jax" / obs.TELEMETRY_FILENAME).keys()
    spans = [r["name"] for r in got if r["type"] == "span"]
    if rounds_per_block == 1:
        assert spans == ["cohort-sample", "cohort-gather", "local-train", "aggregate",
                         "round", "publish"] * 2
    else:
        assert spans == ["cohort-sample", "dispatch", "host_sync", "publish", "publish"]


def test_occupancy_reaches_the_retuner_and_the_gauge(tmp_path):
    coord = _port_coordinator(tmp_path, 1)
    seen = []

    class Retuner:
        def observe(self, candidate, rounds, walltime_s, occupancy=None):
            seen.append(occupancy)

        def write_back(self):
            return None

        def summary(self):
            return {"decisions": 0}

    coord.retuner, coord._retune_candidate = Retuner(), object()
    coord.run()
    assert len(seen) == 2 and all(0.0 < o <= 1.0 for o in seen)
    gauge = obs.get_registry().gauge(obs.profiling.DEVICE_OCCUPANCY_GAUGE)
    assert gauge.value() == pytest.approx(seen[-1])


def test_the_coordinator_publishes_its_round_instruments_on_the_process_registry(tmp_path):
    coord = _port_coordinator(tmp_path, 1)
    before = obs.get_registry().counter(
        "nanofed_rounds_total", labels=("status",)).value(status="completed")
    coord.run()
    reg = obs.get_registry()
    assert coord._registry is reg and coord.telemetry.registry is reg
    assert reg.counter("nanofed_rounds_total", labels=("status",)).value(
        status="completed") == before + 2
    assert reg.gauge("nanofed_cohort_size").value() == 3
    snapshot = _records(tmp_path / "port" / obs.TELEMETRY_FILENAME)[-1]
    assert snapshot["type"] == "metrics_snapshot"
    assert "nanofed_span_duration_seconds" in snapshot["metrics"]


# ---------------------------------------------------------------------------
# The network coordinator over localhost: /metrics and trace headers.
# ---------------------------------------------------------------------------

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")

import aiohttp  # noqa: E402

import nanofed_tpu.communication as jax_comm  # noqa: E402
import nanofed_tpu_torch.communication as port_comm  # noqa: E402
from nanofed_tpu_torch.communication.transport import free_port  # noqa: E402
from nanofed_tpu_torch.utils.trees import from_numpy_params  # noqa: E402

CLIENTS = ("c0", "c1", "c2", "c3")
NET_ROUNDS = 2


def _nested(seed, scale=1.0):
    model = jax_get_model("linear", in_features=6, num_classes=3)
    return jax.tree.map(lambda a: np.asarray(a) * np.float32(scale),
                        model.init(jax.random.key(seed)))


INIT = _nested(0)
DELTAS = {cid: _nested(10 + i, scale=0.1) for i, cid in enumerate(CLIENTS)}
SERVERS = {
    "port": dict(comm=port_comm, registry=obs.MetricsRegistry, tracer=obs.SpanTracer,
                 params=lambda: from_numpy_params(INIT, device="cpu"),
                 coordinator={"device": "cpu"}),
    "jax": dict(comm=jax_comm, registry=jax_obs.MetricsRegistry, tracer=jax_obs.SpanTracer,
                params=lambda: jax.tree.map(jax.numpy.asarray, INIT), coordinator={}),
}
CLIENT_PKGS = {
    "port": dict(comm=port_comm, registry=obs.MetricsRegistry,
                 params=lambda nested: from_numpy_params(nested, device="cpu"),
                 add=lambda p, d: {k: v + from_numpy_params(d, device="cpu")[k]
                                   for k, v in p.items()}),
    "jax": dict(comm=jax_comm, registry=jax_obs.MetricsRegistry,
                params=lambda nested: jax.tree.map(jax.numpy.asarray, nested),
                add=lambda p, d: jax.tree.map(lambda a, b: np.asarray(a, np.float32) + b,
                                              p, d)),
}


async def _client(pkg, url, cid, registry):
    template = pkg["params"](INIT)
    async with pkg["comm"].HTTPClient(url, cid, timeout_s=30, registry=registry) as client:
        while True:
            for _ in range(400):
                try:
                    params, rnd, active = await client.fetch_global_model(like=template)
                    break
                except Exception:
                    await asyncio.sleep(0.02)
            if not active:
                return
            metrics = {"num_samples": 10.0 + CLIENTS.index(cid), "loss": 1.0, "accuracy": 0.5}
            assert await client.submit_update(pkg["add"](params, DELTAS[cid]), metrics)
            while True:
                status = await client.check_server_status()
                if not status["training_active"] or status["round"] != rnd:
                    break
                await asyncio.sleep(0.02)


def _federate(server_pkg, client_pkgs, tmp_path):
    """``NET_ROUNDS`` plain rounds on ``server_pkg``'s server (its own registry and a
    tracer) and network coordinator (with a telemetry dir); returns the /metrics text,
    the server's tracer, the client registries and the coordinator."""
    srv = SERVERS[server_pkg]

    async def main():
        port = free_port()
        registry, tracer = srv["registry"](), srv["tracer"](registry=False,
                                                            annotate_device=False)
        server = srv["comm"].HTTPServer(port=port, registry=registry, tracer=tracer)
        await server.start()
        try:
            coordinator = srv["comm"].NetworkCoordinator(
                server, srv["params"](),
                srv["comm"].NetworkRoundConfig(num_rounds=NET_ROUNDS,
                                               min_clients=len(CLIENTS),
                                               round_timeout_s=20.0, poll_interval_s=0.02),
                telemetry_dir=tmp_path / f"{server_pkg}_net", **srv["coordinator"])
            url = f"http://127.0.0.1:{port}"
            client_regs = [CLIENT_PKGS[p]["registry"]() for p in client_pkgs]
            await asyncio.wait_for(asyncio.gather(coordinator.run(), *[
                _client(CLIENT_PKGS[p], url, cid, reg)
                for p, cid, reg in zip(client_pkgs, CLIENTS, client_regs)]), 120)
            async with aiohttp.ClientSession() as session:
                async with session.get(f"{url}/metrics") as resp:
                    assert resp.status == 200
                    assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
                    text = await resp.text()
            return text, tracer, client_regs, coordinator
        finally:
            await server.stop()

    return asyncio.run(main())


def _families(text):
    return set(re.findall(r"^# TYPE (\S+) ", text, flags=re.M))


def _value(text, sample):
    match = re.search(rf"^{re.escape(sample)} (\S+)$", text, flags=re.M)
    return float(match.group(1)) if match else None


@pytest.fixture(scope="module")
def federations(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("net")
    return {name: _federate(name, ["port"] * len(CLIENTS), tmp) for name in ("port", "jax")}


def test_metrics_show_the_jax_families_and_counts(federations):
    got, want = federations["port"][0], federations["jax"][0]
    assert _families(got) == _families(want)
    assert {"nanofed_bytes_received_total", "nanofed_bytes_sent_total",
            "nanofed_updates_total", "nanofed_secagg_evictions_total",
            "nanofed_http_429_total", "nanofed_read_timeouts_total",
            "nanofed_fleet_bytes_total", "nanofed_fleet_updates_total",
            "nanofed_rounds_total", "nanofed_round_duration_seconds",
            "nanofed_span_duration_seconds", "nanofed_validation_rejections_total",
            "nanofed_straggler_evictions_total"} <= _families(got)
    for sample in ('nanofed_updates_total{kind="plain",result="accepted"}',
                   'nanofed_bytes_received_total{endpoint="update"}',
                   'nanofed_rounds_total{status="completed"}',
                   'nanofed_span_duration_seconds_count{span="aggregate"}'):
        assert _value(got, sample) == _value(want, sample) is not None, sample
    assert _value(got, 'nanofed_updates_total{kind="plain",result="accepted"}') == \
        len(CLIENTS) * NET_ROUNDS


def test_bytes_received_equal_the_bodies_the_clients_sent(federations):
    for name, (text, _, client_regs, _) in federations.items():
        sent = sum(reg.counter("nanofed_client_bytes_sent_total", labels=("endpoint",))
                   .value(endpoint="update") for reg in client_regs)
        assert _value(text, 'nanofed_bytes_received_total{endpoint="update"}') == sent > 0


def test_the_network_coordinator_telemetry_matches_jax(federations):
    def shape(name):
        coordinator = federations[name][3]
        path = coordinator.telemetry.path
        records = _records(path)
        return [(r["type"], r.get("name"), r.get("depth"), sorted(r)) for r in records
                if r["type"] != "metrics_snapshot"]

    assert shape("port") == shape("jax")
    assert [r for r in _records(federations["port"][3].telemetry.path)][-1]["type"] == \
        "metrics_snapshot"


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "jax"), ("jax", "port")])
def test_each_package_trace_header_lands_in_one_decode_span(tmp_path, server_pkg,
                                                            client_pkg):
    _, tracer, _, _ = _federate(server_pkg, [client_pkg] * len(CLIENTS), tmp_path)
    decodes = [r for r in tracer.records if r.name == "submit-decode"]
    want = [obs.new_trace(cid, rnd, rnd + 1).trace_id
            for cid in CLIENTS for rnd in range(NET_ROUNDS)]
    traces = [r.attrs["trace"] for r in decodes]
    assert sorted(traces) == sorted(want)
    assert all(traces.count(t) == 1 for t in want)
