"""The port's observability layer (``nanofed_tpu_torch.observability``, the
``RoundLedger``'s sinks and ``utils.profiling``) against the JAX package's, on the CPU.

The same span programs, telemetry streams, trace parts, flight-recorder marks and
ledger charges go through both packages.  Everything compared here is exact: record
structure, headers, digests and Prometheus text (times are removed or injected)."""

import asyncio
import importlib.util
import json
import threading
from pathlib import Path

import pytest
import torch

import nanofed_tpu.observability as jax_obs
import nanofed_tpu_torch.observability as obs
from nanofed_tpu.observability import profiling as jax_profiling
from nanofed_tpu.orchestration.engine import RoundLedger as JaxRoundLedger
from nanofed_tpu_torch.observability import profiling
from nanofed_tpu_torch.orchestration.engine import RoundLedger
from nanofed_tpu_torch.utils import profiling as port_profiling

PKGS = {"port": obs, "jax": jax_obs}
REPO = Path(__file__).resolve().parents[1]


def _structure(records):
    """(name, depth, parent name, attrs) per closed span, in closing order."""
    by_id = {r.span_id: r for r in records}
    return [(r.name, r.depth, by_id[r.parent_id].name if r.parent_id is not None else None,
             r.attrs) for r in records]


def _nested_program(tracer):
    with tracer.span("round", round=3):
        with tracer.span("cohort-sample", round=3):
            pass
        with tracer.span("local-train", round=3, fused="train+aggregate"):
            with tracer.span("inner"):
                pass
        with tracer.span("aggregate", round=3):
            pass
    with tracer.span("publish", round=3):
        pass


def _to_thread_program(tracer):
    def decode():
        with tracer.span("submit-decode", trace="ab" * 16):
            with tracer.span("unpack"):
                pass

    async def handler():
        with tracer.span("handle-submit"):
            await asyncio.to_thread(decode)

    asyncio.run(handler())


@pytest.mark.parametrize("program", [_nested_program, _to_thread_program],
                         ids=["nested", "to_thread"])
def test_span_programs_give_the_jax_records(program):
    got, want = (pkg.SpanTracer(registry=False, annotate_device=False)
                 for pkg in (obs, jax_obs))
    program(got)
    program(want)
    assert _structure(got.records) == _structure(want.records)
    assert [r.span_id for r in got.records] == [r.span_id for r in want.records]
    assert got.phase_summary().keys() == want.phase_summary().keys()
    for r in got.records:
        assert set(r.to_dict()) == set(next(
            w for w in want.records if w.span_id == r.span_id).to_dict())


def test_a_pool_thread_span_is_a_root():
    tracer = obs.SpanTracer(registry=False, annotate_device=False)
    _to_thread_program(tracer)
    records = {r.name: r for r in tracer.records}
    assert records["submit-decode"].depth == 0 and records["submit-decode"].parent_id is None
    assert records["submit-decode"].thread_id != records["handle-submit"].thread_id
    assert records["unpack"].parent_id == records["submit-decode"].span_id


def test_spans_feed_the_histogram_and_stream_without_keeping_records():
    reg, seen = obs.MetricsRegistry(), []
    tracer = obs.SpanTracer(registry=reg, on_close=seen.append, annotate_device=False)
    _nested_program(tracer)
    assert tracer.records == [] and [r.name for r in seen][-1] == "publish"
    hist = reg.histogram(obs.SPAN_HISTOGRAM, labels=("span",))
    assert hist.sample_sum(span="round") == pytest.approx(seen[-2].duration_s)
    kept = obs.SpanTracer(registry=False, on_close=seen.append, keep_records=True)
    _nested_program(kept)
    assert len(kept.records) == 6


def test_span_exports_match_jax_shapes(tmp_path):
    got, want = (pkg.SpanTracer(registry=False, annotate_device=False)
                 for pkg in (obs, jax_obs))
    _nested_program(got)
    _nested_program(want)
    for tracer, tag in ((got, "port"), (want, "jax")):
        tracer.export_jsonl(tmp_path / tag / "spans.jsonl")
        tracer.export_chrome_trace(tmp_path / tag / "trace.json")

    def shape(tag):
        lines = [json.loads(x) for x in (tmp_path / tag / "spans.jsonl").read_text().splitlines()]
        events = json.loads((tmp_path / tag / "trace.json").read_text())["traceEvents"]
        return ([(x["name"], x["depth"], x.get("attrs")) for x in lines],
                [(e["name"], e["ph"], sorted(e["args"])) for e in events])

    assert shape("port") == shape("jax")


def test_a_span_is_a_named_slice_in_a_torch_profiler_capture(tmp_path):
    tracer = obs.SpanTracer(registry=False)
    with port_profiling.trace(tmp_path / "cap") as prof:
        with tracer.span("local-train"):
            with port_profiling.annotate("inner-annotation"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"local-train", "inner-annotation"} <= names
    written = list((tmp_path / "cap").glob("*.json"))
    assert len(written) == 1
    text = written[0].read_text()
    assert '"local-train"' in text and '"inner-annotation"' in text


def test_device_time_warms_once_then_times_each_rep():
    calls = []
    out = port_profiling.device_time(lambda: calls.append(1), reps=4)
    assert len(calls) == 5
    assert out["min_s"] <= out["median_s"] <= out["max_s"]


@pytest.mark.parametrize("parts", [("c7", 3, 1), ("client", 0, 12), (), ("ä", None, 2.5)])
def test_trace_headers_and_children_equal_jax(parts):
    got, want = obs.new_trace(*parts), jax_obs.new_trace(*parts)
    assert got.header() == want.header()
    assert got.child("decode", 4).header() == want.child("decode", 4).header()
    for header in (want.header(), want.trace_id, want.header().upper(), "00-zz", "",
                   None, "00-" + "a" * 32 + "-" + "b" * 16, "junk-" * 3):
        assert obs.parse_trace(header) == (
            None if jax_obs.parse_trace(header) is None
            else obs.TraceContext(**vars(jax_obs.parse_trace(header))))
    assert obs.TRACE_VERSION == jax_obs.TRACE_VERSION
    assert obs.FLIGHT_RECORDER_FILENAME == jax_obs.FLIGHT_RECORDER_FILENAME


def test_flight_recorder_dump_and_mttr_equal_jax(tmp_path, monkeypatch):
    for module in (obs.tracing, jax_obs.tracing):
        monkeypatch.setattr(module, "forensic_now", lambda: 1.5e9)
    docs, phases = {}, {}
    for tag, pkg in PKGS.items():
        times = iter([100.0, 100.5, 101.25, 103.0, 104.0, 104.0, 109.5])
        monkeypatch.setattr(pkg.tracing.time, "monotonic", lambda: next(times))
        rec = pkg.FlightRecorder(capacity=5, name="sup")
        for kind in ("spawn", "host_killed", "kill_detected", "reaped", "respawned",
                     "ready", "first_progress"):
            rec.note(kind, host=1)
        path = rec.dump(tmp_path / tag / "deep" / pkg.FLIGHT_RECORDER_FILENAME,
                        extra={"generation": 2})
        docs[tag] = json.loads(Path(path).read_text())
        phases[tag] = pkg.mttr_decomposition(rec.snapshot(), [
            ("host_killed", None), ("kill_detected", "detect"), ("reaped", "reap"),
            ("respawned", "respawn"), ("ready", "bring_up"), ("first_progress", "recompile"),
        ])
    assert docs["port"] == docs["jax"] and docs["port"]["events_dropped"] == 2
    assert phases["port"] == phases["jax"]
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where a directory should be")
    assert obs.FlightRecorder().dump(blocked / "sub" / "ring.json") is None  # never raises


def _critical_path_module():
    spec = importlib.util.spec_from_file_location(
        "jax_critical_path_tests", REPO / "tests/unit/observability/test_critical_path.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def federation_dir(tmp_path):
    """The streams ``tests/unit/observability/test_critical_path.py`` builds: two
    workers with a 0.5 s clock skew plus the supervisor's stream, with a torn tail."""
    cp = _critical_path_module()
    cp._write(tmp_path / "telemetry.jsonl", [
        {"type": "host_failure", "kind": "host_crash", "host": 1, "round": 1},
        {"type": "recovery", "recovery_s": 2.5,
         "mttr_phases": {"reap": 0.5, "respawn": 1.0, "recompile": 1.0}},
    ])
    cp._write(tmp_path / "host_0" / "telemetry.jsonl", [
        {"type": "clock_sync", "host": 0, "anchor_wall": 1000.0, "process_id": 0},
        cp._round(0, 0, 1000.2, 1.0, ["aa" * 16, "bb" * 16]),
        cp._round(0, 1, 1001.2, 1.0, ["cc" * 16], scale=0.96),
        {"type": "span", "name": "submit-decode", "start_unix": 1000.4,
         "duration_s": 0.05, "attrs": {"trace": "aa" * 16}},
    ])
    cp._write(tmp_path / "host_1" / "telemetry.jsonl", [
        {"type": "clock_sync", "host": 1, "anchor_wall": 1000.5, "process_id": 1},
        cp._round(1, 0, 1000.7, 1.0, ["dd" * 16]),
        cp._round(1, 1, 1001.7, 1.0, ["aa" * 16]),  # a double consumption
    ])
    with (tmp_path / "host_1" / "telemetry.jsonl").open("a") as f:
        f.write('{"type": "round", "torn')
    return tmp_path


@pytest.mark.parametrize("name", [
    "load_host_streams", "clock_offsets", "merge_timeline", "critical_path_rounds",
    "segment_digest", "resolve_traces", "federation_timeline", "federation_timeline_map",
    "single_file",
])
def test_critical_path_reader_equals_jax(federation_dir, name):
    def run(pkg):
        streams = pkg.load_host_streams(federation_dir)
        return {
            "load_host_streams": lambda: streams,
            "clock_offsets": lambda: pkg.clock_offsets(streams),
            "merge_timeline": lambda: pkg.merge_timeline(streams),
            "critical_path_rounds": lambda: pkg.critical_path_rounds(streams),
            "segment_digest": lambda: pkg.segment_digest(pkg.critical_path_rounds(streams)),
            "resolve_traces": lambda: pkg.resolve_traces(streams),
            "federation_timeline": lambda: pkg.federation_timeline(federation_dir),
            "federation_timeline_map": lambda: pkg.federation_timeline(
                federation_dir, include_trace_map=True),
            "single_file": lambda: pkg.load_host_streams(
                federation_dir / "host_0" / "telemetry.jsonl"),
        }[name]()

    got, want = run(obs), run(jax_obs)
    assert got == want
    if name == "resolve_traces":
        assert got["multi_consumed_count"] == 1 and not got["resolved"]
    assert obs.CRITICAL_PATH_SEGMENTS == jax_obs.CRITICAL_PATH_SEGMENTS
    assert obs.CRITICAL_PATH_HISTOGRAM == jax_obs.CRITICAL_PATH_HISTOGRAM


OCCUPANCY_OBSERVATIONS = {
    "single": [("round", 2.0), ("local-train", 1.5), ("publish", 0.5),
               ("round", 1.0), ("local-train", 0.25)],
    "fused": [("dispatch", 0.5), ("host_sync", 3.0), ("publish", 0.25),
              ("round", 9.0), ("local-train", 9.0)],
    "saturated": [("round", 1.0), ("local-train", 4.0)],
    "none": [("aggregate", 1.0)],
}


@pytest.mark.parametrize("case", sorted(OCCUPANCY_OBSERVATIONS))
def test_update_device_occupancy_equals_jax_on_both_bases(case):
    out = {}
    for tag, pkg, prof in (("port", obs, profiling), ("jax", jax_obs, jax_profiling)):
        reg = pkg.MetricsRegistry()
        hist = reg.histogram(pkg.SPAN_HISTOGRAM, "Federation-loop phase durations",
                             labels=("span",))
        for span, seconds in OCCUPANCY_OBSERVATIONS[case]:
            hist.observe(seconds, span=span)
        ratio = pkg.update_device_occupancy(reg)
        out[tag] = (ratio, reg.render_prometheus())
    assert out["port"] == out["jax"]
    if case != "none":
        assert profiling.DEVICE_OCCUPANCY_GAUGE in out["port"][1]
    assert profiling.DEVICE_OCCUPANCY_GAUGE == jax_profiling.DEVICE_OCCUPANCY_GAUGE


def _charge_all(ledger):
    ledger.charge(status="COMPLETED", num_clients=8, duration_s=0.5, expected=10,
                  telemetry_fields={"round": 0, "status": "COMPLETED"})
    ledger.charge(status="FAILED", num_clients=1, duration_s=0.25, expected=10)
    ledger.charge(status="COMPLETED", num_clients=10, duration_s=2.0, expected=10,
                  telemetry_fields={"round": 2}, segments={"wire_wait": 1.25, "apply": 0.5})


class _Sink:
    def __init__(self):
        self.records = []

    def record(self, record_type, **fields):
        self.records.append((record_type, fields))


@pytest.mark.parametrize("track_dropouts", [True, False])
def test_round_ledger_renders_the_jax_prometheus_text(track_dropouts):
    got_reg, want_reg = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    got_sink, want_sink = _Sink(), _Sink()
    got = RoundLedger(got_reg, telemetry=got_sink, track_dropouts=track_dropouts)
    want = JaxRoundLedger(want_reg, telemetry=want_sink, track_dropouts=track_dropouts)
    _charge_all(got)
    _charge_all(want)
    assert got_reg.render_prometheus() == want_reg.render_prometheus()
    assert got_sink.records == want_sink.records
    assert got.rounds == {"completed": 2, "failed": 1}
    assert got.durations_s == [0.5, 0.25, 2.0] and got.cohort_size == 10


def test_observability_exports_the_jax_surface_but_the_bridge():
    jax_names = set(jax_obs.__all__) - {"install_jax_event_bridge"}
    assert jax_names <= set(obs.__all__)
    assert set(obs.__all__) - jax_names == {"install_torch_event_bridge", "GPU_PEAKS"}
    for name in obs.__all__:
        assert getattr(obs, name) is not None


def test_span_threads_share_one_id_sequence():
    tracer = obs.SpanTracer(registry=False, annotate_device=False)

    def work():
        for _ in range(50):
            with tracer.span("w"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ids = sorted(r.span_id for r in tracer.records)
    assert ids == list(range(200)) and all(r.depth == 0 for r in tracer.records)
