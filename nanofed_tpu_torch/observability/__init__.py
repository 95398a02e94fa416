"""Observability (counterpart of ``nanofed_tpu/observability``): the metrics
registry, federation spans, run telemetry, wire trace contexts, the critical-path
reader and the program cost profiler.

A zero-dependency, thread-safe :class:`MetricsRegistry` (counters / gauges /
histograms with labels, Prometheus text exposition — served at ``GET /metrics`` by
``communication.http_server``), a nestable :class:`SpanTracer` for the federation
loop's phase structure (round → cohort-sample → local-train → aggregate → publish;
JSONL and Chrome-trace export, and a ``torch.profiler.record_function`` per span, so
spans show inside a ``utils.profiling.trace`` capture), and :class:`RunTelemetry`,
the per-run ``telemetry.jsonl`` both coordinators write, in the JAX package's record
format.

The program cost layer (:mod:`~nanofed_tpu_torch.observability.profiling`) runs each
round program and counts what it did, and :func:`update_device_occupancy` derives the
occupancy gauge the online retuner reads from the spans.

The tracing layer (:mod:`~nanofed_tpu_torch.observability.tracing`,
:mod:`~nanofed_tpu_torch.observability.critical_path`) is the JAX package's, copied:
trace contexts on the ``X-NanoFed-Trace`` header, the flight recorder, and the pure
reader that merges per-host streams and decomposes each round's critical path.

Stated difference: the JAX package's ``install_jax_event_bridge`` is the port's
:func:`install_torch_event_bridge`, which forwards the kernel-build events of ``ops._build``
(``ops/_build.py``) under ``nanofed_torch_*`` families.
"""

from nanofed_tpu_torch.observability.critical_path import (
    CRITICAL_PATH_HISTOGRAM,
    CRITICAL_PATH_SEGMENTS,
    clock_offsets,
    critical_path_rounds,
    federation_timeline,
    load_host_streams,
    merge_timeline,
    resolve_traces,
    segment_digest,
)
from nanofed_tpu_torch.observability.profiling import (
    GPU_PEAKS,
    PlatformPeaks,
    ProgramCatalog,
    ProgramCostReport,
    format_cost_table,
    peaks_for_device_kind,
    profile_program,
    update_device_occupancy,
)
from nanofed_tpu_torch.observability.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from nanofed_tpu_torch.observability.spans import SPAN_HISTOGRAM, SpanRecord, SpanTracer
from nanofed_tpu_torch.observability.telemetry import (
    TELEMETRY_FILENAME,
    RunTelemetry,
    find_latest_telemetry,
    install_torch_event_bridge,
    summarize_telemetry,
)
from nanofed_tpu_torch.observability.tracing import (
    FLIGHT_RECORDER_FILENAME,
    TRACE_VERSION,
    FlightRecorder,
    TraceContext,
    forensic_now,
    mttr_decomposition,
    new_trace,
    parse_trace,
)

__all__ = [
    "CRITICAL_PATH_HISTOGRAM",
    "CRITICAL_PATH_SEGMENTS",
    "Counter",
    "DEFAULT_BUCKETS",
    "FLIGHT_RECORDER_FILENAME",
    "FlightRecorder",
    "GPU_PEAKS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PlatformPeaks",
    "ProgramCatalog",
    "ProgramCostReport",
    "RunTelemetry",
    "SPAN_HISTOGRAM",
    "SpanRecord",
    "SpanTracer",
    "TELEMETRY_FILENAME",
    "TRACE_VERSION",
    "TraceContext",
    "clock_offsets",
    "critical_path_rounds",
    "federation_timeline",
    "find_latest_telemetry",
    "forensic_now",
    "format_cost_table",
    "get_registry",
    "install_torch_event_bridge",
    "load_host_streams",
    "merge_timeline",
    "mttr_decomposition",
    "new_trace",
    "parse_trace",
    "peaks_for_device_kind",
    "profile_program",
    "resolve_traces",
    "segment_digest",
    "summarize_telemetry",
    "update_device_occupancy",
]
