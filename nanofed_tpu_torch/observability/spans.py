"""Nestable span tracing for the federation loop (counterpart of
``nanofed_tpu/observability/spans.py``).

Where ``utils.profiling.trace`` captures the DEVICE side of a round (kernels, copies,
host gaps — heavyweight, opt-in), this tracer owns the HOST side: the federation
loop's phase structure (round → cohort-sample → local-train → aggregate → publish) as
cheap, always-on spans.  The two compose: every ``SpanTracer.span`` also enters a
``torch.profiler.record_function`` (the JAX package enters a
``jax.profiler.TraceAnnotation``), so host spans appear as named slices inside a
capture taken with ``utils.profiling.trace``.

A span reads the host clock only: it never synchronizes the device and never reads a
tensor.  PyTorch dispatches asynchronously, so a span around a launch measures the
enqueue; only a span around a barrier measures the device's work.

Exports:

* **JSONL** — one record per closed span; ``observability.telemetry.RunTelemetry``
  streams these into the per-run ``telemetry.jsonl`` as they close.
* **Chrome trace** (``trace_event`` format) — loadable in ``chrome://tracing`` or
  Perfetto, mergeable with the device captures TensorBoard's profiler writes.
* A metrics bridge — each closed span observes into a
  ``nanofed_span_duration_seconds{span=...}`` histogram on the attached registry, so
  ``GET /metrics`` exposes per-phase duration distributions without reading any file.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator

from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry

SPAN_HISTOGRAM = "nanofed_span_duration_seconds"


@dataclass(frozen=True)
class SpanRecord:
    """One closed span.  ``start_unix`` is wall-clock (for cross-process alignment);
    ``duration_s`` comes from ``perf_counter`` (monotonic, sub-µs)."""

    span_id: int
    name: str
    start_unix: float
    duration_s: float
    depth: int
    parent_id: int | None
    thread_id: int
    attrs: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "span_id": self.span_id,
            "name": self.name,
            "start_unix": round(self.start_unix, 6),
            "duration_s": round(self.duration_s, 6),
            "depth": self.depth,
            "parent_id": self.parent_id,
        }
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class SpanTracer:
    """Collects nested spans; thread-safe (each thread nests independently via a
    thread-local stack, closed spans land in one shared list).

    ``on_close`` (if given) is called with each ``SpanRecord`` as it closes —
    ``RunTelemetry`` uses this to stream spans into ``telemetry.jsonl`` so a crashed
    run still has every completed phase on disk.

    ``keep_records`` controls in-memory retention (what ``records`` /
    ``phase_summary`` / the exports read).  Default: retain only when there is NO
    ``on_close`` sink — a streaming tracer on a long-lived coordinator would
    otherwise accumulate every round's spans forever (the histogram still sees
    every span either way).

    ``registry=None`` attaches the process-wide default registry;
    pass ``registry=False`` to skip the metrics bridge entirely.
    """

    def __init__(
        self,
        registry: MetricsRegistry | bool | None = None,
        on_close: Callable[[SpanRecord], None] | None = None,
        annotate_device: bool = True,
        keep_records: bool | None = None,
    ) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: list[SpanRecord] = []
        self._keep_records = keep_records if keep_records is not None else on_close is None
        self._next_id = 0
        self._on_close = on_close
        self._annotate_device = annotate_device
        self._histogram = None
        if registry is not False:
            reg = registry if isinstance(registry, MetricsRegistry) else get_registry()
            self._histogram = reg.histogram(
                SPAN_HISTOGRAM, "Federation-loop phase durations", labels=("span",)
            )

    def _stack(self) -> list[tuple[int, int]]:
        """This thread's open-span stack of ``(span_id, depth)``."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        """Time the enclosed block as a span named ``name``; nests freely."""
        stack = self._stack()
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        parent_id = stack[-1][0] if stack else None
        depth = stack[-1][1] + 1 if stack else 0
        stack.append((span_id, depth))
        annotation = None
        if self._annotate_device:
            try:
                import torch

                annotation = torch.profiler.record_function(name)
                annotation.__enter__()
            except Exception:
                annotation = None
        # Wall clock for cross-process alignment only; durations use perf_counter.
        # fedlint: disable=FED010 (forensics-only: start_unix aligns spans across PROCESSES — durations use perf_counter below; a per-process virtual clock cannot provide a cross-process common timeline)
        start_unix = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            duration = time.perf_counter() - t0
            if annotation is not None:
                try:
                    annotation.__exit__(None, None, None)
                except Exception:
                    pass
            stack.pop()
            record = SpanRecord(
                span_id=span_id,
                name=name,
                start_unix=start_unix,
                duration_s=duration,
                depth=depth,
                parent_id=parent_id,
                thread_id=threading.get_ident(),
                attrs=dict(attrs),
            )
            if self._keep_records:
                with self._lock:
                    self._records.append(record)
            if self._histogram is not None:
                self._histogram.observe(duration, span=name)
            if self._on_close is not None:
                self._on_close(record)

    @property
    def records(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._records)

    def phase_summary(self) -> dict[str, dict[str, float]]:
        """Per-span-name digest: count / total / mean / max seconds."""
        out: dict[str, dict[str, float]] = {}
        for r in self.records:
            agg = out.setdefault(
                r.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            agg["count"] += 1
            agg["total_s"] += r.duration_s
            agg["max_s"] = max(agg["max_s"], r.duration_s)
        for agg in out.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["max_s"] = round(agg["max_s"], 6)
            agg["mean_s"] = round(agg["total_s"] / agg["count"], 6)
        return out

    def export_jsonl(self, path: str | Path) -> Path:
        """Write every closed span as one JSON line per record."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")
        return path

    def export_chrome_trace(self, path: str | Path) -> Path:
        """Write the spans in Chrome ``trace_event`` format (complete 'X' events) —
        open in ``chrome://tracing`` / Perfetto, or merge with the device captures
        ``utils.profiling.trace`` writes (both are trace_event JSON)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        pid = os.getpid()
        events = [
            {
                "name": r.name,
                "ph": "X",
                "ts": r.start_unix * 1e6,  # microseconds, wall-clock epoch
                "dur": r.duration_s * 1e6,
                "pid": pid,
                "tid": r.thread_id,
                "args": {**r.attrs, "span_id": r.span_id, "depth": r.depth},
            }
            for r in self.records
        ]
        path.write_text(json.dumps({"traceEvents": events, "displayTimeUnit": "ms"}))
        return path
