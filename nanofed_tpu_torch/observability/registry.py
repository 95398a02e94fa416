"""Process-wide metrics registry: counters, gauges, histograms with labels (the
port's own copy of ``nanofed_tpu/observability/registry.py``, plain Python with no
JAX, so the port imports nothing of the JAX package).

A zero-dependency, thread-safe registry whose instruments follow Prometheus
semantics and render in the Prometheus text exposition format (v0.0.4).  The
profiler's ``ProgramCatalog.publish`` writes its ``nanofed_program_*`` gauges and
time-to-ready histogram here, under the JAX package's names.

* **Zero deps** — stdlib only.
* **Thread-safe** — one registry lock covers every mutation.
* **Hot-path-cheap** — instruments are created once and a recorded sample is a dict
  update under a lock; no string formatting happens until exposition.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Iterable

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram buckets, tuned for round/phase durations (seconds): spans from
#: sub-millisecond host work to multi-minute CPU-fallback rounds.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote, newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    """Render a sample value the way Prometheus expects (integers without '.0',
    +Inf/NaN spelled out)."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Instrument:
    """Shared plumbing: name/help/label validation and the label-tuple key scheme.

    Samples are stored keyed by the tuple of label VALUES in the instrument's
    declared label order — label names are fixed at construction, so the tuple is
    unambiguous and hashing it is the entire per-sample bookkeeping cost.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: tuple[str, ...],
                 lock: threading.Lock) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labels:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r} on metric {name!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._lock = lock

    def _key(self, labels: dict[str, Any]) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def _render_labels(self, key: tuple[str, ...],
                       extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = [
            f'{n}="{_escape_label_value(v)}"'
            for n, v in (*zip(self.label_names, key), *extra)
        ]
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Instrument):
    """Monotonically increasing count (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self, name: str, help: str, labels: tuple[str, ...],
                 lock: threading.Lock) -> None:
        super().__init__(name, help, labels, lock)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (got {amount})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._render_labels(k)} {_format_value(v)}"
                for k, v in items]

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {",".join(k) if k else "": v for k, v in sorted(self._values.items())}


class Gauge(_Instrument):
    """A value that can go up and down (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labels: tuple[str, ...],
                 lock: threading.Lock) -> None:
        super().__init__(name, help, labels, lock)
        self._values: dict[tuple[str, ...], float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._render_labels(k)} {_format_value(v)}"
                for k, v in items]

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {",".join(k) if k else "": v for k, v in sorted(self._values.items())}


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus ``histogram``): per-label-set bucket
    counts plus ``_sum`` and ``_count`` series, rendered with the mandatory ``+Inf``
    bucket.  ``observe`` is O(len(buckets)) with no allocation beyond the first sample
    for a label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: tuple[str, ...],
                 lock: threading.Lock,
                 buckets: Iterable[float] | None = None) -> None:
        super().__init__(name, help, labels, lock)
        bs = tuple(sorted(float(b) for b in (buckets if buckets is not None
                                             else DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self.buckets = bs
        # key -> [bucket_counts..., +Inf count]; sums/counts separate.
        self._buckets: dict[tuple[str, ...], list[int]] = {}
        self._sum: dict[tuple[str, ...], float] = {}
        self._count: dict[tuple[str, ...], int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            counts = self._buckets.get(key)
            if counts is None:
                counts = self._buckets[key] = [0] * (len(self.buckets) + 1)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._count[key] = self._count.get(key, 0) + 1

    def sample_count(self, **labels: Any) -> int:
        with self._lock:
            return self._count.get(self._key(labels), 0)

    def sample_sum(self, **labels: Any) -> float:
        with self._lock:
            return self._sum.get(self._key(labels), 0.0)

    def collect(self) -> list[str]:
        with self._lock:
            # Deep-copy the bucket lists: rendering happens outside the lock, and a
            # concurrent observe() mutating a shared list could emit a scrape whose
            # cumulative buckets disagree with the copied _sum/_count (which
            # Prometheus-side histogram_quantile treats as corrupt data).
            items = sorted((k, list(v)) for k, v in self._buckets.items())
            sums = dict(self._sum)
            counts = dict(self._count)
        lines: list[str] = []
        for key, bucket_counts in items:
            cumulative = 0
            for bound, n in zip(self.buckets, bucket_counts):
                cumulative += n
                labels = self._render_labels(key, (("le", _format_value(bound)),))
                lines.append(f"{self.name}_bucket{labels} {cumulative}")
            cumulative += bucket_counts[-1]
            labels = self._render_labels(key, (("le", "+Inf"),))
            lines.append(f"{self.name}_bucket{labels} {cumulative}")
            lines.append(
                f"{self.name}_sum{self._render_labels(key)} "
                f"{_format_value(sums[key])}"
            )
            lines.append(f"{self.name}_count{self._render_labels(key)} {counts[key]}")
        return lines

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                ",".join(k) if k else "": {
                    "count": self._count[k], "sum": self._sum[k],
                }
                for k in sorted(self._buckets)
            }


class MetricsRegistry:
    """A named collection of instruments with Prometheus text exposition.

    Instruments are idempotently registered: asking for an existing name returns the
    existing instrument (so modules can declare their metrics independently), but a
    kind or label-schema mismatch raises — two call sites silently writing different
    shapes under one name is how dashboards lie.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _register(self, cls: type, name: str, help: str,
                  labels: tuple[str, ...], **kwargs: Any) -> Any:
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind} with "
                        f"labels {existing.label_names}; cannot re-register as "
                        f"{cls.kind} with labels {tuple(labels)}"
                    )
                want_buckets = kwargs.get("buckets")
                if want_buckets is not None and tuple(
                    sorted(float(b) for b in want_buckets)
                ) != existing.buckets:
                    # Same strictness as kind/label mismatches: observations landing
                    # in bucket boundaries the call site never declared would render
                    # a silently-wrong distribution.
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{existing.buckets}; cannot re-register with different ones"
                    )
                return existing
            # Instruments share the registry lock: a collect() during exposition sees
            # each instrument atomically, and one lock keeps observe() cheap.
            inst = cls(name, help, tuple(labels), self._lock, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple[str, ...] = (),
                  buckets: Iterable[float] | None = None) -> Histogram:
        """``buckets=None`` means DEFAULT_BUCKETS for a new histogram, or 'adopt the
        existing boundaries' when the name is already registered; an EXPLICIT
        buckets argument that disagrees with the registered instrument raises."""
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def render_prometheus(self) -> str:
        """The full registry in Prometheus text exposition format v0.0.4."""
        out: list[str] = []
        with self._lock:
            instruments = sorted(self._instruments.values(), key=lambda i: i.name)
        for inst in instruments:
            if inst.help:
                out.append(f"# HELP {inst.name} {inst.help}")
            out.append(f"# TYPE {inst.name} {inst.kind}")
            out.extend(inst.collect())
        return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> dict[str, Any]:
        """JSON-friendly dump of every instrument (telemetry.jsonl's final record and
        the ``metrics-summary`` subcommand read this shape)."""
        with self._lock:
            instruments = sorted(self._instruments.values(), key=lambda i: i.name)
        return {
            inst.name: {"kind": inst.kind, "values": inst.snapshot()}
            for inst in instruments
        }

    def reset(self) -> None:
        """Drop every instrument (tests; a long-lived process keeps its counters)."""
        with self._lock:
            self._instruments.clear()


#: The process-wide default registry.  Everything that instruments itself —
#: coordinators, HTTP server/client, trainer callbacks — defaults to this, so one
#: ``GET /metrics`` scrape sees the whole process; pass an explicit registry for
#: isolation (tests do).
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry
