"""Wire trace contexts and the crash flight recorder (counterpart of
``nanofed_tpu/observability/tracing.py``, copied as it is: plain Python).

* :class:`TraceContext` / :func:`new_trace` / :func:`parse_trace` — a
  W3C-traceparent-style context (``00-<32hex trace>-<16hex span>-<flags>``) that
  rides the ``X-NanoFed-Trace`` header from the submitting client
  (:class:`~nanofed_tpu_torch.communication.http_client.HTTPClient`) to the server's
  ``submit-decode`` span.  Trace ids are DERIVED, not drawn: ``new_trace`` hashes the
  caller-supplied identity parts (client id, round, submit sequence), so a retry's
  re-sends stay on ONE trace, and both packages derive the same header from the same
  parts.
* :class:`FlightRecorder` — a bounded in-process ring of recent events for crash
  forensics; :meth:`~FlightRecorder.dump` creates missing parent directories and
  NEVER raises.  :func:`mttr_decomposition` turns the ring's marks into named
  recovery phases.

:func:`forensic_now` is the one wall-clock read for forensic stamps.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Mapping, Sequence

__all__ = [
    "FLIGHT_RECORDER_FILENAME",
    "FlightRecorder",
    "TRACE_VERSION",
    "TraceContext",
    "forensic_now",
    "mttr_decomposition",
    "new_trace",
    "parse_trace",
]

#: Version prefix of the wire form (W3C traceparent's ``00``).
TRACE_VERSION = "00"

#: Default filename the supervisor dumps a crashed host's ring under.
FLIGHT_RECORDER_FILENAME = "flight_recorder.json"

_HEX = set("0123456789abcdef")


def forensic_now() -> float:
    """Current wall-clock time, for FORENSIC stamps only: a timestamp that lines
    artifacts up against external logs and each other across processes.  Time that
    takes part in protocol behaviour (backoffs, timeouts, round pacing) reads the
    injected ``utils.clock.Clock``.  Never branch on the value."""
    return time.time()


def _hexdigest(parts: Iterable[Any]) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode("utf-8", "replace"))
        h.update(b"\x1f")  # unit separator: ("ab","c") != ("a","bc")
    return h.hexdigest()


@dataclass(frozen=True)
class TraceContext:
    """One wire trace: a 32-hex trace id (the LOGICAL submit) and a 16-hex
    span id (the hop currently holding it)."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    flags: str = "01"  # sampled; kept for wire-format fidelity

    def header(self) -> str:
        """The ``X-NanoFed-Trace`` wire form (traceparent layout)."""
        return f"{TRACE_VERSION}-{self.trace_id}-{self.span_id}-{self.flags}"

    def child(self, *parts: Any) -> "TraceContext":
        """Same trace, a derived span id for the next hop — deterministic in
        (this span, ``parts``), so re-processing a retry re-derives the SAME
        child rather than forking the trace."""
        digest = _hexdigest((self.trace_id, self.span_id, *parts))
        return TraceContext(self.trace_id, digest[:16], self.flags)


def new_trace(*parts: Any) -> TraceContext:
    """Derive a :class:`TraceContext` from identity parts (client id, round,
    submit sequence...).  Same parts -> same trace: retries of one logical
    submit share a trace id, and seeded load harnesses stay reproducible."""
    digest = _hexdigest(parts)
    return TraceContext(digest[:32], digest[32:48])


def parse_trace(header: str | None) -> TraceContext | None:
    """Parse an ``X-NanoFed-Trace`` header; lenient — a malformed or absent
    header is ``None`` (an untraced submit must stay a valid submit: tracing
    is observability, never admission control).  Accepts the full
    ``00-<32hex>-<16hex>-<2hex>`` form or a bare 32-hex trace id."""
    if not header:
        return None
    value = header.strip().lower()
    if "-" not in value:
        if len(value) == 32 and set(value) <= _HEX:
            return TraceContext(value, value[:16])
        return None
    fields = value.split("-")
    if len(fields) != 4:
        return None
    version, trace_id, span_id, flags = fields
    if (
        len(version) == 2
        and len(trace_id) == 32
        and len(span_id) == 16
        and len(flags) == 2
        and set(trace_id) <= _HEX
        and set(span_id) <= _HEX
    ):
        return TraceContext(trace_id, span_id, flags)
    return None


class FlightRecorder:
    """Bounded thread-safe ring of recent events, for crash forensics.

    ``note(kind, **fields)`` appends one event carrying both clocks: a
    monotonic stamp (phase arithmetic — :func:`mttr_decomposition` subtracts
    these) and a forensic wall stamp (correlation with external logs).  The
    ring holds the last ``capacity`` events; old ones fall off — a flight
    recorder documents the moments BEFORE the crash, not the whole flight.
    """

    def __init__(self, capacity: int = 512, name: str = "supervisor") -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._dropped = 0

    def note(self, kind: str, **fields: Any) -> dict[str, Any]:
        """Append one event; returns the record (callers keep the ``t_mono``
        of marks they will difference later)."""
        rec = {
            "kind": str(kind),
            "t_wall": round(forensic_now(), 6),
            "t_mono": round(time.monotonic(), 6),
            **fields,
        }
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)
        return rec

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(
        self, path: str | Path, *, extra: Mapping[str, Any] | None = None
    ) -> Path | None:
        """Write the ring as one JSON document at ``path``; creates missing
        parent directories; NEVER raises.  Returns the path on success, None
        on any failure — this runs inside the supervisor's reap path, and a
        forensics write must not be able to break the recovery it documents.
        """
        try:
            path = Path(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            with self._lock:
                events = list(self._ring)
                dropped = self._dropped
            doc: dict[str, Any] = {
                "recorder": self.name,
                "capacity": self.capacity,
                "events_dropped": dropped,
                "dumped_wall": round(forensic_now(), 3),
                "events": events,
            }
            if extra:
                doc.update(extra)
            path.write_text(json.dumps(doc, indent=1, default=str) + "\n")
            return path
        except Exception:
            return None


def mttr_decomposition(
    events: Iterable[Mapping[str, Any]],
    sequence: Sequence[tuple[str, str | None]],
) -> dict[str, float]:
    """Named recovery phases from a flight recorder's marks.

    ``sequence`` is an ordered list of ``(mark_kind, phase_name)`` pairs:
    each phase measures the interval from the PREVIOUS present mark to this
    one (the first pair anchors and names no phase — pass ``None``).  Marks
    absent from ``events`` are skipped, so a partial recovery still yields
    the phases it reached.  The first event of each kind wins (re-noted marks
    do not stretch a phase)::

        mttr_decomposition(recorder.snapshot(), [
            ("host_killed", None),
            ("kill_detected", "detect"),
            ("reaped", "reap"),
            ("respawned", "respawn"),
            ("ready", "bring_up"),
            ("first_progress", "recompile"),
        ])
    """
    t_by_kind: dict[str, float] = {}
    for e in events:
        kind = e.get("kind")
        if kind is not None and kind not in t_by_kind and "t_mono" in e:
            t_by_kind[str(kind)] = float(e["t_mono"])
    phases: dict[str, float] = {}
    prev_t: float | None = None
    for kind, phase in sequence:
        t = t_by_kind.get(kind)
        if t is None:
            continue
        if phase is not None and prev_t is not None:
            phases[phase] = round(max(0.0, t - prev_t), 6)
        prev_t = t
    return phases
