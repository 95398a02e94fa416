"""Merged federation timelines + per-round critical-path attribution (counterpart of
``nanofed_tpu/observability/critical_path.py``: the pure read side, copied as it is;
the per-host writer, the federate worker, comes with the multi-host slice).

A multi-host federate run writes one ``telemetry.jsonl`` PER PROCESS (the
supervisor's stream at the telemetry root, each mesh worker's under
``host_<h>/``).  This module is the pure read side that turns those disjoint
streams into one story:

* :func:`load_host_streams` finds and parses every stream under a telemetry
  dir.
* :func:`clock_offsets` aligns the streams' wall clocks at the
  bring-up-barrier epoch: each worker records a ``clock_sync`` record with
  the wall time of its warm-psum anchor, and since the warm psum is a
  BARRIER (every host exits within collective-completion skew of its peers),
  the per-host anchor walls are simultaneous up to clock error — the
  differences ARE the clock skew to subtract.
* :func:`merge_timeline` emits one host-laned Chrome ``trace_event`` JSON
  (``chrome://tracing`` / Perfetto): pid = mesh host, with the round beats,
  their critical-path segments, and every streamed span on that host's lane.
* :func:`critical_path_rounds` / :func:`segment_digest` decompose each
  round's walltime into the :data:`CRITICAL_PATH_SEGMENTS` the workers
  timed — the numbers behind ``nanofed_round_critical_path_seconds``.
* :func:`resolve_traces` joins the rounds' consumed-trace lists into a
  submit -> consuming-round resolution (every accepted submit that drained
  must resolve to exactly one round).

:func:`federation_timeline` is the one-call entry point the ``nanofed-tpu trace``
subcommand and the trace-smoke assertions use.

Segment convention (why the segments tile the round walltime): ``wire_wait``,
``drain``, ``collective``, ``apply`` and ``publish`` are SEQUENTIAL stages of
the worker's round loop.  ``decode`` happens on the bounded pool's threads
*during* the wait for the round beat, so the worker reports ``decode`` as the
pool-busy seconds attributed to the round and ``wire_wait`` as the measured
beat wait MINUS that overlap — the six segments then partition the loop body,
and their sum tracks the measured round walltime (the residue is heartbeat
and bookkeeping slivers).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Iterable, Mapping

from nanofed_tpu_torch.observability.telemetry import TELEMETRY_FILENAME

__all__ = [
    "CRITICAL_PATH_HISTOGRAM",
    "CRITICAL_PATH_SEGMENTS",
    "clock_offsets",
    "critical_path_rounds",
    "federation_timeline",
    "load_host_streams",
    "merge_timeline",
    "resolve_traces",
    "segment_digest",
]

#: The per-round decomposition, in critical-path order.
CRITICAL_PATH_SEGMENTS = (
    "wire_wait", "decode", "drain", "collective", "apply", "publish",
)

#: Registry histogram the RoundLedger publishes the segments under.
CRITICAL_PATH_HISTOGRAM = "nanofed_round_critical_path_seconds"

#: The tiling segments (decode overlaps wire_wait on pool threads; the worker
#: already subtracts the overlap, so ALL six tile — kept for documentation).
_SEQUENTIAL_SEGMENTS = ("wire_wait", "drain", "collective", "apply", "publish")


def load_host_streams(root: str | Path) -> dict[str, list[dict[str, Any]]]:
    """Every telemetry stream under ``root``, keyed by stream label (the
    stream's dir relative to ``root``; the root's own stream is ``"."``).
    ``root`` may also be one ``telemetry.jsonl`` directly.  Torn tail lines
    (a crashed writer) are skipped, matching ``summarize_telemetry``."""
    root = Path(root)
    paths = (
        [root] if root.is_file()
        else sorted(root.glob(f"**/{TELEMETRY_FILENAME}"))
    )
    streams: dict[str, list[dict[str, Any]]] = {}
    for path in paths:
        if root.is_file():
            label = "."
        else:
            rel = path.parent.relative_to(root)
            label = str(rel) if str(rel) != "." else "."
        records: list[dict[str, Any]] = []
        with path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # at most one torn tail line per crashed writer
        streams[label] = records
    return streams


def _clock_sync(records: Iterable[Mapping[str, Any]]) -> dict[str, Any] | None:
    for rec in records:
        if rec.get("type") == "clock_sync":
            return dict(rec)
    return None


def clock_offsets(
    streams: Mapping[str, list[dict[str, Any]]],
) -> dict[str, float]:
    """Per-stream seconds to ADD to that stream's wall stamps so every host
    agrees the bring-up barrier happened at the reference instant (the
    lowest-labelled stream with a ``clock_sync`` record).  Streams without a
    ``clock_sync`` (the supervisor's) get offset 0.0 — they share the
    machine clock in the single-machine harness and have no barrier to pin
    to elsewhere."""
    anchors = {
        label: float(sync["anchor_wall"])
        for label, recs in streams.items()
        if (sync := _clock_sync(recs)) is not None and "anchor_wall" in sync
    }
    if not anchors:
        return {label: 0.0 for label in streams}
    reference = anchors[sorted(anchors)[0]]
    return {
        label: round(reference - anchors[label], 6) if label in anchors
        else 0.0
        for label in streams
    }


def _stream_host(
    label: str, records: Iterable[Mapping[str, Any]], fallback: int
) -> int:
    sync = _clock_sync(records)
    if sync is not None and "host" in sync:
        return int(sync["host"])
    for rec in records:
        if rec.get("type") == "round" and "host" in rec:
            return int(rec["host"])
    return fallback


def merge_timeline(
    streams: Mapping[str, list[dict[str, Any]]],
    offsets: Mapping[str, float] | None = None,
) -> dict[str, Any]:
    """One Chrome ``trace_event`` document over every stream: pid = mesh host
    (the supervisor's lane is pid 1000), tid 0 = round beats, tid 1 = the
    sequential critical-path segments tiling each beat, tid 2 = the decode
    overlay (pool-thread seconds, overlapping the beat's wait), tid 3 = the
    raw streamed spans.  Wall stamps are clock-aligned via ``offsets``."""
    offsets = dict(offsets or clock_offsets(streams))
    events: list[dict[str, Any]] = []
    fallback_pid = 900
    for label in sorted(streams):
        records = streams[label]
        shift = float(offsets.get(label, 0.0))
        if _clock_sync(records) is None and not any(
            r.get("type") == "round" and "segments" in r for r in records
        ):
            pid = 1000  # supervisor / non-worker stream
            lane = f"supervisor ({label})"
        else:
            pid = _stream_host(label, records, fallback_pid)
            fallback_pid += 1
            lane = f"host {pid} ({label})"
        events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": lane},
        })
        for rec in records:
            rtype = rec.get("type")
            if rtype == "round" and "start_wall" in rec:
                start = (float(rec["start_wall"]) + shift) * 1e6
                dur = float(rec.get("duration_s", 0.0)) * 1e6
                events.append({
                    "name": f"round {rec.get('round', '?')}",
                    "ph": "X", "ts": start, "dur": dur, "pid": pid, "tid": 0,
                    "args": {
                        k: rec[k]
                        for k in ("round", "status", "drained", "mass")
                        if k in rec
                    },
                })
                segments = rec.get("segments") or {}
                cursor = start
                for seg in _SEQUENTIAL_SEGMENTS:
                    if seg not in segments:
                        continue
                    seg_us = float(segments[seg]) * 1e6
                    events.append({
                        "name": seg, "ph": "X", "ts": cursor, "dur": seg_us,
                        "pid": pid, "tid": 1,
                        "args": {"round": rec.get("round")},
                    })
                    cursor += seg_us
                if "decode" in segments:
                    events.append({
                        "name": "decode", "ph": "X", "ts": start,
                        "dur": float(segments["decode"]) * 1e6,
                        "pid": pid, "tid": 2,
                        "args": {"round": rec.get("round"),
                                 "overlay": "pool-thread seconds inside "
                                            "wire_wait"},
                    })
            elif rtype == "span" and "start_unix" in rec:
                events.append({
                    "name": str(rec.get("name", "?")), "ph": "X",
                    "ts": (float(rec["start_unix"]) + shift) * 1e6,
                    "dur": float(rec.get("duration_s", 0.0)) * 1e6,
                    "pid": pid, "tid": 3,
                    "args": rec.get("attrs", {}),
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def critical_path_rounds(
    streams: Mapping[str, list[dict[str, Any]]],
) -> list[dict[str, Any]]:
    """One row per (host, round) from every segment-bearing ``round`` record:
    the segment decomposition, the measured walltime, and ``coverage`` (the
    segments' sum over the walltime — the >= 0.95 acceptance bar)."""
    rows: list[dict[str, Any]] = []
    for label in sorted(streams):
        for rec in streams[label]:
            if rec.get("type") != "round" or "segments" not in rec:
                continue
            segments = {
                seg: round(float(rec["segments"][seg]), 6)
                for seg in CRITICAL_PATH_SEGMENTS
                if seg in rec["segments"]
            }
            walltime = float(rec.get("duration_s", 0.0))
            covered = math.fsum(segments.values())
            rows.append({
                "host": rec.get("host"),
                "round": rec.get("round"),
                "status": rec.get("status"),
                "walltime_s": round(walltime, 6),
                "segments": segments,
                "coverage": round(covered / walltime, 4) if walltime else None,
            })
    rows.sort(key=lambda r: (r["round"] if r["round"] is not None else -1,
                             r["host"] if r["host"] is not None else -1))
    return rows


def segment_digest(rows: Iterable[Mapping[str, Any]]) -> dict[str, Any]:
    """Per-segment totals across rows plus the coverage envelope."""
    per_seg: dict[str, list[float]] = {}
    coverages: list[float] = []
    for row in rows:
        for seg, v in (row.get("segments") or {}).items():
            per_seg.setdefault(seg, []).append(float(v))
        if row.get("coverage") is not None:
            coverages.append(float(row["coverage"]))
    out: dict[str, Any] = {
        "segments": {
            seg: {
                "count": len(vs),
                "total_s": round(math.fsum(vs), 6),
                "mean_s": round(math.fsum(vs) / len(vs), 6),
                "max_s": round(max(vs), 6),
            }
            for seg, vs in sorted(per_seg.items())
        },
    }
    if coverages:
        out["coverage"] = {
            "rounds": len(coverages),
            "min": round(min(coverages), 4),
            "mean": round(math.fsum(coverages) / len(coverages), 4),
            "max": round(max(coverages), 4),
        }
    return out


def resolve_traces(
    streams: Mapping[str, list[dict[str, Any]]],
) -> dict[str, Any]:
    """Join the rounds' consumed-trace lists into a submit resolution: each
    drained submit's trace id -> the (host, round) that consumed it.  A
    healthy run has zero ``untraced`` (every accepted submit carried the
    header end to end) and zero ``multi_consumed`` (the idempotency key and
    latest-wins slot semantics make double consumption impossible)."""
    consumed: dict[str, list[tuple[Any, Any]]] = {}
    untraced = 0
    total = 0
    for label in sorted(streams):
        for rec in streams[label]:
            if rec.get("type") != "round" or "traces" not in rec:
                continue
            for trace in rec["traces"]:
                total += 1
                if not trace:
                    untraced += 1
                    continue
                consumed.setdefault(str(trace), []).append(
                    (rec.get("host"), rec.get("round"))
                )
    multi = {t: rounds for t, rounds in consumed.items() if len(rounds) > 1}
    return {
        "consumed_submits": total,
        "unique_traces": len(consumed),
        "untraced": untraced,
        "multi_consumed": {t: multi[t] for t in sorted(multi)[:16]},
        "multi_consumed_count": len(multi),
        "resolved": untraced == 0 and not multi,
        "by_trace": {
            t: {"host": rounds[0][0], "round": rounds[0][1]}
            for t, rounds in sorted(consumed.items())
        },
    }


def federation_timeline(
    root: str | Path, *, include_trace_map: bool = False
) -> dict[str, Any]:
    """The one-call digest of a federate run's telemetry dir: clock-aligned
    stream inventory, the per-round critical-path table + segment digest,
    the trace resolution, and every recovery / host-failure record found.
    The (large) per-trace map is withheld unless ``include_trace_map``."""
    root = Path(root)
    streams = load_host_streams(root)
    offsets = clock_offsets(streams)
    rows = critical_path_rounds(streams)
    resolution = resolve_traces(streams)
    if not include_trace_map:
        resolution = {
            k: v for k, v in resolution.items() if k != "by_trace"
        }
    recoveries: list[dict[str, Any]] = []
    failures: list[dict[str, Any]] = []
    for recs in streams.values():
        for rec in recs:
            if rec.get("type") == "recovery":
                recoveries.append(rec)
            elif rec.get("type") == "host_failure":
                failures.append(rec)
    return {
        "telemetry_dir": str(root),
        "streams": {
            label: {
                "records": len(recs),
                "clock_offset_s": offsets.get(label, 0.0),
            }
            for label, recs in sorted(streams.items())
        },
        "rounds": rows,
        **segment_digest(rows),
        "trace_resolution": resolution,
        "recoveries": recoveries,
        "host_failures": failures,
    }
