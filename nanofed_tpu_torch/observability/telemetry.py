"""Per-run telemetry artifact and the kernel-build event bridge (counterpart of
``nanofed_tpu/observability/telemetry.py``).

``RunTelemetry`` owns one run's ``telemetry.jsonl``: an append-only stream of typed
JSON records — ``span`` records streamed from a :class:`~nanofed_tpu_torch.
observability.spans.SpanTracer` as each phase closes, ``round`` records appended by
the coordinator after each round, and a final ``metrics_snapshot`` of the whole
registry on ``close()``.  One ``os.write`` per record on an ``O_APPEND`` descriptor,
so a crashed run still has every completed round on disk and concurrent writers never
interleave a line.  The file's records are the JAX package's: each package's
:func:`summarize_telemetry` (copied whole, record types the port does not write yet
included) digests the other's files the same.

Stated difference: the JAX ``install_jax_event_bridge`` forwards ``jax.monitoring``
events (compilation-cache hits and misses, compile durations).  The port compiles no
programs; what it builds is its CUDA kernels (``ops/_build.py``: a library found by
its content hash, or an ``nvcc`` build and its seconds).  :func:`install_torch_event_
bridge` forwards those build events through ``_build``'s listener list into families
shaped like the JAX ones:

* ``nanofed_torch_events_total{event=...}`` — occurrence counters; events
  ``/nanofed_torch/kernel_build/cache_hits`` and ``.../cache_misses``;
* ``nanofed_torch_event_duration_seconds{event=...}`` — durations; event
  ``/nanofed_torch/kernel_build/nvcc_seconds``.

No ``nanofed_jax_*`` family is emitted.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from pathlib import Path
from typing import Any

from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry
from nanofed_tpu_torch.observability.spans import SpanRecord, SpanTracer

TELEMETRY_FILENAME = "telemetry.jsonl"


class RunTelemetry:
    """One run's telemetry sink: a tracer wired to stream spans into
    ``<run_dir>/telemetry.jsonl``, plus typed record appends for round results.

    Usage (what both coordinators do)::

        tel = RunTelemetry(run_dir)
        with tel.span("round", round=r):
            with tel.span("local-train"):
                ...
        tel.record("round", round=r, status="COMPLETED", duration_s=1.2)
        ...
        tel.close()   # appends the final metrics_snapshot record
    """

    def __init__(
        self,
        run_dir: str | Path,
        registry: MetricsRegistry | None = None,
        annotate_device: bool = True,
    ) -> None:
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / TELEMETRY_FILENAME
        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        # O_APPEND fd + ONE os.write per record: the kernel makes each append
        # atomic at the file offset, so records never interleave mid-line even
        # when SEVERAL RunTelemetry instances (concurrent tenant engines) share
        # one telemetry.jsonl — a stdio handle only guarantees whole lines per
        # HANDLE, and flushes above the buffer size split into multiple writes.
        self._fd = os.open(
            str(self.path), os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644
        )
        self._closed = False
        self.tracer = SpanTracer(
            registry=self.registry,
            on_close=self._on_span_close,
            annotate_device=annotate_device,
        )

    def span(self, name: str, **attrs: Any):
        return self.tracer.span(name, **attrs)

    def _on_span_close(self, record: SpanRecord) -> None:
        self.record("span", **record.to_dict())

    def record(self, record_type: str, **fields: Any) -> None:
        """Append one typed JSON line; silently a no-op after ``close()`` (a late
        straggler span must not raise inside a finally block)."""
        # Wall time: the `t` stamp lines telemetry.jsonl up against external logs.
        line = json.dumps({"type": record_type, "t": round(time.time(), 3), **fields})
        with self._lock:
            if self._closed:
                return
            os.write(self._fd, (line + "\n").encode("utf-8"))

    def close(self) -> None:
        """Append the final registry snapshot and release the file handle.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            snapshot = json.dumps(
                {"type": "metrics_snapshot", "t": round(time.time(), 3),
                 "metrics": self.registry.snapshot()}
            )
            os.write(self._fd, (snapshot + "\n").encode("utf-8"))
            self._closed = True
            os.close(self._fd)


_torch_bridge_installed = False
_torch_bridge_lock = threading.Lock()

#: The bridge's metric families (stated difference: the JAX package's are
#: ``nanofed_jax_events_total`` and ``nanofed_jax_event_duration_seconds``).
TORCH_EVENTS_TOTAL = "nanofed_torch_events_total"
TORCH_EVENT_DURATIONS = "nanofed_torch_event_duration_seconds"


def _sanitize_event(event: str) -> str:
    """Event names are slash-paths; keep them readable as label VALUES but drop
    anything exotic."""
    return re.sub(r"[^a-zA-Z0-9_/.:-]", "_", event)


def install_torch_event_bridge(registry: MetricsRegistry | None = None) -> bool:
    """Forward the kernel-build events of ``ops._build`` (``ops._build``) into the registry
    (idempotent, process-wide):

    * ``nanofed_torch_events_total{event=...}`` — a library found by its content hash
      (``/nanofed_torch/kernel_build/cache_hits``) or built by ``nvcc``
      (``/nanofed_torch/kernel_build/cache_misses``);
    * ``nanofed_torch_event_duration_seconds{event=...}`` — each ``nvcc`` build's
      seconds (``/nanofed_torch/kernel_build/nvcc_seconds``).

    Only ever installs against ONE registry (the first caller's): the listener list
    keeps listeners for the process, so re-installing per run would double-count.
    Returns True once installed."""
    global _torch_bridge_installed
    with _torch_bridge_lock:
        if _torch_bridge_installed:
            return True
        from nanofed_tpu_torch.ops import _build

        reg = registry or get_registry()
        events = reg.counter(
            TORCH_EVENTS_TOTAL,
            "Kernel-build occurrence events (library cache hits/misses, ...)",
            labels=("event",),
        )
        durations = reg.histogram(
            TORCH_EVENT_DURATIONS,
            "Kernel-build duration events (nvcc builds)",
            labels=("event",),
        )

        def _on_event(event: str, **fields: Any) -> None:
            events.inc(event=_sanitize_event(event))
            if "seconds" in fields:
                durations.observe(float(fields["seconds"]),
                                  event=_sanitize_event(_build.BUILD_SECONDS_EVENT))

        _build.add_build_listener(_on_event)
        _torch_bridge_installed = True
        return True


def find_latest_telemetry(root: str | Path) -> Path | None:
    """The most recently modified ``telemetry.jsonl`` under ``root`` (``root`` may
    also point directly at a run dir or at the file itself)."""
    root = Path(root)
    if root.is_file():
        return root
    direct = root / TELEMETRY_FILENAME
    if direct.exists():
        return direct
    candidates = sorted(
        root.glob(f"**/{TELEMETRY_FILENAME}"), key=lambda p: p.stat().st_mtime
    )
    return candidates[-1] if candidates else None


def summarize_telemetry(path: str | Path) -> dict[str, Any]:
    """Digest one ``telemetry.jsonl``: per-phase span stats (count/total/mean/p50/max),
    round outcomes, and headline counters from the final metrics snapshot.  This is
    the ``nanofed-tpu-torch metrics-summary`` subcommand's engine — pure, so it is
    unit-testable without running a federation."""
    path = Path(path)
    spans: dict[str, list[float]] = {}
    rounds: dict[str, int] = {}
    round_durations: list[float] = []
    segment_durations: dict[str, list[float]] = {}
    clock_syncs: list[dict[str, Any]] = []
    snapshot: dict[str, Any] | None = None
    program_profiles: dict[str, dict[str, Any]] = {}
    loadtests: dict[str, dict[str, Any]] = {}
    autotunes: dict[str, dict[str, Any]] = {}
    audits: dict[str, dict[str, Any]] = {}
    topology: dict[str, Any] | None = None
    host_failures: list[dict[str, Any]] = []
    recoveries: list[dict[str, Any]] = []
    tenants: dict[str, dict[str, Any]] = {}
    fleets: dict[str, dict[str, Any]] = {}
    federations: list[dict[str, Any]] = []
    adapter: dict[str, Any] = {}
    compile_events: list[dict[str, Any]] = []
    retune_events: list[dict[str, Any]] = []
    retune_final: dict[str, Any] | None = None
    malformed = 0
    with path.open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                malformed += 1  # a crash mid-write leaves at most one torn tail line
                continue
            rtype = rec.get("type")
            if rtype == "span":
                spans.setdefault(rec.get("name", "?"), []).append(
                    float(rec.get("duration_s", 0.0))
                )
            elif rtype == "round":
                status = str(rec.get("status", "?"))
                rounds[status] = rounds.get(status, 0) + 1
                if "duration_s" in rec:
                    round_durations.append(float(rec["duration_s"]))
                # Critical-path decomposition (observability.critical_path):
                # federate workers attach per-round segment timings that tile
                # the round walltime — accumulate per segment for the digest.
                for seg, v in (rec.get("segments") or {}).items():
                    segment_durations.setdefault(str(seg), []).append(float(v))
            elif rtype == "metrics_snapshot":
                snapshot = rec.get("metrics")
            elif rtype == "program_profile":
                # Last record per program wins (a re-profile supersedes): keep
                # the cost/roofline fields the summary table prints.
                program_profiles[str(rec.get("program", "?"))] = {
                    k: rec[k]
                    for k in (
                        "rounds", "flops", "flops_per_round", "bytes_accessed",
                        "peak_bytes", "arithmetic_intensity", "verdict",
                        "lower_bound_s", "compile_seconds", "platform",
                    )
                    if k in rec
                }
            elif rtype == "autotune":
                # Cost-model sweep outcome (nanofed_tpu.tuning), keyed by the
                # sweep's cache key so re-sweeps of the same configuration
                # supersede — same last-wins policy as program_profile.
                autotunes[str(rec.get("cache_key", "?"))[:16]] = {
                    k: rec[k]
                    for k in (
                        "winner", "scoring_basis", "platform", "device_kind",
                        "num_devices", "candidates_total",
                        "candidates_feasible", "cache_hit", "compiles",
                        "compile_seconds_total", "best_score",
                    )
                    if k in rec
                }
            elif rtype == "audit":
                # Program-auditor verdict (analysis.program_audit via
                # Coordinator.audit_programs or the CLI `audit` subcommand):
                # last record per program wins (a re-audit supersedes) — the
                # same policy as program_profile.  The digest keeps the
                # verdict, the findings, and the collective-schedule shape.
                audits[str(rec.get("program", "?"))] = {
                    k: rec[k]
                    for k in (
                        "ok", "findings", "schedule", "mesh_axes", "checks",
                        "compiled",
                    )
                    if k in rec
                }
            elif rtype == "topology":
                # Host/process geometry of the run (multi-host federation):
                # single-host runs record process_count/hosts of 1, they don't
                # omit the block — the ROADMAP item-1 evidence convention.
                topology = {
                    k: rec[k]
                    for k in (
                        "process_count", "hosts", "mesh_shape", "devices",
                        "num_clients",
                    )
                    if k in rec
                }
            elif rtype == "host_failure":
                # One detected host-level failure (parallel.resilience /
                # the hostchaos supervisor): who died, how, when.
                host_failures.append({
                    k: rec[k]
                    for k in (
                        "kind", "host", "round", "generation",
                        "detection_s", "detail",
                    )
                    if k in rec
                })
            elif rtype == "recovery":
                # One completed elastic recovery: the MTTR evidence record —
                # since the flight recorder, MTTR arrives decomposed into
                # named phases (detect/reap/respawn/bring_up/recompile) with
                # a pointer to the dumped ring.
                recoveries.append({
                    k: rec[k]
                    for k in (
                        "recovery_s", "resumed_generation", "resumed_round",
                        "rounds_lost", "hosts_before", "hosts_after",
                        "reshape", "rejoin", "mttr_phases", "flight_recorder",
                    )
                    if k in rec
                })
            elif rtype == "clock_sync":
                # A federate worker's bring-up-barrier epoch: the wall time at
                # its warm-psum anchor.  The barrier makes these simultaneous
                # across hosts, so the spread IS the cross-host clock skew the
                # timeline merger subtracts.
                clock_syncs.append({
                    k: rec[k]
                    for k in ("host", "anchor_wall", "process_id")
                    if k in rec
                })
            elif rtype == "tenant":
                # Multi-tenant service layer (nanofed_tpu.service): one
                # tenant's headline numbers, keyed by tenant name; last
                # record per tenant wins (a re-run supersedes) — same
                # policy as loadtest/program_profile.
                tenants[str(rec.get("tenant", "?"))] = {
                    k: rec[k]
                    for k in (
                        "model", "algorithm", "rounds_completed",
                        "rounds_failed", "rounds_per_sec", "p99_s",
                        "http_429_total", "chaos_injected_total",
                        "failed_submits",
                    )
                    if k in rec
                }
            elif rtype == "fleet":
                # Heterogeneous fleet layer (nanofed_tpu.fleet): one fleet
                # run's headline numbers keyed by profile name; last record
                # per profile wins (a re-run supersedes) — same policy as
                # tenant/loadtest.
                fleets[str(rec.get("profile", "?"))] = {
                    k: rec[k]
                    for k in (
                        "tiers", "population", "max_rank", "accepted_total",
                        "failed_total", "rejected_429_total",
                        "wire_bytes_by_tier", "p99_s_by_tier",
                        "parity_max_abs_diff", "aggregate_route", "rounds",
                    )
                    if k in rec
                }
            elif rtype == "adapter":
                # Parameter-efficient federation (nanofed_tpu.adapters):
                # records accumulate by FIELD (different emitters own
                # different fields — the Coordinator the rank/size split and
                # final merge count, the wire harnesses the measured
                # full-vs-adapter payload bytes), last value per field wins.
                adapter.update({
                    k: rec[k]
                    for k in (
                        "rank", "alpha", "targets", "adapter_params",
                        "base_params", "ratio", "merges",
                        "payload_bytes_full", "payload_bytes_adapter",
                        "payload_reduction", "wire_bytes_full_round",
                        "wire_bytes_adapter_round", "wire_reduction",
                        "encoding",
                    )
                    if k in rec
                })
            elif rtype == "federation":
                # Fused wire→mesh campaigns (multihost_harness federate):
                # one record per campaign — population, mesh geometry before/
                # after chaos, round throughput, submit p99, and the reroute
                # + zero-lost-submits accounting.  Campaigns accumulate (a
                # telemetry dir may hold a no-chaos run and a kill drill).
                federations.append({
                    k: rec[k]
                    for k in (
                        "wire_clients", "hosts", "survivors", "rounds",
                        "rounds_per_sec", "p99_submit_s", "accepted",
                        "duplicates", "failed", "reroutes",
                        "rerouted_updates_drained",
                        "terminated_early_redriven", "zero_lost_submits",
                        "host_killed", "kill_round",
                    )
                    if k in rec
                })
            elif rtype == "compile":
                # One XLA compile paid by the autotune sweep / warm pass
                # (tuning.autotuner / tuning.compile_cache): which program,
                # how long — the compile-wall evidence stream.
                compile_events.append({
                    k: rec[k]
                    for k in ("program", "seconds", "cache_key")
                    if k in rec
                })
            elif rtype == "retune":
                # One online-retune verdict (tuning.retuner via the
                # Coordinator): swap or hold, with the measured basis; the
                # `considered` table stays in the raw telemetry — the digest
                # keeps the verdict line.
                retune_events.append({
                    k: rec[k]
                    for k in (
                        "round", "swap", "applied", "old_program",
                        "new_program", "measured_s_per_round",
                        "candidate_s_per_round", "delta", "basis", "reason",
                    )
                    if k in rec
                })
            elif rtype == "retune_summary":
                # Run-end retuner digest (last wins): decision/swap counts,
                # the measured table, and the cache entry written back.
                retune_final = {
                    k: rec[k]
                    for k in (
                        "decisions", "swaps", "hysteresis", "measured",
                        "cache_entry",
                    )
                    if k in rec
                }
            elif rtype == "loadtest":
                # Swarm-harness headline numbers (nanofed_tpu.loadgen), keyed
                # by serving path; last record per mode wins (a re-run
                # supersedes) — same policy as program_profile above.
                loadtests[str(rec.get("mode", "?"))] = {
                    k: rec[k]
                    for k in (
                        "clients", "total_submits", "p50_s", "p99_s",
                        "rounds_per_sec", "aggregations_completed",
                        "http_429_total", "retries_total", "accepted",
                    )
                    if k in rec
                }

    def _digest(durs: list[float]) -> dict[str, float]:
        durs = sorted(durs)
        n = len(durs)
        return {
            "count": n,
            "total_s": round(math.fsum(durs), 6),
            "mean_s": round(math.fsum(durs) / n, 6),
            "p50_s": round(durs[n // 2], 6),
            "max_s": round(durs[-1], 6),
        }

    out: dict[str, Any] = {
        "telemetry": str(path),
        "rounds": rounds,
        "phases": {name: _digest(d) for name, d in sorted(spans.items())},
    }
    if topology is not None:
        out["topology"] = topology
    if round_durations:
        out["round_duration"] = _digest(round_durations)
    if segment_durations:
        # Critical-path layer (observability.critical_path): where round
        # walltime actually goes — wire_wait / decode / drain / collective /
        # apply / publish, digested per segment across all rounds seen.
        out["critical_path"] = {
            seg: _digest(d) for seg, d in sorted(segment_durations.items())
        }
    if clock_syncs:
        walls = sorted(
            float(c["anchor_wall"]) for c in clock_syncs if "anchor_wall" in c
        )
        out["clock_sync"] = {
            "hosts": len(clock_syncs),
            **({"anchor_spread_s": round(walls[-1] - walls[0], 6)}
               if walls else {}),
        }
    if program_profiles:
        # Compiled-program cost layer (observability.profiling): per-program
        # compiler FLOPs, peak device bytes, and the roofline verdict.
        out["program_profiles"] = dict(sorted(program_profiles.items()))
    if loadtests:
        # Load-harness layer (nanofed_tpu.loadgen): per-serving-path submit
        # latency percentiles and server rounds/sec.
        out["loadtests"] = dict(sorted(loadtests.items()))
    if autotunes:
        # Autotuner layer (nanofed_tpu.tuning): the winner config, scoring
        # basis, and sweep economics per swept configuration.
        out["autotunes"] = dict(sorted(autotunes.items()))
    if audits:
        # Program-audit layer (analysis.program_audit): per-program verdict
        # on collective schedules, mesh discipline, donation, dtype drift,
        # and host transfers — plus a headline clean/dirty count.
        out["audits"] = {
            "programs": dict(sorted(audits.items())),
            "clean": sum(1 for a in audits.values() if a.get("ok")),
            "dirty": sum(1 for a in audits.values() if not a.get("ok")),
        }
    if adapter:
        # Parameter-efficient federation (nanofed_tpu.adapters): rank, the
        # trainable-vs-frozen split, merge count, and — when a wire harness
        # ran — the measured full-vs-adapter wire bytes per round.
        out["adapter"] = adapter
    if tenants:
        # Multi-tenant service layer (nanofed_tpu.service): per-tenant
        # rounds, p99 submit latency, 429s, and chaos hits — the isolation
        # story in one block.
        out["tenants"] = dict(sorted(tenants.items()))
    if fleets:
        # Heterogeneous fleet layer (nanofed_tpu.fleet): per-profile tier
        # mix, per-tier wire bytes and submit p99, and the dense-vs-padded
        # aggregation parity — the tiered-federation story in one block.
        out["fleets"] = dict(sorted(fleets.items()))
    if federations:
        # One-stack layer (multihost_harness federate): wire swarm → per-host
        # ingest drains → one cross-host psum per round, with the chaos
        # reroute ledger — the wire-to-mesh fusion story in one block.
        out["federations"] = {
            "count": len(federations),
            "zero_lost_submits": all(
                f.get("zero_lost_submits") for f in federations
            ),
            "campaigns": federations,
        }
    if host_failures:
        # Host fault-tolerance layer (parallel.resilience): every detected
        # host failure, by kind, plus the recovery outcomes with MTTR — a
        # hostchaos run's telemetry digests to "what died, how fast did the
        # mesh come back".
        by_kind: dict[str, int] = {}
        for f in host_failures:
            kind = str(f.get("kind", "?"))
            by_kind[kind] = by_kind.get(kind, 0) + 1
        out["host_failures"] = {"by_kind": by_kind, "events": host_failures}
    if recoveries:
        mttrs = [float(r["recovery_s"]) for r in recoveries if "recovery_s" in r]
        out["recoveries"] = {
            "count": len(recoveries),
            "events": recoveries,
        }
        if mttrs:
            out["recoveries"]["mttr"] = _digest(mttrs)
    if compile_events:
        # Compile-wall layer (tuning.autotuner / tuning.compile_cache): what
        # the sweep/warm pass paid per program — the budget-pruning and
        # warm-cache stories read straight off this block.
        secs = [float(e.get("seconds", 0.0)) for e in compile_events]
        out["compiles"] = {
            "count": len(compile_events),
            "total_s": round(math.fsum(secs), 4),
            "max_s": round(max(secs), 4),
            "by_program": {
                str(e.get("program", "?")): round(float(e.get("seconds", 0.0)), 4)
                for e in sorted(
                    compile_events, key=lambda e: str(e.get("program", "?"))
                )
            },
        }
    if retune_events or retune_final is not None:
        # Online-retuning layer (tuning.retuner): every boundary verdict plus
        # the run-end digest — "did the measurements overrule the AOT pick".
        proposed = [e for e in retune_events if e.get("swap")]
        out["retunes"] = {
            "decisions": len(retune_events),
            "swaps_proposed": len(proposed),
            "swaps_applied": sum(1 for e in proposed if e.get("applied")),
            "events": retune_events,
            **({"final": retune_final} if retune_final is not None else {}),
        }
    if snapshot is not None:
        headline = {}
        for name in ("nanofed_rounds_total", "nanofed_bytes_received_total",
                     "nanofed_bytes_sent_total", "nanofed_updates_total",
                     "nanofed_dropouts_total"):
            if name in snapshot:
                headline[name] = snapshot[name]["values"]
        out["counters"] = headline
    if malformed:
        out["malformed_lines"] = malformed
    return out
