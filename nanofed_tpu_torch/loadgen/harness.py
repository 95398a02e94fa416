"""The packaged load experiment: server, round engine and swarm, measured (counterpart
of ``nanofed_tpu/loadgen/harness.py``).

:func:`run_loadtest` hosts an in-process ``HTTPServer`` and ``NetworkCoordinator`` in
asynchronous FedBuff mode (aggregations fire on buffer fill, no cohort barrier), drives
a :class:`~nanofed_tpu_torch.loadgen.swarm.SwarmConfig` population against it, and
reduces the outcome to p50/p99 submit latency, server rounds/s, 429 and retry counts
and the decode pool's utilization.  :func:`run_loadtest_comparison` runs the
per-submit and the ingest serving paths back to back on identical traffic and writes
one ``runs/loadtest_*.json`` artifact holding both records and the rounds/s ratio,
plus ``loadtest`` telemetry records that ``metrics-summary`` digests.

The round engine and the ingest buffer run on ``device`` (None means the card).
Params are the port's model init from ``seed`` (torch's generator, not the JAX
package's key), so their values differ from the JAX package's; the traffic (arrivals,
weights, noise) is the same draw.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path
from typing import Any

import torch

from nanofed_tpu_torch.communication.http_server import HTTPServer
from nanofed_tpu_torch.communication.network_coordinator import (
    NetworkCoordinator,
    NetworkRoundConfig,
)
from nanofed_tpu_torch.communication.transport import free_port as _free_port
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.loadgen.swarm import SwarmConfig, latency_digest, run_swarm
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.utils.aio import spawn_logged
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock, VirtualClock
from nanofed_tpu_torch.utils.logger import Logger

__all__ = ["run_loadtest", "run_loadtest_comparison"]

_LOG = Logger()

#: Real-time grace for the round engine's tail aggregations after the swarm drained
#: (a backstop: virtual-clock runs expire their timeouts in milliseconds).
_COORDINATOR_GRACE_S = 60.0


def _counter_total(snapshot: dict[str, Any], name: str) -> float:
    values = snapshot.get(name, {}).get("values", {})
    return float(sum(values.values())) if isinstance(values, dict) else 0.0


def environment(device: torch.device) -> dict[str, Any]:
    """The artifact's ``env`` block: torch's version, the device type and the count of
    cards (the JAX artifact's ``jax``, ``backend`` and ``device_count``)."""
    return {
        "torch": torch.__version__,
        "backend": device.type,
        "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
    }


def run_loadtest(
    *,
    mode: str = "ingest",
    clients: int = 10_000,
    submits_per_client: int = 1,
    model: str = "digits_mlp",
    async_buffer_k: int = 64,
    aggregations: int | None = None,
    ingest_capacity: int = 1024,
    decode_workers: int = 4,
    max_inflight: int | None = 512,
    arrival: str = "poisson",
    arrival_rate: float = 2000.0,
    weight_skew: float = 0.0,
    staleness_window: int = 4,
    round_timeout_s: float = 120.0,
    virtual_clock: bool = False,
    seed: int = 0,
    port: int | None = None,
    adapter_rank: int | None = None,
    model_kwargs: dict[str, Any] | None = None,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """One measured run of one serving path (``mode`` ``"per-submit"`` or
    ``"ingest"``); returns the per-mode record.  The registry is the run's own, so its
    counters cover exactly this run.  ``adapter_rank`` federates the rank-R LoRA
    adapter tree instead of the model (what clients fetch, the canned payloads, what
    the engine aggregates); the record then carries an ``adapter`` block with the
    measured full-vs-adapter payload bytes."""
    from nanofed_tpu_torch.models import get_model

    if mode not in ("per-submit", "ingest"):
        raise ValueError(f"unknown loadtest mode {mode!r}")
    dev = resolve_device(device)
    total_submits = clients * submits_per_client
    k = min(async_buffer_k, total_submits)
    n_aggs = max(1, total_submits // k) if aggregations is None else aggregations
    mdl = get_model(model, **(model_kwargs or {}))
    params = {name: leaf.to(dev)
              for name, leaf in mdl.init(torch.Generator().manual_seed(seed)).items()}
    adapter_block = None
    if adapter_rank is not None:
        from nanofed_tpu_torch.adapters import AdapterSpec, adapter_param_count, init_adapters
        from nanofed_tpu_torch.communication.codec import encode_params

        spec = AdapterSpec(rank=adapter_rank)
        base = params
        params = init_adapters(spec, base, rng=seed)
        full_bytes = len(encode_params(base))
        adapter_bytes = len(encode_params(params))
        adapter_block = {
            **spec.to_dict(),
            **adapter_param_count(spec, base),
            "payload_bytes_full": full_bytes,
            "payload_bytes_adapter": adapter_bytes,
            "payload_reduction": round(full_bytes / max(adapter_bytes, 1), 2),
        }
    clock: Clock = VirtualClock() if virtual_clock else SYSTEM_CLOCK
    registry = MetricsRegistry()
    swarm_config = SwarmConfig(num_clients=clients, submits_per_client=submits_per_client,
                               arrival=arrival, arrival_rate=arrival_rate,
                               weight_skew=weight_skew, seed=seed)
    ingest_config = None
    if mode == "ingest":
        from nanofed_tpu_torch.ingest import IngestConfig

        ingest_config = IngestConfig(capacity=ingest_capacity,
                                     decode_workers=decode_workers)

    async def _main() -> dict[str, Any]:
        chosen_port = port or _free_port()
        server = HTTPServer(port=chosen_port, registry=registry, max_inflight=max_inflight,
                            clock=clock, ingest=ingest_config, device=dev)
        await server.start()
        coord_wall = 0.0
        try:
            coordinator = NetworkCoordinator(
                server, params,
                NetworkRoundConfig(num_rounds=n_aggs, async_buffer_k=k,
                                   staleness_window=staleness_window,
                                   round_timeout_s=round_timeout_s, poll_interval_s=0.01),
                registry=registry, clock=clock, device=dev,
            )

            async def _timed_run() -> None:
                nonlocal coord_wall
                t = time.perf_counter()
                try:
                    await coordinator.run()
                finally:
                    coord_wall = time.perf_counter() - t

            # spawn_logged: the timeout path below swallows the cancel, so a real
            # coordinator crash keeps its traceback in the log.
            coord_task = spawn_logged(_timed_run(), name="loadtest-coordinator")
            swarm = await run_swarm(f"http://127.0.0.1:{chosen_port}", params, swarm_config,
                                    clock=clock, registry=registry)
            try:
                await asyncio.wait_for(asyncio.shield(coord_task),
                                       timeout=_COORDINATOR_GRACE_S)
            except asyncio.TimeoutError:
                _LOG.warning("loadtest: round engine still running %.0fs after the swarm "
                             "drained; cancelling (tail aggregations dropped)",
                             _COORDINATOR_GRACE_S)
                coord_task.cancel()
                try:
                    await coord_task
                except (asyncio.CancelledError, Exception):
                    pass
            completed = sum(1 for h in coordinator.history if h.get("status") == "COMPLETED")
            failed = len(coordinator.history) - completed
            snapshot = registry.snapshot()
            # The aggregation step's own cost: end-to-end rounds/s is coupled to the
            # arrivals and backoffs, this isolates the server tier.
            span_values = snapshot.get("nanofed_span_duration_seconds", {}).get("values", {})
            agg_span = span_values.get("aggregate")
            aggregate_span = (
                {"count": int(agg_span["count"]), "total_s": round(agg_span["sum"], 4),
                 "mean_s": round(agg_span["sum"] / agg_span["count"], 6)}
                if isinstance(agg_span, dict) and agg_span.get("count") else None
            )
            decode_pool = None
            ingest_block = None
            pipeline = server.ingest_pipeline
            if pipeline is not None:
                busy = pipeline.decode_busy_seconds()
                elapsed = max(coord_wall, swarm.wall_s, 1e-9)
                decode_pool = {"workers": decode_workers, "busy_s": round(busy, 4),
                               "utilization": round(busy / (decode_workers * elapsed), 4)}
                ingest_block = {
                    "capacity": ingest_capacity,
                    "device_bytes": pipeline.buffer.device_bytes,
                    "drains": _counter_total(snapshot, "nanofed_ingest_drains_total"),
                    "offers": snapshot.get("nanofed_ingest_offers_total", {}).get("values", {}),
                }
            return {
                "mode": mode,
                "clients": clients,
                "submits_per_client": submits_per_client,
                "total_submits": total_submits,
                "arrival": arrival,
                "arrival_rate": arrival_rate,
                "weight_skew": weight_skew,
                "async_buffer_k": k,
                "max_inflight": max_inflight,
                "aggregations_target": n_aggs,
                "aggregations_completed": completed,
                "aggregations_failed": failed,
                "coordinator_wall_s": round(coord_wall, 4),
                "swarm_wall_s": round(swarm.wall_s, 4),
                "rounds_per_sec": round(completed / coord_wall, 4) if coord_wall > 0 else None,
                "aggregate_span": aggregate_span,
                "submit_latency_s": latency_digest(swarm.latencies_s),
                "accepted": swarm.accepted,
                "duplicates": swarm.duplicates,
                "http_429_total": _counter_total(snapshot, "nanofed_http_429_total"),
                "client_retries_total": swarm.retries,
                "stale_refreshes": swarm.stale_refreshes,
                "failed_submits": swarm.failed,
                "terminated_early": swarm.terminated_early,
                "decode_pool": decode_pool,
                "ingest": ingest_block,
                "adapter": adapter_block,
                "clock": "virtual" if virtual_clock else "system",
            }
        finally:
            await server.stop()

    return asyncio.run(_main())


def run_loadtest_comparison(
    *,
    modes: tuple[str, ...] = ("per-submit", "ingest"),
    out_dir: str | Path | None = "runs",
    telemetry_dir: str | Path | None = None,
    tag: str | None = None,
    **kwargs: Any,
) -> dict[str, Any]:
    """Run each serving path on identical traffic and write ONE artifact,
    ``<out_dir>/loadtest_<stamp>.json``; with ``telemetry_dir`` each mode's headline
    numbers land as a ``loadtest`` telemetry record."""
    dev = resolve_device(kwargs.get("device"))
    kwargs["device"] = dev
    records: dict[str, Any] = {}
    for mode in modes:
        _LOG.info("loadtest: running %s path ...", mode)
        records[mode] = run_loadtest(mode=mode, **kwargs)
    artifact: dict[str, Any] = {
        "record_type": "loadtest",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "env": environment(dev),
        "modes": records,
    }
    rps = {m: r.get("rounds_per_sec") for m, r in records.items()}
    artifact["rounds_per_sec"] = rps
    if rps.get("per-submit") and rps.get("ingest"):
        artifact["rounds_per_sec_ratio_ingest_over_per_submit"] = round(
            rps["ingest"] / rps["per-submit"], 4)
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        stamp = tag or time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = out / f"loadtest_{stamp}.json"
        path.write_text(json.dumps(artifact, indent=2) + "\n")
        artifact["artifact_path"] = str(path)
        _LOG.info("loadtest artifact: %s", path)
    if telemetry_dir is not None:
        from nanofed_tpu_torch.observability.telemetry import RunTelemetry

        tel = RunTelemetry(telemetry_dir)
        try:
            for mode, rec in records.items():
                lat = rec["submit_latency_s"]
                tel.record("loadtest", mode=mode, clients=rec["clients"],
                           total_submits=rec["total_submits"], p50_s=lat["p50_s"],
                           p99_s=lat["p99_s"], rounds_per_sec=rec["rounds_per_sec"],
                           aggregations_completed=rec["aggregations_completed"],
                           http_429_total=rec["http_429_total"],
                           retries_total=rec["client_retries_total"],
                           accepted=rec["accepted"])
                if rec.get("adapter"):
                    tel.record("adapter", **rec["adapter"])
        finally:
            tel.close()
    return artifact
