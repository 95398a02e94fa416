"""The packaged multi-tenant experiment: N tenants, measured, against sequential
(counterpart of ``nanofed_tpu/service/harness.py``).

:func:`run_tenant_service` hosts a :class:`~nanofed_tpu_torch.service.FederationService`
with N tenants (distinct models, algorithms and serving paths), drives one synthetic
swarm per tenant against its ``/t/<name>`` prefix, and reduces the outcome to:

* **aggregate rounds/s, concurrent against sequential**: the same jobs once
  concurrently (one service, scheduler-interleaved) and once one tenant at a time;
* **each tenant's p99 submit latency under chaos**: a seeded wire-fault storm (drops,
  lost-ACK retry storms, delays) aimed at exactly one tenant;
* **isolation**: the untargeted tenants must lose zero rounds and zero submits.

One ``runs/tenants_*.json`` artifact holds all three, plus one ``tenant`` telemetry
record a tenant (``metrics-summary`` digests them into its ``tenants`` block).
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from pathlib import Path
from typing import Any

from nanofed_tpu_torch.communication.transport import tenant_base_url
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.faults.plan import FaultEvent, FaultPlan
from nanofed_tpu_torch.loadgen.harness import environment
from nanofed_tpu_torch.loadgen.swarm import SwarmConfig, latency_digest, run_swarm
from nanofed_tpu_torch.service.service import FederationService, free_port
from nanofed_tpu_torch.service.tenant import TenantQuota, TenantSpec
from nanofed_tpu_torch.utils.aio import spawn_logged
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock, VirtualClock
from nanofed_tpu_torch.utils.logger import Logger

__all__ = [
    "default_tenant_specs",
    "run_tenant_service",
    "tenant_storm_plan",
]

_LOG = Logger()

#: Real-time grace for the round engines' tail rounds after the swarms drained.
_SERVICE_GRACE_S = 120.0

#: The default roster's (model, algorithm, serving path) jobs, the JAX package's.
_DEFAULT_JOBS: tuple[dict[str, Any], ...] = (
    {"model": "digits_mlp", "algorithm": "fedbuff", "ingest_capacity": 128},
    {"model": "mlp", "algorithm": "fedbuff", "ingest_capacity": 0},
    {"model": "linear", "algorithm": "fedavg", "ingest_capacity": 0},
)

_NAMES = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel")


def default_tenant_specs(
    tenants: int = 3,
    *,
    rounds: int = 4,
    async_buffer_k: int = 16,
    min_clients: int = 8,
    round_timeout_s: float = 120.0,
    max_inflight: int | None = 256,
    seed: int = 0,
) -> list[TenantSpec]:
    """N tenant jobs cycling through the roster: tenant 0 ingest FedBuff on
    ``digits_mlp``, tenant 1 per-submit FedBuff on ``mlp``, tenant 2 sync FedAvg on
    ``linear``."""
    specs = []
    for i in range(tenants):
        job = _DEFAULT_JOBS[i % len(_DEFAULT_JOBS)]
        name = _NAMES[i] if i < len(_NAMES) else f"tenant{i}"
        specs.append(TenantSpec(
            name=name, model=job["model"], algorithm=job["algorithm"], rounds=rounds,
            async_buffer_k=async_buffer_k, min_clients=min_clients,
            round_timeout_s=round_timeout_s, seed=seed + i,
            quota=TenantQuota(max_inflight=max_inflight,
                              ingest_capacity=job["ingest_capacity"]),
        ))
    return specs


def tenant_storm_plan(
    seed: int,
    num_clients: int,
    rounds: int,
    *,
    drop_fraction: float = 0.15,
    ack_drop_fraction: float = 0.10,
    delay_fraction: float = 0.10,
    delay_s: float = 0.2,
) -> FaultPlan:
    """A seeded wire-fault storm against ONE tenant's swarm: ``drop`` (severed before
    the handler, the client retries), ``ack_drop`` (buffered, the ACK severed: the
    client re-sends the same key, a real duplicate retry storm) and ``delay``.  Every
    drawn client meets its fault on every round or version it might stamp (an
    asynchronous tenant's version advances with load); unfired events are never
    consumed.  ``random.Random`` draws, the JAX package's event for event."""
    rng = random.Random(seed)
    ids = [f"swarm_{i}" for i in range(num_clients)]
    events: list[FaultEvent] = []
    # +2: versions reach `rounds` (the final publish), and a straggler's refresh can
    # stamp one past it.
    span = rounds + 2

    def pick(fraction: float) -> list[str]:
        k = round(fraction * len(ids))
        return rng.sample(ids, k) if k else []

    for cid in pick(drop_fraction):
        for r in range(span):
            events.append(FaultEvent(kind="drop", round=r, client=cid))
    for cid in pick(ack_drop_fraction):
        for r in range(span):
            events.append(FaultEvent(kind="ack_drop", round=r, client=cid))
    for cid in pick(delay_fraction):
        for r in range(span):
            events.append(FaultEvent(kind="delay", round=r, client=cid, seconds=delay_s))
    return FaultPlan(seed=seed, events=tuple(events))


async def _drive(
    specs: list[TenantSpec],
    *,
    clock: Clock,
    swarm_configs: dict[str, SwarmConfig],
    hbm_budget_bytes: int | None,
    profile_programs: bool,
    telemetry_dir: Any | None,
    device: Any,
) -> dict[str, Any]:
    """One service hosting ``specs`` concurrently and one swarm per tenant; returns the
    tenant summaries, the swarm digests, the wall and the scheduler's stats."""
    service = FederationService(port=free_port(), clock=clock,
                                hbm_budget_bytes=hbm_budget_bytes,
                                telemetry_dir=telemetry_dir,
                                profile_programs=profile_programs, device=device)
    sessions = {spec.name: service.add_tenant(spec) for spec in specs}
    await service.start()
    base = f"http://127.0.0.1:{service.transport.port}"
    try:
        t0 = time.perf_counter()
        # spawn_logged: the timeout path below cancels and swallows; a real service
        # crash keeps its traceback in the log.
        run_task = spawn_logged(service.run(), name="tenant-service")
        swarm_results = await asyncio.gather(*(
            run_swarm(tenant_base_url(base, spec.name), sessions[spec.name].params,
                      swarm_configs[spec.name], clock=clock,
                      registry=sessions[spec.name].registry)
            for spec in specs
        ))
        try:
            summaries = await asyncio.wait_for(asyncio.shield(run_task),
                                               timeout=_SERVICE_GRACE_S)
        except asyncio.TimeoutError:
            _LOG.warning("tenant service still running %.0fs after the swarms drained; "
                         "cancelling (tail rounds dropped)", _SERVICE_GRACE_S)
            run_task.cancel()
            try:
                await run_task
            except (asyncio.CancelledError, Exception):
                pass
            summaries = {spec.name: sessions[spec.name].summary() for spec in specs}
        wall = time.perf_counter() - t0
    finally:
        await service.stop()
    swarms = {}
    for spec, res in zip(specs, swarm_results):
        swarms[spec.name] = {
            "submit_latency_s": latency_digest(res.latencies_s),
            "accepted": res.accepted,
            "duplicates": res.duplicates,
            "rejected_429": res.rejected_429,
            "retries": res.retries,
            "stale_refreshes": res.stale_refreshes,
            "failed_submits": res.failed,
            "terminated_early": res.terminated_early,
        }
    return {"tenants": summaries, "swarms": swarms, "wall_s": round(wall, 4),
            "scheduler": service.scheduler.stats()}


def run_tenant_service(
    specs: list[TenantSpec] | None = None,
    *,
    tenants: int = 3,
    rounds: int = 4,
    clients_per_tenant: int = 40,
    submits_per_client: int = 2,
    async_buffer_k: int = 16,
    arrival: str = "poisson",
    arrival_rate: float = 500.0,
    chaos_tenant: str | None | bool = True,
    chaos_seed: int = 7,
    virtual_clock: bool = True,
    sequential_baseline: bool = True,
    hbm_budget_bytes: int | None = None,
    profile_programs: bool = True,
    seed: int = 0,
    out_dir: str | Path | None = "runs",
    telemetry_dir: str | Path | None = None,
    tag: str | None = None,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """Run the multi-tenant experiment and write ONE artifact.

    ``chaos_tenant=True`` aims the storm at the first tenant; a name aims it, and
    None or False runs clean.  ``sequential_baseline`` re-runs the same jobs one tenant
    at a time (a fresh clock and service each) and records both aggregate rates.
    Every tenant runs on ``device`` (None means the card)."""
    dev = resolve_device(device)
    if specs is None:
        specs = default_tenant_specs(tenants, rounds=rounds, async_buffer_k=async_buffer_k,
                                     min_clients=min(8, clients_per_tenant), seed=seed)
    if chaos_tenant is True:
        chaos_tenant = specs[0].name
    elif chaos_tenant is False:
        chaos_tenant = None
    if chaos_tenant is not None:
        names = [s.name for s in specs]
        if chaos_tenant not in names:
            raise ValueError(f"chaos_tenant {chaos_tenant!r} is not a tenant ({names})")
        specs = [s if s.name != chaos_tenant else _with_chaos(
                     s, tenant_storm_plan(chaos_seed, clients_per_tenant, s.rounds))
                 for s in specs]
    swarm_configs = {
        s.name: SwarmConfig(num_clients=clients_per_tenant,
                            submits_per_client=submits_per_client, arrival=arrival,
                            arrival_rate=arrival_rate, seed=seed + i)
        for i, s in enumerate(specs)
    }

    def _clock() -> Clock:
        return VirtualClock() if virtual_clock else SYSTEM_CLOCK

    _LOG.info("tenant service: %d tenants concurrent ...", len(specs))
    concurrent = asyncio.run(_drive(
        specs, clock=_clock(), swarm_configs=swarm_configs,
        hbm_budget_bytes=hbm_budget_bytes, profile_programs=profile_programs,
        telemetry_dir=telemetry_dir, device=dev))
    sequential: dict[str, Any] | None = None
    if sequential_baseline:
        per_tenant: dict[str, Any] = {}
        seq_wall = 0.0
        seq_completed = 0
        for spec in specs:
            _LOG.info("tenant service: sequential baseline %s ...", spec.name)
            one = asyncio.run(_drive(
                [spec], clock=_clock(), swarm_configs={spec.name: swarm_configs[spec.name]},
                hbm_budget_bytes=hbm_budget_bytes, profile_programs=profile_programs,
                telemetry_dir=None, device=dev))
            per_tenant[spec.name] = {
                "wall_s": one["wall_s"],
                "rounds_completed": one["tenants"][spec.name]["rounds_completed"],
                "scheduler": one["scheduler"]["tenants"][spec.name],
            }
            seq_wall += one["wall_s"]
            seq_completed += one["tenants"][spec.name]["rounds_completed"]
        sequential = {
            "wall_s": round(seq_wall, 4),
            "rounds_completed": seq_completed,
            "aggregate_rounds_per_sec": (round(seq_completed / seq_wall, 4)
                                         if seq_wall > 0 else None),
            "per_tenant": per_tenant,
        }
    conc_completed = sum(t["rounds_completed"] for t in concurrent["tenants"].values())
    conc_rps = (round(conc_completed / concurrent["wall_s"], 4)
                if concurrent["wall_s"] > 0 else None)
    untargeted = [s.name for s in specs if s.name != chaos_tenant]
    isolation = {
        name: {
            "rounds_lost": (concurrent["tenants"][name]["rounds_target"]
                            - concurrent["tenants"][name]["rounds_completed"]),
            "failed_submits": concurrent["swarms"][name]["failed_submits"],
        }
        for name in untargeted
    }
    artifact: dict[str, Any] = {
        "record_type": "tenants",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "env": environment(dev),
        "clock": "virtual" if virtual_clock else "system",
        "clients_per_tenant": clients_per_tenant,
        "submits_per_client": submits_per_client,
        "chaos_tenant": chaos_tenant,
        "tenants": {name: {**summary, **concurrent["swarms"][name]}
                    for name, summary in concurrent["tenants"].items()},
        "scheduler": concurrent["scheduler"],
        "concurrent": {
            "wall_s": concurrent["wall_s"],
            "rounds_completed": conc_completed,
            "aggregate_rounds_per_sec": conc_rps,
        },
        "isolation": {
            "untargeted": isolation,
            "zero_rounds_lost": all(v["rounds_lost"] == 0 for v in isolation.values()),
            "zero_failed_submits": all(v["failed_submits"] == 0
                                       for v in isolation.values()),
        },
    }
    if sequential is not None:
        artifact["sequential"] = sequential
        if conc_rps and sequential["aggregate_rounds_per_sec"]:
            artifact["concurrent_over_sequential"] = round(
                conc_rps / sequential["aggregate_rounds_per_sec"], 4)
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        stamp = tag or time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = out / f"tenants_{stamp}.json"
        path.write_text(json.dumps(artifact, indent=2) + "\n")
        artifact["artifact_path"] = str(path)
        _LOG.info("tenants artifact: %s", path)
    if telemetry_dir is not None:
        from nanofed_tpu_torch.observability.telemetry import RunTelemetry

        tel = RunTelemetry(telemetry_dir)
        try:
            for name, rec in artifact["tenants"].items():
                lat = rec["submit_latency_s"]
                tel.record("tenant", tenant=name, model=rec["model"],
                           algorithm=rec["algorithm"],
                           rounds_completed=rec["rounds_completed"],
                           rounds_failed=rec["rounds_failed"],
                           rounds_per_sec=rec["rounds_per_sec"], p99_s=lat["p99_s"],
                           http_429_total=rec["http_429_total"],
                           chaos_injected_total=rec["chaos_injected_total"],
                           failed_submits=rec["failed_submits"])
        finally:
            tel.close()
    return artifact


def _with_chaos(spec: TenantSpec, plan: FaultPlan) -> TenantSpec:
    from dataclasses import replace

    return replace(spec, chaos_plan=plan)
