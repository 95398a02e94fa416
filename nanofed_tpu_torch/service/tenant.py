"""Per-tenant session state: one federation job, isolated (counterpart of
``nanofed_tpu/service/tenant.py``).

A :class:`TenantSession` is everything ONE tenant's federation consists of: its own
:class:`~nanofed_tpu_torch.communication.http_server.HTTPServer` session (mounted on
the service's shared transport under ``/t/<name>``), its own ``NetworkCoordinator``
round and version state, its own ``MetricsRegistry`` (no counter is shared with
another tenant; the service mirrors headline numbers into ``tenant``-labelled gauges),
its own ``ProgramCatalog`` holding its aggregation program's cost report, its own
ingest buffer and admission quota, and its own chaos schedule.  The isolation the
service claims (a 429 storm, a dedup window, a retry storm or a chaos plan aimed at
tenant A cannot touch tenant B) follows from this layout, not from filtering.

The aggregation program ``base_flat + coefs @ stack`` (``[K, P]``) is profiled at
admission.  Stated difference: the port's profiler RUNS the program and reads the
card's ``max_memory_allocated`` (the JAX one asks XLA's memory analysis, which also
answers on the CPU).  So on the card the footprint's peak is the program's arguments,
outputs and temporaries as that counter measured them; on the CPU, where the profile
reports no peak, the footprint takes the JAX package's analytic bound ``(K + 2) * P *
4`` and says so in its basis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.service.scheduler import TenantFootprint
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger

__all__ = ["TenantQuota", "TenantSpec", "TenantSession"]

_LOG = Logger()


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's resource envelope.

    ``weight`` is the fair-share weight in the round scheduler.  ``max_inflight`` is the
    admission-control bound: submits past it answer 429 from THIS tenant's session
    only.  ``ingest_capacity`` > 0 switches the tenant to the device-resident ingest
    path with that many slots (its bytes count toward the tenant's resident footprint).
    ``ingest_batch`` sizes the JAX package's compiled flush programs; the port compiles
    nothing, so it is kept for the JAX fields and read by nothing."""

    weight: float = 1.0
    max_inflight: int | None = 256
    ingest_capacity: int = 0
    ingest_batch: int = 32
    decode_workers: int = 2
    read_timeout_s: float = 30.0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        if self.ingest_capacity < 0:
            raise ValueError("ingest_capacity must be >= 0")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's job: model, algorithm, cadence, quota and chaos.

    ``algorithm`` is ``"fedbuff"`` (asynchronous buffered aggregation: aggregations
    fire on buffer fill) or ``"fedavg"`` (synchronous cohort rounds).  ``rounds``
    counts aggregations in fedbuff mode and cohort rounds in fedavg mode.
    ``chaos_plan`` (a ``faults.FaultPlan``) scopes entirely to this tenant."""

    name: str
    model: str = "digits_mlp"
    algorithm: str = "fedbuff"
    rounds: int = 4
    async_buffer_k: int = 16
    min_clients: int = 1
    completion_rate: float = 1.0
    staleness_window: int = 4
    round_timeout_s: float = 120.0
    poll_interval_s: float = 0.01
    seed: int = 0
    quota: TenantQuota = field(default_factory=TenantQuota)
    chaos_plan: Any | None = None

    def __post_init__(self) -> None:
        if not self.name or "/" in self.name:
            raise ValueError(f"invalid tenant name {self.name!r}")
        if self.algorithm not in ("fedavg", "fedbuff"):
            raise ValueError(f"unknown algorithm {self.algorithm!r} (fedavg | fedbuff)")
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")


def _aggregate(base_flat: torch.Tensor, stack: torch.Tensor,
               coefs: torch.Tensor) -> torch.Tensor:
    """The tenant's aggregation program: the ingest drain's shape."""
    return base_flat + coefs @ stack


class TenantSession:
    """One tenant's live state on the service (see the module note).

    Built by ``FederationService.add_tenant``; everything here is the tenant's own.
    Params are drawn by the port's model init from ``spec.seed`` on the host, then
    moved to ``device`` (None means the card)."""

    def __init__(
        self,
        spec: TenantSpec,
        transport: Any,
        scheduler: Any,
        clock: Clock | None = None,
        telemetry_dir: Any | None = None,
        profile_programs: bool = True,
        device: DeviceLike = None,
    ) -> None:
        from nanofed_tpu_torch.communication.http_server import HTTPServer
        from nanofed_tpu_torch.communication.network_coordinator import (
            NetworkCoordinator,
            NetworkRoundConfig,
        )
        from nanofed_tpu_torch.models import get_model
        from nanofed_tpu_torch.observability.profiling import ProgramCatalog

        self.spec = spec
        self.clock = clock or SYSTEM_CLOCK
        self.device = resolve_device(device)
        # Isolation by construction: every instrument this tenant's server,
        # coordinator, chaos schedule and swarm write lives in a registry no other
        # tenant holds.
        self.registry = MetricsRegistry()
        host = get_model(spec.model).init(torch.Generator().manual_seed(spec.seed))
        self.params = {name: leaf.to(self.device) for name, leaf in host.items()}
        self.param_count = sum(int(leaf.numel()) for leaf in self.params.values())
        chaos = None
        if spec.chaos_plan is not None:
            from nanofed_tpu_torch.faults import ChaosSchedule

            chaos = ChaosSchedule(spec.chaos_plan, registry=self.registry)
        self.chaos = chaos
        ingest = None
        if spec.quota.ingest_capacity > 0:
            from nanofed_tpu_torch.ingest import IngestConfig

            ingest = IngestConfig(capacity=spec.quota.ingest_capacity,
                                  decode_workers=spec.quota.decode_workers)
        asynchronous = spec.algorithm == "fedbuff"
        self.server = HTTPServer(
            transport=transport,
            tenant=spec.name,
            registry=self.registry,
            max_inflight=spec.quota.max_inflight,
            read_timeout_s=spec.quota.read_timeout_s,
            staleness_window=spec.staleness_window if asynchronous else 0,
            chaos=chaos,
            clock=self.clock,
            ingest=ingest,
            device=self.device,
        )
        config = NetworkRoundConfig(
            num_rounds=spec.rounds,
            min_clients=spec.min_clients,
            min_completion_rate=spec.completion_rate,
            round_timeout_s=spec.round_timeout_s,
            poll_interval_s=spec.poll_interval_s,
            async_buffer_k=spec.async_buffer_k if asynchronous else None,
            staleness_window=spec.staleness_window,
        )
        self.coordinator = NetworkCoordinator(
            self.server,
            self.params,
            config,
            registry=self.registry,
            clock=self.clock,
            device=self.device,
            telemetry_dir=(None if telemetry_dir is None
                           else str(telemetry_dir) + f"/{spec.name}"),
            device_gate=lambda: scheduler.lease(spec.name),
        )
        # The tenant's aggregation program, registered with lazy arguments: profiling
        # it gives the scheduler its measured peak and time on the card.
        self.catalog = ProgramCatalog(registry=self.registry)
        k = spec.async_buffer_k if asynchronous else max(1, spec.min_clients)
        self._agg_k = int(k)
        self._register_aggregate_program()
        self.cost_report = None
        if profile_programs:
            try:
                self.cost_report = self.catalog.profile(f"tenant_aggregate[{spec.name}]")
            except Exception as e:  # degraded, not fatal: the analytic bound applies
                _LOG.warning("tenant %s: aggregation-program profile failed (%s); "
                             "falling back to the analytic footprint", spec.name, e)
        self.history: list[dict[str, Any]] = []
        self.wall_s = 0.0

    # -- cost model ----------------------------------------------------------

    def _register_aggregate_program(self) -> None:
        p, k, device = self.param_count, self._agg_k, self.device

        def _args() -> tuple[tuple, dict]:
            return ((torch.zeros(p, device=device), torch.zeros(k, p, device=device),
                     torch.zeros(k, device=device)), {})

        self.catalog.register(
            f"tenant_aggregate[{self.spec.name}]", _aggregate, args_factory=_args,
            attrs={"tenant": self.spec.name, "model": self.spec.model, "k": k,
                   "params": p},
        )

    def footprint(self) -> TenantFootprint:
        """This tenant's device-memory shape for the scheduler's bin-pack.

        Resident: current and published params (float32) plus the ingest buffer.  Peak:
        the profiled program's arguments, outputs and temporaries from
        ``max_memory_allocated`` when the profile measured one (the card), else the
        analytic ``(K + 2) * P * 4`` (the ``[K, P]`` stack, base and output)."""
        param_bytes = self.param_count * 4
        resident = 2 * param_bytes
        if self.spec.quota.ingest_capacity > 0:
            resident += self.spec.quota.ingest_capacity * param_bytes
        report = self.cost_report
        if report is not None and report.peak_bytes > 0:
            return TenantFootprint(
                resident_bytes=resident,
                peak_extra_bytes=int(report.argument_bytes + report.output_bytes
                                     + report.temp_bytes),
                basis=("resident analytic (2x params + ingest buffer); peak measured: "
                       "the profiled aggregation program's args + outputs + temps "
                       "(torch.cuda.max_memory_allocated over the call)"),
            )
        return TenantFootprint(
            resident_bytes=resident,
            peak_extra_bytes=(self._agg_k + 2) * param_bytes,
            basis="analytic: 2x params + ingest buffer; peak (K+2)*P*4",
        )

    def cost_hint_s(self) -> float | None:
        """The cost model's expected section time: the profile's roofline lower bound
        when a peaks row exists for the card, else None (charges are measured either
        way)."""
        if self.cost_report is None:
            return None
        return self.cost_report.lower_bound_s

    # -- run -----------------------------------------------------------------

    async def run(self) -> dict[str, Any]:
        """Drive this tenant's rounds to completion; returns its summary."""
        t0 = time.perf_counter()
        try:
            self.history = await self.coordinator.run()
        finally:
            self.wall_s = time.perf_counter() - t0
        return self.summary()

    def summary(self) -> dict[str, Any]:
        completed = sum(1 for h in self.history if h.get("status") == "COMPLETED")
        failed = len(self.history) - completed
        snapshot = self.registry.snapshot()

        def _total(name: str) -> float:
            values = snapshot.get(name, {}).get("values", {})
            return float(sum(values.values())) if isinstance(values, dict) else 0.0

        updates = snapshot.get("nanofed_updates_total", {}).get("values", {})
        accepted = float(sum(
            v for key, v in updates.items()
            if isinstance(key, str) and key.endswith("accepted")
        )) if isinstance(updates, dict) else 0.0
        rps = completed / self.wall_s if self.wall_s > 0 else None
        return {
            "tenant": self.spec.name,
            "model": self.spec.model,
            "algorithm": self.spec.algorithm,
            "rounds_target": self.spec.rounds,
            "rounds_completed": completed,
            "rounds_failed": failed,
            "rounds_per_sec": round(rps, 4) if rps is not None else None,
            "wall_s": round(self.wall_s, 4),
            "http_429_total": _total("nanofed_http_429_total"),
            "updates_accepted": accepted,
            "chaos_injected_total": _total("nanofed_faults_injected_total"),
            "chaos_by_kind": self.chaos.counts() if self.chaos is not None else {},
            "params": self.param_count,
        }

    def close(self) -> None:
        """Release the tenant's resources (the ingest pipeline's decode pool)."""
        pipeline = self.server.ingest_pipeline
        if pipeline is not None:
            pipeline.close()
