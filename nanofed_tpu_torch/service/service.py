"""The federation service: N concurrent tenants over one card (counterpart of
``nanofed_tpu/service/service.py``).

:class:`FederationService` composes the shared
:class:`~nanofed_tpu_torch.communication.transport.HTTPTransport` (one listener,
tenant resolution), per-tenant :class:`~nanofed_tpu_torch.service.tenant.TenantSession`
state and the :class:`~nanofed_tpu_torch.service.scheduler.RoundScheduler` (the
bin-pack at admission, weighted-fair device leases at run time) into one process
serving many federation jobs.  Every tenant's round engine runs as its own asyncio
task; device steps serialize through the scheduler's lease, while each tenant's host
work (polling its barrier, decoding submits on its bounded pool, publishing) overlaps
the other tenants' device time.

Each tenant's instruments live in its own registry (``GET /t/<tenant>/metrics``); the
service mirrors headline numbers into ``tenant``-labelled gauges on the service
registry after each tenant finishes, so one scrape ranks the tenants without a shared
counter.
"""

from __future__ import annotations

import asyncio
from typing import Any

from nanofed_tpu_torch.communication.transport import HTTPTransport, free_port
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.service.scheduler import RoundScheduler
from nanofed_tpu_torch.service.tenant import TenantSession, TenantSpec
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger

__all__ = ["FederationService", "free_port"]


class FederationService:
    """One listener, one card, N tenants (see the module note)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        clock: Clock | None = None,
        registry: MetricsRegistry | None = None,
        hbm_budget_bytes: int | None = None,
        telemetry_dir: Any | None = None,
        profile_programs: bool = True,
        device: DeviceLike = None,
    ) -> None:
        """``registry`` is the service's (scheduler metrics, unknown-tenant 404s, the
        per-tenant mirror gauges), a private one by default so services in one process
        stay apart.  ``profile_programs`` runs each tenant's aggregation program at
        admission so the bin-pack uses its measured peak (off: the analytic bound).
        ``device`` (None means the card) runs every tenant and sets the budget's
        basis."""
        self.clock = clock or SYSTEM_CLOCK
        self.device = resolve_device(device)
        self.registry = registry or MetricsRegistry()
        self.transport = HTTPTransport(host=host, port=port, registry=self.registry)
        self.scheduler = RoundScheduler(hbm_budget_bytes=hbm_budget_bytes,
                                        registry=self.registry, device=self.device)
        self.telemetry_dir = telemetry_dir
        self.profile_programs = profile_programs
        self._tenants: dict[str, TenantSession] = {}
        self._log = Logger()
        self._m_tenants = self.registry.gauge(
            "nanofed_service_tenants", "Tenant sessions currently mounted")
        self._m_rounds = self.registry.gauge(
            "nanofed_tenant_rounds_completed",
            "Rounds/aggregations completed per tenant (mirrored from the tenant "
            "registry at summary time)",
            labels=("tenant",),
        )
        self._m_429 = self.registry.gauge(
            "nanofed_tenant_http_429", "Admission-control 429s per tenant (mirrored)",
            labels=("tenant",),
        )
        self._m_chaos = self.registry.gauge(
            "nanofed_tenant_chaos_injected",
            "Chaos faults injected against each tenant (mirrored)",
            labels=("tenant",),
        )

    # -- tenant lifecycle ----------------------------------------------------

    def add_tenant(self, spec: TenantSpec) -> TenantSession:
        """Admit and mount one tenant.  Raises
        :class:`~nanofed_tpu_torch.service.scheduler.AdmissionError` when its footprint
        does not pack (nothing stays mounted), ``ValueError`` on a duplicate name."""
        if spec.name in self._tenants:
            raise ValueError(f"tenant {spec.name!r} already exists")
        session = None
        try:
            # Construction mounts the session on the shared transport, so ANY failure
            # after it (a bad round config as much as a refusal) must unmount it.
            session = TenantSession(
                spec, transport=self.transport, scheduler=self.scheduler,
                clock=self.clock, telemetry_dir=self.telemetry_dir,
                profile_programs=self.profile_programs, device=self.device,
            )
            self.scheduler.admit(spec.name, session.footprint(),
                                 weight=spec.quota.weight,
                                 cost_hint_s=session.cost_hint_s())
        except Exception:
            self.transport.remove_session(spec.name)
            if session is not None:
                session.close()
            raise
        self._tenants[spec.name] = session
        self._m_tenants.set(len(self._tenants))
        self._log.info("tenant %s admitted: model=%s algorithm=%s rounds=%d weight=%g",
                       spec.name, spec.model, spec.algorithm, spec.rounds,
                       spec.quota.weight)
        return session

    def remove_tenant(self, name: str) -> None:
        """Unmount a tenant: later requests 404, its reservation is released, its
        decode pool closes.  Idempotent."""
        session = self._tenants.pop(name, None)
        self.transport.remove_session(name)
        self.scheduler.remove(name)
        if session is not None:
            session.close()
        self._m_tenants.set(len(self._tenants))

    def tenant(self, name: str) -> TenantSession:
        return self._tenants[name]

    def tenants(self) -> list[str]:
        return sorted(self._tenants)

    # -- lifecycle and execution ---------------------------------------------

    async def start(self) -> None:
        await self.transport.start()

    async def stop(self) -> None:
        for session in self._tenants.values():
            session.close()
        await self.transport.stop()

    async def run(self) -> dict[str, dict[str, Any]]:
        """Run every mounted tenant's rounds concurrently to completion; returns
        ``{tenant: summary}``.  A tenant's crashed round loop is its own summary's
        ``error``, and the other tenants run on."""
        names = self.tenants()
        results = await asyncio.gather(*(self._tenants[n].run() for n in names),
                                       return_exceptions=True)
        summaries: dict[str, dict[str, Any]] = {}
        for name, result in zip(names, results):
            if isinstance(result, BaseException):
                summary = self._tenants[name].summary()
                summary["error"] = repr(result)
                summaries[name] = summary
            else:
                summaries[name] = result
            self._mirror(name, summaries[name])
        return summaries

    def _mirror(self, name: str, summary: dict[str, Any]) -> None:
        """One tenant's headline numbers into the service's ``tenant``-labelled
        gauges."""
        self._m_rounds.set(summary.get("rounds_completed", 0), tenant=name)
        self._m_429.set(summary.get("http_429_total", 0), tenant=name)
        self._m_chaos.set(summary.get("chaos_injected_total", 0), tenant=name)
