"""Multi-tenant federation service: many concurrent jobs, one card (counterpart of
``nanofed_tpu/service/``).

* :class:`~nanofed_tpu_torch.service.tenant.TenantSession`: one tenant's isolated
  state: its HTTP session (mounted on the shared transport under ``/t/<name>``), round
  and version buffers, ingest buffer, metrics registry, telemetry, program catalog,
  quota and chaos schedule.
* :class:`~nanofed_tpu_torch.service.scheduler.RoundScheduler`: the device-memory
  bin-pack at admission and start-time fair queueing of device leases at run time.
* :class:`~nanofed_tpu_torch.service.service.FederationService`: one listener, N
  tenant round engines as asyncio tasks, device steps serialized through the lease.
* :func:`~nanofed_tpu_torch.service.harness.run_tenant_service`: N tenants concurrent
  against sequential, each tenant's p99 under a storm on one tenant, the isolation
  proof, one ``runs/tenants_*`` artifact.
"""

from nanofed_tpu_torch.service.scheduler import (
    AdmissionError,
    RoundScheduler,
    TenantFootprint,
)
from nanofed_tpu_torch.service.tenant import TenantQuota, TenantSession, TenantSpec

_LAZY_EXPORTS = {
    # The aiohttp-dependent pieces load lazily, as in the communication package.
    "FederationService": "service",
    "free_port": "service",
    "default_tenant_specs": "harness",
    "run_tenant_service": "harness",
    "tenant_storm_plan": "harness",
}


def __getattr__(name: str):
    if name in _LAZY_EXPORTS:
        import importlib

        mod = importlib.import_module(f"nanofed_tpu_torch.service.{_LAZY_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionError",
    "FederationService",
    "RoundScheduler",
    "TenantFootprint",
    "TenantQuota",
    "TenantSession",
    "TenantSpec",
    "default_tenant_specs",
    "free_port",
    "run_tenant_service",
    "tenant_storm_plan",
]
