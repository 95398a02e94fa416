"""Fault injection for the port (counterpart of ``nanofed_tpu/faults``).

Deterministic, seeded failure schedules (:class:`FaultPlan` / :class:`ChaosSchedule`)
injectable at four boundaries: the HTTP client (:class:`ChaosClient`), the HTTP
server's update endpoint (``HTTPServer(chaos=...)``), the round loops
(``NetworkCoordinator(chaos=...)`` raising :class:`InjectedServerCrash`,
``Coordinator(chaos=...)`` dropping planned crashes from every cohort) and a
multi-host worker (:class:`HostChaosInjector`).

``plan`` and ``host_injector`` are pure stdlib; ``injector`` needs ``aiohttp`` (the
port's HTTP client) and is imported lazily.
"""

from nanofed_tpu_torch.faults.host_injector import HostChaosInjector
from nanofed_tpu_torch.faults.plan import (
    FAULT_KINDS,
    HOST_KINDS,
    ChaosSchedule,
    FaultEvent,
    FaultPlan,
    InjectedServerCrash,
)

__all__ = [
    "FAULT_KINDS",
    "HOST_KINDS",
    "ChaosClient",
    "ChaosSchedule",
    "FaultEvent",
    "FaultPlan",
    "HostChaosInjector",
    "InjectedServerCrash",
]


def __getattr__(name: str):
    if name == "ChaosClient":
        from nanofed_tpu_torch.faults.injector import ChaosClient

        return ChaosClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
