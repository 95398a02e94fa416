"""Weighted-fair device scheduling and the device-memory bin-pack for N tenants on one
card (counterpart of ``nanofed_tpu/service/scheduler.py``).

Two decisions make a multi-tenant federation service more than N processes behind one
port, and this module owns both:

* **Admission (space).**  Can this tenant's working set live on the card beside the
  tenants already admitted?  The rule is a bin-pack against the budget: the sum of
  every admitted tenant's RESIDENT bytes (params, the published copy, the ingest
  buffer: what stays on the card between rounds) plus the LARGEST single tenant's
  program peak (the lease below serializes device steps, so at most one tenant's
  temporaries exist at a time) must fit.  The budget resolves through the autotuner's
  chain (:func:`~nanofed_tpu_torch.tuning.autotuner.resolve_hbm_budget`): explicit,
  then ``NANOFED_AUTOTUNE_HBM_BUDGET``, then the card's ``total_memory``, then
  unbounded on the CPU, stated as such.  Both sides of the inequality and their bases
  are in the :class:`AdmissionError` message.
* **Ordering (time).**  Which ready tenant's device step runs next?  Start-time fair
  queueing over virtual passes: a lease request enqueues at the tenant's pass, the
  lowest pass is granted when the device frees, and a released lease charges
  ``measured_seconds / weight`` to the tenant's pass.  A heavy tenant accrues pass
  quickly and yields the card to light ones between its steps; an idle tenant's pass
  is clamped up to the global virtual time when it returns, so idling banks no credit.
  Charges are measured seconds of the section (the coordinator ends each section with
  a device synchronize, so they are device-complete seconds).

Single-event-loop use only: every mutation happens on the service's loop.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from nanofed_tpu_torch.core.device import DeviceLike
from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry

__all__ = [
    "AdmissionError",
    "RoundScheduler",
    "TenantFootprint",
]


class AdmissionError(ValueError):
    """A tenant whose footprint cannot be packed onto the card."""


@dataclass(frozen=True)
class TenantFootprint:
    """One tenant's device-memory shape, with the basis of its numbers.

    ``resident_bytes`` lives on the card between rounds and SUMS across tenants;
    ``peak_extra_bytes`` exists only while the tenant's aggregation program runs, and
    since the lease serializes device steps only the largest across tenants counts."""

    resident_bytes: int
    peak_extra_bytes: int
    basis: str = "analytic"

    def __post_init__(self) -> None:
        if self.resident_bytes < 0 or self.peak_extra_bytes < 0:
            raise ValueError("footprint bytes must be >= 0")

    @classmethod
    def for_fleet(cls, profile: Any, base_like: Any, ingest_capacity: int,
                  agg_k: int = 8) -> "TenantFootprint":
        """The analytic footprint of a heterogeneous-fleet tenant
        (``nanofed_tpu_torch.fleet.FleetProfile``), sized by its largest-rank tier: the
        fleet aggregates in dense-delta space, so the ingest buffer and the drain are
        dense whatever the tier ranks, and the adapter state is the max-rank tier's.
        Resident: the frozen base and its published copy, one max-rank A/B projection
        and the ``capacity x P`` ingest buffer; peak: the ``(K + 2) x P`` drain shape.
        The JAX package's numbers; ``chip_smoke.py`` (fl3) holds them against a
        drain's measured peak on the card."""
        from nanofed_tpu_torch.adapters.lora import AdapterSpec, adapter_param_count

        flat = sum(int(np.prod(tuple(getattr(leaf, "shape", leaf))) or 1)
                   for leaf in base_like.values())
        top = profile.max_rank_tier
        counts = adapter_param_count(AdapterSpec(rank=top.adapter_rank), base_like)
        resident = (
            2 * flat * 4  # frozen base + published dense copy
            + 2 * counts["adapter_bytes_f32"]  # max-rank A/B projection
            + ingest_capacity * flat * 4  # dense ingest buffer rows
        )
        peak = (agg_k + 2) * flat * 4
        return cls(
            resident_bytes=int(resident),
            peak_extra_bytes=int(peak),
            basis=(
                f"analytic fleet({profile.name}): dense ingest, sized by "
                f"max-rank tier '{top.name}' (rank {top.adapter_rank})"
            ),
        )


class _Lease:
    """One granted device section: an async context manager that measures its own
    duration and settles the tenant's virtual-time bill on exit."""

    def __init__(self, scheduler: "RoundScheduler", tenant: str) -> None:
        self._scheduler = scheduler
        self._tenant = tenant
        self._t0 = 0.0

    async def __aenter__(self) -> "_Lease":
        await self._scheduler._acquire(self._tenant)
        self._t0 = time.perf_counter()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        self._scheduler._release(self._tenant, time.perf_counter() - self._t0)


class RoundScheduler:
    """Packs N tenants' round programs onto one card (see the module note).

    ``admit`` is the space decision (raises :class:`AdmissionError` with both sides of
    the inequality), ``lease`` the time decision: the async context manager a tenant's
    round engine brackets its device steps with (``NetworkCoordinator(device_gate=)``).
    ``device`` is the card whose ``total_memory`` is the budget when neither
    ``hbm_budget_bytes`` nor the env variable sets one (None means the card; on the
    CPU the budget is unbounded)."""

    def __init__(
        self,
        hbm_budget_bytes: int | None = None,
        registry: MetricsRegistry | None = None,
        device: DeviceLike = None,
    ) -> None:
        from nanofed_tpu_torch.tuning.autotuner import resolve_hbm_budget

        self.hbm_budget_bytes, self.hbm_budget_basis = resolve_hbm_budget(
            hbm_budget_bytes, device=device)
        self._weights: dict[str, float] = {}
        self._footprints: dict[str, TenantFootprint] = {}
        self._cost_hints: dict[str, float | None] = {}
        self._pass: dict[str, float] = {}
        self._vt = 0.0  # global virtual time: the pass of the last granted tenant
        self._busy: str | None = None  # the tenant holding the device, if any
        self._seq = 0
        # (pass at enqueue, seq, tenant, wake future)
        self._waiters: list[tuple[float, int, str, Any]] = []
        self._leases: dict[str, int] = {}
        self._device_seconds: dict[str, float] = {}
        self._wait_seconds: dict[str, float] = {}
        self._enqueued_at: dict[int, float] = {}
        self.metrics_registry = registry or get_registry()
        self._m_leases = self.metrics_registry.counter(
            "nanofed_sched_leases_total",
            "Device leases granted by the round scheduler, by tenant",
            labels=("tenant",),
        )
        self._m_device_seconds = self.metrics_registry.counter(
            "nanofed_sched_device_seconds_total",
            "Measured device-section seconds charged to each tenant",
            labels=("tenant",),
        )
        self._m_wait = self.metrics_registry.histogram(
            "nanofed_sched_wait_seconds",
            "Time a ready tenant waited for the device lease",
            labels=("tenant",),
        )
        self._m_queue = self.metrics_registry.gauge(
            "nanofed_sched_queue_depth",
            "Tenants currently waiting for the device lease",
        )
        self._m_rejects = self.metrics_registry.counter(
            "nanofed_sched_admission_rejects_total",
            "Tenants refused admission by the HBM bin-pack check",
        )
        self._m_resident = self.metrics_registry.gauge(
            "nanofed_tenant_resident_bytes",
            "Admitted device-resident bytes per tenant",
            labels=("tenant",),
        )

    # -- admission (space) ---------------------------------------------------

    def admit(self, tenant: str, footprint: TenantFootprint, weight: float = 1.0,
              cost_hint_s: float | None = None) -> None:
        """Admit a tenant, or raise :class:`AdmissionError` with the packing
        arithmetic.  ``weight`` is the fair-share weight (2.0: twice the device time of
        a weight-1 tenant under contention); ``cost_hint_s`` the cost model's expected
        section time, kept for ``stats()`` (charges always use measured seconds)."""
        if weight <= 0:
            raise ValueError("weight must be > 0")
        if tenant in self._footprints:
            raise AdmissionError(f"tenant {tenant!r} is already admitted")
        if self.hbm_budget_bytes is not None:
            resident = footprint.resident_bytes + sum(
                f.resident_bytes for f in self._footprints.values())
            peak = max([footprint.peak_extra_bytes]
                       + [f.peak_extra_bytes for f in self._footprints.values()])
            if resident + peak > self.hbm_budget_bytes:
                self._m_rejects.inc()
                raise AdmissionError(
                    f"tenant {tenant!r} does not fit the device pool: "
                    f"resident {resident:,} B (all tenants incl. this one) + "
                    f"max program peak {peak:,} B = {resident + peak:,} B > "
                    f"budget {self.hbm_budget_bytes:,} B "
                    f"({self.hbm_budget_basis}); footprint basis: {footprint.basis}"
                )
        self._footprints[tenant] = footprint
        self._weights[tenant] = float(weight)
        self._cost_hints[tenant] = cost_hint_s
        # Join at the current virtual time: no credit for not existing yet.
        self._pass[tenant] = self._vt
        self._m_resident.set(footprint.resident_bytes, tenant=tenant)

    def remove(self, tenant: str) -> None:
        """Release a tenant's reservation (idempotent).  A lease it HOLDS finishes
        normally; a request still QUEUED fails with a typed RuntimeError at grant time
        and the device moves on to the next waiter.  Its accounting goes too: a
        re-admitted name is a new job."""
        for table in (self._footprints, self._weights, self._cost_hints, self._pass,
                      self._leases, self._device_seconds, self._wait_seconds):
            table.pop(tenant, None)
        self._m_resident.set(0, tenant=tenant)

    def admitted(self) -> list[str]:
        return sorted(self._footprints)

    # -- the lease (time) ----------------------------------------------------

    def lease(self, tenant: str) -> _Lease:
        """The device-section context manager for ``tenant``: pass ``lambda:
        scheduler.lease(name)`` as a coordinator's ``device_gate``."""
        return _Lease(self, tenant)

    async def _acquire(self, tenant: str) -> None:
        if tenant not in self._weights:
            raise RuntimeError(f"tenant {tenant!r} requested the device without admission")
        # Start-time rule: an idle tenant re-enters at the global virtual time.
        self._pass[tenant] = max(self._pass[tenant], self._vt)
        if self._busy is None and not self._waiters:
            self._grant(tenant)
            return
        fut = asyncio.get_running_loop().create_future()
        self._seq += 1
        seq = self._seq
        heapq.heappush(self._waiters, (self._pass[tenant], seq, tenant, fut))
        self._enqueued_at[seq] = time.perf_counter()
        self._m_queue.set(len(self._waiters))
        try:
            await fut
        except asyncio.CancelledError:
            # Lost-wakeup guard (the asyncio.Lock pattern): a grant that landed on
            # this future before the cancellation arrived marks the device busy for a
            # task that will never run its section; hand it to the next waiter.
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self._busy = None
                self._grant_next()
            raise

    def _grant(self, tenant: str) -> None:
        self._busy = tenant
        # .get: a waiter removed while queued reaches here only through the typed
        # refusal below, but the bookkeeping must never KeyError mid-release.
        self._vt = max(self._vt, self._pass.get(tenant, self._vt))
        self._leases[tenant] = self._leases.get(tenant, 0) + 1
        self._m_leases.inc(tenant=tenant)

    def _release(self, tenant: str, duration_s: float) -> None:
        # The realized bill: measured seconds over the fair-share weight.
        charge = max(0.0, duration_s) / self._weights.get(tenant, 1.0)
        if tenant in self._pass:
            self._pass[tenant] += charge
        if tenant in self._footprints:
            # A tenant removed while holding the lease is not re-inserted into the
            # accounting its removal cleared.
            self._device_seconds[tenant] = (
                self._device_seconds.get(tenant, 0.0) + max(0.0, duration_s))
        self._m_device_seconds.inc(max(0.0, duration_s), tenant=tenant)
        self._busy = None
        self._grant_next()

    def _grant_next(self) -> None:
        """Hand the free device to the lowest-pass live waiter.  Waiters whose tenant
        was removed while queued fail with a typed error and the scan continues."""
        while self._waiters:
            _, seq, waiter, fut = heapq.heappop(self._waiters)
            self._m_queue.set(len(self._waiters))
            if fut.done():
                self._enqueued_at.pop(seq, None)
                continue
            if waiter not in self._weights:
                self._enqueued_at.pop(seq, None)
                fut.set_exception(RuntimeError(
                    f"tenant {waiter!r} was removed while waiting for the device lease"))
                continue
            waited = time.perf_counter() - self._enqueued_at.pop(seq, time.perf_counter())
            self._wait_seconds[waiter] = self._wait_seconds.get(waiter, 0.0) + waited
            self._m_wait.observe(waited, tenant=waiter)
            self._grant(waiter)
            fut.set_result(None)
            return

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        """Per-tenant leases, device and wait seconds, virtual passes, and the packing
        state with its basis: the artifact's view."""
        return {
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "hbm_budget_basis": self.hbm_budget_basis,
            "tenants": {
                t: {
                    "weight": self._weights[t],
                    "resident_bytes": self._footprints[t].resident_bytes,
                    "peak_extra_bytes": self._footprints[t].peak_extra_bytes,
                    "footprint_basis": self._footprints[t].basis,
                    "cost_hint_s": self._cost_hints.get(t),
                    "leases": self._leases.get(t, 0),
                    "device_seconds": round(self._device_seconds.get(t, 0.0), 6),
                    "wait_seconds": round(self._wait_seconds.get(t, 0.0), 6),
                    "virtual_pass": round(self._pass.get(t, 0.0), 6),
                }
                for t in sorted(self._footprints)
            },
        }
