"""The port's multi-tenant service (``nanofed_tpu_torch.service``) against the JAX
package's (``nanofed_tpu.service``) on the CPU.

* The round scheduler: both ``RoundScheduler``s are driven through the same
  admissions, leases and injected durations (each module's ``time.perf_counter`` is a
  fake clock), removal while queued and a cancellation after a grant included: the
  same grant order, equal ``stats()`` and registry snapshots, bit for bit; the same
  ``AdmissionError`` text.
* The storm plan (``random.Random`` draws) and the default roster: equal, event for
  event and field for field.
* The two-tenant smoke of ``tests/integration/test_tenant_service.py`` on a
  ``VirtualClock`` in both packages: the isolation claim holds in the port, its
  artifact has the JAX artifact's key sets, and ``summarize_telemetry`` digests it.
  Params differ by design (torch's generator against JAX's key), so values are not
  compared.
* Stated differences, one test each: a gated device section ends with a synchronize
  inside the lease, once a lease; on the CPU, where the profile reports no peak, a
  tenant's footprint takes the analytic ``(K+2)·P·4`` and says so.
  ``TenantFootprint.for_fleet`` is held against the JAX package in
  ``tests/test_torch_fleet.py``.
"""

import pytest

pytest.importorskip("aiohttp", reason="the service needs aiohttp")

import asyncio
import dataclasses
import json
import math
import types

import nanofed_tpu.service as jax_service
import nanofed_tpu.service.scheduler as jax_sched
import nanofed_tpu_torch.service as port_service
import nanofed_tpu_torch.service.scheduler as port_sched
from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry
from nanofed_tpu_torch.communication import network_coordinator
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.observability.telemetry import summarize_telemetry

PKGS = {"port": (port_sched, MetricsRegistry), "jax": (jax_sched, JaxRegistry)}


class FakeClock:
    """Stands in for a scheduler module's ``time``: ``perf_counter`` reads ``now``."""

    def __init__(self) -> None:
        self.now = 100.0

    def perf_counter(self) -> float:
        return self.now


async def _settle(n: int = 3) -> None:
    for _ in range(n):
        await asyncio.sleep(0)


def _schedule(pkg: str, monkeypatch) -> tuple[list, dict, dict, list]:
    """One scripted day of a scheduler: history, a blocker, five queued waiters, a
    removal while queued, a cancellation after its grant, then the queue drained."""
    mod, registry_cls = PKGS[pkg]
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))

    async def scenario():
        registry = registry_cls()
        s = mod.RoundScheduler(hbm_budget_bytes=1 << 40, registry=registry)
        fp = mod.TenantFootprint(resident_bytes=1, peak_extra_bytes=1)
        for name, weight in (("blocker", 1.0), ("heavy", 1.0), ("light", 2.0),
                             ("doomed", 1.0), ("victim", 1.0), ("next", 0.5)):
            s.admit(name, fp, weight=weight, cost_hint_s=0.25 if name == "heavy" else None)
        grants = []

        async def hold(name: str, seconds: float) -> None:
            async with s.lease(name):
                grants.append(name)
                clock.now += seconds

        await hold("heavy", 10.0)
        await hold("light", 1.0)
        await s._acquire("blocker")
        grants.append("blocker")
        waiters = {}
        for name in ("heavy", "light", "doomed", "victim", "next"):
            waiters[name] = asyncio.ensure_future(s._acquire(name))
            clock.now += 0.5
        await _settle()
        s.remove("doomed")
        clock.now += 2.0
        s._release("blocker", 3.0)  # the grant lands on the victim ...
        waiters["victim"].cancel()  # ... cancelled before it resumes
        await _settle()
        outcomes = {name: ("cancelled" if t.cancelled() else
                           repr(t.exception()) if t.done() and t.exception() else
                           "granted" if t.done() else "waiting")
                    for name, t in waiters.items()}
        for name, seconds in (("next", 4.0), ("light", 1.5), ("heavy", 0.25)):
            assert waiters[name].done() and not waiters[name].cancelled(), (name, outcomes)
            grants.append(name)
            clock.now += seconds
            s._release(name, seconds)
            await _settle()
        return grants, s.stats(), registry.snapshot(), outcomes

    return asyncio.run(scenario())


def test_scheduler_grants_and_stats_equal_the_jax_scheduler(monkeypatch):
    ours = _schedule("port", monkeypatch)
    theirs = _schedule("jax", monkeypatch)
    assert ours[0] == theirs[0] == ["heavy", "light", "blocker", "next", "light", "heavy"]
    assert ours[3] == theirs[3]
    assert ours[3]["victim"] == "cancelled" and "removed while waiting" in ours[3]["doomed"]
    assert ours[1] == theirs[1]
    assert ours[2] == theirs[2]


def test_admission_error_equals_the_jax_text():
    messages = []
    for mod, registry_cls in PKGS.values():
        s = mod.RoundScheduler(hbm_budget_bytes=100, registry=registry_cls())
        s.admit("a", mod.TenantFootprint(resident_bytes=40, peak_extra_bytes=10))
        s.admit("b", mod.TenantFootprint(resident_bytes=40, peak_extra_bytes=20))
        with pytest.raises(mod.AdmissionError) as e:
            s.admit("c", mod.TenantFootprint(resident_bytes=10, peak_extra_bytes=5))
        assert s.admitted() == ["a", "b"]
        messages.append(str(e.value))
        with pytest.raises(mod.AdmissionError, match="already admitted"):
            s.admit("a", mod.TenantFootprint(resident_bytes=1, peak_extra_bytes=1))
        s.remove("a")
        s.admit("c", mod.TenantFootprint(resident_bytes=10, peak_extra_bytes=5))
    assert messages[0] == messages[1]
    assert "resident 90 B" in messages[0] and "budget 100 B" in messages[0]


def test_scheduler_budget_follows_the_port_chain(monkeypatch):
    """Explicit, then the env variable, then unbounded on the CPU, with the basis."""
    monkeypatch.delenv("NANOFED_AUTOTUNE_HBM_BUDGET", raising=False)
    s = port_sched.RoundScheduler(registry=MetricsRegistry(), device="cpu")
    assert s.hbm_budget_bytes is None and "unbounded" in s.hbm_budget_basis
    s.admit("a", port_sched.TenantFootprint(resident_bytes=10**15, peak_extra_bytes=10**15))
    monkeypatch.setenv("NANOFED_AUTOTUNE_HBM_BUDGET", "2048")
    s = port_sched.RoundScheduler(registry=MetricsRegistry(), device="cpu")
    assert s.hbm_budget_bytes == 2048 and "environment" in s.hbm_budget_basis
    s = port_sched.RoundScheduler(hbm_budget_bytes=7, registry=MetricsRegistry())
    assert (s.hbm_budget_bytes, s.hbm_budget_basis) == (7, "explicit hbm_budget_bytes argument")


def test_storm_plan_equals_the_jax_draws():
    for seed, clients, rounds in ((7, 40, 4), (3, 32, 3), (11, 200, 2)):
        ours = port_service.tenant_storm_plan(seed, clients, rounds)
        theirs = jax_service.tenant_storm_plan(seed, clients, rounds)
        assert ours.seed == theirs.seed
        assert [dataclasses.asdict(e) for e in ours.events] == \
            [dataclasses.asdict(e) for e in theirs.events]
        assert {e.kind for e in ours.events} == {"drop", "ack_drop", "delay"}


def test_default_roster_equals_the_jax_roster():
    for kwargs in ({}, {"tenants": 5, "rounds": 3, "async_buffer_k": 8, "min_clients": 4,
                        "max_inflight": None, "seed": 9}):
        ours = [dataclasses.asdict(s) for s in port_service.default_tenant_specs(**kwargs)]
        theirs = [dataclasses.asdict(s) for s in jax_service.default_tenant_specs(**kwargs)]
        assert ours == theirs
    alpha, bravo, charlie = port_service.default_tenant_specs()
    assert (alpha.model, alpha.algorithm, alpha.quota.ingest_capacity) == (
        "digits_mlp", "fedbuff", 128)
    assert (bravo.model, bravo.algorithm, bravo.quota.ingest_capacity) == ("mlp", "fedbuff", 0)
    assert (charlie.model, charlie.algorithm) == ("linear", "fedavg")


def test_spec_and_quota_validation_like_jax():
    for svc in (port_service, jax_service):
        for bad in (dict(name=""), dict(name="a/b"), dict(name="a", algorithm="sgd"),
                    dict(name="a", rounds=0)):
            with pytest.raises(ValueError):
                svc.TenantSpec(**bad)
        with pytest.raises(ValueError):
            svc.TenantQuota(weight=0)
        with pytest.raises(ValueError):
            svc.TenantQuota(ingest_capacity=-1)
    assert sorted(port_service.__all__) == sorted(jax_service.__all__)


def _specs_2tenant(svc, rounds=3):
    return [
        svc.TenantSpec(name="alpha", model="digits_mlp", algorithm="fedbuff", rounds=rounds,
                       async_buffer_k=8,
                       quota=svc.TenantQuota(ingest_capacity=32, ingest_batch=8)),
        svc.TenantSpec(name="bravo", model="mlp", algorithm="fedbuff", rounds=rounds,
                       async_buffer_k=8),
    ]


def _smoke(svc, tmp, **extra):
    return svc.run_tenant_service(
        _specs_2tenant(svc), clients_per_tenant=32, submits_per_client=1,
        chaos_tenant="alpha", virtual_clock=True, sequential_baseline=False,
        out_dir=tmp, telemetry_dir=tmp / "telemetry", tag="smoke", **extra)


def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_two_tenant_smoke_holds_isolation_with_the_jax_artifact_shape(tmp_path):
    ours = _smoke(port_service, tmp_path / "port", device="cpu")
    theirs = _smoke(jax_service, tmp_path / "jax")
    on_disk = json.loads((tmp_path / "port" / "tenants_smoke.json").read_text())
    assert on_disk["record_type"] == "tenants"
    alpha, bravo = ours["tenants"]["alpha"], ours["tenants"]["bravo"]
    assert alpha["chaos_injected_total"] > 0 and bravo["chaos_injected_total"] == 0
    assert bravo["rounds_completed"] == bravo["rounds_target"] == 3
    assert bravo["failed_submits"] == 0
    assert ours["isolation"]["zero_rounds_lost"] and ours["isolation"]["zero_failed_submits"]
    assert alpha["rounds_completed"] > 0
    for t in (alpha, bravo):
        assert math.isfinite(t["submit_latency_s"]["p99_s"])
    sched = ours["scheduler"]["tenants"]
    assert sched["alpha"]["leases"] > 0 and sched["bravo"]["leases"] > 0
    assert sched["alpha"]["footprint_basis"] == "analytic: 2x params + ingest buffer; peak " \
        "(K+2)*P*4"
    # The JAX artifact's shape, two levels down; env names torch where JAX names jax.
    ours_keys, theirs_keys = _keys(ours), _keys(theirs)
    assert set(ours_keys.pop("env")) == {"torch", "backend", "device_count"}
    theirs_keys.pop("env")
    assert ours_keys == theirs_keys
    assert set(ours["tenants"]["alpha"]) == set(theirs["tenants"]["alpha"])
    assert set(ours["scheduler"]["tenants"]["alpha"]) == \
        set(theirs["scheduler"]["tenants"]["alpha"])
    summary = summarize_telemetry(tmp_path / "port" / "telemetry" / "telemetry.jsonl")
    assert set(summary["tenants"]) == {"alpha", "bravo"}
    assert summary["tenants"]["bravo"]["rounds_completed"] == bravo["rounds_completed"]
    assert summary["tenants"]["alpha"]["chaos_injected_total"] > 0


def test_sync_fedavg_tenant_completes_from_swarm_traffic():
    artifact = port_service.run_tenant_service(
        [port_service.TenantSpec(name="sync", model="linear", algorithm="fedavg", rounds=2,
                                 min_clients=3)],
        clients_per_tenant=12, submits_per_client=2, arrival="uniform", arrival_rate=100.0,
        chaos_tenant=None, virtual_clock=True, sequential_baseline=True, out_dir=None,
        profile_programs=False, device="cpu")
    t = artifact["tenants"]["sync"]
    assert t["rounds_completed"] == 2 and t["failed_submits"] == 0
    seq = artifact["sequential"]
    assert seq["per_tenant"]["sync"]["rounds_completed"] == 2
    assert seq["per_tenant"]["sync"]["scheduler"]["leases"] == 2
    assert artifact["concurrent_over_sequential"] > 0


def test_admission_refusal_unmounts_and_names_both_sides():
    async def scenario():
        service = port_service.FederationService(port=0, hbm_budget_bytes=1024,
                                                 profile_programs=False, device="cpu")
        with pytest.raises(port_service.AdmissionError) as e:
            service.add_tenant(port_service.TenantSpec(name="fat", model="digits_mlp"))
        assert "budget 1,024 B" in str(e.value) and "(K+2)*P*4" in str(e.value)
        assert service.tenants() == [] and service.transport.tenants() == []

    asyncio.run(scenario())


def test_failed_construction_unmounts_and_frees_the_name():
    async def scenario():
        service = port_service.FederationService(port=0, profile_programs=False,
                                                 device="cpu")
        with pytest.raises(ValueError):
            # Passes TenantSpec's checks, fails NetworkRoundConfig's after the mount.
            service.add_tenant(port_service.TenantSpec(name="alpha", async_buffer_k=0))
        assert service.transport.tenants() == []
        service.add_tenant(port_service.TenantSpec(name="alpha", rounds=1))
        assert service.tenants() == ["alpha"] == service.transport.tenants()
        with pytest.raises(ValueError, match="already exists"):
            service.add_tenant(port_service.TenantSpec(name="alpha", rounds=1))
        service.remove_tenant("alpha")
        service.remove_tenant("alpha")  # idempotent
        assert service.tenants() == [] == service.scheduler.admitted()
        assert service.transport.tenants() == []

    asyncio.run(scenario())


def test_a_removed_tenant_is_a_404_on_the_shared_listener():
    import aiohttp

    async def scenario():
        service = port_service.FederationService(port=port_service.free_port(),
                                                 profile_programs=False, device="cpu")
        service.add_tenant(port_service.TenantSpec(name="alpha", rounds=1))
        service.add_tenant(port_service.TenantSpec(name="bravo", rounds=1))
        await service.start()
        try:
            base = f"http://127.0.0.1:{service.transport.port}"
            async with aiohttp.ClientSession() as http:
                assert (await http.get(f"{base}/t/alpha/test")).status == 200
                service.remove_tenant("alpha")
                assert (await http.get(f"{base}/t/alpha/test")).status == 404
                assert (await http.get(f"{base}/t/bravo/test")).status == 200
        finally:
            await service.stop()

    asyncio.run(scenario())


def test_gated_sections_end_with_one_synchronize_inside_each_lease(monkeypatch):
    """Stated difference: CUDA launches return before the work is done, so the port's
    device section ends with a synchronize of its devices inside the lease (a no-op on
    the CPU), once a lease; the JAX section does not block."""
    log = []
    monkeypatch.setattr(network_coordinator, "synchronize_devices",
                        lambda devices: log.append(("sync", sorted(d.type for d in devices))))
    real_lease = port_sched.RoundScheduler.lease

    def traced_lease(self, tenant):
        lease = real_lease(self, tenant)

        class Traced:
            async def __aenter__(self_):
                await lease.__aenter__()
                log.append(("enter", tenant))

            async def __aexit__(self_, *exc):
                log.append(("exit", tenant))
                await lease.__aexit__(*exc)

        return Traced()

    monkeypatch.setattr(port_sched.RoundScheduler, "lease", traced_lease)
    artifact = port_service.run_tenant_service(
        _specs_2tenant(port_service, rounds=2), clients_per_tenant=16,
        submits_per_client=1, chaos_tenant=None, virtual_clock=True,
        sequential_baseline=False, out_dir=None, profile_programs=False, device="cpu")
    leases = sum(t["leases"] for t in artifact["scheduler"]["tenants"].values())
    assert leases == 4
    assert [e[0] for e in log] == ["enter", "sync", "exit"] * leases
    assert all(e[1] == ["cpu"] for e in log if e[0] == "sync")


def test_cpu_footprint_takes_the_analytic_peak_and_a_measured_peak_when_there_is_one():
    """Stated difference: the port's profile reports a peak only on the card
    (``max_memory_allocated``); on the CPU the footprint takes ``(K+2)·P·4`` and says
    so, as the JAX package does without a profile."""
    async def scenario():
        service = port_service.FederationService(port=0, device="cpu")
        session = service.add_tenant(port_service.TenantSpec(
            name="alpha", model="linear", async_buffer_k=8,
            quota=port_service.TenantQuota(ingest_capacity=4)))
        assert session.cost_report is not None and session.cost_report.peak_bytes == 0
        fp = session.footprint()
        p = session.param_count
        assert fp.resident_bytes == (2 + 4) * p * 4
        assert fp.peak_extra_bytes == (8 + 2) * p * 4
        assert fp.basis == "analytic: 2x params + ingest buffer; peak (K+2)*P*4"
        session.cost_report = dataclasses.replace(
            session.cost_report, peak_bytes=123, argument_bytes=40, output_bytes=8,
            temp_bytes=4)
        measured = session.footprint()
        assert measured.peak_extra_bytes == 52 and "max_memory_allocated" in measured.basis
        assert measured.resident_bytes == fp.resident_bytes

    asyncio.run(scenario())


def test_service_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("NANOFED_AUTOTUNE_HBM_BUDGET", raising=False)
    for build in (lambda: port_service.FederationService(port=0),
                  lambda: port_sched.RoundScheduler(),
                  lambda: port_service.run_tenant_service(out_dir=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
