"""The chaos scenarios of ``tests/integration/test_chaos.py`` run in both packages, on
the CPU, on a ``VirtualClock``, with the same fault plan and the linear model's JAX
weights carried across: the port's chaos hooks (``HTTPServer(chaos=, clock=)``,
``HTTPClient(wire_filter=)`` through ``faults.ChaosClient``,
``NetworkCoordinator(chaos=)``, ``Coordinator(chaos=)``) against the JAX package's.

Each package's clients train with its own local fit; the port's fit is given the
permutations the JAX fit draws from the same key, so the two fits agree to float32
rounding.  Compared:
- (a) 25% crashes with eviction and the chaos smoke: statuses, evictions, the
  barrier's requirement and the fault counts (which live clients close a barrier at
  the completion rate is a socket race in both packages, so params are not compared);
- (b) a server kill and restart: the crash, the resumed round, statuses, per-round
  losses within 1e-5 and final params within 1e-5 of the JAX run;
- (c) a lost ACK's duplicates: the global params move exactly once, in both (1e-6);
- (d) wire faults at both boundaries (drops a retry gets past, a corrupted body,
  a lost ACK, duplicates, a server-side delay): statuses, the fault counts and the
  server's update counters by result;
- (e) the simulator's planned crashes: the same cohorts every round, the same
  statuses at a completion rate that fails every round and at one that completes
  them, the same crash counts.
Servers listen on fixed ports 19700-19709, apart from the JAX tests' 19050+."""

import pytest

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")

import asyncio
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import nanofed_tpu.communication as jax_comm
import nanofed_tpu.faults as jax_faults
import nanofed_tpu_torch.communication as port_comm
import nanofed_tpu_torch.faults as port_faults
from nanofed_tpu.core.exceptions import NanoFedError as JaxNanoFedError
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry
from nanofed_tpu.persistence.state_store import FileStateStore as JaxStateStore
from nanofed_tpu.persistence.state_store import is_recoverable as jax_is_recoverable
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import make_local_fit as jax_make_local_fit
from nanofed_tpu.utils.clock import VirtualClock as JaxVirtualClock
from nanofed_tpu.utils.trees import tree_ravel
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.persistence import FileStateStore, is_recoverable
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.trainer.local import make_local_fit
from nanofed_tpu_torch.utils.clock import VirtualClock
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel

PORT = 19700
HYPER = dict(batch_size=8, local_epochs=1, learning_rate=0.1)

_JAX_MODEL = jax_get_model("linear", in_features=6, num_classes=2)
TEMPLATE = jax.tree.map(np.asarray, _JAX_MODEL.init(jax.random.key(0)))
_JAX_FIT = jax.jit(jax_make_local_fit(_JAX_MODEL.apply, JaxTrainingConfig(**HYPER)))
_PORT_FIT = make_local_fit(get_model("linear", in_features=6, num_classes=2),
                           TrainingConfig(**HYPER))


def _client_arrays(idx: int):
    r = np.random.default_rng(100 + idx)
    x = r.normal(size=(16, 6)).astype(np.float32)
    w = r.normal(size=(6,))
    y = (x @ w > 0).astype(np.int32)
    return x, y, np.ones((16,), np.float32)


def _jax_fit(params, idx, rnd):
    x, y, mask = _client_arrays(idx)
    res = _JAX_FIT(jax.tree.map(jnp.asarray, params),
                   JaxClientData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask)),
                   jax.random.key(1000 * rnd + idx))
    return res.params, float(res.metrics.loss)


def _jax_perms(key, epochs: int, n: int) -> torch.Tensor:
    """The permutations the JAX fit draws from its key (epoch keys, each split, the
    first half permutes)."""
    keys = jax.random.split(key, epochs)
    perms = jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.asarray(perms).astype(np.int64))[None]


def _port_fit(params, idx, rnd):
    x, y, mask = _client_arrays(idx)
    data = ClientData(torch.from_numpy(x)[None], torch.from_numpy(y)[None],
                      torch.from_numpy(mask)[None])
    res = _PORT_FIT(params, data, _jax_perms(jax.random.key(1000 * rnd + idx), 1, 16))
    return {k: v[0] for k, v in res.params.items()}, float(res.metrics.loss[0])


PKGS = {
    "jax": SimpleNamespace(
        comm=jax_comm, faults=jax_faults, Registry=JaxRegistry, Clock=JaxVirtualClock,
        StateStore=JaxStateStore, is_recoverable=jax_is_recoverable, error=JaxNanoFedError,
        template=lambda: jax.tree.map(jnp.asarray, TEMPLATE), fit=_jax_fit,
        flat=lambda p: np.asarray(tree_ravel(p)[0]), coordinator_kwargs={},
        vector=lambda v: {"w": jnp.asarray(v, jnp.float32)},
    ),
    "port": SimpleNamespace(
        comm=port_comm, faults=port_faults, Registry=MetricsRegistry, Clock=VirtualClock,
        StateStore=FileStateStore, is_recoverable=is_recoverable, error=NanoFedError,
        template=lambda: from_numpy_params(TEMPLATE, device="cpu"), fit=_port_fit,
        flat=lambda p: ravel(p).numpy(), coordinator_kwargs={"device": "cpu"},
        vector=lambda v: {"w": torch.tensor(v, dtype=torch.float32)},
    ),
}

async def _run_client(pkg, cid, idx, port, clock, schedule, registry, resubmit_after=2.0,
                      start_delay_s=0.0):
    """test_chaos.py's scripted client: fetch, train (deterministic in (round,
    client)), submit with retries under the plan; re-submit if the same round stays
    open ``resubmit_after`` virtual seconds after the submit (a restarted server lost
    its buffer)."""
    if start_delay_s:
        await clock.sleep(start_delay_s)
    retry = pkg.comm.RetryPolicy(max_attempts=10, base_backoff_s=0.02, max_backoff_s=0.5,
                                 seed=1234)
    template = pkg.template()
    async with pkg.comm.HTTPClient(f"http://127.0.0.1:{port}", cid, timeout_s=60,
                                   registry=registry, retry=retry, clock=clock) as client:
        chaos = pkg.faults.ChaosClient(client, schedule, clock=clock) if schedule else None
        submitted: dict[int, float] = {}
        while True:
            try:
                params, rnd, active = await client.fetch_global_model(like=template)
            except pkg.error:
                return  # the server is gone past the retry budget
            if not active:
                return
            if chaos is not None and not chaos.alive(rnd):
                return  # a planned crash: silence
            if rnd in submitted and clock.time() - submitted[rnd] < resubmit_after:
                await clock.sleep(0.05)
                continue
            trained, loss = pkg.fit(params, idx, rnd)
            metrics = {"loss": loss, "num_samples": 16.0}
            if chaos is not None:
                await chaos.submit(trained, metrics, rnd)
            else:
                await client.submit_update(trained, metrics)
            submitted[rnd] = clock.time()
            await clock.sleep(0.05)


def _telemetry(path):
    return [json.loads(line) for line in (path / "telemetry.jsonl").read_text().splitlines()]


def _crashes_with_eviction(name, tmp_path):
    pkg = PKGS[name]
    registry = pkg.Registry()
    plan = pkg.faults.FaultPlan(seed=11, events=(
        pkg.faults.FaultEvent(kind="crash", round=1, client="c6"),
        pkg.faults.FaultEvent(kind="crash", round=1, client="c7"),
    ))
    schedule = pkg.faults.ChaosSchedule(plan, registry=registry)
    clock = pkg.Clock()
    port = PORT + (0 if name == "jax" else 1)

    async def main():
        server = pkg.comm.HTTPServer(port=port, registry=registry, clock=clock)
        coordinator = pkg.comm.NetworkCoordinator(
            server, pkg.template(),
            pkg.comm.NetworkRoundConfig(num_rounds=5, min_clients=8, min_completion_rate=0.75,
                                        round_timeout_s=20.0, poll_interval_s=0.01,
                                        straggler_evict_after=3),
            telemetry_dir=tmp_path / name, registry=registry, clock=clock,
            **pkg.coordinator_kwargs)
        await server.start()
        try:
            # The doomed pair submits round 0 first, so the round-0 barrier sees it.
            tasks = [asyncio.create_task(_run_client(
                pkg, f"c{i}", i, port, clock, schedule, registry,
                start_delay_s=0.0 if i >= 6 else 0.001)) for i in range(8)]
            history = await coordinator.run()
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=60)
            return history
        finally:
            await server.stop()

    history = asyncio.run(main())
    rounds = [t for t in _telemetry(tmp_path / name) if t.get("type") == "round"]
    return {
        "statuses": [h["status"] for h in history],
        "evicted": sorted(c for h in history for c in h.get("evicted_stragglers", ())),
        "required": [h["required"] for h in history],
        "mid_clients": [h["num_clients"] for h in history[2:4]],
        "counts": schedule.counts(),
        "crash_sample": 'nanofed_faults_injected_total{kind="crash"} 2'
                        in registry.render_prometheus(),
        "telemetry_rounds": len(rounds),
    }


def test_round_survives_25pct_crashes_with_eviction_as_jax(tmp_path):
    want = _crashes_with_eviction("jax", tmp_path)
    got = _crashes_with_eviction("port", tmp_path)
    assert got == want
    assert got["statuses"] == ["COMPLETED"] * 5 and got["evicted"] == ["c6", "c7"]
    assert got["required"][-1] == 5 and got["mid_clients"] == [6, 6]
    assert got["counts"] == {"crash": 2} and got["crash_sample"]


def _kill_restart(name, tmp_path):
    pkg = PKGS[name]
    registry = pkg.Registry()
    clock = pkg.Clock()
    port = PORT + (2 if name == "jax" else 3)
    config = dict(num_rounds=6, min_clients=4, min_completion_rate=1.0, round_timeout_s=30.0,
                  poll_interval_s=0.01)
    state = tmp_path / name / "state"
    schedule = pkg.faults.ChaosSchedule(
        pkg.faults.FaultPlan(seed=7, events=(pkg.faults.FaultEvent(kind="server_kill",
                                                                   round=3),)),
        registry=registry)
    out = {}

    async def chaotic():
        tasks = [asyncio.create_task(_run_client(pkg, f"c{i}", i, port, clock, None, registry))
                 for i in range(4)]

        async def incarnation():
            server = pkg.comm.HTTPServer(port=port, registry=registry, clock=clock)
            coordinator = pkg.comm.NetworkCoordinator(
                server, pkg.template(), pkg.comm.NetworkRoundConfig(**config),
                registry=registry, clock=clock, state_store=pkg.StateStore(state),
                chaos=schedule, **pkg.coordinator_kwargs)
            await server.start()
            try:
                return coordinator, await coordinator.run(), None
            except pkg.faults.InjectedServerCrash as crash:
                return coordinator, list(coordinator.history), crash
            finally:
                await server.stop()

        try:
            coord1, h1, crash = await incarnation()
            out["crash_recoverable"] = crash is not None and pkg.is_recoverable(crash)
            out["start_rounds"] = [coord1.start_round]
            coord2, h2, crash2 = await incarnation()
            out["second_crash"] = crash2
            out["start_rounds"].append(coord2.start_round)
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=120)
            return h1 + h2, coord2.params
        finally:
            for t in tasks:
                t.cancel()

    history, params = asyncio.run(chaotic())
    out.update(
        rounds=[h["round"] for h in history], statuses=[h["status"] for h in history],
        losses=[h["metrics"]["loss"] for h in history], params=pkg.flat(params),
        last_checkpoint=pkg.StateStore(state).restore_latest().round_number,
        counts=schedule.counts(),
        kill_sample='nanofed_faults_injected_total{kind="server_kill"} 1'
                    in registry.render_prometheus())
    return out


def test_server_kill_restart_resumes_as_jax(tmp_path):
    want = _kill_restart("jax", tmp_path)
    got = _kill_restart("port", tmp_path)
    for key in ("crash_recoverable", "start_rounds", "second_crash", "rounds", "statuses",
                "last_checkpoint", "counts", "kill_sample"):
        assert got[key] == want[key], key
    assert got["crash_recoverable"] and got["start_rounds"] == [0, 3]
    assert got["statuses"] == ["COMPLETED"] * 6 and got["rounds"] == list(range(6))
    assert got["last_checkpoint"] == 5 and got["counts"] == {"server_kill": 1}
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


def _duplicates(name):
    pkg = PKGS[name]
    registry = pkg.Registry()
    clock = pkg.Clock()
    port = PORT + (4 if name == "jax" else 5)
    schedule = pkg.faults.ChaosSchedule(pkg.faults.FaultPlan(seed=5, events=(
        pkg.faults.FaultEvent(kind="ack_drop", round=0, client="c1", count=1),)),
        registry=registry)
    base, trained = pkg.vector([0.0] * 4), pkg.vector([1.0] * 4)  # known delta: +1

    async def main():
        server = pkg.comm.HTTPServer(port=port, registry=registry, clock=clock, chaos=schedule)
        coordinator = pkg.comm.NetworkCoordinator(
            server, base,
            pkg.comm.NetworkRoundConfig(num_rounds=1, async_buffer_k=1, staleness_window=2,
                                        round_timeout_s=10.0, poll_interval_s=0.001),
            registry=registry, clock=clock, **pkg.coordinator_kwargs)
        await server.start()
        try:
            async def client():
                async with pkg.comm.HTTPClient(
                        f"http://127.0.0.1:{port}", "c1", timeout_s=30, registry=registry,
                        clock=clock,
                        retry=pkg.comm.RetryPolicy(max_attempts=6, base_backoff_s=0.05,
                                                   seed=0)) as c:
                    await c.fetch_global_model(like=base)
                    oks = [await c.submit_update(trained, {"loss": 0.5})]
                    for _ in range(3):  # keep the storm going after the drain
                        oks.append(await c.resend_last_update())
                    return oks

            task = asyncio.create_task(client())
            history = await coordinator.run()
            oks = await asyncio.wait_for(task, timeout=60)
            return history, coordinator, server, oks
        finally:
            await server.stop()

    history, coordinator, server, oks = asyncio.run(main())
    text = registry.render_prometheus()
    return {
        "oks": oks, "status": history[0]["status"], "clients": history[0]["num_clients"],
        "params": pkg.flat(coordinator.params).tolist(), "buffered": server.num_updates(),
        "ack_drop_sample": 'nanofed_faults_injected_total{kind="ack_drop"} 1' in text,
        "duplicate_seen": 'result="duplicate"' in text, "counts": schedule.counts(),
    }


def test_duplicate_submits_change_global_params_exactly_once_as_jax():
    want = _duplicates("jax")
    got = _duplicates("port")
    assert got.keys() == want.keys()
    for key in got:
        if key != "params":
            assert got[key] == want[key], key
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-6)
    np.testing.assert_allclose(got["params"], np.ones(4), atol=1e-6)
    assert got["status"] == "COMPLETED" and got["buffered"] == 0 and got["duplicate_seen"]


def _chaos_smoke(name, tmp_path):
    pkg = PKGS[name]
    registry = pkg.Registry()
    plan = pkg.faults.FaultPlan.generate(seed=6, clients=[f"c{i}" for i in range(8)],
                                         num_rounds=3, crash_fraction=1 / 8,
                                         straggler_fraction=1 / 8, straggler_delay_s=3.0)
    schedule = pkg.faults.ChaosSchedule(plan, registry=registry)
    clock = pkg.Clock()
    port = PORT + (6 if name == "jax" else 7)

    async def main():
        server = pkg.comm.HTTPServer(port=port, registry=registry, clock=clock, chaos=schedule)
        coordinator = pkg.comm.NetworkCoordinator(
            server, pkg.template(),
            pkg.comm.NetworkRoundConfig(num_rounds=3, min_clients=8, min_completion_rate=0.75,
                                        round_timeout_s=20.0, poll_interval_s=0.01,
                                        straggler_evict_after=2),
            telemetry_dir=tmp_path / name, registry=registry, clock=clock, chaos=schedule,
            **pkg.coordinator_kwargs)
        await server.start()
        try:
            tasks = [asyncio.create_task(_run_client(pkg, f"c{i}", i, port, clock, schedule,
                                                     registry)) for i in range(8)]
            history = await coordinator.run()
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=60)
            return history
        finally:
            await server.stop()

    history = asyncio.run(main())
    return {"plan": plan.to_json(), "statuses": [h["status"] for h in history],
            "crashes": schedule.counts().get("crash", 0),
            "telemetry": (tmp_path / name / "telemetry.jsonl").exists()}


def test_chaos_smoke_as_jax(tmp_path):
    want = _chaos_smoke("jax", tmp_path)
    got = _chaos_smoke("port", tmp_path)
    assert got == want
    assert got["statuses"] == ["COMPLETED"] * 3 and got["crashes"] == 1 and got["telemetry"]


def _wire_faults(name):
    pkg = PKGS[name]
    registry = pkg.Registry()
    ev = pkg.faults.FaultEvent
    schedule = pkg.faults.ChaosSchedule(pkg.faults.FaultPlan(seed=2, events=(
        ev(kind="drop", round=0, client="c0", count=2),
        ev(kind="duplicate", round=0, client="c2", count=2),
        ev(kind="delay", round=1, client="c2", seconds=0.5),
        ev(kind="corrupt", round=1, client="c1"),
        ev(kind="ack_drop", round=1, client="c3"),
    )), registry=registry)
    clock = pkg.Clock()
    port = PORT + (8 if name == "jax" else 9)

    async def main():
        server = pkg.comm.HTTPServer(port=port, registry=registry, clock=clock, chaos=schedule)
        coordinator = pkg.comm.NetworkCoordinator(
            server, pkg.template(),
            pkg.comm.NetworkRoundConfig(num_rounds=3, min_clients=4, min_completion_rate=1.0,
                                        round_timeout_s=20.0, poll_interval_s=0.01),
            registry=registry, clock=clock, chaos=schedule, **pkg.coordinator_kwargs)
        await server.start()
        try:
            tasks = [asyncio.create_task(_run_client(pkg, f"c{i}", i, port, clock, schedule,
                                                     registry)) for i in range(4)]
            history = await coordinator.run()
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=60)
            return history, coordinator.params
        finally:
            await server.stop()

    history, params = asyncio.run(main())
    # Accepted and stale-round counts depend on when the clients' re-submits land; the
    # rejected body and the folded duplicates do not.
    updates = sorted(line for line in registry.render_prometheus().splitlines()
                     if line.startswith("nanofed_updates_total{")
                     and ('result="bad_payload"' in line or 'result="duplicate"' in line))
    return {"statuses": [h["status"] for h in history],
            "clients": [h["num_clients"] for h in history], "counts": schedule.counts(),
            "updates": updates, "params": pkg.flat(params)}


def test_wire_faults_at_both_boundaries_as_jax():
    """Every client must report every round (completion 1.0), so each fault has to be
    survived: the drops by the retry policy, the corrupted body by the client's
    re-submit of the still-open round, the lost ACK and the duplicates by the
    server's dedupe.  Each round then holds the same four updates in both packages."""
    want = _wire_faults("jax")
    got = _wire_faults("port")
    for key in ("statuses", "clients", "counts", "updates"):
        assert got[key] == want[key], key
    assert got["statuses"] == ["COMPLETED"] * 3 and got["clients"] == [4, 4, 4]
    assert got["counts"] == {"drop": 2, "duplicate": 1, "delay": 1, "corrupt": 1,
                             "ack_drop": 1}
    assert got["updates"] == ['nanofed_updates_total{kind="plain",result="bad_payload"} 1',
                              'nanofed_updates_total{kind="plain",result="duplicate"} 3']
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


def _simulators(tmp_path, completion, plan_kw):
    from nanofed_tpu.data import federate as jax_federate
    from nanofed_tpu.data import synthetic_classification as jax_synthetic
    from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
    from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
    from nanofed_tpu_torch.data import federate, synthetic_classification
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

    cfg = dict(num_rounds=2, min_completion_rate=completion, seed=0, save_metrics=False,
               participation_rate=0.75, dropout_rate=0.1)
    training = dict(batch_size=16, local_epochs=1)
    model_kw = dict(in_features=8, hidden=8, num_classes=3)
    plans = {n: PKGS[n].faults.FaultPlan.generate(3, list(range(8)), 2, **plan_kw)
             for n in PKGS}
    schedules = {n: PKGS[n].faults.ChaosSchedule(plans[n], registry=PKGS[n].Registry())
                 for n in PKGS}
    theirs = JaxCoordinator(
        model=jax_get_model("mlp", **model_kw),
        train_data=jax_federate(jax_synthetic(256, 3, (8,), seed=0), num_clients=8,
                                scheme="iid", batch_size=16),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **cfg),
        training=JaxTrainingConfig(**training), chaos=schedules["jax"])
    ours = Coordinator(
        model=get_model("mlp", **model_kw),
        train_data=federate(synthetic_classification(256, 3, (8,), seed=0), num_clients=8,
                            scheme="iid", batch_size=16),
        config=CoordinatorConfig(base_dir=tmp_path / "torch", **cfg),
        training=TrainingConfig(**training), chaos=schedules["port"], device="cpu")
    return theirs, ours, schedules


@pytest.mark.parametrize("completion,expect", [(0.9, "FAILED"), (0.3, "COMPLETED")])
def test_simulator_crashes_gate_rounds_as_jax(tmp_path, completion, expect):
    theirs, ours, schedules = _simulators(tmp_path, completion, dict(crash_fraction=0.25))
    for round_id in range(4):
        np.testing.assert_array_equal(ours._sample_cohort(round_id),
                                      theirs._sample_cohort(round_id))
    theirs, ours, schedules = _simulators(tmp_path, completion, dict(crash_fraction=0.25))
    want, got = theirs.run(), ours.run()
    assert [r.status.name for r in got] == [r.status.name for r in want] == [expect] * 2
    assert [r.num_clients for r in got] == [r.num_clients for r in want]
    assert schedules["port"].counts() == schedules["jax"].counts() == {"crash": 2}
