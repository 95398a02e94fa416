"""The host-local stage of a hierarchical federation in the port: the ingest buffer's
partial drains (``DeviceIngestBuffer``, ``IngestPipeline``, ``HTTPServer``),
``communication.federation``, ``persistence.GenerationStore`` and
``parallel.resilience``, held against the JAX package on the CPU.

The JAX program builders of ``nanofed_tpu/communication/federation.py`` fail under
this jax (``shard_map`` lost ``check_vma``), so the cross-host reduce is held against
the JAX package's numpy helpers (``host_partial_row``, ``apply_summed_row``), its
buffer's own partial drains, and the numpy ``einsum`` oracle of
``tests/integration/test_ingest_parity.py``; a world of two gloo ranks is the two hosts.

Tolerances: the partial drains 1e-6 against the JAX buffer's (float32 products in
another order); partials summed across hosts 1e-6 against one buffer draining the
union and against the float64 oracle; the row helpers bit for bit.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_world_ranks as W

import nanofed_tpu.communication as jax_comm
from nanofed_tpu.communication.federation import apply_summed_row as jax_apply_summed_row
from nanofed_tpu.communication.federation import host_partial_row as jax_host_partial_row
from nanofed_tpu.ingest import DeviceIngestBuffer as JaxBuffer
from nanofed_tpu.ingest import IngestConfig as JaxIngestConfig
from nanofed_tpu.parallel.resilience import HostMonitor as JaxHostMonitor
from nanofed_tpu.persistence import GenerationStore as JaxGenerationStore
from nanofed_tpu_torch import communication as port_comm
from nanofed_tpu_torch.communication.federation import (
    MASS_LANE,
    apply_summed_row,
    build_cross_host_row_psum,
    host_partial_row,
)
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.ingest import DeviceIngestBuffer, IngestConfig, IngestPipeline
from nanofed_tpu_torch.observability import MetricsRegistry
from nanofed_tpu_torch.parallel import (
    CollectiveWatchdog,
    Heartbeat,
    HostFailure,
    HostMonitor,
    no_orphans,
    resilience_metrics,
)
from nanofed_tpu_torch.parallel.launch import spawn_world
from nanofed_tpu_torch.parallel.mesh import Mesh
from nanofed_tpu_torch.persistence import GenerationStore, is_recoverable
from nanofed_tpu_torch.utils.clock import VirtualClock
from nanofed_tpu_torch.utils.trees import from_numpy_params

TOL = dict(rtol=0, atol=1e-6)
NESTED = {"layer": {"bias": np.zeros(5, np.float32), "kernel": np.zeros((4, 8), np.float32)}}
FLAT = 37  # NESTED's parameter count


def _deltas(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=FLAT).astype(np.float32) for _ in range(n)]


def _buffers(capacity=6):
    port = DeviceIngestBuffer(from_numpy_params(NESTED, device="cpu"), capacity, device="cpu")
    ref = JaxBuffer({"layer": {k: jnp.asarray(v) for k, v in NESTED["layer"].items()}},
                    capacity, warm_batch=1)
    return port, ref


def _offer_both(port, ref, rows):
    for cid, delta, weight, version in rows:
        for buf in (port, ref):
            assert buf.offer(delta, client_id=cid, round_number=version,
                             weight=weight) is not None


# ---------------------------------------------------------------------------
# The partial drains
# ---------------------------------------------------------------------------


def test_fedavg_partial_drain_matches_jax():
    port, ref = _buffers()
    deltas = _deltas(4)
    _offer_both(port, ref, [(f"c{i}", d, float(i + 1), 0) for i, d in enumerate(deltas)])
    (out, mass, metas), (jout, jmass, jmetas) = (port.drain_fedavg_partial(),
                                                 ref.drain_fedavg_partial())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert mass == jmass == 10.0
    assert [m.client_id for m in metas] == [m.client_id for m in jmetas]
    assert port.fill == ref.fill == 0
    # Freed rows stay zeroed in the port (a stated difference from the reference).
    assert not port._buf.any()
    assert port.drain_fedavg_partial() == ref.drain_fedavg_partial() == (None, 0.0, [])


def test_fedbuff_partial_drain_matches_jax_with_its_window_contract():
    port, ref = _buffers()
    deltas = _deltas(5, seed=1)
    # Arrival order: an out-of-window base first, then in-window ones at staleness 0-1.
    rows = [("old", deltas[0], 1.0, 0), ("a", deltas[1], 1.0, 1), ("b", deltas[2], 1.0, 2),
            ("c", deltas[3], 1.0, 1), ("d", deltas[4], 1.0, 2)]
    _offer_both(port, ref, rows)
    got = port.drain_fedbuff_partial(3, 2, (1, 2), staleness_exponent=0.5)
    want = ref.drain_fedbuff_partial(3, 2, (1, 2), staleness_exponent=0.5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert [m.client_id for m in got[1]] == [m.client_id for m in want[1]] == ["a", "b"]
    assert got[2] == want[2] and got[2]["num_skipped_out_of_window"] == 1
    assert port.fill == ref.fill == 2  # the newer slots stay
    # Every remaining base leaves the window: both consume the slots and raise.
    for buf in (port, ref):
        with pytest.raises(ValueError, match="left the version window"):
            buf.drain_fedbuff_partial(4, 9, (8, 9))
        assert buf.fill == 0


def test_two_buffers_partials_summed_equal_the_union_drain():
    """Each host drains its own clients unnormalised; summed and divided once, the
    partials are the union's FedAvg drain and its FedBuff (K = 4, lr 1) step."""
    deltas = _deltas(4, seed=2)
    base = np.random.default_rng(3).normal(size=FLAT).astype(np.float32)
    weights = [3.0, 1.0, 2.0, 5.0]
    hosts = [DeviceIngestBuffer(from_numpy_params(NESTED, device="cpu"), 4, device="cpu")
             for _ in range(2)]
    union = DeviceIngestBuffer(from_numpy_params(NESTED, device="cpu"), 4, device="cpu")
    for i, (d, w) in enumerate(zip(deltas, weights)):
        hosts[i % 2].offer(d, client_id=f"c{i}", round_number=0, weight=w)
        union.offer(d, client_id=f"c{i}", round_number=0, weight=w)
    rows = [host_partial_row(*h.drain_fedavg_partial()[:2], FLAT) for h in hosts]
    new, tail = apply_summed_row(base, rows[0] + rows[1], FLAT)
    want, _ = union.drain_fedavg(base)
    np.testing.assert_allclose(new.numpy(), want.numpy(), **TOL)
    assert float(tail[0]) == sum(weights)

    versions = [1, 2, 2, 1]
    for i, (d, v) in enumerate(zip(deltas, versions)):
        hosts[i % 2].offer(d, client_id=f"c{i}", round_number=v, weight=1.0)
        union.offer(d, client_id=f"c{i}", round_number=v, weight=1.0)
    rows = []
    for h in hosts:
        num, live, _ = h.drain_fedbuff_partial(2, 2, (1, 2))
        rows.append(host_partial_row(num, len(live), FLAT))
    new, tail = apply_summed_row(base, rows[0] + rows[1], FLAT)
    want, live, _ = union.drain_fedbuff(4, 2, (1, 2), base)
    np.testing.assert_allclose(new.numpy(), want.numpy(), **TOL)
    assert int(tail[0]) == len(live) == 4


def test_pipeline_counts_its_partial_drains_by_policy():
    registry = MetricsRegistry()
    pipe = IngestPipeline(from_numpy_params(NESTED, device="cpu"), IngestConfig(capacity=4),
                          registry=registry, device="cpu")
    try:
        pipe.note_version(0, from_numpy_params(NESTED, device="cpu"), window=2)
        pipe.offer(_deltas(1)[0], client_id="a", round_number=0, metrics={"num_samples": 3})
        out, mass, metas = pipe.drain_fedavg_partial()
        assert mass == 3.0 and len(metas) == 1 and out.shape == (FLAT,)
        pipe.offer(_deltas(1)[0], client_id="a", round_number=0)
        _, live, stats = pipe.drain_fedbuff_partial(1, 0)
        assert len(live) == 1 and stats["num_aggregated"] == 1
        drains = registry.counter("nanofed_ingest_drains_total", labels=("policy",))
        assert drains.value(policy="fedavg_partial") == drains.value(
            policy="fedbuff_partial") == 1
    finally:
        pipe.close()


def test_server_partial_drains_match_the_jax_server():
    """Two submits to an ingest server of each package; the host-local FedAvg stage
    drains the same numerator and mass, under the server's lock."""
    import aiohttp

    async def one(pkg):
        if pkg == "port":
            server = port_comm.HTTPServer(port=free_port(), ingest=IngestConfig(capacity=4),
                                          device="cpu")
            params = from_numpy_params(NESTED, device="cpu")
        else:
            server = jax_comm.HTTPServer(port=free_port(),
                                         ingest=JaxIngestConfig(capacity=4))
            params = {"layer": {k: jnp.asarray(v) for k, v in NESTED["layer"].items()}}
        await server.start()
        try:
            await server.publish_model(params, 0)
            url = f"http://127.0.0.1:{server.port}/update"
            async with aiohttp.ClientSession() as session:
                for i, cid in enumerate(("a", "b")):
                    sent = {k: v + (i + 1) for k, v in
                            from_numpy_params(NESTED, device="cpu").items()}
                    headers = {"X-NanoFed-Client": cid, "X-NanoFed-Round": "0",
                               "X-NanoFed-Metrics": json.dumps({"num_samples": 2 + i})}
                    async with session.post(url, data=port_comm.encode_params(sent),
                                            headers=headers) as r:
                        assert r.status == 200, await r.text()
            num, mass, metas = await server.drain_ingest_fedavg_partial()
            empty = await server.drain_ingest_fedavg_partial()
            return np.asarray(num), mass, sorted(m.client_id for m in metas), empty
        finally:
            await server.stop()

    (num, mass, ids, empty), (jnum, jmass, jids, jempty) = (asyncio.run(one("port")),
                                                            asyncio.run(one("jax")))
    np.testing.assert_allclose(num, jnum, **TOL)
    assert mass == jmass == 5.0 and ids == jids == ["a", "b"]
    assert empty == jempty == (None, 0.0, [])


# ---------------------------------------------------------------------------
# The cross-host reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("empty", [False, True])
def test_row_helpers_match_jax_bit_for_bit(empty):
    rng = np.random.default_rng(4)
    partial = None if empty else rng.normal(size=FLAT).astype(np.float32)
    extra = (1.0, 0.0)
    got = host_partial_row(None if empty else torch.from_numpy(partial), 7.5, FLAT,
                           extra=extra, device="cpu")
    want = jax_host_partial_row(partial, 7.5, FLAT, extra=extra)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (FLAT + MASS_LANE + len(extra),)
    base = rng.normal(size=FLAT).astype(np.float32)
    total = want + jax_host_partial_row(rng.normal(size=FLAT).astype(np.float32), 2.25, FLAT,
                                        extra=extra)
    new, tail = apply_summed_row(torch.from_numpy(base), torch.from_numpy(total), FLAT)
    jnew, jtail = jax_apply_summed_row(base, total, FLAT)
    np.testing.assert_array_equal(new.numpy(), jnew)
    np.testing.assert_array_equal(tail.numpy(), jtail)
    # Every host empty: the mass floor keeps the base exactly.
    zero = jax_host_partial_row(None, 0.0, FLAT)
    new, tail = apply_summed_row(torch.from_numpy(base), torch.from_numpy(zero), FLAT)
    np.testing.assert_array_equal(new.numpy(), base)
    assert float(tail[0]) == 0.0


def test_cross_host_builders_need_a_hosts_axis():
    with pytest.raises(ValueError, match="'hosts' axis"):
        build_cross_host_row_psum(Mesh.describe((2, 2), 0))


@pytest.fixture(scope="module")
def federation(tmp_path_factory):
    rng = np.random.default_rng(5)
    hosts = [[(f"h{h}c{i}", rng.normal(size=FLAT).astype(np.float32),
               float(rng.integers(1, 9)), [0, 1, 2][(h + i) % 3]) for i in range(3)]
             for h in range(2)]
    inputs = dict(hosts=hosts, base=rng.normal(size=FLAT).astype(np.float32),
                  slabs=rng.normal(size=(2, 4, FLAT)).astype(np.float32),
                  coefs=np.abs(rng.normal(size=(2, 4))).astype(np.float32))
    inputs["coefs"][0, 1] = 0.0  # an unoccupied slot
    tmp = tmp_path_factory.mktemp("generations")
    out = spawn_world(W.federation_world, 2, backend="gloo", device="cpu", timeout_s=120,
                      args=(inputs, str(tmp)))
    return inputs, out, tmp


def test_two_hosts_row_all_reduce_matches_the_einsum_oracle(federation):
    inputs, out, _ = federation
    clients = [c for host in inputs["hosts"] for c in host]
    deltas = np.stack([c[1] for c in clients]).astype(np.float64)
    weights = np.asarray([c[2] for c in clients])
    want = inputs["base"] + np.einsum("c,cp->p", weights, deltas) / weights.sum()
    for r in out:
        new, tail = r["fedavg"]
        np.testing.assert_allclose(new, want, **TOL)
        assert tail[0] == weights.sum() and tail[1] == 2.0  # the mass and one vote a host
        np.testing.assert_array_equal(new, out[0]["fedavg"][0])  # the same bits


def test_the_row_crosses_hosts_in_exactly_one_all_reduce(federation):
    _, out, _ = federation
    assert all(r["all_reduces"] == [FLAT + 2] for r in out)  # P + mass + one vote lane


def test_two_hosts_fedbuff_step_matches_the_oracle(federation):
    inputs, out, _ = federation
    clients = [c for host in inputs["hosts"] for c in host]
    live = [c for c in clients if c[3] in (1, 2)]
    discounts = np.asarray([(1.0 + 2 - c[3]) ** -0.5 for c in live])
    want = inputs["base"] + np.einsum(
        "c,cp->p", discounts, np.stack([c[1] for c in live]).astype(np.float64)) / len(live)
    for r in out:
        new, tail, stats = r["fedbuff"]
        np.testing.assert_allclose(new, want, **TOL)
        assert int(tail[0]) == len(live)
    assert sum(r["fedbuff"][2]["num_skipped_out_of_window"] for r in out) == len(clients) - len(live)


def test_fused_slab_reduce_matches_the_einsum_oracle(federation):
    inputs, out, _ = federation
    coefs, slabs = inputs["coefs"].astype(np.float64), inputs["slabs"].astype(np.float64)
    want = inputs["base"] + np.einsum("sc,scp->p", coefs, slabs) / coefs.sum()
    for r in out:
        np.testing.assert_allclose(r["fused"], want, **TOL)


def test_both_hosts_commit_and_read_the_generation(federation):
    _, out, tmp = federation
    for r in out:
        assert r["generation"] == (0, 0, (0, 1), {"by": "port"})
    record = JaxGenerationStore(tmp).latest_complete()  # the JAX store reads it
    assert record.generation == 0 and record.hosts == (0, 1)
    np.testing.assert_array_equal(np.asarray(record.params["w"]), out[0]["fedbuff"][0])


def test_hosts_import_no_jax(federation):
    assert all(r["_imports"] == [] for r in federation[1])


# ---------------------------------------------------------------------------
# GenerationStore
# ---------------------------------------------------------------------------


def _params(v):
    return {"layer": {"bias": np.full(5, v, np.float32), "kernel": np.full((4, 8), v,
                                                                            np.float32)}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_generation_store_agrees_with_jax_on_one_directory(tmp_path, writer):
    stores = {"port": GenerationStore, "jax": JaxGenerationStore}
    write, read = stores[writer], stores["jax" if writer == "port" else "port"]
    for host in (0, 1):  # generation 0: both hosts
        write(tmp_path, host=host).commit(0, 3, _params(1.0), {"n": 1}, hosts=[0, 1])
    write(tmp_path, host=0).commit(1, 7, _params(2.0), {"n": 2}, hosts=[0, 1])  # torn
    write(tmp_path, host=0).commit(2, 9, _params(3.0), {}, hosts=[0])  # a reshaped set
    write(tmp_path, host=1).commit(2, 9, _params(3.0), {}, hosts=[0, 1])
    (tmp_path / "generations" / "gen_3").mkdir()
    (tmp_path / "generations" / "gen_3" / "host_0.commit.json").write_text("{torn")
    for store in (read(tmp_path), write(tmp_path), read(tmp_path, host=1)):
        assert store.generations() == [0, 1, 2]
        assert [store.is_complete(g) for g in (0, 1, 2, 3)] == [True, False, False, False]
        record = store.latest_complete()
        assert (record.generation, record.round_number, record.hosts) == (0, 3, (0, 1))
        np.testing.assert_array_equal(np.asarray(record.params["layer"]["bias"]),
                                      np.ones(5, np.float32))
    assert read(tmp_path / "empty").latest_complete() is None


def test_generation_store_writes_the_marker_after_the_state(tmp_path, monkeypatch):
    """A crash between the state and its marker leaves no marker: the generation is
    not a recovery point."""
    from nanofed_tpu_torch.persistence import generation_store

    def crash(*a, **kw):
        raise OSError("the disk went away")

    monkeypatch.setattr(generation_store, "write_text_durable", crash)
    with pytest.raises(OSError):
        GenerationStore(tmp_path, host=0).commit(0, 0, _params(1.0), {}, hosts=[0])
    assert (tmp_path / "generations" / "gen_0" / "host_0.state.pkl").exists()
    assert GenerationStore(tmp_path).generations() == []
    with pytest.raises(Exception, match="read-only"):
        GenerationStore(tmp_path).commit(0, 0, {}, {}, hosts=[0])


# ---------------------------------------------------------------------------
# Resilience
# ---------------------------------------------------------------------------


def test_a_frozen_heartbeat_is_found_on_the_monitor_clock(tmp_path):
    clock, registry = VirtualClock(), MetricsRegistry()
    beats = [Heartbeat(tmp_path, h) for h in (0, 1)]
    monitor = HostMonitor(tmp_path, stall_timeout_s=3.0, clock=clock, registry=registry)
    for b in beats:
        b.beat(round_number=0, generation=0)
    assert monitor.stalled() == []
    clock.advance(2.0)
    beats[1].beat(round_number=1)
    clock.advance(2.0)
    beats[1].beat(round_number=2)
    (failure,) = monitor.stalled()  # host 0's seq froze 4 s ago, host 1's is fresh
    assert isinstance(failure, HostFailure) and is_recoverable(failure)
    assert (failure.kind, failure.host, failure.round_number) == ("host_stall", 0, 0)
    assert monitor.stalled() == []  # flagged once
    failures = resilience_metrics(registry)["host_failures"]
    assert failures.value(kind="host_stall") == 1
    states = monitor.poll()
    assert states[1].seq == 3 and states[1].age_s == 0.0 and states[0].age_s == 4.0
    # The JAX monitor reads the port's heartbeat files the same way.
    jax_states = JaxHostMonitor(tmp_path, stall_timeout_s=3.0).poll()
    assert {h: (s.seq, s.round_number, s.status) for h, s in jax_states.items()} == {
        h: (s.seq, s.round_number, s.status) for h, s in states.items()}
    monitor.clear(0)
    beats[0].beat(round_number=3)
    assert monitor.stalled() == []


def test_the_watchdog_guard_turns_a_virtual_hang_into_host_failure():
    clock, registry = VirtualClock(), MetricsRegistry()
    watchdog = CollectiveWatchdog(5.0, clock=clock, registry=registry)

    async def main():
        async def hung():
            await clock.sleep(3600.0)  # a peer that never arrives

        async def quick():
            await clock.sleep(1.0)
            return "done"

        assert await watchdog.guard(quick()) == "done"
        with pytest.raises(HostFailure, match="collective_timeout") as err:
            await watchdog.guard(hung(), round_number=4)
        return err.value

    failure = asyncio.run(main())
    assert failure.round_number == 4 and failure.host is None
    assert clock.time() == 6.0  # 1 s of quick work, then the 5 s deadline
    assert resilience_metrics(registry)["host_failures"].value(kind="collective_timeout") == 1


def test_the_watchdog_run_deadline_ticks_and_propagates():
    watchdog = CollectiveWatchdog(0.2, registry=MetricsRegistry())
    never = threading.Event()
    ticks = []
    with pytest.raises(HostFailure, match="collective_timeout"):
        watchdog.run(never.wait, tick=lambda: ticks.append(1), tick_interval_s=0.05)
    assert len(ticks) >= 2  # the waiting host kept beating
    assert watchdog.run(lambda x: x + 1, 1) == 2
    with pytest.raises(ZeroDivisionError):
        watchdog.run(lambda: 1 / 0)
    with pytest.raises(ValueError):
        CollectiveWatchdog(0.0)


def test_no_orphans_lists_the_live_pids():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    assert no_orphans([os.getpid(), proc.pid]) == [os.getpid()]
