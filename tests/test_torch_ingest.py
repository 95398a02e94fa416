"""The port's ingest buffer and pipeline (``nanofed_tpu_torch.ingest``) and its
``fedbuff_combine`` against the JAX package's, on the CPU.

The same deltas, made from a seed with numpy, go through both.  A drain is one float32
product ``base + coefs @ buffer`` in both packages, summed in the BLAS's order, so
drains agree within 1e-6; the slot bookkeeping (which clients a drain takes, their
staleness and discounts, what stays buffered) is exact.  ``fedbuff_combine`` sums the
discounted deltas in client-id order where the JAX package sums in arrival order:
1e-6.  One stated difference: the port zeroes a freed slot's row, where the JAX
package keeps it and a NaN delta reaches every later drain (ROADMAP, the freed-slot
finding); both behaviours are pinned here.
"""

import asyncio
import math
import time

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanofed_tpu.communication as jax_comm
import nanofed_tpu_torch.communication as port_comm
from nanofed_tpu.communication.network_coordinator import fedbuff_combine as jax_fedbuff
from nanofed_tpu.core.types import ModelUpdate as JaxModelUpdate
from nanofed_tpu.ingest import DeviceIngestBuffer as JaxBuffer
from nanofed_tpu.ingest import IngestConfig as JaxIngestConfig
from nanofed_tpu.ingest import IngestPipeline as JaxPipeline
from nanofed_tpu.ingest.buffer import SlotMeta as JaxSlotMeta
from nanofed_tpu.utils.trees import tree_ravel
from nanofed_tpu_torch.communication import fedbuff_combine
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.core.types import ModelUpdate
from nanofed_tpu_torch.ingest import DeviceIngestBuffer, IngestConfig, IngestPipeline
from nanofed_tpu_torch.ingest.buffer import SlotMeta
from nanofed_tpu_torch.ingest.pipeline import flatten_params, weight_from_metrics
from nanofed_tpu_torch.observability import MetricsRegistry, new_trace
from nanofed_tpu_torch.utils.trees import flatten_with_names, from_numpy_params

NESTED = {"dense": {"bias": np.zeros(3, np.float32), "kernel": np.zeros((5, 3), np.float32)},
          "out": {"kernel": np.zeros((3, 2), np.float32)}}
P = 3 + 15 + 6
TOL = 1e-6


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, P)).astype(np.float32)


def _pair(capacity):
    port = DeviceIngestBuffer(from_numpy_params(NESTED, device="cpu"), capacity, device="cpu")
    ref = JaxBuffer(jax.tree.map(jnp.asarray, NESTED), capacity, warm_batch=2)
    return port, ref


def _offer(bufs, row, cid, rnd, weight):
    slots = [b.offer(row, client_id=cid, round_number=rnd, weight=weight,
                     metrics={"num_samples": weight}) for b in bufs]
    assert slots[0] == slots[1]
    return slots[0]


def _same_metas(ours, theirs):
    assert [(m.slot, m.client_id, m.round_number, m.weight) for m in ours] == \
        [(m.slot, m.client_id, m.round_number, m.weight) for m in theirs]


def test_fedavg_drain_with_a_replacing_offer_matches_jax():
    port, ref = _pair(4)
    rows, base = _rows(4), _rows(1, seed=9)[0]
    for i, (cid, w) in enumerate([("a", 3.0), ("b", 1.0), ("c", 2.0)]):
        _offer((port, ref), rows[i], cid, 0, w)
    _offer((port, ref), rows[3], "b", 0, 5.0)  # b's second offer replaces its first
    assert port.fill == ref.fill == 3 and all(port.has_client(c) for c in "abc")
    (ours, ometas), (theirs, tmetas) = port.drain_fedavg(base), ref.drain_fedavg(base)
    _same_metas(ometas, tmetas)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=TOL)
    want = base + (3 * rows[0] + 2 * rows[2] + 5 * rows[3]) / 10
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=TOL)
    assert port.fill == ref.fill == 0 and port.drain_fedavg(base) == (None, [])


def test_fedbuff_drain_takes_the_oldest_k_and_skips_stale_bases_like_jax():
    port, ref = _pair(6)
    rows, base = _rows(5, seed=1), _rows(1, seed=2)[0]
    for i, (cid, rnd) in enumerate([("e", 1), ("a", 3), ("d", 4), ("c", 2), ("b", 4)]):
        _offer((port, ref), rows[i], cid, rnd, 1.0)
    window = [2, 3, 4]
    ours, ometas, ostats = port.drain_fedbuff(4, 4, window, base, staleness_exponent=0.5,
                                              server_lr=0.7)
    theirs, tmetas, tstats = ref.drain_fedbuff(4, 4, window, base, staleness_exponent=0.5,
                                               server_lr=0.7)
    _same_metas(ometas, tmetas)
    assert ostats == tstats and ostats["num_skipped_out_of_window"] == 1
    assert ostats["staleness"] == [1, 0, 2]
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=TOL)
    assert [m.client_id for m in port.occupied()] == ["b"]  # the newer slot stays
    with pytest.raises(ValueError, match="left the version window"):
        port.drain_fedbuff(1, 9, [9], base)
    with pytest.raises(ValueError, match="left the version window"):
        ref.drain_fedbuff(1, 9, [9], base)
    assert port.fill == ref.fill == 0


def test_full_and_cleared_buffers_match_jax():
    port, ref = _pair(2)
    rows = _rows(3, seed=3)
    _offer((port, ref), rows[0], "a", 0, 1.0)
    _offer((port, ref), rows[1], "b", 0, 1.0)
    assert _offer((port, ref), rows[2], "c", 0, 1.0) is None  # full
    assert _offer((port, ref), rows[2], "a", 0, 4.0) is not None  # a replaces in place
    assert port.clear() == ref.clear() == 2
    _offer((port, ref), rows[2], "c", 0, 2.0)
    base = np.zeros(P, np.float32)
    (ours, _), (theirs, _) = port.drain_fedavg(base), ref.drain_fedavg(base)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=TOL)
    np.testing.assert_allclose(ours.numpy(), rows[2], rtol=0, atol=TOL)
    assert port.device_bytes == ref.device_bytes == 2 * P * 4


def test_a_freed_nan_row_reaches_later_drains_in_jax_and_not_in_the_port():
    """The reference keeps a freed slot's row and relies on its 0.0 coefficient, but
    0 * NaN is NaN: after one drain of a non-finite delta, every later drain of the
    JAX buffer is NaN.  The port zeroes freed rows, so the next drain is the plain
    mean of what it drains."""
    port, ref = _pair(2)
    poisoned, clean = _rows(2, seed=4)
    poisoned[1] = np.nan
    base = np.zeros(P, np.float32)
    _offer((port, ref), poisoned, "bad", 0, 1.0)
    _offer((port, ref), clean, "ok", 0, 1.0)
    assert np.isnan(port.drain_fedavg(base)[0].numpy()[1])  # a live NaN slot: both NaN
    assert np.isnan(np.asarray(ref.drain_fedavg(base)[0])[1])
    _offer((port, ref), clean, "next", 1, 1.0)
    (ours, _), (theirs, _) = port.drain_fedavg(base), ref.drain_fedavg(base)
    assert np.isnan(np.asarray(theirs)).any()  # the reference defect
    np.testing.assert_allclose(ours.numpy(), clean, rtol=0, atol=TOL)
    port.clear()
    assert not port._buf.any()


def test_pipeline_drains_and_version_window_match_jax():
    ours = IngestPipeline(from_numpy_params(NESTED, device="cpu"),
                          IngestConfig(capacity=4, decode_workers=1),
                          registry=MetricsRegistry(), device="cpu")
    from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry

    theirs = JaxPipeline(jax.tree.map(jnp.asarray, NESTED),
                         JaxIngestConfig(capacity=4, decode_workers=1), registry=JaxRegistry())
    try:
        versions = {v: jax.tree.map(lambda a, v=v: a + np.float32(v), NESTED) for v in range(4)}
        for v, nested in versions.items():
            ours.note_version(v, from_numpy_params(nested, device="cpu"), window=2)
            theirs.note_version(v, jax.tree.map(jnp.asarray, nested), window=2)
            np.testing.assert_array_equal(ours.base_flat(v),
                                          np.asarray(tree_ravel(nested)[0]))
        assert ours.base_flat(0) is None and theirs.base_flat(0) is None
        rows = _rows(3, seed=5)
        for pipe in (ours, theirs):
            pipe.offer(rows[0], client_id="x", round_number=1, metrics={"num_samples": 2})
            pipe.offer(rows[1], client_id="y", round_number=3, metrics={"loss": 1.0})
            pipe.offer(rows[2], client_id="z", round_number=2,
                       metrics={"num_samples": "junk"})
        (a, am, ast), (b, bm, bst) = (p.drain_fedbuff(2, 3, staleness_exponent=1.0,
                                                      server_lr=1.0) for p in (ours, theirs))
        _same_metas(am, bm)
        assert ast == bst
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
        (a, am), (b, bm) = ours.drain_fedavg(3), theirs.drain_fedavg(3)
        _same_metas(am, bm)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
        assert asyncio.run(ours.run_decode(lambda x: x + 1, 41)) == 42
    finally:
        ours.close()
        theirs.close()


def test_client_ids_follow_offers_and_drains_like_jax():
    port, ref = _pair(4)
    assert port.client_ids() == ref.client_ids() == set()
    rows = _rows(4, seed=3)
    for i, cid in enumerate(["a", "b", "a", "c"]):  # a's second offer replaces its first
        _offer((port, ref), rows[i], cid, 0, 1.0 + i)
    assert port.client_ids() == ref.client_ids() == {"a", "b", "c"}
    ids = port.client_ids()
    ids.add("intruder")  # a copy: the buffer's own bookkeeping is untouched
    assert port.client_ids() == {"a", "b", "c"}
    base = _rows(1, seed=4)[0]
    _same_metas(port.drain_fedbuff(2, 0, [0], base)[1], ref.drain_fedbuff(2, 0, [0], base)[1])
    assert port.client_ids() == ref.client_ids() == {"c"}  # a kept its first slot's age
    port.clear()
    ref.clear()
    assert port.client_ids() == ref.client_ids() == set()


def test_decode_busy_seconds_sum_the_pool_workers_like_jax():
    """Worker-busy wall seconds: 0 at construction, then at least the summed wall time
    of every decode job, however many workers ran them at once."""
    from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry

    ours = IngestPipeline(from_numpy_params(NESTED, device="cpu"),
                          IngestConfig(capacity=2, decode_workers=3),
                          registry=MetricsRegistry(), device="cpu")
    theirs = JaxPipeline(jax.tree.map(jnp.asarray, NESTED),
                         JaxIngestConfig(capacity=2, decode_workers=3), registry=JaxRegistry())

    async def jobs(pipe):
        return await asyncio.gather(*(pipe.run_decode(time.sleep, 0.02) for _ in range(6)))

    try:
        for pipe in (ours, theirs):
            assert pipe.decode_busy_seconds() == 0.0
            asyncio.run(jobs(pipe))
            assert 6 * 0.02 <= pipe.decode_busy_seconds() < 6 * 0.02 + 1.0
    finally:
        ours.close()
        theirs.close()


def test_weight_and_flatten_helpers():
    assert weight_from_metrics({"num_samples": 3}) == 3.0
    assert weight_from_metrics({"num_samples": -1, "samples_processed": 7}) == 7.0
    assert weight_from_metrics({"num_samples": math.inf}) == 1.0
    assert weight_from_metrics(None) == 1.0
    nested = jax.tree.map(lambda a: a + 1.5, NESTED)
    np.testing.assert_array_equal(flatten_params(from_numpy_params(nested, device="cpu")),
                                  np.asarray(tree_ravel(nested)[0]))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = from_numpy_params(NESTED, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceIngestBuffer(params, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedbuff_combine(params, [], {}, 0)


def _update(cid, rnd, nested, pkg):
    if pkg == "jax":
        return JaxModelUpdate(cid, rnd, jax.tree.map(jnp.asarray, nested), {}, "t")
    return ModelUpdate(cid, rnd, from_numpy_params(nested, device="cpu"), {}, "t")


def test_fedbuff_combine_matches_jax_with_skipped_stale_bases():
    rng = np.random.default_rng(6)

    def rand():
        return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), NESTED)

    versions = {v: rand() for v in (3, 4, 5)}
    current = rand()
    arrivals = [("d", 5), ("b", 3), ("z", 1), ("a", 4), ("c", 5)]  # z's base left
    trained = {cid: rand() for cid, _ in arrivals}
    ours, ostats = fedbuff_combine(
        from_numpy_params(current, device="cpu"),
        [_update(c, r, trained[c], "port") for c, r in arrivals],
        {v: from_numpy_params(p, device="cpu") for v, p in versions.items()}, 5,
        staleness_exponent=0.5, server_lr=0.8, device="cpu")
    theirs, tstats = jax_fedbuff(
        jax.tree.map(jnp.asarray, current), [_update(c, r, trained[c], "jax") for c, r in arrivals],
        {v: jax.tree.map(jnp.asarray, p) for v, p in versions.items()}, 5,
        staleness_exponent=0.5, server_lr=0.8)
    assert ostats == tstats
    assert ostats["num_skipped_out_of_window"] == 1 and ostats["staleness"] == [0, 2, 1, 0]
    want = flatten_with_names(jax.tree.map(np.asarray, theirs))
    for name, leaf in ours.items():
        np.testing.assert_allclose(leaf.numpy(), want[name], rtol=0, atol=TOL, err_msg=name)
    with pytest.raises(ValueError, match="left the version window"):
        fedbuff_combine(from_numpy_params(current, device="cpu"),
                        [_update("z", 1, trained["z"], "port")], {}, 5, device="cpu")


def test_fedbuff_combine_discounts_each_update_of_a_repeated_client_like_jax():
    """Two updates of one client from different versions each carry their own
    staleness discount, as in the JAX package; the port sums them in buffer order
    within the client's place in the client-id order."""
    rng = np.random.default_rng(11)

    def rand():
        return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), NESTED)

    versions = {v: rand() for v in (0, 1, 2)}
    current = rand()
    arrivals = [("c1", 0), ("b", 1), ("c1", 2)]
    trained = [rand() for _ in arrivals]
    ours, ostats = fedbuff_combine(
        from_numpy_params(current, device="cpu"),
        [_update(c, r, t, "port") for (c, r), t in zip(arrivals, trained)],
        {v: from_numpy_params(p, device="cpu") for v, p in versions.items()}, 2,
        staleness_exponent=0.5, device="cpu")
    theirs, tstats = jax_fedbuff(
        jax.tree.map(jnp.asarray, current),
        [_update(c, r, t, "jax") for (c, r), t in zip(arrivals, trained)],
        {v: jax.tree.map(jnp.asarray, p) for v, p in versions.items()}, 2,
        staleness_exponent=0.5)
    assert ostats == tstats and ostats["staleness"] == [2, 1, 0]
    want = flatten_with_names(jax.tree.map(np.asarray, theirs))
    for name, leaf in ours.items():
        np.testing.assert_allclose(leaf.numpy(), want[name], rtol=0, atol=TOL, err_msg=name)


def test_slot_record_has_the_jax_fields():
    assert SlotMeta._fields == JaxSlotMeta._fields
    assert SlotMeta._field_defaults == JaxSlotMeta._field_defaults == {"trace": ""}


def test_offer_trace_rides_the_slot_record_into_the_drain_like_jax():
    """A trace id offered with a delta comes back on the drained slot's record; an
    untraced offer's is ""; a client's replacing offer replaces its trace too."""
    port, ref = _pair(4)
    rows, base = _rows(3), _rows(1, seed=5)[0]
    offers = [("c0", rows[0], "aa" * 16), ("c1", rows[1], None), ("c0", rows[2], "bb" * 16)]
    for buf in (port, ref):
        for cid, row, trace in offers:
            kw = {} if trace is None else {"trace": trace}
            assert buf.offer(row, client_id=cid, round_number=0, weight=1.0, **kw) is not None
    (_, ometas), (_, tmetas) = port.drain_fedavg(base), ref.drain_fedavg(base)
    _same_metas(ometas, tmetas)
    assert [m.trace for m in ometas] == [m.trace for m in tmetas] == ["", "bb" * 16]


def test_pipeline_offer_forwards_its_trace_like_jax():
    template = from_numpy_params(NESTED, device="cpu")
    port = IngestPipeline(template, IngestConfig(capacity=2), registry=MetricsRegistry(),
                          device="cpu")
    ref = JaxPipeline(jax.tree.map(jnp.asarray, NESTED),
                      JaxIngestConfig(capacity=2, batch_size=2))
    for pipe in (port, ref):
        pipe.note_version(0, template if pipe is port else jax.tree.map(jnp.asarray, NESTED))
        assert pipe.offer(_rows(1)[0], client_id="a", round_number=0,
                          metrics={"num_samples": 2}, trace="cd" * 16) is not None
    (_, ometas), (_, tmetas) = port.drain_fedavg(0), ref.drain_fedavg(0)
    assert [m.trace for m in ometas] == [m.trace for m in tmetas] == ["cd" * 16]


def test_ingest_submit_trace_header_reaches_the_drained_slot_like_jax():
    """A plain submit to an ingest server carries ``X-NanoFed-Trace``; the slot the
    round drains names its trace id, in both packages.  An untraced submit's is ""."""
    trace = new_trace("client-a", 0)

    async def one(pkg):
        comm = {"port": port_comm, "jax": jax_comm}[pkg]
        if pkg == "port":
            server = comm.HTTPServer(port=free_port(), ingest=IngestConfig(capacity=4),
                                     device="cpu")
            params = from_numpy_params(NESTED, device="cpu")
        else:
            server = comm.HTTPServer(port=free_port(), ingest=JaxIngestConfig(capacity=4))
            params = jax.tree.map(jnp.asarray, NESTED)
        await server.start()
        try:
            await server.publish_model(params, 0)
            body = port_comm.encode_params(from_numpy_params(NESTED, device="cpu"))
            url = f"http://127.0.0.1:{server.port}/update"
            async with aiohttp.ClientSession() as session:
                for cid, extra in (("a", {"X-NanoFed-Trace": trace.header()}), ("b", {})):
                    headers = {"X-NanoFed-Client": cid, "X-NanoFed-Round": "0",
                               "X-NanoFed-Metrics": '{"num_samples": 2}', **extra}
                    async with session.post(url, data=body, headers=headers) as r:
                        assert r.status == 200, await r.text()
            _, metas = await server.drain_ingest_fedavg()
            return sorted((m.client_id, m.trace) for m in metas)
        finally:
            await server.stop()

    ours, theirs = asyncio.run(one("port")), asyncio.run(one("jax"))
    assert ours == theirs == [("a", trace.trace_id), ("b", "")]
