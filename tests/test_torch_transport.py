"""The port's admission control, shared transports and device gate against the JAX
package's on the CPU.

* Admission: ``max_inflight`` 0 (every submit shed), 1 with a held body read (the
  second submit shed while the first is in the pipeline, then the first lands), a
  custom ``retry_after_s`` on the full ingest buffer's 429, and a negative bound
  (refused); the same status codes, ``Retry-After`` headers and bodies in both.
* Shared transports: the cases of ``tests/unit/communication/test_transport.py`` (the
  unknown-tenant 404, path and header routing, the 405 inside a tenant, the scoped
  429, dedup isolation, the refused ``start()`` of a shared session, a removed tenant's
  404, ``tenant=`` without ``transport=``) in both packages, answers compared.
* ``device_gate``: the port's coordinator enters the gate as many times as the JAX
  coordinator on the same scripted sync and FedBuff runs, on the list buffer and the
  ingest buffer (the four gated places).
"""

import pytest

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
from aiohttp.test_utils import TestClient, TestServer

import nanofed_tpu.communication as jax_comm
import nanofed_tpu.communication.codec as jax_codec
import nanofed_tpu.communication.transport as jax_transport
import nanofed_tpu_torch.communication as port_comm
import nanofed_tpu_torch.communication.codec as port_codec
import nanofed_tpu_torch.communication.transport as port_transport
from nanofed_tpu.ingest import IngestConfig as JaxIngestConfig
from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry
from nanofed_tpu_torch.communication.http_server import (
    HEADER_CLIENT,
    HEADER_METRICS,
    HEADER_ROUND,
    HEADER_SUBMIT,
)
from nanofed_tpu_torch.ingest import IngestConfig
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.utils.trees import from_numpy_params

NESTED = {"b": np.zeros((2,), np.float32), "w": np.ones((4, 2), np.float32)}
PKGS = {"port": (port_comm, port_transport, port_codec, MetricsRegistry),
        "jax": (jax_comm, jax_transport, jax_codec, JaxRegistry)}


def _params(pkg):
    return (from_numpy_params(NESTED, device="cpu") if pkg == "port"
            else jax.tree.map(jnp.asarray, NESTED))


def _server_kwargs(pkg, **kw):
    if "ingest" in kw:
        capacity = kw.pop("ingest")
        kw["ingest"] = (IngestConfig(capacity=capacity) if pkg == "port"
                        else JaxIngestConfig(capacity=capacity))
        if pkg == "port":
            kw["device"] = "cpu"
    return kw


async def _answer(resp):
    return (resp.status, resp.headers.get("Retry-After"), await resp.json())


def _headers(client="c1", key="k1", rnd="0"):
    return {HEADER_CLIENT: client, HEADER_ROUND: rnd, HEADER_SUBMIT: key,
            HEADER_METRICS: json.dumps({"num_samples": 2.0})}


def _single(pkg, fn, **kw):
    """One server of ``pkg`` (private transport) behind an aiohttp test client."""
    comm, _, codec, registry_cls = PKGS[pkg]

    async def main():
        server = comm.HTTPServer(port=0, registry=registry_cls(), **_server_kwargs(pkg, **kw))
        client = TestClient(TestServer(server._app))
        await client.start_server()
        try:
            await server.publish_model(_params(pkg), 0)
            return await fn(server, client, codec.encode_params(_params(pkg)))
        finally:
            await client.close()
            await server.stop()

    return asyncio.run(main())


def _both(fn, **kw):
    return _single("port", fn, **kw), _single("jax", fn, **kw)


def test_max_inflight_zero_sheds_every_submit_like_jax():
    async def scenario(server, client, body):
        answers = [await _answer(await client.post("/update", data=body,
                                                   headers=_headers(key=f"k{i}")))
                   for i in range(2)]
        return answers, server.num_updates()

    ours, theirs = _both(scenario, max_inflight=0)
    assert ours == theirs
    assert ours[0][0] == (429, "0.25", {
        "status": "error",
        "message": "server at capacity (0 submits in flight); retry after backoff"})
    assert ours[1] == 0


def test_max_inflight_one_sheds_while_a_body_is_held_like_jax():
    """The first submit's body is held open, so it sits in the read and decode
    pipeline; the second is shed with its body unread; released, the first lands."""
    async def scenario(server, client, body):
        release = asyncio.Event()

        async def slow_body():
            yield body[:10]
            await release.wait()
            yield body[10:]

        first = asyncio.ensure_future(client.post("/update", data=slow_body(),
                                                  headers=_headers(client="c1", key="a")))
        for _ in range(200):
            await asyncio.sleep(0.005)
            second = await _answer(await client.post(
                "/update", data=body, headers=_headers(client="c2", key="b")))
            if second[0] == 429:
                break
        release.set()
        first_answer = await _answer(await first)
        third = await _answer(await client.post("/update", data=body,
                                                headers=_headers(client="c2", key="c")))
        return second, first_answer[0], third[0], server.num_updates()

    ours, theirs = _both(scenario, max_inflight=1, retry_after_s=1.5)
    assert ours == theirs
    assert ours[0] == (429, "1.5", {
        "status": "error",
        "message": "server at capacity (1 submits in flight); retry after backoff"})
    assert ours[1:] == (200, 200, 2)


def test_full_ingest_buffer_429_carries_retry_after_s_like_jax():
    async def scenario(server, client, body):
        return [await _answer(await client.post("/update", data=body,
                                                headers=_headers(client=c, key=c)))
                for c in ("a", "b", "a")]

    ours, theirs = _both(scenario, ingest=1, retry_after_s=2.0)
    assert [a[:2] for a in ours] == [a[:2] for a in theirs] == [
        (200, None), (429, "2"), (200, None)]
    assert ours[1][2] == theirs[1][2]


def test_negative_max_inflight_is_refused_like_jax():
    for comm, *_ in PKGS.values():
        with pytest.raises(ValueError, match="max_inflight must be >= 0"):
            comm.HTTPServer(port=0, max_inflight=-1)


def _two_tenants(pkg, fn, a_kwargs=None, b_kwargs=None):
    comm, transport_mod, codec, registry_cls = PKGS[pkg]

    async def main():
        transport = transport_mod.HTTPTransport(port=0, registry=registry_cls())
        a = comm.HTTPServer(transport=transport, tenant="a", registry=registry_cls(),
                            **_server_kwargs(pkg, **(a_kwargs or {})))
        b = comm.HTTPServer(transport=transport, tenant="b", registry=registry_cls(),
                            **_server_kwargs(pkg, **(b_kwargs or {})))
        client = TestClient(TestServer(transport.app))
        await client.start_server()
        try:
            return await fn(transport, a, b, client, codec.encode_params(_params(pkg)),
                            _params(pkg))
        finally:
            await client.close()

    return asyncio.run(main())


def _both_tenants(fn, **kw):
    return _two_tenants("port", fn, **kw), _two_tenants("jax", fn, **kw)


def test_unknown_tenant_is_a_404_at_the_transport_like_jax():
    async def scenario(transport, a, b, client, body, params):
        answers = [
            await _answer(await client.get("/t/ghost/status")),
            await _answer(await client.get("/status", headers={"X-NanoFed-Tenant": "ghost"})),
            await _answer(await client.get("/status")),
        ]
        return answers, transport.metrics_registry.counter(
            "nanofed_unknown_tenant_total").value()

    ours, theirs = _both_tenants(scenario)
    assert ours == theirs
    assert [a[0] for a in ours[0]] == [404] * 3 and ours[1] == 3.0


def test_tenant_routing_and_the_405_inside_a_tenant_like_jax():
    async def scenario(transport, a, b, client, body, params):
        await a.publish_model(params, 3)
        await b.publish_model(params, 7)
        via_path = await (await client.get("/t/a/status")).json()
        via_header = await (await client.get("/status",
                                             headers={"X-NanoFed-Tenant": "a"})).json()
        return [via_path, via_header, await (await client.get("/t/b/status")).json(),
                await _answer(await client.get("/t/a/update")),
                (await client.post("/t/a/nosuch")).status,
                (await client.head("/t/a/status")).status,
                (await client.head("/t/a/update")).status]

    ours, theirs = _both_tenants(scenario)
    assert ours == theirs
    assert ours[0]["round"] == ours[1]["round"] == 3 and ours[2]["round"] == 7
    assert ours[3][0] == 405 and ours[4:] == [404, 200, 405]


def test_429_is_scoped_to_the_saturated_tenant_like_jax():
    async def scenario(transport, a, b, client, body, params):
        await a.publish_model(params, 0)
        await b.publish_model(params, 0)
        resp_a, resp_b = await asyncio.gather(
            client.post("/t/a/update", data=body, headers=_headers()),
            client.post("/t/b/update", data=body, headers=_headers()))
        counts = [s.metrics_registry.counter("nanofed_http_429_total", labels=("endpoint",))
                  .value(endpoint="update") for s in (a, b)]
        return await _answer(resp_a), resp_b.status, counts

    ours, theirs = _both_tenants(scenario, a_kwargs={"max_inflight": 0})
    assert ours == theirs
    assert ours[0][0] == 429 and ours[1] == 200 and ours[2] == [1.0, 0.0]


def test_submit_keys_never_collide_across_tenants_like_jax():
    async def scenario(transport, a, b, client, body, params):
        await a.publish_model(params, 0)
        await b.publish_model(params, 0)
        headers = _headers(key="shared-key")
        answers = [await _answer(await client.post(path, data=body, headers=headers))
                   for path in ("/t/a/update", "/t/b/update", "/t/a/update")]
        return [(s, body.get("duplicate")) for s, _, body in answers], \
            a.num_updates(), b.num_updates()

    ours, theirs = _both_tenants(scenario)
    assert ours == theirs
    assert ours == ([(200, None), (200, None), (200, True)], 1, 1)


def test_shared_sessions_refuse_start_and_unmount_to_a_404_like_jax():
    async def scenario(transport, a, b, client, body, params):
        with pytest.raises(RuntimeError, match="shared transport"):
            await a.start()
        before = (await client.get("/t/a/test")).status
        transport.remove_session("a")
        return before, (await client.get("/t/a/test")).status, \
            (await client.get("/t/b/test")).status, transport.tenants()

    ours, theirs = _both_tenants(scenario)
    assert ours == theirs == (200, 404, 200, ["b"])


def test_tenant_without_a_shared_transport_and_a_duplicate_mount_are_refused_like_jax():
    for comm, transport_mod, _, registry_cls in PKGS.values():
        with pytest.raises(ValueError, match="requires a shared transport"):
            comm.HTTPServer(port=0, tenant="t")
        transport = transport_mod.HTTPTransport(port=0, registry=registry_cls())
        comm.HTTPServer(transport=transport, tenant="a", registry=registry_cls())
        with pytest.raises(ValueError, match="already mounted"):
            comm.HTTPServer(transport=transport, tenant="a", registry=registry_cls())


class CountingGate:
    """A ``device_gate`` that counts its sections."""

    def __init__(self) -> None:
        self.entries = 0

    def __call__(self):
        gate = self

        class Section:
            async def __aenter__(self):
                gate.entries += 1

            async def __aexit__(self, *exc):
                return False

        return Section()


def _delta(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            for k, v in NESTED.items()}


def _gated_run(pkg, fedbuff, ingest):
    """Two rounds (or aggregations of K=2) of ``pkg``'s coordinator, every client's
    fetch and submit scripted, under a counting gate."""
    comm, _, _, registry_cls = PKGS[pkg]
    extra = {"device": "cpu"} if pkg == "port" else {}
    gate = CountingGate()

    def to_pkg(nested):
        return from_numpy_params(nested, device="cpu") if pkg == "port" else \
            jax.tree.map(jnp.asarray, nested)

    def to_nested(params):
        if pkg == "port":
            from nanofed_tpu_torch.utils.trees import to_numpy_params

            return to_numpy_params(params)
        return jax.tree.map(np.asarray, params)

    async def submit(url, cid, step, rnd):
        async with comm.HTTPClient(url, cid, timeout_s=30) as c:
            while True:
                status = await c.check_server_status()
                if status["round"] >= rnd:
                    break
                await asyncio.sleep(0.01)
            params, _, _ = await c.fetch_global_model(like=to_pkg(NESTED))
            mine = {k: v + _delta(step)[k] for k, v in to_nested(params).items()}
            assert await c.submit_update(to_pkg(mine), {"num_samples": 3.0 + step})

    async def script(url):
        for rnd, cids in enumerate((("A", "B"), ("C", "D"))):
            await asyncio.gather(*(submit(url, cid, 2 * rnd + i, rnd)
                                   for i, cid in enumerate(cids)))

    async def main():
        kw = _server_kwargs(pkg, ingest=4) if ingest else {}
        server = comm.HTTPServer(port=port_transport.free_port(), registry=registry_cls(),
                                 **kw)
        await server.start()
        try:
            config = (comm.NetworkRoundConfig(num_rounds=2, async_buffer_k=2,
                                              staleness_window=2, round_timeout_s=20.0,
                                              poll_interval_s=0.01) if fedbuff else
                      comm.NetworkRoundConfig(num_rounds=2, min_clients=2,
                                              round_timeout_s=20.0, poll_interval_s=0.01))
            coordinator = comm.NetworkCoordinator(server, to_pkg(NESTED), config,
                                                  device_gate=gate, **extra)
            await asyncio.wait_for(asyncio.gather(
                coordinator.run(), script(f"http://127.0.0.1:{server.port}")), 60)
            return gate.entries, [h["status"] for h in coordinator.history]
        finally:
            await server.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("fedbuff", [False, True], ids=["sync", "fedbuff"])
@pytest.mark.parametrize("ingest", [False, True], ids=["list", "ingest"])
def test_device_gate_is_entered_as_often_as_the_jax_coordinators(fedbuff, ingest):
    ours = _gated_run("port", fedbuff, ingest)
    theirs = _gated_run("jax", fedbuff, ingest)
    assert ours == theirs == (2, ["COMPLETED", "COMPLETED"])
