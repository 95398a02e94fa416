"""The port's asynchronous (FedBuff) network rounds, its ingest rounds and its signed
and compressed submissions against the JAX package's, over real aiohttp servers on
free localhost ports, on the CPU.

The FedBuff runs are scripted: 4 clients (and a fifth whose base has left the window)
fetch and submit in one fixed, staggered order, each next step waiting for the
server to move on, so both packages drain the same updates in the same aggregations.
Tolerances: the staleness stats exactly; params within 1e-6 (float32 sums, the port's
in client-id order within a drain, the JAX package's in arrival order, and the ingest
drains in the BLAS's order).  The sync ingest round against the list round and the JAX ingest round: 1e-6.
Mixed cohorts (a JAX client against a port server and the reverse) with q8, topk8 and
signatures must complete, every signature verifying across packages, within the
codec's quantization step of the plain FedAvg.
"""

import pytest

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")
pytest.importorskip("cryptography", reason="signing needs the crypto dependency")

import asyncio
import functools

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np

import nanofed_tpu.communication as jax_comm
import nanofed_tpu_torch.communication as port_comm
from nanofed_tpu.ingest import IngestConfig as JaxIngestConfig
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.security.signing import SecurityManager as JaxSecurityManager
from nanofed_tpu.utils.trees import tree_ravel
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.ingest import IngestConfig
from nanofed_tpu_torch.security.signing import SecurityManager
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel, to_numpy_params

TOL = 1e-6
PKGS = {"port": port_comm, "jax": jax_comm}
INIT = jax.tree.map(np.asarray, jax_get_model("linear", in_features=6, num_classes=3)
                    .init(jax.random.key(0)))


def _to_pkg(pkg, nested):
    return (from_numpy_params(nested, device="cpu") if pkg == "port"
            else jax.tree.map(jnp.asarray, nested))


def _to_nested(pkg, params):
    return to_numpy_params(params) if pkg == "port" else jax.tree.map(np.asarray, params)


def _flat(pkg, params):
    return ravel(params).numpy() if pkg == "port" else np.asarray(tree_ravel(params)[0])


def _delta(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        INIT)


def _server(pkg, ingest=False, capacity=8, **kwargs):
    comm = PKGS[pkg]
    if ingest:
        kwargs["ingest"] = (IngestConfig(capacity=capacity) if pkg == "port"
                            else JaxIngestConfig(capacity=capacity))
        if pkg == "port":
            kwargs["device"] = "cpu"
    return comm.HTTPServer(port=free_port(), **kwargs)


async def _fetch(client, like):
    for _ in range(400):
        try:
            return await client.fetch_global_model(like=like)
        except Exception:
            await asyncio.sleep(0.02)
    raise TimeoutError("model never published")


async def _wait_round(client, rnd):
    while (await client.check_server_status())["round"] < rnd:
        await asyncio.sleep(0.01)


# fetch / submit / wait-for-round steps; "E" holds version 0 past the window.
SCRIPT = [
    ("fetch", "A"), ("fetch", "B"), ("fetch", "C"), ("fetch", "D"), ("fetch", "E"),
    ("submit", "A"), ("submit", "B"), ("wait", 1),                       # A τ0, B τ0
    ("submit", "C"), ("fetch", "A"), ("fetch", "C"), ("submit", "A"), ("wait", 2),  # C τ1, A τ0
    ("submit", "D"), ("fetch", "B"), ("submit", "B"), ("wait", 3),       # D τ2, B τ0
    ("stale", "E"), ("submit", "C"), ("fetch", "D"), ("submit", "D"), ("wait", 4),  # C τ2, D τ0
]


def _fedbuff(pkg, ingest=False):
    comm = PKGS[pkg]
    extra = {"device": "cpu"} if pkg == "port" else {}

    async def run_script(url):
        template = _to_pkg(pkg, INIT)
        names = sorted({cid for _, cid in SCRIPT if isinstance(cid, str)})
        clients = {cid: comm.HTTPClient(url, cid, timeout_s=30) for cid in names}
        held, outcomes = {}, []
        for client in clients.values():
            await client.__aenter__()
        try:
            for step, (op, arg) in enumerate(SCRIPT):
                if op == "fetch":
                    params, _, _ = await _fetch(clients[arg], template)
                    held[arg] = _to_nested(pkg, params)
                elif op == "wait":
                    await _wait_round(clients["A"], arg)
                else:
                    mine = jax.tree.map(np.add, held[arg], _delta(100 + step))
                    outcomes.append(await clients[arg].submit_update(
                        _to_pkg(pkg, mine), {"num_samples": 5.0, "loss": float(step)}))
        finally:
            for client in clients.values():
                await client.__aexit__(None, None, None)
        return outcomes

    async def main():
        server = _server(pkg, ingest=ingest)
        await server.start()
        try:
            coordinator = comm.NetworkCoordinator(
                server, _to_pkg(pkg, INIT),
                comm.NetworkRoundConfig(num_rounds=4, async_buffer_k=2, staleness_window=2,
                                        round_timeout_s=20.0, poll_interval_s=0.01),
                **extra)
            _, outcomes = await asyncio.wait_for(asyncio.gather(
                coordinator.run(), run_script(f"http://127.0.0.1:{server.port}")), 120)
            return coordinator, outcomes
        finally:
            await server.stop()

    coordinator, outcomes = asyncio.run(main())
    return _flat(pkg, coordinator.params), coordinator.history, outcomes


@functools.lru_cache(maxsize=None)
def _fedbuff_cached(pkg, ingest):
    return _fedbuff(pkg, ingest)


KEYS = ("aggregation", "version", "status", "num_clients", "staleness", "discounts",
        "num_skipped_out_of_window", "mean_staleness")


@pytest.mark.parametrize("ingest", [False, True], ids=["list_buffer", "ingest_buffer"])
def test_fedbuff_run_matches_jax(ingest):
    ours, ohist, oout = _fedbuff_cached("port", ingest)
    theirs, thist, tout = _fedbuff_cached("jax", ingest)
    assert oout == tout == [True] * 6 + [False] + [True] * 2  # E's base left the window
    assert [{k: h[k] for k in KEYS} for h in ohist] == [{k: h[k] for k in KEYS} for h in thist]
    assert [h["staleness"] for h in ohist] == [[0, 0], [1, 0], [2, 0], [2, 0]]
    assert [h["drained"] for h in ohist] == [["A", "B"], ["C", "A"], ["D", "B"], ["C", "D"]]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)


def test_fedbuff_ingest_run_matches_the_list_run():
    np.testing.assert_allclose(_fedbuff_cached("port", True)[0],
                               _fedbuff_cached("port", False)[0], rtol=0, atol=TOL)


def _sync(pkg, ingest, clients, rounds=2, server_kwargs=None, client_kwargs=None):
    """``rounds`` sync rounds of ``pkg``'s server; ``clients`` maps a client id to the
    package its client comes from.  Each submits the fetched global plus its delta."""
    comm = PKGS[pkg]
    extra = {"device": "cpu"} if pkg == "port" else {}
    server_kwargs = server_kwargs or {}
    client_kwargs = client_kwargs or {}

    async def client(cpkg, url, cid, idx):
        template = _to_pkg(cpkg, INIT)
        async with PKGS[cpkg].HTTPClient(url, cid, timeout_s=30,
                                         **client_kwargs.get(cid, {})) as c:
            while True:
                params, rnd, active = await _fetch(c, template)
                if not active:
                    return
                mine = jax.tree.map(np.add, _to_nested(cpkg, params), _delta(10 + idx))
                assert await c.submit_update(_to_pkg(cpkg, mine),
                                             {"num_samples": 10.0 * (idx + 1)})
                while True:
                    status = await c.check_server_status()
                    if not status["training_active"] or status["round"] != rnd:
                        break
                    await asyncio.sleep(0.01)

    async def main():
        server = _server(pkg, ingest=ingest, **server_kwargs)
        await server.start()
        try:
            coordinator = comm.NetworkCoordinator(
                server, _to_pkg(pkg, INIT),
                comm.NetworkRoundConfig(num_rounds=rounds, min_clients=len(clients),
                                        round_timeout_s=20.0, poll_interval_s=0.01),
                **extra)
            url = f"http://127.0.0.1:{server.port}"
            await asyncio.wait_for(asyncio.gather(
                coordinator.run(),
                *[client(cpkg, url, cid, i) for i, (cid, cpkg) in enumerate(clients.items())]),
                120)
            return coordinator
        finally:
            await server.stop()

    coordinator = asyncio.run(main())
    return _flat(pkg, coordinator.params), coordinator.history


def _fedavg_reference(n, rounds=2):
    flat = np.asarray(tree_ravel(INIT)[0], np.float64)
    w = np.asarray([10.0 * (i + 1) for i in range(n)])
    for _ in range(rounds):
        flat = flat + sum(w[i] * np.asarray(tree_ravel(_delta(10 + i))[0], np.float64)
                          for i in range(n)) / w.sum()
    return flat


def test_sync_ingest_round_matches_the_list_round():
    clients = {"c0": "port", "c1": "port", "c2": "port"}
    ours, ohist = _sync("port", True, clients)
    listed, lhist = _sync("port", False, clients)
    theirs, _ = _sync("jax", True, clients)
    assert [h["status"] for h in ohist] == ["COMPLETED"] * 2 and all(h["ingest"] for h in ohist)
    assert [h["metrics"] for h in ohist] == pytest.approx([h["metrics"] for h in lhist])
    np.testing.assert_allclose(ours, listed, rtol=0, atol=TOL)
    np.testing.assert_allclose(ours, _fedavg_reference(3), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def keys():
    return {"p": SecurityManager(), "j": JaxSecurityManager()}


@pytest.mark.parametrize("encoding", ["npz", "q8-delta", "topk8-delta"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_mixed_cohort_signed_and_compressed_submissions(server_pkg, encoding, keys):
    """A port client and a JAX client, each signing, against either package's server
    with ``require_signatures``: both signatures verify, the round completes, and the
    aggregate is the plain FedAvg within the codec's quantization."""
    clients = {"p": "port", "j": "jax"}
    client_kwargs = {cid: {"update_encoding": encoding, "security_manager": keys[cid],
                           "topk_fraction": 1.0} for cid in clients}
    server_kwargs = {"require_signatures": True,
                     "client_keys": {cid: keys[cid].get_public_key() for cid in clients}}
    ours, hist = _sync(server_pkg, False, clients, server_kwargs=server_kwargs,
                       client_kwargs=client_kwargs)
    assert [h["num_clients"] for h in hist] == [2, 2]
    tol = 1e-5 if encoding == "npz" else 3e-3  # q8: |delta| / 127 a leaf, ~2e-3 here
    np.testing.assert_allclose(ours, _fedavg_reference(2), rtol=0, atol=tol)


async def _post(url, body, headers):
    async with aiohttp.ClientSession() as session:
        async with session.post(url, data=body, headers=headers) as r:
            return r.status, (await r.json())["message"]


def test_forged_and_unregistered_signatures_get_403_and_never_reach_the_buffer(keys):
    async def main():
        server = _server("port", require_signatures=True,
                         client_keys={"p": keys["p"].get_public_key()})
        await server.start()
        url = f"http://127.0.0.1:{server.port}"
        try:
            await server.publish_model(_to_pkg("port", INIT), 0)
            out = []
            for cid, manager in (("p", keys["j"]), ("stranger", keys["p"]), ("p", None)):
                async with port_comm.HTTPClient(url, cid, security_manager=manager) as c:
                    await c.fetch_global_model(like=_to_pkg("port", INIT))
                    out.append(await c.submit_update(_to_pkg("port", INIT), {}))
            body = port_comm.encode_params(_to_pkg("port", INIT))
            status = await _post(url + "/update", body, {
                "X-NanoFed-Client": "p", "X-NanoFed-Round": "0",
                "X-NanoFed-Signature": "AAAA"})
            return out, status, server.num_updates()
        finally:
            await server.stop()

    outcomes, status, buffered = asyncio.run(main())
    assert outcomes == [False, False, False]
    assert status == (403, "invalid signature") and buffered == 0


@pytest.mark.parametrize("window", [0, 2])
def test_stale_round_submit_gets_400_with_the_reference_message(window):
    async def one(pkg):
        server = _server(pkg, staleness_window=window)
        await server.start()
        try:
            for r in range(4):
                await server.publish_model(_to_pkg(pkg, INIT), r)
            body = port_comm.encode_params(_to_pkg("port", INIT))
            return await _post(f"http://127.0.0.1:{server.port}/update", body,
                               {"X-NanoFed-Client": "a", "X-NanoFed-Round": "0"})
        finally:
            await server.stop()

    ours, theirs = asyncio.run(one("port")), asyncio.run(one("jax"))
    assert ours == theirs
    assert ours == (400, "update for round 0 is outside the staleness window [1, 3]"
                    if window else "update for round 0, server is on 3")


def test_resend_folds_once_and_a_full_ingest_buffer_answers_429(keys):
    """A resent signed submit is a duplicate (folded once); the same key with another
    signature is not (403); a submit to a full ingest buffer is shed with 429 and a
    Retry-After before its body is decoded."""
    async def main():
        server = _server("port", ingest=True, capacity=1, require_signatures=True,
                         client_keys={"p": keys["p"].get_public_key()})
        await server.start()
        url = f"http://127.0.0.1:{server.port}"
        try:
            await server.publish_model(_to_pkg("port", INIT), 0)
            async with port_comm.HTTPClient(url, "p", security_manager=keys["p"],
                                            update_encoding="q8-delta") as c:
                params, _, _ = await c.fetch_global_model(like=_to_pkg("port", INIT))
                first = await c.submit_update(params, {"num_samples": 3})
                again = await c.resend_last_update()
                _, body, headers = c._last_update_post
            forged = await _post(url + "/update", body,
                                 dict(headers, **{"X-NanoFed-Signature": "AAAA"}))
            async with aiohttp.ClientSession() as session:
                async with session.post(url + "/update", data=b"", headers={
                        "X-NanoFed-Client": "q", "X-NanoFed-Round": "0"}) as r:
                    full = (r.status, r.headers.get("Retry-After"))
            return first, again, forged, full, server.num_updates()
        finally:
            await server.stop()

    first, again, forged, full, buffered = asyncio.run(main())
    assert first and again and buffered == 1
    assert forged == (403, "invalid signature")
    assert full == (429, "0.25")
