"""The port's network mode (``communication/``) against the JAX package's, over real
aiohttp sockets on localhost, on the CPU.

Both packages get the same injected params: each client submits the fetched global
model plus its own fixed delta, so a run is deterministic up to the order in which
updates arrive.  Tolerances:
- the plain round is a float32 weighted mean whose terms arrive in any order: 1e-6;
- the secure round's sum is exact uint32 arithmetic and both packages dequantize
  with one rounding to float32: bit for bit;
- the dropout-tolerant round divides by the survivors' weight mass (the port in
  float64 on the device, JAX in float64 on the host): 2e-7 relative.
Every server takes a free port, so the tests run beside any other test process.
"""

import pytest

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")
pytest.importorskip("cryptography", reason="secure aggregation needs the crypto dependency")

import asyncio
import functools
import hashlib
import io
from types import SimpleNamespace

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import torch

import nanofed_tpu.communication as jax_comm
import nanofed_tpu_torch.communication as port_comm
from nanofed_tpu.communication import codec as jax_codec
from nanofed_tpu.core.exceptions import NanoFedError as JaxNanoFedError
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.security import secure_agg as jax_sa
from nanofed_tpu.utils.trees import tree_ravel
from nanofed_tpu_torch.communication import codec
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.security import secure_agg as sa
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel, to_numpy_params

NUM_SAMPLES = {"c0": 30.0, "c1": 10.0, "c2": 20.0, "c3": 40.0}
ROUNDS = 2


def _nested(seed: int, scale: float = 1.0):
    model = jax_get_model("linear", in_features=6, num_classes=3)
    return jax.tree.map(lambda a: np.asarray(a) * np.float32(scale), model.init(jax.random.key(seed)))


INIT = _nested(0)
DELTAS = {cid: _nested(10 + i, scale=0.1) for i, cid in enumerate(NUM_SAMPLES)}


def _jax_add(params, delta):
    return jax.tree.map(lambda p, d: np.asarray(p, np.float32) + d, params, delta)


def _port_add(params, delta):
    d = from_numpy_params(delta, device="cpu")
    return {k: v + d[k] for k, v in params.items()}


PKGS = {
    "port": SimpleNamespace(
        comm=port_comm, sa=sa, error=NanoFedError,
        params=lambda nested: from_numpy_params(nested, device="cpu"),
        add=_port_add, flat=lambda p: ravel(p).numpy(),
        mask=lambda *a, **k: sa.mask_update(*a, device="cpu", **k),
        coordinator_kwargs={"device": "cpu"},
    ),
    "jax": SimpleNamespace(
        comm=jax_comm, sa=jax_sa, error=JaxNanoFedError,
        params=lambda nested: jax.tree.map(jnp.asarray, nested),
        add=_jax_add, flat=lambda p: np.asarray(tree_ravel(p)[0]),
        mask=jax_sa.mask_update, coordinator_kwargs={},
    ),
}


async def _fetch(pkg, client, like):
    """The coordinator publishes concurrently with client start-up: retry a 503."""
    for _ in range(400):
        try:
            return await client.fetch_global_model(like=like)
        except pkg.error:
            await asyncio.sleep(0.02)
    raise TimeoutError("model never published")


async def _wait_next_round(client, rnd, on_poll=None):
    while True:
        status = await client.check_server_status()
        if not status["training_active"] or status["round"] != rnd:
            return
        if on_poll is not None:
            await on_poll()
        await asyncio.sleep(0.02)


async def _plain_client(pkg, url, cid):
    template = pkg.params(INIT)
    async with pkg.comm.HTTPClient(url, cid, timeout_s=30) as client:
        while True:
            params, rnd, active = await _fetch(pkg, client, template)
            if not active:
                return
            metrics = {"num_samples": NUM_SAMPLES[cid], "loss": 1.0 + rnd, "accuracy": 0.5}
            assert await client.submit_update(pkg.add(params, DELTAS[cid]), metrics)
            await _wait_next_round(client, rnd)


async def _secure_client(pkg, url, cid, cfg, backend="host", drop_at_round=None, seen=None):
    """One secure client as ``examples/secure_federation/run_secure.py`` drives it,
    submitting the fetched model plus its delta instead of training.  With ``seen``
    (a dict) it records what ``fetch_secagg_participants`` answers each round, and
    waits for the server's end with ``wait_for_completion``."""
    template = pkg.params(INIT)
    identity = pkg.sa.ClientKeyPair.generate()
    async with pkg.comm.HTTPClient(url, cid, timeout_s=30) as client:
        assert await client.register_secagg(identity.public_bytes(), NUM_SAMPLES[cid],
                                            backend=backend)
        roster = await client.fetch_secagg_roster(timeout_s=30)
        while True:
            params, rnd, active = await _fetch(pkg, client, template)
            if not active:
                if seen is not None:
                    await client.wait_for_completion(poll_interval_s=0.01)
                    seen[(cid, "completed")] = (await client.check_server_status())[
                        "training_active"]
                return
            index, mask_key, ordered = roster.index_of(cid), identity, roster.ordered_keys()
            self_seed = held = None
            if cfg.dropout_tolerant:
                participants, threshold = await client.fetch_secagg_round_info()
                if seen is not None:
                    seen[(cid, rnd)] = (participants, await client.fetch_secagg_participants())
                if cid not in participants:
                    return
                mask_key = pkg.sa.ClientKeyPair.generate()
                context = f"{client.secagg_session}:{rnd}"
                self_seed, sealed = pkg.sa.make_dropout_shares(
                    identity, mask_key, participants,
                    {c: roster.public_keys[c] for c in participants},
                    threshold or cfg.threshold, my_id=cid, context=context)
                assert await client.deposit_secagg_shares(
                    rnd, mask_key.public_bytes(), sealed,
                    self_seed_commitment=hashlib.sha256(self_seed).digest())
                epks, inbox = await client.fetch_secagg_inbox(rnd, timeout_s=30)
                held = pkg.sa.open_share_inbox(identity, cid, roster.public_keys, inbox, epks,
                                               context)
                index, ordered = participants.index(cid), [epks[c] for c in participants]
            if drop_at_round is not None and rnd >= drop_at_round:
                return  # gone after the share barrier: its masks are in the others' vectors
            masked = pkg.mask(pkg.add(params, DELTAS[cid]), index, mask_key, ordered, rnd,
                              cfg, weight=roster.weights[cid], backend=backend,
                              self_seed=self_seed)
            assert await client.submit_masked_update(masked, {"num_samples": NUM_SAMPLES[cid]})
            answered = []

            async def answer_unmask():
                if not cfg.dropout_tolerant or answered:
                    return
                request = await client.poll_unmask_request()
                if request is not None and request["round"] == rnd and cid in request["survivors"]:
                    reveals = pkg.sa.build_unmask_reveals(request, cid, held)
                    answered.append(await client.submit_unmask_reveals(rnd, reveals))

            await _wait_next_round(client, rnd, answer_unmask)


MODES = {
    # mode: (secure config kwargs or None, round config kwargs, clients)
    "plain": (None, dict(min_clients=3), ["c0", "c1", "c2"]),
    "secure": (dict(min_clients=3), dict(min_clients=3), ["c0", "c1", "c2"]),
    "tolerant": (dict(min_clients=3, threshold=3, dropout_tolerant=True),
                 dict(min_clients=4, min_completion_rate=0.5, max_clients=4),
                 ["c0", "c1", "c2", "c3"]),
}


def _run(mode, server_pkg, client_pkgs, drop=None, backend="host", timeout_s=20.0,
         device=None, seen=None):
    """Run ``ROUNDS`` rounds: ``server_pkg``'s server and coordinator, one client per
    entry of ``client_pkgs`` (a package name per client).  ``device`` overrides the
    port coordinator's device (the CPU by default).  Returns the coordinator."""
    secure_kw, round_kw, cids = MODES[mode]
    srv = PKGS[server_pkg]
    coordinator_kwargs = dict(srv.coordinator_kwargs, **({"device": device} if device else {}))

    async def main():
        port = free_port()
        server = srv.comm.HTTPServer(port=port)
        await server.start()
        try:
            cfg = None if secure_kw is None else srv.sa.SecureAggregationConfig(**secure_kw)
            coordinator = srv.comm.NetworkCoordinator(
                server, srv.params(INIT),
                srv.comm.NetworkRoundConfig(num_rounds=ROUNDS, round_timeout_s=timeout_s,
                                            poll_interval_s=0.02, **round_kw),
                secure=cfg, **coordinator_kwargs)
            url = f"http://127.0.0.1:{port}"
            clients = []
            for cid, name in zip(cids, client_pkgs):
                pkg = PKGS[name]
                if secure_kw is None:
                    clients.append(_plain_client(pkg, url, cid))
                else:
                    ccfg = pkg.sa.SecureAggregationConfig(**secure_kw)
                    clients.append(_secure_client(pkg, url, cid, ccfg, backend=backend,
                                                  drop_at_round=drop if cid == "c3" else None,
                                                  seen=seen))
            await asyncio.wait_for(asyncio.gather(coordinator.run(), *clients), 120)
            return coordinator
        finally:
            await server.stop()

    return asyncio.run(main())


def _flat_params(pkg_name, coordinator):
    return PKGS[pkg_name].flat(coordinator.params)


@functools.lru_cache(maxsize=None)
def _single_package(mode, pkg_name, drop=None):
    n = len(MODES[mode][2])
    coordinator = _run(mode, pkg_name, [pkg_name] * n, drop=drop,
                       timeout_s=3.0 if drop is not None else 20.0)
    assert [h["status"] for h in coordinator.history] == ["COMPLETED"] * ROUNDS, \
        coordinator.history
    return _flat_params(pkg_name, coordinator), coordinator.history


def _fedavg_reference(cids, rounds=ROUNDS):
    """The plain weighted FedAvg of (global + delta) in float64: what every mode's
    aggregate approximates."""
    flat = np.asarray(tree_ravel(INIT)[0], np.float64)
    deltas = {c: np.asarray(tree_ravel(DELTAS[c])[0], np.float64) for c in cids}
    w = np.asarray([NUM_SAMPLES[c] for c in cids])
    for _ in range(rounds):
        flat = flat + sum(wi * deltas[c] for wi, c in zip(w, cids)) / w.sum()
    return flat


def test_plain_round_matches_jax():
    port, port_hist = _single_package("plain", "port")
    ref, ref_hist = _single_package("plain", "jax")
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port, _fedavg_reference(["c0", "c1", "c2"]), atol=1e-5)
    for a, b in zip(port_hist, ref_hist):
        assert a["num_clients"] == b["num_clients"] == 3
        assert a["metrics"]["loss"] == pytest.approx(b["metrics"]["loss"], abs=1e-6)


@pytest.mark.cuda
def test_plain_round_reduces_with_b1_on_the_card():
    """The plain round with the port's coordinator on the card: its aggregate is one
    B1 launch a round and agrees with the CPU round to 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the plain network round's B1 reduce on the card")
    from nanofed_tpu_torch import ops

    ops.reset_launch_counts()
    coordinator = _run("plain", "port", ["port"] * 3, device="cuda")
    assert ops.launch_counts()["weighted_mean_flat"] == ROUNDS
    assert [h["status"] for h in coordinator.history] == ["COMPLETED"] * ROUNDS
    on_cpu, _ = _single_package("plain", "port")
    np.testing.assert_allclose(ravel(coordinator.params).cpu().numpy(), on_cpu, rtol=0, atol=1e-6)


def test_secure_round_matches_jax_bit_for_bit():
    port, _ = _single_package("secure", "port")
    ref, _ = _single_package("secure", "jax")
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))
    # Two quantizations at 2^-17 each per client, plus the rounds' float32 roundings.
    np.testing.assert_allclose(port, _fedavg_reference(["c0", "c1", "c2"]), atol=1e-4)


def test_tolerant_round_with_a_dropout_matches_jax():
    """c3 leaves after round 1's share exchange: round 1 recovers the survivors' FedAvg."""
    port, port_hist = _single_package("tolerant", "port", drop=1)
    ref, ref_hist = _single_package("tolerant", "jax", drop=1)
    assert [h["num_dropped"] for h in port_hist] == [h["num_dropped"] for h in ref_hist] == [0, 1]
    np.testing.assert_allclose(port, ref, rtol=2e-7, atol=0)
    # Round 1 is the survivors' FedAvg: reproduce it on top of the round-0 aggregate.
    flat0 = _fedavg_reference(list(NUM_SAMPLES), rounds=1)
    survivors = ["c0", "c1", "c2"]
    w = np.asarray([NUM_SAMPLES[c] for c in survivors])
    step = sum(wi * np.asarray(tree_ravel(DELTAS[c])[0], np.float64)
               for wi, c in zip(w, survivors)) / w.sum()
    np.testing.assert_allclose(port, flat0 + step, atol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["port_clients_jax_server", "jax_clients_port_server",
                                       "mixed_clients_port_server"])
def test_interop_gives_the_single_package_aggregate(mode, direction):
    """Port clients against the JAX server and coordinator, JAX clients against the
    port's, and a cohort of both against the port's (host backend): the aggregate is
    the single-package round's (bit for bit where the arithmetic is exact)."""
    n = len(MODES[mode][2])
    server, clients = {
        "port_clients_jax_server": ("jax", ["port"] * n),
        "jax_clients_port_server": ("port", ["jax"] * n),
        "mixed_clients_port_server": ("port", (["port", "jax"] * n)[:n]),
    }[direction]
    coordinator = _run(mode, server, clients)
    assert [h["status"] for h in coordinator.history] == ["COMPLETED"] * ROUNDS
    got = _flat_params(server, coordinator)
    want, _ = _single_package(mode, server)
    if mode == "plain":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("server", ["port", "jax"])
def test_participants_and_completion_helpers_match_jax(server):
    """A tolerant cohort of port and JAX clients: each round every client's
    ``fetch_secagg_participants`` is its ``fetch_secagg_round_info`` cohort and the
    same list for all, and after the last round ``wait_for_completion`` returns for
    both packages' clients once the server reports training over."""
    seen = {}
    coordinator = _run("tolerant", server, ["port", "jax", "port", "jax"], seen=seen)
    assert [h["status"] for h in coordinator.history] == ["COMPLETED"] * ROUNDS
    for rnd in range(ROUNDS):
        answers = [seen[(cid, rnd)] for cid in NUM_SAMPLES]
        assert all(info == mine == answers[0][0] for info, mine in answers)
        assert sorted(answers[0][0]) == sorted(NUM_SAMPLES)
    assert [seen[(cid, "completed")] for cid in NUM_SAMPLES] == [False] * 4


def test_server_refuses_mixed_backend_and_device_enrollments():
    async def main():
        port = free_port()
        server = port_comm.HTTPServer(port=port)
        await server.start()
        try:
            await server.open_secagg(3)
            url = f"http://127.0.0.1:{port}/secagg/register"
            statuses = []
            async with aiohttp.ClientSession() as session:
                for cid, backend in [("a", "cuda"), ("b", "host"), ("c", "device"),
                                     ("d", "cuda")]:
                    key = sa.ClientKeyPair.generate().public_bytes()
                    import base64

                    body = {"public_key": base64.b64encode(key).decode(),
                            "num_samples": 1.0, "backend": backend}
                    async with session.post(url, json=body,
                                            headers={"X-NanoFed-Client": cid}) as resp:
                        statuses.append((resp.status, (await resp.json())["message"]))
            return statuses, server.secagg_backend(), server.secagg_enrolled()
        finally:
            await server.stop()

    statuses, backend, enrolled = asyncio.run(main())
    assert [s for s, _ in statuses] == [200, 409, 400, 200]
    assert "conflicts" in statuses[1][1] and "TPU" in statuses[2][1]
    assert backend == "cuda" and enrolled == 2


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_full_width_secure_round_on_the_cuda_backend(device):
    """One secure round at full ``mnist_cnn`` width (P = 1,199,882), 3 clients on the
    ``cuda`` backend, the masking and the server's unmask on ``device`` (on the CPU,
    through the kernels' plain versions): the aggregate is exactly the dequantized sum
    of the clients' float32-quantized weighted updates."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs CUDA: runs the secure round's B5/B6/B7 kernels on the card")
    model = get_model("mnist_cnn")
    init = model.init(torch.Generator().manual_seed(0))
    gens = [torch.Generator().manual_seed(1 + i) for i in range(3)]
    local = {f"c{i}": {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in init.items()}
             for i, g in enumerate(gens)}
    cfg = sa.SecureAggregationConfig(min_clients=3)
    samples = {"c0": 600.0, "c1": 600.0, "c2": 1200.0}

    async def client(url, cid):
        key = sa.ClientKeyPair.generate()
        async with port_comm.HTTPClient(url, cid, timeout_s=60) as c:
            assert await c.register_secagg(key.public_bytes(), samples[cid], backend="cuda")
            roster = await c.fetch_secagg_roster(timeout_s=60)
            _, rnd, _ = await _fetch(PKGS["port"], c, init)
            masked = sa.mask_update(local[cid], roster.index_of(cid), key, roster.ordered_keys(),
                                    rnd, cfg, weight=roster.weights[cid], backend="cuda",
                                    device=device)
            assert await c.submit_masked_update(masked, {"num_samples": samples[cid]})

    async def main():
        port = free_port()
        server = port_comm.HTTPServer(port=port)
        await server.start()
        try:
            coordinator = port_comm.NetworkCoordinator(
                server, init, port_comm.NetworkRoundConfig(min_clients=3, round_timeout_s=60),
                secure=cfg, device=device)
            url = f"http://127.0.0.1:{port}"
            await asyncio.gather(coordinator.run(), *(client(url, c) for c in local))
            return coordinator, server.secagg_weights()
        finally:
            await server.stop()

    coordinator, weights = asyncio.run(main())
    assert coordinator.history[0]["status"] == "COMPLETED"
    total = np.zeros(1_199_882, np.uint32)
    for cid, params in local.items():
        flat = ravel(params) * float(np.float32(weights[cid]))
        total = total + sa.quantize(flat.numpy().astype(np.float64), 16)
    want = np.float32(sa.dequantize(total, 16))
    got = ravel(coordinator.params).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_codec_payloads_decode_in_the_other_package(direction):
    """npz params, q8 and topk8 payloads: the same keys and arrays both ways (zip
    timestamps make the bytes differ, so the test is decode equality)."""
    nested = jax.tree.map(np.asarray, INIT)
    port_params = from_numpy_params(nested, device="cpu")
    if direction == "port_to_jax":
        decoded = jax_codec.decode_params(codec.encode_params(port_params), like=INIT)
        np.testing.assert_array_equal(np.asarray(tree_ravel(decoded)[0]),
                                      ravel(port_params).numpy())
        for enc, dec in [(codec.encode_delta_q8, jax_codec.decode_delta_q8),
                         (codec.encode_delta_topk8, jax_codec.decode_delta_topk8)]:
            port_payload = enc(port_params, seed=3)
            ref_payload = {"q8": jax_codec.encode_delta_q8,
                           "topk8": jax_codec.encode_delta_topk8}[
                "q8" if enc is codec.encode_delta_q8 else "topk8"](nested, seed=3)
            with np.load(io.BytesIO(port_payload)) as a, np.load(io.BytesIO(ref_payload)) as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(
                np.asarray(tree_ravel(dec(port_payload, like=INIT))[0]),
                np.asarray(tree_ravel(dec(ref_payload, like=INIT))[0]))
    else:
        payload = jax_codec.encode_params(INIT)
        got = codec.decode_params(payload, like=port_params)
        np.testing.assert_array_equal(ravel(got).numpy(), ravel(port_params).numpy())
        assert list(codec.decode_params(payload)) == list(port_params)
        q8 = jax_codec.encode_delta_q8(nested, seed=4)
        np.testing.assert_array_equal(
            ravel(codec.reconstruct_q8(port_params, q8)).numpy(),
            np.asarray(tree_ravel(jax_codec.reconstruct_q8(nested, q8))[0]))
        tk = jax_codec.encode_delta_topk8(nested, fraction=0.3, seed=4)
        np.testing.assert_array_equal(
            ravel(codec.reconstruct_topk8(port_params, tk)).numpy(),
            np.asarray(tree_ravel(jax_codec.reconstruct_topk8(nested, tk))[0]))


def test_codec_bfloat16_leaves_cross_load():
    nested = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3}
    got = codec.decode_params(jax_codec.encode_params(nested))
    assert got["w"].dtype == torch.bfloat16
    back = jax_codec.decode_params(codec.encode_params(got), like=nested)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(nested["w"], np.float32))


def test_codec_refuses_a_payload_that_does_not_fit_the_template():
    template = from_numpy_params(jax.tree.map(np.asarray, INIT), device="cpu")
    bad = dict(template)
    bad["fc/bias"] = torch.zeros(5)
    with pytest.raises(NanoFedError, match="shape mismatch"):
        codec.decode_params(codec.encode_params(bad), like=template)
    with pytest.raises(NanoFedError, match="missing"):
        codec.decode_params(codec.encode_params({"fc/bias": template["fc/bias"]}), like=template)


def test_chaos_options_are_taken_as_the_jax_package_takes_them():
    """``chaos=``, ``clock=`` and ``wire_filter=`` (the faults slice) are accepted
    where the JAX package accepts them; ``tests/test_torch_chaos.py`` runs them."""
    import inspect

    from nanofed_tpu.faults import ChaosSchedule as JaxSchedule
    from nanofed_tpu.faults import FaultPlan as JaxPlan
    from nanofed_tpu_torch.communication import http_client, http_server
    from nanofed_tpu_torch.communication import network_coordinator as nc
    from nanofed_tpu_torch.faults import ChaosSchedule, FaultPlan
    from nanofed_tpu_torch.utils.clock import VirtualClock

    for owner, names in ((jax_comm.HTTPServer, ("chaos", "clock")),
                         (jax_comm.NetworkCoordinator, ("chaos",)),
                         (jax_comm.HTTPClient, ("wire_filter",))):
        port_owner = getattr(port_comm, owner.__name__)
        for name in names:
            assert inspect.signature(owner).parameters[name].default is None
            assert inspect.signature(port_owner).parameters[name].default is None
    # Every server and coordinator option is taken: no refusal table is left.
    for module in (http_server, nc, http_client):
        assert not hasattr(module, "LATER_SLICE_OPTIONS")
    assert not hasattr(http_server, "refuse_later_slice_options")
    schedule = ChaosSchedule(FaultPlan(seed=1))
    clock = VirtualClock()
    server = port_comm.HTTPServer(port=free_port(), chaos=schedule, clock=clock)
    assert server._chaos is schedule and server._clock is clock
    coordinator = port_comm.NetworkCoordinator(server, {}, port_comm.NetworkRoundConfig(),
                                               device="cpu", chaos=schedule, clock=clock)
    assert coordinator.chaos is schedule
    flip = lambda endpoint, body: body[::-1]  # noqa: E731
    assert port_comm.HTTPClient("http://127.0.0.1:1", "c0", wire_filter=flip).wire_filter is flip
    # A schedule of the JAX package is duck-typed the same way.
    jax_schedule = JaxSchedule(JaxPlan(seed=1))
    assert port_comm.HTTPServer(port=free_port(), chaos=jax_schedule)._chaos is jax_schedule


def _one_plain_round(server_kwargs, client_kwargs):
    """One plain round of c0 on a port server built with ``server_kwargs``, the client
    built with ``client_kwargs``; returns the server."""
    from nanofed_tpu_torch.observability import MetricsRegistry

    async def main():
        port = free_port()
        server = port_comm.HTTPServer(port=port, registry=MetricsRegistry(), **server_kwargs)
        await server.start()
        try:
            coordinator = port_comm.NetworkCoordinator(
                server, from_numpy_params(INIT, device="cpu"),
                port_comm.NetworkRoundConfig(num_rounds=1, round_timeout_s=20.0,
                                             poll_interval_s=0.02), device="cpu")
            url = f"http://127.0.0.1:{port}"

            async def client():
                async with port_comm.HTTPClient(url, "c0", timeout_s=30,
                                                **client_kwargs) as c:
                    params, rnd, _ = await _fetch(PKGS["port"], c, PKGS["port"].params(INIT))
                    assert await c.submit_update(_port_add(params, DELTAS["c0"]),
                                                 {"num_samples": 3.0})

            await asyncio.wait_for(asyncio.gather(coordinator.run(), client()), 60)
            return server
        finally:
            await server.stop()

    return asyncio.run(main())


def test_client_registry_receives_the_wire_metrics():
    """``HTTPClient(registry=)``: the client's wire families, the JAX package's."""
    from nanofed_tpu_torch.observability import MetricsRegistry

    registry = MetricsRegistry()
    server = _one_plain_round({}, {"registry": registry})
    text = registry.render_prometheus()
    for family in ("nanofed_client_bytes_sent_total", "nanofed_client_bytes_received_total",
                   "nanofed_client_submissions_total", "nanofed_client_codec_ratio",
                   "nanofed_client_retries_total"):
        assert f"# TYPE {family} " in text
    sent = registry.counter("nanofed_client_bytes_sent_total", labels=("endpoint",))
    received = server.metrics_registry.counter("nanofed_bytes_received_total",
                                               labels=("endpoint",))
    assert sent.value(endpoint="update") == received.value(endpoint="update") > 0
    assert registry.counter("nanofed_client_submissions_total", labels=("result",)).value(
        result="accepted") == 1


def test_server_tracer_wraps_each_decode_in_a_traced_span():
    """``HTTPServer(tracer=)``: a ``submit-decode`` span carrying the submit's trace id."""
    from nanofed_tpu_torch.observability import SpanTracer, new_trace

    tracer = SpanTracer(registry=False, annotate_device=False)
    _one_plain_round({"tracer": tracer}, {})
    (decode,) = [r for r in tracer.records if r.name == "submit-decode"]
    assert decode.attrs == {"client": "c0", "encoding": "npz",
                            "trace": new_trace("c0", 0, 1).trace_id}


def test_plain_submit_refuses_compressed_encodings_and_stale_rounds():
    async def main():
        port = free_port()
        server = port_comm.HTTPServer(port=port)
        await server.start()
        template = from_numpy_params(jax.tree.map(np.asarray, INIT), device="cpu")
        try:
            await server.publish_model(template, 2)
            url = f"http://127.0.0.1:{port}/update"
            body = codec.encode_params(template)
            out = []
            async with aiohttp.ClientSession() as session:
                for headers in [{"X-NanoFed-Round": "2", "X-NanoFed-Encoding": "zstd-delta"},
                                {"X-NanoFed-Round": "1"},
                                {"X-NanoFed-Round": "2", "X-NanoFed-Submit": "k1"},
                                {"X-NanoFed-Round": "2", "X-NanoFed-Submit": "k1"}]:
                    async with session.post(url, data=body,
                                            headers={"X-NanoFed-Client": "a", **headers}) as r:
                        out.append((r.status, await r.json()))
            return out, await server.drain_updates()
        finally:
            await server.stop()

    out, updates = asyncio.run(main())
    assert [s for s, _ in out] == [400, 400, 200, 200]
    assert out[0][1]["message"] == "unknown encoding 'zstd-delta'"
    assert out[1][1]["message"] == "update for round 1, server is on 2"
    assert out[3][1]["duplicate"] is True
    assert len(updates) == 1 and updates[0].client_id == "a"
    np.testing.assert_array_equal(ravel(updates[0].params).numpy(),
                                  np.asarray(tree_ravel(INIT)[0]))


def test_secure_round_fails_when_a_client_never_submits():
    """No-dropout SecAgg: a missing cohort member leaves masks that cannot cancel, so
    the round FAILS and the params are untouched."""
    cfg_kw = dict(min_clients=3)

    async def main():
        port = free_port()
        server = port_comm.HTTPServer(port=port)
        await server.start()
        try:
            cfg = sa.SecureAggregationConfig(**cfg_kw)
            coordinator = port_comm.NetworkCoordinator(
                server, PKGS["port"].params(INIT),
                port_comm.NetworkRoundConfig(min_clients=3, round_timeout_s=1.0,
                                             poll_interval_s=0.02),
                secure=cfg, device="cpu")
            url = f"http://127.0.0.1:{port}"

            async def enroll_only(cid):
                async with port_comm.HTTPClient(url, cid) as c:
                    await c.register_secagg(sa.ClientKeyPair.generate().public_bytes(), 1.0)

            await asyncio.gather(coordinator.run(),
                                 _secure_client(PKGS["port"], url, "c0", cfg),
                                 _secure_client(PKGS["port"], url, "c1", cfg),
                                 enroll_only("c2"))
            return coordinator
        finally:
            await server.stop()

    coordinator = asyncio.run(main())
    assert coordinator.history[0]["status"] == "FAILED"
    np.testing.assert_array_equal(ravel(coordinator.params).numpy(),
                                  np.asarray(tree_ravel(INIT)[0]))
    assert coordinator.ledger.rounds["failed"] == 1


def test_port_params_round_trip_the_jax_layout():
    nested = jax.tree.map(np.asarray, INIT)
    back = to_numpy_params(from_numpy_params(nested, device="cpu"))
    np.testing.assert_array_equal(back["fc"]["kernel"], nested["fc"]["kernel"])


def test_client_retries_a_503_until_the_model_is_published():
    """With a ``RetryPolicy`` a fetch rides out the server's 503 (no model yet) and the
    idempotency key lets a re-sent submit be folded at most once."""

    async def main():
        port = free_port()
        server = port_comm.HTTPServer(port=port)
        await server.start()
        template = from_numpy_params(jax.tree.map(np.asarray, INIT), device="cpu")
        try:
            retry = port_comm.RetryPolicy(max_attempts=50, base_backoff_s=0.01,
                                          max_backoff_s=0.02, seed=0)
            async with port_comm.HTTPClient(f"http://127.0.0.1:{port}", "c0",
                                            retry=retry) as client:
                fetch = asyncio.ensure_future(client.fetch_global_model(like=template))
                await asyncio.sleep(0.1)
                assert not fetch.done()  # still retrying the 503
                await server.publish_model(template, 0)
                params, rnd, active = await fetch
                assert active and rnd == 0
                assert await client.submit_update(params, {"num_samples": 1.0})
            async with port_comm.HTTPClient(f"http://127.0.0.1:{port}", "c1",
                                            port_comm.ClientEndpoints(model="/nope")) as client:
                with pytest.raises(NanoFedError, match="HTTP 404"):  # final, not retried
                    await client.fetch_global_model()
            return await server.drain_updates()
        finally:
            await server.stop()

    updates = asyncio.run(main())
    assert [u.client_id for u in updates] == ["c0"]


def test_stragglers_are_evicted_from_the_barrier_and_rejoin():
    """After ``straggler_evict_after`` consecutive missed rounds a seen client leaves
    the expected population (the barrier degrades); a returning client rejoins."""
    coordinator = port_comm.NetworkCoordinator(
        port_comm.HTTPServer(port=free_port()), {"w": torch.zeros(2)},
        port_comm.NetworkRoundConfig(min_clients=3, straggler_evict_after=2), device="cpu")
    assert coordinator._required_clients() == 3
    assert coordinator._note_participation({"a", "b", "c"}) == []
    assert coordinator._note_participation({"a", "b"}) == []
    assert coordinator._note_participation({"a", "b"}) == ["c"]
    assert coordinator._required_clients() == 2
    assert coordinator._note_participation({"a", "b", "c"}) == []
    assert coordinator._required_clients() == 3
