"""The port's load generator (``nanofed_tpu_torch.loadgen``) against the JAX package's
(``nanofed_tpu.loadgen``) on the CPU.

* The numpy streams bit for bit: ``arrival_offsets`` for poisson, uniform and burst;
  ``latency_digest``; the canned payloads for npz, q8 and topk8, which decode to equal
  arrays given the JAX params carried across.
* The production client contract: both packages' swarms against one scripted server
  (429 with ``Retry-After``, a stale-round 400, a 503, then a duplicate 200) send the
  same headers at the same virtual times and count the same outcomes.
* The loadtest smoke of ``tests/integration/test_loadtest_smoke.py`` (200 clients on a
  ``VirtualClock``, both serving paths) in both packages: no submit lost in the port,
  the JAX artifact's key sets, and ``summarize_telemetry`` digests it; the adapter
  block's counts equal the JAX package's.  Params differ by design (torch's generator
  against JAX's key), so latencies and params are not compared.
"""

import pytest

pytest.importorskip("aiohttp", reason="the load generator needs aiohttp")

import asyncio
import dataclasses
import json
import math

import jax
import numpy as np
from aiohttp import web

import nanofed_tpu.communication.codec as jax_codec
import nanofed_tpu.loadgen as jax_loadgen
import nanofed_tpu.loadgen.swarm as jax_swarm
import nanofed_tpu_torch.communication.codec as codec
import nanofed_tpu_torch.loadgen as port_loadgen
import nanofed_tpu_torch.loadgen.swarm as port_swarm
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.utils.clock import VirtualClock as JaxVirtualClock
from nanofed_tpu_torch.communication import HTTPServer
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.observability.telemetry import summarize_telemetry
from nanofed_tpu_torch.utils.clock import VirtualClock
from nanofed_tpu_torch.utils.trees import from_numpy_params

JAX_PARAMS = jax.tree.map(np.asarray, jax_get_model("mlp").init(jax.random.key(3)))
SWARM_CLIENTS = 200


def _port_params():
    return from_numpy_params(JAX_PARAMS, device="cpu")


@pytest.mark.parametrize("arrival,rate,n,seed", [
    ("poisson", 2000.0, 10_000, 0), ("poisson", 37.5, 257, 9), ("uniform", 5000.0, 200, 1),
    ("uniform", 3.0, 31, 4), ("burst", 1.0, 64, 2),
])
def test_arrival_offsets_are_the_jax_draws(arrival, rate, n, seed):
    kw = dict(num_clients=n, arrival=arrival, arrival_rate=rate, seed=seed)
    ours = port_swarm.arrival_offsets(port_swarm.SwarmConfig(**kw))
    theirs = jax_swarm.arrival_offsets(jax_swarm.SwarmConfig(**kw))
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_latency_digest_equals_the_jax_digest():
    rng = np.random.default_rng(5)
    for xs in ([], [0.25], list(rng.exponential(0.1, 999)), list(rng.uniform(0, 3, 100))):
        assert port_swarm.latency_digest(xs) == jax_swarm.latency_digest(xs)


def test_swarm_config_fields_and_refusals_equal_jax():
    assert dataclasses.asdict(port_swarm.SwarmConfig()) == \
        dataclasses.asdict(jax_swarm.SwarmConfig())
    for bad in (dict(num_clients=0), dict(submits_per_client=0), dict(arrival="zipf"),
                dict(arrival_rate=0), dict(canned_payloads=0), dict(encoding="gzip"),
                dict(topk_fraction=0.0), dict(topk_fraction=1.5)):
        for mod in (port_swarm, jax_swarm):
            with pytest.raises(ValueError):
                mod.SwarmConfig(**bad)
    assert sorted(port_loadgen.__all__) == sorted(jax_loadgen.__all__)


def _jax_flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _port_flat(params):
    return np.concatenate([leaf.numpy().astype(np.float32).ravel() for leaf in params.values()])


@pytest.mark.parametrize("encoding", ["npz", "q8-delta", "topk8-delta"])
def test_canned_payloads_decode_to_the_jax_arrays(encoding):
    kw = dict(encoding=encoding, canned_payloads=3, seed=4, delta_scale=2e-3,
              topk_fraction=0.1)
    ours = port_swarm.make_canned_payloads(_port_params(), port_swarm.SwarmConfig(**kw))
    theirs = jax_swarm.make_canned_payloads(JAX_PARAMS, jax_swarm.SwarmConfig(**kw))
    assert len(ours) == len(theirs) == 3
    like = _port_params()
    for a, b in zip(ours, theirs):
        if encoding == "npz":
            got, want = codec.decode_params(a, like=like), jax_codec.decode_params(b, like=JAX_PARAMS)
        elif encoding == "q8-delta":
            got, want = codec.decode_delta_q8(a, like), jax_codec.decode_delta_q8(b, JAX_PARAMS)
        else:
            got, want = (codec.decode_delta_topk8(a, like),
                         jax_codec.decode_delta_topk8(b, JAX_PARAMS))
        assert np.array_equal(_port_flat(got), _jax_flat(want))


# The scripted server: what each attempt of the one client is answered.
SCRIPT = [
    (429, {"Retry-After": "0.3"}, {"status": "error", "message": "busy"}),
    (400, {}, {"status": "error", "message": "stale"}),
    (503, {}, {"status": "error", "message": "down"}),
    (200, {}, {"status": "success", "duplicate": True}),
]
RECORDED = ("X-NanoFed-Client", "X-NanoFed-Round", "X-NanoFed-Submit", "X-NanoFed-Trace",
            "X-NanoFed-Encoding", "X-NanoFed-Tier", "X-NanoFed-Metrics")


def _scripted_swarm(mod, clock_cls, params):
    """One client of ``mod``'s swarm against the script; returns what the server saw
    (headers and the virtual time of each attempt) and the swarm's counts."""
    async def main():
        clock = clock_cls()
        seen, state = [], {"round": 0}

        async def update(request):
            seen.append((round(clock.time(), 9),
                         {h: request.headers.get(h) for h in RECORDED}))
            status, headers, body = SCRIPT[len(seen) - 1]
            if status == 400:
                state["round"] += 1  # the stale submit's server moved on
            await request.read()
            return web.json_response(body, status=status, headers=headers)

        async def status(request):
            return web.json_response({"status": "success", "round": state["round"],
                                      "training_active": True})

        app = web.Application()
        app.router.add_post("/update", update)
        app.router.add_get("/status", status)
        runner = web.AppRunner(app)
        await runner.setup()
        port = free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            config = mod.SwarmConfig(num_clients=1, arrival="burst", encoding="q8-delta",
                                     tier="edge", canned_payloads=1)
            result = await mod.run_swarm(f"http://127.0.0.1:{port}", params, config,
                                         clock=clock)
        finally:
            await runner.cleanup()
        counts = {k: getattr(result, k) for k in (
            "accepted", "duplicates", "rejected_429", "retries", "stale_refreshes", "failed",
            "terminated_early", "reroutes", "completed_indices")}
        return seen, counts

    return asyncio.run(main())


def test_submit_contract_equals_the_jax_client():
    ours = _scripted_swarm(port_swarm, VirtualClock, _port_params())
    theirs = _scripted_swarm(jax_swarm, JaxVirtualClock, JAX_PARAMS)
    assert ours == theirs
    seen, counts = ours
    keys = [h["X-NanoFed-Submit"] for _, h in seen]
    # The 429's retry re-sends the same key; the stale 400 starts a new logical submit.
    assert keys[0] == keys[1] and keys[2] == keys[3] and keys[1] != keys[2]
    assert seen[1][0] - seen[0][0] >= 0.3  # Retry-After is the backoff floor
    assert {h["X-NanoFed-Tier"] for _, h in seen} == {"edge"}
    assert counts == {"accepted": 0, "duplicates": 1, "rejected_429": 1, "retries": 2,
                      "stale_refreshes": 1, "failed": 0, "terminated_early": 0,
                      "reroutes": 0, "completed_indices": [0]}


def test_the_port_server_takes_tier_stamped_compressed_submits():
    """``tier`` stamps ``X-NanoFed-Tier``: a fleet server decodes the edge tier's q8
    submits against the edge view and accepts them (``tests/test_torch_fleet_server.py``
    holds the tier routing against the JAX server)."""
    from nanofed_tpu_torch.fleet import FleetGateway, reference_fleet
    from nanofed_tpu_torch.ingest import IngestConfig

    async def main():
        gateway = FleetGateway(reference_fleet(), _port_params(), device="cpu")
        server = HTTPServer(port=free_port(), registry=MetricsRegistry(),
                            ingest=IngestConfig(capacity=8), fleet=gateway, device="cpu")
        await server.start()
        try:
            await server.publish_model(_port_params(), 0)
            result = await port_swarm.run_swarm(
                f"http://127.0.0.1:{server.port}", gateway.view("edge").tree,
                port_swarm.SwarmConfig(num_clients=4, arrival="burst", tier="edge",
                                       encoding="q8-delta"), clock=VirtualClock())
            return result, server.num_updates()
        finally:
            server.stop_training()
            await server.stop()

    result, buffered = asyncio.run(main())
    assert (result.accepted, result.failed, buffered) == (4, 0, 4)


def _smoke(mod, tmp, **extra):
    return mod.run_loadtest_comparison(
        modes=("per-submit", "ingest"), out_dir=tmp, telemetry_dir=tmp, tag="smoke",
        clients=SWARM_CLIENTS, async_buffer_k=25, arrival="poisson", arrival_rate=5000.0,
        max_inflight=128, ingest_capacity=128, round_timeout_s=60.0, virtual_clock=True,
        seed=0, **extra)


def test_loadtest_smoke_loses_no_submit_with_the_jax_artifact_shape(tmp_path):
    ours = _smoke(port_loadgen, tmp_path / "port", device="cpu")
    theirs = _smoke(jax_loadgen, tmp_path / "jax")
    parsed = json.loads((tmp_path / "port" / "loadtest_smoke.json").read_text())
    assert parsed["record_type"] == "loadtest" and set(parsed["modes"]) == {"per-submit",
                                                                           "ingest"}
    for mode, rec in parsed["modes"].items():
        lat = rec["submit_latency_s"]
        assert lat["count"] > 0 and math.isfinite(lat["p99_s"]), mode
        assert lat["p50_s"] <= lat["p99_s"] <= lat["max_s"], mode
        assert rec["failed_submits"] == 0, mode
        assert rec["accepted"] + rec["duplicates"] >= SWARM_CLIENTS, mode
        assert rec["aggregations_completed"] > 0 and rec["rounds_per_sec"] > 0, mode
        assert rec["clock"] == "virtual"
        assert set(rec) == set(theirs["modes"][mode]), mode
        for block in ("submit_latency_s", "decode_pool", "ingest", "aggregate_span"):
            if isinstance(theirs["modes"][mode][block], dict):
                assert set(rec[block]) == set(theirs["modes"][mode][block]), (mode, block)
    ingest = parsed["modes"]["ingest"]
    assert ingest["decode_pool"]["workers"] == 4 and ingest["ingest"]["capacity"] == 128
    assert ingest["ingest"]["drains"] == ingest["aggregations_completed"]
    assert set(ours) - {"env"} == set(theirs) - {"env"}
    summary = summarize_telemetry(tmp_path / "port" / "telemetry.jsonl")
    assert set(summary["loadtests"]) == {"per-submit", "ingest"}
    for mode, digest in summary["loadtests"].items():
        assert math.isfinite(digest["p99_s"]) and digest["clients"] == SWARM_CLIENTS


def test_adapter_loadtest_counts_equal_the_jax_block():
    kw = dict(mode="per-submit", clients=16, async_buffer_k=8, model="mlp", adapter_rank=4,
              virtual_clock=True, seed=1, max_inflight=None)
    ours = port_loadgen.run_loadtest(device="cpu", **kw)
    theirs = jax_loadgen.run_loadtest(**kw)
    assert ours["failed_submits"] == 0 and ours["aggregations_completed"] == 2
    bytes_keys = {"payload_bytes_full", "payload_bytes_adapter", "payload_reduction"}
    assert {k: v for k, v in ours["adapter"].items() if k not in bytes_keys} == \
        {k: v for k, v in theirs["adapter"].items() if k not in bytes_keys}
    assert ours["adapter"]["payload_bytes_full"] > 4 * ours["adapter"]["payload_bytes_adapter"]


def test_loadtest_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_loadgen.run_loadtest(clients=4)
    with pytest.raises(ValueError, match="unknown loadtest mode"):
        port_loadgen.run_loadtest(mode="both", device="cpu")


@pytest.mark.parametrize("virtual_clock", [True, False])
def test_a_submit_shed_after_the_engine_ends_is_terminated_not_lost(virtual_clock):
    """The engine stops after 2 aggregations of 8 while all 100 clients of a burst are
    in flight, and nothing drains the 16-slot buffer after that: a submit it sheds ends
    ``terminated_early`` at its next failed attempt, as at a refresh, not ``failed``
    once its retry budget is spent (the JAX swarm retries on and loses 68)."""
    rec = port_loadgen.run_loadtest(
        mode="ingest", device="cpu", clients=100, model="mlp", async_buffer_k=8,
        aggregations=2, ingest_capacity=16, decode_workers=2, max_inflight=512,
        arrival="burst", round_timeout_s=5.0, virtual_clock=virtual_clock, seed=0)
    assert rec["aggregations_completed"] == 2
    assert rec["ingest"]["offers"]["buffer_full"] > 0 and rec["http_429_total"] > 0
    assert rec["failed_submits"] == 0 and rec["terminated_early"] > 0
    assert rec["accepted"] + rec["duplicates"] + rec["terminated_early"] == 100
