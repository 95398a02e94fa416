"""The fleet over the wire and its artifacts (``HTTPServer(fleet=)``, the tier header,
``fleet.swarm``, ``fleet.evidence``, ``adapters.evidence.generate_fedbuff_adapter_artifact``)
against the JAX package on the CPU.

* The tier header: on a server with no fleet a tier-tagged ``GET /model`` and
  ``POST /update`` are 400s and the submit counts ``bad_tier``, in both packages; with
  a fleet, unknown tiers, encodings other than the tier's codec and masked bodies are
  the same 400s with the same counters, and a tier's ``GET /model`` serves its view.
* The live fleet on a ``VirtualClock`` (the JAX ``test_fleet_swarm_smoke``): per-tier
  outcomes and the fleet byte counters equal the JAX server's on the same seeds; one
  full round (publish, swarm, ``drain_ingest_fedavg``, publish) drains a global
  within 1e-5 of the JAX server's on the same bodies (float32 sums in another order).
* ``run_fleet_convergence`` at 3 rounds from the JAX initial weights: the JAX record's
  keys, dense/padded parity within 1e-6 every round, the same submits, and losses
  within 1e-3 of JAX's (a trajectory tolerance: the views may differ by
  singular-vector signs, which SGD carries through unchanged, but the q8 and topk8
  rounding of a sign-flipped delta draws other values).
* The FedBuff ablation's event replay (aggregations, staleness, skips) equals JAX's;
  the fleet and FedBuff-adapter artifacts carry the JAX records' fields.
"""

import pytest

pytest.importorskip("aiohttp", reason="the fleet server needs aiohttp")

import asyncio
import dataclasses
import io

import aiohttp
import jax
import numpy as np

from nanofed_tpu import fleet as jfleet
from nanofed_tpu.adapters import evidence as jax_adapter_evidence
from nanofed_tpu.communication.http_server import HTTPServer as JaxServer
from nanofed_tpu.fleet import evidence as jax_evidence
from nanofed_tpu.ingest import IngestConfig as JaxIngestConfig
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry
from nanofed_tpu.utils.clock import VirtualClock as JaxClock
from nanofed_tpu_torch import fleet
from nanofed_tpu_torch.adapters import evidence as adapter_evidence
from nanofed_tpu_torch.communication import HTTPServer
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.fleet import evidence
from nanofed_tpu_torch.ingest import IngestConfig
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.observability.telemetry import summarize_telemetry
from nanofed_tpu_torch.utils.clock import VirtualClock
from nanofed_tpu_torch.utils.trees import from_numpy_params, unravel

SWARM_CLIENTS = 24
DRAIN_TOL = 1e-5
TRAJECTORY_TOL = 1e-3
MLP = dict(in_features=64, hidden=128, num_classes=10)


def _jax_base(seed=0):
    return jax.device_get(jax_get_model("mlp", **MLP).init(jax.random.key(seed)))


def _servers(fleet_on: bool, **kw):
    """(port server, JAX server, port registry, JAX registry), a fleet on each when
    ``fleet_on`` (views from the same JAX base)."""
    jp = _jax_base()
    preg, jreg = MetricsRegistry(), JaxRegistry()
    pkw, jkw = dict(kw), dict(kw)
    if fleet_on:
        pkw.update(ingest=IngestConfig(capacity=4 * SWARM_CLIENTS),
                   fleet=fleet.FleetGateway(fleet.reference_fleet(),
                                            from_numpy_params(jp, device="cpu"),
                                            device="cpu"))
        jkw.update(ingest=JaxIngestConfig(capacity=4 * SWARM_CLIENTS),
                   fleet=jfleet.FleetGateway(jfleet.reference_fleet(), jp))
    port = HTTPServer(port=free_port(), registry=preg, device="cpu", **pkw)
    ref = JaxServer(port=free_port(), registry=jreg, **jkw)
    return port, ref, preg, jreg, jp


async def _probe(server, params, requests):
    """Start ``server``, publish round 0, send ``requests`` ((method, path, headers,
    body)); the statuses and bodies."""
    await server.start()
    try:
        await server.publish_model(params=params, round_number=0)
        out = []
        async with aiohttp.ClientSession() as http:
            for method, path, headers, body in requests:
                async with http.request(method, f"http://127.0.0.1:{server.port}{path}",
                                        headers=headers, data=body) as resp:
                    out.append((resp.status, await resp.read(), dict(resp.headers)))
        return out
    finally:
        await server.stop()


def _counter(registry, family, **labels):
    values = registry.snapshot().get(family, {}).get("values", {})
    return values.get(",".join(labels.values()), 0.0)


def test_a_tier_header_on_a_server_with_no_fleet_is_a_400_like_jax():
    port, ref, preg, jreg, jp = _servers(False)
    tier = {"X-NanoFed-Tier": "phone"}
    requests = [("GET", "/model", tier, None),
                ("POST", "/update", {**tier, "X-NanoFed-Client": "c", "X-NanoFed-Round": "0"},
                 b"x")]
    got = asyncio.run(_probe(port, from_numpy_params(jp, device="cpu"), requests))
    want = asyncio.run(_probe(ref, jp, requests))
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [400, 400]
    assert all(b"no fleet configured" in body for _, body, _ in got)
    for reg in (preg, jreg):
        assert _counter(reg, "nanofed_updates_total", kind="plain", result="bad_tier") == 1.0


def test_fleet_server_refusals_equal_jax():
    gw = fleet.FleetGateway(fleet.reference_fleet(),
                            from_numpy_params(_jax_base(), device="cpu"), device="cpu")
    jgw = jfleet.FleetGateway(jfleet.reference_fleet(), _jax_base())
    for kw in (dict(), dict(ingest="on", require_signatures=True)):
        pkw = {k: IngestConfig(capacity=2) if v == "on" else v for k, v in kw.items()}
        jkw = {k: JaxIngestConfig(capacity=2) if v == "on" else v for k, v in kw.items()}
        with pytest.raises(ValueError) as got:
            HTTPServer(port=free_port(), fleet=gw, device="cpu", registry=MetricsRegistry(),
                       **pkw)
        with pytest.raises(ValueError) as want:
            JaxServer(port=free_port(), fleet=jgw, registry=JaxRegistry(), **jkw)
        assert str(got.value) == str(want.value)


def test_fleet_server_routes_tiers_like_jax():
    """A tier's ``GET /model`` serves its view; unknown tiers, a mismatched encoding and
    masked bodies are 400s; the counters equal the JAX server's."""
    port, ref, preg, jreg, jp = _servers(True)
    sub = {"X-NanoFed-Client": "c", "X-NanoFed-Round": "0"}
    requests = [
        ("GET", "/model", {"X-NanoFed-Tier": "edge"}, None),
        ("GET", "/model", {"X-NanoFed-Tier": "watch"}, None),
        ("POST", "/update", {**sub, "X-NanoFed-Tier": "watch"}, b"x"),
        ("POST", "/update", {**sub, "X-NanoFed-Tier": "edge",
                             "X-NanoFed-Encoding": "topk8-delta"}, b"x"),
        ("POST", "/update", {**sub, "X-NanoFed-Tier": "edge", "X-NanoFed-SecAgg": "masked"},
         b"x"),
        ("POST", "/update", {**sub, "X-NanoFed-Tier": "silo"}, b"not an npz"),
    ]
    got = asyncio.run(_probe(port, from_numpy_params(jp, device="cpu"), requests))
    want = asyncio.run(_probe(ref, jp, requests))
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [200, 400, 400, 400, 400, 400]
    assert got[0][1] == port.fleet.payload("edge") and got[0][2]["X-NanoFed-Tier"] == "edge"
    assert len(got[0][1]) == len(want[0][1])
    for family, labels in (
            ("nanofed_updates_total", dict(kind="plain", result="bad_tier")),
            ("nanofed_updates_total", dict(kind="masked", result="bad_tier")),
            ("nanofed_updates_total", dict(kind="plain", result="bad_payload")),
            ("nanofed_fleet_updates_total", dict(tier="edge", result="encoding_mismatch")),
            ("nanofed_fleet_updates_total", dict(tier="silo", result="bad_payload")),
            ("nanofed_fleet_bytes_total", dict(tier="edge", direction="tx")),
            ("nanofed_fleet_bytes_total", dict(tier="silo", direction="rx"))):
        assert _counter(preg, family, **labels) == _counter(jreg, family, **labels) > 0, \
            (family, labels)


def test_the_dense_payload_is_encoded_at_the_first_untiered_fetch(monkeypatch):
    """Stated difference: a publish encodes no dense npz (the JAX server encodes it at
    every publish); the first ``GET /model`` without a tier header does, once, and
    serves the JAX server's payload (the same arrays)."""
    from nanofed_tpu_torch.communication import http_server

    port, ref, _, _, jp = _servers(True)
    encodes = []
    real = http_server.encode_params
    monkeypatch.setattr(http_server, "encode_params",
                        lambda params: encodes.append(1) or real(params))
    tiered = [("GET", "/model", {"X-NanoFed-Tier": t}, None) for t in ("phone", "silo")]
    untiered = [("GET", "/model", {}, None)] * 2
    got = asyncio.run(_probe(port, from_numpy_params(jp, device="cpu"), tiered))
    assert [s for s, _, _ in got] == [200, 200] and encodes == []
    port, _, _, _, _ = _servers(True)
    got = asyncio.run(_probe(port, from_numpy_params(jp, device="cpu"), untiered))
    want = asyncio.run(_probe(ref, jp, untiered))
    assert encodes == [1] and got[0][1] == got[1][1]
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [200, 200]
    ours, theirs = np.load(io.BytesIO(got[0][1])), np.load(io.BytesIO(want[0][1]))
    assert sorted(ours.files) == sorted(theirs.files)
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours.files)


def test_tier_swarm_configs_equal_jax():
    got = fleet.tier_swarm_configs(fleet.reference_fleet(), 24, submits_per_client=2, seed=3)
    want = jfleet.tier_swarm_configs(jfleet.reference_fleet(), 24, submits_per_client=2,
                                     seed=3)
    assert list(got) == list(want) == ["phone", "edge", "silo"]
    for name in got:
        ours, theirs = dataclasses.asdict(got[name]), dataclasses.asdict(want[name])
        assert {k: v for k, v in ours.items() if k in theirs and k != "retry"} == \
            {k: v for k, v in theirs.items() if k in ours and k != "retry"}
    assert [c.num_clients for c in got.values()] == [7, 5, 1]


@pytest.fixture(scope="module")
def swarm_legs():
    return (asyncio.run(evidence._swarm_leg(fleet.reference_fleet(), SWARM_CLIENTS, 2,
                                            device="cpu")),
            asyncio.run(jax_evidence._swarm_leg(jfleet.reference_fleet(), SWARM_CLIENTS, 2)))


def test_fleet_swarm_smoke_counts_equal_jax(swarm_legs):
    got, want = swarm_legs
    drop = ("latency",)
    assert {t: {k: v for k, v in r.items() if k not in drop} for t, r in got["tiers"].items()} \
        == {t: {k: v for k, v in r.items() if k not in drop} for t, r in want["tiers"].items()}
    assert got["server_bytes_by_tier"] == want["server_bytes_by_tier"]
    assert got.keys() == want.keys()
    assert got["failed_total"] == 0 and got["accepted_total"] == want["accepted_total"] > 0
    assert {k.split(",")[0] for k in got["server_bytes_by_tier"] if k.endswith(",rx")} == \
        {"phone", "edge", "silo"}


def test_one_fleet_round_drains_the_jax_servers_global():
    """Publish, one sub-swarm a tier, ``drain_ingest_fedavg``, publish: the port's
    drained global within 1e-5 of the JAX server's on the same bodies, and each
    tier's accepted count equal to its submits."""
    port, ref, preg, jreg, jp = _servers(True, clock=None)
    pp = from_numpy_params(jp, device="cpu")

    async def round_trip(server, params, pkg, clock, registry):
        await server.start()
        try:
            await server.publish_model(params=params, round_number=0)
            bases = {t: server.fleet.view(t).tree for t in server.fleet.profile.tier_names()}
            results = await pkg.run_fleet_swarm(
                f"http://127.0.0.1:{server.port}", server.fleet.profile, bases,
                SWARM_CLIENTS, seed=5, clock=clock, registry=registry)
            flat, metas = await server.drain_ingest_fedavg()
            return results, flat, metas
        finally:
            await server.stop()

    results, flat, metas = asyncio.run(round_trip(port, pp, fleet, VirtualClock(), preg))
    jresults, jflat, jmetas = asyncio.run(round_trip(ref, jp, jfleet, JaxClock(), jreg))
    for name, res in results.items():
        assert res.accepted == jresults[name].accepted == \
            fleet.tier_swarm_configs(port.fleet.profile, SWARM_CLIENTS, seed=5)[name].num_clients
        assert _counter(preg, "nanofed_fleet_updates_total", tier=name, result="accepted") \
            == res.accepted
    assert sorted(m.client_id for m in metas) == sorted(m.client_id for m in jmetas)
    assert {m.metrics["tier"] for m in metas} == {"phone", "edge", "silo"}
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=0, atol=DRAIN_TOL)

    async def publish_next(server, params):
        await server.publish_model(params=params, round_number=1)
        return server.fleet.stats()

    stats = asyncio.run(publish_next(port, unravel(flat, pp)))
    assert stats["round"] == 1 and set(stats["tiers"]) == {"phone", "edge", "silo"}


@pytest.fixture(scope="module")
def convergence():
    jp = _jax_base()
    kw = dict(num_clients=8, num_rounds=3, local_steps=8)
    return (evidence.run_fleet_convergence(fleet.reference_fleet(), device="cpu",
                                           base_params=from_numpy_params(jp, device="cpu"),
                                           **kw),
            jax_evidence.run_fleet_convergence(jfleet.reference_fleet(), **kw))


def test_fleet_convergence_matches_jax(convergence):
    got, want = convergence
    assert got.keys() == want.keys()
    assert got["parity_max_abs_diff"] <= 1e-6
    drop = ("wire_bytes", "bytes_per_submit")
    assert {t: {k: v for k, v in r.items() if k not in drop} for t, r in got["tiers"].items()} \
        == {t: {k: v for k, v in r.items() if k not in drop} for t, r in want["tiers"].items()}
    assert max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) <= TRAJECTORY_TOL
    assert got["loss_descending"] and want["loss_descending"]
    assert got["tiers"]["silo"]["bytes_per_submit"] > got["tiers"]["phone"]["bytes_per_submit"]


def test_generate_fleet_evidence_writes_the_jax_record(tmp_path, convergence):
    art = evidence.generate_fleet_evidence(out_dir=tmp_path, tag="t", num_clients=8,
                                           num_rounds=2, swarm_clients=12, device="cpu")
    assert set(art) == {"record_type", "tag", "created", "env", "profile", "mixed",
                        "homogeneous_baseline", "comparison", "swarm", "reached",
                        "conclusion", "artifact_path"}
    assert art["mixed"].keys() == convergence[1].keys()
    assert art["swarm"]["failed_total"] == 0 and art["record_type"] == "fleet"
    assert (tmp_path / art["artifact_path"].split("/")[-1]).exists()
    digest = summarize_telemetry(tmp_path / "fleet_t_telemetry" / "telemetry.jsonl")
    assert digest["fleets"]["phone_edge_silo"]["tiers"] == 3


def test_fedbuff_staleness_replay_equals_jax(tmp_path):
    jp = _jax_base(7)
    kw = dict(num_clients=8, buffer_k=4, num_aggregations=3)
    got = evidence._fedbuff_sim(0.5, device="cpu",
                                base_params=from_numpy_params(jp, device="cpu"), **kw)
    want = jax_evidence._fedbuff_sim(0.5, **kw)
    assert got.keys() == want.keys()
    for key in ("aggregations", "mean_staleness", "max_staleness", "skipped_out_of_window",
                "diverged"):
        assert got[key] == want[key], key
    assert max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) <= TRAJECTORY_TOL
    art = evidence.generate_fedbuff_staleness_ablation(out_dir=tmp_path, tag="t",
                                                       alphas=(0.0, 1.0), device="cpu", **kw)
    assert set(art) >= {"record_type", "sweep", "best_alpha", "final_loss_spread", "reached",
                        "conclusion", "artifact_path"} and art["reached"]


def test_fedbuff_adapter_artifact_has_the_jax_fields(tmp_path):
    kw = dict(rank=4, clients=16, submits_per_client=1, async_buffer_k=4, aggregations=2)
    got = adapter_evidence.generate_fedbuff_adapter_artifact(out_dir=tmp_path / "p", tag="t",
                                                             device="cpu", **kw)
    want = jax_adapter_evidence.generate_fedbuff_adapter_artifact(out_dir=tmp_path / "j",
                                                                  tag="t", **kw)
    assert got.keys() == want.keys()
    assert got["fedbuff"].keys() == want["fedbuff"].keys()
    assert got["workload"] == want["workload"]
    assert got["delay_distribution"] == want["delay_distribution"]
    for key in ("failed_submits", "aggregations_target", "aggregations_completed"):
        assert got["fedbuff"][key] == want["fedbuff"][key], key
    assert {k: v for k, v in got["fedbuff"]["adapter"].items() if "bytes" not in k
            and k != "payload_reduction"} == \
        {k: v for k, v in want["fedbuff"]["adapter"].items() if "bytes" not in k
         and k != "payload_reduction"}
    assert got["reached"] == want["reached"]
