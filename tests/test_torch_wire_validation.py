"""Validation and robust aggregation over the wire: the port's host verdicts and its
``NetworkCoordinator(validation=, robust=)`` against the JAX package's, on the CPU.

The host verdicts use float64 numpy norms in both packages, so they are compared
exactly.  The rounds run over real aiohttp servers on free localhost ports, each
client submitting the fetched global plus its own fixed delta (NaN, over-norm,
anomalous and Byzantine clients among them); the aggregates are float32 means and
order statistics summed in each package's order, held at 1e-6 as
``tests/test_torch_network.py`` holds the plain round, and ``num_rejected`` exactly.
The refused combinations raise the JAX package's messages, word for word.
"""

import pytest

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import nanofed_tpu.communication as jax_comm
import nanofed_tpu_torch.communication as port_comm
from nanofed_tpu.aggregation.robust import RobustAggregationConfig as JaxRobust
from nanofed_tpu.core.types import ModelUpdate as JaxModelUpdate
from nanofed_tpu.ingest import IngestConfig as JaxIngestConfig
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.security import validation as jax_validation
from nanofed_tpu.utils.trees import tree_ravel
from nanofed_tpu_torch.aggregation.robust import RobustAggregationConfig
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.core.types import ModelUpdate
from nanofed_tpu_torch.ingest import IngestConfig
from nanofed_tpu_torch.security import validation
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel

TOL = 1e-6
INIT = jax.tree.map(np.asarray, jax_get_model("linear", in_features=6, num_classes=3)
                    .init(jax.random.key(0)))


def _delta(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        INIT)


HONEST = {f"h{i}": _delta(10 + i) for i in range(5)}


def _poison(kind):
    """The submitted params of a bad client, from the fetched global ``g``."""
    return {
        "nan": lambda g: jax.tree.map(lambda a: np.full_like(a, np.nan), g),
        "inf": lambda g: jax.tree.map(lambda a: a + np.float32(np.inf), g),
        "huge": lambda g: jax.tree.map(lambda a: a * np.float32(50.0), g),
        "scaled": lambda g: jax.tree.map(lambda a: a * np.float32(3.0), g),
        "byzantine": lambda g: jax.tree.map(lambda a: a - np.float32(8.0), g),
    }[kind]


# ---------------------------------------------------------------------------
# Host verdicts
# ---------------------------------------------------------------------------


def _updates(trees):
    port = [ModelUpdate(cid, 0, from_numpy_params(t, device="cpu"), {}, "t")
            for cid, t in trees.items()]
    ref = [JaxModelUpdate(cid, 0, t, {}, "t") for cid, t in trees.items()]
    return port, ref


def test_host_verdicts_equal_the_jax_packages():
    g = jax.tree.map(lambda a: a + np.float32(0.5), INIT)
    trees = {cid: jax.tree.map(np.add, g, d) for cid, d in HONEST.items()}
    for kind in ("nan", "inf", "huge", "scaled"):
        trees[kind] = _poison(kind)(g)
    port, ref = _updates(trees)
    port.append(ModelUpdate("shape", 0, {k: torch.zeros(2, 2) for k in port[0].params}, {}, "t"))
    ref.append(JaxModelUpdate("shape", 0, jax.tree.map(lambda a: np.zeros((2, 2)), INIT),
                              {}, "t"))
    cfg = validation.ValidationConfig(max_norm=20.0)
    jcfg = jax_validation.ValidationConfig(max_norm=20.0)
    shapes, jshapes = validation.reference_shapes(from_numpy_params(INIT, device="cpu")), \
        jax_validation.reference_shapes(INIT)
    assert shapes == jshapes
    got = [(validation.validate_shape(u, shapes).name, validation.validate_range(u, cfg).name
            if validation.validate_shape(u, shapes).name == "VALID" else "-") for u in port]
    want = [(jax_validation.validate_shape(u, jshapes).name,
             jax_validation.validate_range(u, jcfg).name
             if jax_validation.validate_shape(u, jshapes).name == "VALID" else "-")
            for u in ref]
    assert got == want
    assert [v for _, v in got] == ["VALID"] * 5 + ["INVALID_RANGE"] * 3 + ["VALID", "-"]
    assert got[-1][0] == "INVALID_SHAPE"
    norms = [validation.update_flat_norm(u) for u in port[:5]]
    assert norms == [jax_validation.update_flat_norm(u) for u in ref[:5]]
    cohort = port[:5] + [port[8]]
    jcohort = ref[:5] + [ref[8]]
    assert ([validation.validate_statistics(u, cohort, cfg).name for u in cohort]
            == [jax_validation.validate_statistics(u, jcohort, jcfg).name for u in jcohort])
    # Below min_clients_for_stats every update is VALID.
    assert {validation.validate_statistics(u, cohort[:4], cfg).name for u in cohort} == \
        {"VALID"}


# ---------------------------------------------------------------------------
# Rounds over localhost
# ---------------------------------------------------------------------------

PKGS = {"port": port_comm, "jax": jax_comm}


def _to_pkg(pkg, nested):
    if pkg == "port":
        return from_numpy_params(nested, device="cpu")
    return jax.tree.map(jnp.asarray, nested)


def _to_nested(pkg, params):
    if pkg == "port":
        from nanofed_tpu_torch.utils.trees import to_numpy_params

        return to_numpy_params(params)
    return jax.tree.map(np.asarray, params)


async def _client(pkg, url, cid, make):
    comm = PKGS[pkg]
    template = _to_pkg(pkg, INIT)
    async with comm.HTTPClient(url, cid, timeout_s=30) as client:
        while True:
            for _ in range(400):
                try:
                    params, rnd, active = await client.fetch_global_model(like=template)
                    break
                except Exception:
                    await asyncio.sleep(0.02)
            if not active:
                return
            submitted = make(_to_nested(pkg, params))
            metrics = {"num_samples": 10.0 + len(cid), "loss": 1.0 + len(cid),
                       "accuracy": 0.5}
            await client.submit_update(_to_pkg(pkg, submitted), metrics)
            while True:
                status = await client.check_server_status()
                if not status["training_active"] or status["round"] != rnd:
                    break
                await asyncio.sleep(0.02)


def _run(pkg, clients, rounds=2, min_completion_rate=1.0, **coordinator_kwargs):
    """``rounds`` rounds of ``pkg``'s server and coordinator with one client of the
    same package per entry of ``clients``.  The coordinator sees the buffer only once
    every client has submitted (its barrier may be lower: rejections), so what it
    drains does not depend on arrival times."""
    comm = PKGS[pkg]
    extra = {"device": "cpu"} if pkg == "port" else {}

    async def main():
        port = free_port()
        server = comm.HTTPServer(port=port)
        server.num_updates = lambda: (len(server._updates)
                                      if len(server._updates) >= len(clients) else 0)
        await server.start()
        try:
            coordinator = comm.NetworkCoordinator(
                server, _to_pkg(pkg, INIT),
                comm.NetworkRoundConfig(num_rounds=rounds, min_clients=len(clients),
                                        min_completion_rate=min_completion_rate,
                                        round_timeout_s=20.0, poll_interval_s=0.02),
                **coordinator_kwargs, **extra)
            url = f"http://127.0.0.1:{port}"
            await asyncio.wait_for(asyncio.gather(
                coordinator.run(), *[_client(pkg, url, cid, make)
                                     for cid, make in clients.items()]), 120)
            return coordinator
        finally:
            await server.stop()

    coordinator = asyncio.run(main())
    flat = (ravel(coordinator.params).numpy() if pkg == "port"
            else np.asarray(tree_ravel(coordinator.params)[0]))
    return flat, coordinator.history


def _honest(cid):
    return lambda g: jax.tree.map(np.add, g, HONEST[cid])


VALIDATED = {**{cid: _honest(cid) for cid in HONEST},
             "x_nan": _poison("nan"), "x_huge": _poison("huge"), "x_scaled": _poison("scaled")}


def test_validated_round_matches_jax():
    ours, ohist = _run("port", VALIDATED, min_completion_rate=0.6,
                       validation=validation.ValidationConfig(max_norm=20.0))
    theirs, thist = _run("jax", VALIDATED, min_completion_rate=0.6,
                         validation=jax_validation.ValidationConfig(max_norm=20.0))
    assert [h["num_rejected"] for h in ohist] == [h["num_rejected"] for h in thist] == [3, 3]
    assert [h["num_clients"] for h in ohist] == [h["num_clients"] for h in thist] == [5, 5]
    assert ohist[0]["rejected"] == {"x_nan": "INVALID_RANGE", "x_huge": "INVALID_RANGE",
                                    "x_scaled": "ANOMALOUS"}
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)
    for a, b in zip(ohist, thist):
        assert a["metrics"]["loss"] == pytest.approx(b["metrics"]["loss"], abs=1e-6)
    assert np.isfinite(ours).all()


ROBUST = {"trimmed_mean": dict(trim_k=1), "median": dict(method="median"),
          "multi_krum": dict(method="multi_krum", trim_k=1)}


@functools.lru_cache(maxsize=None)
def _robust(pkg, method):
    cfg = (RobustAggregationConfig if pkg == "port" else JaxRobust)(**ROBUST[method])
    clients = {cid: _honest(cid) for cid in list(HONEST)[:4]}
    clients["x_byzantine"] = _poison("byzantine")
    return _run(pkg, clients, robust=cfg)


@pytest.mark.parametrize("method", list(ROBUST))
def test_robust_round_matches_jax(method):
    ours, ohist = _robust("port", method)
    theirs, thist = _robust("jax", method)
    assert [h["status"] for h in ohist] == [h["status"] for h in thist] == ["COMPLETED"] * 2
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)
    for a, b in zip(ohist, thist):
        assert a["num_rejected"] == b["num_rejected"] == 0
        assert a["metrics"]["loss"] == pytest.approx(b["metrics"]["loss"], abs=1e-6)
        assert a["metrics"]["accuracy"] == pytest.approx(b["metrics"]["accuracy"], abs=1e-6)
    # The Byzantine client moved the aggregate by far less than its own shift.
    honest_mean = np.mean([np.asarray(tree_ravel(HONEST[c])[0]) for c in list(HONEST)[:4]],
                          axis=0)
    start = np.asarray(tree_ravel(INIT)[0])
    assert np.abs(ours - start).max() < 4 * np.abs(honest_mean).max() + 1.0


def test_robust_round_below_its_floor_fails_like_jax():
    clients = {cid: _honest(cid) for cid in list(HONEST)[:4]}
    ours, ohist = _run("port", clients, rounds=1,
                       robust=RobustAggregationConfig(method="multi_krum", trim_k=1))
    theirs, thist = _run("jax", clients, rounds=1,
                         robust=JaxRobust(method="multi_krum", trim_k=1))
    assert ohist[0]["status"] == thist[0]["status"] == "FAILED"
    assert ohist[0]["reason"] == thist[0]["reason"]
    np.testing.assert_array_equal(ours, np.asarray(tree_ravel(INIT)[0]))


def _refusal(pkg, build):
    with pytest.raises(ValueError) as info:
        build(PKGS[pkg], pkg)
    return str(info.value)


def _coord(server_kwargs, round_kwargs=None, **kwargs):
    def build(comm, pkg):
        server_kwargs_pkg = dict(server_kwargs)
        if "ingest" in server_kwargs_pkg:
            server_kwargs_pkg["ingest"] = (IngestConfig() if pkg == "port"
                                           else JaxIngestConfig())
            if pkg == "port":
                server_kwargs_pkg["device"] = "cpu"
        server = comm.HTTPServer(port=free_port(), **server_kwargs_pkg)
        extra = {"device": "cpu"} if pkg == "port" else {}
        resolved = {k: (v(pkg) if callable(v) else v) for k, v in kwargs.items()}
        return comm.NetworkCoordinator(server, _to_pkg(pkg, INIT),
                                       comm.NetworkRoundConfig(**(round_kwargs or {})),
                                       **resolved, **extra)
    return build


def _validation_cfg(pkg):
    return (validation if pkg == "port" else jax_validation).ValidationConfig()


def _robust_cfg(pkg):
    return (RobustAggregationConfig if pkg == "port" else JaxRobust)()


def _secure_cfg(pkg):
    if pkg == "port":
        from nanofed_tpu_torch.security.secure_agg import SecureAggregationConfig
    else:
        from nanofed_tpu.security.secure_agg import SecureAggregationConfig
    return SecureAggregationConfig(min_clients=3)


REFUSALS = {
    "robust_with_secure": _coord({}, robust=_robust_cfg, secure=_secure_cfg),
    "ingest_with_validation": _coord({"ingest": True}, validation=_validation_cfg),
    "ingest_with_robust": _coord({"ingest": True}, robust=_robust_cfg),
    "async_with_validation": _coord({}, {"async_buffer_k": 2}, validation=_validation_cfg),
    "async_with_secure_and_robust": _coord({}, {"async_buffer_k": 2}, secure=_secure_cfg,
                                           robust=None),
    "windowed_server_without_async": _coord({"staleness_window": 2}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_combinations_raise_the_reference_messages(case):
    if "secure" in case:
        pytest.importorskip("cryptography")
    ours = _refusal("port", REFUSALS[case])
    assert ours == _refusal("jax", REFUSALS[case])
