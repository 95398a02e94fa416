"""Resumable runs of the port on the CPU: the cases of
``tests/integration/test_checkpoint_resume.py`` on the port's ``Coordinator`` (an
``mlp`` of 8 clients), and resumes across the packages: a port checkpoint resuming a
JAX ``Coordinator``, JAX checkpoints resuming the port's ``Coordinator`` and
``NetworkCoordinator`` (over a real localhost server), and the checkpoints the port
must refuse.

Tolerances:
- a port run resumed from its own checkpoint runs the same float32 operations from
  the same bits as the uninterrupted run: rtol 1e-6, atol 1e-7 (the JAX test's);
- restored params, server state, counts and accountant events: bit for bit;
- a round of each package's round step from the restored state, with the JAX fit's
  permutations injected: 1e-4, as ``tests/test_torch_round.py``;
- the network round is a float32 weighted mean whose terms arrive in any order: 1e-6.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanofed_tpu import persistence as jp
from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.aggregation import PrivacyAwareAggregationConfig as JaxDPConfig
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.parallel.mesh import make_mesh
from nanofed_tpu.parallel.round_step import build_round_step as jax_build_round_step
from nanofed_tpu.privacy import PrivacyConfig as JaxPrivacyConfig
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu.trainer.schedules import lr_schedule_scale as jax_lr_schedule_scale
from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig
from nanofed_tpu_torch.aggregation import base
from nanofed_tpu_torch.core.exceptions import CheckpointError, NanoFedError
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel import build_round_step
from nanofed_tpu_torch.persistence import (
    FileStateStore,
    ModelManager,
    SimpleRecoveryStrategy,
    run_fault_tolerant,
)
from nanofed_tpu_torch.privacy import PrivacyConfig
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.utils.trees import flatten_with_names, ravel, to_numpy_params

TOL = dict(rtol=1e-6, atol=1e-7)
ROUND_TOL = dict(rtol=1e-4, atol=1e-4)
MLP = dict(in_features=8, hidden=16, num_classes=3)
SERVER_SCHEDULE = optax.cosine_decay_schedule(1.0, decay_steps=4, alpha=0.1)
def port_cosine(c: torch.Tensor) -> torch.Tensor:
    """``SERVER_SCHEDULE`` in torch ops on the 0-d count (the port's schedule contract:
    no read of the count on the host)."""
    t = torch.clamp(c, max=4).float()
    return 0.9 * (0.5 * (1 + torch.cos(torch.pi * t / 4))) + 0.1

# name: (JAX strategy, port strategy) with the same server optimizer.
STRATEGIES = {
    "fedavg": (jax_base.fedavg_strategy, base.fedavg_strategy),
    "fedavgm": (jax_base.fedavgm_strategy, base.fedavgm_strategy),
    "fedadam": (jax_base.fedadam_strategy, base.fedadam_strategy),
    "fedyogi": (jax_base.fedyogi_strategy, base.fedyogi_strategy),
    "fedavgm_cosine": (lambda: jax_base.fedavgm_strategy(SERVER_SCHEDULE),
                       lambda: base.fedavgm_strategy(port_cosine)),
}


@pytest.fixture(scope="module")
def mlp():
    return get_model("mlp", **MLP)


@pytest.fixture(scope="module")
def cd():
    return federate(synthetic_classification(256, 3, (8,), seed=0), num_clients=8,
                    scheme="iid", batch_size=16)


def _coordinator(mlp, cd, path, rounds, strategy=None, **kw):
    cfg = {k: kw.pop(k) for k in list(kw) if k.startswith("lr_")}
    return Coordinator(
        model=mlp, train_data=cd,
        config=CoordinatorConfig(num_rounds=rounds, seed=0, base_dir=path, **cfg),
        training=TrainingConfig(batch_size=16, local_epochs=1),
        strategy=strategy, device="cpu", **kw,
    )


def _close(a, b, **tol):
    assert list(a) == list(b)
    for name in a:
        torch.testing.assert_close(a[name], b[name], **tol)


def test_model_versioned_every_round(mlp, cd, tmp_path):
    mm = ModelManager(tmp_path)
    coord = _coordinator(mlp, cd, tmp_path, rounds=3, model_manager=mm)
    coord.run()
    assert [v.round_number for v in mm.list_versions()] == [0, 1, 2]
    restored, _ = mm.load_model(like=coord.params)  # the live model, bit for bit
    _close(restored, coord.params, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["fedavg", "fedadam", "fedavgm_cosine"])
def test_resume_matches_uninterrupted_run(mlp, cd, tmp_path, name):
    strategy = STRATEGIES[name][1]
    full = _coordinator(mlp, cd, tmp_path / "full", 4, strategy())
    full.run()
    store = FileStateStore(tmp_path / "ckpt")
    _coordinator(mlp, cd, tmp_path / "a", 2, strategy(), state_store=store).run()
    resumed = _coordinator(mlp, cd, tmp_path / "b", 4, strategy(), state_store=store)
    assert resumed.current_round == 2
    assert [m.round_id for m in resumed.run()] == [2, 3]
    _close(resumed.params, full.params, **TOL)
    for key, value in full.server_state.items():
        if torch.is_tensor(value):
            torch.testing.assert_close(resumed.server_state[key], value, **TOL)
        else:
            assert resumed.server_state[key] == value


def test_resume_continues_lr_schedule_exactly(mlp, cd, tmp_path):
    """The schedule is a pure function of the round index: the resumed rounds train at
    the uninterrupted run's decayed scales, not a restarted schedule's."""
    sched = dict(lr_schedule="cosine", lr_min_factor=0.2)
    full = _coordinator(mlp, cd, tmp_path / "full", 4, **sched)
    full_metrics = full.run()
    store = FileStateStore(tmp_path / "ckpt")
    first = _coordinator(mlp, cd, tmp_path / "a", 4, state_store=store, **sched)
    gen = first.start_training()
    next(gen)
    next(gen)
    gen.close()  # the crash: configured for 4 rounds, dead after 2
    resumed = _coordinator(mlp, cd, tmp_path / "b", 4, state_store=store, **sched)
    assert resumed.current_round == 2
    resumed_scales = [m.agg_metrics["lr_scale"] for m in resumed.run()]
    assert resumed_scales == [m.agg_metrics["lr_scale"] for m in full_metrics][2:]
    assert resumed_scales[0] < 1.0
    _close(resumed.params, full.params, **TOL)


def _dp():
    return PrivacyAwareAggregationConfig(
        privacy=PrivacyConfig(max_gradient_norm=1.0, noise_multiplier=1.0))


def test_resume_preserves_privacy_accounting(mlp, cd, tmp_path):
    full = _coordinator(mlp, cd, tmp_path / "full", 4, central_privacy=_dp())
    full.run()
    store = FileStateStore(tmp_path / "ckpt")
    first = _coordinator(mlp, cd, tmp_path / "a", 2, state_store=store, central_privacy=_dp())
    first.run()
    resumed = _coordinator(mlp, cd, tmp_path / "b", 4, state_store=store,
                           central_privacy=_dp())
    assert resumed.current_round == 2
    assert resumed.privacy_accountant.state_dict() == first.privacy_accountant.state_dict()
    resumed.run()
    assert resumed.privacy_spent.epsilon_spent == pytest.approx(full.privacy_spent.epsilon_spent)
    assert resumed.privacy_accountant.state_dict() == full.privacy_accountant.state_dict()


def test_run_fault_tolerant_retries_through_crash(mlp, cd, tmp_path):
    store = FileStateStore(tmp_path / "ckpt")
    crashed = {"done": False}

    def make():
        coord = _coordinator(mlp, cd, tmp_path, 3, state_store=store)
        if not crashed["done"]:
            def boom(metrics):  # a recoverable failure after round 1's checkpoint
                if metrics.round_id == 1:
                    crashed["done"] = True
                    raise ConnectionError("simulated network partition")

            coord.on_round_end = boom
        return coord

    history = run_fault_tolerant(make, SimpleRecoveryStrategy(max_retries=2))
    assert crashed["done"]
    assert [m.round_id for m in history] == [2]
    assert store.restore_latest().round_number == 2


def test_run_fault_tolerant_propagates_unrecoverable(mlp, cd, tmp_path):
    def make():
        coord = _coordinator(mlp, cd, tmp_path, 2)

        def boom(metrics):
            raise ValueError("deterministic bug")

        coord.on_round_end = boom
        return coord

    with pytest.raises(ValueError):
        run_fault_tolerant(make)


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cd():
    return jax_federate(jax_synthetic(256, 3, (8,), seed=0), num_clients=8, scheme="iid",
                        batch_size=16)


def _jax_coordinator(jax_cd, path, rounds, strategy=None, **kw):
    cfg = {k: kw.pop(k) for k in list(kw) if k.startswith("lr_")}
    return JaxCoordinator(
        model=jax_get_model("mlp", **MLP), train_data=jax_cd,
        config=JaxCoordinatorConfig(num_rounds=rounds, seed=0, base_dir=path, **cfg),
        training=JaxTrainingConfig(batch_size=16, local_epochs=1),
        strategy=strategy, **kw,
    )


def _flat_tree(tree):
    return np.concatenate([np.asarray(a).ravel() for a in flatten_with_names(tree).values()])


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_port_checkpoint_resumes_a_jax_coordinator(mlp, cd, jax_cd, tmp_path, name):
    """A port run's checkpoint resumes the JAX Coordinator: its optax state is
    structured as ``server_tx.init(params)`` and holds the port's values, and the JAX
    run goes on from it."""
    jax_strategy, port_strategy = STRATEGIES[name]
    store = tmp_path / "ckpt"
    port = _coordinator(mlp, cd, tmp_path / "port", 2, port_strategy(),
                        state_store=FileStateStore(store))
    port.run()
    jc = _jax_coordinator(jax_cd, tmp_path / "jax", 3, jax_strategy(),
                          state_store=jp.FileStateStore(store))
    assert jc.current_round == 2
    init = jc.strategy.server_tx.init(jc.params)
    assert jax.tree.structure(jc.server_state) == jax.tree.structure(init)
    np.testing.assert_array_equal(_flat_tree(jax.device_get(jc.params)), ravel(port.params))
    transform, schedule = jax.device_get(jc.server_state)
    for field in ("trace", "mu", "nu"):
        if field in transform._fields:
            np.testing.assert_array_equal(_flat_tree(getattr(transform, field)),
                                          port.server_state[field])
    if "count" in schedule._fields:
        assert int(schedule.count) == port.server_state["schedule_count"] == 2
    (last,) = jc.run()
    assert last.round_id == 2 and np.isfinite(last.agg_metrics["loss"])


def _jax_permutations(rngs, epochs, n):
    """The permutations the JAX local fit draws from each client's key."""
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def test_jax_checkpoint_resumes_a_port_coordinator(mlp, cd, jax_cd, tmp_path):
    """A 2-round JAX run (FedAvgM under a server schedule, a cosine client schedule)
    resumes the port's Coordinator exactly where the JAX package resumes itself; the
    next round, through both round steps from the restored state, agrees."""
    sched = dict(lr_schedule="cosine", lr_min_factor=0.2)
    jax_strategy, port_strategy = STRATEGIES["fedavgm_cosine"]
    store = tmp_path / "ckpt"
    first = _jax_coordinator(jax_cd, tmp_path / "a", 4, jax_strategy(),
                             state_store=jp.FileStateStore(store), **sched)
    gen = first.start_training()
    next(gen)
    next(gen)
    gen.close()
    jc = _jax_coordinator(jax_cd, tmp_path / "jb", 4, jax_strategy(),
                          state_store=jp.FileStateStore(store), **sched)
    tc = _coordinator(mlp, cd, tmp_path / "tb", 4, port_strategy(),
                      state_store=FileStateStore(store), **sched)
    assert tc.current_round == jc.current_round == 2
    np.testing.assert_array_equal(ravel(tc.params), _flat_tree(jax.device_get(jc.params)))
    transform, schedule = jax.device_get(jc.server_state)
    np.testing.assert_array_equal(tc.server_state["trace"], _flat_tree(transform.trace))
    assert tc.server_state["schedule_count"] == int(schedule.count) == 2
    lr_scale = jax_lr_schedule_scale("cosine", 2, 4, min_factor=0.2)
    assert lr_scale == pytest.approx(0.6)

    hyper = dict(batch_size=16, local_epochs=1)
    x, y, mask = (np.asarray(a) for a in jax_cd)
    rngs = stack_rngs(jax.random.key(5), x.shape[0])
    m = jax_get_model("mlp", **MLP)
    jax_step = jax_build_round_step(lambda p, x_, train=False, rng=None: m.apply(p, x_),
                                    JaxTrainingConfig(**hyper), make_mesh(jax.devices()[:1]),
                                    jc.strategy)
    on_one = lambda tree: jax.tree.map(jnp.asarray, jax.device_get(tree))  # noqa: E731
    want = jax_step(on_one(jc.params), on_one(jc.server_state),
                    JaxClientData(*(jnp.asarray(a) for a in (x, y, mask))),
                    jnp.asarray(mask.sum(1)), rngs, lr_scale)
    port_step = build_round_step(mlp, TrainingConfig(**hyper), tc.strategy)
    got = port_step(tc.params, tc.server_state, ClientData(x, y, mask).to(torch.device("cpu")),
                    torch.from_numpy(mask.sum(1)), _jax_permutations(rngs, 1, x.shape[1]),
                    lr_scale=lr_scale)
    np.testing.assert_allclose(ravel(got.params), _flat_tree(jax.device_get(want.params)),
                               **ROUND_TOL)
    transform, schedule = jax.device_get(want.server_opt_state)
    np.testing.assert_allclose(got.server_opt_state["trace"], _flat_tree(transform.trace),
                               **ROUND_TOL)
    assert got.server_opt_state["schedule_count"] == int(schedule.count) == 3
    # Both resumed coordinators go on at the uninterrupted schedule's rounds 2-3.
    scales = [m.agg_metrics["lr_scale"] for m in tc.run()]
    assert scales == [m.agg_metrics["lr_scale"] for m in jc.run()]
    assert scales[0] == round(lr_scale, 6)


def test_jax_dp_checkpoint_restores_the_port_accountant(mlp, cd, jax_cd, tmp_path):
    dp = JaxDPConfig(privacy=JaxPrivacyConfig(max_gradient_norm=1.0, noise_multiplier=1.0))
    store = tmp_path / "ckpt"
    _jax_coordinator(jax_cd, tmp_path / "a", 2, central_privacy=dp,
                     state_store=jp.FileStateStore(store)).run()
    jc = _jax_coordinator(jax_cd, tmp_path / "jb", 4, central_privacy=dp,
                          state_store=jp.FileStateStore(store))
    tc = _coordinator(mlp, cd, tmp_path / "tb", 4, central_privacy=_dp(),
                      state_store=FileStateStore(store))
    assert tc.current_round == jc.current_round == 2
    assert tc.privacy_accountant.state_dict() == jc.privacy_accountant.state_dict()
    assert tc.privacy_spent.epsilon_spent == jc.privacy_spent.epsilon_spent > 0


def test_refused_checkpoints(mlp, cd, jax_cd, tmp_path):
    """A SCAFFOLD checkpoint is refused by a coordinator built with scaffold=False
    (the JAX package's message); a checkpoint of another model (an adapter tree) or of
    another server optimizer fails its check."""
    params = jax.device_get(_jax_coordinator(jax_cd, tmp_path / "j", 1).params)
    opt = jax.device_get(optax.sgd(1.0).init(params))
    stack = jax.tree.map(lambda a: np.stack([a] * 8), params)
    cases = {
        "scaffold": (params, {"opt": opt, "scaffold_c_global": params,
                              "scaffold_c_stack": stack}, NanoFedError, "scaffold=True"),
        "adapter": ({"lora": {"a": np.zeros((8, 2), np.float32)}}, opt, CheckpointError,
                    "params"),
        "momentum": (params, jax.device_get(optax.sgd(1.0, momentum=0.9).init(params)),
                     CheckpointError, "strategy"),
    }
    for name, (ckpt_params, server_state, error, match) in cases.items():
        jp.FileStateStore(tmp_path / name).checkpoint(0, ckpt_params, server_state)
        with pytest.raises(error, match=match):
            _coordinator(mlp, cd, tmp_path / f"t_{name}", 2,
                         state_store=FileStateStore(tmp_path / name))


# ----------------------------------------------------------------------
# The network coordinator
# ----------------------------------------------------------------------

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")

import nanofed_tpu.communication as jax_comm  # noqa: E402
import nanofed_tpu_torch.communication as port_comm  # noqa: E402
from nanofed_tpu_torch.communication.transport import free_port  # noqa: E402
from nanofed_tpu_torch.utils.trees import from_numpy_params  # noqa: E402

NET_SAMPLES = {"c0": 30.0, "c1": 10.0, "c2": 20.0}


def _nested(seed, scale=1.0):
    model = jax_get_model("linear", in_features=6, num_classes=3)
    return jax.tree.map(lambda a: np.asarray(a) * np.float32(scale),
                        model.init(jax.random.key(seed)))


NET_INIT = _nested(0)
NET_DELTAS = {cid: from_numpy_params(_nested(10 + i, 0.1), device="cpu")
              for i, cid in enumerate(NET_SAMPLES)}


async def _port_client(url, cid, fetched):
    """Each round: fetch, submit the fetched model plus this client's fixed delta."""
    template = from_numpy_params(NET_INIT, device="cpu")
    async with port_comm.HTTPClient(url, cid, timeout_s=30) as client:
        while True:
            for _ in range(400):
                try:
                    params, rnd, active = await client.fetch_global_model(like=template)
                    break
                except NanoFedError:  # published concurrently with start-up
                    await asyncio.sleep(0.02)
            if not active:
                return
            fetched.setdefault(rnd, params)
            update = {k: v + NET_DELTAS[cid][k] for k, v in params.items()}
            assert await client.submit_update(update, {"num_samples": NET_SAMPLES[cid]})
            while True:
                status = await client.check_server_status()
                if not status["training_active"] or status["round"] != rnd:
                    break
                await asyncio.sleep(0.02)


def _network_run(pkg, rounds, store, evicted=()):
    """``rounds`` plain rounds of 3 port clients against ``pkg``'s server and
    coordinator with a state store, 4 expected clients and straggler eviction after
    one missed round.  ``evicted`` seeds the coordinator's evicted set (c3 was seen
    once and left); without the restored set a resumed round would wait for 4 clients
    and fail.  Returns (coordinator, the params fetched each round)."""
    fetched = {}
    round_cfg = dict(num_rounds=rounds, min_clients=4, straggler_evict_after=1,
                     round_timeout_s=20.0, poll_interval_s=0.02)

    async def main():
        port = free_port()
        comm = jax_comm if pkg == "jax" else port_comm
        server = comm.HTTPServer(port=port)
        await server.start()
        try:
            if pkg == "jax":
                coordinator = comm.NetworkCoordinator(
                    server, jax.tree.map(jnp.asarray, NET_INIT),
                    comm.NetworkRoundConfig(**round_cfg), state_store=jp.FileStateStore(store))
            else:
                coordinator = comm.NetworkCoordinator(
                    server, from_numpy_params(NET_INIT, device="cpu"),
                    comm.NetworkRoundConfig(**round_cfg), device="cpu",
                    state_store=FileStateStore(store))
            if evicted:  # what the engine holds once c3, seen before, was evicted
                coordinator._evicted_stragglers = set(evicted)
                coordinator._known_clients = set(evicted)
            url = f"http://127.0.0.1:{port}"
            clients = [_port_client(url, cid, fetched) for cid in NET_SAMPLES]
            await asyncio.wait_for(asyncio.gather(coordinator.run(), *clients), 120)
            return coordinator
        finally:
            await server.stop()

    return asyncio.run(main()), fetched


def _net_fedavg(start, rounds):
    w = np.asarray(list(NET_SAMPLES.values()), np.float64)
    deltas = [ravel(NET_DELTAS[c]).double().numpy() for c in NET_SAMPLES]
    flat = np.asarray(start, np.float64)
    for _ in range(rounds):
        flat = flat + sum(wi * d for wi, d in zip(w, deltas)) / w.sum()
    return flat


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_network_coordinator_resumes_from_a_checkpoint(tmp_path, writer):
    """Two rounds of ``writer``'s network coordinator with a store (c3 evicted), then
    the port's, configured for 3 rounds, resumes: it starts at round 2 with c3 still
    evicted, publishes the checkpointed params bit for bit, and its round 2 is the
    weighted FedAvg of what it published."""
    store = tmp_path / "ckpt"
    first, _ = _network_run(writer, 2, store, evicted=["c3"])
    assert [h["status"] for h in first.history] == ["COMPLETED"] * 2
    written = FileStateStore(store).restore_latest()
    assert written.round_number == 1
    assert [str(c) for c in written.server_state["evicted_stragglers"]] == ["c3"]
    checkpointed = from_numpy_params(written.params, device="cpu")
    resumed, fetched = _network_run("port", 3, store)
    assert resumed.start_round == 2
    assert resumed._evicted_stragglers == {"c3"}
    assert [h["round"] for h in resumed.history] == [2]
    assert list(fetched) == [2]
    _close(fetched[2], checkpointed, rtol=0, atol=0)
    first_flat = (ravel(first.params) if writer == "port"
                  else _flat_tree(jax.device_get(first.params)))
    np.testing.assert_array_equal(ravel(checkpointed), first_flat)
    np.testing.assert_allclose(ravel(resumed.params).numpy(), _net_fedavg(first_flat, 1),
                               rtol=0, atol=1e-6)
    assert FileStateStore(store).restore_latest().round_number == 2
