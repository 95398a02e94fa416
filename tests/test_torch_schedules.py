"""The port's lr schedules against the JAX package's, on the CPU: the client-side
round scales (``trainer.schedules``) exactly, the server-side schedules of the four
strategies against optax's with an optax schedule over 5 rounds, and the
Coordinator's schedule settings, validation and reported ``lr_scale``.

Tolerances: the round scales are the same float64 arithmetic, so exact.  A server
update is one float32 product per coordinate in both packages, with the schedule
read at the same int32 count; Adam and Yogi add a square root and a division in
float32 and optax's bias correction in float32 against the port's in float64:
rtol 1e-6, atol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.persistence import save_state_pickle as jax_save_state_pickle
from nanofed_tpu.trainer import schedules as jax_schedules
from nanofed_tpu_torch.aggregation import base
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.persistence import load_state_pickle
from nanofed_tpu_torch.trainer import TrainingConfig, schedules
from nanofed_tpu_torch.utils.trees import from_numpy_server_state

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", schedules.SCHEDULES)
@pytest.mark.parametrize("total", [1, 2, 7, 40])
def test_round_scales_equal_jax(schedule, total):
    for min_factor in (0.0, 0.2, 1.0):
        for decay_every, gamma in ((1, 0.5), (3, 0.9), (10, 1.0)):
            kw = dict(min_factor=min_factor, decay_every=decay_every, gamma=gamma)
            rounds = range(total + 3)  # past the horizon the terminal value holds
            assert [schedules.lr_schedule_scale(schedule, r, total, **kw) for r in rounds] \
                == [jax_schedules.lr_schedule_scale(schedule, r, total, **kw) for r in rounds]
            assert schedules.lr_schedule_scales(schedule, 1, total, total, **kw) \
                == jax_schedules.lr_schedule_scales(schedule, 1, total, total, **kw)


@pytest.mark.parametrize("args", [
    ("warmup", 0, 4, {}), ("cosine", 0, 4, {"min_factor": 1.5}),
    ("step", 0, 4, {"decay_every": 0}), ("step", 0, 4, {"gamma": 0.0}),
])
def test_round_scales_refuse_what_jax_refuses(args):
    schedule, r, total, kw = args
    with pytest.raises(ValueError):
        jax_schedules.lr_schedule_scale(schedule, r, total, **kw)
    with pytest.raises(ValueError):
        schedules.lr_schedule_scale(schedule, r, total, **kw)


JAX_SCHEDULES = {
    "cosine": optax.cosine_decay_schedule(1.0, decay_steps=4, alpha=0.1),
    "linear": optax.linear_schedule(1.0, 0.2, transition_steps=5),
}
# The same schedules in torch ops on the port's 0-d count (its schedule contract: no
# read of the count on the host).
PORT_SCHEDULES = {
    "cosine": lambda c: 0.9 * (0.5 * (1 + torch.cos(torch.pi * torch.clamp(c, max=4).float()
                                                    / 4))) + 0.1,
    "linear": lambda c: 0.8 * (1 - torch.clamp(c, 0, 5).float() / 5) + 0.2,
}
STRATEGIES = {
    "fedavg": (lambda lr: jax_base.Strategy("fedavg", optax.sgd(lr)),
               lambda lr: base.Strategy("fedavg", base.ServerSGD(lr))),
    "fedavgm": (lambda lr: jax_base.fedavgm_strategy(lr, 0.9),
                lambda lr: base.fedavgm_strategy(lr, 0.9)),
    "fedadam": (jax_base.fedadam_strategy, base.fedadam_strategy),
    "fedyogi": (jax_base.fedyogi_strategy, base.fedyogi_strategy),
}


@pytest.mark.parametrize("schedule", list(JAX_SCHEDULES))
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_server_schedule_equals_optax_over_five_rounds(tmp_path, name, schedule):
    """Each round's server update and state under an optax schedule, against the
    port's strategy with the same schedule in torch ops on the 0-d count: the schedule
    is read at optax's count, which the state carries (``ScaleByScheduleState``).  The JAX
    state reaches the port as a checkpoint would, through a pickle."""

    def as_port(state):
        jax_save_state_pickle(tmp_path / "state.pkl", state)
        return from_numpy_server_state(load_state_pickle(tmp_path / "state.pkl"),
                                       port_strategy, like)

    sched = JAX_SCHEDULES[schedule]
    jax_make, port_make = STRATEGIES[name]
    scale = 0.05 if name in ("fedadam", "fedyogi") else 1.0
    jax_tx = jax_make(lambda c: scale * sched(c)).server_tx
    port_strategy = port_make(lambda c: scale * PORT_SCHEDULES[schedule](c))
    rng = np.random.default_rng(0)
    params = {"a": {"w": np.zeros((3, 4), np.float32)}, "b": np.zeros(5, np.float32)}
    like = {"a/w": torch.zeros(3, 4), "b": torch.zeros(5)}
    j_state = jax_tx.init(params)
    p_state = port_strategy.server_tx.init(torch.zeros(17))
    assert set(p_state) == set(as_port(j_state))
    for _ in range(5):
        grad = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
                "b": rng.normal(size=5).astype(np.float32)}
        j_upd, j_state = jax_tx.update(jax.tree.map(jnp.asarray, grad), j_state)
        flat = torch.from_numpy(np.concatenate([grad["a"]["w"].ravel(), grad["b"]]))
        p_upd, p_state = port_strategy.server_tx.update(flat, p_state)
        want = np.concatenate([np.asarray(j_upd["a"]["w"]).ravel(), np.asarray(j_upd["b"])])
        np.testing.assert_allclose(p_upd.numpy(), want, **TOL)
        restored = as_port(j_state)
        assert restored["schedule_count"] == p_state["schedule_count"]
        for key, value in p_state.items():
            if torch.is_tensor(value):
                np.testing.assert_allclose(value.numpy(), restored[key].numpy(), **TOL)
            else:
                assert value == restored[key]


@pytest.mark.parametrize("field,value", [
    ("lr_schedule", "warmup"), ("lr_min_factor", -0.1), ("lr_min_factor", 1.5),
    ("lr_decay_every", 0), ("lr_decay_gamma", 0.0), ("lr_decay_gamma", 1.5),
])
def test_coordinator_config_refuses_what_jax_refuses(field, value):
    with pytest.raises(ValueError):
        JaxCoordinatorConfig(**{field: value})
    with pytest.raises(ValueError):
        CoordinatorConfig(**{field: value})


@pytest.mark.parametrize("schedule", ["constant", "cosine", "step"])
def test_coordinator_reports_the_rounds_scales(tmp_path, schedule):
    cfg = CoordinatorConfig(num_rounds=3, seed=0, base_dir=tmp_path, save_metrics=False,
                            lr_schedule=schedule, lr_min_factor=0.2, lr_decay_every=1)
    coord = Coordinator(
        model=get_model("mlp", in_features=8, hidden=16, num_classes=3),
        train_data=federate(synthetic_classification(64, 3, (8,), seed=0), 4,
                            batch_size=16),
        config=cfg, training=TrainingConfig(batch_size=16, local_epochs=1), device="cpu")
    scales = [m.agg_metrics.get("lr_scale") for m in coord.run()]
    if schedule == "constant":
        assert scales == [None] * 3
    else:
        want = [round(jax_schedules.lr_schedule_scale(
            schedule, r, 3, min_factor=0.2, decay_every=1), 6) for r in range(3)]
        assert scales == want and scales[-1] < 1.0


def test_scaled_round_equals_a_round_at_the_scaled_learning_rate():
    """``lr_scale`` multiplies each local step: plain SGD at lr x scale gives the same
    round (rtol 1e-6: the same products in another association)."""
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.trainer import draw_permutations

    model = get_model("mlp", in_features=8, hidden=16, num_classes=3)
    data = federate(synthetic_classification(64, 3, (8,), seed=0), 4,
                    batch_size=16).to(torch.device("cpu"))
    params = model.init(torch.Generator().manual_seed(0))
    weights = data.mask.sum(1)
    perms = draw_permutations(torch.Generator().manual_seed(1), 4, 1, data.y.shape[1])
    training = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.1)
    strategy = base.fedavg_strategy()
    scaled = build_round_step(model, training, strategy)(
        params, init_server_state(strategy, params), data, weights, perms, lr_scale=0.3)
    slower = build_round_step(model, dataclasses.replace(training, learning_rate=0.1 * 0.3),
                              strategy)(params, init_server_state(strategy, params), data,
                                        weights, perms)
    for name in params:
        torch.testing.assert_close(scaled.params[name], slower.params[name], **TOL)
