"""SCAFFOLD in the port (``trainer.scaffold``, ``parallel.scaffold_step``,
``Coordinator(scaffold=True)``), mirroring ``tests/integration/test_scaffold.py`` and
held against the JAX package on the CPU.

Parity: the fit and the step get the JAX fit's own permutations; the coordinators run
single-batch clients (a batch holds a client's whole data, so the masked mean loss
does not depend on the permutation) and sample the same cohorts from the same numpy
streams.  Checkpoints cross between the packages both ways.

Tolerances (float32): parity 1e-5 relative and absolute (SGD steps and means summed
in another order); the port against itself, the JAX test's 1e-6 / 1e-7 where a path
runs other float operations (FedAvg's update, the gathered cohort), and bit for bit
where it runs the same ones (chunked rounds: the reduces run once over the whole
buffers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu import persistence as jp
from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.parallel.mesh import make_mesh
from nanofed_tpu.parallel.scaffold_step import (
    build_scaffold_round_step as jax_build_scaffold_round_step,
)
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu.trainer.scaffold import make_scaffold_local_fit as jax_make_scaffold_local_fit
from nanofed_tpu_torch import run_experiment
from nanofed_tpu_torch.aggregation import (
    PrivacyAwareAggregationConfig,
    RobustAggregationConfig,
    fedavgm_strategy,
)
from nanofed_tpu_torch.core.exceptions import CheckpointError, NanoFedError
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel import build_scaffold_round_step, init_server_state
from nanofed_tpu_torch.persistence import FileStateStore
from nanofed_tpu_torch.privacy import PrivacyConfig
from nanofed_tpu_torch.security import ValidationConfig
from nanofed_tpu_torch.trainer import (
    TrainingConfig,
    draw_permutations,
    make_grad_fn,
    make_local_fit,
    make_scaffold_local_fit,
    stack_zero_controls,
    zero_controls,
)
from nanofed_tpu_torch.utils.trees import flatten_with_names, from_numpy_params, ravel

MLP = dict(in_features=16, hidden=32, num_classes=4)
PARITY = dict(rtol=1e-5, atol=1e-5)
SELF = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mlp():
    return get_model("mlp", **MLP)


def _data(n=1024, seed=0):
    return synthetic_classification(n, 4, (16,), seed=seed)


def _flat(tree):
    return np.concatenate([np.asarray(a).ravel() for a in flatten_with_names(tree).values()])


def _stack_flat(tree):
    leaves = list(flatten_with_names(tree).values())
    return np.concatenate([np.asarray(a).reshape(a.shape[0], -1) for a in leaves], axis=1)


def _jax_permutations(rngs, epochs, n):
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def _coord(mlp, cd, path, scaffold=True, rounds=1, epochs=2, batch=32, **kw):
    cfg = {k: kw.pop(k) for k in ("participation_rate", "seed") if k in kw}
    cfg.setdefault("seed", 0)
    return Coordinator(
        mlp, cd, CoordinatorConfig(num_rounds=rounds, base_dir=path, save_metrics=False, **cfg),
        TrainingConfig(batch_size=batch, local_epochs=epochs, learning_rate=0.1),
        scaffold=scaffold, device="cpu", **kw)


# ---------------------------------------------------------------------------
# The control-update math
# ---------------------------------------------------------------------------


def test_one_step_control_update_recovers_the_gradient(mlp):
    """K = 1: dc_i = -c + (x - y)/eta = g - c_i, so c_i + dc_i is the gradient at x."""
    cd = federate(_data(n=32), num_clients=1, scheme="iid", batch_size=32)
    data = cd.to(torch.device("cpu"))
    params = mlp.init(torch.Generator().manual_seed(0))
    p = ravel(params).numel()
    fit = make_scaffold_local_fit(mlp, TrainingConfig(batch_size=32, local_epochs=1,
                                                      learning_rate=0.1))
    c_global = torch.full((p,), 0.05)
    c_client = torch.full((1, p), -0.03)
    perms = draw_permutations(torch.Generator().manual_seed(1), 1, 1, 32)
    result = fit(params, data, perms, c_global, c_client)
    grads, _ = make_grad_fn(mlp.apply)(params, data.x[0], data.y[0], data.mask[0], ())
    torch.testing.assert_close(result.delta_c[0], ravel(grads) - c_client[0], rtol=1e-5,
                               atol=1e-6)


def test_all_padding_client_moves_nothing(mlp):
    cd = federate(_data(n=64), num_clients=2, scheme="iid", batch_size=16)
    data = cd.to(torch.device("cpu"))
    data = ClientData(torch.zeros_like(data.x[:1]), torch.zeros_like(data.y[:1]),
                      torch.zeros_like(data.mask[:1]))
    params = mlp.init(torch.Generator().manual_seed(0))
    p = ravel(params).numel()
    fit = make_scaffold_local_fit(mlp, TrainingConfig(batch_size=16, local_epochs=2,
                                                      learning_rate=0.1))
    c = torch.full((p,), 0.05)
    perms = draw_permutations(torch.Generator().manual_seed(1), 1, 2, data.y.shape[1])
    result = fit(params, data, perms, c, c[None])
    for name, leaf in params.items():
        assert torch.equal(result.params[name][0], leaf)
    assert torch.equal(result.delta_c, torch.zeros_like(result.delta_c))


def test_refuses_momentum_weight_decay_and_prox(mlp):
    with pytest.raises(ValueError, match="plain SGD"):
        make_scaffold_local_fit(mlp, TrainingConfig(momentum=0.9))
    with pytest.raises(ValueError, match="plain SGD"):
        make_scaffold_local_fit(mlp, TrainingConfig(weight_decay=1e-4))
    with pytest.raises(ValueError, match="drift remedy"):
        make_scaffold_local_fit(mlp, TrainingConfig(prox_mu=0.1))


# ---------------------------------------------------------------------------
# Round semantics
# ---------------------------------------------------------------------------


def test_zero_controls_first_round_is_fedavg(mlp, tmp_path):
    """Round 1 with zero controls applies no correction and, with equal-sized clients,
    the uniform participant mean is the sample-weighted mean: FedAvg's params."""
    cd = federate(_data(n=256), num_clients=8, scheme="iid", batch_size=32)
    a = _coord(mlp, cd, tmp_path / "a", scaffold=False)
    b = _coord(mlp, cd, tmp_path / "b", scaffold=True)
    a.run()
    b.run()
    torch.testing.assert_close(ravel(b.params), ravel(a.params), **SELF)


def _cohort_pair(mlp, tmp_path, rounds=3):
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=16)
    make = lambda name: _coord(mlp, cd, tmp_path / name, rounds=rounds, epochs=1,  # noqa: E731
                               batch=16, participation_rate=0.25, seed=5)
    gathered, full = make("g"), make("f")
    assert gathered._cohort_mode
    full._cohort_mode = False
    full._step_clients = full.num_clients
    return gathered, full


def test_cohort_scaffold_equals_forced_full_round(mlp, tmp_path):
    gathered, full = _cohort_pair(mlp, tmp_path)
    gathered.run()
    full.run()
    for name, a, b in (("params", ravel(gathered.params), ravel(full.params)),
                       ("c_global", gathered.c_global, full.c_global),
                       ("c_stack", gathered.c_stack, full.c_stack)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=f"{name} diverged")


def test_nonparticipant_controls_do_not_move(mlp, tmp_path):
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=8)
    coord = _coord(mlp, cd, tmp_path, batch=8, epochs=1, participation_rate=0.25, seed=3)
    sampled = set(coord._sample_cohort(0).tolist())
    coord.run()
    for cid in range(coord.num_clients):
        row_norm = float(coord.c_stack[cid].abs().sum())
        if cid in sampled:
            assert row_norm > 0, f"participant {cid}'s control never moved"
        else:
            assert row_norm == 0, f"non-participant {cid}'s control moved"


@pytest.mark.parametrize("cohort", [False, True])
def test_chunked_scaffold_matches_unchunked(mlp, tmp_path, cohort):
    """client_chunk bounds memory and changes no bit: the reduces run once."""
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=8)
    part = dict(participation_rate=0.5) if cohort else {}
    a = _coord(mlp, cd, tmp_path / "a", rounds=2, batch=8, epochs=1, **part)
    b = _coord(mlp, cd, tmp_path / "b", rounds=2, batch=8, epochs=1, client_chunk=2, **part)
    a.run()
    b.run()
    assert torch.equal(ravel(a.params), ravel(b.params))
    assert torch.equal(a.c_stack, b.c_stack) and torch.equal(a.c_global, b.c_global)


def test_empty_round_moves_nothing(mlp):
    cd = federate(_data(n=64), num_clients=2, scheme="iid", batch_size=32)
    data = cd.to(torch.device("cpu"))
    params = mlp.init(torch.Generator().manual_seed(0))
    strategy = fedavgm_strategy()
    sos = init_server_state(strategy, params)
    step = build_scaffold_round_step(mlp, TrainingConfig(batch_size=32), 2, strategy,
                                     device="cpu")
    c = torch.full((ravel(params).numel(),), 0.01)
    out = step(params, sos, c, torch.zeros(2, c.numel()), data, torch.zeros(2),
               draw_permutations(torch.Generator().manual_seed(0), 2, 1, 32))
    assert torch.equal(ravel(out.params), ravel(params)) and torch.equal(out.c_global, c)
    assert torch.equal(out.server_opt_state["trace"], sos["trace"])
    assert torch.equal(out.delta_c, torch.zeros_like(out.delta_c))


def test_scaffold_refuses_incompatible_features(mlp, tmp_path):
    cd = federate(_data(n=64), num_clients=2, scheme="iid", batch_size=32)
    dp = PrivacyAwareAggregationConfig(privacy=PrivacyConfig(
        epsilon=8.0, delta=1e-5, noise_multiplier=1.0, max_gradient_norm=1.0))
    fit = make_local_fit(mlp, TrainingConfig(batch_size=32))
    for name, kw in {"central_privacy": dict(central_privacy=dp),
                     "validation": dict(validation=ValidationConfig()),
                     "robust": dict(robust=RobustAggregationConfig(trim_k=1)),
                     "local_fit": dict(local_fit=fit)}.items():
        with pytest.raises(ValueError, match=name):
            _coord(mlp, cd, tmp_path, **kw)
    coord = _coord(mlp, cd, tmp_path)
    with pytest.raises(NanoFedError, match="SCAFFOLD"):
        coord.enable_retuning(None)
    with pytest.raises(NanoFedError, match="SCAFFOLD"):
        coord._rebuild_round_programs(1, 1)
    with pytest.raises(NanoFedError, match="SCAFFOLD"):
        Coordinator.from_autotune(mlp, cd, CoordinatorConfig(base_dir=tmp_path),
                                  scaffold=True, device="cpu")
    with pytest.raises(NanoFedError, match="autotune"):
        run_experiment(model="mlp", num_clients=2, train_size=64, scaffold=True,
                       autotune=True, device="cpu", out_dir=tmp_path)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def test_scaffold_resume_equals_uninterrupted(mlp, tmp_path):
    cd = federate(_data(n=256), num_clients=8, scheme="iid", batch_size=16)
    kw = dict(batch=16, participation_rate=0.5)
    full = _coord(mlp, cd, tmp_path / "full", rounds=4, **kw)
    full.run()
    store = FileStateStore(tmp_path / "ckpt")
    _coord(mlp, cd, tmp_path / "a", rounds=2, state_store=store, **kw).run()
    resumed = _coord(mlp, cd, tmp_path / "b", rounds=4, state_store=store, **kw)
    assert resumed.current_round == 2
    resumed.run()
    torch.testing.assert_close(ravel(resumed.params), ravel(full.params), **SELF)
    torch.testing.assert_close(resumed.c_global, full.c_global, **SELF)
    torch.testing.assert_close(resumed.c_stack, full.c_stack, **SELF)


def test_resume_mode_mismatch_fails_loudly(mlp, tmp_path):
    cd = federate(_data(n=64), num_clients=2, scheme="iid", batch_size=32)
    store = FileStateStore(tmp_path / "s")
    _coord(mlp, cd, tmp_path / "a", state_store=store).run()
    with pytest.raises(NanoFedError, match="scaffold=True"):
        _coord(mlp, cd, tmp_path / "b", rounds=2, scaffold=False, state_store=store)
    store2 = FileStateStore(tmp_path / "s2")
    _coord(mlp, cd, tmp_path / "c", scaffold=False, state_store=store2).run()
    with pytest.raises(NanoFedError, match="no control state"):
        _coord(mlp, cd, tmp_path / "d", rounds=2, state_store=store2)
    # A control stack of another population is refused by its rows.
    cd4 = federate(_data(n=128), num_clients=4, scheme="iid", batch_size=32)
    with pytest.raises(CheckpointError, match="one row per client"):
        _coord(mlp, cd4, tmp_path / "e", rounds=2, state_store=store)


def test_run_experiment_takes_scaffold(tmp_path):
    summary = run_experiment(model="mlp", num_clients=4, num_rounds=2, local_epochs=1,
                             batch_size=8, train_size=96, participation=0.5, scaffold=True,
                             client_chunk=1, device="cpu", out_dir=tmp_path)
    assert summary["rounds_completed"] == 2
    assert np.isfinite(summary["final_train_metrics"]["loss"])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_mlp():
    m = jax_get_model("mlp", **MLP)
    params = jax.device_get(m.init(jax.random.key(0)))
    return (lambda p, x, train=False, rng=None: m.apply(p, x)), params


def _controls(params, c, seed):
    """Non-trivial controls: a server control and ``c`` client rows."""
    rng = np.random.default_rng(seed)
    cg = jax.tree.map(lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    cs = jax.tree.map(lambda a: (0.05 * rng.normal(size=(c, *a.shape))).astype(np.float32),
                      params)
    return cg, cs


def _inputs(c=4, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, n, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(c, n)).astype(np.int32)
    mask = np.ones((c, n), np.float32)
    mask[-1, 3:] = 0.0  # a padded client: one of its batches is all padding
    return x, y, mask


HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.1)


@pytest.mark.parametrize("lr_scale", [1.0, 0.5])
def test_scaffold_fit_matches_jax(mlp, lr_scale):
    japply, jparams = _jax_mlp()
    x, y, mask = _inputs()
    cg, cs = _controls(jparams, 4, seed=1)
    rngs = stack_rngs(jax.random.key(2), 4)
    jfit = jax.jit(jax.vmap(jax_make_scaffold_local_fit(japply, JaxTrainingConfig(**HYPER)),
                            in_axes=(None, 0, 0, None, 0, None)))
    want = jfit(jparams, JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)), rngs,
                cg, cs, jnp.float32(lr_scale))
    fit = make_scaffold_local_fit(mlp, TrainingConfig(**HYPER))
    got = fit(from_numpy_params(jparams, device="cpu"),
              ClientData(x, y, mask).to(torch.device("cpu")),
              _jax_permutations(rngs, 2, 8), torch.from_numpy(_flat(cg)),
              torch.from_numpy(_stack_flat(cs)), lr_scale=lr_scale)
    np.testing.assert_allclose(got.delta_c.numpy(), _stack_flat(jax.device_get(want.delta_c)),
                               **PARITY)
    for name, leaf in got.params.items():
        np.testing.assert_allclose(
            leaf.numpy(), flatten_with_names(jax.device_get(want.params))[name], **PARITY)
    np.testing.assert_allclose(got.epoch_loss.numpy(), np.asarray(want.epoch_loss), **PARITY)


@pytest.mark.parametrize("client_chunk", [None, 2])
def test_scaffold_step_matches_jax(mlp, client_chunk):
    japply, jparams = _jax_mlp()
    x, y, mask = _inputs(seed=3)
    cg, cs = _controls(jparams, 4, seed=4)
    weights = mask.sum(1)
    weights[1] = 0.0  # a dropped client: its control must not move
    rngs = stack_rngs(jax.random.key(5), 4)
    jstrategy = jax_base.fedavgm_strategy(0.7, 0.9)
    jstep = jax_build_scaffold_round_step(japply, JaxTrainingConfig(**HYPER),
                                          make_mesh(jax.devices()[:1]), 10, jstrategy,
                                          client_chunk=client_chunk)
    want = jstep(jparams, jstrategy.server_tx.init(jparams), cg, cs,
                 JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)),
                 jnp.asarray(weights), rngs)
    strategy = fedavgm_strategy(0.7, 0.9)
    params = from_numpy_params(jparams, device="cpu")
    step = build_scaffold_round_step(mlp, TrainingConfig(**HYPER), 10, strategy,
                                     client_chunk=client_chunk, device="cpu")
    got = step(params, init_server_state(strategy, params), torch.from_numpy(_flat(cg)),
               torch.from_numpy(_stack_flat(cs)), ClientData(x, y, mask).to(torch.device("cpu")),
               torch.from_numpy(weights), _jax_permutations(rngs, 2, 8))
    want = jax.device_get(want)
    np.testing.assert_allclose(ravel(got.params).numpy(), _flat(want.params), **PARITY)
    np.testing.assert_allclose(got.c_global.numpy(), _flat(want.c_global), **PARITY)
    np.testing.assert_allclose(got.delta_c.numpy(), _stack_flat(want.delta_c), **PARITY)
    assert not got.delta_c[1].any()
    np.testing.assert_allclose(got.server_opt_state["trace"].numpy(),
                               _flat(want.server_opt_state[0].trace), **PARITY)
    np.testing.assert_allclose(got.update_sq_norms.numpy(), np.asarray(want.update_sq_norms),
                               rtol=1e-4, atol=1e-8)
    for key in ("loss", "accuracy", "participating_clients"):
        np.testing.assert_allclose(float(got.metrics[key]), float(want.metrics[key]), **PARITY)


def _jax_cd(n=256, clients=16, batch=16):
    return jax_federate(jax_synthetic(n, 4, (16,), seed=0), num_clients=clients, scheme="iid",
                        batch_size=batch)


def _jax_coord(cd, path, rounds, batch=16, **kw):
    cfg = {k: kw.pop(k) for k in ("participation_rate",) if k in kw}
    return JaxCoordinator(
        model=jax_get_model("mlp", **MLP), train_data=cd,
        config=JaxCoordinatorConfig(num_rounds=rounds, seed=0, base_dir=path,
                                    save_metrics=False, **cfg),
        training=JaxTrainingConfig(batch_size=batch, local_epochs=2, learning_rate=0.1),
        scaffold=True, **kw)


def _port_like_jax(mlp, cd, path, rounds, jc=None, **kw):
    """A port coordinator starting from the JAX coordinator's initial params."""
    coord = _coord(mlp, cd, path, rounds=rounds, batch=16, **kw)
    if jc is not None:
        coord.params = from_numpy_params(jax.device_get(jc.params), device="cpu")
    return coord


def test_scaffold_coordinator_matches_jax(mlp, tmp_path):
    """Single-batch clients, 25% cohorts from the same numpy stream, 3 rounds: params,
    the server control and the whole control stack agree with the JAX coordinator."""
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=16)
    jc = _jax_coord(_jax_cd(), tmp_path / "j", 3, participation_rate=0.25)
    tc = _port_like_jax(mlp, cd, tmp_path / "t", 3, jc, participation_rate=0.25)
    assert tc._cohort_mode and jc._cohort_mode
    jc.run()
    tc.run()
    np.testing.assert_allclose(ravel(tc.params).numpy(), _flat(jax.device_get(jc.params)),
                               **PARITY)
    np.testing.assert_allclose(tc.c_global.numpy(), _flat(jax.device_get(jc.c_global)),
                               **PARITY)
    np.testing.assert_allclose(tc.c_stack.numpy(), _stack_flat(jax.device_get(jc.c_stack)),
                               **PARITY)


@pytest.mark.parametrize("participation", [1.0, 0.25])
def test_scaffold_program_is_profiled_under_the_jax_name(mlp, tmp_path, participation):
    """The SCAFFOLD step is catalogued as ``scaffold_round_step`` with its controls among
    its arguments, as the JAX coordinator catalogues it, and profiles (it runs); the
    profiled calls leave the coordinator's params and controls as they were."""
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=16)
    jc = _jax_coord(_jax_cd(), tmp_path / "j", 1, participation_rate=participation)
    tc = _port_like_jax(mlp, cd, tmp_path / "t", 1, jc, participation_rate=participation)
    assert tc.program_catalog.names() == jc.program_catalog.names() == [
        "scaffold_round_step"]
    before = (ravel(tc.params).clone(), tc.c_global.clone(), tc.c_stack.clone())
    (report,) = tc.profile_programs()
    assert report.program == "scaffold_round_step" and report.flops > 0
    for was, now in zip(before, (ravel(tc.params), tc.c_global, tc.c_stack)):
        assert torch.equal(was, now)


def test_jax_scaffold_checkpoint_resumes_the_port(mlp, tmp_path):
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=16)
    store = tmp_path / "ckpt"
    first = _jax_coord(_jax_cd(), tmp_path / "a", 2, participation_rate=0.25,
                       state_store=jp.FileStateStore(store))
    first.run()
    jc = _jax_coord(_jax_cd(), tmp_path / "jb", 3, participation_rate=0.25,
                    state_store=jp.FileStateStore(store))
    tc = _coord(mlp, cd, tmp_path / "tb", rounds=3, batch=16, participation_rate=0.25,
                state_store=FileStateStore(store))
    assert tc.current_round == jc.current_round == 2
    np.testing.assert_array_equal(ravel(tc.params).numpy(), _flat(jax.device_get(first.params)))
    np.testing.assert_array_equal(tc.c_global.numpy(), _flat(jax.device_get(first.c_global)))
    np.testing.assert_array_equal(tc.c_stack.numpy(), _stack_flat(jax.device_get(first.c_stack)))
    jc.run()
    tc.run()
    np.testing.assert_allclose(ravel(tc.params).numpy(), _flat(jax.device_get(jc.params)),
                               **PARITY)
    np.testing.assert_allclose(tc.c_stack.numpy(), _stack_flat(jax.device_get(jc.c_stack)),
                               **PARITY)


def test_port_scaffold_checkpoint_resumes_jax(mlp, tmp_path):
    cd = federate(_data(n=256), num_clients=16, scheme="iid", batch_size=16)
    store = tmp_path / "ckpt"
    port = _coord(mlp, cd, tmp_path / "t", rounds=2, batch=16, participation_rate=0.25,
                  strategy=fedavgm_strategy(), state_store=FileStateStore(store))
    port.run()
    jc = _jax_coord(_jax_cd(), tmp_path / "j", 3, participation_rate=0.25,
                    strategy=jax_base.fedavgm_strategy(), state_store=jp.FileStateStore(store))
    assert jc.current_round == 2
    np.testing.assert_array_equal(_flat(jax.device_get(jc.params)), ravel(port.params).numpy())
    np.testing.assert_array_equal(_flat(jax.device_get(jc.c_global)), port.c_global.numpy())
    np.testing.assert_array_equal(_stack_flat(jax.device_get(jc.c_stack)), port.c_stack.numpy())
    transform, _ = jax.device_get(jc.server_state)
    np.testing.assert_array_equal(_flat(transform.trace), port.server_state["trace"].numpy())
    (last,) = jc.run()
    assert last.round_id == 2 and np.isfinite(last.agg_metrics["loss"])


def test_zero_controls_helpers(mlp):
    params = mlp.init(torch.Generator().manual_seed(0))
    p = ravel(params).numel()
    assert torch.equal(zero_controls(params), torch.zeros(p))
    assert torch.equal(stack_zero_controls(params, 3), torch.zeros(3, p))


@pytest.mark.cuda
def test_scaffold_step_on_the_card_equals_the_cpu(mlp):
    """On a GPU: the SCAFFOLD step launches B1 normalised and accumulate once each and
    B3 once, and agrees with the CPU step within 1e-4; chip_smoke.py (m) runs the
    flagship."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the SCAFFOLD step's kernels on the card")
    from nanofed_tpu_torch import ops

    x, y, mask = _inputs(seed=3)
    rng = np.random.default_rng(0)
    params = mlp.init(torch.Generator().manual_seed(0))
    p = ravel(params).numel()
    cg = torch.from_numpy((0.05 * rng.normal(size=p)).astype(np.float32))
    cs = torch.from_numpy((0.05 * rng.normal(size=(4, p))).astype(np.float32))
    perms = draw_permutations(torch.Generator().manual_seed(1), 4, 2, 8)
    out = {}
    for dev in ("cuda", "cpu"):
        step = build_scaffold_round_step(mlp, TrainingConfig(**HYPER), 10, client_chunk=2,
                                         device=dev)
        on = {k: v.to(dev) for k, v in params.items()}
        ops.reset_launch_counts()
        out[dev] = step(on, init_server_state(fedavgm_strategy(), on), cg.to(dev), cs.to(dev),
                        ClientData(x, y, mask).to(torch.device(dev)),
                        torch.from_numpy(mask.sum(1)).to(dev), perms.to(dev))
        if dev == "cuda":
            counts = ops.launch_counts()
            assert (counts["weighted_mean_flat"], counts["weighted_sum_into"],
                    counts["row_sq_norms"]) == (1, 1, 1)
    torch.testing.assert_close(ravel(out["cuda"].params).cpu(), ravel(out["cpu"].params),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out["cuda"].c_global.cpu(), out["cpu"].c_global, rtol=1e-4,
                               atol=1e-4)
