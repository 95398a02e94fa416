"""DP-SGD clients of the port (``trainer.private``) against the JAX package's
``nanofed_tpu.trainer.private`` on the CPU.

The JAX grad fn draws its noise from its step key (``jax.random.split`` into dropout
and noise keys, ``private.py:64``, ``:79``); the port's from a counter-based hash of
the client's key.  So the parity tests inject the JAX draw: the unit-scale noise of
each (client, epoch, step), computed from the same key splits, is handed to the
port's grad fn by the port's key for that step.  Models run without dropout, and the
fits get the JAX fit's own permutations.

Tolerances (float32): the grad fn 1e-5 relative and 1e-6 absolute (per-example
gradients summed in another order); fits and rounds 1e-5 (a few SGD steps); the
privacy numbers exactly (the same host float64 arithmetic).  The bfloat16 grad fn is
held at 2e-2 relative: the two packages round the bf16 forward in other places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.parallel.mesh import make_mesh
from nanofed_tpu.parallel.round_step import build_round_step as jax_build_round_step
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.privacy import GaussianAccountant as JaxGaussianAccountant
from nanofed_tpu.privacy import PrivacyConfig as JaxPrivacyConfig
from nanofed_tpu.privacy import RDPAccountant as JaxRDPAccountant
from nanofed_tpu.privacy.config import NoiseType as JaxNoiseType
from nanofed_tpu.privacy.noise import get_noise_generator as jax_noise_generator
from nanofed_tpu.privacy.noise import tree_noise as jax_tree_noise
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer import private as jax_private
from nanofed_tpu.trainer.local import make_local_fit as jax_make_local_fit
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu_torch.aggregation import fedavg_strategy
from nanofed_tpu_torch.core.exceptions import PrivacyError
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel import build_round_step, init_server_state
from nanofed_tpu_torch.privacy import (
    GaussianAccountant,
    NoiseType,
    PrivacyConfig,
    RDPAccountant,
)
from nanofed_tpu_torch.trainer import (
    SGD,
    TrainingConfig,
    client_keys,
    draw_permutations,
    get_privacy_spent,
    local_fit_noise_events,
    make_dp_grad_fn,
    make_local_fit,
    make_private_local_fit,
    record_local_fit,
    validate_privacy_budget,
)
from nanofed_tpu_torch.trainer.local import grad_keys
from nanofed_tpu_torch.trainer.private import (
    clip_coefficients,
    counter_noise,
    per_example_grads,
)
from nanofed_tpu_torch.utils.trees import flatten_with_names, from_numpy_params, ravel

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)
MLP = dict(in_features=16, hidden=32, num_classes=4)
PRIVACY = dict(max_gradient_norm=2.0, noise_multiplier=0.8)
HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.1)
C, N = 4, 8


def _flat(tree):
    return np.concatenate([np.asarray(a).ravel() for a in flatten_with_names(tree).values()])


def _models(name):
    """(JAX apply without dropout, JAX params, port model without dropout, port params)."""
    if name == "mlp":
        jm, tm = jax_get_model("mlp", **MLP), get_model("mlp", **MLP)
    else:
        jm, tm = jax_get_model("mnist_cnn"), dataclasses.replace(get_model("mnist_cnn"),
                                                                 dropout=())
    jp = jax.device_get(jm.init(jax.random.key(0)))
    return (lambda p, x, train=False, rng=None: jm.apply(p, x)), jp, tm, from_numpy_params(
        jp, device="cpu")


def _batch(name, b=6, seed=1):
    rng = np.random.default_rng(seed)
    shape = (MLP["in_features"],) if name == "mlp" else (28, 28, 1)
    classes = MLP["num_classes"] if name == "mlp" else 10
    x = rng.normal(size=(b, *shape)).astype(np.float32)
    x[0] *= 40.0  # far above the clip bound
    x[1] *= 1e-3  # below it
    y = rng.integers(0, classes, size=b).astype(np.int32)
    m = np.ones(b, np.float32)
    m[-2:] = 0.0  # padded rows
    return x, y, m


def _unit_noise(noise_rng, like, noise_type):
    gen = jax_noise_generator(JaxNoiseType(noise_type.value))
    return torch.from_numpy(_flat(jax_tree_noise(noise_rng, like, 1.0, gen)))


@pytest.mark.parametrize("name,noise_type", [("mlp", NoiseType.GAUSSIAN),
                                             ("mlp", NoiseType.LAPLACIAN),
                                             ("mnist_cnn", NoiseType.GAUSSIAN)])
def test_dp_grad_fn_matches_jax(name, noise_type):
    japply, jp, model, params = _models(name)
    x, y, m = _batch(name)
    rng = jax.random.key(7)
    jprivacy = JaxPrivacyConfig(**PRIVACY, noise_type=JaxNoiseType(noise_type.value))
    want, wstats = jax_private.make_dp_grad_fn(japply, jprivacy)(
        jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), rng)
    _, noise_rng = jax.random.split(rng)
    unit = _unit_noise(noise_rng, jp, noise_type)
    grad_fn = make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY, noise_type=noise_type),
                              noise_fn=lambda key, n: unit)
    got, stats = grad_fn(params, torch.from_numpy(x), torch.from_numpy(y).long(),
                         torch.from_numpy(m), (), torch.tensor(3, dtype=torch.int32))
    torch.testing.assert_close(ravel(got), torch.from_numpy(_flat(want)), **GRAD_TOL)
    for field in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(getattr(stats, field)),
                                   float(getattr(wstats, field)), rtol=1e-5)


def test_dp_grad_fn_bfloat16_matches_jax():
    japply, jp, model, params = _models("mlp")
    x, y, m = _batch("mlp")
    rng = jax.random.key(8)
    want, _ = jax_private.make_dp_grad_fn(japply, JaxPrivacyConfig(**PRIVACY),
                                          compute_dtype="bfloat16")(
        jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), rng)
    unit = _unit_noise(jax.random.split(rng)[1], jp, NoiseType.GAUSSIAN)
    got, _ = make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY), compute_dtype="bfloat16",
                             noise_fn=lambda key, n: unit)(
        params, torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(m), (),
        torch.tensor(3, dtype=torch.int32))
    assert all(g.dtype == torch.float32 for g in got.values())  # float32 master gradients
    torch.testing.assert_close(ravel(got), torch.from_numpy(_flat(want)), rtol=2e-2, atol=2e-3)


def test_padding_contributes_exactly_zero_and_clips_per_example():
    _, _, model, params = _models("mlp")
    x, y, m = (torch.from_numpy(a) for a in _batch("mlp"))
    y = y.long()
    grads, _, _ = per_example_grads(model.apply)(params, x, y, ())
    coef = clip_coefficients(grads, m, PRIVACY["max_gradient_norm"])
    norms = torch.stack([g.reshape(g.shape[0], -1).square().sum(1)
                         for g in grads.values()]).sum(0).sqrt()
    assert float(norms[0]) > PRIVACY["max_gradient_norm"] > float(norms[1])
    assert float(coef[0]) < 1.0 and float(coef[1]) == 1.0
    assert torch.equal(coef[-2:], torch.zeros(2))
    clipped = torch.stack([(coef[:, None] * g.reshape(g.shape[0], -1)).square().sum(1)
                           for g in grads.values()]).sum(0).sqrt()
    assert float(clipped.max()) <= PRIVACY["max_gradient_norm"] * (1 + 1e-6)

    grad_fn = make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY))
    key = torch.tensor(11, dtype=torch.int32)
    a, _ = grad_fn(params, x, y, m, (), key)
    x2, y2 = x.clone(), y.clone()
    x2[-2:] = 1e6  # garbage in the padded rows
    y2[-2:] = 3
    b, _ = grad_fn(params, x2, y2, m, (), key)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _fit_inputs(name, c=C, n=N, seed=0):
    rng = np.random.default_rng(seed)
    shape = (MLP["in_features"],) if name == "mlp" else (28, 28, 1)
    classes = MLP["num_classes"] if name == "mlp" else 10
    x = rng.normal(size=(c, n, *shape)).astype(np.float32)
    x[0] *= 20.0  # a client whose examples clip
    y = rng.integers(0, classes, size=(c, n)).astype(np.int32)
    mask = np.ones((c, n), np.float32)
    mask[-1, 3:] = 0.0  # a padded client: one of its batches is all padding
    return x, y, mask


def _jax_permutations(rngs, epochs, n):
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def _injected_noise(rngs, keys, epochs, steps, like):
    """The JAX fit's unit noise of every (client, epoch, step), as a port ``noise_fn``
    that looks its draw up by the port's grad-fn key for that step."""
    port_keys = grad_keys(keys, epochs, steps)  # [E, S, k]
    table_keys, rows = [], []
    for c, rng in enumerate(rngs):
        for e, ekey in enumerate(jax.random.split(rng, epochs)):
            _, step_key = jax.random.split(ekey)
            for s, skey in enumerate(jax.random.split(step_key, steps)):
                table_keys.append(int(port_keys[e, s, c]))
                rows.append(_unit_noise(jax.random.split(skey)[1], like, NoiseType.GAUSSIAN))
    assert len(set(table_keys)) == len(table_keys)
    table_keys = torch.tensor(table_keys, dtype=torch.int32)
    table = torch.stack(rows)

    def noise_fn(key, n):
        return (table_keys == key).float() @ table  # picks the row exactly

    return noise_fn


def test_private_local_fit_matches_jax():
    japply, jp, model, params = _models("mlp")
    x, y, mask = _fit_inputs("mlp")
    rngs = stack_rngs(jax.random.key(2), C)
    jprivacy = JaxPrivacyConfig(**PRIVACY)
    jfit = jax.jit(jax.vmap(
        jax_private.make_private_local_fit(japply, JaxTrainingConfig(**HYPER), jprivacy),
        in_axes=(None, 0, 0)))
    want = jfit(jp, JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)), rngs)

    keys = client_keys(5, C, "cpu")
    steps = N // HYPER["batch_size"]
    grad_fn = make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY),
                              noise_fn=_injected_noise(rngs, keys, 2, steps, jp))
    fit = make_local_fit(model, TrainingConfig(**HYPER), grad_fn=grad_fn)
    got = fit(params, ClientData(x, y, mask).to(torch.device("cpu")),
              _jax_permutations(rngs, 2, N), keys)
    for name, leaf in from_numpy_params(jax.device_get(want.params), device="cpu").items():
        torch.testing.assert_close(got.params[name], leaf, **FIT_TOL)
    for field in ("loss", "accuracy", "samples"):
        np.testing.assert_allclose(getattr(got.metrics, field).numpy(),
                                   np.asarray(getattr(want.metrics, field)), **FIT_TOL)


def test_round_step_with_private_fit_matches_jax():
    japply, jp, model, params = _models("mlp")
    x, y, mask = _fit_inputs("mlp", seed=3)
    rngs = stack_rngs(jax.random.key(4), C)
    jprivacy = JaxPrivacyConfig(**PRIVACY)
    jtraining = JaxTrainingConfig(**HYPER)
    from nanofed_tpu.aggregation import base as jax_base

    jstep = jax_build_round_step(
        japply, jtraining, make_mesh(jax.devices()[:1]), jax_base.fedavg_strategy(),
        local_fit=jax_private.make_private_local_fit(japply, jtraining, jprivacy))
    weights = mask.sum(1)
    want = jstep(jp, jax_init_server_state(jax_base.fedavg_strategy(), jp),
                 JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)),
                 jnp.asarray(weights), rngs)

    keys = client_keys(9, C, "cpu")
    grad_fn = make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY),
                              noise_fn=_injected_noise(rngs, keys, 2, N // 4, jp))
    training = TrainingConfig(**HYPER)
    step = build_round_step(model, training, fedavg_strategy(), client_chunk=2,
                            local_fit=make_local_fit(model, training, grad_fn=grad_fn))
    got = step(params, init_server_state(fedavg_strategy(), params),
               ClientData(x, y, mask).to(torch.device("cpu")), torch.from_numpy(weights),
               _jax_permutations(rngs, 2, N), keys)
    np.testing.assert_allclose(ravel(got.params).numpy(), _flat(jax.device_get(want.params)),
                               **FIT_TOL)
    np.testing.assert_allclose(got.update_sq_norms.numpy(), np.asarray(want.update_sq_norms),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(float(got.metrics["loss"]), float(want.metrics["loss"]),
                               **FIT_TOL)


def test_make_private_local_fit_is_the_dp_grad_fn_fit():
    """make_private_local_fit = make_local_fit(grad_fn=make_dp_grad_fn(compute_dtype=
    the config's)) with the config's compute dtype cleared, bit for bit."""
    _, _, model, params = _models("mlp")
    x, y, mask = _fit_inputs("mlp")
    data = ClientData(x, y, mask).to(torch.device("cpu"))
    perms = draw_permutations(torch.Generator().manual_seed(1), C, 2, N)
    keys = client_keys(3, C, "cpu")
    training = TrainingConfig(**HYPER, compute_dtype="bfloat16")
    a = make_private_local_fit(model, training, PrivacyConfig(**PRIVACY))(
        params, data, perms, keys)
    b = make_local_fit(model, dataclasses.replace(training, compute_dtype=None),
                       grad_fn=make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY),
                                               compute_dtype="bfloat16"))(
        params, data, perms, keys)
    assert all(torch.equal(a.params[k], b.params[k]) for k in params)
    with pytest.raises(ValueError, match="keys"):
        make_private_local_fit(model, TrainingConfig(**HYPER), PrivacyConfig(**PRIVACY))(
            params, data, perms)


def test_noise_accounting_matches_jax():
    training = TrainingConfig(batch_size=16, local_epochs=3, max_batches=2)
    jtraining = JaxTrainingConfig(batch_size=16, local_epochs=3, max_batches=2)
    assert local_fit_noise_events(training, 64) == jax_private.local_fit_noise_events(
        jtraining, 64) == 6
    assert local_fit_noise_events(TrainingConfig(batch_size=16), 48) == 3
    for port_cls, jax_cls in ((RDPAccountant, JaxRDPAccountant),
                              (GaussianAccountant, JaxGaussianAccountant)):
        privacy = PrivacyConfig(epsilon=3.0, noise_multiplier=1.1)
        jprivacy = JaxPrivacyConfig(epsilon=3.0, noise_multiplier=1.1)
        port, ref = port_cls(), jax_cls()
        for samples in (60, 60, 10):
            record_local_fit(port, privacy, training, 64, samples)
            jax_private.record_local_fit(ref, jprivacy, jtraining, 64, samples)
        assert port.state_dict() == ref.state_dict()
        spent, want = get_privacy_spent(port, privacy), jax_private.get_privacy_spent(
            ref, jprivacy)
        assert (spent.epsilon_spent, spent.delta_spent) == (want.epsilon_spent,
                                                            want.delta_spent)
        assert validate_privacy_budget(port, privacy) == jax_private.validate_privacy_budget(
            ref, jprivacy)
    with pytest.raises(PrivacyError):
        record_local_fit(RDPAccountant(), PrivacyConfig(noise_type=NoiseType.LAPLACIAN),
                         training, 64, 60)


def _round(model, training, data, perms, keys, client_chunk=None, order=None):
    order = np.arange(data.y.shape[0]) if order is None else order
    idx = torch.as_tensor(np.ascontiguousarray(order))
    fit = make_private_local_fit(model, training, PrivacyConfig(**PRIVACY))
    step = build_round_step(model, training, fedavg_strategy(), client_chunk=client_chunk,
                            local_fit=fit)
    params = model.init(torch.Generator().manual_seed(0))
    return step(params, init_server_state(fedavg_strategy(), params), data.select(idx),
                data.mask.sum(1)[idx], perms[idx], keys[idx])


def test_noise_is_client_stable_across_chunks_and_slots():
    model = get_model("mlp", **MLP)
    x, y, mask = _fit_inputs("mlp")
    data = ClientData(x, y, mask).to(torch.device("cpu"))
    training = TrainingConfig(**HYPER)
    perms = draw_permutations(torch.Generator().manual_seed(2), C, 2, N)
    keys = client_keys(17, C, "cpu")
    whole = _round(model, training, data, perms, keys)
    chunked = _round(model, training, data, perms, keys, client_chunk=1)
    reversed_slots = _round(model, training, data, perms, keys, order=np.arange(C)[::-1])
    torch.testing.assert_close(ravel(chunked.params), ravel(whole.params), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(reversed_slots.update_sq_norms.flip(0), whole.update_sq_norms,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ravel(reversed_slots.params), ravel(whole.params), rtol=1e-6,
                               atol=1e-7)
    other = _round(model, training, data, perms, client_keys(18, C, "cpu"))
    assert not torch.equal(ravel(other.params), ravel(whole.params))


@pytest.mark.parametrize("noise_type", [NoiseType.GAUSSIAN, NoiseType.LAPLACIAN])
def test_counter_noise_is_a_function_of_the_key(noise_type):
    n = 200_001
    keys = torch.tensor([5, 6, -7], dtype=torch.int32)
    batched = torch.func.vmap(lambda k: counter_noise(k, n, noise_type))(keys)
    for i, key in enumerate(keys):
        assert torch.equal(batched[i], counter_noise(key, n, noise_type))
    draw = batched[0].double()
    std = 1.0 if noise_type is NoiseType.GAUSSIAN else 2 ** 0.5
    assert abs(float(draw.mean())) < 5 * std / n ** 0.5
    assert abs(float(draw.std()) / std - 1.0) < 0.01
    assert torch.isfinite(draw).all()
    assert not torch.equal(batched[0], batched[1])


def test_custom_grad_fn_with_compute_dtype_is_refused():
    """A custom grad fn owns its casts: with TrainingConfig.compute_dtype set the fit
    is refused with the JAX package's error, never run at the wrong precision."""
    model = get_model("mlp", **MLP)

    def custom(params, xb, yb, mb, dropout, key=None):
        raise AssertionError("never called")

    with pytest.raises(ValueError) as got:
        make_local_fit(model, TrainingConfig(compute_dtype="bfloat16"), grad_fn=custom)
    with pytest.raises(ValueError) as want:
        jax_make_local_fit(jax_get_model("mlp", **MLP).apply,
                           JaxTrainingConfig(compute_dtype="bfloat16"), grad_fn=custom)
    assert str(got.value) == str(want.value)
    make_local_fit(model, TrainingConfig(), grad_fn=custom)  # no dtype: accepted


def test_optimizer_argument_replaces_the_configs():
    model = get_model("mlp", **MLP)
    params = model.init(torch.Generator().manual_seed(0))
    x, y, mask = _fit_inputs("mlp")
    data = ClientData(x, y, mask).to(torch.device("cpu"))
    perms = draw_permutations(torch.Generator().manual_seed(1), C, 2, N)
    a = make_local_fit(model, TrainingConfig(**HYPER, momentum=0.9))(params, data, perms)
    b = make_local_fit(model, TrainingConfig(**HYPER),
                       optimizer=SGD(HYPER["learning_rate"], momentum=0.9))(params, data, perms)
    c = make_local_fit(model, TrainingConfig(**HYPER))(params, data, perms)
    assert all(torch.equal(a.params[k], b.params[k]) for k in params)
    assert not torch.equal(a.params["fc1/kernel"], c.params["fc1/kernel"])


def test_coordinator_runs_private_clients_and_checks_lr_scale(tmp_path):
    cd = federate(synthetic_classification(128, 4, (16,), seed=0), num_clients=4,
                  batch_size=8)
    model = get_model("mlp", **MLP)
    training = TrainingConfig(batch_size=8, local_epochs=1)
    fit = make_private_local_fit(model, training, PrivacyConfig(**PRIVACY))
    cfg = CoordinatorConfig(num_rounds=2, seed=0, base_dir=tmp_path, lr_schedule="cosine")
    a = Coordinator(model, cd, cfg, training, local_fit=fit, device="cpu", client_chunk=2)
    b = Coordinator(model, cd, cfg, training, local_fit=fit, device="cpu")
    assert [m.agg_metrics["lr_scale"] for m in a.run()] == [1.0, 0.5]
    b.run()
    torch.testing.assert_close(ravel(a.params), ravel(b.params), rtol=1e-6, atol=1e-7)

    def bare(global_params, data, perms, keys=None, lr_scale=1.0):
        return fit(global_params, data, perms, keys)

    with pytest.raises(ValueError, match="lr_scale"):
        Coordinator(model, cd, cfg, training, local_fit=bare, device="cpu")
    with pytest.raises(ValueError, match="grad_fn"):
        Coordinator(model, cd, CoordinatorConfig(base_dir=tmp_path), training, local_fit=fit,
                    grad_fn=make_dp_grad_fn(model.apply, PrivacyConfig(**PRIVACY)),
                    device="cpu")


@pytest.mark.cuda
def test_dp_round_on_the_card_equals_the_cpu():
    """On a GPU: the counter-based noise is the CPU's draw within 1e-6 relative, and a
    DP-SGD round launches B1's accumulate form and B3 once a chunk and agrees with the
    CPU round within 1e-4; chip_smoke.py (l) runs it at the flagship's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the DP-SGD round's noise and kernels on the card")
    from nanofed_tpu_torch import ops

    key = torch.tensor(12345, dtype=torch.int32)
    cpu = counter_noise(key, 100_001)
    gpu = counter_noise(key.cuda(), 100_001).cpu()
    assert float((gpu - cpu).abs().max() / cpu.abs().max()) <= 1e-6
    model = get_model("mlp", **MLP)
    x, y, mask = _fit_inputs("mlp")
    perms = draw_permutations(torch.Generator().manual_seed(2), C, 2, N)
    training = TrainingConfig(**HYPER)
    results = {}
    for dev in ("cuda", "cpu"):
        data = ClientData(x, y, mask).to(torch.device(dev))
        ops.reset_launch_counts()
        results[dev] = _round(model, training, data, perms.to(dev), client_keys(17, C, dev),
                              client_chunk=2)
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["weighted_sum_into"] == 2 and counts["row_sq_norms"] == 2
    torch.testing.assert_close(ravel(results["cuda"].params).cpu(),
                               ravel(results["cpu"].params), rtol=1e-4, atol=1e-4)
