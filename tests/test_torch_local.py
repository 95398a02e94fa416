"""Port local fit against the JAX package's ``make_local_fit`` on the CPU.

Both sides start from the same JAX-initialised weights, train with dropout off, and
the port is handed the exact epoch permutations the JAX fit draws from its keys.
Tolerance 1e-4: four SGD steps with momentum of float32 convolutions summed in
another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import make_local_fit as jax_make_local_fit
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.trainer import TrainingConfig, make_evaluator, make_local_fit
from nanofed_tpu_torch.trainer.local import client_keys, draw_permutations
from nanofed_tpu_torch.utils.trees import from_numpy_params

TOL = dict(rtol=1e-4, atol=1e-4)
HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.05, momentum=0.9,
             weight_decay=1e-3, prox_mu=0.1)


def jax_permutations(rngs, epochs, n):
    """The permutations ``nanofed_tpu.trainer.local.make_local_fit`` draws from each
    client's key: split into epoch keys, split each, permute with the first half."""
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def tiny_clients(k=3, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(k, n)).astype(np.int32)
    mask = np.ones((k, n), np.float32)
    mask[-1, 3:] = 0.0  # a padded client: some of its batches are all padding
    return x, y, mask


def no_dropout_jax_apply():
    m = jax_get_model("mnist_cnn")
    return lambda p, x, train=False, rng=None: m.apply(p, x)


@pytest.mark.parametrize("lr_scale", [1.0, 0.5])
def test_local_fit_matches_jax(lr_scale):
    x, y, mask = tiny_clients()
    jp = jax_get_model("mnist_cnn").init(jax.random.key(1))
    rngs = stack_rngs(jax.random.key(2), x.shape[0])
    jfit = jax.jit(jax.vmap(
        jax_make_local_fit(no_dropout_jax_apply(), JaxTrainingConfig(**HYPER)),
        in_axes=(None, 0, 0, None),
    ))
    want = jfit(jp, JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)), rngs,
                jnp.float32(lr_scale))

    model = dataclasses.replace(get_model("mnist_cnn"), dropout=())
    fit = make_local_fit(model, TrainingConfig(**HYPER))
    got = fit(from_numpy_params(jax.device_get(jp), device="cpu"),
              ClientData(x, y, mask).to(torch.device("cpu")),
              jax_permutations(rngs, HYPER["local_epochs"], x.shape[1]), lr_scale=lr_scale)

    for name, leaf in from_numpy_params(jax.device_get(want.params), device="cpu").items():
        torch.testing.assert_close(got.params[name], leaf, **TOL)
    for field in ("loss", "accuracy", "samples"):
        np.testing.assert_allclose(getattr(got.metrics, field).numpy(),
                                   np.asarray(getattr(want.metrics, field)), **TOL)
    np.testing.assert_allclose(got.epoch_loss.numpy(), np.asarray(want.epoch_loss), **TOL)


def test_all_padding_client_is_a_no_op():
    """A client with no real samples: params and momentum untouched every step."""
    x, y, mask = tiny_clients(k=2)
    mask[1] = 0.0
    model = dataclasses.replace(get_model("mnist_cnn"), dropout=())
    params = model.init(torch.Generator().manual_seed(0))
    fit = make_local_fit(model, TrainingConfig(**HYPER))
    perms = draw_permutations(torch.Generator().manual_seed(1), 2, 2, 8)
    got = fit(params, ClientData(x, y, mask).to(torch.device("cpu")), perms)
    for name, p in params.items():
        assert torch.equal(got.params[name][1], p)
        assert not torch.equal(got.params[name][0], p)
    assert float(got.metrics.samples[1]) == 0.0


def test_dropout_fit_needs_a_generator_and_is_seeded():
    x, y, mask = tiny_clients(k=2)
    model = get_model("mnist_cnn")
    params = model.init(torch.Generator().manual_seed(0))
    fit = make_local_fit(model, TrainingConfig(**HYPER))
    data = ClientData(x, y, mask).to(torch.device("cpu"))
    perms = draw_permutations(torch.Generator().manual_seed(1), 2, 2, 8)
    with pytest.raises(ValueError, match="keys"):
        fit(params, data, perms)
    a = fit(params, data, perms, client_keys(5, 2, "cpu"))
    b = fit(params, data, perms, client_keys(5, 2, "cpu"))
    c = fit(params, data, perms, client_keys(6, 2, "cpu"))
    for name in params:
        assert torch.equal(a.params[name], b.params[name])
    assert not torch.equal(a.params["fc1/kernel"], c.params["fc1/kernel"])


def test_evaluator_matches_jax():
    from nanofed_tpu.trainer.local import make_evaluator as jax_make_evaluator

    rng = np.random.default_rng(3)
    n = 300  # not a multiple of the batch: the tail batch is padded
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    mask = np.ones((n,), np.float32)
    m = jax_get_model("mnist_cnn")
    jp = m.init(jax.random.key(4))
    want = jax_make_evaluator(m.apply, batch_size=128)(
        jp, JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    got = make_evaluator(get_model("mnist_cnn"), batch_size=128)(
        from_numpy_params(jax.device_get(jp), device="cpu"),
        ClientData(x, y, mask).to(torch.device("cpu")))
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_keep_masks_are_bernoulli_and_keyed_by_client(rate):
    """``nn.keep_mask``: the keep share is 1 - rate within 5 standard errors, two
    clients' masks agree as often as independent draws would (p^2 + (1-p)^2), and a
    client's mask depends on its key alone, not on the other rows of the call."""
    from nanofed_tpu_torch.nn import keep_mask, mix32

    keys = client_keys(3, 4, "cpu")
    positions = mix32(torch.arange(64 * 9216, dtype=torch.int32))
    masks = keep_mask(keys, positions, (64, 9216), rate)
    n = masks[0].numel()
    p = 1.0 - rate
    for m in masks:
        assert abs(float(m.float().mean()) - p) < 5 * (p * (1 - p) / n) ** 0.5
    agree = float((masks[0] == masks[1]).float().mean())
    q = p * p + (1 - p) * (1 - p)
    assert abs(agree - q) < 5 * (q * (1 - q) / n) ** 0.5
    alone = keep_mask(keys[2:3], positions, (64, 9216), rate)
    assert torch.equal(alone[0], masks[2])
    assert keep_mask(keys, positions[:10], (10,), 0.0).all()
