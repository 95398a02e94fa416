"""Port MNIST CNN and layers against the JAX package on the CPU, with the JAX-initialised
weights carried across by ``from_numpy_params``.

Tolerance 1e-5 on log-probs: float32 convolutions and a 9216-long dot product summed
in another order (oneDNN vs XLA:CPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu import nn as jnn
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu_torch import nn
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.utils.trees import from_numpy_params


@pytest.fixture(scope="module")
def jax_model():
    return jax_get_model("mnist_cnn")


def test_eval_log_probs_match_jax(jax_model):
    jp = jax_model.init(jax.random.key(3))
    x = np.random.default_rng(0).normal(size=(6, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax_model.apply(jp, jnp.asarray(x)))
    model = get_model("mnist_cnn")
    got = model.apply(from_numpy_params(jax.device_get(jp), device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dropout_masks_match_jax_inverted_dropout():
    """Same keep-mask on both sides: identical inverted dropout."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 12)).astype(np.float32)
    keep = rng.random((4, 12)) >= 0.25
    want = np.where(keep, x / 0.75, 0.0)
    got = nn.dropout(torch.from_numpy(x), torch.from_numpy(keep), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    xt = torch.from_numpy(x)
    assert nn.dropout(xt, None, 0.25) is xt  # no mask: eval / dropout off


@pytest.mark.parametrize("size", [9, 10])
def test_conv_and_pool_layouts_match_jax(size):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, size, size + 2, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = jnn.max_pool(jnn.conv2d({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)},
                                   jnp.asarray(x)), 2)
    got = nn.max_pool(nn.conv2d({"kernel": torch.from_numpy(k), "bias": torch.from_numpy(b)},
                                torch.from_numpy(x)), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_bounds_match_jax_fan_in():
    params = get_model("mnist_cnn").init(torch.Generator().manual_seed(0))
    fan_in = {"conv1": 9, "conv2": 9 * 32, "fc1": 9216, "fc2": 128}
    for name, leaf in params.items():
        bound = 1.0 / math.sqrt(fan_in[name.split("/")[0]])
        assert float(leaf.abs().max()) <= bound
        assert float(leaf.abs().max()) > 0.9 * bound  # drawn over the whole range
    again = get_model("mnist_cnn").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[n], again[n]) for n in params)
