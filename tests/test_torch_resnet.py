"""Port ResNets and their layers against the JAX package on the CPU, with the
JAX-initialised weights carried across by ``from_numpy_params``.

Tolerances: 1e-5 for one layer in float32 (convolutions summed in another order,
oneDNN vs XLA:CPU); 2e-2 for a layer in bfloat16 (8 bits of mantissa: one rounding
of the statistics and the output is 2^-8 relative); 1e-5 / 1e-4 for a narrow
network's log-probs / gradient and 1e-4 for the full networks (a dozen to twenty
layers of float32 sums); 1e-4 for a one-round run's params.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.flatten_util import ravel_pytree

import nanofed_tpu.experiments as jax_experiments
from nanofed_tpu import nn as jnn
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.models import resnet as jax_resnet
from nanofed_tpu_torch import experiments, nn
from nanofed_tpu_torch.models import get_model, resnet8, resnet18
from nanofed_tpu_torch.models.resnet import _block_apply, _block_init, _resnet
from nanofed_tpu_torch.utils.trees import (
    flatten_with_names,
    from_numpy_params,
    ravel,
    unflatten_names,
)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_matches_lax_conv_general_dilated(padding, stride, size, bias, kernel):
    rng = np.random.default_rng(size + 10 * stride + kernel)
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    params = {"kernel": rng.normal(size=(kernel, kernel, 3, 5)).astype(np.float32)}
    if bias:
        params["bias"] = rng.normal(size=(5,)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(params["kernel"]), window_strides=(stride, stride),
        padding=padding, dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if bias:
        want = want + params["bias"]
    got = nn.conv2d({k: _t(v) for k, v in params.items()}, _t(x), stride=stride,
                    padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_same_padding_is_xlas_split():
    # A 3x3 stride-2 window over an even size pads (0, 1); torch's padding=1 would
    # pad (1, 1) and shift every window.
    assert nn.same_padding(32, 3, 2) == (0, 1)
    assert nn.same_padding(33, 3, 2) == (1, 1)
    assert nn.same_padding(32, 3, 1) == (1, 1)
    assert nn.same_padding(32, 1, 2) == (0, 0)
    with pytest.raises(ValueError, match="padding"):
        nn.conv2d({"kernel": torch.zeros(3, 3, 1, 1)}, torch.zeros(1, 4, 4, 1), padding="FULL")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [16, 12, 4])
def test_group_norm_matches_jax(dtype, channels):
    rng = np.random.default_rng(channels)
    x = (rng.normal(size=(3, 5, 6, channels)) * 2 + 0.5).astype(np.float32)
    scale = rng.normal(size=(channels,)).astype(np.float32)
    bias = rng.normal(size=(channels,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jnn.group_norm({"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
                          jnp.asarray(x, jdt))
    got = nn.group_norm({"scale": _t(scale).to(tdt), "bias": _t(bias).to(tdt)},
                        _t(x).to(tdt))
    assert got.dtype == tdt and str(want.dtype) == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_init_matches_jax(dtype):
    want = jnn.group_norm_init(12, jnp.dtype(dtype))
    got = nn.group_norm_init(12, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == getattr(torch, dtype) and got[k].device.type == "cpu"
        assert str(want[k].dtype) == dtype
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def test_group_norm_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.group_norm_init(4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,stride", [(2, None), (3, 1), (3, 2)])
def test_pools_match_jax(dtype, window, stride):
    x = np.random.default_rng(window).normal(size=(2, 9, 8, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), _t(x).to(getattr(torch, dtype))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(nn.avg_pool(tx, window, stride).float().numpy(),
                               np.asarray(jnn.avg_pool(jx, window, stride), np.float32), **tol)
    np.testing.assert_allclose(nn.global_avg_pool(tx).float().numpy(),
                               np.asarray(jnn.global_avg_pool(jx), np.float32), **tol)


def _masked_nll(apply):
    def loss(params, x, y, m):
        logp = apply(params, x)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=-1)[:, 0] if isinstance(
            logp, jax.Array) else -logp.gather(-1, y[:, None])[:, 0]
        return (nll * m).sum() / m.sum()
    return loss


def test_narrow_resnet_forward_and_gradient_match_jax():
    """Stages 8/16, one block each, stem 8: a stride-2 stage with its projection."""
    jm = jax_resnet._resnet("narrow", (8, 16), 1, 10, stem_channels=8)
    tm = _resnet("narrow", (8, 16), 1, 10, stem_channels=8)
    jp = jax.jit(jm.init)(jax.random.key(4))  # one compile, not one an op
    params = from_numpy_params(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=5).astype(np.int32)
    m = np.array([1, 1, 0, 1, 1], np.float32)
    want = jax.jit(jm.apply)(jp, jnp.asarray(x))
    np.testing.assert_allclose(tm.apply(params, _t(x)).numpy(), np.asarray(want), **F32)
    jgrad = jax.jit(jax.grad(_masked_nll(jm.apply)))(jp, jnp.asarray(x), jnp.asarray(y),
                                                     jnp.asarray(m))
    tgrad = torch.func.grad(_masked_nll(tm.apply))(params, _t(x),
                                                   torch.from_numpy(y).long(), _t(m))
    for name, leaf in from_numpy_params(jax.device_get(jgrad), device="cpu").items():
        torch.testing.assert_close(tgrad[name], leaf, rtol=1e-4, atol=1e-4)


def test_block_init_and_apply_follow_jax():
    """One projected stride-2 block, its params built by each package's _block_init."""
    jp = jax.jit(jax_resnet._block_init, static_argnums=(1, 2))(jax.random.key(5), 4, 8)
    tp = _block_init(torch.Generator().manual_seed(5), 4, 8)
    names = list(flatten_with_names(jax.device_get(jp)))
    assert list(flatten_with_names(tp)) == names  # conv1, conv2, gn1 x2, gn2 x2, proj
    x = np.random.default_rng(5).normal(size=(2, 10, 10, 4)).astype(np.float32)
    want = jax.jit(jax_resnet._block_apply, static_argnums=2)(jp, jnp.asarray(x), 2)
    got = _block_apply(unflatten_names(from_numpy_params(jax.device_get(jp), device="cpu")),
                       _t(x), stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("name,p", [("resnet8", 77_850), ("resnet18", 11_218_340)])
def test_full_resnets_match_jax_with_ravel_order(name, p):
    jm, tm = jax_get_model(name), get_model(name)
    assert tm.dropout == () and tm.input_shape == jm.input_shape == (32, 32, 3)
    assert tm.num_classes == jm.num_classes
    jp = jax.jit(jm.init)(jax.random.key(0))
    flat, _ = ravel_pytree(jp)
    own = tm.init(torch.Generator().manual_seed(0))
    crossed = from_numpy_params(jax.device_get(jp), device="cpu")
    # The port's own init: ravel_pytree's names, shapes and order, and P.
    assert [(k, tuple(v.shape)) for k, v in own.items()] == [
        (k, tuple(v.shape)) for k, v in crossed.items()]
    assert flat.size == p == ravel(own).numel()
    assert list(own)[0] == "fc/bias" and list(own)[-1] == "stem/kernel"
    np.testing.assert_array_equal(ravel(crossed).numpy(), np.asarray(flat))
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.apply(crossed, _t(x)).numpy(),
                               np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


def test_factories_take_the_class_count():
    assert resnet8().num_classes == 10 and resnet18().num_classes == 100
    assert resnet8(num_classes=100).init(torch.Generator())["fc/kernel"].shape == (64, 100)


def test_run_experiment_resnet8_matches_the_jax_runner(tmp_path, monkeypatch):
    """4 FedProx clients of 16 synthetic CIFAR-10 images, one batch an epoch (so the
    local permutations only reorder a sum), 1 round, both runners from the JAX init."""
    kw = dict(model="resnet8", num_clients=4, num_rounds=1, local_epochs=2, batch_size=16,
              learning_rate=0.05, prox_mu=0.01, train_size=64, seed=0)
    made = {}

    def recording(cls, key):
        class Recorded(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made[key] = self
        return Recorded

    jax_init = jax.jit(jax_get_model("resnet8").init)(jax.random.key(0))
    port_model = dataclasses.replace(
        get_model("resnet8"),
        init=lambda gen: from_numpy_params(jax.device_get(jax_init), device="cpu"))
    monkeypatch.setattr(jax_experiments, "Coordinator",
                        recording(jax_experiments.Coordinator, "jax"))
    monkeypatch.setattr(experiments, "Coordinator", recording(experiments.Coordinator, "port"))
    monkeypatch.setattr(experiments, "get_model", lambda name: port_model)
    want = jax_experiments.run_experiment(out_dir=tmp_path / "jax", **kw)
    got = experiments.run_experiment(out_dir=tmp_path / "port", device="cpu", **kw)
    assert got["rounds_completed"] == want["rounds_completed"] == 1
    for name, leaf in from_numpy_params(jax.device_get(made["jax"].params),
                                        device="cpu").items():
        torch.testing.assert_close(made["port"].params[name], leaf, rtol=1e-4, atol=1e-4)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got["final_eval_metrics"][key],
                                   want["final_eval_metrics"][key], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["final_train_metrics"][key],
                                   want["final_train_metrics"][key], rtol=1e-4, atol=1e-4)
