"""Port in-round update validation against ``nanofed_tpu.security.validation`` on the
CPU: stacks with NaN and inf rows, an over-norm leaf and an outlier client.

Booleans must be equal; norms and z-scores agree to 1e-5 (float32 sums of a few
thousand squares taken in another order).  The clients' scales are spread so that the
cohort variance is not a small difference of large sums: the leave-one-out variance
is ``ss - x^2 - n * mean^2`` in float32 (as in the JAX package), and a tightly
clustered cohort would amplify rounding in the last bits beyond 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.core.types import ClientUpdates
from nanofed_tpu.security import validation as jv
from nanofed_tpu_torch.security import validation as tv
from nanofed_tpu_torch.utils.trees import ravel_stacked, unravel_stacked

TOL = dict(rtol=1e-5, atol=1e-5)
C = 9


def _stack(seed=0):
    """9 clients x two leaves: client 1 NaN, client 2 +inf, client 4 over the per-leaf
    norm in leaf "b" only, client 7 an outlier by global norm."""
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.1, 0.5, C)
    stacked = {
        "a": (rng.normal(size=(C, 6, 5)) * scale[:, None, None]).astype(np.float32),
        "b": (rng.normal(size=(C, 40)) * scale[:, None]).astype(np.float32),
    }
    stacked["a"][1, 2, 3] = np.nan
    stacked["b"][2, 7] = np.inf
    stacked["b"][4] *= 100.0
    stacked["a"][7] *= 12.0
    return stacked


def _torch(stacked):
    return {k: torch.from_numpy(v.copy()) for k, v in stacked.items()}


def test_stacked_leaf_stats_matches_jax():
    stacked = _stack()
    want = jv.stacked_leaf_stats({k: jnp.asarray(v) for k, v in stacked.items()})
    got = tv.stacked_leaf_stats(_torch(stacked))
    assert got.sanitized is None
    np.testing.assert_array_equal(got.finite.numpy(), np.asarray(want.finite))
    np.testing.assert_allclose(got.leaf_sq.numpy(), np.asarray(want.leaf_sq), **TOL)
    np.testing.assert_allclose(got.global_norm.numpy(), np.asarray(want.global_norm), **TOL)


def test_sanitize_in_place_zeroes_the_buffer_itself():
    """The round's form: leaves are column views of one padded [C, P] buffer, and
    sanitizing writes the buffer (no second copy)."""
    stacked = _stack(1)
    like = {k: torch.zeros(v.shape[1:]) for k, v in stacked.items()}
    flat = ravel_stacked(_torch(stacked))
    buf = torch.zeros(C, flat.shape[1] + 2)
    buf[:, : flat.shape[1]] = flat
    views = unravel_stacked(buf[:, : flat.shape[1]], like)
    got = tv.stacked_leaf_stats(views, sanitize_in_place=True)
    want = jv.stacked_leaf_stats({k: jnp.asarray(v) for k, v in stacked.items()})
    assert torch.isfinite(buf).all()
    for k in stacked:
        assert got.sanitized[k].data_ptr() == views[k].data_ptr()
        np.testing.assert_array_equal(got.sanitized[k].numpy(), np.asarray(want.sanitized[k]))
    np.testing.assert_allclose(got.leaf_sq.numpy(), np.asarray(want.leaf_sq), **TOL)


@pytest.mark.parametrize("eligible_case", ["all", "some", "too_few"])
def test_loo_zscore_matches_jax(eligible_case):
    rng = np.random.default_rng(3)
    norms = rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32)
    norms[5] = 9.0
    eligible = np.ones(C, np.float32)
    if eligible_case == "some":
        eligible[[0, 3]] = 0.0
    elif eligible_case == "too_few":
        eligible[3:] = 0.0
    z_want, a_want = jv.loo_zscore(jnp.asarray(norms), jnp.asarray(eligible), 2.0, 5.0)
    z_got, a_got = tv.loo_zscore(torch.from_numpy(norms), torch.from_numpy(eligible), 2.0, 5.0)
    np.testing.assert_allclose(z_got.numpy(), np.asarray(z_want), **TOL)
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(a_want))


@pytest.mark.parametrize("max_norm", [10.0, 1.5])
def test_validate_client_updates_matches_jax(max_norm):
    stacked = _stack(2)
    config_j = jv.ValidationConfig(max_norm=max_norm)
    config_t = tv.ValidationConfig(max_norm=max_norm)
    jstack = {k: jnp.asarray(v) for k, v in stacked.items()}
    want = jv.validate_client_updates(ClientUpdates(jstack, jnp.ones(C), None), config_j)
    got = tv.validate_client_updates(_torch(stacked), config_t)
    for field in ("finite", "range_ok", "anomalous", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for field in ("global_norm", "z_score"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **TOL)
    assert got.num_valid() == want.num_valid()
    weights = torch.arange(1.0, C + 1)
    np.testing.assert_array_equal(
        tv.apply_validation_mask(weights, got).numpy(),
        np.asarray(jv.apply_validation_mask(jnp.arange(1.0, C + 1), want)))


def test_validation_config_defaults_match_jax():
    assert tv.ValidationConfig() == tv.ValidationConfig(**vars(jv.ValidationConfig()))
