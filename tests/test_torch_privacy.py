"""Port privacy modules against ``nanofed_tpu.privacy`` and
``nanofed_tpu.aggregation.privacy`` on the CPU.

The accountants are the same NumPy code, so their epsilons and the calibrated noise
multiplier must be EQUAL.  Noise comes from torch generators (not threefry), so draws
are held to their distribution: the sample mean and std of 200,000 draws within 5
standard errors (mean: 5 / sqrt(n); std: 5 * sqrt(1 / (2n)) for the Gaussian and
5 * sqrt(5 / (4n)) for the Laplace), and a fixed seed must repeat.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu import privacy as jp
from nanofed_tpu.aggregation import privacy as jagg
from nanofed_tpu.core.exceptions import AggregationError as JaxAggregationError
from nanofed_tpu.core.exceptions import PrivacyError as JaxPrivacyError
from nanofed_tpu_torch import privacy as tp
from nanofed_tpu_torch.aggregation import privacy as tagg
from nanofed_tpu_torch.core.exceptions import AggregationError, PrivacyError

EVENTS = [(1.1, 0.01, 100), (0.7, 0.1, 3), (2.0, 1.0, 5), (0.44, 0.1, 20), (5.0, 0.5, 1)]


@pytest.mark.parametrize("sigma,q,count", EVENTS)
def test_rdp_and_gaussian_accountants_equal_jax(sigma, q, count):
    for jax_cls, torch_cls in ((jp.RDPAccountant, tp.RDPAccountant),
                               (jp.GaussianAccountant, tp.GaussianAccountant)):
        ja, ta = jax_cls(), torch_cls()
        for acc in (ja, ta):
            acc.add_noise_event(sigma, q, count=count)
            acc.add_noise_event(sigma, q)  # collapses into the same run
        for delta in (1e-5, 1e-3):
            assert ta.get_privacy_spent(delta).to_dict() == ja.get_privacy_spent(delta).to_dict()
        assert ta.state_dict() == ja.state_dict()
    np.testing.assert_array_equal(
        tp.sampled_gaussian_rdp(sigma, q, np.asarray(tp.DEFAULT_RDP_ORDERS)),
        jp.accounting.sampled_gaussian_rdp(sigma, q, np.asarray(jp.DEFAULT_RDP_ORDERS)))


def test_rdp_state_dict_round_trips_and_composes():
    ta = tp.RDPAccountant()
    ta.add_noise_event(1.0, 0.1, count=4)
    restored = tp.RDPAccountant()
    restored.load_state_dict(ta.state_dict())
    assert restored.get_privacy_spent(1e-5) == ta.get_privacy_spent(1e-5)
    assert restored.num_events == 4
    assert restored.optimal_order(1e-5) == ta.optimal_order(1e-5)


@pytest.mark.parametrize("eps,delta,q,events", [(2.0, 1e-5, 0.1, 2), (1.0, 1e-5, 0.01, 100),
                                                 (8.0, 1e-6, 1.0, 10)])
def test_noise_multiplier_for_budget_equals_jax(eps, delta, q, events):
    assert tp.noise_multiplier_for_budget(eps, delta, q, events) == \
        jp.noise_multiplier_for_budget(eps, delta, q, events)


@pytest.mark.parametrize("kwargs", [
    dict(epsilon=0.001), dict(epsilon=11.0), dict(delta=0.5), dict(delta=1e-12),
    dict(max_gradient_norm=0.0), dict(noise_multiplier=-1.0), dict(noise_type="gaussian"),
])
def test_privacy_config_bounds_raise_as_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jp.PrivacyConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        tp.PrivacyConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_laplacian_accounting_refused_as_jax():
    cfg_t = tp.PrivacyConfig(noise_type=tp.NoiseType.LAPLACIAN)
    cfg_j = jp.PrivacyConfig(noise_type=jp.NoiseType.LAPLACIAN)
    with pytest.raises(JaxPrivacyError):
        jp.require_gaussian_accounting(cfg_j)
    with pytest.raises(PrivacyError):
        tp.require_gaussian_accounting(cfg_t)
    with pytest.raises(PrivacyError):
        tagg.record_central_privacy(tp.RDPAccountant(),
                                    tagg.PrivacyAwareAggregationConfig(privacy=cfg_t))


@pytest.mark.parametrize("noise_type,std_factor", [("gaussian", 1.0),
                                                   ("laplacian", math.sqrt(2.0))])
def test_noise_draws_have_the_requested_moments_and_repeat(noise_type, std_factor):
    n, scale = 200_000, 0.7
    noise = tp.get_noise_generator(noise_type)
    draw = noise.sample(torch.Generator().manual_seed(3), (n,), scale)
    std = scale * std_factor
    se_std = std * math.sqrt((0.5 if noise_type == "gaussian" else 1.25) / n)
    assert abs(float(draw.mean())) < 5 * std / math.sqrt(n)
    assert abs(float(draw.std()) - std) < 5 * se_std
    assert torch.equal(draw, noise.sample(torch.Generator().manual_seed(3), (n,), scale))
    assert not torch.equal(draw, noise.sample(torch.Generator().manual_seed(4), (n,), scale))
    with pytest.raises(ValueError):
        noise.sample(torch.Generator(), (3,), -1.0)
    with pytest.raises(ValueError):
        noise.sample(torch.Generator(), (-1,), 1.0)


def test_tree_noise_is_one_flat_draw_in_ravel_order():
    tree = {"a": torch.zeros(3, 4), "b": torch.zeros(5)}
    noised = tp.tree_noise(torch.Generator().manual_seed(0), tree, 2.0)
    flat = 2.0 * torch.randn(17, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(torch.cat([noised["a"].reshape(-1), noised["b"]]), flat)
    added = tp.tree_add_noise(torch.Generator().manual_seed(0),
                              {k: v + 1.0 for k, v in tree.items()}, 2.0)
    torch.testing.assert_close(added["b"], noised["b"] + 1.0)


def test_mechanism_and_aggregation_helpers_match_jax():
    cfg_j = jp.PrivacyConfig(max_gradient_norm=0.5, noise_multiplier=1.3)
    cfg_t = tp.PrivacyConfig(max_gradient_norm=0.5, noise_multiplier=1.3)
    agg_j = jagg.PrivacyAwareAggregationConfig(privacy=cfg_j, min_clients=4,
                                               dropout_tolerance=0.5)
    agg_t = tagg.PrivacyAwareAggregationConfig(privacy=cfg_t, min_clients=4,
                                               dropout_tolerance=0.5)
    assert agg_t.required_clients == agg_j.required_clients == 2
    assert tagg.central_mechanism(agg_t, 8).noise_scale == \
        jagg.central_mechanism(agg_j, 8).noise_scale
    assert tp.make_privacy_mechanism("local", cfg_t, batch_size=8).batch_size == 1
    with pytest.raises(ValueError):
        tp.PrivacyMechanism(cfg_t, tp.PrivacyType.LOCAL, batch_size=2)
    for n in (1, 2):
        raised = []
        for fn, err in ((jagg.validate_private_round, JaxAggregationError),
                        (tagg.validate_private_round, AggregationError)):
            try:
                fn(agg_j if fn is jagg.validate_private_round else agg_t, n)
            except err:
                raised.append(True)
            else:
                raised.append(False)
        assert raised[0] == raised[1]
    ja, ta = jp.RDPAccountant(), tp.RDPAccountant()
    jagg.record_central_privacy(ja, agg_j, num_rounds=3, sampling_rate=0.1)
    tagg.record_central_privacy(ta, agg_t, num_rounds=3, sampling_rate=0.1)
    assert ta.get_privacy_spent(1e-5).to_dict() == ja.get_privacy_spent(1e-5).to_dict()
    w = np.asarray([1.0, 2.0, 0.0, 3.0], np.float32)
    e = np.asarray([0.5, 1.0, 2.0, 0.1], np.float32)
    np.testing.assert_allclose(
        tagg.epsilon_adjusted_weights(torch.from_numpy(w), torch.from_numpy(e)).numpy(),
        np.asarray(jagg.epsilon_adjusted_weights(jnp.asarray(w), jnp.asarray(e))), rtol=1e-6)
    assert not tagg.epsilon_adjusted_weights(torch.zeros(3), torch.zeros(3)).any()


def test_privatize_stacked_updates_clips_each_row_then_noises():
    cfg = tp.PrivacyConfig(max_gradient_norm=1.0, noise_multiplier=1e-3)
    mech = tp.make_privacy_mechanism("central", cfg, batch_size=1)
    rng = np.random.default_rng(0)
    stacked = {"a": torch.from_numpy(rng.normal(size=(3, 4, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))}
    stacked["a"][2] *= 1e-2  # client 2 under the bound: not clipped
    stacked["b"][2] *= 1e-2
    out = tp.privatize_stacked_updates(torch.Generator().manual_seed(1), stacked, mech)
    flat_in = torch.cat([stacked["a"].reshape(3, -1), stacked["b"]], 1)
    flat_out = torch.cat([out["a"].reshape(3, -1), out["b"]], 1)
    norms = torch.linalg.vector_norm(flat_out, dim=1)
    torch.testing.assert_close(norms[:2], torch.ones(2), atol=0.02, rtol=0)
    torch.testing.assert_close(flat_out[2], flat_in[2], atol=0.01, rtol=0)
    got = tagg.apply_central_privacy(torch.Generator().manual_seed(1), stacked,
                                     tagg.PrivacyAwareAggregationConfig(privacy=cfg))
    assert got["a"].shape == (3, 4, 5)


def test_jax_unaffected():
    assert jax.default_backend() == "cpu"
