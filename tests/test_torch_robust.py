"""Port robust aggregation against ``nanofed_tpu.aggregation.robust`` on the CPU:
trimmed mean, coordinate median and Multi-Krum with participation masks, including
rounds below each method's floor (``ok`` false, zero aggregate).

The port takes the round's flat ``[C, P]`` layout (leaf segments in ravel order); the
JAX functions take the stacked pytree.  Tolerance 1e-5: sorts are exact, the kept
ranks are summed in another order, and Multi-Krum's Gram matrices are float32
products summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.aggregation import robust as jr
from nanofed_tpu_torch.aggregation import robust as tr
from nanofed_tpu_torch.utils.trees import ravel, ravel_stacked

TOL = dict(rtol=1e-5, atol=1e-5)
C = 9


def _stack(seed):
    rng = np.random.default_rng(seed)
    stacked = {
        "a": rng.normal(size=(C, 4, 3)).astype(np.float32),
        "b": rng.normal(size=(C, 25)).astype(np.float32),
    }
    stacked["a"][3] += 40.0  # a Byzantine client far from the others
    stacked["b"][6, :5] -= 30.0
    return stacked


MASKS = {
    "all": np.ones(C, np.float32),
    "partial": np.asarray([1, 1, 0, 1, 1, 1, 1, 0, 1], np.float32),
    "even": np.asarray([1, 1, 0, 1, 1, 1, 1, 1, 1], np.float32),
    "below_floor": np.asarray([1, 1, 0, 0, 0, 0, 0, 0, 0], np.float32),
}
METHODS = {
    "trimmed_mean": (lambda s, m: jr.trimmed_mean(s, m, 2),
                     lambda x, m, like: tr.trimmed_mean(x, m, 2, like)),
    "median": (jr.coordinate_median, tr.coordinate_median),
    "multi_krum": (lambda s, m: jr.multi_krum(s, m, 1),
                   lambda x, m, like: tr.multi_krum(x, m, 1, like)),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("method", list(METHODS))
def test_robust_estimators_match_jax(method, mask):
    stacked = _stack(1)
    part = MASKS[mask]
    jax_fn, port_fn = METHODS[method]
    want, ok_w, kept_w = jax_fn({k: jnp.asarray(v) for k, v in stacked.items()},
                                jnp.asarray(part))
    tstack = {k: torch.from_numpy(v) for k, v in stacked.items()}
    like = {k: v[0] for k, v in tstack.items()}
    got, ok, kept = port_fn(ravel_stacked(tstack), torch.from_numpy(part), like)
    want_flat = ravel({k: torch.from_numpy(np.array(v)) for k, v in want.items()})
    np.testing.assert_allclose(got.numpy(), want_flat.numpy(), **TOL)
    assert bool(ok) == bool(ok_w)
    assert float(kept) == float(kept_w)
    if mask == "below_floor":
        assert not bool(ok) and not got.any()


def test_multi_krum_drops_the_byzantine_clients():
    stacked = {k: torch.from_numpy(v) for k, v in _stack(2).items()}
    like = {k: v[0] for k, v in stacked.items()}
    x = ravel_stacked(stacked)
    agg, ok, kept = tr.multi_krum(x, torch.ones(C), 2, like)
    honest = [i for i in range(C) if i not in (3, 6)]
    # m - f = 7 selected = exactly the honest clients.
    torch.testing.assert_close(agg, x[honest].mean(0), rtol=1e-5, atol=1e-5)
    assert bool(ok) and float(kept) == 7.0


def test_robust_config_checks_and_floors_match_jax():
    for kwargs in (dict(method="mean"), dict(trim_k=0), dict(method="multi_krum", trim_k=0)):
        with pytest.raises(ValueError) as want:
            jr.RobustAggregationConfig(**kwargs)
        with pytest.raises(ValueError) as got:
            tr.RobustAggregationConfig(**kwargs)
        assert str(got.value) == str(want.value)
    tr.RobustAggregationConfig(method="median", trim_k=0)
    for method in ("trimmed_mean", "median", "multi_krum"):
        for k in (1, 3):
            cfg_t = tr.RobustAggregationConfig(trim_k=k, method=method)
            cfg_j = jr.RobustAggregationConfig(trim_k=k, method=method)
            assert tr.robust_floor(cfg_t) == jr.robust_floor(cfg_j)
            x = torch.ones(C, 4)
            got = tr.robust_aggregate(cfg_t, x, torch.ones(C), {"v": torch.zeros(4)})[0]
            torch.testing.assert_close(got, torch.ones(4))
