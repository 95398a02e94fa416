"""Port kernels B1 (weighted reduce), B2 (masked, sanitized reduce) and B3 (row
norms), and the central-DP clipped mean built on B3 and B1: the plain versions against
the JAX package's Pallas kernels run in interpret mode, on the CPU.

Tolerance rtol 1e-5 / atol 1e-6: float32 sums over at most a few thousand terms,
taken in another order than the Pallas interpreter's dot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.ops import masked_weighted_mean_flat as jax_masked_weighted_mean_flat
from nanofed_tpu.ops import row_sq_norms as jax_row_sq_norms
from nanofed_tpu.ops.dp_reduce import central_dp_reduce_stacked as jax_central_dp_reduce_stacked
from nanofed_tpu.ops.dp_reduce import dp_clipped_mean_flat as jax_dp_clipped_mean_flat
from nanofed_tpu.ops import weighted_mean_flat as jax_weighted_mean_flat
from nanofed_tpu.ops import weighted_mean_tree as jax_weighted_mean_tree
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.parallel.round_step import client_deltas

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(1, 1000), (7, 1000), (7, 1537), (3, 1)]


def _inputs(c, p, seed=0):
    rng = np.random.default_rng(seed + 31 * c + p)
    x = rng.normal(size=(c, p)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32)
    return x, w


def _jax_wmean(x, w, denom=None):
    d = None if denom is None else jnp.float32(denom)
    return np.asarray(
        jax_weighted_mean_flat(jnp.asarray(x), jnp.asarray(w), interpret=True, denom=d)
    )


@pytest.mark.parametrize("c,p", SHAPES)
def test_weighted_mean_flat_matches_pallas(c, p):
    x, w = _inputs(c, p)
    got = ops.weighted_mean_flat(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), _jax_wmean(x, w), **TOL)


@pytest.mark.parametrize(
    "case", ["zero_weights", "all_zero_weights", "explicit_denom", "explicit_denom_tensor"]
)
def test_weighted_mean_flat_weight_cases_match_pallas(case):
    x, w = _inputs(7, 1537, seed=1)
    denom = None
    if case == "zero_weights":
        w[[0, 3, 6]] = 0.0
    elif case == "all_zero_weights":
        w[:] = 0.0
    else:
        denom = 11.5
    tdenom = torch.tensor(denom) if case == "explicit_denom_tensor" else denom
    got = ops.weighted_mean_flat(torch.from_numpy(x), torch.from_numpy(w), denom=tdenom)
    np.testing.assert_allclose(got.numpy(), _jax_wmean(x, w, denom), **TOL)
    if case == "all_zero_weights":
        assert not got.any()


@pytest.mark.parametrize("c,p", SHAPES)
def test_weighted_sum_into_accumulates_in_place(c, p):
    x, w = _inputs(c, p, seed=2)
    acc0 = np.random.default_rng(3).normal(size=(p,)).astype(np.float32)
    acc = torch.from_numpy(acc0.copy())
    out = ops.weighted_sum_into(acc, torch.from_numpy(x), torch.from_numpy(w))
    assert out is acc
    np.testing.assert_allclose(acc.numpy(), acc0 + w @ x, **TOL)


@pytest.mark.parametrize("c,p", SHAPES)
def test_row_sq_norms_matches_pallas(c, p):
    x, _ = _inputs(c, p, seed=4)
    want = np.asarray(jax_row_sq_norms(jnp.asarray(x), interpret=True))
    got = ops.row_sq_norms(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_weighted_mean_tree_matches_pallas():
    rng = np.random.default_rng(5)
    stacked = {"a": rng.normal(size=(3, 5, 3)), "b": rng.normal(size=(3, 17))}
    stacked = {k: v.astype(np.float32) for k, v in stacked.items()}
    w = np.asarray([1.0, 2.0, 3.0], np.float32)
    want = jax_weighted_mean_tree({k: jnp.asarray(v) for k, v in stacked.items()},
                                  jnp.asarray(w), interpret=True)
    got = ops.weighted_mean_tree({k: torch.from_numpy(v) for k, v in stacked.items()},
                                 torch.from_numpy(w))
    for name in stacked:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL)


def test_padded_row_stride_matches_contiguous():
    """The round hands the kernels a [k, P] view whose rows are padded to a multiple
    of 4 floats; the result must not depend on the padding."""
    x, w = _inputs(5, 1537, seed=6)
    gp = torch.zeros(1537)
    strided = client_deltas({"v": torch.from_numpy(x)}, gp)
    assert strided.stride() == (1540, 1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    torch.testing.assert_close(ops.weighted_mean_flat(strided, wt), ops.weighted_mean_flat(xt, wt))
    torch.testing.assert_close(ops.row_sq_norms(strided), ops.row_sq_norms(xt))


def _poisoned(c, p, seed):
    """Rows holding NaN, +inf and -inf, as a diverged client's delta does."""
    x, w = _inputs(c, p, seed=seed)
    x[0, min(3, p - 1)] = np.nan
    x[c // 2, p // 2] = np.inf
    x[-1, -1] = -np.inf
    return x, w


B2_CASES = {
    "random_bool": lambda rng, c: rng.random(c) > 0.4,
    "random_float": lambda rng, c: (rng.random(c) > 0.4).astype(np.float32),
    "all_valid": lambda rng, c: np.ones(c, bool),
    "all_invalid": lambda rng, c: np.zeros(c, bool),
    "zero_weights": lambda rng, c: np.ones(c, np.float32),
}


@pytest.mark.parametrize("case", list(B2_CASES))
@pytest.mark.parametrize("c,p", [(1, 1000), (7, 1537), (5, 1)])
def test_masked_weighted_mean_flat_matches_pallas(c, p, case):
    x, w = _poisoned(c, p, seed=7)
    rng = np.random.default_rng(c + p)
    valid = B2_CASES[case](rng, c)
    if case == "zero_weights":
        w[::2] = 0.0
    want = np.asarray(jax_masked_weighted_mean_flat(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(valid), interpret=True))
    got = ops.masked_weighted_mean_flat(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(valid))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case == "all_invalid":
        assert not got.any()


def test_masked_weighted_mean_flat_padded_rows_and_bad_valid():
    x, w = _poisoned(5, 1537, seed=8)
    valid = torch.tensor([True, False, True, True, False])
    strided = client_deltas({"v": torch.from_numpy(x)}, torch.zeros(1537))
    wt = torch.from_numpy(w)
    torch.testing.assert_close(ops.masked_weighted_mean_flat(strided, wt, valid),
                               ops.masked_weighted_mean_flat(torch.from_numpy(x), wt, valid))
    with pytest.raises(ValueError, match="valid"):
        ops.masked_weighted_mean_flat(strided, wt, valid[:4])


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_dp_clipped_mean_matches_pallas(clip):
    x, w = _inputs(7, 1537, seed=9)
    w[2] = 0.0
    want = np.asarray(jax_dp_clipped_mean_flat(jnp.asarray(x), jnp.asarray(w), clip,
                                               interpret=True))
    got = ops.dp_clipped_mean_flat(torch.from_numpy(x), torch.from_numpy(w), clip)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    stacked = {"a": x[:, :1000].reshape(7, 10, 100), "b": x[:, 1000:]}
    want_tree = jax_central_dp_reduce_stacked(
        {k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(w), clip, interpret=True)
    got_tree = ops.central_dp_reduce_stacked(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in stacked.items()},
        torch.from_numpy(w), clip)
    for k in stacked:
        np.testing.assert_allclose(got_tree[k].numpy(), np.asarray(want_tree[k]), **TOL)


def test_cpu_tensors_never_count_a_launch():
    before = ops.launch_counts()
    x, w = _inputs(4, 100)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ops.weighted_mean_flat(xt, wt)
    ops.weighted_sum_into(torch.zeros(100), xt, wt)
    ops.row_sq_norms(xt)
    ops.masked_weighted_mean_flat(xt, wt, torch.ones(4, dtype=torch.bool))
    ops.dp_clipped_mean_flat(xt, wt, 1.0)
    assert ops.launch_counts() == before


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: ops.weighted_mean_flat(torch.zeros(4, 8, dtype=torch.float64), torch.ones(4)),
         TypeError),
        (lambda: ops.weighted_mean_flat(torch.zeros(4, 8), torch.ones(3)), ValueError),
        (lambda: ops.row_sq_norms(torch.zeros(8, 4).t()), ValueError),
        (lambda: ops.weighted_sum_into(torch.zeros(7), torch.zeros(4, 8), torch.ones(4)),
         ValueError),
    ],
    ids=["dtype", "weights_shape", "column_major", "acc_shape"],
)
def test_wrappers_reject_bad_inputs(call, err):
    with pytest.raises(err):
        call()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On a GPU: B1 (both forms), B2 and B3 launch their CUDA kernels and agree with
    the plain versions; chip_smoke.py runs the same checks at the round's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the hand-written B1/B2/B3 kernels against their "
                    "plain versions")
    x, w = _inputs(7, 1537)
    xt, wt = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    before = ops.launch_counts()
    torch.testing.assert_close(ops.weighted_mean_flat(xt, wt),
                               ops.weighted_mean_flat_plain(xt, wt), **TOL)
    acc = torch.zeros(1537, device="cuda")
    torch.testing.assert_close(ops.weighted_sum_into(acc, xt, wt),
                               ops.weighted_sum_into_plain(torch.zeros_like(acc), xt, wt), **TOL)
    torch.testing.assert_close(ops.row_sq_norms(xt), ops.row_sq_norms_plain(xt), **TOL)
    xp, _ = _poisoned(7, 1537, seed=10)
    xp, valid = torch.from_numpy(xp).cuda(), torch.arange(7, device="cuda") % 3 > 0
    torch.testing.assert_close(ops.masked_weighted_mean_flat(xp, wt, valid),
                               ops.masked_weighted_mean_flat_plain(xp, wt, valid), **TOL)
    after = ops.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)
