"""Port kernels B5 (quantize), B6 (dequantize), B7 (Philox mask add) and B4 (the
fused int8 dequant-accumulate): the plain versions against the JAX package on the CPU.

B4 is held to the JAX ``dequant_accumulate_flat`` run in interpret mode, at its own
test's tolerance (rtol 1e-5, atol 1e-6): on random stacks, an explicit ``denom``,
zero weights (exactly ``base``), per-leaf q8 aggregation of the port's wire payloads
against the weighted mean of the JAX ``reconstruct_q8``'d params, topk8 dense rows
and a padded row stride.

B5 and B6 are held bit for bit to the Pallas kernels run in interpret mode, and B6
after a modular sum to ``np.float32(secure_agg.dequantize(total))``.  B7's plain
version is an explicit Philox4x64-10; it is held bit for bit to the JAX package's
host mask stream (``expand_mask(seed, n, "host")``, numpy's ``np.random.Philox``),
which is the stream it is defined to reproduce, and with k seeds a call to the
sequential single-seed masks and to the signed sum of the host streams.  (The JAX
interpret-mode ``add_mask`` draws threefry bits, another stream, so it is no oracle
here.)  Every comparison is
exact: integer and power-of-two arithmetic leaves no tolerance to state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.communication import codec as jax_codec
from nanofed_tpu.ops import dequant_accumulate_flat as jax_dequant_accumulate_flat
from nanofed_tpu.ops import dequantize_u32 as jax_dequantize_u32
from nanofed_tpu.ops import quantize_u32 as jax_quantize_u32
from nanofed_tpu.security import secure_agg as jax_sa
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.communication import codec
from nanofed_tpu_torch.ops import quantize as q
from nanofed_tpu_torch.utils.trees import from_numpy_params

SIZES = [1, 3, 1_199_882]  # ragged: 1.2M (the mnist_cnn width) is 2 mod 4 and 2 mod 8


def _u32(t: torch.Tensor) -> np.ndarray:
    """A torch.uint32 tensor as a numpy uint32 array (through its int32 bits)."""
    return t.view(torch.int32).numpy().view(np.uint32)


def _t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).view(
        torch.uint32)


def _in_range(n: int, frac_bits: int, seed: int) -> np.ndarray:
    """Values inside the secure-aggregation contract, |x * 2^frac| < 2^31, with exact
    half-step ties in every other slot."""
    rng = np.random.default_rng(seed + n + frac_bits)
    x = rng.uniform(-1000.0, 1000.0, size=n).astype(np.float32)
    # Exactly k + 1/2 steps (22 significant bits, so exact in float32): half to even.
    k = rng.integers(-(1 << 20), 1 << 20, size=n)
    x[::2] = ((k + 0.5) * 2.0 ** -frac_bits).astype(np.float32)[::2]
    return x


@pytest.mark.parametrize("frac_bits", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_and_dequantize_match_pallas_bit_for_bit(n, frac_bits):
    x = _in_range(n, frac_bits, seed=0)
    want = np.asarray(jax_quantize_u32(jnp.asarray(x), frac_bits, interpret=True))
    got = ops.quantize_u32(torch.from_numpy(x), frac_bits)
    assert got.dtype == torch.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(_u32(got), want)
    back = np.asarray(jax_dequantize_u32(jnp.asarray(want), frac_bits, interpret=True))
    np.testing.assert_array_equal(ops.dequantize_u32(got, frac_bits).numpy().view(np.int32),
                                  back.view(np.int32))


def test_ties_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], dtype=torch.float32) / 256
    np.testing.assert_array_equal(_u32(ops.quantize_u32(x, 8)).view(np.int32),
                                  [0, 2, 2, 0, -2, -2])


@pytest.mark.parametrize("n", SIZES)
def test_dequantize_of_a_modular_sum_equals_host_dequantize(n):
    """Four parties' quantized updates summed modulo 2^32 (the masks' cancellation
    leaves exactly this): B6 equals float32 of the host's float64 dequantize."""
    rng = np.random.default_rng(n)
    total = np.zeros(n, np.uint32)
    for _ in range(4):
        total = total + jax_sa.quantize(rng.normal(size=n) * 50.0, 16)
    want = np.float32(jax_sa.dequantize(total, 16))
    got = ops.dequantize_u32(_t32(total), 16).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_quantize_outside_the_contract_saturates_and_zeroes_nan():
    """Outside |x * 2^frac| < 2^31 the plain version (as the kernel) saturates, and NaN
    gives 0; no JAX comparison is defined there."""
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 32768.0,
                      -32768.0, 32767.99], dtype=torch.float32)
    got = _u32(ops.quantize_u32(x, 16)).view(np.int32)
    i32 = np.iinfo(np.int32)
    np.testing.assert_array_equal(
        got, [0, i32.max, i32.min, i32.max, i32.min, i32.max, i32.min,
              int(np.float64(np.float32(32767.99)) * 65536)])


@pytest.mark.parametrize("n", SIZES)
def test_philox_stream_equals_the_host_mask_stream(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        seed = rng.bytes(32)
        want = jax_sa.expand_mask(seed, n, "host")
        key = q.seed_key(jax_sa._fold_seed_words(seed))
        np.testing.assert_array_equal(q.philox_stream_plain(key, n), want)
        zeros = torch.zeros(n, dtype=torch.int32).view(torch.uint32)
        np.testing.assert_array_equal(_u32(ops.add_mask(zeros, jax_sa._fold_seed_words(seed), 1)),
                                      want)


def test_seed_key_folds_all_128_bits_as_the_host_key():
    """The four signed folded words give the host's key ``words[:2] ^ words[2:]``
    (little-endian 64-bit halves of the 256-bit seed)."""
    seed = bytes(range(200, 232))
    words = np.frombuffer(seed, dtype="<u8")
    host = words[:2] ^ words[2:]
    assert q.seed_key(jax_sa._fold_seed_words(seed)) == (int(host[0]), int(host[1]))
    assert q.seed_key(7) == (7, 0)
    assert q.seed_key(-1) == (0xFFFFFFFF, 0)
    with pytest.raises(ValueError, match="4 words"):
        q.seed_key([1, 2, 3])


@pytest.mark.parametrize("n", SIZES)
def test_add_then_subtract_cancels_and_seeds_differ(n):
    rng = np.random.default_rng(7 + n)
    base = _t32(rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32))
    words_a = jax_sa._fold_seed_words(rng.bytes(32))
    words_b = jax_sa._fold_seed_words(rng.bytes(32))
    masked = ops.add_mask(base, words_a, 1)
    np.testing.assert_array_equal(_u32(ops.add_mask(masked, words_a, -1)), _u32(base))
    # Two parties with one seed and opposite signs: the masks cancel in the sum.
    pair = _u32(ops.add_mask(base, words_a, 1)) + _u32(ops.add_mask(base, words_a, -1))
    np.testing.assert_array_equal(pair, _u32(base) + _u32(base))
    if n > 2:
        other = _u32(ops.add_mask(base, words_b, 1))
        assert (other != _u32(masked)).mean() > 0.99


def _seed_words(rng: np.random.Generator, k: int) -> tuple[list[bytes], np.ndarray]:
    """k random 32-byte seeds and their [k, 4] folded words."""
    seeds = [rng.bytes(32) for _ in range(k)]
    return seeds, np.stack([jax_sa._fold_seed_words(b) for b in seeds])


@pytest.mark.parametrize("k", [1, 2, 7, 65])
def test_multi_key_mask_equals_the_sequential_single_key_masks(k):
    """k seeds in one ``add_mask`` (mixed signs) are bit-equal to k single-seed
    ``add_mask_plain`` calls in a row, on a ragged n."""
    rng = np.random.default_rng(100 + k)
    n = 1_027
    q0 = _t32(rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32))
    _, words = _seed_words(rng, k)
    signs = [int(s) for s in rng.choice([1, -1], k)]
    want = q0
    for w, sign in zip(words, signs):
        want = ops.add_mask_plain(want, w, sign)
    np.testing.assert_array_equal(_u32(ops.add_mask(q0, words, signs)), _u32(want))
    np.testing.assert_array_equal(_u32(ops.add_mask_plain(q0, words, signs)), _u32(want))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_multi_key_mask_equals_the_signed_sum_of_the_host_streams(k):
    """On zeros, k seeds in one launch give the signed sum (mod 2^32) of the JAX
    package's host streams ``_prg_uint32`` under the same 32-byte seeds, folded by
    ``_fold_seed_words``: the stream a mixed cohort cancels against."""
    rng = np.random.default_rng(200 + k)
    n = 4_099
    seeds, words = _seed_words(rng, k)
    signs = [int(s) for s in rng.choice([1, -1], k)]
    want = np.zeros(n, np.uint32)
    for b, sign in zip(seeds, signs):
        stream = jax_sa._prg_uint32(b, n)
        want = want + stream if sign > 0 else want - stream
    zeros = torch.zeros(n, dtype=torch.int32).view(torch.uint32)
    np.testing.assert_array_equal(_u32(ops.add_mask(zeros, words, signs)), want)


def test_a_seed_added_and_subtracted_in_one_call_returns_q():
    rng = np.random.default_rng(5)
    q0 = _t32(rng.integers(0, 1 << 32, size=333, dtype=np.uint64).astype(np.uint32))
    _, (a, b) = _seed_words(rng, 2)
    np.testing.assert_array_equal(_u32(ops.add_mask(q0, np.stack([a, b, a]), [1, 1, -1])),
                                  _u32(ops.add_mask(q0, b, 1)))
    np.testing.assert_array_equal(_u32(ops.add_mask(q0, np.stack([a, a]), [-1, 1])), _u32(q0))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [1, 7, 8, 1_027, 40_003, 1_199_882, 8 * 256 * 132 * 5 + 1])
def test_mask_grid_is_one_wave_of_equal_ranges(n, sms):
    """B7's grid: at most SMs x MASK_BLOCKS_PER_SM blocks (one wave) whose ranges of
    Philox blocks (the kernel's slab_of cut) differ by at most one and cover every
    Philox block once, each a warp's at least; at the mnist_cnn width on an H100
    SXM's 132 SMs every range fits one pass (a Philox block a thread)."""
    from nanofed_tpu_torch.ops.reduce import LaunchPlan, plan_slabs

    grid = q.mask_grid(n, sms)
    philox = -(-n // 8)
    assert 1 <= grid <= sms * q.MASK_BLOCKS_PER_SM
    ranges = plan_slabs(LaunchPlan(grid, philox // grid, 0, 0, 0), philox, 1)
    assert ranges[0][0] == 0 and ranges[-1][1] == philox
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [stop - start for start, stop in ranges]
    assert max(sizes) - min(sizes) <= 1 and (grid == 1 or min(sizes) >= q.MASK_MIN_SPAN)
    if n == 1_199_882 and sms == 132:
        assert grid == 660 and max(sizes) <= q.MASK_THREADS


U32_4 = torch.zeros(4, dtype=torch.int32).view(torch.uint32)


@pytest.mark.parametrize(
    "seeds,signs",
    [
        (np.zeros((0, 4), np.int64), []),  # k = 0
        (np.zeros((2, 4), np.int64), [1]),  # fewer signs than seeds
        (np.zeros((2, 4), np.int64), 1),  # one sign for several seeds
        (np.zeros((2, 4), np.int64), [1, 0]),  # a sign that is not +-1
        (np.zeros((2, 2, 4), np.int64), [1, 1]),  # not [k, 4]
    ],
    ids=["no_seeds", "short_signs", "scalar_sign", "zero_sign", "three_dims"],
)
def test_multi_key_mask_rejects_bad_seed_tables(seeds, signs):
    for fn in (ops.add_mask, ops.add_mask_plain):
        with pytest.raises(ValueError):
            fn(U32_4, seeds, signs)


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: ops.quantize_u32(torch.zeros(4, dtype=torch.float64)), TypeError),
        (lambda: ops.quantize_u32(torch.zeros(2, 2)), ValueError),
        (lambda: ops.quantize_u32(torch.zeros(4), frac_bits=32), ValueError),
        (lambda: ops.dequantize_u32(torch.zeros(4, dtype=torch.int32)), TypeError),
        (lambda: ops.add_mask(torch.zeros(4, dtype=torch.int32).view(torch.uint32), 1, 0),
         ValueError),
        (lambda: ops.add_mask(torch.zeros(8, dtype=torch.int32).view(torch.uint32)[::2], 1, 1),
         ValueError),
    ],
    ids=["quantize_dtype", "quantize_2d", "frac_bits", "dequantize_dtype", "sign", "strided"],
)
def test_wrappers_reject_bad_inputs(call, err):
    with pytest.raises(err):
        call()


def test_cpu_tensors_never_count_a_launch():
    before = ops.launch_counts()
    quantized = ops.quantize_u32(torch.ones(10))
    ops.dequantize_u32(quantized)
    ops.add_mask(quantized, 3, -1)
    ops.dequant_accumulate_flat(torch.ones(2, 5, dtype=torch.int8), torch.ones(2),
                                torch.ones(2), torch.zeros(5))
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# B4: the fused int8 dequant-accumulate
# ---------------------------------------------------------------------------

B4_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package's own test's tolerance


def _b4_jax(q8, scales, weights, base, denom=None):
    return np.asarray(jax_dequant_accumulate_flat(
        jnp.asarray(q8), jnp.asarray(scales), jnp.asarray(weights), jnp.asarray(base),
        denom=None if denom is None else jnp.float32(denom), interpret=True))


def _b4_port(q8, scales, weights, base, denom=None):
    return ops.dequant_accumulate_flat(
        torch.from_numpy(q8), torch.from_numpy(scales), torch.from_numpy(weights),
        torch.from_numpy(base), denom).numpy()


@pytest.mark.parametrize("c,p,low", [(9, 1333, -127), (9, 1333, -128), (1, 1, -128),
                                     (33, 517, -128)])
def test_dequant_accumulate_matches_pallas(c, p, low):
    rng = np.random.default_rng(c + p)
    q8 = rng.integers(low, 128, size=(c, p), dtype=np.int8)
    scales = rng.uniform(1e-4, 1e-2, size=c).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    base = rng.normal(size=p).astype(np.float32)
    np.testing.assert_allclose(_b4_port(q8, scales, weights, base),
                               _b4_jax(q8, scales, weights, base), **B4_TOL)


def test_dequant_accumulate_explicit_denominator():
    rng = np.random.default_rng(1)
    c, p = 4, 640
    q8 = rng.integers(-127, 128, size=(c, p), dtype=np.int8)
    scales = np.full(c, 1e-3, np.float32)
    discounts = np.asarray([1.0, 0.7071, 0.5774, 0.5], np.float32)
    base = np.zeros(p, np.float32)
    got = _b4_port(q8, scales, discounts, base, denom=float(c))
    np.testing.assert_allclose(got, _b4_jax(q8, scales, discounts, base, denom=float(c)),
                               **B4_TOL)
    np.testing.assert_allclose(got, (discounts / c) @ (q8.astype(np.float32) * scales[:, None]),
                               **B4_TOL)
    tensor_denom = ops.dequant_accumulate_flat(
        torch.from_numpy(q8), torch.from_numpy(scales), torch.from_numpy(discounts),
        torch.from_numpy(base), torch.tensor(float(c)))
    np.testing.assert_array_equal(tensor_denom.numpy(), got)


def test_dequant_accumulate_zero_weights_return_base_exactly():
    c, p = 3, 512
    q8 = np.full((c, p), -128, np.int8)
    base = np.random.default_rng(2).normal(size=p).astype(np.float32)
    got = _b4_port(q8, np.ones(c, np.float32), np.zeros(c, np.float32), base)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(_b4_jax(q8, np.ones(c, np.float32), np.zeros(c, np.float32),
                                       base), base, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int32])
def test_dequant_accumulate_rejects_non_int8(dtype):
    with pytest.raises(TypeError, match="int8"):
        ops.dequant_accumulate_flat(torch.zeros(2, 128, dtype=dtype), torch.ones(2),
                                    torch.ones(2), torch.zeros(128))
    with pytest.raises(TypeError, match="int8"):
        ops.dequant_accumulate_flat_plain(torch.zeros(2, 128, dtype=dtype), torch.ones(2),
                                          torch.ones(2), torch.zeros(128))
    with pytest.raises(TypeError, match="int8"):
        jax_dequant_accumulate_flat(jnp.zeros((2, 128), jnp.float32), jnp.ones(2),
                                    jnp.ones(2), jnp.zeros(128), interpret=True)


def test_dequant_accumulate_padded_row_stride():
    """A [C, P] view of a [C, P + pad] buffer (the callers' 16-byte row stride)."""
    rng = np.random.default_rng(3)
    c, p = 7, 1_001
    buf = rng.integers(-128, 128, size=(c, 1_008), dtype=np.int8)
    q_view = torch.from_numpy(buf)[:, :p]
    assert q_view.stride(0) == 1_008
    scales = rng.uniform(1e-4, 1e-2, size=c).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    base = rng.normal(size=p).astype(np.float32)
    got = ops.dequant_accumulate_flat(q_view, torch.from_numpy(scales),
                                      torch.from_numpy(weights), torch.from_numpy(base))
    np.testing.assert_allclose(got.numpy(), _b4_jax(np.ascontiguousarray(buf[:, :p]), scales,
                                                    weights, base), **B4_TOL)
    with pytest.raises(ValueError, match="contiguous"):
        ops.dequant_accumulate_flat(torch.from_numpy(buf)[:, ::2], torch.from_numpy(scales),
                                    torch.from_numpy(weights), torch.from_numpy(base[:504]))


def test_q8_aggregation_of_port_payloads_equals_the_jax_reconstructions():
    """Encode each client's delta with the port's ``encode_delta_q8``, aggregate per
    leaf with B4 (the wire format's scales are per leaf), and hold the result to the
    weighted mean of the JAX package's ``reconstruct_q8``'d params."""
    import io

    rng = np.random.default_rng(2)
    c = 5
    base_tree = {"w": rng.normal(size=(13, 7)).astype(np.float32),
                 "b": rng.normal(size=(19,)).astype(np.float32)}
    weights = rng.uniform(1.0, 3.0, size=c).astype(np.float32)
    leaves = {name: [] for name in base_tree}
    scales = {name: [] for name in base_tree}
    reconstructed = []
    for i in range(c):
        delta = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1
                 for k, v in base_tree.items()}
        payload = codec.encode_delta_q8(from_numpy_params(delta, device="cpu"), seed=100 + i)
        full = jax_codec.reconstruct_q8(base_tree, payload)
        reconstructed.append(np.concatenate([np.ravel(full[k]) for k in base_tree]))
        with np.load(io.BytesIO(payload)) as wire:
            for name in base_tree:
                leaves[name].append(np.ravel(wire[name + codec.Q8_QUANT_TAG]))
                scales[name].append(np.float32(wire[name + codec.Q8_SCALE_TAG]))
    fused = np.concatenate([
        _b4_port(np.stack(leaves[name]), np.asarray(scales[name], np.float32), weights,
                 np.ravel(base_tree[name]))
        for name in base_tree
    ])
    np.testing.assert_allclose(fused, (weights / weights.sum()) @ np.stack(reconstructed),
                               rtol=1e-5, atol=1e-5)
    jax_fused = np.concatenate([
        _b4_jax(np.stack(leaves[name]), np.asarray(scales[name], np.float32), weights,
                np.ravel(base_tree[name]))
        for name in base_tree
    ])
    np.testing.assert_allclose(fused, jax_fused, **B4_TOL)


def test_topk8_dense_rows_aggregate():
    """topk8 decodes to dense rows (zeros off the shipped coordinates); re-quantized
    per row (scale absmax/127), B4 aggregates them as the JAX kernel does."""
    rng = np.random.default_rng(3)
    like = {"w": torch.zeros(40)}
    dense = []
    for i in range(2):
        delta = {"w": torch.from_numpy(rng.normal(size=40).astype(np.float32))}
        payload = codec.encode_delta_topk8(delta, fraction=0.2, seed=7 + i)
        dense.append(codec.decode_delta_topk8(payload, like=like)["w"].numpy())
    q_rows, row_scales = [], []
    for row in dense:
        s = max(float(np.max(np.abs(row))), 1e-12) / 127.0
        q_rows.append(np.round(row / s).astype(np.int8))
        row_scales.append(s)
    q8, sc = np.stack(q_rows), np.asarray(row_scales, np.float32)
    weights, base = np.ones(2, np.float32), np.zeros(40, np.float32)
    got = _b4_port(q8, sc, weights, base)
    np.testing.assert_allclose(got, _b4_jax(q8, sc, weights, base), **B4_TOL)
    np.testing.assert_allclose(got, np.mean(np.stack(dense), axis=0), atol=1e-2)


@pytest.mark.cuda
def test_dequant_accumulate_kernel_matches_plain_version_on_the_card():
    """On a GPU: B4 launches and agrees with its plain version for every int8 load
    width and on the bulk-copy ring with the plan it launched; chip_smoke.py runs the
    full case list and the timing."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the hand-written B4 kernel against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = ops.launch_counts()["dequant_accumulate_flat"]
    for stride, offset in ((1008, 0), (1000, 8), (1004, 4), (1002, 2), (1001, 1)):
        buf = torch.randint(-128, 128, (9 * stride + offset,), generator=gen, device="cuda",
                            dtype=torch.int8)
        q8 = buf[offset:].view(9, stride)[:, :997]
        s, w = torch.rand(9, device="cuda") * 1e-2, torch.rand(9, device="cuda") + 0.5
        base = torch.randn(997, device="cuda")
        torch.testing.assert_close(ops.dequant_accumulate_flat(q8, s, w, base),
                                   ops.dequant_accumulate_flat_plain(q8, s, w, base),
                                   rtol=1e-5, atol=1e-6)
    # The bulk-copy ring: rows padded to 16 bytes, P = 10 mod 16 as at mnist_cnn's width,
    # wide enough for several slabs.
    from nanofed_tpu_torch.ops.reduce import plan_for

    c, p = 33, 16 * 300 * 40 + 10
    buf = torch.randint(-128, 128, (c, -(-p // 16) * 16), generator=gen, device="cuda",
                        dtype=torch.int8)
    q8 = buf[:, :p]
    vec, plan = plan_for(q8, buf.stride(0))
    assert vec == 16 and plan.stages >= 2 and plan.blocks > 1
    s, w = torch.rand(c, device="cuda") * 1e-2, torch.rand(c, device="cuda") + 0.5
    base = torch.randn(p, device="cuda")
    torch.testing.assert_close(ops.dequant_accumulate_flat(q8, s, w, base),
                               ops.dequant_accumulate_flat_plain(q8, s, w, base),
                               rtol=1e-5, atol=1e-4)
    assert ops.launch_counts()["dequant_accumulate_flat"] == before + 6


@pytest.mark.cuda
def test_quantize_kernels_match_plain_versions_on_the_card():
    """On a GPU: B5, B6 and B7 launch their CUDA kernels and agree bit for bit with the
    plain versions on ragged, unaligned vectors, B7 also with 20 seeds a launch;
    chip_smoke.py runs the same checks at the secure round's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the hand-written B5/B6/B7 kernels against their "
                    "plain versions")
    x = torch.from_numpy(_in_range(1027, 16, seed=1))
    before = ops.launch_counts()
    for start in (0, 1, 3):
        xc = x.cuda()[start:]
        got = ops.quantize_u32(xc, 16)
        np.testing.assert_array_equal(_u32(got.cpu()), _u32(ops.quantize_u32_plain(xc, 16).cpu()))
        np.testing.assert_array_equal(ops.dequantize_u32(got, 16).cpu().numpy(),
                                      ops.dequantize_u32_plain(got, 16).cpu().numpy())
        for sign in (1, -1):
            np.testing.assert_array_equal(_u32(ops.add_mask(got, [1, -2, 3, -4], sign).cpu()),
                                          _u32(ops.add_mask_plain(got, [1, -2, 3, -4], sign).cpu()))
        # 20 seeds in one launch: more than the kernel takes in its parameters.
        words = np.arange(80).reshape(20, 4) * 977 - 5000
        signs = [1, -1] * 10
        np.testing.assert_array_equal(_u32(ops.add_mask(got, words, signs).cpu()),
                                      _u32(ops.add_mask_plain(got, words, signs).cpu()))
    after = ops.launch_counts()
    assert after["quantize_u32"] == before["quantize_u32"] + 3
    assert after["add_mask"] == before["add_mask"] + 9
