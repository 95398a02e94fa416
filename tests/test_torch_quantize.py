"""Port kernels B5 (quantize), B6 (dequantize) and B7 (Philox mask add): the plain
versions against the JAX package on the CPU.

B5 and B6 are held bit for bit to the Pallas kernels run in interpret mode, and B6
after a modular sum to ``np.float32(secure_agg.dequantize(total))``.  B7's plain
version is an explicit Philox4x64-10; it is held bit for bit to the JAX package's
host mask stream (``expand_mask(seed, n, "host")``, numpy's ``np.random.Philox``),
which is the stream it is defined to reproduce.  (The JAX interpret-mode ``add_mask``
draws threefry bits, another stream, so it is no oracle here.)  Every comparison is
exact: integer and power-of-two arithmetic leaves no tolerance to state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.ops import dequantize_u32 as jax_dequantize_u32
from nanofed_tpu.ops import quantize_u32 as jax_quantize_u32
from nanofed_tpu.security import secure_agg as jax_sa
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.ops import quantize as q

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
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_quantize_kernels_match_plain_versions_on_the_card():
    """On a GPU: B5, B6 and B7 launch their CUDA kernels and agree bit for bit with the
    plain versions on ragged, unaligned vectors; chip_smoke.py runs the same checks at
    the secure round's shapes."""
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
    after = ops.launch_counts()
    assert after["quantize_u32"] == before["quantize_u32"] + 3
    assert after["add_mask"] == before["add_mask"] + 6
