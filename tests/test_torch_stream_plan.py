"""The launch plan of kernels B5 and B6 (``nanofed_tpu_torch/ops/quantize.py``
``quantize_u32`` and ``dequantize_u32``) on the CPU: the one-wave grid the host hands
``nf_quantize_u32`` / ``nf_dequantize_u32`` must cover every word once, in slabs of
whole units (16 bytes, or single words where a pointer is not 16-byte aligned) that
differ by at most one unit, the last ``n % 4`` words going to the last block; it must
be one wave of the card (the kernel holds its words in registers and uses no shared
memory).  A plan the C side would refuse raises on the host.  (The kernels themselves
run only on the card: ``chip_smoke.py`` holds them bit for bit against their plain
versions there.)
"""

import pytest

from nanofed_tpu_torch.ops import quantize as qz
from nanofed_tpu_torch.ops.reduce import MAX_THREADS_PER_SM, LaunchPlan, plan_slabs

P_MNIST = 1_199_882
UNIT = qz.STREAM_UNIT_WORDS
# Units a block covers in one round of its threads' registers (csrc/quantize.cu's
# kRegUnits x kThreads; kRegWords x kThreads words on the single-word path, the same n).
ROUND_UNITS = 8 * 256


def stream_slabs(plan: qz.StreamPlan, n: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` words of each block of ``plan``, as the kernel's ``slab_of``
    cuts the whole units, the last block also taking the ``n % vec`` words after them."""
    units = n // plan.vec
    slabs = plan_slabs(LaunchPlan(plan.blocks, plan.slab, 0, 0, 0), units, 1) if units else [(0, 0)]
    words = [(start * plan.vec, stop * plan.vec) for start, stop in slabs]
    words[-1] = (words[-1][0], n)
    return words


def _sizes(sms: int) -> list[int]:
    """n = 1-5; around the largest grid of minimum slabs (sms x 2 blocks of
    STREAM_MIN_SLAB units); around the slab boundary of P = 1,199,882's plan (its
    blocks x slab whole units); around slabs of one register round; and
    P = 1,199,882."""
    blocks = sms * qz.STREAM_BLOCKS_PER_SM
    plan = qz.stream_plan(P_MNIST, sms)
    edges = (blocks * qz.STREAM_MIN_SLAB * UNIT, plan.blocks * plan.slab * UNIT,
             blocks * ROUND_UNITS * UNIT)
    return [1, 2, 3, 4, 5, *[e + d for e in edges for d in (-1, 0, 1)], P_MNIST]


CASES = [(sms, n) for sms in (132, 114) for n in _sizes(sms)]


@pytest.mark.parametrize("vec", [UNIT, 1], ids=["aligned", "words"])
@pytest.mark.parametrize("sms,n", CASES)
def test_stream_plan_covers_every_word_once_in_one_wave(sms, n, vec):
    plan = qz.stream_plan(n, sms, vec)
    qz.check_stream_plan(plan, n)  # the C side runs it
    assert plan.vec == vec
    slabs = stream_slabs(plan, n)
    assert len(slabs) == plan.blocks
    # Every word in exactly one slab: contiguous, non-empty, from 0 to n.
    assert slabs[0][0] == 0 and slabs[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert all(stop > start for start, stop in slabs)
    # Slabs of whole units, equal to within one: `slab` or `slab + 1` units, the last
    # block also taking the n % vec words after the last whole unit.
    assert all(start % vec == 0 for start, _ in slabs)
    whole = n // vec * vec
    units = [(min(stop, whole) - start) // vec for start, stop in slabs]
    assert max(units) - min(units) <= 1
    assert all(u in (plan.slab, plan.slab + 1) for u in units)
    assert slabs[-1][1] - max(slabs[-1][0], whole) == n % vec
    # At least STREAM_MIN_SLAB units a block, unless there is only one block.
    assert plan.blocks == 1 or plan.slab >= qz.STREAM_MIN_SLAB
    # One wave: no more blocks than the card holds.
    assert plan.blocks <= sms * qz.STREAM_BLOCKS_PER_SM
    assert qz.STREAM_BLOCKS_PER_SM * qz.STREAM_THREADS <= MAX_THREADS_PER_SM


def test_mnist_plan():
    """B5/B6 at mnist_cnn's width on an H100's 132 SMs: 299,970 whole units and 2 words,
    264 slabs (2 an SM) of 1136 or 1137 units, single words when a pointer is not
    16-byte aligned."""
    assert qz.stream_plan(P_MNIST, 132) == qz.StreamPlan(264, 1136, 4)
    assert qz.stream_plan(P_MNIST, 132, 1) == qz.StreamPlan(264, 4545, 1)
    slabs = stream_slabs(qz.stream_plan(P_MNIST, 132), P_MNIST)
    assert {stop - start for start, stop in slabs[:-1]} == {1136 * 4, 1137 * 4}
    assert slabs[-1] == (P_MNIST - 1137 * 4 - 2, P_MNIST)  # a wide slab and the 2 words


def test_wide_vectors_keep_one_wave():
    """Past slabs of one register round the grid stays 2 blocks an SM: the slabs widen
    and each thread loops over its rounds."""
    n = 3 * 132 * qz.STREAM_BLOCKS_PER_SM * ROUND_UNITS * UNIT + 7
    plan = qz.stream_plan(n, 132)
    assert plan == qz.StreamPlan(264, n // 4 // 264, 4)
    assert plan.slab > 2 * ROUND_UNITS


GOOD = dict(n=1_000_003)  # 250,000 units and 3 words


@pytest.mark.parametrize(
    "plan,n",
    [
        (qz.StreamPlan(0, 0, 4), 1_000_003),  # no blocks
        (qz.StreamPlan(250_001, 0, 4), 1_000_003),  # more blocks than units
        (qz.StreamPlan(2, 0, 4), 3),  # two blocks over no whole unit
        (qz.StreamPlan(264, 945, 4), 1_000_003),  # slab not the cut's
        (qz.StreamPlan(264, 946, 1), 1_000_003),  # the units' slab on the words' path
        (qz.StreamPlan(264, 946, 3), 1_000_003),  # vec 3
        (qz.StreamPlan(1, 0, 4), -1),  # negative n
    ],
    ids=["no_blocks", "too_many_blocks", "blocks_without_units", "wrong_slab",
         "slab_of_another_vec", "vec3", "negative_n"],
)
def test_plans_the_kernel_refuses_raise_on_the_host(plan, n):
    with pytest.raises(ValueError, match="cannot run"):
        qz.check_stream_plan(plan, n)


def test_the_refusal_list_starts_from_a_plan_the_kernel_runs():
    """The plans above differ from these in one field each."""
    plan = qz.stream_plan(GOOD["n"], 132)
    assert plan == qz.StreamPlan(264, 946, 4)
    qz.check_stream_plan(plan, GOOD["n"])
    qz.check_stream_plan(qz.StreamPlan(264, 3787, 1), GOOD["n"])


@pytest.mark.parametrize(
    "kwargs",
    [dict(n=-1, sms=132), dict(n=10, sms=0), dict(n=10, sms=132, vec=3)],
    ids=["negative_n", "no_sms", "vec3"],
)
def test_stream_plan_refuses_impossible_layouts(kwargs):
    with pytest.raises(ValueError, match="no plan"):
        qz.stream_plan(**kwargs)
