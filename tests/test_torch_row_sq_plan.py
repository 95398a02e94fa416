"""The launch plan of kernel B3 (``nanofed_tpu_torch/ops/dp_reduce.py``), on the CPU:
the persistent grid the host hands ``nf_row_sq_norms`` must cut every row into the
same segments whatever C is (a row's norm bits depend on its segments), cover every
(row, column) once, deal the (row, segment) pairs to contiguous runs balanced to
within one pair, in one wave of the card, and within a block's shared memory.  A plan
the C side would refuse raises on the host.  (The kernel itself runs only on the card:
``chip_smoke.py`` holds it against its plain version there.)
"""

import numpy as np
import pytest

from nanofed_tpu_torch.ops.dp_reduce import (
    MIN_SEGMENT_UNITS,
    RowSqPlan,
    check_row_sq_plan,
    plan_runs,
    plan_segments,
    row_sq_plan,
)
from nanofed_tpu_torch.ops.reduce import (
    BLOCK_SHARED_MAX,
    BLOCK_SHARED_RESERVED,
    MAX_THREADS_PER_SM,
    REGISTER_THREADS,
    RING_THREADS,
    SM_SHARED_BYTES,
    STAGE_BYTES,
)

P_MNIST = 1_199_882
CS = [1, 2, 8, 125, 1000]
PS = [1, 1000, 1537, 77_850, P_MNIST, 1_398_784]


def _ldx(p: int, vec: int) -> int:
    return -(-p // vec) * vec


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("vec", [4, 2, 1])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("c", CS)
def test_plan_covers_every_row_and_column_once_in_one_wave(c, p, vec, sms):
    ldx = _ldx(p, vec)
    plan = row_sq_plan(c, p, ldx, vec, sms)
    check_row_sq_plan(plan, c, p, ldx, vec)  # the C side runs it
    # A row's segments: contiguous, non-empty, from 0 to P, each starting on the load
    # width, widths within one unit of each other.
    segs = plan_segments(plan, p, vec)
    assert len(segs) == plan.segments
    assert segs[0][0] == 0 and segs[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert all(stop > start and start % vec == 0 for start, stop in segs)
    widths = [stop - start for start, stop in segs]
    assert max(widths[:-1] or widths) - min(widths[:-1] or widths) <= vec
    # The runs: every (row, segment) pair once, contiguous, balanced within one pair.
    runs = plan_runs(plan, c)
    assert len(runs) == plan.blocks
    assert runs[0][0] == 0 and sum(n for _, n in runs) == c * plan.segments
    assert all(a[0] + a[1] == b[0] for a, b in zip(runs, runs[1:]))
    counts = [n for _, n in runs]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    if c * p <= 2_000_000 and c * plan.segments <= 20_000:
        cover = np.zeros((c, p), np.int32)
        for start, n in runs:
            for i in range(start, start + n):
                lo, hi = segs[i % plan.segments]
                cover[i // plan.segments, lo:hi] += 1
        assert (cover == 1).all()
    # One wave of the card, within an SM's threads and shared memory.
    threads = RING_THREADS if vec == 4 else REGISTER_THREADS
    assert plan.blocks <= sms * plan.per_sm
    assert plan.per_sm * threads <= MAX_THREADS_PER_SM
    if vec == 4:
        assert plan.shared_bytes == plan.stages * STAGE_BYTES <= BLOCK_SHARED_MAX
        assert plan.per_sm * (plan.shared_bytes + BLOCK_SHARED_RESERVED) <= SM_SHARED_BYTES
    else:
        assert plan.stages == plan.shared_bytes == 0


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("vec", [4, 2, 1])
@pytest.mark.parametrize("p", PS)
def test_segment_bounds_do_not_depend_on_c(p, vec, sms):
    """A row's segments come from P, the load width and the SM count alone, so a row's
    norm bits are the same in a launch of 1, 2, 8, 125 or 1000 rows."""
    ldx = _ldx(p, vec)
    cuts = {tuple(plan_segments(row_sq_plan(c, p, ldx, vec, sms), p, vec)) for c in CS}
    assert len(cuts) == 1
    (cut,) = cuts
    units = -(-p // vec)
    assert len(cut) == max(1, min(sms // 2, units // MIN_SEGMENT_UNITS))


def test_main_path_plans_on_132_sms():
    """The flagship chunk is one wave of 2 ring blocks an SM; C = 2 gives every SM one
    block; rows past the old grid's 65,535 take the same persistent grid."""
    ldx = _ldx(P_MNIST, 4)
    assert row_sq_plan(125, P_MNIST, ldx, 4, 132) == RowSqPlan(
        segments=66, blocks=258, stages=3, shared_bytes=3 * STAGE_BYTES, per_sm=2)
    assert row_sq_plan(2, P_MNIST, ldx, 4, 132).blocks == 132
    assert row_sq_plan(2, 1_398_784, 1_398_784, 4, 132).blocks == 132
    big = row_sq_plan(70_000, 3, 4, 4, 132)
    check_row_sq_plan(big, 70_000, 3, 4, 4)
    assert big.blocks == 264 and big.segments == 1


GOOD = dict(c=7, p=1537, ldx=1540, vec=4)
RING = dict(stages=3, shared_bytes=3 * STAGE_BYTES, per_sm=2)


@pytest.mark.parametrize(
    "plan,layout",
    [
        (RowSqPlan(0, 7, **RING), GOOD),  # no segments
        (RowSqPlan(386, 7, **RING), GOOD),  # more segments than units
        (RowSqPlan(6, 0, **RING), GOOD),  # no blocks
        (RowSqPlan(1, 8, **RING), GOOD),  # more blocks than pairs
        (RowSqPlan(1, 7, 0, 0, 2), GOOD),  # the aligned layout needs the ring
        (RowSqPlan(1, 7, 1, STAGE_BYTES, 2), GOOD),  # too few stages
        (RowSqPlan(1, 7, 9, 9 * STAGE_BYTES, 2), GOOD),  # too many stages
        (RowSqPlan(1, 7, 3, 2 * STAGE_BYTES, 2), GOOD),  # shared != stages x 16 KB
        (RowSqPlan(1, 7, **RING), dict(GOOD, ldx=1538)),  # stride not 4-aligned
        (RowSqPlan(1, 7, **RING), dict(GOOD, ldx=1538, vec=2)),  # the ring on vec 2
        (RowSqPlan(1, 7, 0, 0, 6), dict(GOOD, ldx=1539, vec=2)),  # odd stride on vec 2
        (RowSqPlan(1, 7, 0, 0, 6), dict(GOOD, vec=3)),
        (RowSqPlan(1, 7, 0, 0, 6), dict(GOOD, ldx=1536, vec=1)),  # ldx < P
        (RowSqPlan(1, 1, **RING), dict(c=1, p=1 << 33, ldx=1 << 33, vec=4)),  # 2^31 units
        (RowSqPlan(1, 1, 0, 0, 6), dict(c=1 << 31, p=1, ldx=1, vec=1)),  # 2^31 rows
    ],
    ids=["no_segments", "too_many_segments", "no_blocks", "too_many_blocks",
         "vec4_without_ring", "one_stage", "nine_stages", "shared_mismatch",
         "vec4_unaligned_stride", "ring_on_vec2", "vec2_odd_stride", "vec3", "short_stride",
         "segment_of_2_31_units", "rows_past_int32"],
)
def test_plans_the_kernel_refuses_raise_on_the_host(plan, layout):
    with pytest.raises(ValueError, match="cannot run"):
        check_row_sq_plan(plan, **layout)


def test_row_sq_plan_refuses_impossible_layouts():
    for bad in [(0, 10, 10, 1, 132), (2, 10, 8, 1, 132), (2, 10, 12, 3, 132),
                (2, 0, 4, 4, 132), (2, 10, 12, 4, 0)]:
        with pytest.raises(ValueError, match="no plan"):
            row_sq_plan(*bad)


def test_row_sq_plan_is_cached_and_checked():
    """A call pays a lookup: the same shape gives the same plan object, and a layout
    the C side would refuse raises before it is cached."""
    ldx = _ldx(P_MNIST, 4)
    assert row_sq_plan(25, P_MNIST, ldx, 4, 132) is row_sq_plan(25, P_MNIST, ldx, 4, 132)
    with pytest.raises(ValueError, match="cannot run"):
        row_sq_plan(2, 1537, 1538, 4, 132)  # the ring on a stride that is not 4-aligned
    with pytest.raises(ValueError, match="cannot run"):
        row_sq_plan(2, 1537, 1539, 2, 132)  # 2-float loads on an odd stride
