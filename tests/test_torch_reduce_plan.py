"""The launch plan of kernels B1 and B2 (``nanofed_tpu_torch/ops/reduce.py``), and of
B4 over int8 rows, on the CPU: the persistent grid the host hands ``nf_weighted_sum``
(and ``nf_dequant_accumulate``) must cover every column once, in slabs that start on
the layout's vector width and differ by at most one 16-byte unit, in one wave of the
card, and within a block's shared memory.  A plan the C side would refuse raises on
the host.  (The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against their plain versions there.)
"""

import pytest

from nanofed_tpu_torch.ops.reduce import (
    BLOCK_SHARED_MAX,
    BLOCK_SHARED_RESERVED,
    MAX_THREADS_PER_SM,
    REGISTER_THREADS,
    RING_THREADS,
    SM_SHARED_BYTES,
    STAGE_BYTES,
    LaunchPlan,
    check_plan,
    launch_plan,
    plan_slabs,
)

P_MNIST = 1_199_882
# The P at which the grid stops growing: the largest grid (132 SMs x blocks an SM)
# of slabs of 256 units, for the ring (one block an SM for a small read, two above;
# 4 floats a unit) and the register path (6 blocks an SM, 2 floats a unit).
SMALL_RING_EDGE = 132 * 256 * 4
RING_EDGE = 132 * 2 * 256 * 4
REGISTER_EDGE = 132 * 6 * 256 * 2
PS = [1, 2, 3, 4, 5, 1023, 1537, 65_537, P_MNIST,
      *(e + d for e in (SMALL_RING_EDGE, RING_EDGE) for d in (-4, -1, 0, 1, 4)),
      *(REGISTER_EDGE + d for d in (-4, -1, 1, 4))]


def _ldx(p: int, vec: int) -> int:
    return -(-p // vec) * vec


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("vec", [4, 2, 1])
@pytest.mark.parametrize("c", [1, 7, 1000])
@pytest.mark.parametrize("p", PS)
def test_plan_covers_every_column_once_in_one_wave(p, c, vec, sms):
    ldx = _ldx(p, vec)
    plan = launch_plan(c, p, ldx, vec, sms)
    check_plan(plan, c, p, ldx, vec)  # the C side runs it
    slabs = plan_slabs(plan, p, vec)
    assert len(slabs) == plan.blocks
    # Every column in exactly one slab: contiguous, non-empty, from 0 to P.
    assert slabs[0][0] == 0 and slabs[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert all(stop > start for start, stop in slabs)
    # Each slab starts on a multiple of the load width.
    assert all(start % vec == 0 for start, _ in slabs)
    # Widths within one 16-byte unit of each other: `slab` or `slab + vec` floats,
    # the last one ending at P.
    widths = [stop - start for start, stop in slabs]
    assert max(widths) - min(widths) <= 4
    assert all(w in (plan.slab, plan.slab + vec) for w in widths[:-1])
    # One wave: no more blocks than the card holds at this footprint.
    threads = RING_THREADS if vec == 4 else REGISTER_THREADS
    assert plan.blocks <= sms * plan.per_sm
    assert plan.per_sm * threads <= MAX_THREADS_PER_SM
    assert plan.shared_bytes <= BLOCK_SHARED_MAX
    if vec == 4:
        assert plan.per_sm * (plan.shared_bytes + BLOCK_SHARED_RESERVED) <= SM_SHARED_BYTES
        assert plan.shared_bytes == plan.stages * STAGE_BYTES
        # At least 64 KB in flight on an SM (Little's law asks ~25 KB).
        assert plan.per_sm * plan.shared_bytes >= 64 * 1024
    else:
        assert plan.stages == plan.shared_bytes == 0


def test_flagship_chunk_plan():
    """The flagship chunk (C=125, rows padded to 4 floats) on an H100's 132 SMs: the
    ring at two blocks of 3 stages an SM, 264 slabs of 4544 or 4548 floats."""
    plan = launch_plan(125, P_MNIST, _ldx(P_MNIST, 4), 4, 132)
    assert plan == LaunchPlan(blocks=264, slab=4544, stages=3, shared_bytes=3 * 16384,
                              per_sm=2)
    widths = {stop - start for start, stop in plan_slabs(plan, P_MNIST, 4)}
    assert widths == {4544, 4548, 4548 - 2}  # the last slab ends at P (P % 4 == 2)


def test_small_read_takes_one_ring_block_an_sm():
    """Under 32 MB read (the tutorial round's C=2), one block of 6 stages an SM: the
    same 96 KB of ring, and half the blocks to start."""
    plan = launch_plan(2, P_MNIST, _ldx(P_MNIST, 4), 4, 132)
    assert plan == LaunchPlan(blocks=132, slab=9088, stages=6, shared_bytes=6 * 16384,
                              per_sm=2)
    assert launch_plan(7, P_MNIST, _ldx(P_MNIST, 4), 4, 132).blocks == 264  # 33.6 MB


def test_small_p_takes_fewer_blocks():
    assert launch_plan(1000, 2, 2, 2, 132).blocks == 1  # Multi-Krum's [C, 2] scalars
    assert launch_plan(3, 1537, 1540, 4, 132).blocks == 1
    assert launch_plan(3, 4 * 256 * 10, 4 * 256 * 10, 4, 132).blocks == 10


GOOD = dict(c=7, p=1537, ldx=1540, vec=4)


@pytest.mark.parametrize(
    "plan,layout",
    [
        (LaunchPlan(0, 1540, 6, 6 * STAGE_BYTES, 2), GOOD),
        (LaunchPlan(386, 0, 6, 6 * STAGE_BYTES, 2), GOOD),  # more blocks than units
        (LaunchPlan(1, 1536, 6, 6 * STAGE_BYTES, 2), GOOD),  # slab not the cut's
        (LaunchPlan(1, 1540, 0, 0, 2), GOOD),  # the aligned layout needs the ring
        (LaunchPlan(1, 1540, 1, STAGE_BYTES, 2), GOOD),  # too few stages
        (LaunchPlan(1, 1540, 9, 9 * STAGE_BYTES, 2), GOOD),  # too many stages
        (LaunchPlan(1, 1540, 6, 5 * STAGE_BYTES, 2), GOOD),  # shared != stages x 16 KB
        (LaunchPlan(1, 1540, 6, 6 * STAGE_BYTES, 2), dict(GOOD, ldx=1538)),  # stride
        (LaunchPlan(1, 1538, 6, 6 * STAGE_BYTES, 8), dict(GOOD, ldx=1538, vec=2)),
        (LaunchPlan(1, 1537, 0, 0, 8), dict(GOOD, vec=3)),
        (LaunchPlan(1, 1537, 0, 0, 8), dict(GOOD, ldx=1536, vec=1)),  # ldx < P
    ],
    ids=["no_blocks", "too_many_blocks", "wrong_slab", "vec4_without_ring", "one_stage",
         "nine_stages", "shared_mismatch", "vec4_unaligned_stride", "ring_on_vec2", "vec3",
         "short_stride"],
)
def test_plans_the_kernel_refuses_raise_on_the_host(plan, layout):
    with pytest.raises(ValueError, match="cannot run"):
        check_plan(plan, **layout)


def test_launch_plan_refuses_impossible_layouts():
    with pytest.raises(ValueError):
        launch_plan(0, 10, 10, 1, 132)
    with pytest.raises(ValueError):
        launch_plan(2, 10, 8, 1, 132)
    with pytest.raises(ValueError):
        launch_plan(2, 10, 12, 3, 132)


# ---------------------------------------------------------------------------
# Kernel B4 (ops/quantize.py dequant_accumulate_flat): the same plan over int8 rows
# (itemsize 1), 16-byte units of 16 columns, the ring at a 16-byte load width.
# ---------------------------------------------------------------------------

INT8_SMALL_RING_EDGE = 132 * 256 * 16
INT8_RING_EDGE = 132 * 2 * 256 * 16
INT8_REGISTER_EDGE = 132 * 6 * 256 * 8
INT8_PS = [1, 2, 15, 16, 17, 4097, P_MNIST,
           *(e + d for e in (INT8_SMALL_RING_EDGE, INT8_RING_EDGE) for d in (-16, -1, 0, 1, 16)),
           *(INT8_REGISTER_EDGE + d for d in (-8, -1, 1, 8))]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("vec", [16, 8, 4, 2, 1])
@pytest.mark.parametrize("c", [1, 64, 1000])
@pytest.mark.parametrize("p", INT8_PS)
def test_int8_plan_covers_every_column_once_in_one_wave(p, c, vec, sms):
    ldq = _ldx(p, vec)
    plan = launch_plan(c, p, ldq, vec, sms, itemsize=1)
    check_plan(plan, c, p, ldq, vec, itemsize=1)  # nf_dequant_accumulate runs it
    slabs = plan_slabs(plan, p, vec)
    assert len(slabs) == plan.blocks
    assert slabs[0][0] == 0 and slabs[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert all(stop > start for start, stop in slabs)
    assert all(start % vec == 0 for start, _ in slabs)
    # Widths within one 16-byte unit (16 int8 columns) of each other.
    widths = [stop - start for start, stop in slabs]
    assert max(widths) - min(widths) <= 16
    assert all(w in (plan.slab, plan.slab + vec) for w in widths[:-1])
    threads = RING_THREADS if vec == 16 else REGISTER_THREADS
    assert plan.blocks <= sms * plan.per_sm
    assert plan.per_sm * threads <= MAX_THREADS_PER_SM
    assert plan.shared_bytes <= BLOCK_SHARED_MAX
    if vec == 16:
        assert plan.per_sm * (plan.shared_bytes + BLOCK_SHARED_RESERVED) <= SM_SHARED_BYTES
        assert plan.shared_bytes == plan.stages * STAGE_BYTES
        assert plan.per_sm * plan.shared_bytes >= 64 * 1024
    else:
        assert plan.stages == plan.shared_bytes == 0


def test_epilogue_plan():
    """The epilogue table's q8 stack (C=64, rows padded to 16 bytes) on an H100's 132
    SMs: 77 MB read, so the ring at two blocks of 3 stages an SM, 264 slabs of 284 or
    285 units (each one column tile of the kernel: 4.5 KB copies)."""
    plan = launch_plan(64, P_MNIST, _ldx(P_MNIST, 16), 16, 132, itemsize=1)
    assert plan == LaunchPlan(blocks=264, slab=284 * 16, stages=3, shared_bytes=3 * 16384,
                              per_sm=2)
    widths = {stop - start for start, stop in plan_slabs(plan, P_MNIST, 16)}
    assert widths == {284 * 16, 285 * 16, 285 * 16 - 6}  # the last ends at P (P % 16 == 10)
    small = launch_plan(4, P_MNIST, _ldx(P_MNIST, 16), 16, 132, itemsize=1)
    assert (small.blocks, small.stages) == (132, 6)  # a 19 MB read: one block of 6 an SM


INT8_GOOD = dict(c=7, p=1537, ldx=1552, vec=16, itemsize=1)


@pytest.mark.parametrize(
    "plan,layout",
    [
        (LaunchPlan(0, 1552, 6, 6 * STAGE_BYTES, 2), INT8_GOOD),
        (LaunchPlan(97, 0, 6, 6 * STAGE_BYTES, 2), INT8_GOOD),  # more blocks than units
        (LaunchPlan(1, 1536, 6, 6 * STAGE_BYTES, 2), INT8_GOOD),  # slab not the cut's
        (LaunchPlan(1, 1552, 0, 0, 2), INT8_GOOD),  # the 16-byte layout needs the ring
        (LaunchPlan(1, 1552, 9, 9 * STAGE_BYTES, 2), INT8_GOOD),  # too many stages
        (LaunchPlan(1, 1552, 6, 6 * STAGE_BYTES, 2), dict(INT8_GOOD, ldx=1544)),  # stride
        (LaunchPlan(1, 1544, 6, 6 * STAGE_BYTES, 6), dict(INT8_GOOD, ldx=1544, vec=8)),
        (LaunchPlan(1, 1537, 0, 0, 6), dict(INT8_GOOD, vec=3)),
        (LaunchPlan(1, 1537, 0, 0, 6), dict(INT8_GOOD, vec=32)),
        (LaunchPlan(1, 1537, 0, 0, 6), dict(INT8_GOOD, ldx=1536, vec=1)),  # ldx < P
    ],
    ids=["no_blocks", "too_many_blocks", "wrong_slab", "vec16_without_ring", "nine_stages",
         "vec16_unaligned_stride", "ring_on_vec8", "vec3", "vec32", "short_stride"],
)
def test_int8_plans_the_kernel_refuses_raise_on_the_host(plan, layout):
    with pytest.raises(ValueError, match="cannot run"):
        check_plan(plan, **layout)
