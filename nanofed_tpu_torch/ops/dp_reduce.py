"""Kernel B3, per-row squared L2 norms ``[C, P] -> [C]``, and the central-DP reduce
built on B3 and B1.

B3 replaces ``nanofed_tpu/ops/dp_reduce.py::row_sq_norms`` (the Pallas
``_sq_norm_kernel``).  The CUDA source is ``csrc/dp_reduce.cu``: one launch on a
persistent grid planned on the host, B1's bulk-copy ring on 16-byte-aligned rows, and
a fixed-order reduction across blocks with a ticket a row; its header note gives the
bound (bytes) and the design.  The round uses it for every client's
``update_sq_norms`` and for the central-DP clip norms.

:func:`row_sq_plan` chooses each launch's grid: every row cut into the same segments
(from P, the load width and the SM count, never C, so a row's bits do not depend on
the rows beside it), the ``C x S`` (row, segment) pairs dealt to at most ``SMs x k``
blocks in contiguous runs, and on the aligned layout the depth of the ring.  The C
side refuses a plan it cannot run, and :func:`check_row_sq_plan` raises on the same
plans.

:func:`dp_clipped_mean_flat` is ``nanofed_tpu/ops/dp_reduce.py``'s fused clip + mean
(two read passes, no write): B3 for the norms, then B1 with the clip folded into the
weights and the denominator the participant weight sum.

On CPU tensors :func:`row_sq_norms` takes :func:`row_sq_norms_plain`; on CUDA
tensors it launches the kernel or raises, and counts launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.ops._common import (
    check_launch,
    check_rows,
    kernel_launched,
    stream_of,
    uses_kernel,
    vector_width,
)
from nanofed_tpu_torch.ops.reduce import (
    BLOCK_SHARED_MAX,
    BLOCK_SHARED_RESERVED,
    MAX_STAGES,
    MAX_THREADS_PER_SM,
    MIN_STAGES,
    REGISTER_BLOCKS_PER_SM,
    RING_BLOCKS_PER_SM,
    RING_THREADS,
    SM_SHARED_BYTES,
    STAGE_BYTES,
    UNIT_BYTES,
    sm_count,
    weighted_mean_flat,
)
from nanofed_tpu_torch.utils.trees import ravel_stacked, unravel

SMS_PER_SEGMENT = 2  # a row's segments: one for every two SMs, so C = 2 fills the card
MIN_SEGMENT_UNITS = 256  # load units a segment holds at least (4 KB on the ring)
RING_STAGES = 3  # 2 blocks x 3 x 16 KB an SM in flight (B1's 96 KB); deeper measured slower
STAGE_UNITS = STAGE_BYTES // UNIT_BYTES
WARP_PARTIALS = 8  # a segment's partials: one a consumer warp (256 threads)
INT32_MAX = 0x7FFFFFFF


class RowSqPlan(NamedTuple):
    """One launch of B3: each row cut into ``segments`` segments (:func:`plan_segments`),
    the ``C x segments`` (row, segment) pairs dealt to ``blocks`` contiguous runs
    (:func:`plan_runs`); ``stages`` ring stages in ``shared_bytes`` of dynamic shared
    memory (0 and 0 on the register path); ``per_sm`` (k) blocks an SM holds at that
    footprint, so ``blocks <= SMs x per_sm`` is one wave."""

    segments: int
    blocks: int
    stages: int
    shared_bytes: int
    per_sm: int


def _part(total: int, parts: int, i: int) -> tuple[int, int]:
    """``(start, count)`` of part ``i`` of ``total`` items cut into ``parts``
    contiguous parts, the last ``total % parts`` one item wider (``part_of`` in
    ``csrc/dp_reduce.cu``)."""
    base, extra = divmod(total, parts)
    first_wide = parts - extra
    return i * base + max(0, i - first_wide), base + (1 if i >= first_wide else 0)


@functools.lru_cache(maxsize=256)
def row_sq_plan(c: int, p: int, ldx: int, vec: int, sms: int) -> RowSqPlan:
    """The grid of one launch over a ``[c, p]`` float32 matrix with row stride ``ldx``
    whose layout allows ``vec``-float loads (4: the bulk-copy ring; 2 or 1: register
    loads) on a card of ``sms`` SMs, checked as the C side checks it.  Cached, so a
    call pays a lookup."""
    if c < 1 or p < 1 or ldx < p or sms < 1 or vec not in (4, 2, 1):
        raise ValueError(f"row_sq_plan: no plan for c={c} p={p} ldx={ldx} vec={vec} sms={sms}")
    units = -(-p // vec)
    segments = max(1, min(sms // SMS_PER_SEGMENT, units // MIN_SEGMENT_UNITS))
    pairs = c * segments
    per_sm = RING_BLOCKS_PER_SM if vec == 4 else REGISTER_BLOCKS_PER_SM
    # As few blocks as keep the longest run at its least: runs within one pair.
    blocks = -(-pairs // -(-pairs // (sms * per_sm)))
    if vec != 4:
        plan = RowSqPlan(segments, blocks, 0, 0, per_sm)
    else:
        # No more stages than a run has chunks (a segment's are at most 16 KB each).
        seg_units = -(-units // segments)
        run_chunks = -(-pairs // blocks) * -(-seg_units // STAGE_UNITS)
        stages = max(MIN_STAGES, min(RING_STAGES, run_chunks))
        shared = stages * STAGE_BYTES
        per_sm = min(MAX_THREADS_PER_SM // RING_THREADS, RING_BLOCKS_PER_SM,
                     SM_SHARED_BYTES // (shared + BLOCK_SHARED_RESERVED))
        plan = RowSqPlan(segments, blocks, stages, shared, per_sm)
    check_row_sq_plan(plan, c, p, ldx, vec)
    return plan


def plan_segments(plan: RowSqPlan, p: int, vec: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` columns of each of a row's segments, as the kernels cut
    them: ``ceil(p / vec)`` units, the last ``units % segments`` segments one unit
    wider (the last segment may end in a partial unit)."""
    units = -(-p // vec)
    out = []
    for s in range(plan.segments):
        start, count = _part(units, plan.segments, s)
        out.append((start * vec, min((start + count) * vec, p)))
    return out


def plan_runs(plan: RowSqPlan, c: int) -> list[tuple[int, int]]:
    """``(first pair, pair count)`` of each block's run over the row-major ``(row,
    segment)`` pairs; pair ``i`` is row ``i // segments``, segment ``i % segments``."""
    return [_part(c * plan.segments, plan.blocks, b) for b in range(plan.blocks)]


def check_row_sq_plan(plan: RowSqPlan, c: int, p: int, ldx: int, vec: int) -> None:
    """Raise ``ValueError`` for a plan or layout ``nf_row_sq_norms`` would refuse
    (``row_sq_plan_ok`` and the layout checks in ``csrc/dp_reduce.cu``, in the same
    order; the data pointer's alignment is the wrapper's ``vector_width``)."""
    ok = vec in (4, 2, 1) and 1 <= c <= INT32_MAX and p >= 1 and ldx >= p
    if ok:
        units = -(-p // vec)
        ok = (1 <= plan.segments <= min(units, INT32_MAX)
              and -(-units // plan.segments) <= INT32_MAX
              and 1 <= plan.blocks <= min(c * plan.segments, INT32_MAX))
    if ok and vec == 4:
        ok = (ldx % 4 == 0 and MIN_STAGES <= plan.stages <= MAX_STAGES
              and plan.shared_bytes == plan.stages * STAGE_BYTES
              and plan.shared_bytes <= BLOCK_SHARED_MAX)
    elif ok:
        ok = plan.stages == 0 and plan.shared_bytes == 0 and ldx % vec == 0
    if not ok:
        raise ValueError(f"the kernel cannot run {plan} for c={c} p={p} ldx={ldx} vec={vec}")


def row_sq_plan_for(x: torch.Tensor, ldx: int) -> tuple[int, RowSqPlan]:
    """``(vec, plan)`` of a launch over the CUDA float32 matrix ``x``."""
    vec = vector_width(x, ldx)
    c, p = x.shape
    return vec, row_sq_plan(c, p, ldx, vec, sm_count(x.device.index))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dp_reduce")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.nf_row_sq_norms.argtypes = [
        ptr, i64, i64, i64, i32, i64, i64, i32, i64, ptr, ptr, ptr, ptr,
    ]
    lib.nf_row_sq_norms.restype = i32
    lib.nf_row_sq_norms_occupancy.argtypes = [
        i32, i64, ctypes.POINTER(i32), ctypes.POINTER(i32),
    ]
    lib.nf_row_sq_norms_occupancy.restype = i32
    return lib


# (device index, stream) -> (tickets [>= C] int32, all 0 between launches; partials
# [>= C x S x 8] float32): allocated once per stream and grown, never per call.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: ctypes.c_void_p, rows: int,
               pairs: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream.value)
    tickets, partial = _workspaces.get(key, (None, None))
    if tickets is None or tickets.numel() < rows:
        tickets = torch.zeros(rows, dtype=torch.int32, device=device)
    if partial is None or partial.numel() < pairs:
        partial = torch.empty(pairs, dtype=torch.float32, device=device)
    _workspaces[key] = (tickets, partial)
    return tickets, partial


def _launch(x: torch.Tensor, ldx: int, out: torch.Tensor) -> None:
    """One launch over ``x`` into ``out`` on the wrapper's plan."""
    c, p = x.shape
    vec, plan = row_sq_plan_for(x, ldx)
    lib = _lib()
    stream = stream_of(x)
    with torch.cuda.device(x.device):
        tickets, partial = _workspace(x.device, stream, c, c * plan.segments * WARP_PARTIALS)
        rc = lib.nf_row_sq_norms(
            x.data_ptr(), ldx, c, p, vec, plan.segments, plan.blocks, plan.stages,
            plan.shared_bytes, partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            stream,
        )
    check_launch(lib, "row_sq_norms", rc)


def row_sq_occupancy(device: torch.device, vec: int, plan: RowSqPlan) -> tuple[int, int]:
    """``(registers a thread, blocks an SM holds)`` of the layout's kernel on the card,
    as ``ptxas`` and the occupancy calculator give them at the plan's shared memory."""
    lib = _lib()
    regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.nf_row_sq_norms_occupancy(vec, plan.shared_bytes, ctypes.byref(regs),
                                           ctypes.byref(per_sm))
    check_launch(lib, "row_sq_occupancy", rc)
    return regs.value, per_sm.value


def row_sq_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_sq_norms`."""
    return (x * x).sum(1)


def row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """``[C, P] -> [C]``: ``out[c] = sum_p x[c, p]^2``, one read of ``x``.  ``x`` is
    float32 with contiguous rows; its row stride may exceed P."""
    c, p, ldx = check_rows("row_sq_norms", x)
    if not uses_kernel(x):
        return row_sq_norms_plain(x)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    _launch(x, ldx, out)
    kernel_launched(row_sq_norms, 4 * c * p + 4 * c)
    return out


row_sq_norms.launches = 0


def dp_clipped_mean_flat(
    x: torch.Tensor, weights: torch.Tensor, clip: float | torch.Tensor
) -> torch.Tensor:
    """``[C, P] x [C] -> [P]``: ``weighted_mean(clip_rows(x), weights)`` without the
    clipped rows: row c's clip coefficient ``min(1, clip / max(||x_c||, 1e-12))``
    scales its WEIGHT, and the denominator stays the participant sum ``sum(w)`` (the
    clip bounds each client's contribution; it must not inflate everyone else's)."""
    norms = torch.sqrt(torch.clamp(row_sq_norms(x), min=0.0))
    coef = torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0)
    return weighted_mean_flat(x, weights * coef, denom=weights.sum())


def central_dp_reduce_stacked(
    stacked: Params, weights: torch.Tensor, clip: float | torch.Tensor
) -> Params:
    """:func:`dp_clipped_mean_flat` over a stacked ``[C, ...]`` update (add noise with
    ``privacy.noise.tree_noise``)."""
    like = {name: leaf[0] for name, leaf in stacked.items()}
    return unravel(dp_clipped_mean_flat(ravel_stacked(stacked), weights, clip), like)
