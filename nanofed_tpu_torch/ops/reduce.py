"""Kernels B1 and B2: the FedAvg weighted reduce, ``[C, P] x [C] -> [P]``.

B1 replaces ``nanofed_tpu/ops/reduce.py::weighted_mean_flat`` (the Pallas
``_wmean_kernel``), B2 ``nanofed_tpu/ops/reduce.py::masked_weighted_mean_flat``
(``_masked_wmean_kernel``).  The CUDA source of both is ``csrc/reduce.cu``, whose
header note gives the bound (bytes: x is read once) and the design: B2 is B1's
kernel with every element sanitized in registers.  Three entry points:

* :func:`weighted_mean_flat` (B1) — the TPU function: ``sum_c w_c x[c] / max(sum w
  or denom, 1e-12)`` (the materialised round's reduce; central DP and Multi-Krum
  pass ``denom``);
* :func:`weighted_sum_into` (B1) — ``acc += sum_c w_c x[c]`` in place (the streamed
  round folds each client chunk into a running sum);
* :func:`masked_weighted_mean_flat` (B2) — the validated round's reduce: the mean
  over the valid clients of the deltas with NaN and inf zeroed, in one read pass
  (with ``denom``, a rank of a mesh divides by the whole cohort's valid weight).

On CPU tensors each takes its plain version (``*_plain``, same module), which is
what the CPU tests hold against the JAX package.  On CUDA tensors it launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``.

:func:`launch_plan` chooses each launch's grid on the host: a persistent grid of at
most ``SMs x k`` blocks over column slabs of equal width (to within one 16-byte
unit), and on the aligned layout the depth of the bulk-copy ring.  The C side
refuses a plan it cannot run, and :func:`check_plan` raises on the same plans.
Kernel B4 (``ops.quantize.dequant_accumulate_flat``) runs on the same template over
int8 rows: its plans are these functions' with ``itemsize=1``.
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
    check_vector,
    int8_vector_width,
    kernel_launched,
    stream_of,
    uses_kernel,
    vector_width,
)
from nanofed_tpu_torch.utils.trees import ravel_stacked, unravel


# The launch plan's constants, as csrc/common.cuh and csrc/reduce.cu have them (B4's
# kernels in csrc/quantize.cu take the same ring, threads and blocks an SM).
UNIT_BYTES = 16  # one 16-byte unit: a bulk copy's granularity, a ring consumer's load
STAGE_BYTES = 16 * 1024  # one ring stage: 1024 16-byte units
RING_BYTES_PER_SM = 96 * 1024  # the ring an SM holds in flight: 3 stages x 2 blocks
MIN_STAGES, MAX_STAGES = 2, 8
RING_THREADS = 288  # 256 consumers + one producer warp
RING_BLOCKS_PER_SM = 2  # __launch_bounds__(288, 2): the registers allow two
SMALL_READ_BYTES = 32 << 20  # below this read, one ring block an SM starts sooner
REGISTER_THREADS = 256
REGISTER_BLOCKS_PER_SM = 6  # __launch_bounds__(256, 6): up to 40 registers a thread
MIN_SLAB_UNITS = 256  # one unit a consumer thread: fewer blocks where P is small
SM_SHARED_BYTES = 233_472  # 228 KB of shared memory an H100 SM holds
BLOCK_SHARED_MAX = 232_448  # 227 KB, a block's dynamic shared-memory limit
BLOCK_SHARED_RESERVED = 2048  # the ring's static shared memory plus the 1 KB the card keeps
MAX_THREADS_PER_SM = 2048


class LaunchPlan(NamedTuple):
    """One launch of B1/B2 (or B4): ``blocks`` column slabs, each ``slab`` or ``slab
    + vec`` elements wide (the last one ends at P); ``stages`` ring stages in
    ``shared_bytes`` of dynamic shared memory (0 and 0 on the register path);
    ``per_sm`` (k) blocks an SM holds at that footprint, so ``blocks <= SMs x
    per_sm`` is one wave."""

    blocks: int
    slab: int
    stages: int
    shared_bytes: int
    per_sm: int


def load_widths(itemsize: int) -> tuple[int, ...]:
    """The load widths, in elements, of a row of ``itemsize``-byte elements: powers
    of two up to one 16-byte unit, the widest of which takes the bulk-copy ring."""
    ring = UNIT_BYTES // itemsize
    return tuple(1 << i for i in range(ring.bit_length() - 1, -1, -1))


def launch_plan(c: int, p: int, ldx: int, vec: int, sms: int, itemsize: int = 4) -> LaunchPlan:
    """The grid of one launch over a ``[c, p]`` matrix of ``itemsize``-byte elements
    (4: B1/B2's float32, 1: B4's int8) with row stride ``ldx`` whose layout allows
    ``vec``-element loads (:func:`load_widths`) on a card of ``sms`` SMs.  A
    16-byte ``vec`` takes the bulk-copy ring, narrower ones register loads."""
    if c < 1 or p < 1 or ldx < p or sms < 1 or vec not in load_widths(itemsize):
        raise ValueError(f"launch_plan: no plan for c={c} p={p} ldx={ldx} vec={vec} sms={sms} "
                         f"itemsize={itemsize}")
    units = -(-p // vec)
    if vec * itemsize == UNIT_BYTES:
        # 96 KB of ring an SM: two blocks of 3 stages, or, where the whole read is
        # small, one block of 6 (a block's start-up then costs more than a second
        # block's overlap).
        used = 1 if itemsize * c * p < SMALL_READ_BYTES else RING_BLOCKS_PER_SM
        stages = RING_BYTES_PER_SM // (used * STAGE_BYTES)
        shared = stages * STAGE_BYTES
        per_sm = min(MAX_THREADS_PER_SM // RING_THREADS, RING_BLOCKS_PER_SM,
                     SM_SHARED_BYTES // (shared + BLOCK_SHARED_RESERVED))
        blocks = min(sms * used, units // MIN_SLAB_UNITS)
    else:
        stages, shared, per_sm = 0, 0, REGISTER_BLOCKS_PER_SM
        blocks = min(sms * per_sm, units // MIN_SLAB_UNITS)
    blocks = max(1, blocks)
    return LaunchPlan(blocks, (units // blocks) * vec, stages, shared, per_sm)


def plan_slabs(plan: LaunchPlan, p: int, vec: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` columns of each block's slab, as the kernels' ``slab_of``
    cuts them: ``ceil(p / vec)`` units of ``vec`` elements, the last ``units %
    blocks`` slabs one unit wider (the last slab may end in a partial unit)."""
    units = -(-p // vec)
    base, extra = divmod(units, plan.blocks)
    first_wide = plan.blocks - extra
    starts = [b * base + max(0, b - first_wide) for b in range(plan.blocks + 1)]
    return [(starts[b] * vec, min(starts[b + 1] * vec, p)) for b in range(plan.blocks)]


def check_plan(plan: LaunchPlan, c: int, p: int, ldx: int, vec: int, itemsize: int = 4) -> None:
    """Raise ``ValueError`` for a plan the C side would refuse (``plan_ok`` in
    ``csrc/common.cuh`` and the layout checks of ``nf_weighted_sum`` or, with
    ``itemsize=1``, ``nf_dequant_accumulate``, in the same order)."""
    widths = load_widths(itemsize)
    units = -(-p // vec) if vec in widths else 0
    ok = (vec in widths and c >= 1 and p >= 1 and ldx >= p
          and 1 <= plan.blocks <= min(units, 0x7FFFFFFF)
          and plan.slab == (units // plan.blocks) * vec)
    if ok and vec * itemsize == UNIT_BYTES:
        ok = (ldx % vec == 0 and MIN_STAGES <= plan.stages <= MAX_STAGES
              and plan.shared_bytes == plan.stages * STAGE_BYTES
              and plan.shared_bytes <= BLOCK_SHARED_MAX)
    elif ok:
        ok = plan.stages == 0 and plan.shared_bytes == 0
    if not ok:
        raise ValueError(f"the kernel cannot run {plan} for c={c} p={p} ldx={ldx} vec={vec} "
                         f"itemsize={itemsize}")


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, ldx: int) -> tuple[int, LaunchPlan]:
    """``(vec, plan)`` of a launch over the CUDA matrix ``x`` (float32 for B1/B2,
    int8 for B4)."""
    vec = int8_vector_width(x, ldx) if x.dtype == torch.int8 else vector_width(x, ldx)
    c, p = x.shape
    return vec, launch_plan(c, p, ldx, vec, sm_count(x.device.index), x.element_size())


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("reduce")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.nf_weighted_sum.argtypes = [
        ptr, i64, ptr, i64, i64, ptr, ptr, i32, i32, i32, i64, i64, i32, i64, ptr,
    ]
    lib.nf_weighted_sum.restype = i32
    lib.nf_weighted_sum_occupancy.argtypes = [
        i32, i32, i32, i64, ctypes.POINTER(i32), ctypes.POINTER(i32),
    ]
    lib.nf_weighted_sum_occupancy.restype = i32
    return lib


def _launch(name: str, x: torch.Tensor, ldx: int, w: torch.Tensor,
            denom: torch.Tensor | None, out: torch.Tensor, accumulate: bool,
            sanitized: bool = False) -> None:
    lib = _lib()
    c, p = x.shape
    vec, plan = plan_for(x, ldx)
    check_plan(plan, c, p, ldx, vec)
    with torch.cuda.device(x.device):
        rc = lib.nf_weighted_sum(
            x.data_ptr(), ldx, w.data_ptr(), c, p,
            None if denom is None else denom.data_ptr(), out.data_ptr(),
            int(accumulate), int(sanitized), vec, plan.blocks, plan.slab, plan.stages,
            plan.shared_bytes, stream_of(x),
        )
    check_launch(lib, name, rc)


def kernel_occupancy(device: torch.device, vec: int, accumulate: bool, sanitized: bool,
                     plan: LaunchPlan) -> tuple[int, int]:
    """``(registers a thread, blocks an SM holds)`` of the form's kernel on the card,
    as ``ptxas`` and the occupancy calculator give them at the plan's shared memory."""
    lib = _lib()
    regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.nf_weighted_sum_occupancy(vec, int(accumulate), int(sanitized),
                                           plan.shared_bytes, ctypes.byref(regs),
                                           ctypes.byref(per_sm))
    check_launch(lib, "kernel_occupancy", rc)
    return regs.value, per_sm.value


def _denom_tensor(denom: float | torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    if denom is None:
        return None
    return torch.as_tensor(denom, dtype=torch.float32).to(device).reshape(1).contiguous()


def weighted_mean_flat_plain(
    x: torch.Tensor, weights: torch.Tensor, denom: float | torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_mean_flat`."""
    d = weights.sum() if denom is None else torch.as_tensor(denom, dtype=torch.float32)
    return (weights[:, None] * x).sum(0) / torch.clamp(d.to(x.device), min=1e-12)


def weighted_mean_flat(
    x: torch.Tensor, weights: torch.Tensor, denom: float | torch.Tensor | None = None
) -> torch.Tensor:
    """``[C, P] x [C] -> [P]`` weighted mean: weights normalised by their sum, or by
    an explicit ``denom`` (central DP divides by the participant sum while clip
    coefficients ride in the weights).  All-zero weights give zeros (the
    denominator is floored at 1e-12).  ``x`` is float32 with contiguous rows; its
    row stride may exceed P."""
    c, p, ldx = check_rows("weighted_mean_flat", x)
    check_vector("weighted_mean_flat", "weights", weights, c)
    extra = [denom] if isinstance(denom, torch.Tensor) else []
    if not uses_kernel(x, weights, *extra):
        return weighted_mean_flat_plain(x, weights, denom)
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    _launch("weighted_mean_flat", x, ldx, weights, _denom_tensor(denom, x.device), out,
            accumulate=False)
    kernel_launched(weighted_mean_flat, 4 * c * p + 4 * c + 4 * p + (0 if denom is None else 4))
    return out


weighted_mean_flat.launches = 0


def weighted_sum_into_plain(acc: torch.Tensor, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_sum_into` (also in place)."""
    acc += (weights[:, None] * x).sum(0)
    return acc


def weighted_sum_into(acc: torch.Tensor, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``acc[p] += sum_c weights[c] * x[c, p]``.  Updates ``acc`` IN PLACE (a
    contiguous float32 ``[P]``) and returns it — the streamed round's accumulate,
    with no divide."""
    c, p, ldx = check_rows("weighted_sum_into", x)
    check_vector("weighted_sum_into", "weights", weights, c)
    check_vector("weighted_sum_into", "acc", acc, p)
    if not uses_kernel(acc, x, weights):
        return weighted_sum_into_plain(acc, x, weights)
    _launch("weighted_sum_into", x, ldx, weights, None, acc, accumulate=True)
    kernel_launched(weighted_sum_into, 4 * c * p + 4 * c + 8 * p)
    return acc


weighted_sum_into.launches = 0


def masked_weighted_mean_flat_plain(
    x: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor,
    denom: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_weighted_mean_flat`, as the TPU
    function writes it: normalised coefficients, then the sanitized contraction."""
    w = weights * valid.to(torch.float32)
    d = w.sum() if denom is None else torch.as_tensor(denom, dtype=torch.float32)
    coefs = w / torch.clamp(d.to(x.device), min=1e-12)
    sanitized = torch.where(torch.isfinite(x), x, torch.zeros((), device=x.device))
    return (coefs[:, None] * sanitized).sum(0)


def masked_weighted_mean_flat(
    x: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor,
    denom: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """``[C, P] x [C] weights x [C] validity -> [P]``: the weighted mean over the VALID
    clients of ``x`` with NaN and inf zeroed, equal to ``weighted_mean_flat(
    sanitize(x), weights * valid)`` with the sanitized stack never written.  ``valid``
    is bool or 0/1; an all-invalid cohort gives zeros.  ``x`` is float32 with
    contiguous rows; its row stride may exceed P.  ``denom`` replaces the valid
    weights' sum as the divisor, as B1's: on a mesh it is the whole cohort's valid
    weight, so the ranks' results sum to the cohort's mean."""
    c, p, ldx = check_rows("masked_weighted_mean_flat", x)
    check_vector("masked_weighted_mean_flat", "weights", weights, c)
    if valid.ndim != 1 or valid.shape[0] != c:
        raise ValueError(f"masked_weighted_mean_flat: valid must be [{c}], got "
                         f"{tuple(valid.shape)}")
    extra = [denom] if isinstance(denom, torch.Tensor) else []
    if not uses_kernel(x, weights, valid, *extra):
        return masked_weighted_mean_flat_plain(x, weights, valid, denom)
    w = weights * valid.to(torch.float32)  # the O(C) coefficient work, beside the kernel
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    _launch("masked_weighted_mean_flat", x, ldx, w, _denom_tensor(denom, x.device), out,
            accumulate=False, sanitized=True)
    kernel_launched(masked_weighted_mean_flat,
                    4 * c * p + 4 * c + valid.element_size() * c + 4 * p
                    + (0 if denom is None else 4))
    return out


masked_weighted_mean_flat.launches = 0


def weighted_mean_tree(stacked: Params, weights: torch.Tensor) -> Params:
    """Weighted mean of stacked params (leaves ``[C, ...]``): ravel into one
    ``[C, P]`` matrix, reduce with :func:`weighted_mean_flat`, unravel."""
    like = {name: leaf[0] for name, leaf in stacked.items()}
    return unravel(weighted_mean_flat(ravel_stacked(stacked), weights), like)
