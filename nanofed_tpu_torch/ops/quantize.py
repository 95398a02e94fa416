"""Kernels B5, B6 and B7: secure aggregation's fixed-point and mask arithmetic; kernel
B4: the q8/topk aggregation epilogue's fused int8 dequant-accumulate.

B5 :func:`quantize_u32`, B6 :func:`dequantize_u32`, B7 :func:`add_mask` and B4
:func:`dequant_accumulate_flat` replace ``nanofed_tpu/ops/quantize.py``'s Pallas
``_quantize_kernel``, ``_dequantize_kernel``, ``_mask_kernel`` and
``_dequant_acc_kernel``.  The CUDA source of all four is ``csrc/quantize.cu``, whose
header note gives their bounds (bytes for B4, B5 and B6, integer operations for B7)
and the design.

* B4: int8 ``[C, P]`` x ``[C]`` scales x ``[C]`` weights + ``[P]`` base -> ``[P]``,
  ``base + coefs @ float(q)`` with ``coefs = (w * s) / max(denom or sum(w), 1e-12)``
  in float32, one read of the int8 stack; the dequantized float stack never exists.
  The TPU's padding of C to 32 and of P to 512 lanes is a tiling rule and is left
  out: the kernel takes any C and P.  It runs on B1's template: a persistent grid
  planned on the host (``ops.reduce.launch_plan`` with ``itemsize=1``), and on rows
  whose stride and start are 16-byte multiples (as the callers allocate them) the
  bulk-copy ring.

* B5: float32 ``[n]`` -> uint32 ``[n]``, ``bits(int32(round_half_even(x * 2^frac)))``.
  Inside the secure-aggregation contract (``|x * 2^frac| < 2^31``) this is the JAX
  kernel's function bit for bit.  Outside it the result saturates to ``INT32_MIN`` /
  ``INT32_MAX`` and NaN gives 0, in the kernel and in :func:`quantize_u32_plain` alike.
* B6: uint32 ``[n]`` -> float32 ``[n]``, ``float(int32(q)) * 2^-frac``: one rounding,
  so on a modular sum it equals ``np.float32(secure_agg.dequantize(total))`` exactly.
  B5 and B6 are one kernel over a conversion, on a one-wave grid planned on the host
  (:func:`stream_plan`: slabs of whole 16-byte units, or single words where a pointer
  is not 16-byte aligned), loaded into registers; the C side refuses any other plan,
  and :func:`check_stream_plan` raises on the same plans.
* B7: ``q + sum_j sign_j * m_j`` modulo 2^32 over k seeds in one launch, where
  ``m_j`` is numpy's Philox4x64-10 stream (``np.random.Philox``) under the 128-bit key
  formed from seed j's four folded words ``(w0 | w1 << 32, w2 | w3 << 32)``.  That
  is the key the host backend derives from the same 32-byte seed
  (``secure_agg._prg_uint32``), so the card's masks equal the host's bit for bit.  A
  client adds all of its masks in one launch.  (The TPU kernel draws the TPU core's
  own random bits, a stream no other device reproduces.)

uint32 vectors are ``torch.uint32`` tensors (the wire arrays are numpy ``uint32``).
PyTorch has few uint32 ops, so the plain versions carry the bits in int64 tensors
masked to 32 bits; B7's plain version is an explicit Philox4x64-10 in numpy
``uint64``, whose products wrap.  On CPU tensors each wrapper takes its plain version;
on CUDA tensors it launches the kernel or raises, and counts launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.ops._common import (
    check_int8_rows,
    check_launch,
    check_vector,
    kernel_launched,
    stream_of,
    to_device,
    uses_kernel,
)
from nanofed_tpu_torch.ops.reduce import LaunchPlan, check_plan, plan_for, sm_count

_LOW32 = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

# Philox4x64-10 (Random123 / numpy): multipliers and Weyl key increments.
PHILOX_M0, PHILOX_M1 = 0xD2E7470EE14C6C93, 0xCA5A826395121157
PHILOX_W0, PHILOX_W1 = 0x9E3779B97F4A7C15, 0xBB67AE8584CAA73B
PHILOX_ROUNDS = 10

# B7's grid, as csrc/quantize.cu has it: one thread per Philox block (8 words), 256
# threads a block, __launch_bounds__(256, 5); each block covers an equal range of
# Philox blocks (to within one), at least a warp's.
MASK_THREADS = 256
MASK_BLOCKS_PER_SM = 5
MASK_MIN_SPAN = 32

# B5/B6's plan, as csrc/quantize.cu has it: 256-thread blocks over slabs of whole
# units (16 bytes, 4 words, where both pointers are 16-byte aligned; else single
# words), at least STREAM_MIN_SLAB units a block, at most STREAM_BLOCKS_PER_SM blocks
# an SM (the kernel's 48 registers let an SM hold 5; 2 measured fastest warm).
STREAM_THREADS = 256
STREAM_UNIT_WORDS = 4
STREAM_MIN_SLAB = 256
STREAM_BLOCKS_PER_SM = 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    ptr, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.nf_quantize_u32.argtypes = [ptr, ptr, i64, ctypes.c_float, c_int, i64, i64, ptr]
    lib.nf_dequantize_u32.argtypes = list(lib.nf_quantize_u32.argtypes)
    lib.nf_add_mask.argtypes = [ptr, ptr, i64, ptr, ptr, c_int, c_int, c_int, i64, ptr]
    lib.nf_add_mask_inline_keys.argtypes = []
    lib.nf_dequant_accumulate.argtypes = [
        ptr, i64, ptr, i64, i64, ptr, c_int, ptr, c_int, i64, i64, c_int, i64, ptr,
    ]
    int_out = ctypes.POINTER(c_int)
    lib.nf_add_mask_occupancy.argtypes = [int_out, int_out]
    lib.nf_dequant_accumulate_occupancy.argtypes = [c_int, i64, int_out, int_out]
    lib.nf_fixed_point_occupancy.argtypes = [c_int, c_int, int_out, int_out]
    for fn in (lib.nf_quantize_u32, lib.nf_dequantize_u32, lib.nf_add_mask,
               lib.nf_add_mask_inline_keys, lib.nf_dequant_accumulate, lib.nf_add_mask_occupancy,
               lib.nf_dequant_accumulate_occupancy, lib.nf_fixed_point_occupancy):
        fn.restype = ctypes.c_int
    return lib


def _check_flat(name: str, what: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.ndim != 1:
        raise ValueError(f"{name}: {what} must be a flat [n] vector, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_frac_bits(frac_bits: int) -> None:
    if not 0 <= frac_bits <= 31:
        raise ValueError(f"frac_bits must be in [0, 31], got {frac_bits}")


def _vec(*tensors: torch.Tensor) -> int:
    """16-byte accesses when every pointer is 16-byte aligned, else scalar."""
    return 4 if all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _bits(q: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> its bits as int64 in [0, 2^32)."""
    return q.view(torch.int32).to(torch.int64) & _LOW32


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """int64 bits (any value; taken modulo 2^32) -> uint32 tensor."""
    return (b & _LOW32).to(torch.int32).view(torch.uint32)


def seed_key(seed: int | Sequence[int] | np.ndarray) -> tuple[int, int]:
    """A scalar or four 32-bit seed words (signed or unsigned, e.g. the int32 words of
    ``secure_agg._fold_seed_words``) -> the 128-bit Philox key ``(w0 | w1 << 32,
    w2 | w3 << 32)``.  A scalar seed is ``[seed, 0, 0, 0]``, as in the TPU kernel."""
    words = np.asarray(seed, dtype=np.int64).reshape(-1)
    if words.size == 1:
        words = np.concatenate([words, np.zeros(3, np.int64)])
    if words.size != 4:
        raise ValueError(f"seed must be a scalar or 4 words, got {words.size} values")
    w = [int(v) & _LOW32 for v in words]
    return w[0] | (w[1] << 32), w[2] | (w[3] << 32)


# ---------------------------------------------------------------------------
# B5 and B6: the launch plan
# ---------------------------------------------------------------------------


class StreamPlan(NamedTuple):
    """One launch of B5 or B6 over ``n`` words: ``blocks`` slabs of the ``n // vec``
    whole units of ``vec`` words (4: 16 bytes, 1: a word), ``slab`` units the narrower
    (the others one more; the last ``n % vec`` words go to the last block)."""

    blocks: int
    slab: int
    vec: int


def check_stream_plan(plan: StreamPlan, n: int) -> None:
    """Raise ``ValueError`` for a plan the C side would refuse (``stream_plan_ok`` in
    ``csrc/quantize.cu``)."""
    units = n // plan.vec if plan.vec in (STREAM_UNIT_WORDS, 1) else -1
    if not (n >= 0 and units >= 0 and 1 <= plan.blocks <= min(max(units, 1), 0x7FFFFFFF)
            and plan.slab == units // plan.blocks):
        raise ValueError(f"the kernel cannot run {plan} for n={n}")


@functools.lru_cache(maxsize=256)
def stream_plan(n: int, sms: int, vec: int = STREAM_UNIT_WORDS) -> StreamPlan:
    """The grid of one B5/B6 launch over ``n`` words on a card of ``sms`` SMs, checked
    as the C side checks it: ``sms x STREAM_BLOCKS_PER_SM`` blocks in one wave (fewer
    where a slab would hold under ``STREAM_MIN_SLAB`` units), each a contiguous slab.
    ``vec`` 4 needs both pointers 16-byte aligned.  Cached, so a call pays a lookup."""
    if n < 0 or sms < 1 or vec not in (STREAM_UNIT_WORDS, 1):
        raise ValueError(f"stream_plan: no plan for n={n} sms={sms} vec={vec}")
    units = n // vec
    blocks = max(1, min(sms * STREAM_BLOCKS_PER_SM, units // STREAM_MIN_SLAB))
    plan = StreamPlan(blocks, units // blocks, vec)
    check_stream_plan(plan, n)
    return plan


def fixed_point_launch(src: torch.Tensor, out: torch.Tensor, frac_bits: int) -> None:
    """One launch of B5 (``src`` float32, ``out`` uint32) or B6 (``src`` uint32, ``out``
    float32) on CUDA tensors, on :func:`stream_plan` for the pointers.  The wrapper's
    checks are done by the caller, and no launch is counted."""
    n = src.shape[0]
    vec = _vec(src, out)
    plan = stream_plan(n, sm_count(src.device.index), vec)
    lib = _lib()
    if src.dtype == torch.float32:
        name, fn, scale = "quantize_u32", lib.nf_quantize_u32, float(1 << frac_bits)
    else:
        name, fn, scale = "dequantize_u32", lib.nf_dequantize_u32, 1.0 / (1 << frac_bits)
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), out.data_ptr(), n, scale, vec, plan.blocks, plan.slab,
                stream_of(src))
    check_launch(lib, name, rc)


def fixed_point_occupancy(device: torch.device, dequantize: bool, vec: int) -> tuple[int, int]:
    """``(registers a thread, blocks an SM holds)`` of B5's (with ``dequantize``, B6's)
    kernel at ``vec`` on the card."""
    lib = _lib()
    regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.nf_fixed_point_occupancy(int(dequantize), vec, ctypes.byref(regs),
                                          ctypes.byref(per_sm))
    check_launch(lib, "fixed_point_occupancy", rc)
    return regs.value, per_sm.value


# ---------------------------------------------------------------------------
# B5: quantize
# ---------------------------------------------------------------------------


def quantize_u32_plain(x: torch.Tensor, frac_bits: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_u32` (same saturation and NaN rule)."""
    scaled = torch.round(x * float(1 << frac_bits)).to(torch.float64)  # half to even
    scaled = torch.nan_to_num(scaled, nan=0.0).clamp(_INT32_MIN, _INT32_MAX)
    return _from_bits(scaled.to(torch.int64))


def quantize_u32(x: torch.Tensor, frac_bits: int = 16) -> torch.Tensor:
    """float32 ``[n]`` -> uint32 ``[n]`` fixed point: ``int32(round_half_even(x *
    2^frac_bits))`` as two's-complement bits.  Values with ``|x * 2^frac_bits| >=
    2^31`` saturate and NaN gives 0 (the secure-aggregation contract keeps values
    inside the range)."""
    _check_flat("quantize_u32", "x", x, torch.float32)
    _check_frac_bits(frac_bits)
    if not uses_kernel(x):
        return quantize_u32_plain(x, frac_bits)
    out = torch.empty(x.shape[0], dtype=torch.uint32, device=x.device)
    fixed_point_launch(x, out, frac_bits)
    kernel_launched(quantize_u32, 8 * x.shape[0])
    return out


quantize_u32.launches = 0


# ---------------------------------------------------------------------------
# B6: dequantize
# ---------------------------------------------------------------------------


def dequantize_u32_plain(q: torch.Tensor, frac_bits: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`dequantize_u32`."""
    return q.view(torch.int32).to(torch.float32) * (1.0 / (1 << frac_bits))


def dequantize_u32(q: torch.Tensor, frac_bits: int = 16) -> torch.Tensor:
    """uint32 ``[n]`` fixed point -> float32 ``[n]``: the bits read as a signed
    (centered) int32, converted to float32 (one rounding) and scaled by the exact
    ``2^-frac_bits``."""
    _check_flat("dequantize_u32", "q", q, torch.uint32)
    _check_frac_bits(frac_bits)
    if not uses_kernel(q):
        return dequantize_u32_plain(q, frac_bits)
    out = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    fixed_point_launch(q, out, frac_bits)
    kernel_launched(dequantize_u32, 8 * q.shape[0])
    return out


dequantize_u32.launches = 0


# ---------------------------------------------------------------------------
# B7: add (or subtract) the Philox mask
# ---------------------------------------------------------------------------


def _mulhilo64(a: int, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``a * b`` as (low, high) 64-bit halves of the 128-bit product, from four
    32 x 32 -> 64 partial products (numpy uint64 wraps, and has no wider type)."""
    m32, s32 = np.uint64(_LOW32), np.uint64(32)
    a_lo, a_hi = np.uint64(a & _LOW32), np.uint64(a >> 32)
    b_lo, b_hi = b & m32, b >> s32
    p0, p1, p2, p3 = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (p0 >> s32) + (p1 & m32) + (p2 & m32)
    hi = p3 + (p1 >> s32) + (p2 >> s32) + (mid >> s32)
    return np.uint64(a) * b, hi


def philox_stream_plain(key: tuple[int, int], n: int) -> np.ndarray:
    """The first ``n`` uint32 words of numpy's Philox4x64-10 stream under ``key``,
    computed block by block as the kernel does: block ``b`` is the Philox of the
    counter ``(b + 1, 0, 0, 0)``, and its four 64-bit words give uint32 words ``8b ..
    8b + 7`` as (low half, high half) of each in turn."""
    blocks = -(-n // 8)
    c0 = np.arange(1, blocks + 1, dtype=np.uint64)
    c1 = c2 = c3 = np.zeros(blocks, np.uint64)
    k0, k1 = key
    for rnd in range(PHILOX_ROUNDS):
        if rnd:
            k0, k1 = (k0 + PHILOX_W0) & ((1 << 64) - 1), (k1 + PHILOX_W1) & ((1 << 64) - 1)
        lo0, hi0 = _mulhilo64(PHILOX_M0, c0)
        lo1, hi1 = _mulhilo64(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ np.uint64(k0), lo1, hi0 ^ c3 ^ np.uint64(k1), lo0
    words = np.stack([c0, c1, c2, c3], axis=1)
    halves = np.stack([words & np.uint64(_LOW32), words >> np.uint64(32)], axis=-1)
    return halves.astype(np.uint32).reshape(-1)[:n]


Seeds = int | Sequence[int] | Sequence[Sequence[int]] | np.ndarray
Signs = int | Sequence[int]


def mask_keys(seeds: Seeds, signs: Signs) -> tuple[np.ndarray, np.ndarray]:
    """The Philox keys and signs of one :func:`add_mask` call, as ``[k, 2]`` uint64
    keys (:func:`seed_key` of each seed) and ``k`` int signs: one seed (a scalar or
    four words) with an int sign, or a ``[k, 4]`` array of seed words with ``k``
    signs.  Every sign is +1 or -1; ``k = 0`` raises."""
    words = np.asarray(seeds, dtype=np.int64)
    if words.ndim <= 1:
        keys = np.array([seed_key(words)], dtype=np.uint64)
        sign_arr = np.asarray(signs).reshape(1) if np.ndim(signs) == 0 else None
    elif words.ndim == 2 and words.shape[1] == 4:
        w = (words & _LOW32).astype(np.uint64)
        shift = np.uint64(32)
        keys = np.stack([w[:, 0] | (w[:, 1] << shift), w[:, 2] | (w[:, 3] << shift)], axis=1)
        sign_arr = np.asarray(signs).reshape(-1) if np.ndim(signs) == 1 else None
    else:
        raise ValueError(f"add_mask: seeds must be one seed or [k, 4] words, got shape "
                         f"{words.shape}")
    if not len(keys):
        raise ValueError("add_mask: no seeds (k = 0)")
    if sign_arr is None or sign_arr.size != len(keys):
        raise ValueError(f"add_mask: {len(keys)} seeds need {len(keys)} signs, got {signs!r}")
    if not np.isin(sign_arr, (1, -1)).all():
        raise ValueError(f"add_mask: sign must be +1 or -1, got {signs!r}")
    return keys, sign_arr.astype(np.int64)


def add_mask_plain(q: torch.Tensor, seeds: Seeds, signs: Signs) -> torch.Tensor:
    """Plain version of :func:`add_mask`: each seed's explicit Philox stream, summed
    with its sign into ``q``'s bits in int64, then taken modulo 2^32."""
    keys, sign_arr = mask_keys(seeds, signs)
    total = _bits(q)
    for (k0, k1), sign in zip(keys, sign_arr):
        mask = philox_stream_plain((int(k0), int(k1)), q.shape[0]).astype(np.int64)
        total = total + int(sign) * torch.from_numpy(mask).to(q.device)
    return _from_bits(total)


def mask_grid(n: int, sms: int) -> int:
    """B7's block count over ``n`` words on a card of ``sms`` SMs: ``sms x
    MASK_BLOCKS_PER_SM`` blocks (one wave, the same number on every SM), fewer where a
    block would cover less than ``MASK_MIN_SPAN`` Philox blocks."""
    philox_blocks = -(-max(n, 1) // 8)
    return max(1, min(sms * MASK_BLOCKS_PER_SM, philox_blocks // MASK_MIN_SPAN))


def add_mask(q: torch.Tensor, seeds: Seeds, signs: Signs) -> torch.Tensor:
    """uint32 ``[n]`` -> ``q + sum_j sign_j * PRG(seed_j)`` modulo 2^32, as a new
    tensor, in one launch whatever the number of seeds.  ``seeds`` is one seed (four
    32-bit words, 128 seed bits, or a scalar) with ``signs`` +1 (add) or -1
    (subtract), or a ``[k, 4]`` array of seed words with ``k`` signs.  Each mask is
    numpy's Philox4x64-10 stream under :func:`seed_key`, so two parties with one seed
    and opposite signs cancel exactly and the stream equals the host backend's for
    the same 32-byte seed."""
    _check_flat("add_mask", "q", q, torch.uint32)
    keys, sign_arr = mask_keys(seeds, signs)
    if not uses_kernel(q):
        return add_mask_plain(q, seeds, signs)
    # The table of keys and signs, [k, 3] words (k0, k1, subtract): in the launch's
    # parameters up to the kernel's limit, else copied to the card on its stream.
    table = np.concatenate([keys, (sign_arr < 0).astype(np.uint64)[:, None]], axis=1)
    n = q.shape[0]
    out = torch.empty_like(q)
    lib = _lib()
    device_keys = None
    if len(keys) > lib.nf_add_mask_inline_keys():
        device_keys = to_device(torch.from_numpy(table.view(np.int64)), q.device)
    with torch.cuda.device(q.device):
        rc = lib.nf_add_mask(q.data_ptr(), out.data_ptr(), n, table.ctypes.data,
                             None if device_keys is None else device_keys.data_ptr(), len(keys),
                             int((sign_arr < 0).sum()), _vec(q, out),
                             mask_grid(n, sm_count(q.device.index)), stream_of(q))
    check_launch(lib, "add_mask", rc)
    kernel_launched(add_mask, 8 * n)
    return out


add_mask.launches = 0


def add_mask_occupancy(device: torch.device) -> tuple[int, int]:
    """``(registers a thread, blocks an SM holds)`` of B7's kernel on the card."""
    lib = _lib()
    regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.nf_add_mask_occupancy(ctypes.byref(regs), ctypes.byref(per_sm))
    check_launch(lib, "add_mask_occupancy", rc)
    return regs.value, per_sm.value


# ---------------------------------------------------------------------------
# B4: fused int8 dequant + weighted accumulate (the q8/topk aggregation epilogue)
# ---------------------------------------------------------------------------


def _dequant_coefs(
    scales: torch.Tensor, weights: torch.Tensor, denom: float | torch.Tensor | None
) -> torch.Tensor:
    """``(w * s) / max(denom or sum(w), 1e-12)`` in float32, in the TPU function's
    order: the per-client scale folded into the reduce coefficient."""
    w = weights.to(torch.float32)
    d = w.sum() if denom is None else torch.as_tensor(denom, dtype=torch.float32).to(w.device)
    return (w * scales.to(torch.float32)) / torch.clamp(d, min=1e-12)


def dequant_accumulate_flat_plain(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, base: torch.Tensor,
    denom: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`dequant_accumulate_flat`."""
    if q.dtype != torch.int8:
        raise TypeError(f"dequant_accumulate_flat: q must be int8 (the wire dtype), got {q.dtype}")
    return base.to(torch.float32) + _dequant_coefs(scales, weights, denom) @ q.to(torch.float32)


def dequant_accumulate_flat(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, base: torch.Tensor,
    denom: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused q8/topk aggregation epilogue: ``[C, P] int8 x [C] scales x [C] weights +
    [P] base -> [P]``, ``base + sum_c (w_c * s_c / denom) * q[c, :]`` in one pass over
    the int8 stack.  ``denom`` defaults to ``sum(w)`` (the weighted mean) and is floored
    at 1e-12, so all-zero weights return ``base`` exactly.  ``q`` is int8 (anything
    else raises ``TypeError``) with contiguous rows; its row stride may exceed P (a
    16-byte stride gives the kernel its bulk-copy ring).  ``base`` is a contiguous
    float32 ``[P]``."""
    c, p, ldq = check_int8_rows("dequant_accumulate_flat", q)
    for what, v in (("scales", scales), ("weights", weights)):
        if v.ndim != 1 or v.shape[0] != c:
            raise ValueError(f"dequant_accumulate_flat: {what} must be [{c}], got "
                             f"{tuple(v.shape)}")
    check_vector("dequant_accumulate_flat", "base", base, p)
    extra = [denom] if isinstance(denom, torch.Tensor) else []
    if not uses_kernel(q, scales, weights, base, *extra):
        return dequant_accumulate_flat_plain(q, scales, weights, base, denom)
    coefs = _dequant_coefs(scales, weights, denom).contiguous()  # O(C), beside the kernel
    out = torch.empty(p, dtype=torch.float32, device=q.device)
    dequant_launch(q, ldq, coefs, base, out)
    # Bytes: the int8 stack once, base read and out written, and the C-sized scales,
    # weights and coefficients.
    kernel_launched(dequant_accumulate_flat, c * p + 8 * p + 12 * c)
    return out


def dequant_launch(q: torch.Tensor, ldq: int, coefs: torch.Tensor, base: torch.Tensor,
                   out: torch.Tensor) -> None:
    """One launch of B4's kernel on CUDA tensors whose coefficients are formed: ``out =
    base + coefs @ float(q)``.  The wrapper's checks are done by the caller, and no
    launch is counted."""
    c, p = q.shape
    vec, plan = plan_for(q, ldq)
    check_plan(plan, c, p, ldq, vec, itemsize=1)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.nf_dequant_accumulate(
            q.data_ptr(), ldq, coefs.data_ptr(), c, p, base.data_ptr(),
            int(base.data_ptr() % 16 == 0), out.data_ptr(), vec, plan.blocks, plan.slab,
            plan.stages, plan.shared_bytes, stream_of(q))
    check_launch(lib, "dequant_accumulate_flat", rc)


dequant_accumulate_flat.launches = 0


def dequant_occupancy(device: torch.device, vec: int, plan: LaunchPlan) -> tuple[int, int]:
    """``(registers a thread, blocks an SM holds)`` of B4's kernel for a launch of
    load width ``vec`` on the card, at the plan's shared memory."""
    lib = _lib()
    regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.nf_dequant_accumulate_occupancy(vec, plan.shared_bytes, ctypes.byref(regs),
                                                 ctypes.byref(per_sm))
    check_launch(lib, "dequant_occupancy", rc)
    return regs.value, per_sm.value
