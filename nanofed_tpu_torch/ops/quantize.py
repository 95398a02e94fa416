"""Kernels B5, B6 and B7: secure aggregation's fixed-point and mask arithmetic.

B5 :func:`quantize_u32`, B6 :func:`dequantize_u32` and B7 :func:`add_mask` replace
``nanofed_tpu/ops/quantize.py``'s Pallas ``_quantize_kernel``, ``_dequantize_kernel``
and ``_mask_kernel``.  The CUDA source of all three is ``csrc/quantize.cu``, whose
header note gives their bounds (bytes for B5 and B6, integer operations for B7) and
the design.

* B5: float32 ``[n]`` -> uint32 ``[n]``, ``bits(int32(round_half_even(x * 2^frac)))``.
  Inside the secure-aggregation contract (``|x * 2^frac| < 2^31``) this is the JAX
  kernel's function bit for bit.  Outside it the result saturates to ``INT32_MIN`` /
  ``INT32_MAX`` and NaN gives 0, in the kernel and in :func:`quantize_u32_plain` alike.
* B6: uint32 ``[n]`` -> float32 ``[n]``, ``float(int32(q)) * 2^-frac``: one rounding,
  so on a modular sum it equals ``np.float32(secure_agg.dequantize(total))`` exactly.
* B7: ``q + m`` or ``q - m`` modulo 2^32, where ``m`` is numpy's Philox4x64-10 stream
  (``np.random.Philox``) under the 128-bit key formed from the four folded seed words
  ``(w0 | w1 << 32, w2 | w3 << 32)``.  That is the key the host backend derives from
  the same 32-byte seed (``secure_agg._prg_uint32``), so the card's mask equals the
  host's mask bit for bit.  (The TPU kernel draws the TPU core's own random bits, a
  stream no other device reproduces.)

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
from typing import Sequence

import numpy as np
import torch

from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.ops._common import check_launch, stream_of, uses_kernel

_LOW32 = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

# Philox4x64-10 (Random123 / numpy): multipliers and Weyl key increments.
PHILOX_M0, PHILOX_M1 = 0xD2E7470EE14C6C93, 0xCA5A826395121157
PHILOX_W0, PHILOX_W1 = 0x9E3779B97F4A7C15, 0xBB67AE8584CAA73B
PHILOX_ROUNDS = 10


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    ptr, i64, u64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int
    lib.nf_quantize_u32.argtypes = [ptr, ptr, i64, ctypes.c_float, c_int, ptr]
    lib.nf_dequantize_u32.argtypes = [ptr, ptr, i64, ctypes.c_float, c_int, ptr]
    lib.nf_add_mask.argtypes = [ptr, ptr, i64, u64, u64, c_int, c_int, ptr]
    for fn in (lib.nf_quantize_u32, lib.nf_dequantize_u32, lib.nf_add_mask):
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
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.nf_quantize_u32(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 float(1 << frac_bits), _vec(x, out), stream_of(x))
    check_launch(lib, "quantize_u32", rc)
    quantize_u32.launches += 1
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
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.nf_dequantize_u32(q.data_ptr(), out.data_ptr(), q.shape[0],
                                   1.0 / (1 << frac_bits), _vec(q, out), stream_of(q))
    check_launch(lib, "dequantize_u32", rc)
    dequantize_u32.launches += 1
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


def add_mask_plain(
    q: torch.Tensor, seed: int | Sequence[int] | np.ndarray, sign: int
) -> torch.Tensor:
    """Plain version of :func:`add_mask`: the explicit Philox stream, then the same
    modular add or subtract in int64."""
    mask = torch.from_numpy(philox_stream_plain(seed_key(seed), q.shape[0]).astype(np.int64))
    bits = _bits(q)
    return _from_bits(bits + mask.to(q.device) if sign > 0 else bits - mask.to(q.device))


def add_mask(
    q: torch.Tensor, seed: int | Sequence[int] | np.ndarray, sign: int
) -> torch.Tensor:
    """uint32 ``[n]`` -> ``q + PRG(seed)`` (``sign`` > 0) or ``q - PRG(seed)``
    (``sign`` < 0), modulo 2^32, as a new tensor.  ``seed`` is four 32-bit words (128
    seed bits) or a scalar; the mask is numpy's Philox4x64-10 stream under
    :func:`seed_key`, so two parties with one seed and opposite signs cancel exactly
    and the stream equals the host backend's for the same 32-byte seed."""
    _check_flat("add_mask", "q", q, torch.uint32)
    if sign not in (1, -1):
        raise ValueError(f"add_mask: sign must be +1 or -1, got {sign}")
    if not uses_kernel(q):
        return add_mask_plain(q, seed, sign)
    k0, k1 = seed_key(seed)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.nf_add_mask(q.data_ptr(), out.data_ptr(), q.shape[0], k0, k1,
                             int(sign < 0), _vec(q, out), stream_of(q))
    check_launch(lib, "add_mask", rc)
    add_mask.launches += 1
    return out


add_mask.launches = 0
