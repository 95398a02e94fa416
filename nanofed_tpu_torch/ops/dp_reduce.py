"""Kernel B3, per-row squared L2 norms ``[C, P] -> [C]``, and the central-DP reduce
built on B3 and B1.

B3 replaces ``nanofed_tpu/ops/dp_reduce.py::row_sq_norms`` (the Pallas
``_sq_norm_kernel``).  The CUDA source is ``csrc/dp_reduce.cu``: a deterministic
two-stage reduction in place of the TPU kernel's in-order grid accumulator; its
header note gives the bound (bytes) and the design.  The round uses it for every
client's ``update_sq_norms`` and for the central-DP clip norms.

:func:`dp_clipped_mean_flat` is ``nanofed_tpu/ops/dp_reduce.py``'s fused clip + mean
(two read passes, no write): B3 for the norms, then B1 with the clip folded into the
weights and the denominator the participant weight sum.

On CPU tensors :func:`row_sq_norms` takes :func:`row_sq_norms_plain`; on CUDA
tensors it launches the kernel or raises, and counts launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

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
from nanofed_tpu_torch.ops.reduce import weighted_mean_flat
from nanofed_tpu_torch.utils.trees import ravel_stacked, unravel

# Columns per stage-1 block: 256 threads x VEC floats x 16 loads each.
_LOADS_PER_THREAD = 16
_THREADS = 256
_MAX_ROWS = 65_535  # the grid's y dimension holds one row per block


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dp_reduce")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.nf_row_sq_norms.argtypes = [ptr, i64, i64, i64, i64, i64, ptr, ptr, ctypes.c_int, ptr]
    lib.nf_row_sq_norms.restype = ctypes.c_int
    return lib


def row_sq_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_sq_norms`."""
    return (x * x).sum(1)


def row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """``[C, P] -> [C]``: ``out[c] = sum_p x[c, p]^2``, one read of ``x``.  ``x`` is
    float32 with contiguous rows; its row stride may exceed P."""
    c, p, ldx = check_rows("row_sq_norms", x)
    if not uses_kernel(x):
        return row_sq_norms_plain(x)
    if c > _MAX_ROWS:
        raise ValueError(f"row_sq_norms: at most {_MAX_ROWS} rows, got {c}")
    vec = vector_width(x, ldx)
    seg_len = _THREADS * vec * _LOADS_PER_THREAD
    nseg = -(-p // seg_len)
    partial = torch.empty((c, nseg), dtype=torch.float32, device=x.device)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.nf_row_sq_norms(
            x.data_ptr(), ldx, c, p, seg_len, nseg, partial.data_ptr(), out.data_ptr(),
            vec, stream_of(x),
        )
    check_launch(lib, "row_sq_norms", rc)
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
