"""Kernel B3: per-row squared L2 norms, ``[C, P] -> [C]``.

Replaces ``nanofed_tpu/ops/dp_reduce.py::row_sq_norms`` (the Pallas
``_sq_norm_kernel``).  The CUDA source is ``csrc/dp_reduce.cu``: a deterministic
two-stage reduction in place of the TPU kernel's in-order grid accumulator; its
header note gives the bound (bytes) and the design.  The round uses it for every
client's ``update_sq_norms``.  ``dp_clipped_mean_flat`` and
``central_dp_reduce_stacked`` come with the central-DP slice.

On CPU tensors :func:`row_sq_norms` takes :func:`row_sq_norms_plain`; on CUDA
tensors it launches the kernel or raises, and counts launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.ops._common import (
    check_launch,
    check_rows,
    stream_of,
    uses_kernel,
    vector_width,
)

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
    row_sq_norms.launches += 1
    return out


row_sq_norms.launches = 0
