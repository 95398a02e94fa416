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
  over the valid clients of the deltas with NaN and inf zeroed, in one read pass.

On CPU tensors each takes its plain version (``*_plain``, same module), which is
what the CPU tests hold against the JAX package.  On CUDA tensors it launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``.
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
    check_vector,
    kernel_launched,
    stream_of,
    uses_kernel,
    vector_width,
)
from nanofed_tpu_torch.utils.trees import ravel_stacked, unravel


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("reduce")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.nf_weighted_sum.argtypes = [
        ptr, i64, ptr, i64, i64, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr,
    ]
    lib.nf_weighted_sum.restype = ctypes.c_int
    return lib


def _launch(name: str, x: torch.Tensor, ldx: int, w: torch.Tensor,
            denom: torch.Tensor | None, out: torch.Tensor, accumulate: bool,
            sanitized: bool = False) -> None:
    lib = _lib()
    c, p = x.shape
    with torch.cuda.device(x.device):
        rc = lib.nf_weighted_sum(
            x.data_ptr(), ldx, w.data_ptr(), c, p,
            None if denom is None else denom.data_ptr(), out.data_ptr(),
            int(accumulate), int(sanitized), vector_width(x, ldx), stream_of(x),
        )
    check_launch(lib, name, rc)


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
    x: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_weighted_mean_flat`, as the TPU
    function writes it: normalised coefficients, then the sanitized contraction."""
    w = weights * valid.to(torch.float32)
    coefs = w / torch.clamp(w.sum(), min=1e-12)
    sanitized = torch.where(torch.isfinite(x), x, torch.zeros((), device=x.device))
    return (coefs[:, None] * sanitized).sum(0)


def masked_weighted_mean_flat(
    x: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """``[C, P] x [C] weights x [C] validity -> [P]``: the weighted mean over the VALID
    clients of ``x`` with NaN and inf zeroed, equal to ``weighted_mean_flat(
    sanitize(x), weights * valid)`` with the sanitized stack never written.  ``valid``
    is bool or 0/1; an all-invalid cohort gives zeros.  ``x`` is float32 with
    contiguous rows; its row stride may exceed P."""
    c, p, ldx = check_rows("masked_weighted_mean_flat", x)
    check_vector("masked_weighted_mean_flat", "weights", weights, c)
    if valid.ndim != 1 or valid.shape[0] != c:
        raise ValueError(f"masked_weighted_mean_flat: valid must be [{c}], got "
                         f"{tuple(valid.shape)}")
    if not uses_kernel(x, weights, valid):
        return masked_weighted_mean_flat_plain(x, weights, valid)
    w = weights * valid.to(torch.float32)  # the O(C) coefficient work, beside the kernel
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    _launch("masked_weighted_mean_flat", x, ldx, w, None, out, accumulate=False,
            sanitized=True)
    kernel_launched(masked_weighted_mean_flat,
                    4 * c * p + 4 * c + valid.element_size() * c + 4 * p)
    return out


masked_weighted_mean_flat.launches = 0


def weighted_mean_tree(stacked: Params, weights: torch.Tensor) -> Params:
    """Weighted mean of stacked params (leaves ``[C, ...]``): ravel into one
    ``[C, P]`` matrix, reduce with :func:`weighted_mean_flat`, unravel."""
    like = {name: leaf[0] for name, leaf in stacked.items()}
    return unravel(weighted_mean_flat(ravel_stacked(stacked), weights), like)
