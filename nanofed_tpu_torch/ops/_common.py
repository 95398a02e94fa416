"""The dispatch rule shared by the port's kernels, and their launch bookkeeping.

A wrapper takes its plain PyTorch version only because the tensors it was given lie
on the CPU.  For CUDA tensors it launches the hand-written kernel or raises: there
is no ``try`` that falls back.  (Counterpart of ``nanofed_tpu/ops/_common.py``'s
``auto_interpret``, which picked the Pallas interpreter off the TPU.)

Where it launches, a wrapper calls :func:`kernel_launched`: one more on its
``.launches`` count, and the bytes the kernel's function must move (each input read
once, each output written once: the formula of ``PERF.md``'s bound column) to every
open :class:`KernelBytes`.  The profiler (``observability.profiling``) counts those,
because a ctypes launch is invisible to PyTorch's dispatch modes.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable

import torch

_open_byte_counts: list["KernelBytes"] = []


class KernelBytes:
    """While entered, sums the bytes each hand-written kernel reports per launch
    (``by_kernel``: wrapper name -> bytes)."""

    def __init__(self) -> None:
        self.by_kernel: dict[str, int] = {}

    @property
    def total(self) -> int:
        return sum(self.by_kernel.values())

    def __enter__(self) -> "KernelBytes":
        _open_byte_counts.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        _open_byte_counts.remove(self)


def kernel_launched(wrapper: Callable, nbytes: int) -> None:
    """Count one launch of ``wrapper``'s kernel, which moved ``nbytes``."""
    wrapper.launches += 1
    name = wrapper.__name__
    for counts in _open_byte_counts:
        counts.by_kernel[name] = counts.by_kernel.get(name, 0) + int(nbytes)


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors and for ``meta`` tensors (a shape
    trace, as the analysis' contract checks and program audit run: a meta tensor
    computes nothing, so the plain version hides no kernel); anything else (mixed
    devices, other device types) raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"tensors on several GPUs: {sorted(str(t.device) for t in tensors)}")
        return True
    raise ValueError(f"tensors must all be on the CPU or all on one GPU, got {sorted(kinds)}")


def check_rows(name: str, x: torch.Tensor) -> tuple[int, int, int]:
    """Validate a ``[C, P]`` float32 matrix whose rows are contiguous (the row
    stride may exceed P, so rows can be padded to an aligned start).  Returns
    ``(C, P, row_stride)``."""
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be [C, P], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    c, p = x.shape
    if c < 1 or p < 1:
        raise ValueError(f"{name}: x must have C >= 1 and P >= 1, got {tuple(x.shape)}")
    ldx = x.stride(0) if c > 1 else p
    if x.stride(1) != 1 or ldx < p:
        raise ValueError(
            f"{name}: rows of x must be contiguous (strides {x.stride()} for shape "
            f"{tuple(x.shape)})"
        )
    return c, p, ldx


def check_int8_rows(name: str, q: torch.Tensor) -> tuple[int, int, int]:
    """:func:`check_rows` for an int8 ``[C, P]`` stack (the wire dtype): rows
    contiguous, row stride >= P.  Raises ``TypeError`` for any other dtype.  Returns
    ``(C, P, row_stride)``."""
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8 (the wire dtype), got {q.dtype}")
    if q.ndim != 2:
        raise ValueError(f"{name}: q must be [C, P], got shape {tuple(q.shape)}")
    c, p = q.shape
    if c < 1 or p < 1:
        raise ValueError(f"{name}: q must have C >= 1 and P >= 1, got {tuple(q.shape)}")
    ldq = q.stride(0) if c > 1 else p
    if q.stride(1) != 1 or ldq < p:
        raise ValueError(
            f"{name}: rows of q must be contiguous (strides {q.stride()} for shape "
            f"{tuple(q.shape)})"
        )
    return c, p, ldq


def int8_vector_width(q: torch.Tensor, ldq: int) -> int:
    """Widest load (16, 8, 4, 2 or 1 int8) that keeps every row start of ``q``
    aligned: a 16-byte row stride lets the whole stack load 16 bytes at a time."""
    for vec in (16, 8, 4, 2):
        if ldq % vec == 0 and q.data_ptr() % vec == 0:
            return vec
    return 1


def check_vector(name: str, what: str, v: torch.Tensor, n: int) -> None:
    if v.ndim != 1 or v.shape[0] != n:
        raise ValueError(f"{name}: {what} must be [{n}], got shape {tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def vector_width(x: torch.Tensor, ldx: int) -> int:
    """Widest load (4, 2 or 1 floats) that keeps every row start of ``x`` aligned."""
    for vec in (4, 2):
        if ldx % vec == 0 and x.data_ptr() % (4 * vec) == 0:
            return vec
    return 1


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host tensor (a kernel's argument table) on ``device``: on a card, a
    copy from pinned memory on the current stream, so the host does not wait for the
    card (PyTorch keeps the pinned buffer until the copy has run)."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as the kernels take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs, and a
    later synchronize would not report it)."""
    if rc != 0:
        msg = lib.nf_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}: {msg}")
