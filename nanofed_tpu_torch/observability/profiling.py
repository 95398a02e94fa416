"""Program cost profiling: what a round program costs when it runs on the device.

Counterpart of ``nanofed_tpu/observability/profiling.py``.  The JAX profiler asks the
compiler: ``lower().compile()`` and XLA's ahead-of-time ``cost_analysis()`` and
``memory_analysis()``, with zero executions.  PyTorch runs eagerly and has no such
cost model for the port's round step (``torch.compile`` is not the port's, and fake
tensors cannot pass through the ctypes-launched kernels), so here
:func:`profile_program` RUNS the program and counts what it did:

1. one first call, timed on the host clock around a device synchronize: the
   time-to-ready (cuDNN's choice of algorithm, kernel loads, the kernels' first
   build), kept under the JAX name ``compile_seconds``;
2. one counting call:

   * FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
     convolutions, forward and backward; elementwise work is not counted), with the
     weight gradient of a grouped convolution counted once per group's share: vmap
     over per-client weights makes every convolution grouped (one group per
     client), and torch's formula counts it as one group, ``groups`` times too many;
   * bytes: the bytes of every aten op's tensor inputs and outputs, from a
     ``TorchDispatchMode`` (eager op-level bytes: no fusion; views and allocations
     move none), plus the bytes each hand-written kernel reports per launch
     (``ops._common.KernelBytes``: a ctypes launch is invisible to dispatch modes);
   * ``peak_bytes``: ``torch.cuda.max_memory_allocated()`` over the call, after
     ``reset_peak_memory_stats()``: everything the process holds on the card at the
     call's peak (0 on the CPU, which keeps no such count);

3. :data:`TIMED_CALLS` more calls, each timed with CUDA events on the card or the
   host clock on the CPU; their median is ``measured_s``.

A program therefore runs ``2 + TIMED_CALLS`` times and must accept the same inputs
again: the port's round step and the epilogue programs do not mutate theirs.

:class:`ProgramCatalog` keeps the JAX package's interface: lazily registered
programs, profiled on demand, published as the ``nanofed_program_*`` gauges and the
time-to-ready histogram under the same names.  :func:`update_device_occupancy`
derives the ``nanofed_device_occupancy_ratio`` gauge the retuner reads from the
coordinator's spans, on the JAX package's two bases.  Not in this slice:
``ProgramCatalog.audit`` (the analysis slice).
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count
from torch.utils._python_dispatch import TorchDispatchMode

from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry
from nanofed_tpu_torch.observability.spans import SPAN_HISTOGRAM
from nanofed_tpu_torch.ops._common import KernelBytes

#: Gauge/histogram names: the JAX package's (``nanofed_tpu/observability/profiling.py``).
PROGRAM_FLOPS_GAUGE = "nanofed_program_flops_total"
PROGRAM_PEAK_BYTES_GAUGE = "nanofed_program_peak_bytes"
PROGRAM_BYTES_ACCESSED_GAUGE = "nanofed_program_bytes_accessed"
PROGRAM_INTENSITY_GAUGE = "nanofed_program_arithmetic_intensity"
PROGRAM_COMPILE_HISTOGRAM = "nanofed_program_compile_seconds"
DEVICE_OCCUPANCY_GAUGE = "nanofed_device_occupancy_ratio"

#: Buckets for time-to-ready, as the JAX package's.
COMPILE_BUCKETS: tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

#: Timed calls after the counting call; ``measured_s`` is their median.
TIMED_CALLS = 3


class PlatformPeaks(NamedTuple):
    """Per-card peak throughputs the roofline is drawn against."""

    flops_per_s: float  # peak matmul FLOP/s at the training compute dtype (bf16)
    hbm_bytes_per_s: float  # peak device-memory bandwidth
    basis: str  # where the numbers come from


_H100_SXM = PlatformPeaks(
    989e12, 3.35e12,
    "NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense (tensor cores), 3.35 TB/s HBM3, "
    "at the 700 W power limit",
)

#: Published per-card peaks, matched against ``torch.cuda.get_device_name()``
#: substrings (lower case).  The H100 SXM part reports itself as "NVIDIA H100 80GB
#: HBM3".  The CPU and any card without a row get NO entry: a made-up peak would make
#: the roofline verdict a fabrication, so those reports say "no peak basis".
GPU_PEAKS: tuple[tuple[str, PlatformPeaks], ...] = (
    ("h100 80gb hbm3", _H100_SXM),
    ("h100 sxm", _H100_SXM),
)


def peaks_for_device_kind(device_kind: str, platform: str) -> PlatformPeaks | None:
    """The peaks row for a card, or None when there is no published basis (the CPU,
    cards not in :data:`GPU_PEAKS`)."""
    if platform != "cuda":
        return None
    kind = device_kind.lower()
    for needle, peaks in GPU_PEAKS:
        if needle in kind:
            return peaks
    return None


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors in nested tuples (named tuples too), lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _nbytes(obj: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def device_of(args: Any) -> torch.device:
    """The device of the first tensor in ``args`` (the CPU when there is none)."""
    for t in _tensors(args):
        return t.device
    return torch.device("cpu")


def device_kind_of(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """torch's ``convolution_backward`` formula with the weight gradient divided by
    ``groups``: each group's weight gradient correlates only its own channels."""

    def t(shape):
        return [shape[1], shape[0], *shape[2:]]

    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0], not transposed)
    if output_mask[1]:
        a, b = (grad_out_shape, x_shape) if transposed else (x_shape, grad_out_shape)
        flops += conv_flop_count(t(a), t(b), t(out_shape[1]), transposed=False) // groups
    return flops


_FLOP_FORMULAS = {torch.ops.aten.convolution_backward: _conv_backward_flop}

# Ops that allocate or re-describe memory without moving its bytes.
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "detach", "lift_fresh", "alias",
})


class _OpBytes(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs (views and
    allocations excluded): eager op-level traffic, with no fusion."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        moves = not getattr(func, "is_view", False)
        if moves and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.total += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


@dataclass(frozen=True)
class ProgramCostReport:
    """One program's counted cost and roofline placement, with the JAX report's fields
    (so artifacts read across) and ``measured_s``.

    ``compile_seconds`` is the first call's time-to-ready; ``measured_s`` the median
    of the timed calls.  ``verdict`` is ``"compute-bound"`` / ``"memory-bound"`` when
    a peaks row exists for the card, else ``"no peak basis"`` (the CPU, unknown
    cards).  A program covering several rounds has ``rounds`` > 1 (the port's
    programs cover one)."""

    program: str
    platform: str
    device_kind: str
    num_devices: int
    rounds: int
    flops: float
    transcendentals: float  # not counted on this basis: always 0
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    generated_code_bytes: int
    peak_bytes: int
    compile_seconds: float
    measured_s: float
    arithmetic_intensity: float  # flops / bytes_accessed (0 when no bytes)
    peaks: PlatformPeaks | None = None
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def ridge_intensity(self) -> float | None:
        """The roofline ridge point (FLOP/byte); None without a peaks basis."""
        if self.peaks is None:
            return None
        return self.peaks.flops_per_s / self.peaks.hbm_bytes_per_s

    @property
    def verdict(self) -> str:
        ridge = self.ridge_intensity
        if ridge is None:
            return "no peak basis"
        if self.arithmetic_intensity >= ridge:
            return "compute-bound"
        return "memory-bound"

    @property
    def lower_bound_s(self) -> float | None:
        """Roofline lower bound on the program's time: the slower of its counted
        FLOPs at the peak rate and its counted bytes at the peak bandwidth.  None
        without a peaks basis."""
        if self.peaks is None:
            return None
        return max(
            self.flops / self.peaks.flops_per_s,
            self.bytes_accessed / self.peaks.hbm_bytes_per_s,
        )

    def mfu(self, walltime_s: float) -> float | None:
        """Counted-FLOPs MFU for a measured time of THIS program.  None without a
        peaks basis or a non-positive time."""
        if self.peaks is None or walltime_s <= 0:
            return None
        return self.flops / walltime_s / self.peaks.flops_per_s

    def to_dict(self) -> dict[str, Any]:
        """JSON-friendly dump with the JAX report's keys plus ``measured_s``."""
        out: dict[str, Any] = {
            "program": self.program,
            "platform": self.platform,
            "device_kind": self.device_kind,
            "num_devices": self.num_devices,
            "rounds": self.rounds,
            "flops": self.flops,
            "flops_per_round": self.flops / self.rounds,
            "transcendentals": self.transcendentals,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_bytes": self.peak_bytes,
            "compile_seconds": round(self.compile_seconds, 4),
            "measured_s": self.measured_s,
            "arithmetic_intensity": round(self.arithmetic_intensity, 4),
            "verdict": self.verdict,
            "basis": (
                "one counted execution: FLOPs from torch.utils.flop_counter "
                "(matmuls and convolutions only), bytes = eager op-level bytes of "
                "every aten op's inputs and outputs (no fusion) + the bytes the "
                "hand-written kernels report; peak_bytes = "
                "torch.cuda.max_memory_allocated over the call (0 on the CPU); "
                "compile_seconds = the first call's time-to-ready; measured_s = the "
                "median of the timed calls"
            ),
        }
        if self.peaks is not None:
            out["peaks_basis"] = self.peaks.basis
            out["ridge_intensity"] = round(self.ridge_intensity, 4)
            out["lower_bound_s"] = self.lower_bound_s
        if self.attrs:
            out["attrs"] = self.attrs
        return out


def profile_program(
    name: str,
    fn: Callable,
    *args: Any,
    rounds: int = 1,
    peaks: PlatformPeaks | None | str = "auto",
    attrs: dict[str, Any] | None = None,
    **kwargs: Any,
) -> ProgramCostReport:
    """Run ``fn(*args, **kwargs)`` ``2 + TIMED_CALLS`` times and report its counted
    cost (see the module note): a first call for time-to-ready, a counting call, and
    :data:`TIMED_CALLS` timed calls.  The program runs on the device of its first tensor
    argument.  ``peaks="auto"`` (default) resolves the peaks table from that device;
    pass an explicit :class:`PlatformPeaks` (tests) or None."""
    device = device_of((args, kwargs))
    cuda = device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    sync()
    compile_seconds = time.perf_counter() - t0

    before = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    with FlopCounterMode(display=False, custom_mapping=_FLOP_FORMULAS) as flop_counter, \
            _OpBytes() as op_bytes, KernelBytes() as kernel_bytes:
        out = fn(*args, **kwargs)
    sync()
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    output_bytes = _nbytes(out)
    temp_bytes = max(0, peak_bytes - before - output_bytes) if cuda else 0
    del out

    times = []
    for _ in range(TIMED_CALLS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)

    platform = device.type
    device_kind = device_kind_of(device)
    if peaks == "auto":
        peaks = peaks_for_device_kind(device_kind, platform)
    flops = float(flop_counter.get_total_flops())
    bytes_accessed = float(op_bytes.total + kernel_bytes.total)
    return ProgramCostReport(
        program=name,
        platform=platform,
        device_kind=device_kind,
        num_devices=1,
        rounds=max(1, int(rounds)),
        flops=flops,
        transcendentals=0.0,
        bytes_accessed=bytes_accessed,
        argument_bytes=_nbytes((args, kwargs)),
        output_bytes=output_bytes,
        temp_bytes=temp_bytes,
        alias_bytes=0,
        generated_code_bytes=0,
        peak_bytes=int(peak_bytes),
        compile_seconds=compile_seconds,
        measured_s=statistics.median(times),
        arithmetic_intensity=flops / bytes_accessed if bytes_accessed > 0 else 0.0,
        peaks=peaks,
        attrs=dict(attrs or {}),
    )


@dataclass
class _CatalogEntry:
    fn: Callable
    args_factory: Callable[[], tuple[tuple, dict]]
    rounds: int
    attrs: dict[str, Any]


class ProgramCatalog:
    """The programs a process has built, profiled on demand.

    ``register`` is free (nothing runs, nothing is allocated): the caller passes a
    LAZY ``args_factory``.  ``profile`` runs :func:`profile_program`, caches the
    report, and publishes the ``nanofed_program_*`` gauges plus the time-to-ready
    histogram into the registry (``registry=None``: the process-wide default).
    Thread-safe."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry
        self._lock = threading.Lock()
        self._entries: dict[str, _CatalogEntry] = {}
        self._reports: dict[str, ProgramCostReport] = {}

    def register(
        self,
        name: str,
        fn: Callable,
        args_factory: Callable[[], tuple[tuple, dict]] | None = None,
        args: tuple = (),
        rounds: int = 1,
        attrs: dict[str, Any] | None = None,
    ) -> None:
        """Add (or replace) a program.  Pass either a lazy ``args_factory`` returning
        ``(args, kwargs)`` (preferred: nothing is made until profile time) or
        concrete ``args``."""
        factory = args_factory if args_factory is not None else (lambda: (args, {}))
        with self._lock:
            self._entries[name] = _CatalogEntry(
                fn=fn, args_factory=factory, rounds=max(1, int(rounds)),
                attrs=dict(attrs or {}),
            )
            self._reports.pop(name, None)

    def remove(self, name: str) -> None:
        """Drop a program and its cached report; no-op when absent."""
        with self._lock:
            self._entries.pop(name, None)
            self._reports.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def registration(
        self, name: str
    ) -> tuple[Callable, Callable[[], tuple[tuple, dict]], int, dict[str, Any]]:
        """The raw registration ``(fn, args_factory, rounds, attrs)``."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"no program {name!r} registered (have {self.names()})")
        return entry.fn, entry.args_factory, entry.rounds, dict(entry.attrs)

    def report(self, name: str) -> ProgramCostReport | None:
        """The cached report, or None if ``profile`` has not run for it."""
        with self._lock:
            return self._reports.get(name)

    def reports(self) -> list[ProgramCostReport]:
        with self._lock:
            return [self._reports[n] for n in sorted(self._reports)]

    def profile(self, name: str, force: bool = False) -> ProgramCostReport:
        """Profile one registered program (cached unless ``force``) and publish its
        gauges."""
        with self._lock:
            entry = self._entries.get(name)
            cached = self._reports.get(name)
        if entry is None:
            raise KeyError(f"no program {name!r} registered (have {self.names()})")
        if cached is not None and not force:
            return cached
        args, kwargs = entry.args_factory()
        report = profile_program(
            name, entry.fn, *args, rounds=entry.rounds, attrs=entry.attrs, **kwargs
        )
        with self._lock:
            self._reports[name] = report
        self.publish(report)
        return report

    def profile_all(self, force: bool = False) -> list[ProgramCostReport]:
        return [self.profile(name, force=force) for name in self.names()]

    def audit(self, name: str, compile: bool = True):
        """The JAX package audits a program's jaxpr (``analysis.program_audit``); the
        port's counterpart comes with the analysis slice (ROADMAP queue A item 21)."""
        raise NotImplementedError(
            "ProgramCatalog.audit: the program audit comes with the analysis slice "
            "(ROADMAP queue A item 21); it is tied to jaxpr in the JAX package"
        )

    def publish(self, report: ProgramCostReport) -> None:
        """Expose one report on the metrics registry: per-program gauges (label
        ``program=``) and the time-to-ready histogram."""
        reg = self.registry or get_registry()
        reg.gauge(
            PROGRAM_FLOPS_GAUGE,
            "Counted FLOPs of one execution of the program (matmuls and convolutions)",
            labels=("program",),
        ).set(report.flops, program=report.program)
        reg.gauge(
            PROGRAM_PEAK_BYTES_GAUGE,
            "Peak device bytes allocated while the program ran (max_memory_allocated)",
            labels=("program",),
        ).set(report.peak_bytes, program=report.program)
        reg.gauge(
            PROGRAM_BYTES_ACCESSED_GAUGE,
            "Counted bytes of one execution (eager op-level + hand-written kernels)",
            labels=("program",),
        ).set(report.bytes_accessed, program=report.program)
        reg.gauge(
            PROGRAM_INTENSITY_GAUGE,
            "Arithmetic intensity (counted FLOPs / counted bytes) of the program",
            labels=("program",),
        ).set(report.arithmetic_intensity, program=report.program)
        reg.histogram(
            PROGRAM_COMPILE_HISTOGRAM,
            "Time-to-ready (the first call) per program",
            labels=("program",),
            buckets=COMPILE_BUCKETS,
        ).observe(report.compile_seconds, program=report.program)


def update_device_occupancy(registry: MetricsRegistry | None = None) -> float | None:
    """Derive ``nanofed_device_occupancy_ratio`` from the span histogram and set the
    gauge; returns the ratio (or None when no spans have been recorded).

    The fraction of orchestration walltime the host spent blocked ON the device — a
    LOWER bound on the device's busy fraction (the device also computes while the
    host enqueues), on the JAX package's two bases:

    * fused blocks: ``host_sync`` (the block's one device barrier) over
      ``dispatch + host_sync + publish``;
    * single rounds: ``local-train`` (which ends in the round's one device barrier,
      so its duration is device time) over ``round + publish``.

    ``publish`` is host time the device spends idle, so it belongs in the
    denominator.  The fused basis wins when both exist."""
    reg = registry or get_registry()
    hist = reg.histogram(SPAN_HISTOGRAM, labels=("span",))
    sync = hist.sample_sum(span="host_sync")
    dispatch = hist.sample_sum(span="dispatch")
    publish = hist.sample_sum(span="publish")
    if sync + dispatch > 0:
        busy, total = sync, sync + dispatch + publish
    else:
        busy = hist.sample_sum(span="local-train")
        total = hist.sample_sum(span="round") + publish
    if total <= 0:
        return None
    ratio = min(1.0, busy / total)
    reg.gauge(
        DEVICE_OCCUPANCY_GAUGE,
        "Host-blocked-on-device fraction of orchestration walltime (lower "
        "bound on device occupancy), derived from dispatch/host_sync spans",
    ).set(ratio)
    return ratio


def format_cost_table(reports: Iterable[ProgramCostReport]) -> str:
    """Human-readable roofline table: one row per program with its counted FLOPs per
    round, peak device bytes, intensity, verdict, the roofline bound per round (when
    a peaks basis exists), time-to-ready and the measured time per round."""
    rows = [(
        "program", "rounds", "flops/round", "peak bytes", "intensity",
        "verdict", "bound s/round", "first call s", "measured s/round",
    )]
    reports = list(reports)
    for r in reports:
        bound = r.lower_bound_s
        rows.append((
            r.program,
            str(r.rounds),
            _si(r.flops / r.rounds),
            _si(r.peak_bytes),
            f"{r.arithmetic_intensity:.2f}",
            r.verdict,
            f"{bound / r.rounds:.3g}" if bound is not None else "-",
            f"{r.compile_seconds:.2f}",
            f"{r.measured_s / r.rounds:.4g}",
        ))
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    lines = []
    for j, row in enumerate(rows):
        lines.append("  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip())
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    if reports:
        first = reports[0]
        lines.append("")
        if first.peaks is not None:
            lines.append(
                f"roofline basis: {first.peaks.basis} "
                f"(ridge {first.ridge_intensity:.1f} FLOP/byte)"
            )
        else:
            lines.append(
                f"roofline basis: none for platform={first.platform!r} "
                f"({first.device_kind}): the counts are real and comparable, the "
                "compute/memory-bound verdict is undefined"
            )
    return "\n".join(lines)


def _si(v: float) -> str:
    """Compact engineering notation (1.23G, 456M, ...)."""
    for factor, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= factor:
            return f"{v / factor:.2f}{suffix}"
    return f"{v:.0f}"
