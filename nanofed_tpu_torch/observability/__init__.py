"""Observability (counterpart of ``nanofed_tpu/observability``), the parts this slice
ports: the metrics registry and the program cost profiler that the autotuner scores
candidates with.  Spans, telemetry, tracing and the critical path come with the
observability slice."""

from nanofed_tpu_torch.observability.profiling import (
    GPU_PEAKS,
    PlatformPeaks,
    ProgramCatalog,
    ProgramCostReport,
    format_cost_table,
    peaks_for_device_kind,
    profile_program,
)
from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry

__all__ = [
    "GPU_PEAKS",
    "MetricsRegistry",
    "PlatformPeaks",
    "ProgramCatalog",
    "ProgramCostReport",
    "format_cost_table",
    "get_registry",
    "peaks_for_device_kind",
    "profile_program",
]
