"""Device-level profiling helpers (counterpart of ``nanofed_tpu/utils/profiling.py``).

The JAX helpers wrap ``jax.profiler``; these wrap ``torch.profiler``.  :func:`trace`
captures the host and the card's activity of a block and writes it as a Chrome
``trace_event`` file (open at ui.perfetto.dev or chrome://tracing); the coordinators'
spans (``observability.SpanTracer``) and :func:`annotate` blocks appear in it as named
host slices over the kernels they launched.  :func:`device_time` times a callable with
the device drained after every run, the counterpart of ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from nanofed_tpu_torch.utils.logger import Logger

TRACE_FILENAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Capture the enclosed block's host and device activity::

        with trace("runs/profile"):
            coordinator.run_round()

    Records the CPU and, when a card is present, CUDA activity; on exit the capture
    is written under ``log_dir`` as ``trace.json`` (``trace-<pid>-<n>.json`` when that
    name is taken).  Yields the ``torch.profiler.profile`` for callers that read its
    events."""
    out_dir = Path(log_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Logger().info("profiler trace -> %s", out_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the capture ends with the block's device work
    path = out_dir / TRACE_FILENAME
    n = 0
    while path.exists():
        n += 1
        path = out_dir / f"trace-{os.getpid()}-{n}.json"
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named host slice inside a :func:`trace` capture."""
    with torch.profiler.record_function(name):
        yield


def device_time(fn: Callable[[], Any], reps: int = 3) -> dict[str, float]:
    """On-device timing of a nullary callable: one untimed warm-up, then ``reps``
    runs, each ended by ``torch.cuda.synchronize`` (when a card is present) so the
    asynchronous dispatch cannot hide device work.  Returns min/median/max wall
    seconds."""
    import numpy as np

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t)
    return {
        "min_s": float(np.min(times)),
        "median_s": float(np.median(times)),
        "max_s": float(np.max(times)),
    }
