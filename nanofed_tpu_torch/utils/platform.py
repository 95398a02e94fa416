"""Bring-up helpers (counterpart of ``nanofed_tpu/utils/platform.py``): a timestamped
progress line and a watchdog for a stage that may hang in native code.

Only :func:`log_stage` and :func:`deadline` have a meaning here.  The JAX module's
``force_cpu_mesh`` forces a virtual multi-device CPU platform on JAX; PyTorch has no
platform to force (a tensor's device is chosen per call, ``device="cpu"``), so it has
no counterpart.  ``init_devices_or_die`` and ``enable_compilation_cache`` guard JAX's
backend init and XLA's compile cache, which do not exist here either.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Iterator


def log_stage(msg: str, *, t0: float | None = None) -> None:
    """Timestamped progress line on stderr (flushed), so a killed process leaves a
    diagnostic tail showing the last stage reached."""
    stamp = time.strftime("%H:%M:%S")
    rel = f" +{time.time() - t0:7.1f}s" if t0 is not None else ""
    print(f"[{stamp}{rel}] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def deadline(
    stage: str, timeout_s: float, *, error_json: dict | None = None, exit_code: int = 3
) -> Iterator[None]:
    """Bound a stage that may hang in native code (a device init, a first kernel
    build).  A daemon watchdog thread fires after ``timeout_s``: it prints a
    diagnostic to stderr, optionally a JSON line to stdout, then ``os._exit`` — the
    only way out when the main thread is stuck inside a call that never returns."""
    done = threading.Event()

    def watchdog() -> None:
        if done.wait(timeout_s):
            return
        print(
            f"[watchdog] stage '{stage}' exceeded {timeout_s:.0f}s — "
            "device or build likely wedged; aborting with diagnostic instead of hanging",
            file=sys.stderr,
            flush=True,
        )
        if error_json is not None:
            payload = dict(error_json)
            payload.setdefault("error", f"{stage} timed out after {timeout_s:.0f}s")
            print(json.dumps(payload), flush=True)
        os._exit(exit_code)

    t = threading.Thread(target=watchdog, name=f"deadline-{stage}", daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
