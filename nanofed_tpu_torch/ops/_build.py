"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build runs at first use, from the sources in the checkout only, into
``nanofed_tpu_torch/_build/`` (listed in ``.gitignore``).  A library's file name
carries a hash of its sources and flags, so an edited kernel is rebuilt and a stale
one is never loaded.  :func:`build` compiles several sources at once, one ``nvcc``
process each.

Every library :func:`build` is asked for is reported to the build listeners
(:func:`add_build_listener`): a library found by its content hash as
:data:`BUILD_HIT_EVENT`, one compiled by ``nvcc`` as :data:`BUILD_MISS_EVENT` with its
seconds.  ``observability.install_torch_event_bridge`` and
``tuning.install_compile_cache_metrics`` count them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("reduce", "dp_reduce", "quantize")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Build events: a library found by its content hash, or built by ``nvcc`` (with
#: ``seconds``, the build's wall time, observed under :data:`BUILD_SECONDS_EVENT`).
BUILD_HIT_EVENT = "/nanofed_torch/kernel_build/cache_hits"
BUILD_MISS_EVENT = "/nanofed_torch/kernel_build/cache_misses"
BUILD_SECONDS_EVENT = "/nanofed_torch/kernel_build/nvcc_seconds"

_loaded: dict[str, ctypes.CDLL] = {}
_listeners: list[Callable[..., None]] = []
_listeners_lock = threading.Lock()


def add_build_listener(listener: Callable[..., None]) -> None:
    """Call ``listener(event, name=..., [seconds=...])`` for every later build event.
    Listeners stay for the life of the process."""
    with _listeners_lock:
        _listeners.append(listener)


def _emit(event: str, **fields: Any) -> None:
    with _listeners_lock:
        listeners = list(_listeners)
    for listener in listeners:
        listener(event, **fields)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's CUDA "
        "kernels are compiled from nanofed_tpu_torch/ops/csrc at first use"
    )


def library_path(name: str) -> Path:
    """Content-addressed path of ``lib<name>-<hash>.so``."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all ``nvcc``
    processes at once.  Returns each compiled source's compiler output (``ptxas``
    register and shared-memory lines); raises with that output if one fails."""
    todo = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            _emit(BUILD_HIT_EVENT, name=name)
        else:
            todo[name] = target
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )

    def wait(proc: subprocess.Popen) -> tuple[str, float]:
        out, _ = proc.communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        waited = {name: pool.submit(wait, proc) for name, (proc, _, _) in procs.items()}
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, seconds = waited[name].result()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
            _emit(BUILD_MISS_EVENT, name=name, seconds=seconds)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[name] for name in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.nf_error_string.argtypes = [ctypes.c_int]
        lib.nf_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib

