"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build runs at first use, from the sources in the checkout only, into
``nanofed_tpu_torch/_build/`` (listed in ``.gitignore``).  A library's file name
carries a hash of its sources and flags, so an edited kernel is rebuilt and a stale
one is never loaded.  :func:`build` compiles several sources at once, one ``nvcc``
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("reduce", "dp_reduce", "quantize")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


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
    todo = {name: library_path(name) for name in names if not library_path(name).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
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

