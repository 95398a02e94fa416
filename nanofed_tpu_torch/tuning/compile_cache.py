"""The kernel-build cache as a managed subsystem (counterpart of
``nanofed_tpu/tuning/compile_cache.py``).

The JAX package manages XLA's persistent compilation cache.  The port compiles no
programs; what it builds, and can find again, is its CUDA kernel libraries:
``ops/_build.py`` compiles each ``csrc/<name>.cu`` into a content-hashed
``lib<name>-<hash>.so`` under ``nanofed_tpu_torch/_build/`` (the hash covers the
sources, the shared headers and the ``nvcc`` flags), next to the autotuner's cache of
sweep tables (``.nanofed_torch_cache/``).  This module owns both:

* :func:`install_compile_cache_metrics` — counts ``ops._build``'s events as
  ``nanofed_compile_cache_hits_total`` (a library found by its hash) and
  ``nanofed_compile_cache_misses_total`` (an ``nvcc`` build), the JAX names.
* :func:`build_manifest` / :func:`write_manifest` — inventory a build directory:
  each library's name, hash, bytes and whether today's sources produce that hash, and
  the toolchain (torch, its CUDA, ``nvcc --version``, the ``sm_`` arch, the card).
* :func:`verify_manifest` — the receiving side of a shipped build directory: a
  directory made under another toolchain, or from other sources, is DEAD WEIGHT (its
  libraries will not be loaded; ``ops._build`` compiles anew), as an XLA key miss is for
  the JAX package, and the report says so before a run finds out.
* :func:`warm` — builds every kernel and runs the autotune sweep off the critical
  path (one ``compile`` telemetry record per profiled program), then stamps the
  manifest.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.utils.logger import Logger

__all__ = [
    "COMPILE_CACHE_HITS",
    "COMPILE_CACHE_MISSES",
    "MANIFEST_NAME",
    "WarmResult",
    "build_manifest",
    "install_compile_cache_metrics",
    "verify_manifest",
    "warm",
    "write_manifest",
]

_log = Logger()

COMPILE_CACHE_HITS = "nanofed_compile_cache_hits_total"
COMPILE_CACHE_MISSES = "nanofed_compile_cache_misses_total"

MANIFEST_NAME = "manifest.json"

#: ``lib<name>-<16 hex>.so``, ``ops._build``'s content-addressed file names.
_LIBRARY = re.compile(r"^lib(?P<name>.+)-(?P<hash>[0-9a-f]{16})\.so$")

#: Toolchain fields a library depends on: a mismatch makes the directory dead weight.
_BINARY_DIMS = ("torch", "cuda", "nvcc", "arch")

_metrics_installed = False
#: The registry the FIRST install adopted (listeners stay for the process).
_metrics_registry: Any = None
_metrics_lock = threading.Lock()


def install_compile_cache_metrics(registry: Any = None) -> bool:
    """Count kernel-library cache hits and misses as first-class metrics (idempotent,
    process-wide: only the FIRST caller's registry receives the counters, since the
    build module keeps its listeners).  A warmed directory shows hits equal to the
    libraries loaded and no misses."""
    global _metrics_installed, _metrics_registry
    with _metrics_lock:
        if _metrics_installed:
            return True
        from nanofed_tpu_torch.observability.registry import get_registry

        reg = registry if registry is not None else get_registry()
        hits = reg.counter(
            COMPILE_CACHE_HITS,
            "Kernel-library cache hits (library found by its content hash, no build)",
        )
        misses = reg.counter(
            COMPILE_CACHE_MISSES,
            "Kernel-library cache misses (library compiled by nvcc)",
        )

        def _on_event(event: str, **fields: Any) -> None:
            if event == _build.BUILD_HIT_EVENT:
                hits.inc()
            elif event == _build.BUILD_MISS_EVENT:
                misses.inc()

        _build.add_build_listener(_on_event)
        _metrics_installed = True
        _metrics_registry = reg
        return True


def _nvcc_version() -> str:
    """The release line of ``nvcc --version`` ("not found" without the compiler)."""
    try:
        out = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "not found"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    release = [ln for ln in lines if "release" in ln]
    return (release or lines or ["not found"])[-1]


def _toolchain() -> dict[str, str]:
    import torch

    arch = next((f for f in _build.NVCC_FLAGS if "code=sm_" in f), "")
    available = torch.cuda.is_available()
    return {
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
        "nvcc": _nvcc_version(),
        "arch": arch.split("code=")[-1] if arch else "",
        "device_kind": torch.cuda.get_device_name(0) if available else "cpu",
        "num_devices": str(torch.cuda.device_count() if available else 0),
    }


def _current_hash(name: str) -> str | None:
    """The hash today's sources give library ``name`` (None for a source the
    checkout does not have)."""
    if not (_build.CSRC / f"{name}.cu").exists():
        return None
    match = _LIBRARY.match(_build.library_path(name).name)
    return match.group("hash") if match else None


def build_manifest(
    build_dir: str | os.PathLike | None = None,
    autotune_dir: str | os.PathLike | None = None,
) -> dict[str, Any]:
    """Inventory a build directory (default ``nanofed_tpu_torch/_build``): the
    producing toolchain, every kernel library with its hash, size and whether
    today's sources produce that hash, other files, and the autotune tables under
    ``autotune_dir`` (default: the build directory itself).  Pure read."""
    root = Path(build_dir) if build_dir is not None else _build.BUILD_DIR
    tables = Path(autotune_dir) if autotune_dir is not None else root
    libraries: list[dict[str, Any]] = []
    other_entries = other_bytes = 0
    if root.is_dir():
        for p in sorted(root.iterdir()):
            if not p.is_file() or p.name == MANIFEST_NAME:
                continue
            if p.name.startswith("autotune_") and p.suffix == ".json":
                continue
            match = _LIBRARY.match(p.name)
            if match is None:
                other_entries += 1
                other_bytes += p.stat().st_size
                continue
            name, digest = match.group("name"), match.group("hash")
            libraries.append({
                "file": p.name, "name": name, "hash": digest,
                "bytes": p.stat().st_size, "current": _current_hash(name) == digest,
            })
    autotune_entries: list[dict[str, Any]] = []
    if tables.is_dir():
        for p in sorted(tables.glob("autotune_*.json")):
            entry: dict[str, Any] = {"file": p.name}
            try:
                d = json.loads(p.read_text())
                entry["cache_key"] = d.get("cache_key", "?")[:16]
                entry["winner"] = d.get("winner")
            except (OSError, json.JSONDecodeError):
                entry["error"] = "unreadable"
            autotune_entries.append(entry)
    return {
        "version": 1,
        "created_unix": round(time.time(), 3),
        "cache_dir": str(root),
        "toolchain": _toolchain(),
        "libraries": libraries,
        "library_bytes": sum(lib["bytes"] for lib in libraries),
        "other_entries": other_entries,
        "other_bytes": other_bytes,
        "autotune_entries": autotune_entries,
    }


def write_manifest(
    build_dir: str | os.PathLike | None = None, extra: dict[str, Any] | None = None,
    autotune_dir: str | os.PathLike | None = None,
) -> Path:
    """Stamp ``manifest.json`` into the build directory (atomic rename)."""
    root = Path(build_dir) if build_dir is not None else _build.BUILD_DIR
    root.mkdir(parents=True, exist_ok=True)
    manifest = build_manifest(root, autotune_dir)
    if extra:
        manifest.update(extra)
    path = root / MANIFEST_NAME
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    tmp.replace(path)
    return path


def verify_manifest(build_dir: str | os.PathLike | None = None) -> dict[str, Any]:
    """Does the directory's manifest match THIS host and THESE sources?  Returns
    ``{"compatible": bool, "reasons": [...], "dead_weight": [files], "manifest":
    ...}``; never raises on a missing or corrupt manifest (that is itself a reason).
    A library built under another torch, CUDA, ``nvcc`` or arch, or from sources
    whose hash differs from today's, is dead weight: ``ops._build`` will not load it."""
    root = Path(build_dir) if build_dir is not None else _build.BUILD_DIR
    path = root / MANIFEST_NAME
    reasons: list[str] = []
    dead: list[str] = []
    manifest: dict[str, Any] | None = None
    try:
        manifest = json.loads(path.read_text())
    except OSError:
        reasons.append(f"no manifest at {path} (directory never warmed, or not shipped)")
    except json.JSONDecodeError as e:
        reasons.append(f"manifest unreadable: {e}")
    if manifest is not None:
        shipped = manifest.get("toolchain", {})
        here = _toolchain()
        libraries = manifest.get("libraries", [])
        for dim in _BINARY_DIMS:
            if shipped.get(dim) != here[dim]:
                reasons.append(
                    f"{dim} mismatch: built under {shipped.get(dim)!r}, this host runs "
                    f"{here[dim]!r} — its libraries are dead weight"
                )
                dead.extend(lib["file"] for lib in libraries)
        if shipped.get("device_kind") != here["device_kind"]:
            reasons.append(
                f"device_kind differs: {shipped.get('device_kind')!r} vs "
                f"{here['device_kind']!r} — autotune tables keyed elsewhere"
            )
        for lib in libraries:
            current = _current_hash(lib.get("name", ""))
            if current != lib.get("hash"):
                reasons.append(
                    f"{lib['file']}: built from other sources (today's hash "
                    f"{current}) — dead weight, ``ops._build`` compiles anew"
                )
                dead.append(lib["file"])
            elif not (root / lib["file"]).exists():
                reasons.append(f"{lib['file']}: listed but missing")
    return {
        "compatible": not reasons,
        "reasons": reasons,
        "dead_weight": sorted(set(dead)),
        "manifest": manifest,
    }


@dataclass
class WarmResult:
    """What :func:`warm` did: where the libraries live, what was profiled, the
    stamped manifest and the sweep."""

    cache_dir: str
    manifest_path: str
    manifest: dict[str, Any]
    autotune: Any = None
    programs: list[dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "cache_dir": self.cache_dir,
            "manifest_path": self.manifest_path,
            "manifest": self.manifest,
            "programs": self.programs,
            **(
                {"autotune": self.autotune.telemetry_payload()}
                if self.autotune is not None else {}
            ),
        }


def warm(
    model: Any,
    population: Any,
    training: Any = None,
    *,
    num_rounds: int,
    participation: float = 1.0,
    eval_every: int = 0,
    space: Any = None,
    adapter: Any = None,
    cache_dir: str | os.PathLike | None = None,
    build_dir: str | os.PathLike | None = None,
    telemetry: Any = None,
    force: bool = False,
    compile_budget_s: float | None = None,
    candidate_deadline_s: float | None = None,
    device: Any = None,
) -> WarmResult:
    """Build every kernel (on the card; the CPU runs the plain versions and builds
    nothing) and run the :func:`~nanofed_tpu_torch.tuning.autotuner.autotune` sweep
    into ``cache_dir`` (default ``.nanofed_torch_cache``) off the critical path —
    without the epilogue table, as the JAX warm pass — with one ``compile``
    telemetry record per profiled program when ``telemetry`` is given, the hit/miss
    counters installed, and the build directory stamped with a manifest that lists
    the sweep's table."""
    from nanofed_tpu_torch.core.device import resolve_device
    from nanofed_tpu_torch.tuning.autotuner import (
        DEFAULT_CACHE_DIR,
        autotune,
        candidate_program_name,
    )

    dev = resolve_device(device)
    tables = Path(cache_dir) if cache_dir is not None else Path(DEFAULT_CACHE_DIR)
    install_compile_cache_metrics()
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build()
    result = autotune(
        model, population, training,
        num_rounds=num_rounds, participation=participation,
        eval_every=eval_every, space=space, adapter=adapter,
        cache_dir=tables, out_dir=None, telemetry=telemetry, force=force,
        include_epilogues=False,
        compile_budget_s=compile_budget_s,
        candidate_deadline_s=candidate_deadline_s,
        device=dev,
    )
    # On a sweep cache hit nothing ran THIS pass.
    programs = [] if result.cache_hit else [
        {
            "program": candidate_program_name(o.config),
            "compile_seconds": o.cost["compile_seconds"],
            "feasible": o.feasible,
        }
        for o in result.outcomes
        if o.cost.get("compile_seconds") is not None
    ]
    manifest_path = write_manifest(build_dir, autotune_dir=tables, extra={
        "warmed": {
            "model": getattr(model, "name", type(model).__name__),
            "cache_key": result.cache_key[:16],
            "programs": programs,
            "compiles": result.compiles,
            "compile_seconds_total": round(result.compile_seconds_total, 4),
            "cache_hit": result.cache_hit,
            "warm_seconds": round(time.perf_counter() - t0, 4),
        },
    })
    _log.info(
        "kernel cache warmed at %s: %d programs, %.1fs first calls (%s)",
        manifest_path.parent, result.compiles, result.compile_seconds_total,
        "autotune cache hit" if result.cache_hit else "fresh sweep",
    )
    return WarmResult(
        cache_dir=str(manifest_path.parent),
        manifest_path=str(manifest_path),
        manifest=json.loads(Path(manifest_path).read_text()),
        autotune=result,
        programs=programs,
    )
