"""Start a world of ranks on one machine (a port-only helper; the JAX package reaches
all of a host's devices from one process, torch reaches several devices only through
several processes).

``spawn_world(fn, world_size, backend=..., device=..., timeout_s=...)`` starts
``world_size`` processes with the ``spawn`` method; each joins the world through a
``file://`` rendezvous in a fresh temporary directory (no port to race for when many
worlds start at once) with :func:`nanofed_tpu_torch.parallel.mesh.
initialize_distributed`, runs ``fn(rank, world_size, *args)`` and sends its return
value back.  The parent waits with one deadline for the whole world: on timeout it
kills every rank and raises ``TimeoutError``; when a rank raises, it gives the others a
moment to report (a rank's failure usually breaks its peers' collectives too), kills
the rest (they would wait in a collective forever) and raises ``RuntimeError`` with
every failed rank's traceback.  A rank on the CPU runs with one thread.  A rank dies
with the process that spawned it (:func:`die_with_parent`): a parent killed by SIGKILL
runs no ``finally`` and would leave its ranks waiting in a collective forever.

``fn`` and its arguments and result cross processes by pickling, so ``fn`` is a
module-level function of an importable module.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import os
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

# Seconds the parent waits for the other ranks' reports once one rank has failed.
FAILURE_GRACE_S = 3.0

#: Linux's ``prctl`` option that has the kernel signal a process when its parent dies.
PR_SET_PDEATHSIG = 1

#: Seconds between two looks at the parent pid where ``prctl`` is missing.
PARENT_POLL_S = 0.5


def die_with_parent(parent_pid: int) -> None:
    """Have this process killed (SIGKILL) once ``parent_pid``, the process that started
    it, is gone, however it ended; a process parked forever (a planned host stall, a
    collective whose peer died) then goes with it.  On Linux the kernel does it
    (``prctl(PR_SET_PDEATHSIG, SIGKILL)``), elsewhere a daemon thread that polls
    ``os.getppid()``.  The parent may have died before the call: the pid is checked
    again after it, which closes that race."""
    try:
        armed = ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) == 0
    except (AttributeError, OSError):
        armed = False
    if os.getppid() != parent_pid:
        os.kill(os.getpid(), signal.SIGKILL)
    if armed:
        return

    def watch() -> None:
        while os.getppid() == parent_pid:
            time.sleep(PARENT_POLL_S)
        os.kill(os.getpid(), signal.SIGKILL)

    threading.Thread(target=watch, name="nanofed-parent-watch", daemon=True).start()


def _rank_main(fn: Callable, rank: int, world_size: int, backend: str, device: str,
               init_method: str, args: tuple, results: Any, parent_pid: int) -> None:
    import torch.distributed as dist

    from nanofed_tpu_torch.parallel.mesh import initialize_distributed

    die_with_parent(parent_pid)
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize_distributed(backend, init_method=init_method, world_size=world_size,
                               rank=rank, local_rank=rank, device=device)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_world(
    fn: Callable,
    world_size: int,
    *,
    backend: str,
    device: str = "cuda",
    timeout_s: float = 120.0,
    args: tuple = (),
) -> list[Any]:
    """Run ``fn(rank, world_size, *args)`` on every rank of a new world; returns the
    ranks' results in rank order.  ``backend`` is ``"nccl"`` or ``"gloo"``,
    ``device`` ``"cuda"`` (rank r on ``cuda:{r % device_count}``) or ``"cpu"``."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdv_dir = Path(tempfile.mkdtemp(prefix="nanofed_world_"))
    init_method = f"file://{rdv_dir / 'rendezvous'}"
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world_size, backend, device, init_method, args, results,
            os.getpid()))
        for rank in range(world_size)
    ]
    out: dict[int, Any] = {}
    failures: dict[int, str] = {}
    first_failure: float | None = None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) + len(failures) < world_size:
            if first_failure is not None:
                # The others' reports, for a moment: the root cause is among them.
                deadline = min(deadline, first_failure + FAILURE_GRACE_S)
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                for i, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and i not in out and i not in failures:
                        # A rank that died without a word (a signal, an abort in C++).
                        failures[i] = f"exited with code {p.exitcode} and reported nothing"
            else:
                if ok:
                    out[rank] = value
                else:
                    failures[rank] = value
            if failures and first_failure is None:
                first_failure = time.monotonic()
        if not failures:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        shutil.rmtree(rdv_dir, ignore_errors=True)
    if failures:
        raise RuntimeError(
            f"ranks {sorted(failures)} of a world of {world_size} failed:\n" + "\n".join(
                f"--- rank {r}:\n{failures[r]}" for r in sorted(failures)))
    if len(out) < world_size:
        missing = sorted(set(range(world_size)) - set(out))
        raise TimeoutError(
            f"ranks {missing} of a world of {world_size} did not finish within "
            f"{timeout_s} s; every rank was killed")
    return [out[r] for r in range(world_size)]
