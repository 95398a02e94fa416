#!/usr/bin/env python3
"""Which collectives torch.distributed runs on CUDA tensors, by backend, on one card.

Starts a world of one rank over NCCL, then worlds of 2 and 4 ranks over gloo whose
ranks all place their tensors on ``cuda:0`` (each rank its own process and CUDA
context), tries ``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and an ``all_reduce`` over a new
group on CUDA tensors, and times an all-reduce of a 1,199,882-float vector (the
``mnist_cnn`` aggregate, 4.8 MB; mean of 5 after one warm call).  Prints one line per
rank; exits non-zero when CUDA is absent.  The port's mesh (``nanofed_tpu_torch.
parallel.mesh``) stages no collective through host memory because every one it uses
ran here on CUDA tensors under gloo.

Run on a machine with a card: ``python3 scripts/probe_gloo_cuda_collectives.py``.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import subprocess
import sys
import tempfile
import time
import traceback

P = 1_199_882


def rank_fn(rank: int, world: int, backend: str, init: str, results) -> None:
    import torch
    import torch.distributed as dist

    out: dict = {}
    try:
        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        x = torch.full((4,), float(rank + 1), device=dev)
        cases = [
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(4 * world, device=dev), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(4 // world if world <= 4 else 1, device=dev),
                torch.ones(4, device=dev))),
            ("all_reduce_subgroup", lambda: dist.all_reduce(
                x.clone(), group=dist.new_group(list(range(world))))),
        ]
        for name, fn in cases:
            try:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out[name] = f"ok {time.perf_counter() - t0:.4f}s"
            except Exception as e:  # noqa: BLE001 - what fails is the probe's answer
                out[name] = f"FAIL {type(e).__name__}: {str(e)[:200]}"
        big = torch.ones(P, device=dev)
        dist.all_reduce(big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(big)
        torch.cuda.synchronize()
        out["allreduce_4.8MB_s"] = (time.perf_counter() - t0) / 5
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the parent
        out["error"] = traceback.format_exc()[-1500:]
    results.put((rank, out))


def world(n: int, backend: str) -> None:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tempfile.mkdtemp()}/rendezvous"
    procs = [ctx.Process(target=rank_fn, args=(r, n, backend, init, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.time() + 120
    while len(got) < n and time.time() < deadline:
        try:
            rank, out = results.get(timeout=5)
            got[rank] = out
        except queue.Empty:
            pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
    print(f"== {backend} world {n}:", flush=True)
    for rank in sorted(got):
        print(rank, got[rank], flush=True)
    if len(got) < n:
        print(f"ranks {sorted(set(range(n)) - set(got))} reported nothing", flush=True)


def main() -> None:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        sys.exit("this probe needs a CUDA device")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)
    print("nccl", dist.is_nccl_available(), "gloo", dist.is_gloo_available())
    world(1, "nccl")
    world(2, "gloo")
    world(4, "gloo")


if __name__ == "__main__":
    main()
