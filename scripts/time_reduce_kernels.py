#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels B1 and B2 (``nanofed_tpu_torch/ops/reduce.py``)
on one NVIDIA GPU at every client count the main path launches them with, exactly as
``chip_smoke.py``'s phase 2 does (its ``time_reduce``), for the package of another
checkout.

Run from the root of a checkout::

    python3 scripts/time_reduce_kernels.py [--root DIR]

``--root`` names the checkout whose ``nanofed_tpu_torch`` is timed (default: this
one), for instance an unpacked ``git archive`` of an earlier commit, so that two
versions of the kernels are timed by the same code in one call on one card: run it
for the old, the new, the new and the old tree in turn.  The launch plan and the
kernels' registers are printed where the package has a launch plan.

Then it splits B1's time (normalised form, C = 2, 125 and 1000, the round's layout)
beside cuBLAS's ``w @ x``, three ways: each run alone after the 256 MB L2 flush (as
above), the same with the host's launch work hidden behind a ~0.2 ms device sleep
(if that is faster, the host held the card back), and 20 launches back to back
(no flush between them: what a launch costs inside a stream of work).  Needs a
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose nanofed_tpu_torch is timed")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_reduce_kernels: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.ops import _build, reduce

    spec = importlib.util.spec_from_file_location("chip_smoke_timing", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = smoke.nvidia_smi()
    package = Path(ops.__file__).resolve().parents[1]
    print(f"card: {card}; timing {package}")
    t0 = time.perf_counter()
    logs = _build.build(("reduce",))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in logs.get("reduce", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  reduce: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = smoke.time_reduce(torch, ops, card, gen,
                                show_plan=hasattr(reduce, "launch_plan"))
    print(json.dumps({"package": str(package), "records": records}))
    launch_overhead(torch, ops, smoke, card)


def launch_overhead(torch, ops, smoke, card: str) -> None:
    """B1 normalised and ``w @ x`` timed alone after a flush, with the host's work
    hidden behind a device sleep, and back to back."""
    import statistics

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def alone(fn, sleep_cycles: int = 0, reps: int = 30) -> float:
        for _ in range(5):
            fn()
        events = []
        for _ in range(reps):
            flush.zero_()
            if sleep_cycles:
                torch.cuda._sleep(sleep_cycles)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def back_to_back(fn, n: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # the host enqueues all n launches meanwhile
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for c in (2, 125, 1000):
        x = smoke.round_layout(torch, c, smoke.P_MNIST, seed=c)
        w = torch.rand(c, device="cuda") + 0.5
        for name, fn in (("weighted_mean_flat", lambda: ops.weighted_mean_flat(x, w)),
                         ("w @ x", lambda: w @ x)):
            print(f"[{card}] launch overhead {name} C={c} P={smoke.P_MNIST}: "
                  f"alone_ms={alone(fn):.6f} host_hidden_ms={alone(fn, 400_000):.6f} "
                  f"back_to_back_ms={back_to_back(fn):.6f}")
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
