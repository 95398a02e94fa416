#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels B1 and B2 (``nanofed_tpu_torch/ops/reduce.py``)
and B3 (``nanofed_tpu_torch/ops/dp_reduce.py``) on one NVIDIA GPU at every shape the
main path launches them with, B1/B2 exactly as ``chip_smoke.py``'s phase 2 does (its
``time_reduce``), for the package of another checkout.

Run from the root of a checkout::

    python3 scripts/time_reduce_kernels.py [--root DIR] [--kernels all|b1b2|b3]

``--root`` names the checkout whose ``nanofed_tpu_torch`` is timed (default: this
one), for instance an unpacked ``git archive`` of an earlier commit, so that two
versions of the kernels are timed by the same code in one call on one card: run it
for the old, the new, the new and the old tree in turn.  The kernels' registers and
spills are printed from the build, and each launch plan where the package has one.

B1/B2: then B1's time (normalised form, C = 2, 125 and 1000, the round's layout) is
split beside cuBLAS's ``w @ x`` three ways: each run alone after the 256 MB L2 flush
(as above), the same with the host's launch work hidden behind a ~0.2 ms device sleep
(if that is faster, the host held the card back), and 20 launches back to back (no
flush between them: what a launch costs inside a stream of work).

B3: ``row_sq_norms`` at each of ``B3_SHAPES`` on the round's layout (rows padded to 4
floats), after the flush: the kernel (also after a read flush, which leaves L2 clean
where the write flush leaves it dirty), the wrapper's host time a call, its plain
version, ``torch.linalg.vecdot(x, x)``, B1's normalised form over the same bytes, and
the bound.  ``--b3-sweep`` also times B3's kernel over other plans than the package's
own, through its C entry (a package with ``dp_reduce.row_sq_plan``).  Needs a card;
imports nothing of JAX.
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
    parser.add_argument("--kernels", choices=("all", "b1b2", "b3"), default="all",
                        help="time B1/B2 (with the launch split), B3, or all")
    parser.add_argument("--b3-sweep", action="store_true",
                        help="also time B3 over other plans (segments a row, ring stages)")
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
    logs = _build.build(("reduce", "dp_reduce"))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name in ("reduce", "dp_reduce"):
        for line in logs.get(name, "").splitlines():
            if "Compiling" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    if args.kernels in ("all", "b1b2"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        records = smoke.time_reduce(torch, ops, card, gen,
                                    show_plan=hasattr(reduce, "launch_plan"))
        print(json.dumps({"package": str(package), "records": records}))
        launch_overhead(torch, ops, smoke, card)
    if args.kernels in ("all", "b3"):
        print(json.dumps({"package": str(package), "b3": time_row_sq(torch, ops, smoke, card)}))
    if args.b3_sweep:
        from nanofed_tpu_torch.ops import dp_reduce

        if hasattr(dp_reduce, "row_sq_plan"):
            sweep_row_sq(torch, smoke, card)
        else:
            print(f"--b3-sweep: {package} has no B3 launch plan to sweep")


# B3 at every shape the main path launches it with: (C, P, the paths that launch it).
B3_SHAPES = (
    (125, 1_199_882, "8 a flagship round (b); 2 a (w2) rank"),
    (100, 1_199_882, "1 a SCAFFOLD round (m)"),
    (25, 1_199_882, "4 central DP (d); 40 a DP-SGD round (l)"),
    (8, 11_218_340, "1 a cross_silo round (t2), (t3)"),
    (10, 77_850, "1 a fedprox_cifar10 round (t1)"),
    (8, 1_398_784, "1 a base adapter round (v1), (v3)"),
    (8, 97_745_408, "1 a base dense round (v2)"),
    (2, 97_745_408, "4 a (w3) rank, dense"),
    (2, 1_398_784, "4 a (w3) rank, adapter"),
    (2, 1_199_882, "1 a tutorial round (a)"),
)


def sweep_row_sq(torch, smoke, card: str) -> None:
    """B3's ring over other plans than its own at the shapes its plan was chosen on:
    S segments a row (SMs / 4 to 2 x SMs) x 2, 3, 4 or 6 stages on a balanced grid of
    at most 2 blocks an SM, and 2 or 3 stages at 3 blocks an SM (64 registers a thread
    allow 3), in one launch each, through ``nf_row_sq_norms`` with the sweep's own
    workspace."""
    from nanofed_tpu_torch.ops import dp_reduce
    from nanofed_tpu_torch.ops._common import check_launch, stream_of
    from nanofed_tpu_torch.ops.reduce import STAGE_BYTES, sm_count

    lib = dp_reduce._lib()
    sms = sm_count(0)
    for c, p, _ in B3_SHAPES:
        if 4 * c * p > 1 << 30:
            continue
        x = smoke.round_layout(torch, c, p, seed=c + p)
        ldx = x.stride(0)
        out = torch.empty(c, device="cuda")
        tickets = torch.zeros(c, dtype=torch.int32, device="cuda")
        partial = torch.empty(c * 2 * sms * dp_reduce.WARP_PARTIALS, device="cuda")
        own = dp_reduce.row_sq_plan(c, p, ldx, 4, sms)

        def launch(segments: int, blocks: int, stages: int) -> None:
            check_launch(lib, "row_sq_norms sweep", lib.nf_row_sq_norms(
                x.data_ptr(), ldx, c, p, 4, segments, blocks, stages, stages * STAGE_BYTES,
                partial.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream_of(x)))

        times = []
        for segments in (sms // 4, sms // 2, sms, 2 * sms):
            pairs = c * segments
            for per_sm, depths in ((2, (2, 3, 4, 6)), (3, (2, 3))):
                blocks = -(-pairs // -(-pairs // (per_sm * sms)))
                for stages in depths:
                    ms = smoke.median_ms(lambda: launch(segments, blocks, stages), torch)
                    times.append((ms, segments, per_sm, stages))
        times.sort()
        print(f"[{card}] row_sq_norms sweep C={c} P={p} (own plan: segments={own.segments} "
              f"stages={own.stages} blocks={own.blocks}): " + ", ".join(
                  f"S={s} per_sm={k} stages={st}: {ms:.6f}" for ms, s, k, st in times))
        del x
        torch.cuda.empty_cache()


def time_row_sq(torch, ops, smoke, card: str) -> list[dict]:
    """B3 at each of ``B3_SHAPES``: the kernel, the wrapper's host time a call, its
    plain version, ``vecdot``, B1 over the same bytes and the bound (ms, medians after
    the flush)."""
    from nanofed_tpu_torch.ops import dp_reduce

    records = []
    for c, p, paths in B3_SHAPES:
        x = smoke.round_layout(torch, c, p, seed=c + p)
        w = torch.rand(c, device="cuda") + 0.5
        got = ops.row_sq_norms(x)
        err = smoke.check_close(torch, f"row_sq_norms C={c} P={p}", got,
                                ops.row_sq_norms_plain(x), **smoke.TOL)
        ms = smoke.median_ms(lambda: ops.row_sq_norms(x), torch)
        read_ms = smoke.median_ms(lambda: ops.row_sq_norms(x), torch, flush="read")
        host_ms = smoke.host_ms(lambda: ops.row_sq_norms(x), torch)
        plain_ms = smoke.median_ms(lambda: ops.row_sq_norms_plain(x), torch)
        library_ms = smoke.median_ms(lambda: torch.linalg.vecdot(x, x), torch)
        b1_ms = smoke.median_ms(lambda: ops.weighted_mean_flat(x, w), torch)
        b_ms, b_by = smoke.bound_ms(4 * c * p + 4 * c, 2 * c * p)
        line = (f"[{card}] row_sq_norms C={c} P={p} ({paths}): kernel_ms={ms:.6f} "
                f"read_flush_ms={read_ms:.6f} "
                f"host_ms={host_ms:.6f} (the wrapper's host time a call) "
                f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
                f"(torch.linalg.vecdot(x, x)) b1_ms={b1_ms:.6f} (weighted_mean_flat, same "
                f"bytes) bound_ms={b_ms:.6f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
                f"max_abs_err={err:.3e}")
        if hasattr(dp_reduce, "row_sq_plan_for"):
            line += " " + smoke.row_sq_plan_line(torch, x)
        print(line)
        records.append(dict(c=c, p=p, ms=ms, read_flush_ms=read_ms, host_ms=host_ms,
                            plain_ms=plain_ms,
                            library_ms=library_ms, b1_ms=b1_ms, bound_ms=b_ms, bound_by=b_by,
                            max_abs_err=err))
        del x, got
        torch.cuda.empty_cache()
    return records


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
