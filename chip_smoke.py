#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nanofed_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one card and
exits non-zero when there is none, or when ``nanofed_tpu_torch`` is not beside it.
It imports nothing of JAX or of the JAX package ``nanofed_tpu``.

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions, and the
   kernel build (one ``nvcc`` per source in ``nanofed_tpu_torch/ops/csrc``, all
   started together) with its wall time.
2. Kernels: B1 (``weighted_mean_flat`` and ``weighted_sum_into``) and B3
   (``row_sq_norms``) against their plain PyTorch versions on the card, on ragged
   shapes and weight cases and at the round's shapes (C = 2 and 125 clients,
   P = 1,199,882).  At those shapes each kernel, its plain version and one library
   call are timed with CUDA events (median of 30 runs after 5 warm-up runs, L2
   flushed before each run), beside the least time the card could take.
3. Slice: ``run_experiment`` on the card at full ``mnist_cnn`` width, (a) the
   2-client tutorial shape (12k + 4k samples, 2 epochs, batch 64, SGD lr 0.1, f32,
   1 round) and (b) the 1000-client flagship (60 samples each, 2 epochs, batch 64,
   bf16, ``client_chunk=125``, 2 rounds).  The kernels' launch counts are zeroed just
   before and read just after; every kernel must have run, as often as the round's
   chunks say.
4. Cross-check: one 8-client f32 round of the port on the card and on the CPU from
   the same weights, with the same injected permutations and dropout off.

The last lines are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
P_MNIST = 1_199_882
# f32 sums taken in another order than the plain version's: up to 125 products of
# magnitude ~1 (B1's accumulate form keeps the un-normalised sum, whose rounding error
# reaches ~1e-5) or 1.2M squares (B3, held by rtol).
TOL = dict(rtol=1e-5, atol=1e-4)
CROSS_TOL = 1e-4  # cuDNN vs CPU convolutions summed in another order, 4 SGD steps, TF32 off


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, torch, reps: int = 30, warmup: int = 5) -> float:
    """Median time of ``fn`` on the card, each run timed alone with CUDA events after
    overwriting a 256 MB buffer (the 50 MB L2 holds none of the inputs)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def round_layout(torch, c: int, p: int, seed: int):
    """A [c, p] float32 view with rows padded to a multiple of 4 floats, as the round
    hands the kernels its client deltas."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.empty((c, -(-p // 4) * 4), device="cuda")
    buf.normal_(generator=gen)
    return buf[:, :p]


def check_close(torch, name: str, got, want, **tol) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    try:
        torch.testing.assert_close(got, want, **tol)
    except AssertionError as e:
        fail(f"{name}: kernel disagrees with its plain version: {e}")
    return float((got - want).abs().max())


def phase_kernels(torch, ops, card: str) -> dict[str, dict]:
    """Hold B1 (both forms) and B3 against their plain versions; time them at the
    round's shapes.  Returns the per-kernel record of the flagship shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    cases = 0
    for c, p in [(1, 1000), (7, 1000), (1, 1537), (7, 1537), (2, P_MNIST)]:
        for layout in ("contiguous", "round"):
            x = rand(c, p) if layout == "contiguous" else round_layout(torch, c, p, seed=c + p)
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            for wcase in ("random", "some_zero", "all_zero", "denom_float", "denom_tensor"):
                wc, denom = w.clone(), None
                if wcase == "some_zero":
                    wc[::2] = 0.0
                elif wcase == "all_zero":
                    wc.zero_()
                elif wcase == "denom_float":
                    denom = 11.5
                elif wcase == "denom_tensor":
                    denom = torch.tensor(3.25, device="cuda")
                tag = f"c={c} p={p} {layout} {wcase}"
                check_close(torch, f"weighted_mean_flat {tag}",
                            ops.weighted_mean_flat(x, wc, denom),
                            ops.weighted_mean_flat_plain(x, wc, denom), **TOL)
                if wcase == "all_zero" and ops.weighted_mean_flat(x, wc).abs().max() != 0:
                    fail(f"weighted_mean_flat {tag}: all-zero weights must give zeros")
                acc = rand(p)
                want = ops.weighted_sum_into_plain(acc.clone(), x, wc)
                got = ops.weighted_sum_into(acc, x, wc)
                if got.data_ptr() != acc.data_ptr():
                    fail("weighted_sum_into must update acc in place")
                check_close(torch, f"weighted_sum_into {tag}", got, want, **TOL)
                cases += 2
            check_close(torch, f"row_sq_norms c={c} p={p} {layout}", ops.row_sq_norms(x),
                        ops.row_sq_norms_plain(x), **TOL)
            cases += 1
    print(f"kernels: {cases} cases agree with the plain versions (rtol {TOL['rtol']}, "
          f"atol {TOL['atol']})")

    records = {}
    for c in (2, 125):
        x = round_layout(torch, c, P_MNIST, seed=c)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        acc = torch.zeros(P_MNIST, device="cuda")
        n_in = 4 * c * P_MNIST + 4 * c
        specs = {
            "weighted_mean_flat": dict(
                kernel=lambda: ops.weighted_mean_flat(x, w),
                plain=lambda: ops.weighted_mean_flat_plain(x, w),
                library=("w @ x", lambda: w @ x),
                bound=bound_ms(n_in + 4 * P_MNIST, 2 * c * P_MNIST),
                err=check_close(torch, "weighted_mean_flat", ops.weighted_mean_flat(x, w),
                                ops.weighted_mean_flat_plain(x, w), **TOL),
            ),
            "weighted_sum_into": dict(
                kernel=lambda: ops.weighted_sum_into(acc, x, w),
                plain=lambda: ops.weighted_sum_into_plain(acc, x, w),
                library=("acc.addmv_(x.t(), w)", lambda: acc.addmv_(x.t(), w)),
                bound=bound_ms(n_in + 8 * P_MNIST, 2 * c * P_MNIST),
                err=check_close(torch, "weighted_sum_into",
                                ops.weighted_sum_into(torch.zeros_like(acc), x, w),
                                ops.weighted_sum_into_plain(torch.zeros_like(acc), x, w), **TOL),
            ),
            "row_sq_norms": dict(
                kernel=lambda: ops.row_sq_norms(x),
                plain=lambda: ops.row_sq_norms_plain(x),
                library=("torch.linalg.vecdot(x, x)", lambda: torch.linalg.vecdot(x, x)),
                bound=bound_ms(n_in, 2 * c * P_MNIST),
                err=check_close(torch, "row_sq_norms", ops.row_sq_norms(x),
                                ops.row_sq_norms_plain(x), **TOL),
            ),
        }
        for name, spec in specs.items():
            lib_name, lib_fn = spec["library"]
            ms = median_ms(spec["kernel"], torch)
            plain_ms = median_ms(spec["plain"], torch)
            library_ms = median_ms(lib_fn, torch)
            b_ms, b_by = spec["bound"]
            print(f"[{card}] {name} C={c} P={P_MNIST}: kernel_ms={ms:.6f} "
                  f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} ({lib_name}) "
                  f"bound_ms={b_ms:.6f} ({b_by}) max_abs_err={spec['err']:.3e}")
            if name == "row_sq_norms":
                sq_ms = median_ms(lambda: x.square().sum(1), torch)
                print(f"[{card}] row_sq_norms C={c}: x.square().sum(1) ms={sq_ms:.6f}")
            if c == 125:
                records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                     bound_ms=b_ms, bound_by=b_by, max_abs_err=spec["err"])
    return records


def phase_slice(torch, ops, run_experiment, card: str, out_dir: Path) -> dict[str, int]:
    """Drive run_experiment on the card in the two configurations; return the
    kernels' launch counts over both."""
    configs = {
        "a_tutorial_parity": dict(
            num_clients=2, num_rounds=1, local_epochs=2, batch_size=64, learning_rate=0.1,
            train_size=16_000, proportions=[0.75, 0.25],
        ),
        "b_flagship": dict(
            num_clients=1000, num_rounds=2, local_epochs=2, batch_size=64, learning_rate=0.1,
            train_size=60_000, compute_dtype="bfloat16", client_chunk=125,
        ),
    }
    # Launches per round of each path: one reduce and one norm pass per chunk.
    expected = {
        "a_tutorial_parity": {"weighted_mean_flat": 1, "weighted_sum_into": 0, "row_sq_norms": 1},
        "b_flagship": {"weighted_mean_flat": 0, "weighted_sum_into": 16, "row_sq_norms": 16},
    }
    ops.reset_launch_counts()
    for name, cfg in configs.items():
        before = ops.launch_counts()
        t0 = time.perf_counter()
        summary = run_experiment(model="mnist_cnn", device="cuda", seed=0,
                                 out_dir=out_dir / name, **cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        grew = {k: after[k] - before[k] for k in after}
        train, ev = summary["final_train_metrics"], summary["final_eval_metrics"]
        print(f"[{card}] slice {name}: round_durations_s={summary['round_durations_s']} "
              f"wall_s={wall:.3f} train_loss={train.get('loss')} "
              f"train_accuracy={train.get('accuracy')} eval_loss={ev['loss']} "
              f"eval_accuracy={ev['accuracy']} launches={grew}")
        if summary["rounds_completed"] != cfg["num_rounds"]:
            fail(f"{name}: {summary['rounds_completed']}/{cfg['num_rounds']} rounds completed")
        values = [train["loss"], train["accuracy"], ev["loss"], ev["accuracy"],
                  *summary["round_durations_s"]]
        if not all(math.isfinite(v) for v in values):
            fail(f"{name}: non-finite metrics {values}")
        if not summary["params_device"].startswith("cuda"):
            fail(f"{name}: params ended on {summary['params_device']}, not the card")
        if grew != expected[name]:
            fail(f"{name}: kernel launches {grew}, expected {expected[name]}")
    counts = ops.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return counts


def phase_cross_check(torch, card: str) -> None:
    import dataclasses

    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.data import federate, synthetic_classification
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.trainer import TrainingConfig, draw_permutations
    from nanofed_tpu_torch.utils.trees import ravel

    model = dataclasses.replace(get_model("mnist_cnn"), dropout=())
    training = TrainingConfig(batch_size=8, local_epochs=2, learning_rate=0.1)
    host = federate(synthetic_classification(128, 10, (28, 28, 1), seed=5), 8, batch_size=8)
    params = model.init(torch.Generator().manual_seed(0))
    perms = draw_permutations(torch.Generator().manual_seed(1), 8, 2, host.y.shape[1])
    strategy = fedavg_strategy()
    step = build_round_step(model, training, strategy)
    results = {}
    for dev in ("cuda", "cpu"):
        device = torch.device(dev)
        data = ClientData(*host).to(device)
        p = {k: v.to(device) for k, v in params.items()}
        results[dev] = step(p, init_server_state(strategy, p), data, data.mask.sum(1),
                            perms.to(device))
    cuda_r, cpu_r = results["cuda"], results["cpu"]
    diff = float((ravel(cuda_r.params).cpu() - ravel(cpu_r.params)).abs().max())
    loss_diff = abs(float(cuda_r.metrics["loss"]) - float(cpu_r.metrics["loss"]))
    norm_rel = float(((cuda_r.update_sq_norms.cpu() - cpu_r.update_sq_norms).abs()
                      / cpu_r.update_sq_norms).max())
    print(f"[{card}] cross-check 8-client f32 round cuda vs cpu: max|dparams|={diff:.3e} "
          f"|dloss|={loss_diff:.3e} max rel d(update_sq_norms)={norm_rel:.3e} "
          f"(tolerance {CROSS_TOL})")
    if not (diff <= CROSS_TOL and loss_diff <= CROSS_TOL and norm_rel <= CROSS_TOL):
        fail("the round on the card disagrees with the round on the CPU")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        import nanofed_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"nanofed_tpu_torch not importable ({e}): run from the root of a checkout")
    from nanofed_tpu_torch import ops, run_experiment
    from nanofed_tpu_torch.ops import _build

    card = nvidia_smi()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s for {list(logs) or 'nothing (already built)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = phase_kernels(torch, ops, card)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "runs") as tmp:
        counts = phase_slice(torch, ops, run_experiment, card, Path(tmp))
    print(f"kernels: {json.dumps(counts)}")
    phase_cross_check(torch, card)

    if any(m == "jax" or m.startswith(("jax.", "nanofed_tpu.")) or m == "nanofed_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package was imported")
    sources = {
        "weighted_mean_flat": ("nanofed_tpu_torch/ops/csrc/reduce.cu", "nanofed_tpu/ops/reduce.py:45"),
        "weighted_sum_into": ("nanofed_tpu_torch/ops/csrc/reduce.cu", "nanofed_tpu/ops/reduce.py:45"),
        "row_sq_norms": ("nanofed_tpu_torch/ops/csrc/dp_reduce.cu", "nanofed_tpu/ops/dp_reduce.py:69"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], **records[name]}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
