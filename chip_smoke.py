#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nanofed_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one card and
exits non-zero when there is none, or when ``nanofed_tpu_torch`` is not beside it.
It imports nothing of JAX or of the JAX package ``nanofed_tpu``.

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions, and the
   kernel build (one ``nvcc`` per source in ``nanofed_tpu_torch/ops/csrc``, all
   started together) with its wall time.
2. Kernels: B1 (``weighted_mean_flat`` and ``weighted_sum_into``), B3
   (``row_sq_norms``) and B2 (``masked_weighted_mean_flat``) against their plain
   PyTorch versions on the card, on ragged shapes, weight and validity cases and
   NaN/inf rows, and at the round's shapes (C = 2 and 125 clients for B1/B3, 125 and
   1000 for B2, P = 1,199,882).  At those shapes each kernel, its plain version and
   one library call are timed with CUDA events (median of 30 runs after 5 warm-up
   runs, L2 flushed before each run), beside the least time the card could take.
3. Slice: the port's entry points on the card at full ``mnist_cnn`` width, (a) the
   2-client tutorial shape (12k + 4k samples, 2 epochs, batch 64, SGD lr 0.1, f32,
   1 round) and (b) the 1000-client flagship (60 samples each, 2 epochs, batch 64,
   bf16, ``client_chunk=125``, 2 rounds) through ``run_experiment``; then the
   guarded round at the flagship's shape: (c) validated, ``Coordinator(validation=
   ...)``, ``client_chunk=125``; (d) central DP through ``run_experiment`` (cohort
   100, ``client_chunk=25``, σ calibrated for ε=2, δ=1e-5 over 2 rounds, clip 1.0);
   (e) robust trimmed mean (k=5, cohort 100).  The kernels' launch counts are zeroed
   just before each configuration and read just after; each must equal what the
   round's code launches.
4. Cross-check: 8-client f32 rounds of the port on the card and on the CPU from the
   same weights, permutations and injected noise: the plain round with dropout off
   and on (the masks are an integer hash, the same bits on both devices), the
   validated round with one client poisoned to NaN, the materialised central-DP
   round, the trimmed-mean round and the Multi-Krum round.

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
FLAGSHIP = dict(num_clients=1000, num_rounds=2, local_epochs=2, batch_size=64,
                learning_rate=0.1, train_size=60_000, compute_dtype="bfloat16")
TRIM_K = 5  # (e): trimmed mean over the 100-client cohort


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
    """Hold B1 (both forms), B3 and B2 against their plain versions; time them at the
    round's shapes.  Returns the per-kernel record of the main path's shape (the
    125-client chunk for B1 and B3, the 1000-client validated round for B2)."""
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
    cases += check_masked_cases(torch, ops, gen)
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
        if c == 125:
            # B1's denom form (central DP's materialised reduce, Multi-Krum's mean).
            d = w.sum()
            err = check_close(torch, "weighted_mean_flat denom", ops.weighted_mean_flat(x, w, d),
                              ops.weighted_mean_flat_plain(x, w, d), **TOL)
            d_ms = median_ms(lambda: ops.weighted_mean_flat(x, w, d), torch)
            d_plain = median_ms(lambda: ops.weighted_mean_flat_plain(x, w, d), torch)
            b_ms, b_by = bound_ms(n_in + 4 + 4 * P_MNIST, 2 * c * P_MNIST)
            print(f"[{card}] weighted_mean_flat (denom form) C={c} P={P_MNIST}: "
                  f"kernel_ms={d_ms:.6f} plain_ms={d_plain:.6f} bound_ms={b_ms:.6f} ({b_by}) "
                  f"max_abs_err={err:.3e}")
    records["masked_weighted_mean_flat"] = time_masked(torch, ops, gen, card)
    return records


def poison(x) -> None:
    """NaN, +inf and -inf in three rows, as a diverged client's delta holds them."""
    c, p = x.shape
    x[0, min(3, p - 1)] = float("nan")
    x[c // 2, p // 2] = float("inf")
    x[-1, -1] = -float("inf")


def check_masked_cases(torch, ops, gen) -> int:
    """B2 against its plain version: ragged P, padded rows, NaN/inf rows, random /
    all-valid / all-invalid masks, bool and float masks, zero weights."""
    cases = 0
    for c, p in [(1, 1000), (7, 1000), (1, 1537), (7, 1537)]:
        for layout in ("contiguous", "round"):
            x = (torch.randn(c, p, device="cuda", generator=gen) if layout == "contiguous"
                 else round_layout(torch, c, p, seed=3 * c + p))
            poison(x)
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            for vcase in ("random", "random_float", "all_valid", "all_invalid", "zero_weights"):
                valid = torch.rand(c, device="cuda", generator=gen) > 0.4
                wc = w.clone()
                if vcase == "random_float":
                    valid = valid.float()
                elif vcase == "all_valid":
                    valid = torch.ones(c, dtype=torch.bool, device="cuda")
                elif vcase == "all_invalid":
                    valid = torch.zeros(c, dtype=torch.bool, device="cuda")
                elif vcase == "zero_weights":
                    valid = torch.ones(c, dtype=torch.bool, device="cuda")
                    wc[::2] = 0.0
                tag = f"masked_weighted_mean_flat c={c} p={p} {layout} {vcase}"
                got = ops.masked_weighted_mean_flat(x, wc, valid)
                check_close(torch, tag, got, ops.masked_weighted_mean_flat_plain(x, wc, valid),
                            **TOL)
                if vcase == "all_invalid" and got.abs().max() != 0:
                    fail(f"{tag}: an all-invalid cohort must give exact zeros")
                cases += 1
    return cases


def time_masked(torch, ops, gen, card: str) -> dict:
    """B2 at the validated round's shapes (C = 125 and 1000, P = 1,199,882, rows padded,
    one NaN row).  The yardstick ``coefs @ x`` on a finite x moves the same bytes but
    is not the same function (no sanitize, coefficients precomputed)."""
    record = {}
    for c in (125, 1000):
        x = round_layout(torch, c, P_MNIST, seed=c + 1)
        finite = x.clone()
        x[c // 3, :1000] = float("nan")
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        valid = torch.rand(c, device="cuda", generator=gen) > 0.05
        coefs = w * valid / (w * valid).sum()
        err = check_close(torch, f"masked_weighted_mean_flat C={c}",
                          ops.masked_weighted_mean_flat(x, w, valid),
                          ops.masked_weighted_mean_flat_plain(x, w, valid), **TOL)
        ms = median_ms(lambda: ops.masked_weighted_mean_flat(x, w, valid), torch)
        plain_ms = median_ms(lambda: ops.masked_weighted_mean_flat_plain(x, w, valid), torch)
        yard_ms = median_ms(lambda: coefs @ finite, torch)
        b_ms, b_by = bound_ms(4 * c * P_MNIST + 4 * c + c + 4 * P_MNIST, 3 * c * P_MNIST)
        print(f"[{card}] masked_weighted_mean_flat C={c} P={P_MNIST}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} yardstick_ms={yard_ms:.6f} (coefs @ x on a finite "
              f"x: the same bytes, not the same function) bound_ms={b_ms:.6f} ({b_by}) "
              f"max_abs_err={err:.3e}")
        if c == 1000:
            record = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err)
        del x, finite
        torch.cuda.empty_cache()
    return record


def run_validated(out_dir: Path) -> dict:
    """(c): the flagship through ``Coordinator(validation=ValidationConfig())`` (the
    runner takes no validation flag, in either package), built as ``run_experiment``
    builds it."""
    from nanofed_tpu_torch.data import federate, load_mnist, pack_eval
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.security import ValidationConfig
    from nanofed_tpu_torch.trainer import TrainingConfig

    cfg = FLAGSHIP
    train = load_mnist("train", None, synthetic_size=cfg["train_size"])
    test = load_mnist("test", None, synthetic_size=cfg["train_size"] // 6)
    coordinator = Coordinator(
        model=get_model("mnist_cnn"),
        train_data=federate(train, num_clients=cfg["num_clients"],
                            batch_size=cfg["batch_size"], seed=0),
        config=CoordinatorConfig(num_rounds=cfg["num_rounds"], seed=0, base_dir=out_dir),
        training=TrainingConfig(batch_size=cfg["batch_size"], local_epochs=cfg["local_epochs"],
                                learning_rate=cfg["learning_rate"],
                                compute_dtype=cfg["compute_dtype"]),
        eval_data=pack_eval(test, batch_size=256),
        client_chunk=125,
        device="cuda",
        validation=ValidationConfig(),
    )
    rounds = coordinator.run()
    completed = [r for r in rounds if r.status == RoundStatus.COMPLETED]
    return {
        "rounds_completed": len(completed),
        "final_train_metrics": completed[-1].agg_metrics if completed else {},
        "final_eval_metrics": coordinator.evaluate(),
        "round_durations_s": [r.duration_s for r in rounds],
        "params_device": str(next(iter(coordinator.params.values())).device),
        "round_metrics": [r.agg_metrics for r in rounds],
    }


def dp_config(num_clients: int, cohort: int, rounds: int):
    """Central DP as ``nanofed_tpu/cli.py`` calibrates it: the smallest σ that spends
    at most ε=2 (δ=1e-5) over the run at q = cohort / N, clip 1.0."""
    from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig
    from nanofed_tpu_torch.privacy import PrivacyConfig, noise_multiplier_for_budget

    sigma = noise_multiplier_for_budget(2.0, 1e-5, sampling_rate=cohort / num_clients,
                                        num_events=rounds)
    return sigma, PrivacyAwareAggregationConfig(privacy=PrivacyConfig(
        epsilon=2.0, delta=1e-5, max_gradient_norm=1.0, noise_multiplier=sigma))


def phase_slice(torch, ops, run_experiment, card: str, out_dir: Path) -> dict[str, int]:
    """Drive the port's entry points on the card in five configurations; return the
    kernels' launch counts over all of them."""
    from nanofed_tpu_torch.orchestration import cohort_size

    n, rounds = FLAGSHIP["num_clients"], FLAGSHIP["num_rounds"]
    cohort = cohort_size(n, 0.1)
    sigma, central_privacy = dp_config(n, cohort, rounds)
    print(f"[{card}] (d) central DP: sigma={sigma} (eps=2.0, delta=1e-5, q={cohort}/{n}, "
          f"{rounds} rounds, clip 1.0)")
    configs = {
        "a_tutorial_parity": dict(
            num_clients=2, num_rounds=1, local_epochs=2, batch_size=64, learning_rate=0.1,
            train_size=16_000, proportions=[0.75, 0.25],
        ),
        "b_flagship": dict(FLAGSHIP, client_chunk=125),
        "c_validated": None,  # Coordinator(validation=...), see run_validated
        "d_central_dp": dict(FLAGSHIP, participation=0.1, client_chunk=25,
                             central_privacy=central_privacy),
        "e_robust_trimmed_mean": dict(FLAGSHIP, participation=0.1,
                                      robust_method="trimmed_mean", robust_trim_k=TRIM_K),
    }
    # Launches per round of each path, from the round step's code: (a) one reduce and
    # one norm pass; (b) one accumulate and one norm pass per 125-client chunk (8);
    # (c) B2 once (the sanitized norms come from the validation statistics, so no B3);
    # (d) per 25-client chunk of the 100-client cohort (4), B3 for the clip norms and
    # B1's accumulate form; (e) B3 once for the update norms (the trimmed mean is a
    # sort, no kernel).  Two rounds each, except (a).
    expected = {
        "a_tutorial_parity": {"weighted_mean_flat": 1, "row_sq_norms": 1},
        "b_flagship": {"weighted_sum_into": 16, "row_sq_norms": 16},
        "c_validated": {"masked_weighted_mean_flat": 2},
        "d_central_dp": {"weighted_sum_into": 8, "row_sq_norms": 8},
        "e_robust_trimmed_mean": {"row_sq_norms": 2},
    }
    totals = dict.fromkeys(ops.launch_counts(), 0)
    for name, cfg in configs.items():
        want = {k: expected[name].get(k, 0) for k in totals}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if cfg is None:
            summary = run_validated(out_dir / name)
        else:
            summary = run_experiment(model="mnist_cnn", device="cuda", seed=0,
                                     out_dir=out_dir / name, **cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = ops.launch_counts()
        train, ev = summary["final_train_metrics"], summary["final_eval_metrics"]
        print(f"[{card}] slice {name}: round_durations_s={summary['round_durations_s']} "
              f"wall_s={wall:.3f} train_loss={train.get('loss')} "
              f"train_accuracy={train.get('accuracy')} eval_loss={ev['loss']} "
              f"eval_accuracy={ev['accuracy']} launches={grew}")
        rounds = (cfg or FLAGSHIP)["num_rounds"]
        if summary["rounds_completed"] != rounds:
            fail(f"{name}: {summary['rounds_completed']}/{rounds} rounds completed")
        values = [train["loss"], train["accuracy"], ev["loss"], ev["accuracy"],
                  *summary["round_durations_s"]]
        if not all(math.isfinite(v) for v in values):
            fail(f"{name}: non-finite metrics {values}")
        if not summary["params_device"].startswith("cuda"):
            fail(f"{name}: params ended on {summary['params_device']}, not the card")
        if grew != want:
            fail(f"{name}: kernel launches {grew}, expected {want}")
        check_guarded(name, summary, out_dir / name, card)
        totals = {k: totals[k] + grew[k] for k in totals}
    missing = [k for k, v in totals.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return totals


def check_guarded(name: str, summary: dict, out_dir: Path, card: str) -> None:
    """What each guarded configuration must report."""
    train = summary["final_train_metrics"]
    if name == "c_validated":
        for i, m in enumerate(summary["round_metrics"]):
            valid, part = m["valid_clients"], m["participating_clients"]
            print(f"[{card}] (c) round {i}: valid_clients={valid} participating_clients={part}"
                  " (ValidationConfig defaults: max_norm=10 per leaf, z-score 2.0)")
            if not (isinstance(valid, int) and part == FLAGSHIP["num_clients"]
                    and part // 2 < valid <= part):
                fail(f"{name}: {valid}/{part} valid: honest clients must mostly pass")
    elif name == "d_central_dp":
        eps = train["privacy_epsilon"]
        print(f"[{card}] (d) privacy_epsilon={eps} privacy_delta={train['privacy_delta']}")
        if not 0 < eps <= 2.0:
            fail(f"{name}: privacy_epsilon {eps} outside (0, 2]")
        for path in sorted((out_dir / "metrics").glob("*.json")):
            if "clients" in json.loads(path.read_text()):
                fail(f"{name}: per-client detail written under central DP ({path.name})")
    elif name == "e_robust_trimmed_mean":
        print(f"[{card}] (e) robust_kept_clients={train['robust_kept_clients']} "
              f"participating_clients={train['participating_clients']}")
        if train["robust_kept_clients"] != train["participating_clients"] - 2 * TRIM_K:
            fail(f"{name}: the trimmed mean must keep m - 2k ranks")


def phase_cross_check(torch, ops, card: str) -> None:
    """8-client f32 rounds on the card and on the CPU from the same inputs; each
    variant's kernel launches on the card are checked against the round's code."""
    import dataclasses

    from nanofed_tpu_torch.aggregation import (
        PrivacyAwareAggregationConfig,
        RobustAggregationConfig,
        fedavg_strategy,
    )
    from nanofed_tpu_torch.core.types import ClientData, ClientMetrics
    from nanofed_tpu_torch.data import federate, synthetic_classification
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.privacy import PrivacyConfig
    from nanofed_tpu_torch.security import ValidationConfig
    from nanofed_tpu_torch.trainer import (
        TrainingConfig,
        client_keys,
        draw_permutations,
        make_local_fit,
    )
    from nanofed_tpu_torch.utils.trees import ravel, tree_size

    with_dropout = get_model("mnist_cnn")
    model = dataclasses.replace(with_dropout, dropout=())
    training = TrainingConfig(batch_size=8, local_epochs=2, learning_rate=0.1)
    host = federate(synthetic_classification(128, 10, (28, 28, 1), seed=5), 8, batch_size=8)
    poisoned = ClientData(host.x.copy(), host.y, host.mask)
    poisoned.x[3, 0, 0, 0, 0] = 1e6  # the sentinel the NaN fit looks for
    params = model.init(torch.Generator().manual_seed(0))
    perms = draw_permutations(torch.Generator().manual_seed(1), 8, 2, host.y.shape[1])
    noise = torch.randn(tree_size(params), generator=torch.Generator().manual_seed(2))
    strategy = fedavg_strategy()

    def nan_fit(gp, data, perms, keys=None, lr_scale=1.0):
        """Client 3 diverges: NaN params and metrics (through ``local_fit=``)."""
        res = make_local_fit(model, training)(gp, data, perms, keys, lr_scale)
        bad = data.x[:, 0, 0, 0, 0] > 1e5
        nan = lambda t: torch.where(bad.view(-1, *[1] * (t.ndim - 1)), torch.nan, t)  # noqa: E731
        return res._replace(params={k: nan(v) for k, v in res.params.items()},
                            metrics=ClientMetrics(*(nan(m) for m in res.metrics)))

    dp = PrivacyAwareAggregationConfig(privacy=PrivacyConfig(max_gradient_norm=0.5,
                                                             noise_multiplier=0.8))
    # name: (build_round_step kwargs, data, model, launches on the card)
    variants = {
        "plain, dropout off": ({}, host, model,
                               {"weighted_mean_flat": 1, "row_sq_norms": 1}),
        "plain, dropout on": ({}, host, with_dropout,
                              {"weighted_mean_flat": 1, "row_sq_norms": 1}),
        "validated, client 3 NaN": (
            dict(local_fit=nan_fit,
                 validation=ValidationConfig(max_norm=100.0, min_clients_for_stats=100)),
            poisoned, model, {"masked_weighted_mean_flat": 1}),
        "central DP, materialised": (dict(central_privacy=dp), host, model,
                                     {"weighted_mean_flat": 1, "row_sq_norms": 1}),
        "trimmed mean, k=1": (dict(robust=RobustAggregationConfig(trim_k=1)), host, model,
                              {"row_sq_norms": 1}),
        # B1 with denom twice: the selected clients' deltas, then the round's
        # loss/accuracy scalars through the same estimator (round_step.py:452-457).
        "Multi-Krum, f=1": (dict(robust=RobustAggregationConfig(trim_k=1, method="multi_krum")),
                            host, model, {"weighted_mean_flat": 2, "row_sq_norms": 1}),
    }
    for name, (kwargs, host_data, mdl, launches) in variants.items():
        step = build_round_step(mdl, training, strategy, **kwargs)
        results = {}
        for dev in ("cuda", "cpu"):
            device = torch.device(dev)
            data = ClientData(*host_data).to(device)
            p = {k: v.to(device) for k, v in params.items()}
            ops.reset_launch_counts()
            results[dev] = step(p, init_server_state(strategy, p), data, data.mask.sum(1),
                                perms.to(device), client_keys(7, 8, device), noise.to(device))
            if dev == "cuda":
                torch.cuda.synchronize()
                grew = ops.launch_counts()
                want = {k: launches.get(k, 0) for k in grew}
                if grew != want:
                    fail(f"cross-check {name}: launches {grew}, expected {want}")
        cuda_r, cpu_r = results["cuda"], results["cpu"]
        gp = ravel(cuda_r.params).cpu()
        diff = float((gp - ravel(cpu_r.params)).abs().max())
        loss_diff = abs(float(cuda_r.metrics["loss"]) - float(cpu_r.metrics["loss"]))
        norm_rel = float(((cuda_r.update_sq_norms.cpu() - cpu_r.update_sq_norms).abs()
                          / cpu_r.update_sq_norms.clamp(min=1e-6)).max())
        extra = ""
        if "valid_clients" in cuda_r.metrics:
            valid = (int(cuda_r.metrics["valid_clients"]), int(cpu_r.metrics["valid_clients"]))
            extra = f" valid_clients={valid}"
            if valid != (7, 7):
                fail(f"cross-check {name}: valid_clients {valid}, expected 7 on both")
        print(f"[{card}] cross-check {name}, 8-client f32 round cuda vs cpu: "
              f"max|dparams|={diff:.3e} |dloss|={loss_diff:.3e} max rel "
              f"d(update_sq_norms)={norm_rel:.3e}{extra} (tolerance {CROSS_TOL})")
        if not torch.isfinite(gp).all():
            fail(f"cross-check {name}: non-finite params on the card")
        if not (diff <= CROSS_TOL and loss_diff <= CROSS_TOL and norm_rel <= CROSS_TOL):
            fail(f"cross-check {name}: the round on the card disagrees with the CPU")


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
    phase_cross_check(torch, ops, card)

    if any(m == "jax" or m.startswith(("jax.", "nanofed_tpu.")) or m == "nanofed_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package was imported")
    sources = {
        "weighted_mean_flat": ("nanofed_tpu_torch/ops/csrc/reduce.cu", "nanofed_tpu/ops/reduce.py:45"),
        "weighted_sum_into": ("nanofed_tpu_torch/ops/csrc/reduce.cu", "nanofed_tpu/ops/reduce.py:45"),
        "row_sq_norms": ("nanofed_tpu_torch/ops/csrc/dp_reduce.cu", "nanofed_tpu/ops/dp_reduce.py:69"),
        "masked_weighted_mean_flat": ("nanofed_tpu_torch/ops/csrc/reduce.cu",
                                      "nanofed_tpu/ops/reduce.py:103"),
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
