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
   NaN/inf rows; B1/B2 also on the edges of their launch plan (C = 1 to 7, around
   the ring's 3 and 6 stages, 40 and 1000; P = 1, 2, 3, around each largest grid of
   minimum slabs and 1,199,882; every load width and a data pointer one float off), two
   launches of each form giving the same bits, and timed with their launch plan at
   every C the main path launches them with (C = 2, 8, 25, 100, 125, 250 and 1000 for
   B1, 64, 125 and 1000 for B2, P = 1,199,882); B3 at C = 2, 25, 100 and 125; B5
   (``quantize_u32``), B6 (``dequantize_u32``) and B7 (``add_mask``) bit for bit on
   ragged sizes, unaligned starts, ties, saturation and both signs; B7 with k seeds a
   launch (k = 1, 2, 7, 8, 14, 65 and 999, mixed signs, a seed at +1 and -1 in one
   launch) against the plain composition, and its stream against numpy's Philox at
   P = 1,199,882 with one seed and eight; B5 and B6 also on the edges of their launch
   plan (n = 1-5, around the largest grid of minimum slabs at 132 SMs and the card's
   own count, around a slab boundary, slabs of one, two and three rounds of the
   threads' registers; starts 0-3; ``frac_bits`` 8 and 16; through the wrappers and
   into guarded outputs) and twice for the same bits, then the floor of a
   1.2M-word pass (an empty launch, a same-bytes copy, B1 at C = 2 and 125, each after
   the write flush, a read flush and none) and B5/B6 timed with their plan, cold
   and warm; B7's key loop counted by class in the SASS
   (``cuobjdump -sass``) beside the function's own count, which gives its operations
   bound; B4
   (``dequant_accumulate_flat``) on ragged P, every int8 load width (16, 8, 4, 2 and 1
   bytes), C = 1, 9, 64 and 1000, zero weights (exactly ``base``), an explicit
   ``denom`` and the int8 extremes, then on the edges of its launch plan and twice for
   the same bits.  At those shapes each kernel, its plain version and one library
   call (for B4 the unfused yardstick ``torch.addmv(base, q.float().t(), coefs)``)
   are timed with CUDA events (median of 30 runs after 5 warm-up runs, L2 flushed
   before each run), beside the least time the card could take: B7 as a client's
   masking pass of k = 1, 7, 8, 14 and 999 seeds (its plain version up to k = 8), B4
   at C = 64 and 1000 with its launch plan.  B5, B6, B7 and B4 are also timed with the
   host's work hidden behind a device sleep (``kernel_ms``: B5's and B6's call, B7's
   pass, B4's launch alone).
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
   Then the secure federation over localhost HTTP, as
   ``examples/secure_federation/run_secure.py`` drives it but through the port's
   ``HTTPServer``, ``NetworkCoordinator`` and ``HTTPClient`` on the card: 8 clients of
   ``mnist_cnn`` at full width on the ``cuda`` mask backend (600 synthetic samples
   each, 1 epoch, batch 64, SGD lr 0.1, f32, 2 rounds), (f) the no-dropout masked
   round (``SecureAggregationConfig(min_clients=8)``) and (g) the dropout-tolerant
   round (threshold 5, ``min_clients`` 7, ``min_completion_rate`` 0.5), client_7 gone
   from round 1 on after the share exchange; then (h) the same 8 clients in the plain
   network round, which the coordinator reduces with B1 on the card.  Each round must
   complete, its aggregate must equal the plain weighted FedAvg of the clients' own
   trained params within 1e-4 (secure) or 1e-5 (plain), and the launches of B1 and
   B5/B6/B7 must equal what the code launches (one B7 per masking client a round, and
   one per dropout-tolerant recovery).
   Then (i) the autotuned run: ``Coordinator.from_autotune`` at the flagship's shape
   (1000 clients x 60 samples, 2 epochs, bf16, 2 rounds) over a pinned space
   (``client_chunk`` None, 125 or 250 x batch 32 or 64), with the ranked table and the
   aggregation-epilogue table (B4 and B2 against their unfused programs at P =
   1,199,882, C = 64); its final params must equal a hand-built coordinator with the
   winner's knobs within 1e-4; then ``run_experiment(autotune=True, retune_every=1,
   profile_programs=True)`` on 8 ``mnist_cnn`` clients of 128 samples, 3 rounds (its
   default space sweeps 3-round blocks too).  The launch counts of both runs must equal
   what the profiler's calls and the rounds launch.
   Then resumable runs: (j) at the flagship's shape through ``Coordinator`` with FedAvgM
   (a [P] momentum trace) and a cosine client schedule (``lr_min_factor=0.2``), 4
   rounds: an uninterrupted run with a ``ModelManager`` and a ``FileStateStore``, each
   round's checkpoint, versioned model and whole publish timed; the same run again
   (the card's run-to-run gap); a run whose ``start_training()`` is closed after two
   rounds, resumed by a fresh coordinator at round 2 with the uninterrupted run's
   ``lr_scale``s and its params and trace within 1e-4 and within the run-to-run gap
   plus 1e-6; ``run_fault_tolerant`` through a ``ConnectionError`` after round 1
   (history rounds 2 and 3, latest checkpoint round 3); the newest versioned model
   equal to the live params bit for bit; then the flagship through ``run_experiment(
   lr_schedule="linear", lr_min_factor=0.2)`` (2 rounds, its last ``lr_scale`` the
   schedule's).  B1's accumulate form and B3 launch 8 times a round.  (k) the plain network round of (h) resumed, its clients training with
   cuDNN's deterministic algorithms: 3 rounds uninterrupted, 2 rounds with a store
   (the run-to-run gap after 2 rounds), then a new server and coordinator for 3
   rounds that must start at round 2, publish the checkpointed params bit for bit and
   end within 1e-4 of the uninterrupted run and within the run-to-run gap plus 1e-6
   (B1 once a round).
   Then the client-training layer at the flagship's shape (1000 clients x 60 samples,
   2 epochs, batch 64, bf16): (l) DP-SGD clients, ``Coordinator(local_fit=
   make_private_local_fit(..., PrivacyConfig(noise_multiplier=1.1,
   max_gradient_norm=1.0)))`` with ``client_chunk=25``, 2 rounds (B1 accumulate and B3
   40 a round), its peak device memory and each client's ε at δ=1e-5 from
   ``record_local_fit``; on the card, one client's clipped per-example norms at most
   C(1 + 1e-5), the per-example gradients against one-example backward passes (1e-4),
   one noise draw at full width (mean within 0.01σC, std within 1%), a 100-client
   round in chunks of 25 and of 50 within 1e-5, and one 25-client DP-SGD fit timed
   against the plain fit with its device time by kernel (``torch.profiler``); (m) SCAFFOLD through
   ``run_experiment(scaffold=True, participation=0.1, client_chunk=25)``, 3 rounds (B1
   normalised, B1 accumulate and B3 once a round), then a ``Coordinator(scaffold=True)``
   whose round 1 equals the plain FedAvg round within 1e-5, whose ``c_global`` equals
   ``c + sum(dc_i) / 1000`` recomputed in float64 within 1e-6 relative after every
   round, and whose non-participants' control rows stay the same bits; then a
   100-client population for 4 rounds, twice (the run-to-run gap), and closed after 2
   rounds and resumed by a fresh coordinator from its checkpoint (params, ``c_global``
   and ``c_stack`` within 1e-4 and within the gap plus 1e-6), each checkpoint timed;
   (n) ``Trainer.fit`` with a ``MetricsLogger`` on the tutorial client (12k samples, 2
   epochs, f32) equal to ``make_local_fit`` run directly bit for bit (cuDNN's
   deterministic algorithms), then the personalized evaluator over (m)'s model on its
   1000 clients split 80/20, timed.
   Then the network mode's update pipeline over (h)'s cohort (8 ``mnist_cnn`` clients of
   600 samples, 1 epoch, f32, localhost aiohttp on the card): (o) two validated rounds,
   client_7 posting a NaN leaf and then a 1000x scaled update, both rejected as out of
   range and the aggregate the FedAvg of the other 7 within 1e-5 (B1 once a round),
   one round with the cohort z-score on (how many honest clients the float32
   leave-one-out z-score rejects, against float64), then trimmed-mean (k=1) and
   Multi-Krum (f=1) rounds with client_7 Byzantine, each within 1e-5 of its float64
   recomputation (Multi-Krum's selection mean is one B1); (p) 2 rounds of q8-delta and
   3 of topk8-delta (fraction 0.05) submissions, each aggregate the FedAvg of the
   server's reconstructions within 1e-5, the bytes on the wire per update (npz, q8,
   topk8) and the client's encode and server's decode seconds, in the run and alone;
   (q) FedBuff (``async_buffer_k=4``, ``staleness_window=4``) over the 8 clients,
   client c sleeping 0.15c s before each round's training, 4 aggregations with the
   list buffer and with ``IngestConfig()`` (256 rows, 1.23 GB on the card), each
   aggregation within 1e-5 of its float64 recomputation from the drained updates, the
   list run's drains replayed through an ingest buffer (within 1e-6 of
   ``fedbuff_combine``, the copy and the drain timed), then 2 sync rounds on the
   ingest buffer (no kernel); (r) signed rounds, every client with a
   ``SecurityManager`` and the server with ``require_signatures=True``: an npz and a
   q8 round, an unregistered client answered 403 and absent from the aggregate,
   signing and verifying timed, then a signed masked round on the ``cuda`` backend
   (B5 8, B7 8, B6 1).
   Then fused multi-round blocks (``CoordinatorConfig.rounds_per_block``): (s1) the
   flagship (``client_chunk=125``), 8 rounds at ``rounds_per_block=4`` (two blocks) and
   at 1, and the fused run again for the run-to-run gap: params within 1e-4 and the gap
   plus 1e-6, every round's metrics within 1e-4 (counts equal), B1 accumulate and B3 64
   each a run, per-round wall time and peak device memory above each run's start
   (within 1%); (s2) a validated 10% cohort with dropout 0.1 as one 4-round block
   against single rounds (B2 once a round), and a 4-round block that resamples its
   cohorts on the card through ``build_round_block`` (distinct ids, plausible
   survivors; B1 normalised and B3 once a round); (s3) in the second fused run, the synchronizing operations inside
   its first block's dispatch under ``torch.cuda.set_sync_debug_mode("warn")`` (must be
   0) and its second block under ``torch.profiler``: the device's busy share of the
   block's wall time and its top four kernels by device time.
   Then the CIFAR ResNets through the package's entry points (phase (t)), on synthetic
   CIFAR-shaped data (no CIFAR files in the repository): (t1) ``cli.main(["bench",
   "fedprox_cifar10"])``, ResNet-8 (P = 77,850), 100 clients, Dirichlet 0.5, cohorts of
   10, FedProx mu 0.01, 3 rounds over 50,000 + 10,000 images (B1 normalised and B3 once
   a round); (t2) ``run_benchmark("cross_silo")``, ResNet-18 at full width (P =
   11,218,340), 8 clients of 6,250 images, 2 rounds in f32 (TF32 off): round times,
   peak device memory above the phase's start, one round step of one batch a client
   profiled (``observability.profile_program``: counted FLOPs, so the round's FLOPs
   and achieved rate) and traced (``torch.profiler``: device busy time and the top
   kernels); (t3) the same configuration in bf16 through ``cli.main``, 1 round, its
   round-0 training loss within 10% of the f32 run's; (t4) a ResNet-8 round of 8
   clients and a narrow ResNet-18's forward and gradient on the card against the CPU
   (1e-4: the stride-2 SAME convolutions and GroupNorm); (t5) B1 normalised and B3 at
   C = 10, P = 77,850 and C = 8, P = 11,218,340 in the round's layout, timed with the
   library calls ``w @ x`` and ``torch.linalg.vecdot(x, x)`` beside their bounds.
   Then observability (phase (u)): (u1) the flagship (``client_chunk=125``) with
   ``telemetry_dir``, 4 single rounds and 8 rounds at ``rounds_per_block=4``: the spans
   of ``telemetry.jsonl`` with the JAX names and nesting, every ``round`` record,
   ``summarize_telemetry`` over the file, the span-derived occupancy on both bases, the
   first block's whole ``dispatch`` span under the sync check (0 synchronizing
   operations) and the second block under ``torch.profiler`` (its span occupancy at
   most the device's busy share + 0.02), then the round with telemetry off and on,
   interleaved (off, on, on, off; 3 rounds each after a warm round); (u2) one flagship
   round inside ``utils.profiling.trace``, whose Chrome trace must hold the span names
   and B1's and B3's kernels; (u3) (h)'s plain network round with the server's
   ``registry=`` and ``tracer=``, the clients' ``registry=`` and the coordinator's
   ``telemetry_dir=``: ``GET /metrics`` with the JAX families, 8 updates a round, the
   bytes received equal to the bodies the clients sent, every submit's trace id in
   exactly one ``submit-decode`` span (B1 once a round); (u4) the kernel-build manifest
   over ``nanofed_tpu_torch/_build/`` (three libraries, the toolchain matches) and a
   second load that counts three hits and no build; (u5) ``nanofed-tpu-torch run
   --telemetry-dir`` (1 round of 8 clients), then ``metrics-summary`` and ``trace`` on
   its directory, each exiting 0.
4. Cross-check: 8-client f32 rounds of the port on the card and on the CPU from the
   same weights, permutations and injected noise: the plain round with dropout off
   and on (the masks are an integer hash, the same bits on both devices), the
   validated round with one client poisoned to NaN, the materialised central-DP
   round, the trimmed-mean round, the Multi-Krum round and the DP-SGD round (its
   counter-based noise of one key within 1e-6 relative on both devices); then two
   SCAFFOLD rounds from zero controls (params within 1e-4, the controls within 1e-4
   over K * eta, the factor (x - y) / (K * eta) multiplies the params' error by).

The last lines are the whole script's wall time, the kernels' JSON record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
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
H100_SMS, H100_BOOST_HZ = 132, 1.98e9  # the clock the 67 TFLOP/s figure assumes
# The compute capability 9.0 throughput table (CUDA C++ Programming Guide, "Arithmetic
# Instructions"), results a clock an SM: 32-bit integer add and subtract, bitwise
# logic, shifts and multiply(-add) 64 each.  IMAD runs on the FMA pipe, beside the
# integer ALU that runs IADD3, LOP3, SHF and the like, and a 32x32->64 IMAD.WIDE gives
# two 32-bit results.  An SM issues at most 4 warp instructions a clock, 128 thread
# instructions.
CC90_INT_RESULTS_PER_CLOCK = 64
CC90_ISSUE_PER_CLOCK = 128
P_MNIST = 1_199_882
# Kernel B7's work, the function's own (not a compile's): a Philox4x64-10 block (8
# output words) is 10 rounds of a 64x64->128 product and XORs.  Round 0's product (of
# the counter) is the same for every key, so a block of k keys needs 18k + 1 products,
# each four 32x32->64 multiplies (IMAD.WIDE.U32: 8 FMA-pipe results).  The integer ALU
# takes a product's 3 carry adds (IADD3 with two carries), a key's 38 XORs (4 three-input
# LOP3 a round after round 0's 2) and 4 to complement a subtracted mask's words, and 4
# three-input adds into the 8-word sum; a block's 8 adds into q come once.
B7_FMA_PER_PRODUCT = 8
B7_ALU_PER_KEY = 18 * 3 + 38 + 4 + 4
B7_CHAINS = 3  # keys a key-loop iteration (csrc/quantize.cu kMaskChains)
# The classes of sass_key_loop's count of the compiled key loop, and the instructions of
# the integer ALU pipe beside IADD3 and LOP3 (the rest, loads, stores, branches and
# uniform-datapath instructions, take only issue slots).
SASS_CLASSES = ("IMAD.WIDE", "IMAD.HI", "IMAD", "LOP3", "IADD3", "other_alu", "other")
SASS_ALU_OPS = ("SHF", "LEA", "ISETP", "SEL", "PRMT", "MOV", "IADD", "IABS", "IMNMX",
                "VIADD", "BMSK", "SGXT", "PLOP3", "FLO", "POPC", "BREV", "P2R", "R2P")
MASK_KS = (1, 2, 7, 8, 14, 65, 999)  # B7's multi-key cases: 65 passes one key tile
TIMED_MASK_KS = (1, 7, 8, 14, 999)  # (f)'s pass, (g)'s pass, (g)'s recovery, 1000 clients
MASK_RECORD_K = 8  # the JSON record: (g)'s client pass, 7 peers and the self mask
SECURE_CLIENTS = 8  # (f) and (g): the cohort of examples/secure_federation, 8 clients
SECURE_SAMPLES = 600  # per client
SECURE_TOL = 1e-4  # 8 quantizations at 2^-17 each, plus float32 sums in another order
PLAIN_NETWORK_TOL = 1e-5  # (h): B1's float32 mean of 8 params against a float64 one
# f32 sums taken in another order than the plain version's: up to 125 products of
# magnitude ~1 (B1's accumulate form keeps the un-normalised sum, whose rounding error
# reaches ~1e-5) or 1.2M squares (B3, held by rtol).
TOL = dict(rtol=1e-5, atol=1e-4)
CROSS_TOL = 1e-4  # cuDNN vs CPU convolutions summed in another order, 4 SGD steps, TF32 off
EPILOGUE_CLIENTS = 64  # the epilogue table's C (tuning.epilogues.DEFAULT_EPILOGUE_CLIENTS)
TUNED_CHUNKS = (None, 125, 250)  # (i): the flagship sweep's pinned client_chunk axis
TUNED_BATCHES = (32, 64)  # (i): and its batch-size axis
# (i): the autotuned runner's samples a client.  Its default space sweeps 3-round blocks
# beside single rounds, and the profiler runs every candidate 5 times.
RUNNER_SAMPLES = 128
FLAGSHIP = dict(num_clients=1000, num_rounds=2, local_epochs=2, batch_size=64,
                learning_rate=0.1, train_size=60_000, compute_dtype="bfloat16")
TRIM_K = 5  # (e): trimmed mean over the 100-client cohort
RESUME_ROUNDS = 4  # (j): the flagship run resumed after 2 of its 4 rounds
RESUME_TOL = 1e-4  # (j), (k): a resumed run against the uninterrupted one on the card


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, torch, reps: int = 30, warmup: int = 5, hide_host_ms: float = 0.0,
              flush: str = "write", prep=None) -> float:
    """Median time of ``fn`` on the card, each run timed alone with CUDA events.  Before
    each run ``flush`` empties the 50 MB L2 of the inputs: ``"write"`` overwrites a
    256 MB buffer (the table's timing since the first slice; it leaves L2 full of dirty
    lines, whose write-backs may fall in the timed window), ``"read"`` sums it (clean
    lines), ``"none"`` leaves L2 as the last run left it.  Then ``prep`` runs, untimed
    (a copy that writes the inputs, as a caller leaves them warm).  With
    ``hide_host_ms``, a device sleep of about that long precedes each run, so the host
    has enqueued ``fn``'s launches before the card reaches them: the time is then the
    card's alone, whatever the host spends per call."""
    if flush not in ("write", "read", "none"):
        raise ValueError(f"median_ms: flush must be write, read or none, got {flush!r}")
    buf = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    total = torch.zeros((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        if prep:
            prep()
        fn()
    events = []
    for _ in range(reps):
        if flush == "write":
            buf.zero_()
        elif flush == "read":
            torch.sum(buf, dim=0, out=total)
        if prep:
            prep()
        if hide_host_ms:
            torch.cuda._sleep(int(hide_host_ms * 1e-3 * H100_BOOST_HZ))
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
    """Hold B1 (all forms), B3 and B2 against their plain versions, on ragged shapes
    and on the edges of B1/B2's launch plan; check that B1/B2 give the same bits
    twice; time them at every C the main path launches them with.  Returns the
    per-kernel record of the main path's shape (the 125-client chunk for B1 and B3,
    the 1000-client validated round for B2)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    cases = 0
    for c, p in [(1, 1000), (7, 1000), (1, 1537), (7, 1537), (2, P_MNIST)]:
        for layout in ("contiguous", "round"):
            x = rand(c, p) if layout == "contiguous" else round_layout(torch, c, p, seed=c + p)
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            cases += check_weight_cases(torch, ops, x, w, gen, f"c={c} p={p} {layout}")
            check_close(torch, f"row_sq_norms c={c} p={p} {layout}", ops.row_sq_norms(x),
                        ops.row_sq_norms_plain(x), **TOL)
            cases += 1
    cases += check_masked_cases(torch, ops, gen)
    print(f"kernels: {cases} cases agree with the plain versions (rtol {TOL['rtol']}, "
          f"atol {TOL['atol']})")
    check_reduce_edges(torch, ops, gen)
    check_reduce_determinism(torch, ops, gen)

    records = time_reduce(torch, ops, card, gen)
    for c in (2, 25, 100, 125):  # tutorial, (d)/(l) chunks, (m) cohort, flagship chunk
        x = round_layout(torch, c, P_MNIST, seed=c)
        err = check_close(torch, "row_sq_norms", ops.row_sq_norms(x), ops.row_sq_norms_plain(x),
                          **TOL)
        ms = median_ms(lambda: ops.row_sq_norms(x), torch)
        plain_ms = median_ms(lambda: ops.row_sq_norms_plain(x), torch)
        library_ms = median_ms(lambda: torch.linalg.vecdot(x, x), torch)
        sq_ms = median_ms(lambda: x.square().sum(1), torch)
        b_ms, b_by = bound_ms(4 * c * P_MNIST + 4 * c, 2 * c * P_MNIST)
        print(f"[{card}] row_sq_norms C={c} P={P_MNIST}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"(torch.linalg.vecdot(x, x)) bound_ms={b_ms:.6f} ({b_by}) "
              f"max_abs_err={err:.3e}; x.square().sum(1) ms={sq_ms:.6f}")
        if c == 125:
            records["row_sq_norms"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                           bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    return records


def check_weight_cases(torch, ops, x, w, gen, tag: str) -> int:
    """B1's normalised and accumulate forms on ``x`` under every weight case (random,
    some zero, all zero, ``denom`` as a float and as a tensor)."""
    p = x.shape[1]
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
        got = ops.weighted_mean_flat(x, wc, denom)
        check_close(torch, f"weighted_mean_flat {tag} {wcase}", got,
                    ops.weighted_mean_flat_plain(x, wc, denom), **TOL)
        if wcase == "all_zero" and got.abs().max() != 0:
            fail(f"weighted_mean_flat {tag}: all-zero weights must give zeros")
        acc = torch.randn(p, device="cuda", generator=gen)
        want = ops.weighted_sum_into_plain(acc.clone(), x, wc)
        got = ops.weighted_sum_into(acc, x, wc)
        if got.data_ptr() != acc.data_ptr():
            fail("weighted_sum_into must update acc in place")
        check_close(torch, f"weighted_sum_into {tag} {wcase}", got, want, **TOL)
    return 10


def reduce_layout(torch, c: int, p: int, layout: str, gen):
    """A [c, p] float32 view in one of the layouts B1/B2 take: ``contiguous`` (row
    stride P), ``vec4`` (stride a multiple of 4 floats: the bulk-copy ring), ``vec2``
    (stride 2 mod 4) or ``vec1`` (stride a multiple of 4, data pointer one float past
    a 16-byte boundary)."""
    stride, offset = {"contiguous": (p, 0), "vec4": (-(-p // 4) * 4, 0),
                      "vec2": (-(-p // 2) * 2, 0), "vec1": (-(-p // 4) * 4, 1)}[layout]
    if layout == "vec2" and stride % 4 == 0:
        stride += 2
    buf = torch.randn(c * stride + offset, device="cuda", generator=gen)
    return buf[offset:offset + c * stride].view(c, stride)[:, :p]


def check_reduce_edges(torch, ops, gen) -> None:
    """B1 (every weight and ``denom`` case) and B2 (NaN/inf rows, every validity case)
    on the edges of the launch plan: C = 1 to 7 (around the ring's 3 and 6 stages),
    40 and 1000; P = 1, 2, 3, around each largest grid of minimum slabs (the ring's
    at one and two blocks an SM, the 2-float register path's: -4, -1, 0, +1, +4) and
    1,199,882; every layout."""
    from nanofed_tpu_torch.ops._common import vector_width
    from nanofed_tpu_torch.ops.reduce import (
        MIN_SLAB_UNITS,
        REGISTER_BLOCKS_PER_SM,
        RING_BLOCKS_PER_SM,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = [sms * MIN_SLAB_UNITS * 4 * k for k in (1, RING_BLOCKS_PER_SM)]
    edges.append(sms * REGISTER_BLOCKS_PER_SM * MIN_SLAB_UNITS * 2)
    near = lambda e: [e + d for d in (-4, -1, 0, 1, 4)]  # noqa: E731
    ps = [1, 2, 3, *(q for e in edges for q in near(e)), P_MNIST]
    shapes = [(c, p) for c in (1, 2, 3, 4, 5, 6, 7, 40) for p in ps]
    shapes += [(1000, p) for p in (1, 2, 3, *near(edges[1]))]
    cases, widths = 0, set()
    for c, p in shapes:
        for layout in ("contiguous", "vec4", "vec2", "vec1"):
            x = reduce_layout(torch, c, p, layout, gen)
            widths.add(vector_width(x, x.stride(0) if c > 1 else p))
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            tag = f"c={c} p={p} {layout}"
            cases += check_weight_cases(torch, ops, x, w, gen, tag)
            poison(x)
            cases += check_validity_cases(torch, ops, x, w, gen, tag)
            del x
    torch.cuda.empty_cache()
    if widths != {4, 2, 1}:
        fail(f"reduce edges: load widths exercised {sorted(widths)}, expected 4, 2 and 1")
    print(f"kernels: {cases} B1/B2 cases on the launch plan's edges agree with the plain "
          f"versions (rtol {TOL['rtol']}, atol {TOL['atol']}; C 1-7, 40 and 1000; P {ps}; "
          f"load widths {sorted(widths)})")


def check_reduce_determinism(torch, ops, gen) -> None:
    """Two launches of each B1/B2 form at C = 125 and 1000 (the round's layout, P =
    1,199,882) must give the same bits."""
    for c in (125, 1000):
        x = round_layout(torch, c, P_MNIST, seed=7 * c)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        valid = torch.rand(c, device="cuda", generator=gen) > 0.05
        d = w.sum()
        start = torch.randn(P_MNIST, device="cuda", generator=gen)
        forms = {
            "weighted_mean_flat": lambda: ops.weighted_mean_flat(x, w),
            "weighted_mean_flat denom": lambda: ops.weighted_mean_flat(x, w, d),
            "weighted_sum_into": lambda: ops.weighted_sum_into(start.clone(), x, w),
            "masked_weighted_mean_flat": lambda: ops.masked_weighted_mean_flat(x, w, valid),
        }
        for name, fn in forms.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                fail(f"{name} C={c}: two launches gave different bits "
                     f"({int((a != b).sum())} words differ)")
        del x
        torch.cuda.empty_cache()
    print(f"kernels: B1 (normalised, denom, accumulate) and B2 give the same bits twice "
          f"at C = 125 and 1000, P = {P_MNIST}")


# B1/B2 at every C at which the main path launches them: (form, C, layout).
TIMED_REDUCES = (
    ("weighted_mean_flat", 2, "round"),  # (a) the tutorial round
    ("weighted_mean_flat", 8, "contiguous"),  # (h) the plain network round: VEC 2
    ("weighted_sum_into", 25, "round"),  # (d) the central-DP chunk, (l) the DP-SGD chunk
    ("weighted_mean_flat", 100, "round"),  # (m) SCAFFOLD's uniform participant mean
    ("weighted_sum_into", 100, "round"),  # (m) SCAFFOLD's control-delta sum
    ("weighted_mean_flat", 125, "round"),
    ("weighted_mean_flat_denom", 125, "round"),  # central DP materialised, Multi-Krum
    ("weighted_sum_into", 125, "round"),  # (b) the flagship chunk
    ("weighted_sum_into", 250, "round"),  # (i) the autotuner's chunk
    ("weighted_mean_flat", 1000, "round"),  # (i) client_chunk=None
    ("masked_weighted_mean_flat", 64, "round"),  # (i) the epilogue table
    ("masked_weighted_mean_flat", 125, "round"),
    ("masked_weighted_mean_flat", 1000, "round"),  # (c) the validated round
)


def time_reduce(torch, ops, card: str, gen, show_plan: bool = True) -> dict[str, dict]:
    """Time B1/B2 at each of ``TIMED_REDUCES`` (P = 1,199,882): the kernel, its plain
    version, one library call computing the same function where there is one, and the
    bound; with ``show_plan`` also the launch plan, ``ptxas``'s registers and the
    blocks an SM holds.  Returns the JSON records (B1 at C=125, B2 at C=1000).  B2's
    yardstick ``coefs @ x`` on a finite x moves the same bytes but is not the same
    function (no sanitize, coefficients precomputed)."""
    records = {}
    p = P_MNIST
    for form, c, layout in TIMED_REDUCES:
        if layout == "round":
            x = round_layout(torch, c, p, seed=c + 1)
        else:
            x = torch.randn(c, p, device="cuda", generator=gen)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        acc = torch.zeros(p, device="cuda")
        n_in = 4 * c * p + 4 * c
        lib_name, library, sanitized, accumulate = None, None, False, False
        if form == "weighted_mean_flat":
            kernel = lambda: ops.weighted_mean_flat(x, w)  # noqa: E731
            plain = lambda: ops.weighted_mean_flat_plain(x, w)  # noqa: E731
            lib_name, library = "w @ x", lambda: w @ x
            bound = bound_ms(n_in + 4 * p, 2 * c * p)
        elif form == "weighted_mean_flat_denom":
            d = w.sum()
            kernel = lambda: ops.weighted_mean_flat(x, w, d)  # noqa: E731
            plain = lambda: ops.weighted_mean_flat_plain(x, w, d)  # noqa: E731
            lib_name, library = "(w / denom) @ x", lambda: (w / d) @ x
            bound = bound_ms(n_in + 4 + 4 * p, 2 * c * p)
        elif form == "weighted_sum_into":
            accumulate = True
            kernel = lambda: ops.weighted_sum_into(acc, x, w)  # noqa: E731
            plain = lambda: ops.weighted_sum_into_plain(acc, x, w)  # noqa: E731
            lib_name, library = "acc.addmv_(x.t(), w)", lambda: acc.addmv_(x.t(), w)
            bound = bound_ms(n_in + 8 * p, 2 * c * p)
        else:
            sanitized = True
            finite = x.clone()
            x[c // 3, :1000] = float("nan")
            valid = torch.rand(c, device="cuda", generator=gen) > 0.05
            coefs = w * valid / (w * valid).sum()
            kernel = lambda: ops.masked_weighted_mean_flat(x, w, valid)  # noqa: E731
            plain = lambda: ops.masked_weighted_mean_flat_plain(x, w, valid)  # noqa: E731
            bound = bound_ms(n_in + c + 4 * p, 3 * c * p)
        if accumulate:
            err = check_close(torch, f"{form} C={c}",
                              ops.weighted_sum_into(torch.zeros_like(acc), x, w),
                              ops.weighted_sum_into_plain(torch.zeros_like(acc), x, w), **TOL)
        else:
            err = check_close(torch, f"{form} C={c}", kernel(), plain(), **TOL)
        ms, plain_ms = median_ms(kernel, torch), median_ms(plain, torch)
        library_ms = median_ms(library, torch) if library else None
        b_ms, b_by = bound
        if sanitized:
            yard_ms = median_ms(lambda: coefs @ finite, torch)
            lib_note = (f"library_ms=None yardstick_ms={yard_ms:.6f} (coefs @ x on a finite "
                        "x: the same bytes, not the same function)")
        else:
            lib_note = f"library_ms={library_ms:.6f} ({lib_name})"
        line = (f"[{card}] {form} C={c} P={p} layout={layout}: kernel_ms={ms:.6f} "
                f"plain_ms={plain_ms:.6f} {lib_note} bound_ms={b_ms:.6f} ({b_by}) "
                f"share_of_bound={b_ms / ms:.4f} max_abs_err={err:.3e}")
        if show_plan:
            line += " " + plan_line(torch, x, accumulate, sanitized)
        print(line)
        record = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                      bound_by=b_by, max_abs_err=err)
        if (form, c) in (("weighted_mean_flat", 125), ("weighted_sum_into", 125),
                         ("masked_weighted_mean_flat", 1000)):
            records[form] = record
        del x
        torch.cuda.empty_cache()
    return records


def plan_line(torch, x, accumulate: bool, sanitized: bool) -> str:
    """The launch plan of B1/B2 over ``x`` with what the card makes of it; fails if
    the grid is more than one wave (blocks > SMs x the blocks an SM holds)."""
    from nanofed_tpu_torch.ops.reduce import kernel_occupancy, plan_for, sm_count

    ldx = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    vec, plan = plan_for(x, ldx)
    regs, per_sm = kernel_occupancy(x.device, vec, accumulate, sanitized, plan)
    sms = sm_count(x.device.index)
    if plan.blocks > sms * per_sm or per_sm < plan.per_sm:
        fail(f"reduce plan {plan}: the card holds {per_sm} blocks an SM ({sms} SMs), "
             f"so the grid is more than one wave")
    return (f"plan: vec={vec} path={'ring' if plan.stages else 'registers'} "
            f"blocks={plan.blocks} slab={plan.slab} stages={plan.stages} "
            f"shared_bytes={plan.shared_bytes} per_sm_planned={plan.per_sm} "
            f"per_sm_card={per_sm} sms={sms} registers={regs}")


def poison(x) -> None:
    """NaN, +inf and -inf in three rows, as a diverged client's delta holds them."""
    c, p = x.shape
    x[0, min(3, p - 1)] = float("nan")
    x[c // 2, p // 2] = float("inf")
    x[-1, -1] = -float("inf")


def check_validity_cases(torch, ops, x, w, gen, tag: str) -> int:
    """B2 on ``x`` under random / random-float / all-valid / all-invalid masks and zero
    weights; an all-invalid cohort must give exact zeros."""
    c = x.shape[0]
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
        name = f"masked_weighted_mean_flat {tag} {vcase}"
        got = ops.masked_weighted_mean_flat(x, wc, valid)
        check_close(torch, name, got, ops.masked_weighted_mean_flat_plain(x, wc, valid), **TOL)
        if vcase == "all_invalid" and got.abs().max() != 0:
            fail(f"{name}: an all-invalid cohort must give exact zeros")
    return 5


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
            cases += check_validity_cases(torch, ops, x, w, gen,
                                          f"c={c} p={p} {layout}")
    return cases


def same_bits(torch, name: str, got, want) -> float:
    """Fail unless ``got`` and ``want`` (uint32 or float32, same shape) hold the same
    bits; returns the max abs difference of their values (0.0)."""
    torch.cuda.synchronize()
    a, b = got.view(torch.int32), want.view(torch.int32)
    if a.shape != b.shape or not torch.equal(a, b):
        bad = int((a != b).sum()) if a.shape == b.shape else -1
        fail(f"{name}: kernel disagrees with its plain version ({bad} words differ)")
    if got.dtype == torch.float32:
        return float((got - want).abs().max()) if got.numel() else 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0


def fixed_point_inputs(torch, n: int, frac_bits: int, gen, specials: bool = True):
    """float32 values inside the contract with exact half-step ties in every other
    slot, and (``specials``) NaN, +-inf and out-of-range values at the end
    (saturation)."""
    x = (torch.rand(n, device="cuda", generator=gen) - 0.5) * 2000.0
    k = torch.randint(-(1 << 20), 1 << 20, (n,), device="cuda", generator=gen)
    ties = ((k.to(torch.float64) + 0.5) * 2.0 ** -frac_bits).to(torch.float32)
    x[::2] = ties[::2]
    if specials:
        edge = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30,
                             2.0 ** (31 - frac_bits), -(2.0 ** (31 - frac_bits))], device="cuda")
        m = min(n, edge.numel())
        x[n - m:] = edge[:m]
    return x


def phase_quantize(torch, ops, card: str) -> dict[str, dict]:
    """Hold B5, B6 and B7 bit for bit against their plain versions (ragged P, unaligned
    starts, ties, saturation, both signs), B7 also with k seeds a launch; check B7's
    stream against numpy's Philox at P = 1,199,882, one seed and eight; hold B5 and B6
    on the edges of their launch plan and twice for the same bits; time the floor of a
    1.2M-word pass, B5 and B6 at that size, and B7 there for each of
    ``TIMED_MASK_KS``."""
    import numpy as np

    from nanofed_tpu_torch.security.secure_agg import _fold_seed_words, _prg_uint32

    gen = torch.Generator(device="cuda").manual_seed(11)
    rng = np.random.default_rng(11)
    cases = 0
    for n in (1, 3, 5, 1000, 1027, P_MNIST):
        for start in (0, 1, 2, 3):
            for frac_bits in (8, 16):
                buf = fixed_point_inputs(torch, n + start, frac_bits, gen)
                x = buf[start:]
                tag = f"n={n} start={start} frac_bits={frac_bits}"
                qx = ops.quantize_u32(x, frac_bits)
                same_bits(torch, f"quantize_u32 {tag}", qx, ops.quantize_u32_plain(x, frac_bits))
                qbuf = torch.empty(n + start, dtype=torch.int32, device="cuda")
                qbuf[start:] = qx.view(torch.int32)
                qv = qbuf[start:].view(torch.uint32)  # the same bits at an unaligned start
                same_bits(torch, f"dequantize_u32 {tag}", ops.dequantize_u32(qv, frac_bits),
                          ops.dequantize_u32_plain(qv, frac_bits))
                words = _fold_seed_words(rng.bytes(32))
                for sign in (1, -1):
                    same_bits(torch, f"add_mask {tag} sign={sign}", ops.add_mask(qv, words, sign),
                              ops.add_mask_plain(qv, words, sign))
                cases += 4
    cases += check_mask_cases(torch, ops, rng, gen)
    seed = rng.bytes(32)
    zeros = torch.zeros(P_MNIST, dtype=torch.int32, device="cuda").view(torch.uint32)
    stream = ops.add_mask(zeros, _fold_seed_words(seed), 1).view(torch.int32).cpu().numpy()
    if not (stream.view(np.uint32) == _prg_uint32(seed, P_MNIST)).all():
        fail("add_mask: the kernel's stream at P=1,199,882 differs from numpy's Philox")
    seeds = [rng.bytes(32) for _ in range(MASK_RECORD_K)]
    signs = [1, -1, 1, 1, -1, -1, 1, -1][:MASK_RECORD_K]
    got = ops.add_mask(zeros, np.stack([_fold_seed_words(b) for b in seeds]), signs)
    want = np.zeros(P_MNIST, np.uint32)
    for b, sign in zip(seeds, signs):
        want = want + _prg_uint32(b, P_MNIST) if sign > 0 else want - _prg_uint32(b, P_MNIST)
    if not (got.view(torch.int32).cpu().numpy().view(np.uint32) == want).all():
        fail(f"add_mask: {MASK_RECORD_K} seeds in one launch at P=1,199,882 differ from the "
             "signed sum of numpy's Philox streams (_prg_uint32)")
    print(f"kernels: {cases} quantize/dequantize/mask cases bit-exact with the plain versions; "
          f"B7's stream at P={P_MNIST} equals numpy's Philox4x64-10 (_prg_uint32), and "
          f"{MASK_RECORD_K} seeds in one launch equal the signed sum of theirs")

    check_fixed_point_edges(torch, ops, gen)
    check_fixed_point_determinism(torch, ops, gen)
    time_floor(torch, ops, card)
    records = time_fixed_point(torch, ops, card, gen)
    records["add_mask"] = time_masks(torch, ops, card, rng)[MASK_RECORD_K]
    return records


# Units of the 16-byte path (words of the single-word path, over 4) a block covers in
# one round of its threads' registers: csrc/quantize.cu's kRegUnits x kThreads.
FIXED_POINT_ROUND_UNITS = 8 * 256


def fixed_point_edges(sms: int) -> list[int]:
    """B5/B6's plan edges for a card of ``sms`` SMs: n = 1-5; around the largest grid
    of minimum slabs (``sms x STREAM_BLOCKS_PER_SM`` blocks of ``STREAM_MIN_SLAB``
    units); around the slab boundary of P = 1,199,882's plan (its blocks x slab whole
    units); around slabs of one round of the threads' registers (one round, then two);
    P = 1,199,882; and slabs of three rounds.  Offsets -4, -1, 0, +1 and +4 words."""
    from nanofed_tpu_torch.ops import quantize

    near = lambda e: [e + d for d in (-4, -1, 0, 1, 4)]  # noqa: E731
    unit = quantize.STREAM_UNIT_WORDS
    blocks = sms * quantize.STREAM_BLOCKS_PER_SM
    plan = quantize.stream_plan(P_MNIST, sms)
    ns = [1, 2, 3, 4, 5]
    ns += near(blocks * quantize.STREAM_MIN_SLAB * unit)
    ns += near(plan.blocks * plan.slab * unit)
    ns += near(blocks * FIXED_POINT_ROUND_UNITS * unit)
    ns += [P_MNIST, blocks * (2 * FIXED_POINT_ROUND_UNITS + 1) * unit + 3]
    return sorted(set(ns))


def check_fixed_point_case(torch, ops, n: int, start: int, frac_bits: int, gen) -> int:
    """B5 on ``n`` words starting ``start`` words into a fresh buffer and B6 on their
    bits at the same start, bit for bit against the plain versions, through the
    wrappers and launched alone into a guarded output at the same start (the words
    around the ``n`` must stay untouched).  Returns the number of comparisons."""
    from nanofed_tpu_torch.ops import quantize

    x = fixed_point_inputs(torch, n + start, frac_bits, gen)[start:]
    tag = f"n={n} start={start} frac_bits={frac_bits}"
    want_q = ops.quantize_u32_plain(x, frac_bits)
    same_bits(torch, f"quantize_u32 {tag}", ops.quantize_u32(x, frac_bits), want_q)
    qbuf = torch.empty(n + start, dtype=torch.int32, device="cuda")
    qbuf[start:] = want_q.view(torch.int32)
    qv = qbuf[start:].view(torch.uint32)  # the same bits at the same start
    want_f = ops.dequantize_u32_plain(qv, frac_bits)
    same_bits(torch, f"dequantize_u32 {tag}", ops.dequantize_u32(qv, frac_bits), want_f)
    guard = 0x5A5A5A5A
    for what, src, want in (("quantize_u32", x, want_q), ("dequantize_u32", qv, want_f)):
        got = torch.full((start + n + 4,), guard, dtype=torch.int32, device="cuda")
        dst = got[start:start + n].view(want.dtype)
        quantize.fixed_point_launch(src, dst, frac_bits)
        same_bits(torch, f"{what} {tag} guarded", dst, want)
        if not (bool((got[:start] == guard).all()) and bool((got[start + n:] == guard).all())):
            fail(f"{what} {tag}: the kernel wrote outside its n words")
    return 4


def check_fixed_point_edges(torch, ops, gen) -> None:
    """B5 and B6 bit for bit on the edges of their launch plan (``fixed_point_edges``
    at 132 SMs and at the card's own count), at starts 0-3 (16-byte aligned, then the
    single-word path) and ``frac_bits`` 8 and 16."""
    from nanofed_tpu_torch.ops.reduce import sm_count

    ns = sorted(set(fixed_point_edges(132)) | set(fixed_point_edges(sm_count(0))))
    cases = 0
    for n in ns:
        for start in (0, 1, 2, 3):
            for frac_bits in (8, 16):
                cases += check_fixed_point_case(torch, ops, n, start, frac_bits, gen)
        torch.cuda.empty_cache()
    print(f"kernels: {cases} B5/B6 cases on the launch plan's edges bit-exact with the plain "
          f"versions (n {ns}; starts 0-3; frac_bits 8 and 16; wrappers and guarded outputs, "
          f"nothing written outside the n words)")


def check_fixed_point_determinism(torch, ops, gen) -> None:
    """Two calls of B5 and of B6 at P = 1,199,882 and at slabs of three register rounds
    must give the same bits."""
    from nanofed_tpu_torch.ops.reduce import sm_count

    sizes = (P_MNIST, fixed_point_edges(sm_count(0))[-1])
    for n in sizes:
        x = fixed_point_inputs(torch, n, 16, gen)
        q = ops.quantize_u32(x, 16)
        for name, run in (("quantize_u32", lambda: ops.quantize_u32(x, 16)),
                          ("dequantize_u32", lambda: ops.dequantize_u32(q, 16))):
            a, b = run(), run()
            torch.cuda.synchronize()
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                fail(f"{name} n={n}: two launches gave different bits")
        del x, q
        torch.cuda.empty_cache()
    print(f"kernels: B5 and B6 give the same bits twice at n = {sizes[0]} and {sizes[1]}")


def time_floor(torch, ops, card: str) -> dict:
    """The floor of a 1.2M-word pass under this script's timing, at P = 1,199,882: an
    empty launch (``torch.cuda._sleep(0)``) and a same-bytes copy yardstick
    (``out.copy_(x)`` of 4.8 MB of float32, the least time the card's own copy path
    takes to move B5's bytes; the port never calls it), each after the table's write
    flush, after a read flush, and warm (no flush; the copy's input written by a copy
    just before, as B5's callers leave theirs); then B1 at C = 2 and 125 after each
    flush, the diagnostic of the fixed ~12 us that B1 showed after the write flush.
    The host is hidden behind a device sleep in every timing here.  Returns the times
    by name and flush."""
    p = P_MNIST
    x0 = torch.randn(p, device="cuda")
    x, out = x0.clone(), torch.empty_like(x0)
    b_ms, _ = bound_ms(8 * p, 0)
    floor = {}
    for flush in ("write", "read", "none"):
        empty = median_ms(lambda: torch.cuda._sleep(0), torch, flush=flush, hide_host_ms=0.5)
        copy = median_ms(lambda: out.copy_(x), torch, flush=flush, hide_host_ms=0.5,
                         prep=(lambda: x.copy_(x0)) if flush == "none" else None)
        floor[flush] = dict(empty_launch_ms=empty, copy_ms=copy, floor_ms=max(empty, copy))
        print(f"[{card}] floor P={p} flush={flush}: empty_launch_ms={empty:.6f} "
              f"(torch.cuda._sleep(0)) copy_ms={copy:.6f} (out.copy_(x), {8 * p} bytes; a "
              f"yardstick the port never calls) floor_ms={max(empty, copy):.6f} "
              f"bound_ms={b_ms:.6f} share_of_bound_at_floor={b_ms / max(empty, copy):.4f}")
    for c in (2, 125):
        xs = round_layout(torch, c, p, seed=c + 1)
        w = torch.rand(c, device="cuda") + 0.5
        call = lambda: ops.weighted_mean_flat(xs, w)  # noqa: E731
        hide = 2 * host_ms(call, torch) + 0.5
        times = {flush: median_ms(call, torch, flush=flush, hide_host_ms=hide)
                 for flush in ("write", "read", "none")}
        floor[f"weighted_mean_flat C={c}"] = times
        print(f"[{card}] floor weighted_mean_flat C={c} P={p}: write_flush_ms="
              f"{times['write']:.6f} read_flush_ms={times['read']:.6f} no_flush_ms="
              f"{times['none']:.6f} (host hidden; the input is {4 * c * p} bytes)")
        del xs
        torch.cuda.empty_cache()
    return floor


def fixed_point_plan_line(torch, dequantize: bool, plan) -> str:
    """B5's (B6's with ``dequantize``) launch plan with what the card makes of it;
    fails if the grid is more than one wave."""
    from nanofed_tpu_torch.ops.quantize import STREAM_BLOCKS_PER_SM, fixed_point_occupancy
    from nanofed_tpu_torch.ops.reduce import sm_count

    regs, per_sm = fixed_point_occupancy(torch.device("cuda"), dequantize, plan.vec)
    sms = sm_count(0)
    if plan.blocks > sms * per_sm or per_sm < STREAM_BLOCKS_PER_SM:
        fail(f"fixed-point plan {plan}: the card holds {per_sm} blocks an SM ({sms} SMs), so "
             "the grid is more than one wave")
    return (f"plan: vec={plan.vec} blocks={plan.blocks} slab={plan.slab} shared_bytes=0 "
            f"per_sm_planned={STREAM_BLOCKS_PER_SM} per_sm_card={per_sm} sms={sms} "
            f"registers={regs}")


def time_fixed_point(torch, ops, card: str, gen) -> dict[str, dict]:
    """B5 and B6 at P = 1,199,882 on 16-byte-aligned vectors, as the secure round
    allocates them: the wrapper's call after the table's write flush (``ms``, as every
    kernel is timed), and with the host's work hidden behind a device sleep after the
    write flush (``kernel_ms``), after a read flush, and warm (``warm_ms``: no flush, the
    input written by a copy just before, as the callers leave it); the wrapper's host
    time, the plain version, one bit-equal library call where there is one, and the
    bound; where the package has a plan, also the plan with the kernel's registers and
    shared bytes.  Returns the records of B5 and B6."""
    from nanofed_tpu_torch.ops import quantize
    from nanofed_tpu_torch.ops.reduce import sm_count

    p = P_MNIST
    x0 = fixed_point_inputs(torch, p, 16, gen, specials=False)
    x = x0.clone()
    qx = ops.quantize_u32(x, 16)
    q0 = qx.clone()
    err = {
        "quantize_u32": same_bits(torch, "quantize_u32", qx, ops.quantize_u32_plain(x, 16)),
        "dequantize_u32": same_bits(torch, "dequantize_u32", ops.dequantize_u32(qx, 16),
                                    ops.dequantize_u32_plain(qx, 16)),
    }
    qi = qx.view(torch.int32)
    inv = 1.0 / (1 << 16)
    libraries = {
        "quantize_u32": ("torch.quantize_per_tensor(x, 2^-16, 0, torch.qint32)",
                         lambda: torch.quantize_per_tensor(x, inv, 0, torch.qint32),
                         lambda out: out.int_repr().view(torch.uint32)),
        "dequantize_u32": ("q.view(torch.int32) * 2^-16", lambda: qi * inv, lambda out: out),
    }
    wants = {"quantize_u32": qx, "dequantize_u32": ops.dequantize_u32_plain(qx, 16)}
    specs = {  # name: (input, its pristine copy, call, plain)
        "quantize_u32": (x, x0, lambda: ops.quantize_u32(x, 16),
                         lambda: ops.quantize_u32_plain(x, 16)),
        "dequantize_u32": (qx, q0, lambda: ops.dequantize_u32(qx, 16),
                           lambda: ops.dequantize_u32_plain(qx, 16)),
    }
    b_ms, b_by = bound_ms(8 * p, 2 * p)  # 4 bytes read and 4 written a word
    sms = sm_count(0)
    records = {}
    for name, (src, pristine, kernel, plain) in specs.items():
        warm = lambda src=src, pristine=pristine: src.view(torch.int32).copy_(  # noqa: E731
            pristine.view(torch.int32))
        wrapper_ms = host_ms(kernel, torch)
        hide = 2 * wrapper_ms + 0.5
        ms = median_ms(kernel, torch)
        kernel_ms = median_ms(kernel, torch, hide_host_ms=hide)
        read_ms = median_ms(kernel, torch, flush="read", hide_host_ms=hide)
        warm_ms = median_ms(kernel, torch, flush="none", prep=warm, hide_host_ms=hide)
        plain_ms = median_ms(plain, torch)
        library_ms, lib_note = None, "none computes the same function"
        lib_name, lib_fn, to_bits = libraries[name]
        try:
            agrees = torch.equal(to_bits(lib_fn()).view(torch.int32),
                                 wants[name].view(torch.int32))
        except (RuntimeError, NotImplementedError) as e:  # a yardstick torch lacks here
            agrees, lib_note = False, f"{lib_name} unavailable: {e}".splitlines()[0]
        if agrees:
            library_ms, lib_note = median_ms(lib_fn, torch), lib_name
        elif lib_note.startswith("none"):
            lib_note = f"{lib_name} is not bit-equal to the kernel, so not timed"
        line = (f"[{card}] {name} P={p}: ms={ms:.6f} (the call, write flush) kernel_ms="
                f"{kernel_ms:.6f} (write flush, host hidden; share_of_bound="
                f"{b_ms / kernel_ms:.4f}) read_flush_ms={read_ms:.6f} (host hidden) warm_ms="
                f"{warm_ms:.6f} (no flush, input just written, host hidden) host_ms="
                f"{wrapper_ms:.6f} (the wrapper's host time a call) plain_ms={plain_ms:.6f} "
                f"library_ms="
                f"{library_ms if library_ms is None else f'{library_ms:.6f}'} ({lib_note}) "
                f"bound_ms={b_ms:.6f} ({b_by}) max_abs_err={err[name]:.3e}")
        if hasattr(quantize, "stream_plan"):
            line += " " + fixed_point_plan_line(torch, name == "dequantize_u32",
                                                quantize.stream_plan(p, sms))
        print(line)
        records[name] = dict(ms=ms, kernel_ms=kernel_ms, warm_ms=warm_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err[name])
    return records


def check_mask_cases(torch, ops, rng, gen) -> int:
    """B7 with k seeds in one launch, bit for bit against the plain composition: each k
    of ``MASK_KS`` with mixed signs, on ragged n and unaligned starts (k = 999 on the
    small n only: the plain Philox is slow); and one seed at +1 and -1 in one launch,
    alone and among others, which must return q exactly."""
    import numpy as np

    from nanofed_tpu_torch.security.secure_agg import _fold_seed_words

    def words(k):
        return np.stack([_fold_seed_words(rng.bytes(32)) for _ in range(k)])

    cases = 0
    for k in MASK_KS:
        for n in ((1, 5, 1027) if k > 100 else (1, 5, 1027, 40_003)):
            for start in (0, 1, 3):
                buf = torch.randint(-(1 << 31), 1 << 31, (n + start,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                q = buf[start:].view(torch.uint32)
                seeds = words(k)
                signs = [int(v) for v in rng.choice([1, -1], k)]
                same_bits(torch, f"add_mask k={k} n={n} start={start}",
                          ops.add_mask(q, seeds, signs), ops.add_mask_plain(q, seeds, signs))
                cases += 1
    for n in (7, 1027, P_MNIST):
        q = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen, device="cuda",
                          dtype=torch.int32).view(torch.uint32)
        a, b, c = words(3)
        for seeds, signs in (([a, a], [1, -1]), ([a, b, c, b, a], [1, -1, 1, 1, -1])):
            got = ops.add_mask(q, np.stack(seeds), signs)
            want = ops.add_mask(q, c, 1) if len(seeds) > 2 else q
            same_bits(torch, f"add_mask n={n}: a seed at +1 and -1 in one launch", got, want)
            cases += 1
    print(f"kernels: B7 with k seeds a launch (k in {MASK_KS}, mixed signs, ragged and "
          "unaligned n; a seed at +1 and -1 cancels) bit-exact with the plain composition")
    return cases


def sass_class(opcode: str) -> str:
    """The class of one SASS instruction for B7's count."""
    for prefix in ("IMAD.WIDE", "IMAD.HI", "IMAD", "LOP3", "IADD3"):
        if opcode.startswith(prefix):
            return prefix
    return "other_alu" if opcode.split(".")[0] in SASS_ALU_OPS else "other"


def sass_key_loop(lib_path) -> dict | None:
    """B7's key loop in the SASS of ``add_mask_kernel<4>`` (``cuobjdump -sass`` of the
    built library): the innermost loop (a backward branch's body) with the most IMAD,
    whose body carries ``B7_CHAINS`` keys, by class and per key.  None where cuobjdump
    or the loop is not found."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    body = next((f for f in re.split(r"\n\s*Function : ", text)[1:]
                 if "add_mask_kernel" in f.split("\n", 1)[0] and "ILi4E" in f.split("\n", 1)[0]),
                None)
    if body is None:
        return None
    instrs, labels = [], {}  # (address, opcode, operands); label -> address
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = None  # the next instruction's address
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);",
                       line)
        if ins:
            addr = int(ins.group(1), 16)
            labels.update({k: addr for k, v in labels.items() if v is None})
            instrs.append((addr, ins.group(2), ins.group(3)))
    loops = []  # (first, last) instruction indices of each backward branch's body
    index = {addr: i for i, (addr, _, _) in enumerate(instrs)}
    for i, (addr, op, args) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        target = re.search(r"0x([0-9a-f]+)", args)
        dest = int(target.group(1), 16) if target else labels.get(
            next(iter(re.findall(r"\.L_x_\d+", args)), ""))
        if dest is not None and dest <= addr and dest in index:
            loops.append((index[dest], i))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return None
    first, last = max(inner, key=lambda lp: sum(op.startswith("IMAD")
                                                for _, op, _ in instrs[lp[0]:lp[1] + 1]))
    counts = dict.fromkeys(SASS_CLASSES, 0.0)
    for _, op, _ in instrs[first:last + 1]:
        counts[sass_class(op)] += 1
    return {k: v / B7_CHAINS for k, v in counts.items()}


def mask_bound_ms(n: int, k: int) -> tuple[float, str]:
    """B7's least time for k masks over n words: its bytes (q read and out written,
    8n), or its integer work, ceil(n / 8) Philox blocks of 18k + 1 products on the FMA
    pipe and ``B7_ALU_PER_KEY`` a key (plus 8 adds into q) on the integer ALU, the
    busier of the two pipes and the issue slots, at the throughput table's rates."""
    blocks = -(-n // 8)
    products = 18 * k + 1
    fma = products * B7_FMA_PER_PRODUCT
    alu = k * B7_ALU_PER_KEY + 8
    cycles = max(fma / CC90_INT_RESULTS_PER_CLOCK, alu / CC90_INT_RESULTS_PER_CLOCK,
                 (fma / 2 + alu) / CC90_ISSUE_PER_CLOCK)
    t_ops = blocks * cycles / (H100_SMS * H100_BOOST_HZ) * 1e3
    t_bytes = 8 * n / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sass_pipes(per_key: dict) -> tuple[float, float]:
    """FMA-pipe results (an IMAD.WIDE gives two) and integer-ALU instructions a key of
    a ``sass_key_loop`` count."""
    fma = 2 * per_key["IMAD.WIDE"] + per_key["IMAD.HI"] + per_key["IMAD"]
    return fma, per_key["LOP3"] + per_key["IADD3"] + per_key["other_alu"]


def mask_pass(ops, q, seeds, signs, plain: bool = False):
    """A client's masking pass over ``q`` (``plain``: through the plain version): one
    B7 launch for all of its seeds, or, with an older package whose ``add_mask`` takes
    one seed (no ``quantize.mask_keys``), one launch a seed."""
    from nanofed_tpu_torch.ops import quantize

    fn = ops.add_mask_plain if plain else ops.add_mask
    if hasattr(quantize, "mask_keys"):
        return fn(q, seeds, signs)
    for words, sign in zip(seeds, signs):
        q = fn(q, words, sign)
    return q


def host_ms(fn, torch, reps: int = 30) -> float:
    """The host's time for one call of ``fn`` (median of ``reps`` calls, each timed on
    the host clock without waiting for the card)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def time_masks(torch, ops, card: str, rng, ks=TIMED_MASK_KS) -> dict[int, dict]:
    """B7 at P = 1,199,882: a client's masking pass of k seeds for each k of ``ks``,
    timed on the card as the wrapper's call (``ms``, as every kernel is timed), again
    with the host's work hidden (``kernel_ms``, ``median_ms(hide_host_ms=...)``: a pass
    of k single-seed launches costs the host more than the card) and on the host alone,
    beside the function's bound (``mask_bound_ms``) and, up to k = 8, its plain version
    (5 runs: it is slow); checked against the host's Philox streams up to k = 14.
    Prints the compiled key loop's count (``sass_key_loop``) beside the function's, the
    kernel's registers, the blocks an SM holds and the grid.  Returns each k's record."""
    import numpy as np

    from nanofed_tpu_torch.ops import _build, quantize
    from nanofed_tpu_torch.ops.reduce import sm_count
    from nanofed_tpu_torch.security.secure_agg import _fold_seed_words, _prg_uint32

    if hasattr(quantize, "mask_keys"):  # a package with the multi-key kernel
        recount = sass_key_loop(_build.library_path("quantize"))
        if recount is None:
            print(f"[{card}] add_mask SASS key loop: not counted (no cuobjdump or no loop)")
        else:
            fma, alu = sass_pipes(recount)
            print(f"[{card}] add_mask SASS key loop per Philox block and key: "
                  f"{json.dumps(recount)}: {fma:.1f} FMA-pipe results and {alu:.1f} ALU "
                  f"instructions, against the function's {18 * B7_FMA_PER_PRODUCT} and "
                  f"{B7_ALU_PER_KEY} (the bound's)")
    if hasattr(quantize, "add_mask_occupancy"):
        sms = sm_count(0)
        regs, per_sm = quantize.add_mask_occupancy(torch.device("cuda"))
        grid = quantize.mask_grid(P_MNIST, sms)
        print(f"[{card}] add_mask plan at P={P_MNIST}: grid={grid} threads="
              f"{quantize.MASK_THREADS} per_sm_planned={quantize.MASK_BLOCKS_PER_SM} "
              f"per_sm_card={per_sm} sms={sms} registers={regs}")
        if per_sm < quantize.MASK_BLOCKS_PER_SM or grid > sms * per_sm:
            fail(f"add_mask: the card holds {per_sm} blocks an SM, so {grid} blocks are more "
                 "than one wave")
    q = torch.randint(-(1 << 31), 1 << 31, (P_MNIST,), device="cuda",
                      dtype=torch.int32).view(torch.uint32)
    records = {}
    for k in ks:
        raw = [rng.bytes(32) for _ in range(k)]
        seeds = np.stack([_fold_seed_words(b) for b in raw])
        signs = [int(v) for v in rng.choice([1, -1], k)]
        got = mask_pass(ops, q, seeds, signs)
        err = "not checked here (k = 999 is checked bit for bit at n = 1027)"
        if k <= 14:
            want = q.view(torch.int32).cpu().numpy().view(np.uint32)
            for b, sign in zip(raw, signs):
                stream = _prg_uint32(b, P_MNIST)
                want = want + stream if sign > 0 else want - stream
            if not (got.view(torch.int32).cpu().numpy().view(np.uint32) == want).all():
                fail(f"add_mask k={k} at P={P_MNIST}: differs from the host's Philox streams")
            err = 0.0
        call = lambda: mask_pass(ops, q, seeds, signs)  # noqa: E731
        wrapper_ms = host_ms(call, torch)
        ms = median_ms(call, torch)
        kernel_ms = median_ms(call, torch, hide_host_ms=2 * wrapper_ms + 0.5)
        plain_ms = (median_ms(lambda: mask_pass(ops, q, seeds, signs, plain=True), torch,
                              reps=5, warmup=1) if k <= 8 else None)
        b_ms, b_by = mask_bound_ms(P_MNIST, k)
        plain_note = f"{plain_ms:.6f}" if plain_ms is not None else "not measured (k > 8)"
        print(f"[{card}] add_mask k={k} P={P_MNIST}: ms={ms:.6f} (the call) kernel_ms="
              f"{kernel_ms:.6f} (host hidden) host_ms={wrapper_ms:.6f} (the wrapper's host "
              f"time a pass) plain_ms={plain_note} library_ms=None (torch's Philox is another "
              f"stream) bound_ms={b_ms:.6f} ({b_by}) share_of_bound={b_ms / kernel_ms:.4f} "
              f"(host hidden) max_abs_err={err}")
        records[k] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err if isinstance(err, float) else None)
    return records


def int8_rows(torch, c: int, p: int, stride: int, offset: int, gen):
    """A [c, p] int8 view with row stride ``stride`` starting ``offset`` bytes into a
    fresh buffer, filled with random values over the whole int8 range."""
    buf = torch.randint(-128, 128, (c * stride + offset,), generator=gen, device="cuda",
                        dtype=torch.int8)
    return buf[offset:offset + c * stride].view(c, stride)[:, :p]


# (row stride rule, start offset) -> the int8 load width it allows.
INT8_LAYOUTS = {16: (16, 0), 8: (8, 8), 4: (4, 4), 2: (2, 2), 1: (1, 1)}


def int8_layout(torch, c: int, p: int, want_vec: int, gen):
    """A [c, p] int8 view whose row stride and start allow exactly ``want_vec``-byte
    loads (16: the bulk-copy ring)."""
    multiple, offset = INT8_LAYOUTS[want_vec]
    stride = -(-p // multiple) * multiple
    if want_vec < 16 and stride % (2 * multiple) == 0:
        stride += multiple  # exactly this width, not a wider one
    return int8_rows(torch, c, p, stride, offset, gen), stride


def check_dequant_case(torch, ops, q, gen, tag: str, extremes: bool = False) -> int:
    """B4 on ``q`` against its plain version, with ``base`` 16-byte aligned and not;
    zero weights must return ``base`` exactly."""
    c, p = q.shape
    if extremes:  # the int8 extremes in every row of the cohort's first rows
        q[0] = 127
        q[1] = -127
        q[2] = -128
        q[3, ::2] = -128
        q[3, 1::2] = 127
    s = torch.rand(c, generator=gen, device="cuda") * 1e-2 + 1e-4
    w = torch.rand(c, generator=gen, device="cuda") + 0.5
    base = torch.randn(p + 1, generator=gen, device="cuda")
    for b in (base[:p], base[1:]):  # 16-byte aligned, then not
        check_close(torch, tag, ops.dequant_accumulate_flat(q, s, w, b),
                    ops.dequant_accumulate_flat_plain(q, s, w, b), **TOL)
        zero = ops.dequant_accumulate_flat(q, s, torch.zeros_like(w), b)
        torch.cuda.synchronize()
        if not torch.equal(zero, b):
            fail(f"{tag}: zero weights must return base exactly")
    return 2


def phase_dequant(torch, ops, card: str) -> dict:
    """Hold B4 against its plain version: ragged P, every int8 load width (a row
    stride and start that allow 16, 8, 4, 2 or 1 bytes), C = 1, 9, 64 and 1000, zero
    weights (exactly ``base``), explicit ``denom`` (float and tensor), the int8
    extremes, an unaligned ``base``; then on the edges of its launch plan, two launches
    giving the same bits, and timed with its plan at the epilogue's shapes (C = 64 and
    1000, P = 1,199,882).  Returns the record at C = 64, the epilogue table's C."""
    from nanofed_tpu_torch.ops._common import int8_vector_width

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, widths = 0, set()
    for c in (1, 9, 64, 1000):
        for p in (1, 2, 3, 15, 16, 17, 31, 1000, 1333, 4097):
            for want_vec in INT8_LAYOUTS:
                q, stride = int8_layout(torch, c, p, want_vec, gen)
                widths.add(int8_vector_width(q, stride if c > 1 else p))
                tag = f"dequant_accumulate_flat c={c} p={p} vec={want_vec}"
                cases += check_dequant_case(torch, ops, q, gen, tag, extremes=c == 9)
                s = torch.rand(c, generator=gen, device="cuda") * 1e-2 + 1e-4
                w = torch.rand(c, generator=gen, device="cuda") + 0.5
                base = torch.randn(p, generator=gen, device="cuda")
                for denom in (float(c) * 1.5, torch.tensor(2.5, device="cuda")):
                    check_close(torch, f"{tag} denom",
                                ops.dequant_accumulate_flat(q, s, w, base, denom),
                                ops.dequant_accumulate_flat_plain(q, s, w, base, denom),
                                **TOL)
                    cases += 1
    if widths != {16, 8, 4, 2, 1}:
        fail(f"dequant_accumulate_flat: load widths exercised {sorted(widths)}, "
             "expected all of 16, 8, 4, 2, 1")
    print(f"kernels: {cases} dequant_accumulate_flat cases agree with the plain version "
          f"(rtol {TOL['rtol']}, atol {TOL['atol']}; load widths {sorted(widths)}; zero "
          f"weights return base exactly)")
    check_dequant_edges(torch, ops, gen)
    check_dequant_determinism(torch, ops, gen)
    return time_dequant(torch, ops, card, gen)


def check_dequant_edges(torch, ops, gen) -> None:
    """B4 on the edges of its launch plan: P below one 16-byte unit, one unit and a
    few, around each largest grid of minimum slabs (the ring's at one and two blocks an
    SM, the 8-byte register path's: -16, -1, 0, +1, +16 columns) and 1,199,882; C = 1,
    3 and 40; load widths 16, 8, 2 and 1."""
    from nanofed_tpu_torch.ops.reduce import (
        MIN_SLAB_UNITS,
        REGISTER_BLOCKS_PER_SM,
        RING_BLOCKS_PER_SM,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = [sms * MIN_SLAB_UNITS * 16 * k for k in (1, RING_BLOCKS_PER_SM)]
    edges.append(sms * REGISTER_BLOCKS_PER_SM * MIN_SLAB_UNITS * 8)
    ps = [1, 2, 15, 16, 17, 33, *(e + d for e in edges for d in (-16, -1, 0, 1, 16)), P_MNIST]
    cases = 0
    for c in (1, 3, 40):
        for p in ps:
            for want_vec in (16, 8, 2, 1):
                q, _ = int8_layout(torch, c, p, want_vec, gen)
                cases += check_dequant_case(torch, ops, q, gen,
                                            f"dequant_accumulate_flat edge c={c} p={p} "
                                            f"vec={want_vec}")
                del q
        torch.cuda.empty_cache()
    print(f"kernels: {cases} B4 cases on the launch plan's edges agree with the plain version "
          f"(rtol {TOL['rtol']}, atol {TOL['atol']}; C 1, 3 and 40; P {ps}; load widths 16, 8, "
          "2 and 1)")


def check_dequant_determinism(torch, ops, gen) -> None:
    """Two launches of B4 at C = 64 and 1000 (rows padded to 16 bytes, P = 1,199,882)
    must give the same bits."""
    for c in (EPILOGUE_CLIENTS, 1000):
        q = int8_rows(torch, c, P_MNIST, -(-P_MNIST // 16) * 16, 0, gen)
        s = torch.rand(c, generator=gen, device="cuda") * 1e-2 + 1e-4
        w = torch.rand(c, generator=gen, device="cuda") + 0.5
        base = torch.randn(P_MNIST, generator=gen, device="cuda")
        a = ops.dequant_accumulate_flat(q, s, w, base)
        b = ops.dequant_accumulate_flat(q, s, w, base)
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"dequant_accumulate_flat C={c}: two launches gave different bits")
        del q
        torch.cuda.empty_cache()
    print(f"kernels: B4 gives the same bits twice at C = {EPILOGUE_CLIENTS} and 1000, "
          f"P = {P_MNIST}")


def time_dequant(torch, ops, card: str, gen) -> dict:
    """Time B4 at C = 64 and 1000 (P = 1,199,882, rows padded to 16 bytes, as the
    epilogue table allocates them): the wrapper's call (``ms``, as every kernel is
    timed: the coefficients' small tensor ops and the kernel) and, where the package
    has ``quantize.dequant_launch``, the kernel alone with the host's work hidden
    (``kernel_ms``); the call's host time, the plain version, the unfused yardstick,
    the bound, and the launch plan with the kernel's registers.  Returns the record at
    C = 64."""
    from nanofed_tpu_torch.ops import quantize

    record = {}
    p = P_MNIST
    for c in (EPILOGUE_CLIENTS, 1000):
        q = int8_rows(torch, c, p, -(-p // 16) * 16, 0, gen)
        s = torch.rand(c, generator=gen, device="cuda") * 1e-2 + 1e-4
        w = torch.rand(c, generator=gen, device="cuda") + 0.5
        base = torch.randn(p, generator=gen, device="cuda")
        coefs = (w * s) / w.sum()
        err = check_close(torch, f"dequant_accumulate_flat C={c}",
                          ops.dequant_accumulate_flat(q, s, w, base),
                          ops.dequant_accumulate_flat_plain(q, s, w, base), **TOL)
        call = lambda: ops.dequant_accumulate_flat(q, s, w, base)  # noqa: E731
        wrapper_ms = host_ms(call, torch)
        ms = median_ms(call, torch)
        kernel_ms = None
        if hasattr(quantize, "dequant_launch"):
            out = torch.empty(p, device="cuda")
            launch = lambda: quantize.dequant_launch(q, q.stride(0), coefs, base, out)  # noqa: E731
            launch()
            check_close(torch, f"dequant_accumulate_flat C={c} kernel alone", out,
                        ops.dequant_accumulate_flat_plain(q, s, w, base), **TOL)
            kernel_ms = median_ms(launch, torch, hide_host_ms=2 * wrapper_ms + 0.5)
        plain_ms = median_ms(lambda: ops.dequant_accumulate_flat_plain(q, s, w, base), torch)
        yard_ms = median_ms(lambda: torch.addmv(base, q.float().t(), coefs), torch)
        b_ms, b_by = bound_ms(c * p + 8 * p + 12 * c, 2 * c * p)
        kernel_note = ("not measured (no dequant_launch)" if kernel_ms is None else
                       f"{kernel_ms:.6f} (the launch alone, host hidden; share_of_bound="
                       f"{b_ms / kernel_ms:.4f})")
        line = (f"[{card}] dequant_accumulate_flat C={c} P={p}: ms={ms:.6f} (the call; "
                f"share_of_bound={b_ms / ms:.4f}) kernel_ms={kernel_note} host_ms="
                f"{wrapper_ms:.6f} plain_ms={plain_ms:.6f} yardstick_ms={yard_ms:.6f} (the "
                f"unfused pair torch.addmv(base, q.float().t(), coefs): no single PyTorch call "
                f"takes int8 with float coefficients) bound_ms={b_ms:.6f} ({b_by}) "
                f"max_abs_err={err:.3e}")
        if hasattr(quantize, "dequant_occupancy"):
            line += " " + dequant_plan_line(torch, q)
        print(line)
        if c == EPILOGUE_CLIENTS:
            record = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        del q
        torch.cuda.empty_cache()
    return record


def dequant_plan_line(torch, q) -> str:
    """B4's launch plan over ``q`` with what the card makes of it; fails if the grid
    is more than one wave."""
    from nanofed_tpu_torch.ops.quantize import dequant_occupancy
    from nanofed_tpu_torch.ops.reduce import plan_for, sm_count

    ldq = q.stride(0) if q.shape[0] > 1 else q.shape[1]
    vec, plan = plan_for(q, ldq)
    regs, per_sm = dequant_occupancy(q.device, vec, plan)
    sms = sm_count(q.device.index)
    if plan.blocks > sms * per_sm or per_sm < plan.per_sm:
        fail(f"dequant plan {plan}: the card holds {per_sm} blocks an SM ({sms} SMs), so the "
             "grid is more than one wave")
    return (f"plan: vec={vec} path={'ring' if plan.stages else 'registers'} "
            f"blocks={plan.blocks} slab={plan.slab} stages={plan.stages} "
            f"shared_bytes={plan.shared_bytes} per_sm_planned={plan.per_sm} "
            f"per_sm_card={per_sm} sms={sms} registers={regs}")


def train_client(torch, local_fit, params, data, client: int, rnd: int):
    """One client's local fit on the card: its own permutations and dropout keys."""
    from nanofed_tpu_torch.trainer import client_keys, draw_permutations

    gen = torch.Generator(device="cuda").manual_seed(1000 * rnd + client)
    n = data.y.shape[1]
    perms = draw_permutations(gen, 1, 1, n)
    keys = client_keys(rnd, SECURE_CLIENTS, "cuda")[client:client + 1]
    result = local_fit(params, data, perms, keys)
    return {k: v[0] for k, v in result.params.items()}


async def network_client(torch, comm, sa, url, cid, index, local_fit, data, cfg, template,
                         trained, fetched, spent, drop_at_round=None, client_kwargs=None,
                         poison=None, delay_s=0.0):
    """One network client as ``examples/secure_federation/run_secure.py`` drives it.
    With ``cfg`` None it is a plain client: each round fetch, train, submit its params
    (``poison(round, params)`` replaces them when given: a bad client).  Otherwise it
    is a secure client on the ``cuda`` backend: enroll, then each round fetch,
    (tolerant: deposit and open the round's shares), train, mask with B5/B7 and
    submit, answer the unmask request.  ``client_kwargs`` go to ``HTTPClient`` (an
    encoding, a ``security_manager``); ``delay_s`` is slept before each round's
    training (a slower device).  ``spent`` collects the seconds of the client's two
    synchronous sections, training and masking (each ends in a device synchronize).
    ``trained[round][cid]`` is what the client submitted, with its FedAvg weight."""
    import hashlib

    from nanofed_tpu_torch.core.exceptions import NanoFedError

    identity = sa.ClientKeyPair.generate()
    num_samples = float(data.mask.sum())
    async with comm.HTTPClient(url, cid, timeout_s=120, **(client_kwargs or {})) as client:
        if cfg is not None:
            if not await client.register_secagg(identity.public_bytes(), num_samples,
                                                backend="cuda"):
                raise RuntimeError(f"{cid}: enrollment refused")
            roster = await client.fetch_secagg_roster(timeout_s=120)
        while True:
            for _ in range(2000):
                try:
                    params, rnd, active = await client.fetch_global_model(like=template)
                    break
                except NanoFedError:  # round 0 is published concurrently with start-up
                    await asyncio.sleep(0.01)
            else:
                raise RuntimeError(f"{cid}: no model published")
            if not active:
                return
            fetched.setdefault(rnd, params)
            tolerant = cfg is not None and cfg.dropout_tolerant
            if cfg is not None:
                mask_index, mask_key = roster.index_of(cid), identity
                ordered, self_seed, held = roster.ordered_keys(), None, None
            if tolerant:
                participants, threshold = await client.fetch_secagg_round_info()
                if cid not in participants:
                    return
                mask_key = sa.ClientKeyPair.generate()
                context = f"{client.secagg_session}:{rnd}"
                self_seed, sealed = sa.make_dropout_shares(
                    identity, mask_key, participants,
                    {c: roster.public_keys[c] for c in participants},
                    threshold or cfg.threshold, my_id=cid, context=context)
                await client.deposit_secagg_shares(
                    rnd, mask_key.public_bytes(), sealed,
                    self_seed_commitment=hashlib.sha256(self_seed).digest())
                epks, inbox = await client.fetch_secagg_inbox(rnd, timeout_s=120)
                held = sa.open_share_inbox(identity, cid, roster.public_keys, inbox, epks,
                                           context)
                mask_index, ordered = participants.index(cid), [epks[c] for c in participants]
            if drop_at_round is not None and rnd >= drop_at_round:
                return  # gone after the share barrier: its masks are in the others' vectors
            if delay_s:
                await asyncio.sleep(delay_s)
            gp = {k: v.to("cuda") for k, v in params.items()}
            t0 = time.perf_counter()
            local = train_client(torch, local_fit, gp, data, index, rnd)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            spent.setdefault("train", []).append(t1 - t0)
            if cfg is None:
                if poison is not None:
                    local = poison(rnd, local)
                trained.setdefault(rnd, {})[cid] = (num_samples, local)
                accepted = await client.submit_update(local, {"num_samples": num_samples})
            else:
                trained.setdefault(rnd, {})[cid] = (roster.weights[cid], local)
                masked = sa.mask_update(local, mask_index, mask_key, ordered, rnd, cfg,
                                        weight=roster.weights[cid], backend="cuda",
                                        self_seed=self_seed, device="cuda")
                spent.setdefault("mask", []).append(time.perf_counter() - t1)
                spent["masked"] = masked
                accepted = await client.submit_masked_update(masked,
                                                             {"num_samples": num_samples})
            if not accepted:
                raise RuntimeError(f"{cid}: update refused in round {rnd}")
            answered = False
            while True:
                status = await client.check_server_status()
                if not status["training_active"] or status["round"] != rnd:
                    break
                if tolerant and not answered:
                    request = await client.poll_unmask_request()
                    if (request is not None and request["round"] == rnd
                            and cid in request["survivors"]):
                        reveals = sa.build_unmask_reveals(request, cid, held)
                        answered = await client.submit_unmask_reveals(rnd, reveals)
                await asyncio.sleep(0.01)


def phase_secure(torch, ops, card: str) -> dict[str, int]:
    """(f) and (g): the secure federation over localhost HTTP on the card, 8 clients of
    ``mnist_cnn`` at full width on the ``cuda`` backend; (h): the same clients in the
    plain network round, which the coordinator reduces with B1 on the card.  Returns
    their launch counts."""
    import logging

    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.security import secure_agg as sa
    from nanofed_tpu_torch.trainer import TrainingConfig, make_local_fit
    from nanofed_tpu_torch.utils.logger import LogConfig, Logger
    from nanofed_tpu_torch.utils.trees import ravel

    Logger().configure(LogConfig(level=logging.WARNING))  # no per-request lines
    n = SECURE_CLIENTS
    model = get_model("mnist_cnn")
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    train = load_mnist("train", None, synthetic_size=n * SECURE_SAMPLES)
    host = federate(train, num_clients=n, batch_size=64, seed=0)
    data = [host.select(slice(c, c + 1)).to(torch.device("cuda")) for c in range(n)]
    local_fit = make_local_fit(model, TrainingConfig(batch_size=64, local_epochs=1,
                                                     learning_rate=0.1))
    rounds = 2
    configs = {
        "f_secure": dict(secure=sa.SecureAggregationConfig(min_clients=n),
                         round=dict(min_clients=n, round_timeout_s=120.0), drop=None),
        # As run_secure.py --dropout-tolerant --drop-client 7 --drop-round 1 configures it.
        "g_dropout_tolerant": dict(
            secure=sa.SecureAggregationConfig(min_clients=n - 1, dropout_tolerant=True,
                                              threshold=n // 2 + 1),
            round=dict(min_clients=n, min_completion_rate=0.5, round_timeout_s=8.0),
            drop=n - 1),
        "h_plain_network": dict(secure=None, round=dict(min_clients=n, round_timeout_s=120.0),
                                drop=None),
    }
    totals = dict.fromkeys(ops.launch_counts(), 0)
    for name, cfg in configs.items():
        secure, drop = cfg["secure"], cfg["drop"]
        trained, fetched, spent = {}, {}, {}

        async def main():
            port = comm.free_port()
            server = comm.HTTPServer(port=port)
            await server.start()
            try:
                coordinator = comm.NetworkCoordinator(
                    server, init, comm.NetworkRoundConfig(num_rounds=rounds, **cfg["round"]),
                    secure=secure, device="cuda")
                url = f"http://127.0.0.1:{port}"
                clients = [
                    network_client(torch, comm, sa, url, f"client_{c}", c, local_fit, data[c],
                                   secure, init, trained, fetched, spent,
                                   drop_at_round=1 if c == drop else None)
                    for c in range(n)]
                await asyncio.wait_for(asyncio.gather(coordinator.run(), *clients), 300)
                return coordinator
            finally:
                await server.stop()

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        coordinator = asyncio.run(main())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = ops.launch_counts()
        history = coordinator.history
        print(f"[{card}] network {name}: round_durations_s={coordinator.ledger.durations_s} "
              f"wall_s={wall:.3f} history={history} launches={grew}")
        if [h["status"] for h in history] != ["COMPLETED"] * rounds:
            fail(f"{name}: rounds {history}")
        # Launches from the code: each masking client's mask_update is one B5 and one B7
        # (every peer's mask and, when tolerant, its self mask); the server's unmask is
        # one B6 a round, and the tolerant recovery one B7 a round (every survivor's self
        # mask and every orphaned pair mask).  The plain round's aggregate is one B1
        # (normalised form) over the stacked [8, P] params a round.
        tolerant = secure is not None and secure.dropout_tolerant
        want = dict.fromkeys(grew, 0)
        for r in range(rounds):
            if secure is None:
                want["weighted_mean_flat"] += 1
                continue
            survivors = n - (1 if drop is not None and r >= 1 else 0)
            want["quantize_u32"] += survivors
            want["add_mask"] += survivors + (1 if tolerant else 0)
            want["dequantize_u32"] += 1
        if grew != want:
            fail(f"{name}: kernel launches {grew}, expected {want}")
        if tolerant and [h["num_dropped"] for h in history] != [0, 1]:
            fail(f"{name}: num_dropped {[h['num_dropped'] for h in history]}, expected [0, 1]")
        # Each round's aggregate (the next round's published model, or the final
        # params) against the plain weighted FedAvg of the clients' own trained params.
        for r in range(rounds):
            agg = ravel(fetched[r + 1]) if r + 1 < rounds else ravel(coordinator.params).cpu()
            entries = trained[r].values()
            mass = sum(w for w, _ in entries)
            ref = sum(w * ravel(p).double().cpu() for w, p in entries) / mass
            err = float((agg.double() - ref).abs().max())
            tol = SECURE_TOL if secure is not None else PLAIN_NETWORK_TOL
            print(f"[{card}] network {name} round {r}: {len(trained[r])} clients, "
                  f"max|aggregate - FedAvg| = {err:.3e} (tolerance {tol})")
            if not (torch.isfinite(agg).all() and err <= tol):
                fail(f"{name} round {r}: aggregate differs from FedAvg by {err}")
        if secure is not None:
            print(f"[{card}] secure {name} host breakdown: "
                  f"{secure_breakdown(comm, spent, init)}")
        totals = {k: totals[k] + grew[k] for k in totals}
    return totals


def secure_breakdown(comm, spent: dict, params) -> str:
    """Where a secure client's time goes: the mean of its measured training and masking
    sections, and one timing each of the wire work around them (the masked vector's
    npz compression and the server's decode of it, the model's npz encode at publish
    and its decode at fetch), all on the host clock."""
    import io

    import numpy as np

    t0 = time.perf_counter()
    buf = io.BytesIO()
    np.savez_compressed(buf, masked=spent["masked"])
    t1 = time.perf_counter()
    np.load(io.BytesIO(buf.getvalue()))["masked"]
    t2 = time.perf_counter()
    payload = comm.encode_params(params)
    t3 = time.perf_counter()
    comm.decode_params(payload, like=params)
    t4 = time.perf_counter()
    parts = dict(train_s=statistics.mean(spent["train"]), mask_s=statistics.mean(spent["mask"]),
                 masked_npz_compress_s=t1 - t0, masked_npz_decode_s=t2 - t1,
                 model_npz_encode_s=t3 - t2, model_npz_decode_s=t4 - t3)
    return " ".join(f"{k}={v:.6f}" for k, v in parts.items()) + (
        f" (masked payload {len(buf.getvalue())} bytes, model payload {len(payload)} bytes)")


WIRE_VALIDATION = dict(max_norm=25.0)  # (o): a trained mnist_cnn leaf's L2 norm is below 7
WIRE_POISON_SCALE = 1e3  # (o): the grossly scaled update of round 1
WIRE_BYZANTINE_SHIFT = 8.0  # (o): the Byzantine client's params, shifted by -8
TOPK_FRACTION = 0.05  # (p)
FEDBUFF = dict(async_buffer_k=4, staleness_window=4)  # (q)
FEDBUFF_AGGREGATIONS = 4
FEDBUFF_DELAY_S = 0.15  # (q): client c sleeps c * this before each round's training
FEDBUFF_TOL = 1e-5  # (q): a float32 aggregation against its float64 recomputation
INGEST_TOL = 1e-6  # (q): the ingest drain against fedbuff_combine on the same updates


def wire_setup(torch):
    """(h)'s cohort: 8 ``mnist_cnn`` clients of 600 samples, 1 epoch, f32."""
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.trainer import TrainingConfig, make_local_fit

    n = SECURE_CLIENTS
    model = get_model("mnist_cnn")
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    host = federate(load_mnist("train", None, synthetic_size=n * SECURE_SAMPLES),
                    num_clients=n, batch_size=64, seed=0)
    data = [host.select(slice(c, c + 1)).to(torch.device("cuda")) for c in range(n)]
    local_fit = make_local_fit(model, TrainingConfig(batch_size=64, local_epochs=1,
                                                     learning_rate=0.1))
    return init, data, local_fit


def run_wire(torch, ops, card: str, tag: str, setup, *, rounds: int, server_kwargs=None,
             coordinator_kwargs=None, round_kwargs=None, client_kwargs=None, poison=None,
             delays=None, secure=None, gate=False, extra=None, want=None):
    """One network run of (h)'s cohort through ``HTTPServer``, ``NetworkCoordinator``
    and ``HTTPClient`` on the card, its launch counts zeroed just before and read just
    after (they must equal ``want``).  ``gate`` lets the coordinator see the buffer
    only once all 8 clients have submitted (a validated round rejects some, so its
    barrier is lower than the cohort).  ``want`` may be a function of the
    coordinator.  ``extra(url)`` is one more coroutine beside
    the clients.  Returns the coordinator, what each client submitted and fetched,
    the updates each drain took, every published version, the server and the launch
    counts."""
    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch.security import secure_agg as sa

    init, data, local_fit = setup
    n = SECURE_CLIENTS
    trained, fetched, spent, drained, publishes = {}, {}, {}, [], {}
    client_kwargs = client_kwargs or (lambda c: {})

    async def main():
        port = comm.free_port()
        server = comm.HTTPServer(port=port, **(server_kwargs or {}))
        if gate:
            server.num_updates = lambda: (len(server._updates)
                                          if len(server._updates) >= n else 0)
        for name in ("drain_updates", "take_updates"):
            method = getattr(server, name)

            async def captured(*a, _method=method):
                out = await _method(*a)
                drained.append(list(out))
                return out

            setattr(server, name, captured)
        publish = server.publish_model

        async def publish_and_keep(params, r):
            publishes[r] = {k: v.detach().cpu().clone() for k, v in params.items()}
            await publish(params, r)

        server.publish_model = publish_and_keep
        await server.start()
        try:
            coordinator = comm.NetworkCoordinator(
                server, init, comm.NetworkRoundConfig(num_rounds=rounds, **round_kwargs),
                secure=secure, device="cuda", **(coordinator_kwargs or {}))
            url = f"http://127.0.0.1:{port}"
            clients = [
                network_client(torch, comm, sa, url, f"client_{c}", c, local_fit, data[c],
                               secure, init, trained, fetched, spent,
                               client_kwargs=client_kwargs(c),
                               poison=poison if c == n - 1 else None,
                               delay_s=(delays or [0.0] * n)[c])
                for c in range(n)]
            if extra is not None:
                clients.append(extra(url))
            await asyncio.wait_for(asyncio.gather(coordinator.run(), *clients), 300)
            return coordinator, server
        finally:
            await server.stop()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    coordinator, server = asyncio.run(main())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = ops.launch_counts()
    print(f"[{card}] {tag}: round_durations_s={coordinator.ledger.durations_s} "
          f"wall_s={wall:.3f} launches={grew}")
    if callable(want):
        want = want(coordinator)
    want = {k: (want or {}).get(k, 0) for k in grew}
    if grew != want:
        fail(f"{tag}: kernel launches {grew}, expected {want}")
    return dict(coordinator=coordinator, trained=trained, fetched=fetched, drained=drained,
                publishes=publishes, server=server, grew=grew, spent=spent)


def published(run, r: int, torch):
    """The params published after round or aggregation ``r``: the next round's model,
    or the final params."""
    from nanofed_tpu_torch.utils.trees import ravel

    nxt = run["publishes"].get(r + 1)
    return ravel(nxt if nxt is not None else run["coordinator"].params).cpu().double()


def check_fedavg(torch, card: str, tag: str, agg, entries, tol: float) -> float:
    """``agg`` against the float64 weighted FedAvg of ``entries`` ((weight, params))."""
    from nanofed_tpu_torch.utils.trees import ravel

    mass = sum(w for w, _ in entries)
    ref = sum(w * ravel(p).double().cpu() for w, p in entries) / mass
    err = float((agg - ref).abs().max())
    print(f"[{card}] {tag}: {len(entries)} updates, max|aggregate - FedAvg| = {err:.3e} "
          f"(tolerance {tol})")
    if not (torch.isfinite(agg).all() and err <= tol):
        fail(f"{tag}: aggregate differs from the float64 FedAvg by {err}")
    return err


def loo_anomalous(norms: dict, threshold: float) -> set:
    """The clients whose leave-one-out z-score of their update norm exceeds
    ``threshold``, in float64."""
    import numpy as np

    out = set()
    for c, v in norms.items():
        rest = np.array([u for k, u in norms.items() if k != c])
        if abs(v - rest.mean()) / (rest.std(ddof=1) + 1e-8) > threshold:
            out.add(c)
    return out


def phase_wire_validation(torch, ops, card: str, setup) -> dict[str, int]:
    """(o): two validated rounds, client_7 posting a NaN leaf and then a 1000x scaled
    update, the cohort z-score off (``min_clients_for_stats`` above the cohort): both
    rejected as out of range, the aggregate the FedAvg of the 7 others.  Then one
    round with the z-score on, which measures how many honest clients the reference's
    float32 leave-one-out z-score over the params' norms rejects.  Then trimmed mean
    (k=1) and Multi-Krum (f=1) rounds with client_7 Byzantine (its params shifted by
    -8), each held against a float64 recomputation."""
    import numpy as np

    from nanofed_tpu_torch.aggregation.robust import RobustAggregationConfig
    from nanofed_tpu_torch.security.validation import ValidationConfig
    from nanofed_tpu_torch.utils.trees import ravel

    n = SECURE_CLIENTS
    bad = f"client_{n - 1}"

    def nan_then_scaled(rnd, local):
        if rnd == 0:
            return {k: (torch.full_like(v, float("nan")) if k == "fc2/bias" else v)
                    for k, v in local.items()}
        return {k: v * WIRE_POISON_SCALE for k, v in local.items()}

    totals: dict[str, int] = {}
    cfg = ValidationConfig(**WIRE_VALIDATION, min_clients_for_stats=n + 1)
    run = run_wire(torch, ops, card, "(o) validated", setup, rounds=2, gate=True,
                   round_kwargs=dict(min_clients=n, min_completion_rate=(n - 1) / n,
                                     round_timeout_s=120.0),
                   coordinator_kwargs=dict(validation=cfg), poison=nan_then_scaled,
                   want={"weighted_mean_flat": 2})
    add_launches(totals, run["grew"])
    for r, record in enumerate(run["coordinator"].history):
        print(f"[{card}] (o) validated round {r}: {record['status']} num_rejected="
              f"{record['num_rejected']} rejected={record.get('rejected')}")
        if record["status"] != "COMPLETED" or record.get("rejected") != {bad: "INVALID_RANGE"}:
            fail(f"(o) validated round {r}: {record}")
        entries = run["trained"][r]
        check_fedavg(torch, card, f"(o) validated round {r}", published(run, r, torch),
                     [entries[c] for c in sorted(entries) if c != bad], PLAIN_NETWORK_TOL)

    cfg = ValidationConfig(**WIRE_VALIDATION)
    run = run_wire(torch, ops, card, "(o) validated, z-score on", setup, rounds=1, gate=True,
                   round_kwargs=dict(min_clients=n, min_completion_rate=1 / n,
                                     round_timeout_s=120.0),
                   coordinator_kwargs=dict(validation=cfg), poison=nan_then_scaled,
                   want=lambda coordinator: {"weighted_mean_flat": int(
                       coordinator.history[0]["status"] == "COMPLETED")})
    add_launches(totals, run["grew"])
    record, entries = run["coordinator"].history[0], run["trained"][0]
    norms = {c: float(np.linalg.norm(ravel(p).double().cpu().numpy()))
             for c, (_, p) in entries.items() if c != bad}
    spread = (max(norms.values()) - min(norms.values())) / statistics.mean(norms.values())
    flagged = sorted(c for c, v in record.get("rejected", {}).items() if v == "ANOMALOUS")
    exact = sorted(loo_anomalous(norms, cfg.z_score_threshold))
    print(f"[{card}] (o) z-score on: {record['status']}; the float32 leave-one-out z-score "
          f"rejected {len(flagged)} of {n - 1} honest clients {flagged}; in float64 it "
          f"would reject {len(exact)} {exact}; the honest params' norms spread "
          f"{spread:.3e} relative")
    if record.get("rejected", {}).get(bad) != "INVALID_RANGE":
        fail(f"(o) z-score on: the NaN client was not rejected as out of range: {record}")
    if record["status"] == "COMPLETED":
        check_fedavg(torch, card, "(o) z-score on", published(run, 0, torch),
                     [entries[c] for c in sorted(entries)
                      if c not in record["rejected"]], PLAIN_NETWORK_TOL)

    def byzantine(rnd, local):
        return {k: v - WIRE_BYZANTINE_SHIFT for k, v in local.items()}

    for method, want_launches in (("trimmed_mean", {}),
                                  ("multi_krum", {"weighted_mean_flat": 1})):
        run = run_wire(torch, ops, card, f"(o) robust {method}", setup, rounds=1,
                       round_kwargs=dict(min_clients=n, round_timeout_s=120.0),
                       coordinator_kwargs=dict(robust=RobustAggregationConfig(
                           method=method, trim_k=1)),
                       poison=byzantine, want=want_launches)
        add_launches(totals, run["grew"])
        record = run["coordinator"].history[0]
        if record["status"] != "COMPLETED":
            fail(f"(o) robust {method}: {record}")
        entries = run["trained"][0]
        x = torch.stack([ravel(entries[c][1]).double().cpu() for c in sorted(entries)])
        if method == "trimmed_mean":
            ref = torch.sort(x, dim=0).values[1:-1].mean(0)
        else:
            d2 = torch.cdist(x, x).square()
            scores = torch.sort(d2, dim=1).values[:, 1:1 + n - 1 - 2].sum(1)
            keep = torch.argsort(scores, stable=True)[: n - 1]
            ref = x[keep].mean(0)
            if sorted(keep.tolist()) != list(range(n - 1)):
                fail(f"(o) multi_krum: the float64 selection {keep.tolist()} keeps the "
                     "Byzantine client")
        agg = published(run, 0, torch)
        err = float((agg - ref).abs().max())
        honest_gap = float((agg - x[: n - 1].mean(0)).abs().max())
        print(f"[{card}] (o) robust {method}: max|aggregate - float64 {method}| = "
              f"{err:.3e} (tolerance {PLAIN_NETWORK_TOL}); max|aggregate - honest "
              f"mean| = {honest_gap:.3e}; metrics {record['metrics']}")
        if not (torch.isfinite(agg).all() and err <= PLAIN_NETWORK_TOL):
            fail(f"(o) robust {method}: aggregate differs from float64 by {err}")
    return totals


def timed_calls(module, names, log: dict):
    """Wrap ``module``'s functions ``names`` so each call's seconds and, for bytes
    results, its length land in ``log[name]``; returns the originals to restore."""
    originals = {name: getattr(module, name) for name in names}
    for name, fn in originals.items():
        def wrapper(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            log.setdefault(_name, []).append(
                (time.perf_counter() - t0, len(out) if isinstance(out, bytes) else None))
            return out

        setattr(module, name, wrapper)
    return originals


def phase_wire_compressed(torch, ops, card: str, setup) -> dict[str, int]:
    """(p): 2 rounds of q8-delta and 3 of topk8-delta (fraction 0.05) submissions; each
    aggregate against the float64 weighted FedAvg of the server's reconstructions,
    with the bytes on the wire per update and the encode and decode seconds."""
    from nanofed_tpu_torch.communication import encode_params
    from nanofed_tpu_torch.communication import http_client, http_server
    from nanofed_tpu_torch.utils.trees import ravel

    n = SECURE_CLIENTS
    totals: dict[str, int] = {}
    npz_bytes = len(encode_params({k: v.cpu() for k, v in setup[0].items()}))
    for encoding, rounds, encoder in (("q8-delta", 2, "encode_delta_q8"),
                                      ("topk8-delta", 3, "encode_delta_topk8")):
        log: dict = {}
        decoder = "reconstruct_q8" if encoding == "q8-delta" else "reconstruct_topk8"
        restore = [(http_client, timed_calls(http_client, [encoder], log)),
                   (http_server, timed_calls(http_server, [decoder], log))]
        try:
            run = run_wire(torch, ops, card, f"(p) {encoding}", setup, rounds=rounds,
                           round_kwargs=dict(min_clients=n, round_timeout_s=120.0),
                           client_kwargs=lambda c, e=encoding: dict(
                               update_encoding=e, topk_fraction=TOPK_FRACTION),
                           want={"weighted_mean_flat": rounds})
        finally:
            for module, originals in restore:
                for name, fn in originals.items():
                    setattr(module, name, fn)
        add_launches(totals, run["grew"])
        for r in range(rounds):
            reconstructed = run["drained"][r]
            entries = [(float(u.metrics["num_samples"]), u.params)
                       for u in sorted(reconstructed, key=lambda u: u.client_id)]
            check_fedavg(torch, card, f"(p) {encoding} round {r} (server reconstructions)",
                         published(run, r, torch), entries, PLAIN_NETWORK_TOL)
            trained = run["trained"][r]
            gap = max(float((ravel(u.params).double() - ravel(trained[u.client_id][1])
                             .double().cpu()).abs().max()) for u in reconstructed)
            print(f"[{card}] (p) {encoding} round {r}: max|reconstruction - client "
                  f"params| = {gap:.3e}")
        enc = log.get(encoder, [])
        dec = log.get(decoder, [])
        sizes = [b for _, b in enc]
        print(f"[{card}] (p) {encoding}: bytes per update npz={npz_bytes} "
              f"{encoding}={statistics.mean(sizes):.0f} (min {min(sizes)}, max "
              f"{max(sizes)}, x{npz_bytes / statistics.mean(sizes):.2f} fewer); client "
              f"encode s mean={statistics.mean(s for s, _ in enc):.6f} max="
              f"{max(s for s, _ in enc):.6f} over {len(enc)}; server decode s mean="
              f"{statistics.mean(s for s, _ in dec):.6f} max={max(s for s, _ in dec):.6f} "
              f"over {len(dec)} (both in the run, beside 8 clients training on the event "
              f"loop)")
        # The same work once more with the host otherwise idle: client_0's last update.
        last = max(run["trained"])
        local = {k: v.cpu() for k, v in run["trained"][last]["client_0"][1].items()}
        base = {k: v.cpu() for k, v in run["publishes"][last].items()}
        delta = {k: local[k] - base[k] for k in local}
        encode = getattr(http_client, encoder)
        kwargs = {"fraction": TOPK_FRACTION} if encoding == "topk8-delta" else {}
        t0 = time.perf_counter()
        body = encode(delta, **kwargs)
        t1 = time.perf_counter()
        getattr(http_server, decoder)(base, body)
        t2 = time.perf_counter()
        encode_params(local)
        t3 = time.perf_counter()
        print(f"[{card}] (p) {encoding} alone: encode {t1 - t0:.6f} s, server "
              f"reconstruction {t2 - t1:.6f} s ({len(body)} bytes); npz encode "
              f"{t3 - t2:.6f} s")
    return totals


def fedbuff_reference(torch, run, record, versions, trained):
    """One FedBuff aggregation recomputed in float64 from the updates its drain
    reports: ``v + lr/K Σ (1+τ)^-α (params_i - base_i)``."""
    from nanofed_tpu_torch.utils.trees import ravel

    v = record["version"] - 1
    out = versions[v].clone()
    k = record["num_clients"]
    for cid, tau in zip(record["drained"], record["staleness"]):
        base = versions[v - tau]
        params = ravel(trained[v - tau][cid][1]).double().cpu()
        out += (1.0 + tau) ** -0.5 / k * (params - base)
    return out


def phase_wire_fedbuff(torch, ops, card: str, setup) -> dict[str, int]:
    """(q): FedBuff (K=4, window 4) over 8 clients of staggered delay, 4 aggregations,
    with the list buffer and with ``IngestConfig()`` (256 slots on the card); each
    aggregation against its float64 recomputation, the list run's drains replayed
    through an ingest buffer; then 2 sync rounds on the ingest buffer."""
    import numpy as np

    from nanofed_tpu_torch.communication import fedbuff_combine
    from nanofed_tpu_torch.ingest import DeviceIngestBuffer, IngestConfig, flatten_params
    from nanofed_tpu_torch.utils.trees import ravel

    n = SECURE_CLIENTS
    totals: dict[str, int] = {}
    delays = [FEDBUFF_DELAY_S * c for c in range(n)]
    runs = {}
    for name, ingest in (("list", None), ("ingest", IngestConfig())):
        drain_ms: list[float] = []
        server_kwargs = dict(ingest=ingest, device="cuda") if ingest is not None else {}
        run = run_wire(torch, ops, card, f"(q) FedBuff {name} buffer", setup,
                       rounds=FEDBUFF_AGGREGATIONS, server_kwargs=server_kwargs,
                       round_kwargs=dict(**FEDBUFF, round_timeout_s=120.0), delays=delays)
        add_launches(totals, run["grew"])
        history = run["coordinator"].history
        if [h["status"] for h in history] != ["COMPLETED"] * FEDBUFF_AGGREGATIONS:
            fail(f"(q) {name}: {history}")
        versions = {v: ravel(p).double() for v, p in run["publishes"].items()}
        for record in history:
            if record["num_skipped_out_of_window"]:
                fail(f"(q) {name}: a drain skipped stale bases: {record}")
            ref = fedbuff_reference(torch, run, record, versions, run["trained"])
            err = float((versions[record["version"]] - ref).abs().max())
            print(f"[{card}] (q) {name} aggregation {record['aggregation']} -> version "
                  f"{record['version']}: drained {record['drained']} staleness "
                  f"{record['staleness']} buffered_at_drain {record['buffered_at_drain']}; "
                  f"max|aggregate - float64| = {err:.3e} (tolerance {FEDBUFF_TOL})")
            if err > FEDBUFF_TOL:
                fail(f"(q) {name}: aggregation {record['aggregation']} differs by {err}")
        if ingest is not None:
            buffer = run["server"].ingest_pipeline.buffer
            print(f"[{card}] (q) ingest buffer: {buffer.capacity} slots x {buffer.flat_size} "
                  f"= {buffer.device_bytes} bytes on the card")
        runs[name] = run
        print(f"[{card}] (q) {name}: aggregation latency s "
              f"{run['coordinator'].ledger.durations_s}")

    # The list run's drains replayed through an ingest buffer on the card: the same
    # drained set gives the same params within INGEST_TOL.
    run = runs["list"]
    template = {k: v.cpu() for k, v in setup[0].items()}
    buffer = DeviceIngestBuffer(template, IngestConfig().capacity, device="cuda")
    bases = run["publishes"]
    worst = 0.0
    for record, taken in zip(run["coordinator"].history, run["drained"]):
        v = record["version"] - 1
        for u in taken:
            buffer.offer(flatten_params(u.params) - flatten_params(bases[u.round_number]),
                         client_id=u.client_id, round_number=u.round_number, weight=1.0)
        base_flat = flatten_params(bases[v])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buffer._flush()  # the staged rows' copy alone; the drain below only multiplies
        torch.cuda.synchronize()
        flush_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out, _, _ = buffer.drain_fedbuff(len(taken), v, list(bases), base_flat)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        combined, _ = fedbuff_combine(bases[v], taken, bases, v, device="cuda")
        torch.cuda.synchronize()
        combine_ms = (time.perf_counter() - t0) * 1e3
        gap = float((out - ravel(combined)).abs().max())
        worst = max(worst, gap)
        print(f"[{card}] (q) replay of aggregation {record['aggregation']} ({len(taken)} "
              f"updates): staged rows copied in {flush_ms:.3f} ms, then the drain "
              f"{ms:.3f} ms (base copied in, one product over 256 rows, freed rows "
              f"zeroed), "
              f"fedbuff_combine {combine_ms:.3f} ms (host bases and updates copied to the "
              f"card), max|drain - fedbuff_combine| = {gap:.3e}")
    if worst > INGEST_TOL:
        fail(f"(q) the ingest drain differs from fedbuff_combine by {worst}")
    del buffer

    run = run_wire(torch, ops, card, "(q) sync rounds on the ingest buffer", setup,
                   rounds=2, server_kwargs=dict(ingest=IngestConfig(), device="cuda"),
                   round_kwargs=dict(min_clients=n, round_timeout_s=120.0))
    add_launches(totals, run["grew"])
    for r, record in enumerate(run["coordinator"].history):
        if record["status"] != "COMPLETED" or not record.get("ingest"):
            fail(f"(q) sync ingest round {r}: {record}")
        check_fedavg(torch, card, f"(q) sync ingest round {r}", published(run, r, torch),
                     list(run["trained"][r].values()), PLAIN_NETWORK_TOL)
    print(f"[{card}] (q) sync ingest: round latency s "
          f"{run['coordinator'].ledger.durations_s}")
    return totals


def phase_wire_signed(torch, ops, card: str, setup) -> dict[str, int]:
    """(r): signed rounds, every client with a ``SecurityManager`` and the server with
    ``require_signatures=True``: one npz round and one q8 round, an unregistered
    client's update refused with 403 and absent from the aggregate; then one signed
    masked round on the ``cuda`` backend (B5, B7, B6)."""
    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch.security import signing
    from nanofed_tpu_torch.security.secure_agg import SecureAggregationConfig

    n = SECURE_CLIENTS
    totals: dict[str, int] = {}
    t0 = time.perf_counter()
    managers = [signing.SecurityManager() for _ in range(n + 1)]
    keygen_s = (time.perf_counter() - t0) / (n + 1)
    keys = {f"client_{c}": managers[c].get_public_key() for c in range(n)}
    intruder_key = managers[n]
    refused: list[int] = []

    async def intruder(url):
        """A client whose key is not registered: fetch, submit, expect 403."""
        import base64

        import aiohttp

        async with comm.HTTPClient(url, "intruder", timeout_s=120,
                                   security_manager=intruder_key) as client:
            for _ in range(2000):
                try:
                    params, rnd, _ = await client.fetch_global_model(like=setup[0])
                    break
                except Exception:
                    await asyncio.sleep(0.01)
            body = comm.encode_params(params)
            signature = intruder_key.sign_update(params, "intruder", rnd, "{}")
            async with aiohttp.ClientSession() as session:
                async with session.post(url + "/update", data=body, headers={
                        "X-NanoFed-Client": "intruder", "X-NanoFed-Round": str(rnd),
                        "X-NanoFed-Signature": base64.b64encode(signature).decode()}) as r:
                    refused.append(r.status)

    log: dict = {}
    restore = timed_calls(signing, ["update_signing_bytes", "verify_update_signature"], log)
    sign_s: list[float] = []
    originals = [m.sign_update for m in managers]
    for m in managers:
        def sign(*a, _fn=m.sign_update, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            sign_s.append(time.perf_counter() - t)
            return out

        m.sign_update = sign
    try:
        for encoding in ("npz", "q8-delta"):
            refused.clear()
            run = run_wire(torch, ops, card, f"(r) signed {encoding}", setup, rounds=1,
                           server_kwargs=dict(require_signatures=True, client_keys=keys),
                           round_kwargs=dict(min_clients=n, round_timeout_s=120.0),
                           client_kwargs=lambda c, e=encoding: dict(
                               update_encoding=e, security_manager=managers[c]),
                           extra=intruder, want={"weighted_mean_flat": 1})
            add_launches(totals, run["grew"])
            record = run["coordinator"].history[0]
            names = {u.client_id for u in run["drained"][0]}
            print(f"[{card}] (r) signed {encoding}: {record['status']} "
                  f"{record['num_clients']} clients; intruder answered {refused}")
            if (record["status"] != "COMPLETED" or refused != [403] or "intruder" in names
                    or len(names) != n):
                fail(f"(r) signed {encoding}: {record}, intruder {refused}, drained {names}")
            entries = [(float(u.metrics["num_samples"]), u.params)
                       for u in sorted(run["drained"][0], key=lambda u: u.client_id)]
            check_fedavg(torch, card, f"(r) signed {encoding}", published(run, 0, torch),
                         entries, PLAIN_NETWORK_TOL)
    finally:
        for name, fn in restore.items():
            setattr(signing, name, fn)
        for m, fn in zip(managers, originals):
            m.sign_update = fn
    verify = log.get("verify_update_signature", [])
    canon = log.get("update_signing_bytes", [])
    print(f"[{card}] (r) signing per update: key generation {keygen_s:.6f} s a client; "
          f"sign (canonical bytes, SHA-256, RSA-2048) mean {statistics.mean(sign_s):.6f} s "
          f"over {len(sign_s)}; server verify mean "
          f"{statistics.mean(s for s, _ in verify):.6f} s over {len(verify)}; canonical "
          f"bytes alone mean {statistics.mean(s for s, _ in canon):.6f} s "
          f"({canon[0][1]} bytes; all in the run, beside 8 clients training on the event "
          f"loop)")
    params = {k: v.cpu() for k, v in run["drained"][0][0].params.items()}
    t0 = time.perf_counter()
    signature = managers[0].sign_update(params, "client_0", 0, "{}")
    t1 = time.perf_counter()
    ok = signing.verify_update_signature(params, "client_0", 0, "{}", signature,
                                         keys["client_0"])
    t2 = time.perf_counter()
    signing.canonical_bytes(params)
    t3 = time.perf_counter()
    print(f"[{card}] (r) alone: sign {t1 - t0:.6f} s, verify {t2 - t1:.6f} s (ok={ok}), "
          f"canonical bytes {t3 - t2:.6f} s")
    if not ok:
        fail("(r) a signature made on the card's host does not verify")

    secure = SecureAggregationConfig(min_clients=n)
    run = run_wire(torch, ops, card, "(r) signed masked round, cuda backend", setup, rounds=1,
                   server_kwargs=dict(require_signatures=True, client_keys=keys),
                   round_kwargs=dict(min_clients=n, round_timeout_s=120.0),
                   client_kwargs=lambda c: dict(security_manager=managers[c]), secure=secure,
                   want={"quantize_u32": n, "add_mask": n, "dequantize_u32": 1})
    add_launches(totals, run["grew"])
    record = run["coordinator"].history[0]
    if record["status"] != "COMPLETED":
        fail(f"(r) signed masked round: {record}")
    check_fedavg(torch, card, "(r) signed masked round", published(run, 0, torch),
                 list(run["trained"][0].values()), SECURE_TOL)
    return totals


def phase_wire(torch, ops, card: str) -> dict[str, int]:
    """(o)-(r): the network mode's update pipeline over (h)'s cohort."""
    import logging

    from nanofed_tpu_torch.utils.logger import LogConfig, Logger

    Logger().configure(LogConfig(level=logging.WARNING))
    setup = wire_setup(torch)
    totals: dict[str, int] = {}
    for phase in (phase_wire_validation, phase_wire_compressed, phase_wire_fedbuff,
                  phase_wire_signed):
        t0 = time.perf_counter()
        add_launches(totals, phase(torch, ops, card, setup))
        print(f"[{card}] {phase.__name__}: {time.perf_counter() - t0:.3f} s")
    return totals


def step_launches(chunk, rows: int) -> dict[str, int]:
    """Kernel launches of one plain round step over ``rows`` clients: the
    materialised reduce (B1 normalised, B3 once), or per chunk B1's accumulate form
    and B3."""
    if chunk is None or chunk >= rows:
        return {"weighted_mean_flat": 1, "row_sq_norms": 1}
    return {"weighted_sum_into": rows // chunk, "row_sq_norms": rows // chunk}


def add_launches(total: dict, more: dict, times: int = 1) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + times * v


def sweep_launches(result_dict: dict, rows: int, calls: int) -> tuple[dict, int]:
    """Launches of an autotune sweep from its artifact: every profiled candidate's
    round step (or R-round block, R rounds a call) ran ``calls`` times (the
    profiler's first, counting and timed calls),
    and the epilogue table ran B4 and B2 ``calls`` times each.  Also returns how many
    candidates were rejected for running out of device memory (their partial runs
    are not derivable)."""
    want: dict[str, int] = {}
    oom = 0
    if result_dict["cache_hit"]:  # a repeat run in one checkout: nothing was profiled
        return want, oom
    for cand in result_dict["candidates"]:
        reason = cand.get("reject_reason", "")
        if cand["feasible"] or "exceeds the device HBM budget" in reason:
            add_launches(want, step_launches(cand["config"]["client_chunk"], rows),
                         calls * cand["config"]["rounds_per_block"])
        elif "out of device memory" in reason:
            oom += 1
    add_launches(want, {"dequant_accumulate_flat": calls,
                        "masked_weighted_mean_flat": calls})
    return want, oom


def check_launches(name: str, grew: dict, want: dict, oom: int) -> None:
    """Every count equal to the derived one; with a candidate rejected for memory, B4
    and B2 equal and the round-step kernels at least the derived counts."""
    want = {k: want.get(k, 0) for k in grew}
    exact = ("dequant_accumulate_flat", "masked_weighted_mean_flat")
    if oom == 0 and grew != want:
        fail(f"{name}: kernel launches {grew}, expected {want}")
    if any(grew[k] != want[k] for k in exact) or any(grew[k] < want[k] for k in grew):
        fail(f"{name}: kernel launches {grew}, expected {want} ({oom} out-of-memory "
             "candidates)")


def print_sweep(card: str, tag: str, result) -> None:
    """The ranked table of an autotune sweep and each profiled candidate's counts."""
    from nanofed_tpu_torch.tuning import format_candidate_table

    print(format_candidate_table(result))
    for o in result.outcomes:
        if o.cost:
            print(f"[{card}] {tag} candidate chunk={o.config.client_chunk} "
                  f"rounds_per_block={o.config.rounds_per_block} "
                  f"batch={o.config.batch_size}: measured_s_per_round="
                  f"{o.cost['measured_s_per_round']:.6f} first_call_s="
                  f"{o.cost['compile_seconds']} bound_s_per_round="
                  f"{o.cost.get('lower_bound_s_per_round')} flops_per_round="
                  f"{o.cost['flops_per_round']:.0f} bytes_per_round="
                  f"{o.cost['bytes_accessed_per_round']:.0f} peak_bytes={o.cost['peak_bytes']}")


def print_epilogues(card: str, epilogues: dict) -> None:
    for name, rep in sorted(epilogues["reports"].items()):
        print(f"[{card}] (i) epilogue {name}: bytes_accessed={rep['bytes_accessed']:.0f} "
              f"measured_ms={rep['measured_s'] * 1e3:.6f} peak_bytes={rep['peak_bytes']}")
    for kind in ("q8", "validated"):
        cmp_ = epilogues[kind]
        print(f"[{card}] (i) epilogue {kind} at P={epilogues['flat_size']} "
              f"C={epilogues['clients']}: fused {cmp_['fused_bytes_accessed']:.0f} bytes "
              f"{cmp_['fused_measured_ms']:.6f} ms vs unfused "
              f"{cmp_['unfused_bytes_accessed']:.0f} bytes {cmp_['unfused_measured_ms']:.6f} "
              f"ms ({cmp_.get('bytes_accessed_reduction_pct')}% fewer bytes)")


def phase_autotune(torch, ops, run_experiment, card: str, out_dir: Path) -> dict[str, int]:
    """(i): the autotuned flagship through ``Coordinator.from_autotune`` (held against
    a hand-built coordinator with the winner's knobs), then the autotuned runner with
    the online retuner and program profiling.  Returns their launch counts."""
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability.profiling import TIMED_CALLS
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.tuning import AutotuneResult, TuningSpace
    from nanofed_tpu_torch.utils.trees import ravel

    calls = 2 + TIMED_CALLS  # the profiler's first, counting and timed calls
    cfg = FLAGSHIP
    n = cfg["num_clients"]
    model = get_model("mnist_cnn")
    data = federate(load_mnist("train", None, synthetic_size=cfg["train_size"]),
                    num_clients=n, batch_size=cfg["batch_size"], seed=0)
    training = TrainingConfig(batch_size=cfg["batch_size"], local_epochs=cfg["local_epochs"],
                              learning_rate=cfg["learning_rate"],
                              compute_dtype=cfg["compute_dtype"])
    space = TuningSpace(client_chunks=TUNED_CHUNKS, rounds_per_blocks=(1,), model_shards=(1,),
                        batch_sizes=TUNED_BATCHES)
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    coord = Coordinator.from_autotune(
        model, data, CoordinatorConfig(num_rounds=cfg["num_rounds"], seed=0,
                                       base_dir=out_dir / "i_flagship"),
        training, tuning_space=space, autotune_cache_dir=out_dir / "cache", device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    rounds = coord.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = ops.launch_counts()
    result = coord.autotune_result
    winner = result.winner
    print(f"[{card}] (i) autotuned flagship: sweep_s={sweep_s:.3f} (profiled "
          f"{result.compiles} candidates, {calls} calls each) wall_s={wall:.3f} "
          f"round_durations_s={[r.duration_s for r in rounds]} winner={winner.to_dict()} "
          f"launches={grew}")
    print_sweep(card, "(i) flagship", result)
    print_epilogues(card, result.epilogues)
    if [r.status for r in rounds] != [RoundStatus.COMPLETED] * cfg["num_rounds"]:
        fail(f"(i) flagship: rounds {[r.status for r in rounds]}")
    want, oom = sweep_launches(result.to_dict(), n, calls)
    add_launches(want, step_launches(winner.client_chunk, n), cfg["num_rounds"])
    check_launches("(i) flagship", grew, want, oom)
    print(f"[{card}] (i) flagship launches {grew} = the sweep's {calls} calls per profiled "
          f"candidate ({oom} rejected for memory) + B4 and B2 {calls} each in the "
          f"epilogue table + {cfg['num_rounds']} rounds at the winner's chunk")
    if result.epilogues["q8"]["bytes_accessed_reduction_pct"] <= 0:
        fail("(i) the fused q8 epilogue must move fewer bytes than the unfused pair")
    add_launches(totals, grew)

    ref = Coordinator(model, data, CoordinatorConfig(num_rounds=cfg["num_rounds"], seed=0,
                                                     base_dir=out_dir / "i_reference"),
                      training=dataclasses.replace(training, batch_size=winner.batch_size),
                      client_chunk=winner.client_chunk, device="cuda")
    ref.run()
    got, want_params = ravel(coord.params), ravel(ref.params)
    diff = float((got - want_params).abs().max())
    print(f"[{card}] (i) autotuned vs hand-built coordinator with the winner's knobs: "
          f"max|dparams|={diff:.3e} (tolerance {CROSS_TOL})")
    if not (torch.isfinite(got).all() and diff <= CROSS_TOL):
        fail(f"(i) the autotuned coordinator differs from the hand-built one by {diff}")
    del coord, ref
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_experiment(model="mnist_cnn", num_clients=SECURE_CLIENTS,
                             train_size=SECURE_CLIENTS * RUNNER_SAMPLES, num_rounds=3,
                             autotune=True, retune_every=1, profile_programs=True,
                             device="cuda", seed=0, out_dir=out_dir / "i_runner")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = ops.launch_counts()
    tuned, retunes = summary["tuned_config"], summary["retunes"]
    print(f"[{card}] (i) autotuned runner: wall_s={wall:.3f} round_durations_s="
          f"{summary['round_durations_s']} tuned_config={json.dumps(tuned)} "
          f"retunes={json.dumps(retunes)} launches={grew}")
    profile = summary["program_profiles"]["round_step"]
    print(f"[{card}] (i) runner round_step profile: flops={profile['flops']:.0f} "
          f"bytes_accessed={profile['bytes_accessed']:.0f} peak_bytes="
          f"{profile['peak_bytes']} measured_s={profile['measured_s']:.6f} "
          f"first_call_s={profile['compile_seconds']} verdict={profile['verdict']}")
    if summary["rounds_completed"] != 3 or tuned["used"] != "tuned":
        fail(f"(i) runner: {summary['rounds_completed']}/3 rounds, tuned_config {tuned}")
    values = [*summary["final_train_metrics"].values(), *summary["final_eval_metrics"].values()]
    if not all(math.isfinite(v) for v in values):
        fail(f"(i) runner: non-finite metrics {values}")
    artifact = json.loads(Path(tuned["artifact"]).read_text())
    print_sweep(card, "(i) runner", AutotuneResult.from_dict(artifact))
    want, oom = sweep_launches(artifact, SECURE_CLIENTS, calls)
    # The catalog's round step, and its block of R rounds a call when the winner fuses.
    rpb = tuned["rounds_per_block"]
    add_launches(want, step_launches(tuned["client_chunk"], SECURE_CLIENTS),
                 calls * (1 + rpb if rpb > 1 else 1))
    for program, measured in retunes["measured"].items():  # the rounds each chunk ran
        chunk = int(program.split("_")[1].removeprefix("chunk")) or None
        add_launches(want, step_launches(chunk, SECURE_CLIENTS), measured["rounds"])
    check_launches("(i) runner", grew, want, oom)
    add_launches(totals, grew)
    return totals


def timed_method(obj, name: str, spent: list[float]) -> None:
    """Record the seconds of every call of ``obj.name`` in ``spent``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(obj, name, wrapper)


def max_gap(torch, a: dict, b: dict) -> float:
    """max |a - b| over the tensors two states share (params or a server state)."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a
               if torch.is_tensor(a[k]))


def phase_resume(torch, ops, run_experiment, card: str, out_dir: Path) -> dict[str, int]:
    """(j): resumable simulated runs at the flagship's shape through ``Coordinator``,
    FedAvgM (a [P] trace) and a cosine client schedule: an uninterrupted run with a
    ``ModelManager`` and a ``FileStateStore`` (its publish cost timed), a second
    uninterrupted run (the card's run-to-run gap), a run closed after two rounds and a
    fresh coordinator resuming it, and ``run_fault_tolerant`` through a
    ``ConnectionError``; then the runner's lr flags (``run_experiment(lr_schedule=
    "linear")``).  Returns the launch counts."""
    from nanofed_tpu_torch.aggregation import fedavgm_strategy
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.persistence import (
        FileStateStore,
        ModelManager,
        SimpleRecoveryStrategy,
        run_fault_tolerant,
    )
    from nanofed_tpu_torch.trainer import TrainingConfig, lr_schedule_scale

    cfg, rounds, chunk = FLAGSHIP, RESUME_ROUNDS, 125
    n = cfg["num_clients"]
    model = get_model("mnist_cnn")
    data = federate(load_mnist("train", None, synthetic_size=cfg["train_size"]),
                    num_clients=n, batch_size=cfg["batch_size"], seed=0)
    training = TrainingConfig(batch_size=cfg["batch_size"], local_epochs=cfg["local_epochs"],
                              learning_rate=cfg["learning_rate"],
                              compute_dtype=cfg["compute_dtype"])
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "j_resume"

    def make(name: str, **kwargs):
        return Coordinator(
            model, data, CoordinatorConfig(num_rounds=rounds, seed=0, base_dir=base / name,
                                           lr_schedule="cosine", lr_min_factor=0.2),
            training, strategy=fedavgm_strategy(), client_chunk=chunk, device="cuda",
            **kwargs)

    def drive(name: str, run, want_rounds: int):
        """Run ``run()`` with the counts zeroed just before; check the rounds' launches."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = ops.launch_counts()
        want = dict.fromkeys(grew, 0)
        add_launches(want, step_launches(chunk, n), want_rounds)
        print(f"[{card}] (j) {name}: wall_s={wall:.3f} launches={grew}")
        if grew != want:
            fail(f"(j) {name}: kernel launches {grew}, expected {want}")
        add_launches(totals, grew)
        return out

    # 1. Uninterrupted, publishing every round: a versioned model and a checkpoint.
    manager = ModelManager(base / "models")
    full = make("full", model_manager=manager, state_store=FileStateStore(base / "full_ckpt"))
    ckpt_s: list[float] = []
    model_s: list[float] = []
    publish_s: list[float] = []
    timed_method(full.state_store, "checkpoint", ckpt_s)
    timed_method(manager, "save_model", model_s)
    timed_method(full, "_publish_round", publish_s)
    full_rounds = drive("uninterrupted, publishing", full.run, rounds)
    for r, m in enumerate(full_rounds):
        print(f"[{card}] (j) round {r}: round_s={m.duration_s:.6f} "
              f"publish_s={publish_s[r]:.6f} checkpoint_s={ckpt_s[r]:.6f} "
              f"versioned_model_s={model_s[r]:.6f} lr_scale={m.agg_metrics['lr_scale']} "
              f"loss={m.agg_metrics['loss']:.6f}")
    if [m.status for m in full_rounds] != [RoundStatus.COMPLETED] * rounds:
        fail(f"(j) uninterrupted: rounds {[m.status for m in full_rounds]}")
    latest, version = manager.load_model(like=full.params)
    if version.round_number != rounds - 1 or not all(
            torch.equal(latest[k], full.params[k].cpu()) for k in full.params):
        fail(f"(j) the newest versioned model (round {version.round_number}) is not the "
             "live params bit for bit")

    # 2. The same run again: the card's run-to-run gap.
    again = make("again")
    drive("uninterrupted again", again.run, rounds)
    run_gap = max(max_gap(torch, again.params, full.params),
                  max_gap(torch, again.server_state, full.server_state))
    del again

    # 3. Closed after two rounds, resumed by a fresh coordinator.
    store = FileStateStore(base / "ckpt")
    first = make("first", state_store=store)

    def two_rounds():
        gen = first.start_training()
        out = [next(gen), next(gen)]
        gen.close()
        return out

    drive("closed after 2 rounds", two_rounds, 2)
    del first
    resumed = make("resumed", state_store=store)
    if resumed.current_round != 2:
        fail(f"(j) resumed at round {resumed.current_round}, expected 2")
    resumed_rounds = drive("resumed", resumed.run, rounds - 2)
    scales = [m.agg_metrics["lr_scale"] for m in resumed_rounds]
    want_scales = [m.agg_metrics["lr_scale"] for m in full_rounds][2:]
    resumed_gap = max(max_gap(torch, resumed.params, full.params),
                      max_gap(torch, resumed.server_state, full.server_state))
    print(f"[{card}] (j) run-to-run gap max|d(params, trace)|={run_gap:.3e}; resumed gap "
          f"{resumed_gap:.3e} (tolerance {RESUME_TOL}, and at most the run-to-run gap + "
          f"1e-6); resumed lr_scale={scales}, uninterrupted rounds 2-3 {want_scales}")
    if scales != want_scales:
        fail(f"(j) resumed lr scales {scales}, uninterrupted {want_scales}")
    if not (resumed_gap <= RESUME_TOL and resumed_gap <= run_gap + 1e-6):
        fail(f"(j) the resumed run differs from the uninterrupted one by {resumed_gap} "
             f"(run-to-run {run_gap})")
    del resumed

    # 4. run_fault_tolerant through a recoverable failure after round 1's checkpoint.
    tolerant_store = FileStateStore(base / "tolerant_ckpt")
    crashed = []

    def make_tolerant():
        coord = make("tolerant", state_store=tolerant_store)
        if not crashed:
            def partition(metrics):
                if metrics.round_id == 1:
                    crashed.append(metrics.round_id)
                    raise ConnectionError("simulated network partition")

            coord.on_round_end = partition
        return coord

    history = drive("run_fault_tolerant", lambda: run_fault_tolerant(
        make_tolerant, SimpleRecoveryStrategy(max_retries=2)), rounds)
    latest_round = tolerant_store.restore_latest().round_number
    print(f"[{card}] (j) run_fault_tolerant: crashed after rounds {crashed}, then history "
          f"{[m.round_id for m in history]}, latest checkpoint round {latest_round}")
    if [m.round_id for m in history] != [2, 3] or latest_round != rounds - 1:
        fail(f"(j) run_fault_tolerant history {[m.round_id for m in history]}, latest "
             f"checkpoint {latest_round}")

    # 5. The runner's lr flags: the flagship through run_experiment on a linear schedule.
    summary = drive("run_experiment(lr_schedule='linear')", lambda: run_experiment(
        model="mnist_cnn", device="cuda", seed=0, out_dir=base / "runner", client_chunk=chunk,
        lr_schedule="linear", lr_min_factor=0.2, **cfg), cfg["num_rounds"])
    last = cfg["num_rounds"] - 1
    want_scale = round(lr_schedule_scale("linear", last, cfg["num_rounds"], min_factor=0.2), 6)
    train = summary["final_train_metrics"]
    print(f"[{card}] (j) run_experiment(lr_schedule='linear'): round_durations_s="
          f"{summary['round_durations_s']} lr_scale={train.get('lr_scale')} (schedule "
          f"{want_scale}) loss={train.get('loss')}")
    if summary["rounds_completed"] != cfg["num_rounds"] or train.get("lr_scale") != want_scale:
        fail(f"(j) run_experiment: {summary['rounds_completed']} rounds, lr_scale "
             f"{train.get('lr_scale')} (schedule {want_scale})")
    return totals


def phase_network_resume(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(k): the plain network round of (h) resumed from a ``FileStateStore``: 3 rounds
    uninterrupted, then 2 rounds with a store, and a new server and coordinator for 3
    rounds resuming from it.  Returns the launch counts."""
    import logging

    import numpy as np

    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.persistence import FileStateStore
    from nanofed_tpu_torch.security import secure_agg as sa
    from nanofed_tpu_torch.trainer import TrainingConfig, make_local_fit
    from nanofed_tpu_torch.utils.logger import LogConfig, Logger
    from nanofed_tpu_torch.utils.trees import flatten_with_names, ravel

    Logger().configure(LogConfig(level=logging.WARNING))
    n = SECURE_CLIENTS
    model = get_model("mnist_cnn")
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    host = federate(load_mnist("train", None, synthetic_size=n * SECURE_SAMPLES),
                    num_clients=n, batch_size=64, seed=0)
    data = [host.select(slice(c, c + 1)).to(torch.device("cuda")) for c in range(n)]
    local_fit = make_local_fit(model, TrainingConfig(batch_size=64, local_epochs=1,
                                                     learning_rate=0.1))
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)

    def run(name: str, rounds: int, store=None):
        fetched: dict = {}

        async def main():
            port = comm.free_port()
            server = comm.HTTPServer(port=port)
            await server.start()
            try:
                coordinator = comm.NetworkCoordinator(
                    server, init, comm.NetworkRoundConfig(num_rounds=rounds, min_clients=n,
                                                          round_timeout_s=120.0),
                    device="cuda", state_store=store)
                url = f"http://127.0.0.1:{port}"
                clients = [network_client(torch, comm, sa, url, f"client_{c}", c, local_fit,
                                          data[c], None, init, {}, fetched, {})
                           for c in range(n)]
                await asyncio.wait_for(asyncio.gather(coordinator.run(), *clients), 300)
                return coordinator
            finally:
                await server.stop()

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        coordinator = asyncio.run(main())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = ops.launch_counts()
        ran = [h["round"] for h in coordinator.history]
        print(f"[{card}] (k) {name}: start_round={coordinator.start_round} rounds={ran} "
              f"round_durations_s={coordinator.ledger.durations_s} wall_s={wall:.3f} "
              f"launches={grew}")
        if [h["status"] for h in coordinator.history] != ["COMPLETED"] * len(ran):
            fail(f"(k) {name}: rounds {coordinator.history}")
        want = dict.fromkeys(grew, 0)
        want["weighted_mean_flat"] = len(ran)  # B1 normalised over [8, P], one a round
        if grew != want:
            fail(f"(k) {name}: kernel launches {grew}, expected {want}")
        add_launches(totals, grew)
        return coordinator, fetched

    # The simulated clients train with cuDNN's deterministic algorithms: its default
    # float32 convolution backward gave two runs of the same rounds 3e-5 to 3e-4 apart
    # on the card, which would hide what the resume changes.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full, full_fetched = run("uninterrupted", 3)
        store = FileStateStore(out_dir / "k_network_ckpt")
        first, _ = run("2 rounds with a store", 2, store)
        checkpoint = store.restore_latest()
        resumed, fetched = run("resumed by a new server and coordinator", 3, store)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # The store run repeats the uninterrupted run's rounds 0-1: the card's run-to-run gap.
    run_gap = float((ravel(first.params).cpu() - ravel(full_fetched[2])).abs().max())
    saved = torch.from_numpy(np.concatenate(
        [a.ravel() for a in flatten_with_names(checkpoint.params).values()]))
    if resumed.start_round != 2 or list(fetched) != [2] or not (
            torch.equal(ravel(fetched[2]), saved)
            and torch.equal(saved, ravel(first.params).cpu())):
        fail(f"(k) the resumed coordinator started at {resumed.start_round} (rounds "
             f"fetched {list(fetched)}), not publishing the round-1 checkpoint bit for bit")
    gap = float((ravel(resumed.params) - ravel(full.params)).abs().max())
    print(f"[{card}] (k) resumed at round 2, published the checkpoint bit for bit; "
          f"run-to-run gap after 2 rounds {run_gap:.3e}; final max|resumed - "
          f"uninterrupted|={gap:.3e} (tolerance {RESUME_TOL})")
    if not (torch.isfinite(ravel(resumed.params)).all() and gap <= RESUME_TOL
            and gap <= run_gap + 1e-6):
        fail(f"(k) the resumed network run differs from the uninterrupted one by {gap} "
             f"(run-to-run {run_gap})")
    return totals


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
        torch.cuda.reset_peak_memory_stats()
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
              f"eval_accuracy={ev['accuracy']} launches={grew} "
              f"peak_memory_bytes={torch.cuda.max_memory_allocated()}")
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


DP_CHUNK = 25  # (l): a chunk's per-example gradients are 25 x 64 x P floats, 7.7 GB
DP_PRIVACY = dict(noise_multiplier=1.1, max_gradient_norm=1.0)  # (l)
DP_STABLE_CLIENTS = 100  # (l): the cohort whose round must not depend on client_chunk
DP_STABLE_CHUNKS = (25, 50)
DP_STABLE_TOL = 1e-5
SCAFFOLD_ROUNDS = 3  # (m)
SCAFFOLD_CHUNK = 25
SCAFFOLD_FEDAVG_TOL = 1e-5  # (m): round 1 from zero controls against plain FedAvg
SCAFFOLD_CONTROL_RTOL = 1e-6  # (m): c_global against its plain recomputation
SCAFFOLD_RESUME_CLIENTS = 100  # (m): the resumed population, a 0.5 GB control stack
TUTORIAL_SAMPLES = 16_000  # (n): the tutorial's two clients, 12k + 4k samples


def flagship_data(num_clients: int | None = None):
    """The flagship's population on the host: 60 synthetic MNIST samples a client."""
    from nanofed_tpu_torch.data import federate, load_mnist

    num_clients = num_clients or FLAGSHIP["num_clients"]

    return federate(load_mnist("train", None, synthetic_size=60 * num_clients),
                    num_clients=num_clients, batch_size=FLAGSHIP["batch_size"], seed=0)


def flagship_training(**kwargs):
    from nanofed_tpu_torch.trainer import TrainingConfig

    cfg = FLAGSHIP
    return TrainingConfig(batch_size=cfg["batch_size"], local_epochs=cfg["local_epochs"],
                          learning_rate=cfg["learning_rate"],
                          compute_dtype=cfg["compute_dtype"], **kwargs)


def counted(torch, ops, card: str, tag: str, run, want: dict):
    """Run ``run()`` with the launch counts zeroed just before and read just after;
    fail unless they equal ``want``.  Returns ``(result, wall_s, counts)``."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = ops.launch_counts()
    want = {k: want.get(k, 0) for k in grew}
    print(f"[{card}] {tag}: wall_s={wall:.3f} launches={grew}")
    if grew != want:
        fail(f"{tag}: kernel launches {grew}, expected {want}")
    return out, wall, grew


def phase_dp(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(l): DP-SGD clients at the flagship's shape through ``Coordinator(local_fit=
    make_private_local_fit(...))``, ``client_chunk=25``, 2 rounds, with each client's
    accountant; then per-example clipping, the noise and client stability on the card.
    Returns the coordinator run's launch counts."""
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.privacy import PrivacyConfig, RDPAccountant
    from nanofed_tpu_torch.trainer import (
        client_keys,
        draw_permutations,
        get_privacy_spent,
        local_fit_noise_events,
        make_private_local_fit,
        record_local_fit,
    )
    from nanofed_tpu_torch.trainer.private import (
        clip_coefficients,
        counter_noise,
        per_example_grads,
    )
    from nanofed_tpu_torch.utils.trees import ravel, tree_size

    n, rounds = FLAGSHIP["num_clients"], FLAGSHIP["num_rounds"]
    model = get_model("mnist_cnn")
    host = flagship_data()
    training = flagship_training()
    privacy = PrivacyConfig(**DP_PRIVACY)
    fit = make_private_local_fit(model, training, privacy)
    coord = Coordinator(model, host, CoordinatorConfig(num_rounds=rounds, seed=0,
                                                       base_dir=out_dir / "l_dp"),
                        training, client_chunk=DP_CHUNK, device="cuda", local_fit=fit)
    torch.cuda.reset_peak_memory_stats()
    chunks = n // DP_CHUNK
    metrics, wall, counts = counted(
        torch, ops, card, "(l) DP-SGD flagship", coord.run,
        {"weighted_sum_into": chunks * rounds, "row_sq_norms": chunks * rounds})
    peak = torch.cuda.max_memory_allocated()
    if [m.status for m in metrics] != [RoundStatus.COMPLETED] * rounds:
        fail(f"(l): rounds {[m.status for m in metrics]}")
    params = coord.params
    if not all(torch.isfinite(p).all() for p in params.values()):
        fail("(l): non-finite params")
    # Each client holds its own accountant: q = batch / its samples, steps x epochs events.
    capacity = host.y.shape[1]
    samples = host.mask.sum(1)
    accountants = [RDPAccountant() for _ in range(n)]
    for _ in metrics:
        for c in range(n):
            record_local_fit(accountants[c], privacy, training, capacity, int(samples[c]))
    eps = [get_privacy_spent(a, privacy).epsilon_spent for a in accountants]
    print(f"[{card}] (l) round_durations_s={[m.duration_s for m in metrics]} "
          f"loss={[m.agg_metrics['loss'] for m in metrics]} peak_memory_bytes={peak} "
          f"({peak / 2**30:.3f} GiB); each client: {rounds} fits of "
          f"{local_fit_noise_events(training, capacity)} noise events at q="
          f"{min(1.0, training.batch_size / float(samples[0]))}, epsilon={max(eps)} at "
          f"delta={privacy.delta} (sigma={privacy.noise_multiplier}, C="
          f"{privacy.max_gradient_norm})")
    if not all(math.isfinite(e) and e > 0 for e in eps):
        fail(f"(l): epsilon {max(eps)}")

    # Per-example clipping on the card: the clipped norms, recomputed in plain torch.
    data = host.select(slice(0, 1)).to(torch.device("cuda"))
    xb, yb, mb = data.x[0], data.y[0], data.mask[0]
    grads, _, _ = per_example_grads(model.apply, training.compute_dtype)(params, xb, yb, ())
    coef = clip_coefficients(grads, mb, privacy.max_gradient_norm)
    rows = torch.cat([g.reshape(g.shape[0], -1) for g in grads.values()], 1)
    clipped_norms = (coef[:, None] * rows).norm(dim=1)
    raw_norms = rows.norm(dim=1)
    bound = privacy.max_gradient_norm * (1 + 1e-5)
    print(f"[{card}] (l) one client's batch: raw per-example norms {float(raw_norms.min()):.4f}"
          f"-{float(raw_norms.max()):.4f}, clipped max {float(clipped_norms.max()):.7f} "
          f"(bound {bound}), padded rows {int((mb == 0).sum())} with coefficient 0")
    if float(clipped_norms.max()) > bound or bool((coef[mb == 0] != 0).any()):
        fail("(l): a clipped per-example gradient exceeds C, or padding is not zeroed")
    # The per-example gradients against a plain loop of one-example backward passes (f32).
    f32_grads, _, _ = per_example_grads(model.apply)(params, xb[:4], yb[:4], ())
    worst = 0.0
    for i in range(4):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        logp = model.apply(leaves, xb[i:i + 1])
        torch.autograd.backward(-logp[0, yb[i]])
        for k, leaf in leaves.items():
            worst = max(worst, float((f32_grads[k][i] - leaf.grad).abs().max()
                                     / leaf.grad.abs().max().clamp(min=1e-12)))
    print(f"[{card}] (l) per-example gradients (vmap) against one-example backward passes: "
          f"max relative error {worst:.3e} (tolerance 1e-4)")
    if worst > 1e-4:
        fail("(l): per-example gradients disagree with one-example backward passes")
    # One noise draw at full width.
    p = tree_size(params)
    std = privacy.noise_multiplier * privacy.max_gradient_norm
    draw = counter_noise(torch.tensor(12345, dtype=torch.int32, device="cuda"), p) * std
    mean, sd = float(draw.double().mean()), float(draw.double().std())
    print(f"[{card}] (l) one noise draw, P={p}: mean {mean:.3e} (|.| <= {0.01 * std:.3e}), "
          f"std {sd:.6f} (sigma*C = {std}, within 1%)")
    if abs(mean) > 0.01 * std or abs(sd / std - 1) > 0.01:
        fail("(l): the noise draw is off its distribution")
    # Client stability: a 100-client cohort round in chunks of 25 and of 50.
    cohort = host.select(slice(0, DP_STABLE_CLIENTS)).to(torch.device("cuda"))
    perms = draw_permutations(torch.Generator(device="cuda").manual_seed(3), DP_STABLE_CLIENTS,
                              training.local_epochs, capacity)
    keys = client_keys(3, DP_STABLE_CLIENTS, "cuda")
    start = {k: v.clone() for k, v in params.items()}
    out = {}
    for chunk in DP_STABLE_CHUNKS:
        step = build_round_step(model, training, fedavg_strategy(), client_chunk=chunk,
                                local_fit=fit)
        result, _, _ = counted(
            torch, ops, card, f"(l) 100-client DP round, client_chunk={chunk}",
            lambda: step(start, init_server_state(fedavg_strategy(), start), cohort,
                         cohort.mask.sum(1), perms, keys),
            {"weighted_sum_into": DP_STABLE_CLIENTS // chunk,
             "row_sq_norms": DP_STABLE_CLIENTS // chunk})
        out[chunk] = ravel(result.params)
    profile_fit(torch, card, model, training, fit, start, cohort, perms, keys)
    gap = float((out[DP_STABLE_CHUNKS[0]] - out[DP_STABLE_CHUNKS[1]]).abs().max())
    print(f"[{card}] (l) client_chunk {DP_STABLE_CHUNKS[0]} vs {DP_STABLE_CHUNKS[1]}: "
          f"max|dparams|={gap:.3e} "
          f"(tolerance {DP_STABLE_TOL})")
    if gap > DP_STABLE_TOL:
        fail("(l): the DP round depends on client_chunk")
    del coord, grads, rows, f32_grads
    return counts


def profile_fit(torch, card: str, model, training, dp_fit, params, cohort, perms, keys):
    """(l): where a DP-SGD fit's time goes: one ``DP_CHUNK``-client fit (2 steps) timed
    against the plain fit (mean of 5 after a warm-up), and the DP fit's device time by
    kernel from ``torch.profiler`` (the largest four, as shares of the kernels' total)."""
    from nanofed_tpu_torch.trainer import make_local_fit

    sl = slice(0, DP_CHUNK)
    args = (params, cohort.select(sl), perms[sl], keys[sl])
    times = {}
    for name, fit in (("DP-SGD", dp_fit), ("plain", make_local_fit(model, training))):
        fit(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fit(*args)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        dp_fit(*args)
        torch.cuda.synchronize()
    kernels = [(e.key, getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(t for _, t in kernels)
    top = sorted(kernels, key=lambda kt: -kt[1])[:4]
    shares = "; ".join(f"{k[:60]} {t / total:.1%}" for k, t in top) if total else "no device time"
    print(f"[{card}] (l) one {DP_CHUNK}-client fit of 2 steps: DP-SGD {times['DP-SGD']:.3f} ms, "
          f"plain {times['plain']:.3f} ms; DP-SGD device time {total / 1e3:.3f} ms by kernel: "
          f"{shares}")


def scaffold_launches(rounds: int) -> dict[str, int]:
    """A SCAFFOLD round launches B1 normalised (the uniform mean of delta y), B1's
    accumulate form (the participants' dc sum) and B3 (the update norms) once each."""
    return {"weighted_mean_flat": rounds, "weighted_sum_into": rounds, "row_sq_norms": rounds}


def phase_scaffold(torch, ops, run_experiment, card: str, out_dir: Path):
    """(m): SCAFFOLD at the flagship's shape, 10% cohorts in 25-client chunks:
    ``run_experiment(scaffold=True)`` for 3 rounds; a ``Coordinator(scaffold=True)``
    checked round by round (round 1 against plain FedAvg, ``c_global`` against its
    recomputation, non-participants' control rows untouched); then a 100-client
    population resumed from a checkpoint.  Returns the launch counts, the checked
    coordinator's params and its population on the card."""
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.persistence import FileStateStore

    n, rounds, part = FLAGSHIP["num_clients"], SCAFFOLD_ROUNDS, 0.1
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    summary, _, grew = counted(
        torch, ops, card, "(m) run_experiment(scaffold=True)",
        lambda: run_experiment(model="mnist_cnn", device="cuda", seed=0, out_dir=out_dir / "m",
                               participation=part, client_chunk=SCAFFOLD_CHUNK, scaffold=True,
                               **dict(FLAGSHIP, num_rounds=rounds)),
        scaffold_launches(rounds))
    add_launches(totals, grew)
    train = summary["final_train_metrics"]
    print(f"[{card}] (m) round_durations_s={summary['round_durations_s']} "
          f"loss={train.get('loss')} participating_clients={train.get('participating_clients')} "
          f"eval_accuracy={summary['final_eval_metrics']['accuracy']}")
    if summary["rounds_completed"] != rounds or not math.isfinite(train["loss"]):
        fail(f"(m) run_experiment: {summary['rounds_completed']} rounds, loss {train.get('loss')}")

    model = get_model("mnist_cnn")
    host = flagship_data()
    training = flagship_training()

    def make(name: str, data=host, num_rounds=rounds, scaffold=True, **kwargs):
        return Coordinator(model, data, CoordinatorConfig(
            num_rounds=num_rounds, participation_rate=part, seed=0, base_dir=out_dir / name,
            save_metrics=False), training, client_chunk=SCAFFOLD_CHUNK, device="cuda",
            scaffold=scaffold, **kwargs)

    plain = make("m_fedavg", num_rounds=1, scaffold=False)
    _, _, grew = counted(torch, ops, card, "(m) plain FedAvg round", plain.run,
                         step_launches(SCAFFOLD_CHUNK, plain.cohort_size))
    add_launches(totals, grew)
    coord = make("m_checked")
    gen = coord.start_training()
    for r in range(rounds):
        c_prev, stack_prev = coord.c_global.clone(), coord.c_stack.clone()
        cohort = torch.as_tensor(coord._sample_cohort(r), device="cuda")
        metrics, _, grew = counted(torch, ops, card, f"(m) checked round {r}",
                                   lambda: next(gen), scaffold_launches(1))
        add_launches(totals, grew)
        if metrics.status != RoundStatus.COMPLETED:
            fail(f"(m) checked round {r}: {metrics.status}")
        moved = (coord.c_stack[cohort].double() - stack_prev[cohort].double()).sum(0)
        want = c_prev.double() + moved / n
        rel = float((coord.c_global.double() - want).abs().max()
                    / want.abs().max().clamp(min=1e-30))
        outside = torch.ones(n, dtype=torch.bool, device="cuda")
        outside[cohort] = False
        untouched = torch.equal(coord.c_stack[outside], stack_prev[outside])
        line = (f"[{card}] (m) round {r}: c_global against c + sum(dc_i)/{n} recomputed in "
                f"float64: max relative error {rel:.3e} (tolerance {SCAFFOLD_CONTROL_RTOL}); "
                f"{int(outside.sum())} non-participant rows unchanged bit for bit: {untouched}")
        if r == 0:
            gap = float((torch.cat([p.reshape(-1) for p in coord.params.values()])
                         - torch.cat([p.reshape(-1) for p in plain.params.values()])).abs().max())
            line += f"; round 1 against plain FedAvg max|dparams|={gap:.3e}"
            if gap > SCAFFOLD_FEDAVG_TOL:
                fail(f"(m) round 1 from zero controls differs from FedAvg by {gap}")
        print(line)
        if rel > SCAFFOLD_CONTROL_RTOL or not untouched:
            fail(f"(m) round {r}: server control off by {rel} or a non-participant moved")
        del stack_prev
    gen.close()
    final_params = coord.params
    del coord, plain

    # Resume: a 100-client population, 4 rounds, closed after 2 and resumed.
    small = flagship_data(SCAFFOLD_RESUME_CLIENTS)
    resume_rounds = RESUME_ROUNDS

    def state(c):
        return torch.cat([torch.cat([p.reshape(-1) for p in c.params.values()]),
                          c.c_global]), c.c_stack

    runs = {}
    for name in ("uninterrupted", "again"):
        c = make(f"m_{name}", data=small, num_rounds=resume_rounds)
        _, _, grew = counted(torch, ops, card, f"(m) population 100, {name}", c.run,
                             scaffold_launches(resume_rounds))
        add_launches(totals, grew)
        runs[name] = state(c)
    store = FileStateStore(out_dir / "m_ckpt")
    ckpt_s: list[float] = []
    timed_method(store, "checkpoint", ckpt_s)
    first = make("m_first", data=small, num_rounds=resume_rounds, state_store=store)

    def two_rounds():
        gen = first.start_training()
        out = [next(gen), next(gen)]
        gen.close()
        return out

    _, _, grew = counted(torch, ops, card, "(m) population 100, closed after 2 rounds",
                         two_rounds, scaffold_launches(2))
    add_launches(totals, grew)
    ckpt_bytes = max(f.stat().st_size for f in (out_dir / "m_ckpt").rglob("state.pkl"))
    resumed = make("m_resumed", data=small, num_rounds=resume_rounds, state_store=store)
    if resumed.current_round != 2:
        fail(f"(m) resumed at round {resumed.current_round}, expected 2")
    _, _, grew = counted(torch, ops, card, "(m) population 100, resumed", resumed.run,
                         scaffold_launches(resume_rounds - 2))
    add_launches(totals, grew)
    full, again = runs["uninterrupted"], runs["again"]
    run_gap = max(float((a - b).abs().max()) for a, b in zip(full, again))
    got = state(resumed)
    gap = max(float((a - b).abs().max()) for a, b in zip(full, got))
    print(f"[{card}] (m) resume: checkpoint_s={[round(s, 6) for s in ckpt_s]} "
          f"(state.pkl of {ckpt_bytes} bytes with the control stack); run-to-run gap "
          f"{run_gap:.3e}; resumed max|d(params, c_global, c_stack)|={gap:.3e} (tolerance "
          f"{RESUME_TOL}, and at most the run-to-run gap + 1e-6)")
    if not (gap <= RESUME_TOL and gap <= run_gap + 1e-6):
        fail(f"(m) the resumed SCAFFOLD run differs by {gap} (run-to-run {run_gap})")
    return totals, final_params, host


def phase_trainer(torch, ops, card: str, out_dir: Path, global_params, population) -> None:
    """(n): ``Trainer.fit`` with a ``MetricsLogger`` on the tutorial client against
    ``make_local_fit`` run directly, bit for bit; then the personalized evaluator over
    (m)'s model on its 1000-client population split 80/20."""
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.trainer import (
        MetricsLogger,
        Trainer,
        TrainingConfig,
        client_keys,
        draw_permutations,
        make_local_fit,
        make_personalized_evaluator,
        split_client_data,
    )

    model = get_model("mnist_cnn")
    host = federate(load_mnist("train", None, synthetic_size=TUTORIAL_SAMPLES), num_clients=2,
                    batch_size=64, seed=0, proportions=[0.75, 0.25])
    client = ClientData(host.x[0], host.y[0], host.mask[0]).to(torch.device("cuda"))
    training = TrainingConfig(batch_size=64, local_epochs=2, learning_rate=0.1)
    params = model.init(torch.Generator().manual_seed(0))
    params = {k: v.cuda() for k, v in params.items()}
    perms = draw_permutations(torch.Generator(device="cuda").manual_seed(1), 1, 2,
                              client.y.shape[0])
    log_path = out_dir / "n_trainer_metrics.json"
    trainer = Trainer(model, training, callbacks=[MetricsLogger(log_path, "tutorial_0")],
                      device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same bits from two calls
    try:
        (tuned, final), fit_s, _ = counted(torch, ops, card, "(n) Trainer.fit",
                                           lambda: trainer.fit(params, client, perms=perms[0]),
                                           {})
        direct, direct_s, _ = counted(
            torch, ops, card, "(n) make_local_fit directly",
            lambda: make_local_fit(model, training)(
                params, ClientData(client.x[None], client.y[None], client.mask[None]), perms,
                client_keys(0, 1, "cuda")), {})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(tuned[k], direct.params[k][0]) for k in params)
    logged = json.loads(log_path.read_text())
    print(f"[{card}] (n) Trainer.fit on {int(client.mask.sum())} samples, 2 epochs: "
          f"fit_s={fit_s:.3f} (make_local_fit directly {direct_s:.3f}), loss={final['loss']:.6f} "
          f"accuracy={final['accuracy']:.6f}; params equal bit for bit: {same}; the "
          f"MetricsLogger wrote {len(logged['epochs'])} epochs and {len(logged['batches'])} "
          "batches")
    if not same:
        fail("(n) Trainer.fit differs from make_local_fit run directly")
    if len(logged["epochs"]) != 2 or len(logged["batches"]) != 2 * perms.shape[-1] // 64:
        fail(f"(n) the MetricsLogger wrote {len(logged['epochs'])} epochs")

    train, test = split_client_data(population.to(torch.device("cuda")), 0.2, seed=0)
    evaluate = make_personalized_evaluator(model, flagship_training())
    out, eval_s, _ = counted(torch, ops, card, "(n) personalized evaluator, 1000 clients",
                             lambda: evaluate(global_params, train, test, seed=0), {})
    g, p = float(out["global_accuracy"]), float(out["personal_accuracy"])
    print(f"[{card}] (n) personalized evaluation over (m)'s model: global_accuracy={g:.6f} "
          f"personal_accuracy={p:.6f} gain={float(out['personalization_gain']):.6f} over "
          f"{int(out['test_counts'].sum())} test samples, evaluate_s={eval_s:.3f}")
    if not (0.0 <= g <= 1.0 and 0.0 <= p <= 1.0):
        fail("(n) personalized accuracies outside [0, 1]")


FUSED_RPB = 4  # (s): rounds per block
FUSED_ROUNDS = 8  # (s1), (s3): two blocks of the flagship
FUSED_COHORT_ROUNDS = 4  # (s2): one block
FUSED_MEMORY_RTOL = 0.01  # (s1): a fused run's peak device memory against a single one's


def block_timer(torch, coord, spent: list[float], around=None) -> None:
    """Wrap ``coord``'s block: record each call's seconds from its dispatch to the
    device's end, and run the ``i``-th call inside ``around[i](call)`` when given."""
    block = coord._round_block

    def timed(*args, **kwargs):
        call = lambda: block(*args, **kwargs)  # noqa: E731
        wrap = (around or {}).get(len(spent))
        t0 = time.perf_counter()
        out = wrap(call) if wrap is not None else call()
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    coord._round_block = timed


def sync_warnings(torch, call) -> tuple[object, list[str]]:
    """``call()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result and the
    warnings of the synchronizing operations it ran (not the mode's own notice that
    it is a prototype)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


def device_profile(torch, call) -> tuple[object, float, float, list[tuple[str, float]]]:
    """``call()`` under ``torch.profiler`` (device activity only: recording the host's
    ops as well costs more than the block): its result, the wall seconds from the call
    to the device's end, the device's busy time in ms (the union of its kernels',
    copies' and fills' intervals, so nothing is counted twice) and every kernel name
    with its summed device time, largest first."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if (not str(getattr(e, "device_type", "")).endswith("CUDA")
                or getattr(e, "is_user_annotation", False)):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return out, wall, busy_us / 1e3, sorted(by_name.items(), key=lambda kt: -kt[1])


def phase_fused(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(s): fused multi-round blocks.  (s1) the flagship at ``rounds_per_block=4`` (two
    blocks) and at 1, 8 rounds each, a second fused run for the run-to-run gap; (s2) a
    validated 10% cohort with dropout as one block against single rounds, and a block
    resampling its cohorts on the device through ``build_round_block``; (s3) the
    synchronizing operations inside a block's dispatch (``set_sync_debug_mode``) and
    the device's busy share of one block (``torch.profiler``), both in the second
    fused run.  Returns the launch counts."""
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import (
        Coordinator,
        CoordinatorConfig,
        RoundStatus,
        cohort_size,
    )
    from nanofed_tpu_torch.parallel import build_round_block, init_server_state, round_seeds
    from nanofed_tpu_torch.security.validation import ValidationConfig
    from nanofed_tpu_torch.utils.trees import ravel

    t_phase = time.perf_counter()
    n, chunk, rpb = FLAGSHIP["num_clients"], 125, FUSED_RPB
    model, data, training = get_model("mnist_cnn"), flagship_data(), flagship_training()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "s_fused"
    gc.collect()  # earlier phases' coordinators sit in cycles with their catalogs

    def make(name: str, rounds_per_block: int, num_rounds: int = FUSED_ROUNDS, **kw):
        guards = {k: kw.pop(k) for k in ("validation", "client_chunk") if k in kw}
        return Coordinator(
            model, data, CoordinatorConfig(num_rounds=num_rounds, seed=0,
                                           base_dir=base / name,
                                           rounds_per_block=rounds_per_block, **kw),
            training, **{"client_chunk": chunk, **guards}, device="cuda")

    def drive(tag: str, coord, want: dict):
        """Run ``coord``; return its rounds, wall seconds and peak device memory above
        what was allocated when it started (its working memory: the population and
        anything earlier phases left behind are not the run's)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        rounds, wall, grew = counted(torch, ops, card, tag, coord.run, want)
        add_launches(totals, grew)
        if [m.status for m in rounds] != [RoundStatus.COMPLETED] * len(rounds):
            fail(f"{tag}: rounds {[m.status for m in rounds]}")
        return rounds, wall, torch.cuda.max_memory_allocated() - start

    # (s1) single rounds, then fused, then fused again instrumented (s3).
    want = {}
    add_launches(want, step_launches(chunk, n), FUSED_ROUNDS)
    # One coordinator on the card at a time, so the peaks compare.
    single = make("single", 1)
    s_rounds, s_wall, s_peak = drive("(s1) single rounds", single, want)
    s_params = ravel(single.params)
    del single
    gc.collect()  # a coordinator sits in a cycle with its program catalog
    fused = make("fused", rpb)
    f_blocks: list[float] = []
    block_timer(torch, fused, f_blocks)
    f_rounds, f_wall, f_peak = drive("(s1) fused", fused, want)
    if len(f_blocks) != FUSED_ROUNDS // rpb:
        fail(f"(s1) fused: {len(f_blocks)} blocks ran, expected {FUSED_ROUNDS // rpb}")
    f_params = ravel(fused.params)
    del fused
    gc.collect()
    again = make("fused_again", rpb)
    caught: dict[str, object] = {}

    def with_sync_check(call):
        out, caught["sync"] = sync_warnings(torch, call)
        return out

    def with_profile(call):
        out, caught["wall"], caught["busy"], caught["top"] = device_profile(torch, call)
        return out

    a_blocks: list[float] = []
    block_timer(torch, again, a_blocks, around={0: with_sync_check, 1: with_profile})
    drive("(s1) fused again, (s3) instrumented", again, want)

    gap = float((f_params - ravel(again.params)).abs().max())
    diff = float((f_params - s_params).abs().max())
    metric_gap = max(abs(f.agg_metrics[k] - s.agg_metrics[k])
                     for f, s in zip(f_rounds, s_rounds) for k in s.agg_metrics)
    s_per = [m.duration_s for m in s_rounds]
    f_per = [m.duration_s for m in f_rounds]
    print(f"[{card}] (s1) flagship, {FUSED_ROUNDS} rounds: single round_s={s_per} "
          f"(median {statistics.median(s_per):.6f}, wall_s={s_wall:.3f}); fused "
          f"rounds_per_block={rpb} round_s={f_per} (median {statistics.median(f_per):.6f}, "
          f"wall_s={f_wall:.3f}, blocks dispatch-to-device-end s={f_blocks}); fused/single "
          f"median={statistics.median(f_per) / statistics.median(s_per):.4f}")
    print(f"[{card}] (s1) max|dparams| fused vs single={diff:.3e}, fused run-to-run gap="
          f"{gap:.3e} (tolerance {CROSS_TOL} and the gap + 1e-6); max|dmetric| per round="
          f"{metric_gap:.3e}; peak device memory above each run's start single={s_peak} "
          f"fused={f_peak} "
          f"(fused/single {f_peak / s_peak:.6f})")
    if not (torch.isfinite(f_params).all() and diff <= CROSS_TOL
            and diff <= gap + 1e-6):
        fail(f"(s1) fused params differ from single rounds by {diff} (gap {gap})")
    for f, s in zip(f_rounds, s_rounds):
        counts = ("participating_clients", "samples")
        if (f.agg_metrics.keys() != s.agg_metrics.keys()
                or any(f.agg_metrics[k] != s.agg_metrics[k] for k in counts)
                or metric_gap > CROSS_TOL):
            fail(f"(s1) round {f.round_id}: fused {f.agg_metrics} vs single {s.agg_metrics}")
    if abs(f_peak / s_peak - 1.0) > FUSED_MEMORY_RTOL:
        fail(f"(s1) fused peak memory {f_peak} vs single {s_peak}")

    # (s3) from the instrumented run: its first block under the sync check, its
    # second under the profiler.
    syncs = caught["sync"]
    busy_ms, prof_wall = caught["busy"], caught["wall"]
    top = "; ".join(f"{k[:70]} {t:.3f} ms ({t / busy_ms:.1%})" for k, t in caught["top"][:4])
    print(f"[{card}] (s3) synchronizing operations inside a fused flagship block's dispatch: "
          f"{len(syncs)}{' ' + repr(syncs[:3]) if syncs else ''}")
    print(f"[{card}] (s3) the instrumented run's blocks, dispatch to device end: "
          f"sync-checked {a_blocks[0]:.3f} s, profiled {a_blocks[1]:.3f} s")
    print(f"[{card}] (s3) one profiled fused block ({rpb} rounds): device time "
          f"{busy_ms:.3f} ms of {prof_wall * 1e3:.3f} ms wall under the profiler (busy share "
          f"{busy_ms / (prof_wall * 1e3):.4f}); of the unprofiled second block's "
          f"{f_blocks[1] * 1e3:.3f} ms: {busy_ms / (f_blocks[1] * 1e3):.4f}; top four by "
          f"device time: {top}")
    if syncs:
        fail(f"(s3) {len(syncs)} synchronizing operations inside a host-sampled FedAvg block")
    if not busy_ms > 0:
        fail("(s3) the profiler saw no device time in the block")
    del again
    gc.collect()

    # (s2) a validated 10% cohort with dropout: one block against single rounds (B2 once
    # a round), then on-device resampling through the builder.
    cohort = cohort_size(n, 0.1)
    kw = dict(num_rounds=FUSED_COHORT_ROUNDS, participation_rate=0.1, dropout_rate=0.1,
              validation=ValidationConfig())
    want = {"masked_weighted_mean_flat": FUSED_COHORT_ROUNDS}
    c_single = make("cohort_single", 1, **kw)
    cs_rounds, _, _ = drive("(s2) validated cohort, single rounds", c_single, want)
    c_fused = make("cohort_fused", FUSED_COHORT_ROUNDS, **kw)
    cf_rounds, cf_wall, _ = drive("(s2) validated cohort, one block", c_fused, want)
    c_diff = float((ravel(c_fused.params) - ravel(c_single.params)).abs().max())
    print(f"[{card}] (s2) validated {cohort}-client cohorts, dropout 0.1: survivors "
          f"{[m.num_clients for m in cf_rounds]}, valid "
          f"{[m.agg_metrics['valid_clients'] for m in cf_rounds]}, fused round_s="
          f"{[m.duration_s for m in cf_rounds]}, single round_s="
          f"{[m.duration_s for m in cs_rounds]}; max|dparams|={c_diff:.3e}")
    if c_diff > CROSS_TOL or any(
            f.num_clients != s.num_clients or f.agg_metrics.keys() != s.agg_metrics.keys()
            or any(abs(f.agg_metrics[k] - s.agg_metrics[k]) > CROSS_TOL for k in s.agg_metrics)
            for f, s in zip(cf_rounds, cs_rounds)):
        fail(f"(s2) the fused cohort block differs from single rounds by {c_diff}")
    del c_single, c_fused
    gc.collect()

    block = build_round_block(model, training, fedavg_strategy(), num_clients=n,
                              step_clients=cohort, cohort_size=cohort, dropout_rate=0.1,
                              device="cuda")
    params = {k: v.cuda() for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    dev_data = data.to(torch.device("cuda"))
    want = {"weighted_mean_flat": FUSED_COHORT_ROUNDS, "row_sq_norms": FUSED_COHORT_ROUNDS}
    res, wall, grew = counted(
        torch, ops, card, "(s2) on-device resampling block",
        lambda: block(params, init_server_state(fedavg_strategy(), params), dev_data,
                      dev_data.mask.sum(1), round_seeds(0, range(FUSED_COHORT_ROUNDS)),
                      [1.0] * FUSED_COHORT_ROUNDS), want)
    add_launches(totals, grew)
    ids = res.cohort_ids.cpu()
    survivors = res.survivors.tolist()
    distinct = [len(set(row[:cohort].tolist())) for row in ids]
    print(f"[{card}] (s2) on-device resampling, {FUSED_COHORT_ROUNDS} rounds: wall_s="
          f"{wall:.3f} survivors={survivors} distinct ids={distinct} "
          f"participating={res.metrics['participating_clients'].tolist()} "
          f"loss={res.metrics['loss'].tolist()}")
    if (distinct != [cohort] * FUSED_COHORT_ROUNDS or not bool((ids >= 0).all())
            or not bool((ids < n).all()) or not all(cohort // 2 <= s <= cohort for s in survivors)
            or res.metrics["participating_clients"].tolist() != survivors
            or not bool(torch.isfinite(res.metrics["loss"]).all())):
        fail("(s2) the on-device cohorts are not valid draws")
    print(f"[{card}] (s) phase wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


CIFAR_TOL = 1e-4  # (t4): cuDNN vs CPU convolutions and GroupNorm summed in another order
CIFAR_BOUNDED_S = 90.0  # (t2): the phase's wall above which the data would be cut
P_RESNET8, P_RESNET18 = 77_850, 11_218_340
# (t5): B1 normalised and B3 at each new shape: (C, P) of fedprox_cifar10's cohort and
# of cross_silo's 8 clients.
CIFAR_REDUCES = ((10, P_RESNET8), (8, P_RESNET18))


def cli_summary(cli, argv: list[str]) -> dict:
    """``cli.main(argv)`` with its stdout captured: the summary JSON it prints."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    if code != 0:
        fail(f"nanofed-tpu-torch {' '.join(argv)}: exit code {code}")
    return json.loads(buf.getvalue())


def check_summary(tag: str, summary: dict, rounds: int) -> None:
    ev = summary["final_eval_metrics"]
    values = [ev["loss"], ev["accuracy"], *summary["round_durations_s"]]
    if summary["rounds_completed"] != rounds or summary["rounds_failed"]:
        fail(f"{tag}: {summary['rounds_completed']}/{rounds} rounds completed")
    if not all(math.isfinite(v) for v in values):
        fail(f"{tag}: non-finite metrics {values}")
    if not summary["params_device"].startswith("cuda"):
        fail(f"{tag}: params ended on {summary['params_device']}, not the card")


def phase_cifar(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(t): the CIFAR ResNets through the package's entry points.  (t1) ``nanofed-tpu-torch
    bench fedprox_cifar10`` (``cli.main``); (t2) ``run_benchmark("cross_silo")`` with
    ResNet-18 at full width, its peak device memory, and one round step profiled
    (counted FLOPs, top kernels); (t3) the same configuration in bf16 through the command
    line, 1 round; (t4) a ResNet-8 round and a narrow ResNet-18's forward and gradient,
    card against CPU; (t5) B1 and B3 timed at the two new shapes.  Returns the main
    paths' launch counts."""
    from nanofed_tpu_torch import cli
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.benchmarks import BENCHMARKS, run_benchmark
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.data import federate, synthetic_classification
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability import profile_program
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
    from nanofed_tpu_torch.utils.trees import tree_size

    t_phase = time.perf_counter()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "t_cifar"
    gc.collect()

    # (t1) FedProx on CIFAR-10 ResNet-8: 100 clients, Dirichlet 0.5, cohorts of 10 (one
    # B1 normalised and one B3 a round over the [10, P] deltas), 3 rounds.
    fedprox = BENCHMARKS["fedprox_cifar10"]
    rounds = fedprox["num_rounds"]
    summary, wall, grew = counted(
        torch, ops, card, "(t1) nanofed-tpu-torch bench fedprox_cifar10",
        lambda: cli_summary(cli, ["bench", "fedprox_cifar10", "--out-dir",
                                  str(base / "fedprox")]),
        {"weighted_mean_flat": rounds, "row_sq_norms": rounds})
    add_launches(totals, grew)
    check_summary("(t1)", summary, rounds)
    ev = summary["final_eval_metrics"]
    print(f"[{card}] (t1) fedprox_cifar10 (resnet8, P={P_RESNET8}, 100 clients, cohort 10, "
          f"50,000 + 10,000 synthetic CIFAR-10): round_durations_s="
          f"{summary['round_durations_s']} rounds_per_sec={summary['rounds_per_sec']} "
          f"eval_loss={ev['loss']} eval_accuracy={ev['accuracy']}")

    # (t2) cross_silo: ResNet-18 on CIFAR-100 at full width, 8 clients, 2 rounds, f32.
    silo = BENCHMARKS["cross_silo"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    summary, wall, grew = counted(
        torch, ops, card, "(t2) run_benchmark cross_silo",
        lambda: run_benchmark("cross_silo", out_dir=str(base / "silo"), device="cuda"),
        {"weighted_mean_flat": silo["num_rounds"], "row_sq_norms": silo["num_rounds"]})
    silo_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start_bytes
    add_launches(totals, grew)
    check_summary("(t2)", summary, silo["num_rounds"])
    durations = summary["round_durations_s"]
    ev = summary["final_eval_metrics"]
    print(f"[{card}] (t2) cross_silo (resnet18, P={P_RESNET18}, 8 clients of 6,250 "
          f"synthetic CIFAR-100 images, 196 steps of batch 32 a round, f32, TF32 off): "
          f"round_durations_s={durations} rounds_per_sec={summary['rounds_per_sec']} "
          f"eval_loss={ev['loss']} eval_accuracy={ev['accuracy']} "
          f"peak_memory_above_start_bytes={peak} wall_s={silo_s:.3f} (train_size: the "
          f"full 50,000, not cut: the run is "
          f"{'inside' if silo_s <= CIFAR_BOUNDED_S else 'OVER'} the phase's "
          f"{CIFAR_BOUNDED_S:.0f} s)")

    # One round step of the same configuration over one batch a client: its counted
    # FLOPs (observability.profiling), then its device time by kernel.
    model = get_model("resnet18")
    training = TrainingConfig(batch_size=silo["batch_size"], local_epochs=1,
                              learning_rate=silo["learning_rate"])
    c = silo["num_clients"]
    host = federate(synthetic_classification(c * training.batch_size, 100, (32, 32, 3),
                                             seed=4), c, batch_size=training.batch_size)
    data = ClientData(*host).to(torch.device("cuda"))
    params = {k: v.cuda() for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    strategy = fedavg_strategy()
    step = build_round_step(model, training, strategy)
    perms = draw_permutations(torch.Generator().manual_seed(1), c, 1, training.batch_size)
    args = (params, init_server_state(strategy, params), data, data.mask.sum(1),
            perms.cuda(), client_keys(0, c, "cuda"))
    report, _, grew = counted(torch, ops, card, "(t2) profile_program, 1-step round step",
                              lambda: profile_program("cross_silo_round_step", step, *args),
                              {"weighted_mean_flat": 5, "row_sq_norms": 5})
    add_launches(totals, grew)
    steps = -(-(50_000 // c) // training.batch_size)
    round_flops = report.flops * steps
    steady = statistics.median(durations[1:] or durations)
    print(f"[{card}] (t2) profiled round step of 1 batch a client: counted_flops="
          f"{report.flops:.6e} measured_s={report.measured_s:.6f} peak_bytes="
          f"{report.peak_bytes}; a round of {steps} steps: {round_flops:.6e} FLOPs, "
          f"achieved {round_flops / steady / 1e12:.3f} TFLOP/s over the steady round "
          f"({steady:.3f} s; f32 peak 67 TFLOP/s outside the tensor cores)")
    _, prof_wall, busy_ms, by_name = device_profile(torch, lambda: step(*args))
    # The per-name sums exceed the busy union where kernels overlap in time.
    print(f"[{card}] (t2) torch.profiler over one 1-step round step: wall_s={prof_wall:.4f} "
          f"device_busy_ms={busy_ms:.3f} kernel_sum_ms={sum(t for _, t in by_name):.3f} "
          f"kernels={len(by_name)} top kernels: "
          + "; ".join(f"{name} {ms:.3f} ms ({ms / busy_ms:.1%})" for name, ms in by_name[:6]))
    del args, data, params, step

    # (t3) the same configuration in bf16 through the command line, 1 round.
    gc.collect()
    summary, wall, grew = counted(
        torch, ops, card, "(t3) nanofed-tpu-torch bench cross_silo --dtype bfloat16",
        lambda: cli_summary(cli, ["bench", "cross_silo", "--dtype", "bfloat16", "--rounds",
                                  "1", "--out-dir", str(base / "silo_bf16")]),
        {"weighted_mean_flat": 1, "row_sq_norms": 1})
    add_launches(totals, grew)
    check_summary("(t3)", summary, 1)
    ev = summary["final_eval_metrics"]
    # Round 0 of both runs: the same clients from the same init, in f32 and in bf16.
    first = {tag: json.loads((base / tag / "metrics" / "metrics_round_0.json").read_text())[
        "agg_metrics"] for tag in ("silo", "silo_bf16")}
    print(f"[{card}] (t3) cross_silo bf16: round_durations_s={summary['round_durations_s']} "
          f"eval_loss={ev['loss']} eval_accuracy={ev['accuracy']}; round 0 train loss / "
          f"accuracy f32 {first['silo']['loss']} / {first['silo']['accuracy']}, bf16 "
          f"{first['silo_bf16']['loss']} / {first['silo_bf16']['accuracy']}")
    if abs(first["silo_bf16"]["loss"] - first["silo"]["loss"]) > 0.1 * first["silo"]["loss"]:
        fail("(t3) the bf16 round's training loss is more than 10% from the f32 round's")

    phase_cifar_cross_check(torch, ops, card)
    time_cifar_reduces(torch, ops, card)
    print(f"[{card}] (t) phase wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


def phase_cifar_cross_check(torch, ops, card: str) -> None:
    """(t4): a ResNet-8 round of 8 clients (f32, 2 epochs of 2 steps) and a narrow
    ResNet-18 (stages 8/16/32/64, 2 blocks each) forward and masked-NLL gradient, from
    the same inputs on the card and on the CPU: the stride-2 SAME convolutions and
    GroupNorm are what it holds."""
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.data import federate, synthetic_classification
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.models.resnet import _resnet
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
    from nanofed_tpu_torch.utils.trees import ravel

    model = get_model("resnet8")
    training = TrainingConfig(batch_size=8, local_epochs=2, learning_rate=0.05, prox_mu=0.01)
    host = federate(synthetic_classification(128, 10, (32, 32, 3), seed=5), 8, batch_size=8)
    params = model.init(torch.Generator().manual_seed(0))
    perms = draw_permutations(torch.Generator().manual_seed(1), 8, 2, host.y.shape[1])
    strategy = fedavg_strategy()
    step = build_round_step(model, training, strategy)
    results = {}
    for dev in ("cuda", "cpu"):
        device = torch.device(dev)
        data = ClientData(*host).to(device)
        p = {k: v.to(device) for k, v in params.items()}
        ops.reset_launch_counts()
        results[dev] = step(p, init_server_state(strategy, p), data, data.mask.sum(1),
                            perms.to(device), client_keys(7, 8, device))
        if dev == "cuda":
            torch.cuda.synchronize()
            grew = ops.launch_counts()
            want = {k: {"weighted_mean_flat": 1, "row_sq_norms": 1}.get(k, 0) for k in grew}
            if grew != want:
                fail(f"(t4) resnet8 round: launches {grew}, expected {want}")
    gp = ravel(results["cuda"].params).cpu()
    diff = float((gp - ravel(results["cpu"].params)).abs().max())
    loss_diff = abs(float(results["cuda"].metrics["loss"]) - float(results["cpu"].metrics["loss"]))
    print(f"[{card}] (t4) resnet8 round, 8 clients f32 cuda vs cpu: max|dparams|={diff:.3e} "
          f"|dloss|={loss_diff:.3e} (tolerance {CIFAR_TOL})")
    if not (torch.isfinite(gp).all() and diff <= CIFAR_TOL and loss_diff <= CIFAR_TOL):
        fail("(t4) the ResNet-8 round on the card disagrees with the CPU")

    narrow = _resnet("resnet18_narrow", (8, 16, 32, 64), 2, 100, stem_channels=8)
    params = narrow.init(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(6, 32, 32, 3, generator=gen)
    y = torch.randint(0, 100, (6,), generator=gen)
    m = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0, 1.0])

    def loss(p, x, y, m):
        logp = narrow.apply(p, x)
        return (-logp.gather(-1, y[:, None])[:, 0] * m).sum() / m.sum(), logp

    outs = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        grads, logp = torch.func.grad(loss, has_aux=True)(p, x.to(dev), y.to(dev), m.to(dev))
        outs[dev] = (logp.cpu(), ravel(grads).cpu())
    fwd = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    grad = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
    print(f"[{card}] (t4) narrow resnet18 (stages 8/16/32/64), batch 6 cuda vs cpu: "
          f"max|dlogp|={fwd:.3e} max|dgrad|={grad:.3e} (tolerance {CIFAR_TOL})")
    if not (fwd <= CIFAR_TOL and grad <= CIFAR_TOL):
        fail("(t4) the narrow ResNet-18 on the card disagrees with the CPU")


def time_cifar_reduces(torch, ops, card: str) -> None:
    """(t5): B1 normalised and B3 at the ResNets' shapes, in the round's layout (rows
    padded to 4 floats), against their plain versions and the library calls."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for c, p in CIFAR_REDUCES:
        x = round_layout(torch, c, p, seed=c + p)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        err = check_close(torch, f"(t5) weighted_mean_flat C={c} P={p}",
                          ops.weighted_mean_flat(x, w), ops.weighted_mean_flat_plain(x, w),
                          **TOL)
        ms = median_ms(lambda: ops.weighted_mean_flat(x, w), torch)
        plain_ms = median_ms(lambda: ops.weighted_mean_flat_plain(x, w), torch)
        library_ms = median_ms(lambda: w @ x, torch)
        b_ms, b_by = bound_ms(4 * c * p + 4 * c + 4 * p, 2 * c * p)
        print(f"[{card}] (t5) weighted_mean_flat C={c} P={p}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} (w @ x) "
              f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
              f"max_abs_err={err:.3e} {plan_line(torch, x, False, False)}")
        err = check_close(torch, f"(t5) row_sq_norms C={c} P={p}", ops.row_sq_norms(x),
                          ops.row_sq_norms_plain(x), **TOL)
        ms = median_ms(lambda: ops.row_sq_norms(x), torch)
        plain_ms = median_ms(lambda: ops.row_sq_norms_plain(x), torch)
        library_ms = median_ms(lambda: torch.linalg.vecdot(x, x), torch)
        b_ms, b_by = bound_ms(4 * c * p + 4 * c, 2 * c * p)
        print(f"[{card}] (t5) row_sq_norms C={c} P={p}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"(torch.linalg.vecdot(x, x)) bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.4f} max_abs_err={err:.3e}")
        del x
        torch.cuda.empty_cache()


OBS_ROUNDS = 4  # (u1): single flagship rounds with telemetry
OBS_FUSED_ROUNDS = 8  # (u1): two blocks at rounds_per_block = FUSED_RPB
OBS_TIMED_ROUNDS = 3  # (u1): timed rounds a coordinator, after its warm round
OCCUPANCY_SLACK = 0.02  # (u1): span occupancy may exceed the profiler's busy share by this
SINGLE_SPANS = [("cohort-sample", 1, "round"), ("cohort-gather", 1, "round"),
                ("local-train", 1, "round"), ("aggregate", 1, "round"), ("round", 0, None),
                ("publish", 0, None)]  # (u1): a single round's spans, in closing order
WIRE_FAMILIES = (  # (u3): the JAX server's and round engine's families
    "nanofed_bytes_received_total", "nanofed_bytes_sent_total", "nanofed_updates_total",
    "nanofed_secagg_evictions_total", "nanofed_http_429_total",
    "nanofed_read_timeouts_total", "nanofed_fleet_bytes_total",
    "nanofed_fleet_updates_total", "nanofed_unknown_tenant_total", "nanofed_rounds_total",
    "nanofed_round_duration_seconds", "nanofed_cohort_size",
    "nanofed_round_critical_path_seconds", "nanofed_span_duration_seconds",
    "nanofed_validation_rejections_total", "nanofed_straggler_evictions_total")


def telemetry_records(run_dir: Path) -> list[dict]:
    lines = (run_dir / "telemetry.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def span_structure(records: list[dict]) -> list[tuple]:
    """(name, depth, parent's name) of every span record, in closing order."""
    names = {r["span_id"]: r["name"] for r in records if r["type"] == "span"}
    return [(r["name"], r["depth"], names.get(r["parent_id"]))
            for r in records if r["type"] == "span"]


def span_occupancy(obs, spans: list[dict]) -> float | None:
    """``update_device_occupancy`` over these span records alone, in a fresh
    registry (the process registry holds every earlier phase's spans too)."""
    reg = obs.MetricsRegistry()
    hist = reg.histogram(obs.SPAN_HISTOGRAM, "Federation-loop phase durations",
                         labels=("span",))
    for r in spans:
        hist.observe(r["duration_s"], span=r["name"])
    return obs.update_device_occupancy(reg)


def sync_checked_span(torch, tracer, name: str, caught: dict) -> None:
    """Run the first span ``name`` that ``tracer`` opens, its whole body, under
    ``torch.cuda.set_sync_debug_mode("warn")``: the warnings of the synchronizing
    operations it ran land in ``caught[name]``."""
    import contextlib
    import warnings

    span = tracer.span

    @contextlib.contextmanager
    def checked(span_name, **attrs):
        if span_name != name or name in caught:
            with span(span_name, **attrs):
                yield
            return
        with span(span_name, **attrs), warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        caught[name] = [str(w.message) for w in seen
                        if "called a synchronizing CUDA operation" in str(w.message)]

    tracer.span = checked


def prom_value(text: str, sample: str) -> float | None:
    """A sample's value in Prometheus text (``name{labels}`` as rendered)."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split()[-1])
    return None


def phase_observability(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(u): observability.  (u1) the flagship with ``telemetry_dir``: 4 single rounds,
    then 8 rounds at ``rounds_per_block=4`` (the first block's dispatch under the
    sync check, the second block under ``torch.profiler``), the spans' names and
    nesting, the ``round`` records, ``summarize_telemetry``, the occupancy gauge on
    both bases, and the round with telemetry off and on, interleaved; (u2) one
    flagship round inside ``utils.profiling.trace``; (u3) (h)'s plain network round with
    the server's ``registry=`` and ``tracer=``, clients' ``registry=`` and the network
    coordinator's ``telemetry_dir=``: ``GET /metrics``, bytes and trace ids; (u4) the
    kernel-build manifest; (u5) ``run --telemetry-dir``, then ``metrics-summary`` and
    ``trace`` on it.  Returns the launch counts."""
    import aiohttp

    from nanofed_tpu_torch import cli
    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch import observability as obs
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.ops import _build
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.security import secure_agg as sa
    from nanofed_tpu_torch.trainer import TrainingConfig, make_local_fit
    from nanofed_tpu_torch.tuning import compile_cache
    from nanofed_tpu_torch.utils import profiling as uprof

    t_phase = time.perf_counter()
    n, chunk, rpb = FLAGSHIP["num_clients"], 125, FUSED_RPB
    model, data, training = get_model("mnist_cnn"), flagship_data(), flagship_training()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "u_observability"
    gc.collect()

    def make(name: str, rounds_per_block: int, num_rounds: int, telemetry: bool):
        return Coordinator(
            model, data, CoordinatorConfig(num_rounds=num_rounds, seed=0,
                                           base_dir=base / name, save_metrics=False,
                                           rounds_per_block=rounds_per_block),
            training, client_chunk=chunk, device="cuda",
            telemetry_dir=base / name / "telemetry" if telemetry else None)

    def drive(tag: str, coord, rounds: int):
        want: dict[str, int] = {}
        add_launches(want, step_launches(chunk, n), rounds)
        out, wall, grew = counted(torch, ops, card, tag, coord.run, want)
        add_launches(totals, grew)
        if [m.status for m in out] != [RoundStatus.COMPLETED] * rounds:
            fail(f"{tag}: rounds {[m.status for m in out]}")
        return out, wall

    # (u1) single rounds with telemetry.
    single = make("single", 1, OBS_ROUNDS, True)
    s_rounds, s_wall = drive("(u1) flagship single rounds, telemetry on", single, OBS_ROUNDS)
    tel_dir = base / "single" / "telemetry"
    records = telemetry_records(tel_dir)
    del single
    gc.collect()
    if records[0]["type"] != "topology" or records[-1]["type"] != "metrics_snapshot":
        fail(f"(u1) single: first/last records {records[0]['type']}/{records[-1]['type']}")
    if span_structure(records) != SINGLE_SPANS * OBS_ROUNDS:
        fail(f"(u1) single: spans {span_structure(records)[:8]}...")
    round_recs = [r for r in records if r["type"] == "round"]
    if ([(r["round"], r["status"], r["num_clients"]) for r in round_recs]
            != [(i, "COMPLETED", n) for i in range(OBS_ROUNDS)]
            or any(set(r) != {"type", "t", "round", "status", "num_clients", "duration_s"}
                   for r in round_recs)):
        fail(f"(u1) single: round records {round_recs}")
    summary = obs.summarize_telemetry(tel_dir / "telemetry.jsonl")
    if (summary["rounds"] != {"COMPLETED": OBS_ROUNDS}
            or set(summary["phases"]) != {name for name, _, _ in SINGLE_SPANS}
            or summary["round_duration"]["count"] != OBS_ROUNDS):
        fail(f"(u1) single: summary {summary}")
    spans = [r for r in records if r["type"] == "span"]
    occ_single = span_occupancy(obs, spans)
    phase_s = {k: v["total_s"] for k, v in summary["phases"].items()}
    round_total = phase_s["round"] + phase_s["publish"]
    shares = {k: phase_s[k] / round_total for k in ("cohort-sample", "cohort-gather",
                                                     "local-train", "aggregate", "publish")}
    print(f"[{card}] (u1) single rounds, span seconds over {OBS_ROUNDS} rounds: "
          f"{json.dumps(phase_s)}; shares of round+publish: "
          + ", ".join(f"{k} {v:.6f}" for k, v in shares.items())
          + f"; host time outside local-train {1 - shares['local-train']:.6f}; "
          f"occupancy (single basis) {occ_single:.6f}; metrics-summary phases "
          f"{json.dumps(summary['phases'])}")

    # (u1) fused blocks with telemetry: block 0's dispatch under the sync check, block 1
    # (dispatch, host_sync and its publishes) under the profiler.
    fused = make("fused", rpb, OBS_FUSED_ROUNDS, True)
    caught: dict[str, object] = {}
    sync_checked_span(torch, fused._tracer, "dispatch", caught)
    train_block = fused._train_block
    blocks: list[float] = []

    def profiled_block(nr):
        if len(blocks) == 1:
            out, caught["wall"], caught["busy"], caught["top"] = device_profile(
                torch, lambda: train_block(nr))
        else:
            t0 = time.perf_counter()
            out = train_block(nr)
            caught.setdefault("plain_wall", time.perf_counter() - t0)
        blocks.append(len(blocks))
        return out

    fused._train_block = profiled_block
    f_rounds, f_wall = drive("(u1) flagship fused blocks, telemetry on", fused,
                             OBS_FUSED_ROUNDS)
    f_dir = base / "fused" / "telemetry"
    records = telemetry_records(f_dir)
    del fused
    gc.collect()
    block_spans = ([("cohort-sample", 1, "dispatch"), ("dispatch", 0, None),
                    ("host_sync", 0, None)] + [("publish", 0, None)] * rpb)
    if span_structure(records) != block_spans * (OBS_FUSED_ROUNDS // rpb):
        fail(f"(u1) fused: spans {span_structure(records)}")
    round_recs = [r for r in records if r["type"] == "round"]
    if [(r["round"], r["fused"], r["rounds_per_block"]) for r in round_recs] != [
            (i, True, rpb) for i in range(OBS_FUSED_ROUNDS)]:
        fail(f"(u1) fused: round records {round_recs}")
    summary_f = obs.summarize_telemetry(f_dir / "telemetry.jsonl")
    if summary_f["rounds"] != {"COMPLETED": OBS_FUSED_ROUNDS}:
        fail(f"(u1) fused: summary {summary_f}")
    spans = [r for r in records if r["type"] == "span"]
    occ_fused = span_occupancy(obs, spans)
    per_block = len(block_spans)
    second = spans[per_block:2 * per_block]
    occ_second = span_occupancy(obs, second)
    busy_share = caught["busy"] / (caught["wall"] * 1e3)
    syncs = caught["dispatch"]
    top = "; ".join(f"{k[:60]} {t:.3f} ms" for k, t in caught["top"][:3])
    print(f"[{card}] (u1) fused blocks: synchronizing operations in block 0's whole "
          f"dispatch span (cohort sampling, copies, enqueue) with spans on: {len(syncs)}"
          f"{' ' + repr(syncs[:3]) if syncs else ''}")
    print(f"[{card}] (u1) fused blocks: span seconds {json.dumps({k: v['total_s'] for k, v in summary_f['phases'].items()})}; "
          f"occupancy (fused basis) over both blocks {occ_fused:.6f}; block 1 span occupancy "
          f"{occ_second:.6f} against the profiler's busy share {busy_share:.6f} "
          f"(device {caught['busy']:.3f} ms of {caught['wall'] * 1e3:.3f} ms, slack "
          f"{OCCUPANCY_SLACK}); unprofiled block 0 wall {caught['plain_wall']:.6f} s; top "
          f"kernels {top}")
    if syncs:
        fail(f"(u1) {len(syncs)} synchronizing operations in a fused block's dispatch")
    if not (0 < occ_single <= 1 and 0 < occ_fused <= 1):
        fail(f"(u1) occupancy single {occ_single} fused {occ_fused}")
    if occ_second > busy_share + OCCUPANCY_SLACK:
        fail(f"(u1) span occupancy {occ_second} above the busy share {busy_share} + slack")
    reg = obs.get_registry()
    # Set at the last block's host_sync, before that block's publishes.
    gauge = reg.gauge(obs.profiling.DEVICE_OCCUPANCY_GAUGE).value()
    if not 0 < gauge <= 1:
        fail(f"(u1) the process's occupancy gauge is {gauge}")
    print(f"[{card}] (u1) process gauge nanofed_device_occupancy_ratio={gauge:.6f} (every "
          "coordinator of the process so far, fused basis)")

    # (u1) the round with telemetry off and on, interleaved; spans are on in both.
    timed: dict[str, list[float]] = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        coord = make(f"overhead_{i}_{mode}", 1, 1 + OBS_TIMED_ROUNDS, mode == "on")
        out, _ = drive(f"(u1) overhead run {i} telemetry {mode}", coord,
                       1 + OBS_TIMED_ROUNDS)
        timed[mode].extend(m.duration_s for m in out[1:])
        del coord
        gc.collect()
    med_off, med_on = statistics.median(timed["off"]), statistics.median(timed["on"])
    print(f"[{card}] (u1) flagship round_s telemetry off {timed['off']} (median "
          f"{med_off:.6f}), on {timed['on']} (median {med_on:.6f}); on/off "
          f"{med_on / med_off:.6f}")

    # (u2) one flagship round inside the capture.
    cap = make("captured", 1, 1, True)
    want: dict[str, int] = {}
    add_launches(want, step_launches(chunk, n))

    def captured():
        with uprof.trace(base / "u2_trace"):
            return cap.run()

    counted_out, cap_wall, grew = counted(torch, ops, card, "(u2) one flagship round "
                                          "inside utils.profiling.trace", captured, want)
    add_launches(totals, grew)
    del cap
    gc.collect()
    (trace_file,) = (base / "u2_trace").glob("*.json")
    events = json.loads(trace_file.read_text())["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    span_names = {"round", "cohort-sample", "cohort-gather", "local-train", "aggregate",
                  "publish"}
    kernels = {k: sorted(x for x in names if k in x)[:2]
               for k in ("weighted_sum_ring", "weighted_sum_regs", "row_sq_partial_kernel",
                         "row_sq_final_kernel")}
    print(f"[{card}] (u2) capture {trace_file.name}: {trace_file.stat().st_size} bytes, "
          f"{len(events)} events; spans found {sorted(span_names & names)}; B1/B3 kernel "
          f"names {json.dumps(kernels)}")
    if not span_names <= names:
        fail(f"(u2) spans missing from the capture: {sorted(span_names - names)}")
    if not ((kernels["weighted_sum_ring"] or kernels["weighted_sum_regs"])
            and kernels["row_sq_partial_kernel"]):
        fail("(u2) B1's or B3's kernel is missing from the capture")
    trace_file.unlink()  # tens of MB: not kept

    # (u3) (h)'s plain network round with metrics, tracer and telemetry.
    import logging

    from nanofed_tpu_torch.utils.logger import LogConfig, Logger

    Logger().configure(LogConfig(level=logging.WARNING))
    clients = SECURE_CLIENTS
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    host = federate(load_mnist("train", None, synthetic_size=clients * SECURE_SAMPLES),
                    num_clients=clients, batch_size=64, seed=0)
    cdata = [host.select(slice(c, c + 1)).to(torch.device("cuda")) for c in range(clients)]
    fit = make_local_fit(model, TrainingConfig(batch_size=64, local_epochs=1,
                                               learning_rate=0.1))
    rounds = 2
    server_reg = obs.MetricsRegistry()
    tracer = obs.SpanTracer(registry=False)
    client_regs = [obs.MetricsRegistry() for _ in range(clients)]
    trained, fetched, spent, scraped = {}, {}, {}, {}

    async def main():
        port = comm.free_port()
        server = comm.HTTPServer(port=port, registry=server_reg, tracer=tracer)
        await server.start()
        try:
            coordinator = comm.NetworkCoordinator(
                server, init, comm.NetworkRoundConfig(num_rounds=rounds, min_clients=clients,
                                                      round_timeout_s=120.0),
                device="cuda", telemetry_dir=base / "u3_network")
            url = f"http://127.0.0.1:{port}"
            await asyncio.wait_for(asyncio.gather(coordinator.run(), *[
                network_client(torch, comm, sa, url, f"client_{c}", c, fit, cdata[c], None,
                               init, trained, fetched, spent,
                               client_kwargs={"registry": client_regs[c]})
                for c in range(clients)]), 300)
            async with aiohttp.ClientSession() as session:
                async with session.get(f"{url}/metrics") as resp:
                    scraped["status"], scraped["type"] = resp.status, resp.headers.get(
                        "Content-Type", "")
                    scraped["text"] = await resp.text()
            return coordinator
        finally:
            await server.stop()

    want = {"weighted_mean_flat": rounds}
    coordinator, net_wall, grew = counted(torch, ops, card, "(u3) plain network round with "
                                          "metrics", lambda: asyncio.run(main()), want)
    add_launches(totals, grew)
    text = scraped["text"]
    families = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
    accepted = prom_value(text, 'nanofed_updates_total{kind="plain",result="accepted"}')
    received = prom_value(text, 'nanofed_bytes_received_total{endpoint="update"}')
    sent_bodies = sum(reg.counter("nanofed_client_bytes_sent_total", labels=("endpoint",))
                      .value(endpoint="update") for reg in client_regs)
    net_records = telemetry_records(base / "u3_network")
    per_round = [r["num_clients"] for r in net_records if r["type"] == "round"]
    model_sent = prom_value(text, 'nanofed_bytes_sent_total{endpoint="model"}')
    decodes = [r for r in tracer.records if r.name == "submit-decode"]
    want_traces = {obs.new_trace(f"client_{c}", r, r + 1).trace_id
                   for c in range(clients) for r in range(rounds)}
    got_traces = [r.attrs.get("trace") for r in decodes]
    print(f"[{card}] (u3) GET /metrics: HTTP {scraped['status']} {scraped['type']!r}, "
          f"{len(families)} families; updates accepted {accepted} ({rounds} rounds, per "
          f"round {per_round}); bytes received {received} = client bodies sent "
          f"{sent_bodies}; model bytes sent {model_sent}; "
          f"submit-decode spans {len(decodes)} over {len(set(got_traces))} trace ids "
          f"(want {len(want_traces)}); network spans "
          f"{json.dumps(obs.summarize_telemetry(base / 'u3_network' / 'telemetry.jsonl')['phases'])}")
    if scraped["status"] != 200 or not scraped["type"].startswith("text/plain; version=0.0.4"):
        fail(f"(u3) /metrics answered {scraped['status']} {scraped['type']!r}")
    if not set(WIRE_FAMILIES) <= families:
        fail(f"(u3) families missing from /metrics: {sorted(set(WIRE_FAMILIES) - families)}")
    if accepted != clients * rounds or per_round != [clients] * rounds:
        fail(f"(u3) {accepted} updates accepted, per round {per_round}")
    if received != sent_bodies or not received:
        fail(f"(u3) bytes received {received} != bodies sent {sent_bodies}")
    if sorted(got_traces) != sorted(want_traces) or len(got_traces) != len(want_traces):
        fail(f"(u3) submit-decode trace ids {got_traces} != the submits' {want_traces}")
    if [h["status"] for h in coordinator.history] != ["COMPLETED"] * rounds:
        fail(f"(u3) rounds {coordinator.history}")
    del coordinator, cdata
    gc.collect()

    # (u4) the kernel-build manifest over the checkout's build directory.
    compile_cache.install_compile_cache_metrics()
    path = compile_cache.write_manifest()
    report = compile_cache.verify_manifest()
    libs = report["manifest"]["libraries"]
    hits_c = obs.get_registry().counter(compile_cache.COMPILE_CACHE_HITS)
    miss_c = obs.get_registry().counter(compile_cache.COMPILE_CACHE_MISSES)
    hits0, misses0 = hits_c.value(), miss_c.value()
    t0 = time.perf_counter()
    rebuilt = _build.build()
    load_s = time.perf_counter() - t0
    hits1, misses1 = hits_c.value(), miss_c.value()
    bridge = {line.split()[0]: line.split()[1] for line in obs.get_registry()
              .render_prometheus().splitlines() if line.startswith("nanofed_torch_event")
              and "_bucket{" not in line}
    print(f"[{card}] (u4) manifest {path}: {json.dumps(report['manifest']['toolchain'])}; "
          f"libraries {[(lib['name'], lib['hash'], lib['bytes'], lib['current']) for lib in libs]}; "
          f"compatible={report['compatible']} reasons={report['reasons']}; counters before "
          f"the second load hits={hits0} misses={misses0}, after hits={hits1} misses={misses1} "
          f"({load_s:.4f} s, built {list(rebuilt)}); build bridge {json.dumps(bridge)}")
    if (not report["compatible"] or len(libs) != len(_build.SOURCES)
            or not all(lib["current"] for lib in libs)):
        fail(f"(u4) manifest {report}")
    if rebuilt or hits1 - hits0 != len(_build.SOURCES) or misses1 != misses0:
        fail(f"(u4) the second load built {list(rebuilt)}, hits +{hits1 - hits0}, "
             f"misses +{misses1 - misses0}")

    # (u5) the command line: run with --telemetry-dir, then metrics-summary and trace.
    cli_dir = base / "u5_cli"
    argv = ["run", "--model", "mnist_cnn", "--clients", "8", "--rounds", "1",
            "--train-size", "1024", "--out-dir", str(cli_dir / "out"),
            "--telemetry-dir", str(cli_dir / "telemetry")]
    ops.reset_launch_counts()
    ran = cli_summary(cli, argv)
    torch.cuda.synchronize()
    add_launches(totals, ops.launch_counts())
    digest = cli_summary(cli, ["metrics-summary", str(cli_dir / "telemetry")])
    timeline = cli_summary(cli, ["trace", str(cli_dir / "telemetry")])
    print(f"[{card}] (u5) nanofed-tpu-torch run --telemetry-dir: rounds_completed "
          f"{ran['rounds_completed']}; metrics-summary rounds {digest['rounds']} phases "
          f"{sorted(digest['phases'])}; trace streams {json.dumps(timeline['streams'])} "
          f"resolved {timeline['trace_resolution']['resolved']}")
    if ran["rounds_completed"] != 1 or digest["rounds"] != {"COMPLETED": 1}:
        fail(f"(u5) run {ran} / summary {digest}")
    print(f"[{card}] (u) phase wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


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
    from nanofed_tpu_torch.parallel import (
        build_round_step,
        build_scaffold_round_step,
        init_server_state,
    )
    from nanofed_tpu_torch.privacy import PrivacyConfig
    from nanofed_tpu_torch.security import ValidationConfig
    from nanofed_tpu_torch.trainer import (
        TrainingConfig,
        client_keys,
        draw_permutations,
        make_local_fit,
        make_private_local_fit,
    )
    from nanofed_tpu_torch.trainer.private import counter_noise
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
        # Per-example clipping and the counter-based noise of the clients' own keys.
        "DP-SGD clients": (dict(local_fit=make_private_local_fit(model, training, PrivacyConfig(
            max_gradient_norm=1.0, noise_multiplier=0.8))), host, model,
            {"weighted_mean_flat": 1, "row_sq_norms": 1}),
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

    # The DP-SGD noise itself: a hash of the key, then float transforms, on both devices.
    key = torch.tensor(7, dtype=torch.int32)
    cpu_noise = counter_noise(key, tree_size(params))
    noise_rel = float((counter_noise(key.cuda(), tree_size(params)).cpu() - cpu_noise).abs().max()
                      / cpu_noise.abs().max())
    print(f"[{card}] cross-check DP-SGD noise of one key, P={tree_size(params)}: max relative "
          f"|cuda - cpu| = {noise_rel:.3e} (tolerance 1e-6)")
    if noise_rel > 1e-6:
        fail("cross-check: the counter-based noise differs between the card and the CPU")

    # Two SCAFFOLD rounds from zero controls, the clients' deltas fed back.
    states = {}
    for dev in ("cuda", "cpu"):
        device = torch.device(dev)
        step = build_scaffold_round_step(model, training, 8, strategy, device=dev)
        data = ClientData(*host).to(device)
        p = {k: v.to(device) for k, v in params.items()}
        sos = init_server_state(strategy, p)
        c_global = torch.zeros(tree_size(p), device=device)
        c_stack = torch.zeros((8, tree_size(p)), device=device)
        ops.reset_launch_counts()
        for _ in range(2):
            out = step(p, sos, c_global, c_stack, data, data.mask.sum(1), perms.to(device),
                       client_keys(7, 8, device))
            p, sos, c_global = out.params, out.server_opt_state, out.c_global
            c_stack = c_stack + out.delta_c
        if dev == "cuda":
            torch.cuda.synchronize()
            grew = ops.launch_counts()
            want = {k: scaffold_launches(2).get(k, 0) for k in grew}
            if grew != want:
                fail(f"cross-check SCAFFOLD: launches {grew}, expected {want}")
        states[dev] = (ravel(p).cpu(), c_global.cpu(), c_stack.cpu())
    # dc_i = -c + (x - y) / (K * eta): the controls carry the params' error divided by
    # K * eta (K = 4 steps, eta = 0.1), so they are held to CROSS_TOL / (K * eta).  Two
    # CPU runs that differ only in how the convolutions are batched (client_chunk 1 vs
    # none) are 3.3e-6 apart in params and 6.7e-5 in c_stack after round 2.
    steps = training.local_epochs * (host.y.shape[1] // training.batch_size)
    control_tol = CROSS_TOL / (steps * training.learning_rate)
    gaps = [float((a - b).abs().max()) for a, b in zip(states["cuda"], states["cpu"])]
    print(f"[{card}] cross-check SCAFFOLD, 2 rounds of 8 clients f32 cuda vs cpu: "
          f"max|dparams|={gaps[0]:.3e} (tolerance {CROSS_TOL}) max|dc_global|={gaps[1]:.3e} "
          f"max|dc_stack|={gaps[2]:.3e} (tolerance {control_tol:.3e})")
    if (gaps[0] > CROSS_TOL or max(gaps[1:]) > control_tol
            or not torch.isfinite(states["cuda"][0]).all()):
        fail("cross-check SCAFFOLD: the rounds on the card disagree with the CPU")


def main() -> None:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        import nanofed_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"nanofed_tpu_torch not importable ({e}): run from the root of a checkout")
    from nanofed_tpu_torch import ops, run_experiment
    from nanofed_tpu_torch.observability import install_torch_event_bridge
    from nanofed_tpu_torch.ops import _build
    from nanofed_tpu_torch.tuning import install_compile_cache_metrics

    # Before the first build, so (u4) reads its nvcc builds from the counters.
    install_torch_event_bridge()
    install_compile_cache_metrics()

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
    records.update(phase_quantize(torch, ops, card))
    records["dequant_accumulate_flat"] = phase_dequant(torch, ops, card)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "runs") as tmp:
        counts = phase_slice(torch, ops, run_experiment, card, Path(tmp))
        secure_counts = phase_secure(torch, ops, card)
        tuned_counts = phase_autotune(torch, ops, run_experiment, card, Path(tmp))
        resume_counts = phase_resume(torch, ops, run_experiment, card, Path(tmp))
        network_resume_counts = phase_network_resume(torch, ops, card, Path(tmp))
        dp_counts = phase_dp(torch, ops, card, Path(tmp))
        scaffold_counts, scaffold_params, population = phase_scaffold(
            torch, ops, run_experiment, card, Path(tmp))
        phase_trainer(torch, ops, card, Path(tmp), scaffold_params, population)
        del scaffold_params, population
        fused_counts = phase_fused(torch, ops, card, Path(tmp))
        cifar_counts = phase_cifar(torch, ops, card, Path(tmp))
        obs_counts = phase_observability(torch, ops, card, Path(tmp))
    wire_counts = phase_wire(torch, ops, card)
    counts = {k: counts[k] + secure_counts[k] + tuned_counts[k] + resume_counts[k]
              + network_resume_counts[k] + dp_counts[k] + scaffold_counts[k]
              + fused_counts[k] + cifar_counts[k] + obs_counts[k] + wire_counts.get(k, 0)
              for k in counts}
    print(f"kernels: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main paths: {missing}")
    phase_cross_check(torch, ops, card)

    if any(m == "jax" or m.startswith(("jax.", "nanofed_tpu.")) or m == "nanofed_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package was imported")
    sources = {
        "weighted_mean_flat": ("nanofed_tpu_torch/ops/csrc/reduce.cu", "nanofed_tpu/ops/reduce.py:46"),
        "weighted_sum_into": ("nanofed_tpu_torch/ops/csrc/reduce.cu", "nanofed_tpu/ops/reduce.py:46"),
        "row_sq_norms": ("nanofed_tpu_torch/ops/csrc/dp_reduce.cu", "nanofed_tpu/ops/dp_reduce.py:70"),
        "masked_weighted_mean_flat": ("nanofed_tpu_torch/ops/csrc/reduce.cu",
                                      "nanofed_tpu/ops/reduce.py:104"),
        "quantize_u32": ("nanofed_tpu_torch/ops/csrc/quantize.cu", "nanofed_tpu/ops/quantize.py:55"),
        "dequantize_u32": ("nanofed_tpu_torch/ops/csrc/quantize.cu",
                           "nanofed_tpu/ops/quantize.py:78"),
        "add_mask": ("nanofed_tpu_torch/ops/csrc/quantize.cu", "nanofed_tpu/ops/quantize.py:208"),
        "dequant_accumulate_flat": ("nanofed_tpu_torch/ops/csrc/quantize.cu",
                                    "nanofed_tpu/ops/quantize.py:135"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], **records[name]}
        for name, (src, replaces) in sources.items()
    ]
    print(f"chip_smoke: whole script wall_s={time.perf_counter() - t_script:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
