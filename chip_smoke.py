#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nanofed_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one card and
exits non-zero when there is none, or when ``nanofed_tpu_torch`` is not beside it.
It imports nothing of JAX or of the JAX package ``nanofed_tpu``.

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions, and the
   kernel build (one ``nvcc`` per source in ``nanofed_tpu_torch/ops/csrc``, all
   started together) with its wall time.
Phases whose seconds a finding of PERF.md reads run one after another.  Everything
that times nothing runs at the end, side by side, beside (o)-(r), part 4, (fl4)'s
fleet evidence and (w3)'s one-rank references: the checks of phase 2, (d), (e), (t4),
(i)'s runner, (k), (y2), (y3), (w3)'s ranks, (x1)'s (1, 2) mesh, (x4), (u2)-(u5), (v5),
(z1), (z5), (fl4)'s FedBuff artifact, (an2) and (an3), each job a process of its own
(``python3 chip_smoke.py --job NAME DIR``, ``JOBS``).  Depths cut to fit the time limit
are stated beside their constants.

2. Kernels: B1 (``weighted_mean_flat`` and ``weighted_sum_into``), B3
   (``row_sq_norms``) and B2 (``masked_weighted_mean_flat``) against their plain
   PyTorch versions on the card, on ragged shapes, weight and validity cases and
   NaN/inf rows; B1/B2 also on the edges of their launch plan (C = 1 to 7, around
   the ring's 3 and 6 stages, 40 and 1000; P = 1, 2, 3, around each largest grid of
   minimum slabs and 1,199,882; every load width and a data pointer one float off), two
   launches of each form giving the same bits, and timed with their launch plan at
   every C the main path launches them with (C = 2, 8, 25, 100, 125, 250 and 1000 for
   B1, 64, 125 and 1000 for B2, P = 1,199,882); B3 at C = 2, 25, 100 and 125 with its
   launch plan, and on the edges of its plan (C = 1, P under one segment and around
   the segment count's steps, P not a multiple of a 16-byte unit, one more (row,
   segment) pair than one wave holds on the ring and on the register path, 70,000
   rows, a row stride beyond P, every load width), the same bits twice, and rows of a
   C = 125 launch equal bit for bit to a launch of those rows alone; B5
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
   are timed with CUDA events (median of ``SMOKE_REPS`` = 5 runs after 5 warm-up runs,
   L2 flushed before each run; the kernel table's medians of 30 runs come from
   ``scripts/time_reduce_kernels.py`` and ``scripts/time_quantize_kernels.py``, which
   call this file's timing functions), beside the least time the card could take: B7 as a client's
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
   each, 1 epoch, batch 64, SGD lr 0.1, f32; 1 round, (g) 2), (f) the no-dropout masked
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
   (``client_chunk`` None, 125 or 250 x batch 64), with the ranked table and the
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
   max_gradient_norm=1.0)))`` with ``client_chunk=25``, 1 round (B1 accumulate and B3
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
   flagship (``client_chunk=125``), 4 rounds at ``rounds_per_block=2`` (two blocks) and
   at 1, and the fused run again for the run-to-run gap: params within 1e-4 and the gap
   plus 1e-6, every round's metrics within 1e-4 (counts equal), B1 accumulate and B3 32
   each a run, per-round wall time and peak device memory above each run's start
   (within 1%); (s2) a validated 10% cohort with dropout 0.1 as one 2-round block
   against single rounds (B2 once a round), and a 2-round block that resamples its
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
   11,218,340), 8 clients of 6,250 images, 1 round in f32 (TF32 off): round times,
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
   ``telemetry_dir``, 2 single rounds and 4 rounds at ``rounds_per_block=2``: the spans
   of ``telemetry.jsonl`` with the JAX names and nesting, every ``round`` record,
   ``summarize_telemetry`` over the file, the span-derived occupancy on both bases, the
   first block's whole ``dispatch`` span under the sync check (0 synchronizing
   operations) and the second block under ``torch.profiler`` (its span occupancy at
   most the device's busy share + 0.02), then the round with telemetry off and on,
   interleaved (off, on, on, off; 2 rounds each after a warm round); (u2) one flagship
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
   Then the causal transformer LM and LoRA adapter federation (phase (v)), on seeded
   Markov-chain token streams, SGD without momentum: (v1) the ``base`` flagship (vocab
   8192, seq 128, width 768, depth 12, 12 heads; 97,745,408 parameters) with rank-8
   adapters (1,398,784 parameters, ratio 69.88) through ``Coordinator(adapter=)``, 8
   clients of 128 sequences, batch 16, 1 epoch, lr 0.1: 2 rounds in f32, then 2 in bf16
   (the second traced by ``torch.profiler``), each round's seconds, counted FLOPs
   (``FlopCounterMode``) and rate, peak device memory and loss; the merge at round 0
   the base bit for bit and after round 1 within 1e-5 of ``base + s A@B`` in float64;
   B1 normalised and B3 once a round at C = 8, P = 1,398,784; (v2) the same cohort's
   dense full fine-tune, 1 round f32 (B1 and B3 at C = 8, P = 97,745,408, held against
   their plain versions on the round's own delta stack), and the q8 and topk8 (5%) wire
   bytes of its delta and of (v1)'s first adapter delta; B1 and B3 at those shapes and
   B1's accumulate form at C = 2, P = 7,356,416 timed beside ``w @ x``, ``acc.addmv_``
   and ``torch.linalg.vecdot`` and their bounds; (v3) 2 bf16 adapter rounds at
   ``rounds_per_block`` 2 and 1 and at 2 again (the run-to-run gap; its first block's
   ``dispatch`` under the sync check, 0 synchronizing operations): the adapters within
   1e-4 plus the gap; (v4) the ``large`` flagship (vocab 32768, seq 256, width 2048,
   depth 24; 1,343,377,408 parameters, initialised on the card, timed) with rank-8
   adapters, 4 clients of 8 uniform token sequences, batch 8, bf16, ``client_chunk=2``
   (1 after running out of memory), 1 round step: its seconds and peak device memory, B1
   accumulate and B3 2 at C = 2, P = 7,356,416; (v5) at the ``evidence`` config
   (3,701,248 parameters) ``nanofed-tpu-torch run --model transformer_lm
   --adapter-rank 4`` (the zoo's default dims, 8 clients, 1 round), a
   ``Coordinator(adapter=)`` with a ``ModelManager`` and a state store closed after 2 of
   4 rounds and resumed (within 1e-4 of the uninterrupted run; the versioned model the
   merged params, the checkpoint the adapters), and ``autotune(adapter=AdapterSpec(
   rank=8))`` with the chunk and batch pinned over ranks 4, 8 and 16.
   Then the round across ranks (phase (w), ``parallel.mesh``) on the one card: (w0) (b)'s
   configuration unsharded under cuDNN's deterministic algorithms; (w1) this process as a
   world of one rank over NCCL, ``Coordinator(mesh_shape=(1,))``, bit for bit (w0), and
   NCCL's all-reduce of the [P] aggregate timed; a rank of two NCCL ranks on one card
   refused before its process group, naming the card; (w2) 4 spawned ranks on ``cuda:0``
   over gloo, mesh (2, 2, 1), the flagship with 250 clients a rank in 2 chunks: within
   1e-5 of (w1), every rank's params the same bits, each rank's all-reduce and
   all-gather calls, bytes and seconds, then a validated round (B2's ``denom`` form once a
   rank); (w3) the ``base`` transformer's dense FedAdam round and its rank-8 adapter round
   (8 clients in chunks of 2, f32) on one rank and on 2 ranks over gloo, mesh (1, 2): bit
   for bit, each rank's model state between rounds half the one-rank state, each rank's
   peak memory; (w4) ``nanofed-tpu-torch run --distributed`` under ``python -m
   torch.distributed.run --nproc_per_node 1`` (NCCL; it times nothing, so it runs beside
   (o)-(r) and part 4) and ``run --model-shards 2`` on one rank (exit 2, the JAX
   validator's message); then B2's ``denom`` form at C = 250 and B1's accumulate form
   and B3 at C = 2, P = 97,745,408 and 1,398,784 timed beside their plain versions,
   library calls and bounds.  Every rank's launches join the kernels line.
   Then the rest of the mesh and the host-local federation (phase (x); (w2) and
   (x1)-(x3) in one world of 4 ranks, (w3), (x1)'s (1, 2) mesh and (x4) in one world of
   2): (x1) SCAFFOLD at (m)'s configuration (1000 clients, 10% cohorts in chunks of 25,
   3 rounds) on 4 gloo ranks, mesh (2, 2, 1), within 1e-5 of one rank given the same (host-local)
   cohorts, every rank's params and ``c_global`` the same bits, each rank a quarter of
   the control stack; the same on 2 ranks, mesh (1, 2), bit for bit one rank; a
   100-client checkpoint of the (2, 2, 1) run resumed on one rank and one rank's resumed
   on (2, 2, 1), bit for bit; (x2) ``profile_programs()`` on every rank of (2, 2, 1) in
   lockstep, the gauges from rank 0 alone; (x3) a fused flagship block of R = 4 drawing
   its cohorts on the card over the hosts axis (one all-gather of rows a round), within
   1e-5 of the one-device block, the same ids; (x4) 2 gloo ranks as hosts, each an
   ``HTTPServer`` with a card ingest buffer and 4 ``HTTPClient`` s submitting full-width
   params: the partial drains, one row all-reduce under a ``CollectiveWatchdog`` and the
   apply, FedAvg and FedBuff, within 1e-5 of one server draining the union, a
   ``GenerationStore`` generation committed and read back each round.
   Then faults and chaos (phase (y), ``nanofed_tpu_torch.faults``): (y1) the flagship
   (b) through ``Coordinator(chaos=)`` under ``FaultPlan.generate(crash_fraction=
   0.25)``, at a completion rate every round completes at on the 750 survivors and at
   one every round fails at: the cohorts the plan's survivors, B1 accumulate and B3 the
   counts the code predicts, the crash count the plan's; (y2) (h)'s 8 clients on a
   ``VirtualClock`` under a plan with a crash, a straggler, a drop, a lost ACK with
   duplicates, a corrupted body and a ``server_kill``, resumed from a ``FileStateStore``:
   every round's status, the counts by kind, each aggregate within 1e-5 of the FedAvg of
   the updates accepted exactly once, B1 at C = that count;
   ``scripts/multihost_harness_torch.py`` with gloo ranks on the card: (y3) ``smoke``,
   2 ranks against 1 within 5e-5; then (y4) ``hostchaos`` with a planned ``host_crash`` (2
   ranks, 6 rounds, blocks of 2, a rejoin): detection, recovery and start-up seconds,
   rounds lost, the parity gap, orphans; (y5) a short ``bench``.  Every rank's launches
   join the kernels line.
   Then load and service (phase (z), ``nanofed_tpu_torch.loadgen`` and ``.service``):
   (z1) ``run_loadtest_comparison`` at the JAX command line's defaults on the system
   clock but 1,000 clients and a 5 s round timeout (``digits_mlp``, K = 64, ingest
   capacity 1024, 4 decode workers, ``max_inflight`` 512, Poisson 2000/s), both serving
   paths: no submit lost, every other one accepted or ended by the engine's end, p50 <=
   p99 <= max, aggregations completed; (z2) the ingest path at full ``mnist_cnn`` width
   (1,000 clients at 250/s, capacity 256: a 1.23 GB buffer on the card), the same
   checks; (z3) ``run_tenant_service`` with the default three-tenant roster and the
   storm on alpha (40 clients a tenant, 2 submits each, 3 rounds, system clock),
   concurrent then sequential: bravo and charlie lose nothing, the storm counts only in
   alpha's registry, every tenant's leases equal its device sections with device
   seconds > 0, B1 once a completed charlie round; (z4) under an explicit 16 GiB budget
   a ``mnist_cnn`` FedBuff tenant with a 4096-row ingest buffer (19.7 GB resident) is
   refused with its numbers and nothing stays mounted; under the card's own budget it
   is admitted beside a ``mnist_cnn`` sync FedAvg tenant (8 clients, 2 rounds, B1 once
   a round at C = 8), both run and both are removed; (z5) ``nanofed-tpu-torch
   loadtest`` and ``tenants`` through ``cli.main`` (exit 0, the artifacts parse), and
   ``scripts/multihost_harness_torch.py federate`` on 2 gloo ranks sharing the card
   (it times nothing), every host's params within
   1e-5 of the numpy replay of the drained rounds.
   Then the heterogeneous fleet (phase (fl), ``nanofed_tpu_torch.fleet``): (fl1) the
   ``base`` transformer (P = 97,745,408) behind ``HTTPServer(fleet=FleetGateway(
   reference_fleet()))`` with a 16-row ingest buffer on a ``VirtualClock``, 24 clients
   (7 rank-4 topk8 phones, 5 rank-8 q8 edge boxes, 1 rank-32 f32 silo a round), 2 rounds
   of publish, tier-tagged ``GET /model``, ``run_fleet_swarm``, ``drain_ingest_fedavg``:
   each round's publish seconds (factorization, views, payloads), decode seconds a
   submit by tier, bytes by tier from ``/metrics``, the drain's seconds and the card's
   peak; every submit accepted, one buffered row a tier within 1e-5 of its float64 host
   recomputation (beside the host route's seconds for it), the head and one attention
   leaf's views within 1e-4 of numpy's float64 truncated SVD and their projection
   errors the singular-value tails within 1e-6, round 0's views revived, no kernel
   launched; (fl2) the dense and padded routes over round 1's cohort within 1e-5; (fl3)
   ``TenantFootprint.for_fleet`` against a drain's measured peak, ``sweep_fleet_mix``
   under the card's budget, ``TuningSpace.for_fleet``'s profiled sweep at the
   ``evidence`` config (ranks 2-64; B1 and B3 launches equal to ``sweep_launches``) with
   its step costs fed to the mix sweep, B1 and B3 timed at its shapes; (fl4)
   ``generate_fleet_evidence`` at 30 clients and 4 rounds and
   ``generate_fedbuff_adapter_artifact`` at 100 clients and 4 aggregations.
   Then analysis (phase (an), ``nanofed_tpu_torch.analysis``): (an1) the flagship
   through ``Coordinator(strict=True)``, one fused block of 2 rounds then one round
   through the single round step (the contract checks on meta tensors and the program
   audit at construction, every dispatch under ``strict_mode``, its entries counted
   with the sync debug mode read inside each), after an untimed warm run and the same
   run with ``strict=False``: params bit-equal under cuDNN's deterministic algorithms,
   B1's accumulate form and B3 8 times a round in each, the seconds strict adds to
   construction, each run's round seconds and their strict/plain ratios, and the peak
   device memory of the construction's checks and audit run again (the factories'
   clones; the programs run on meta tensors); (an2) the tutorial round, materialised,
   at one local epoch (cut from two), strict against not: B1 normalised and B3 once
   each, params bit-equal; then a strict
   coordinator whose round step reads ``.item()`` raises at its dispatch; (an3) inside
   ``strict_mode()`` on
   the card ``.item()``, ``bool()`` of a device tensor and a pageable copy to the card
   raise, and a B1 launch alone does not; (an4) ``audit_programs()`` of (an1)'s
   coordinator: every program ``ok``, its seconds and peak-memory delta.
   Then real data (phase (ev), the digits bundled with the port): (ev1)
   ``scripts/record_accuracy_torch.py``'s default run, ``mnist_cnn`` on the digits
   upsampled to 28x28, 8 clients, must reach 97% held-out accuracy within 30 rounds
   (the round and the wall clock to 97% printed; B1 normalised and B3 once a round);
   (ev2) ``scripts/record_evidence_torch.py``'s byzantine mode at its own depth (16
   clients, 2 attackers, 20 rounds, 5 arms of ``digits_mlp(96)``) must hold every
   defense (B1 4 and B3 5 a round over the arms); (ev3) ``run_experiment(
   model="digits_mlp")``, one round of 4 clients (B1 and B3 once); (ev4) B1 and B3
   timed at the evidence runs' shapes.
   Then the online retuner (phase (rt), ``scripts/record_retune_evidence_torch.py``'s
   reference lifecycle on the card: the AOT sweep with its epilogue table (B4, B2),
   probes of the alternative, the closed loop with a decision every 4 rounds, the
   write-back): the AOT winner, the measured winner, the decisions, the swap round and
   the steady-state rates printed; it fails on the structural checks (at most one
   applied swap, on a block boundary, a write-back with a ``measured`` block) and on
   launches other than the sweep's, the probes' and the rounds' each program ran, never
   on which candidate wins.  Beside (o)-(r), the job ``notebook`` (phase (nb)) builds
   ``scripts/build_notebook_torch.py``'s tutorial and runs every cell on the card with
   its in-process runner in a temporary directory: every code cell without an error
   output and its own asserts holding, and each cell's launches (B1, B3, B5, B6, B7)
   equal to the ones derived from its rounds and its secure clients.
4. Cross-check: 8-client f32 rounds of the port on the card and on the CPU from the
   same weights, permutations and injected noise: the plain round with dropout off
   and on (the masks are an integer hash, the same bits on both devices), the
   validated round with one client poisoned to NaN, the materialised central-DP
   round, the trimmed-mean round, the Multi-Krum round and the DP-SGD round (its
   counter-based noise of one key within 1e-6 relative on both devices); then two
   SCAFFOLD rounds from zero controls (params within 1e-4, the controls within 1e-4
   over K * eta, the factor (x - y) / (K * eta) multiplies the params' error by);
   then (v6) a tiny transformer's adapter round (vocab 256, seq 32, width 64, depth 2,
   rank 4) within 1e-4.

The last lines are the whole script's wall time, the seconds of each phase and of each
run beside (o)-(r) from its start, the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
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
import threading
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
# (i): and its batch-size axis (32 and 64 until 2026: 64 alone halves the sweep, to fit
# the script's time limit; the chunk axis still ranks three candidates).
TUNED_BATCHES = (64,)
# (i): the autotuned runner's samples a client.  Its default space sweeps 3-round blocks
# beside single rounds, and the profiler runs every candidate 5 times.
RUNNER_SAMPLES = 128
FLAGSHIP = dict(num_clients=1000, num_rounds=2, local_epochs=2, batch_size=64,
                learning_rate=0.1, train_size=60_000, compute_dtype="bfloat16")
TRIM_K = 5  # (e): trimmed mean over the 100-client cohort
RESUME_ROUNDS = 4  # (j): the flagship run resumed after 2 of its 4 rounds
RESUME_TOL = 1e-4  # (j), (k): a resumed run against the uninterrupted one on the card
# Kernel timing: the kernel table's medians of 30 runs, each after a 256 MB L2 flush, come
# from scripts/time_reduce_kernels.py and scripts/time_quantize_kernels.py, which call
# this file's timing functions at TABLE_REPS.  Phase 2 times the same shapes briefly, for
# the JSON record of this run (reduced from 30 runs in 2026: the whole script had grown
# past its time limit).
TABLE_REPS = 30
SMOKE_REPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, torch, reps: int = TABLE_REPS, warmup: int = 5, hide_host_ms: float = 0.0,
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
    """B1 (all forms), B3 and B2 at every C the main path launches them with, each held
    against its plain version and then timed briefly (``SMOKE_REPS``).  Returns the
    per-kernel record of the main path's shape (the 125-client chunk for B1 and B3,
    the 1000-client validated round for B2).  Their ragged, edge and bit checks are
    :func:`check_reduce_kernels`'s."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = time_reduce(torch, ops, card, gen, reps=SMOKE_REPS)
    for c in (2, 25, 100, 125):  # tutorial, (d)/(l) chunks, (m) cohort, flagship chunk
        x = round_layout(torch, c, P_MNIST, seed=c)
        err = check_close(torch, "row_sq_norms", ops.row_sq_norms(x), ops.row_sq_norms_plain(x),
                          **TOL)
        ms = median_ms(lambda: ops.row_sq_norms(x), torch, reps=SMOKE_REPS)
        plain_ms = median_ms(lambda: ops.row_sq_norms_plain(x), torch, reps=SMOKE_REPS)
        library_ms = median_ms(lambda: torch.linalg.vecdot(x, x), torch, reps=SMOKE_REPS)
        sq_ms = median_ms(lambda: x.square().sum(1), torch, reps=SMOKE_REPS)
        b_ms, b_by = bound_ms(4 * c * P_MNIST + 4 * c, 2 * c * P_MNIST)
        print(f"[{card}] row_sq_norms C={c} P={P_MNIST}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"(torch.linalg.vecdot(x, x)) bound_ms={b_ms:.6f} ({b_by}) "
              f"max_abs_err={err:.3e}; x.square().sum(1) ms={sq_ms:.6f} "
              f"{row_sq_plan_line(torch, x)}")
        if c == 125:
            records["row_sq_norms"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                           bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    return records


def check_reduce_kernels(torch, ops, gen) -> None:
    """Hold B1 (all forms), B3 and B2 against their plain versions, on ragged shapes
    and on the edges of B1/B2's and B3's launch plans; check that each gives the same
    bits twice."""

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
    t0 = time.perf_counter()
    check_row_sq_edges(torch, ops, gen)
    check_row_sq_determinism(torch, ops, gen)
    print(f"kernels: B3's edge and bit checks took {time.perf_counter() - t0:.3f} s")


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


def check_row_sq_edges(torch, ops, gen) -> None:
    """B3 against its plain version on the edges of its launch plan: C = 1, 2, 3, 7 and
    40 over P = 1-5, under one segment, around the steps of the segment count (one to
    two segments, and where it reaches SMs / 2) and 1,199,882, every layout; one more
    (row, segment) pair than one wave holds on the ring (C = 2 x SMs + 1 small rows) and
    on the register path (C = 6 x SMs + 1); 70,000 rows (past the old grid's 65,535); a
    row stride 64 floats beyond P."""
    from nanofed_tpu_torch.ops._common import vector_width
    from nanofed_tpu_torch.ops.dp_reduce import (
        MIN_SEGMENT_UNITS,
        SMS_PER_SEGMENT,
        check_row_sq_plan,
        row_sq_plan_for,
    )
    from nanofed_tpu_torch.ops.reduce import REGISTER_BLOCKS_PER_SM, RING_BLOCKS_PER_SM

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seg = MIN_SEGMENT_UNITS * 4  # one segment's least columns on the ring
    near = lambda e: [e + d for d in (-4, -1, 1, 4)]  # noqa: E731
    ps = [1, 2, 3, 4, 5, seg - 24, *near(seg), *near(2 * seg),
          *near(sms // SMS_PER_SEGMENT * seg), P_MNIST]
    shapes = [(c, p, layout) for c in (1, 2, 3, 7, 40) for p in ps
              for layout in ("contiguous", "vec4", "vec2", "vec1")]
    shapes += [(RING_BLOCKS_PER_SM * sms + 1, seg - 24, "vec4"),
               (REGISTER_BLOCKS_PER_SM * sms + 1, 999, "vec2"),
               (REGISTER_BLOCKS_PER_SM * sms + 1, 999, "vec1"), (70_000, 3, "vec4")]
    widths, pairs_over_wave = set(), []
    for c, p, layout in shapes:
        x = reduce_layout(torch, c, p, layout, gen)
        ldx = x.stride(0) if c > 1 else p
        widths.add(vector_width(x, ldx))
        vec, plan = row_sq_plan_for(x, ldx)
        check_row_sq_plan(plan, c, p, ldx, vec)
        if c > sms and plan.segments == 1:
            pairs_over_wave.append((c, vec, plan.blocks))
        check_close(torch, f"row_sq_norms edge c={c} p={p} {layout}", ops.row_sq_norms(x),
                    ops.row_sq_norms_plain(x), **TOL)
        del x
    buf = torch.randn(3 * (4096 + 64), device="cuda", generator=gen)
    strided = buf.view(3, 4096 + 64)[:, :4096]  # the ring on a stride 64 floats past P
    check_close(torch, "row_sq_norms stride P+64", ops.row_sq_norms(strided),
                ops.row_sq_norms_plain(strided), **TOL)
    torch.cuda.empty_cache()
    if widths != {4, 2, 1}:
        fail(f"row_sq_norms edges: load widths exercised {sorted(widths)}, expected 4, 2 and 1")
    print(f"kernels: {len(shapes) + 1} B3 cases on its launch plan's edges agree with the "
          f"plain version (rtol {TOL['rtol']}, atol {TOL['atol']}; C 1-7, 40, "
          f"(C, vec, blocks) past one wave {pairs_over_wave}, 70,000 rows; P {ps}; load "
          f"widths {sorted(widths)})")


def check_row_sq_determinism(torch, ops, gen) -> None:
    """B3 at C = 125 on the round's layout (P = 1,199,882) and at C = 25 on the 2-float
    layout: two launches give the same bits, and rows 0-1 and the last two rows equal
    bit for bit a launch of those rows alone (another grid, another ring depth)."""
    def equal(what: str, a, b) -> None:
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"row_sq_norms {what}: different bits ({int((a != b).sum())} rows differ)")

    for c, layout in ((125, "round"), (25, "vec2")):
        x = (round_layout(torch, c, P_MNIST, seed=11 * c) if layout == "round"
             else reduce_layout(torch, c, P_MNIST, layout, gen))
        a = ops.row_sq_norms(x)
        equal(f"C={c} {layout}, two launches", a, ops.row_sq_norms(x))
        equal(f"C={c} {layout}, rows 0-1 alone", a[:2], ops.row_sq_norms(x[:2]))
        equal(f"C={c} {layout}, the last two rows alone", a[-2:], ops.row_sq_norms(x[-2:]))
        del x
    torch.cuda.empty_cache()
    print(f"kernels: B3 gives the same bits twice, and for rows 0-1 and the last two rows "
          f"launched alone, at C = 125 (ring) and 25 (2-float loads), P = {P_MNIST}")


def row_sq_plan_line(torch, x) -> str:
    """B3's launch plan over ``x`` with what the card makes of it; fails if the grid
    is more than one wave."""
    from nanofed_tpu_torch.ops.dp_reduce import row_sq_occupancy, row_sq_plan_for
    from nanofed_tpu_torch.ops.reduce import sm_count

    ldx = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    vec, plan = row_sq_plan_for(x, ldx)
    regs, per_sm = row_sq_occupancy(x.device, vec, plan)
    sms = sm_count(x.device.index)
    if plan.blocks > sms * per_sm or per_sm < plan.per_sm:
        fail(f"row_sq_norms plan {plan}: the card holds {per_sm} blocks an SM ({sms} SMs), "
             f"so the grid is more than one wave")
    return (f"plan: vec={vec} path={'ring' if plan.stages else 'registers'} "
            f"segments={plan.segments} blocks={plan.blocks} stages={plan.stages} "
            f"shared_bytes={plan.shared_bytes} per_sm_planned={plan.per_sm} "
            f"per_sm_card={per_sm} sms={sms} registers={regs}")


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


def time_reduce(torch, ops, card: str, gen, show_plan: bool = True,
                reps: int = TABLE_REPS) -> dict[str, dict]:
    """Time B1/B2 at each of ``TIMED_REDUCES`` (P = 1,199,882), medians of ``reps``
    runs: the kernel, its plain
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
        ms, plain_ms = median_ms(kernel, torch, reps=reps), median_ms(plain, torch, reps=reps)
        library_ms = median_ms(library, torch, reps=reps) if library else None
        b_ms, b_by = bound
        if sanitized:
            yard_ms = median_ms(lambda: coefs @ finite, torch, reps=reps)
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
    """Time, briefly (``SMOKE_REPS``), the floor of a 1.2M-word pass, B5 and B6 at that
    size and B7 there for each of ``TIMED_MASK_KS``, each held bit for bit against its
    plain version (B7 against the host's Philox streams up to k = 14).  Their ragged,
    edge and bit checks are :func:`check_quantize_kernels`'s."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(11)
    time_floor(torch, ops, card, reps=SMOKE_REPS)
    records = time_fixed_point(torch, ops, card, gen, reps=SMOKE_REPS)
    records["add_mask"] = time_masks(torch, ops, card, np.random.default_rng(11),
                                     reps=SMOKE_REPS, plain_reps=1)[MASK_RECORD_K]
    return records


def check_quantize_kernels(torch, ops, gen) -> None:
    """Hold B5, B6 and B7 bit for bit against their plain versions (ragged P, unaligned
    starts, ties, saturation, both signs), B7 also with k seeds a launch; check B7's
    stream against numpy's Philox at P = 1,199,882, one seed and eight; hold B5 and B6
    on the edges of their launch plan and twice for the same bits."""
    import numpy as np

    from nanofed_tpu_torch.security.secure_agg import _fold_seed_words, _prg_uint32

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


def time_floor(torch, ops, card: str, reps: int = TABLE_REPS) -> dict:
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
        empty = median_ms(lambda: torch.cuda._sleep(0), torch, reps=reps, flush=flush,
                          hide_host_ms=0.5)
        copy = median_ms(lambda: out.copy_(x), torch, reps=reps, flush=flush, hide_host_ms=0.5,
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
        hide = 2 * host_ms(call, torch, reps=reps) + 0.5
        times = {flush: median_ms(call, torch, reps=reps, flush=flush, hide_host_ms=hide)
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


def time_fixed_point(torch, ops, card: str, gen, reps: int = TABLE_REPS) -> dict[str, dict]:
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
        wrapper_ms = host_ms(kernel, torch, reps=reps)
        hide = 2 * wrapper_ms + 0.5
        ms = median_ms(kernel, torch, reps=reps)
        kernel_ms = median_ms(kernel, torch, reps=reps, hide_host_ms=hide)
        read_ms = median_ms(kernel, torch, reps=reps, flush="read", hide_host_ms=hide)
        warm_ms = median_ms(kernel, torch, reps=reps, flush="none", prep=warm, hide_host_ms=hide)
        plain_ms = median_ms(plain, torch, reps=reps)
        library_ms, lib_note = None, "none computes the same function"
        lib_name, lib_fn, to_bits = libraries[name]
        try:
            agrees = torch.equal(to_bits(lib_fn()).view(torch.int32),
                                 wants[name].view(torch.int32))
        except (RuntimeError, NotImplementedError) as e:  # a yardstick torch lacks here
            agrees, lib_note = False, f"{lib_name} unavailable: {e}".splitlines()[0]
        if agrees:
            library_ms, lib_note = median_ms(lib_fn, torch, reps=reps), lib_name
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


def host_ms(fn, torch, reps: int = TABLE_REPS) -> float:
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


def time_masks(torch, ops, card: str, rng, ks=TIMED_MASK_KS, reps: int = TABLE_REPS,
               plain_reps: int = 5) -> dict[int, dict]:
    """B7 at P = 1,199,882: a client's masking pass of k seeds for each k of ``ks``,
    timed on the card as the wrapper's call (``ms``, as every kernel is timed), again
    with the host's work hidden (``kernel_ms``, ``median_ms(hide_host_ms=...)``: a pass
    of k single-seed launches costs the host more than the card) and on the host alone,
    beside the function's bound (``mask_bound_ms``) and, up to k = 8, its plain version
    (``plain_reps`` runs: it is slow); checked against the host's Philox streams up to
    k = 14.
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
        wrapper_ms = host_ms(call, torch, reps=reps)
        ms = median_ms(call, torch, reps=reps)
        kernel_ms = median_ms(call, torch, reps=reps, hide_host_ms=2 * wrapper_ms + 0.5)
        plain_ms = (median_ms(lambda: mask_pass(ops, q, seeds, signs, plain=True), torch,
                              reps=plain_reps, warmup=1) if k <= 8 else None)
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
    """B4 at the epilogue's shapes (C = 64 and 1000, P = 1,199,882), held against its
    plain version and timed briefly (``SMOKE_REPS``) with its plan.  Returns the record
    at C = 64, the epilogue table's C.  Its ragged, edge and bit checks are
    :func:`check_dequant_kernel`'s."""
    return time_dequant(torch, ops, card, torch.Generator(device="cuda").manual_seed(4),
                        reps=SMOKE_REPS)


def check_dequant_kernel(torch, ops, gen) -> None:
    """Hold B4 against its plain version: ragged P, every int8 load width (a row
    stride and start that allow 16, 8, 4, 2 or 1 bytes), C = 1, 9, 64 and 1000, zero
    weights (exactly ``base``), explicit ``denom`` (float and tensor), the int8
    extremes, an unaligned ``base``; then on the edges of its launch plan, and two
    launches giving the same bits."""
    from nanofed_tpu_torch.ops._common import int8_vector_width

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


def phase_kernel_checks(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """Phase 2's checks of B1-B7 against their plain versions, in every form and layout:
    :func:`check_reduce_kernels`, :func:`check_quantize_kernels` and
    :func:`check_dequant_kernel`.  They time nothing, so they run beside (o)-(r).  Their
    launches compare kernels with their plain versions and count for no path."""
    check_reduce_kernels(torch, ops, torch.Generator(device="cuda").manual_seed(0))
    check_quantize_kernels(torch, ops, torch.Generator(device="cuda").manual_seed(11))
    check_dequant_kernel(torch, ops, torch.Generator(device="cuda").manual_seed(4))
    return {}


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


def time_dequant(torch, ops, card: str, gen, reps: int = TABLE_REPS) -> dict:
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
        wrapper_ms = host_ms(call, torch, reps=reps)
        ms = median_ms(call, torch, reps=reps)
        kernel_ms = None
        if hasattr(quantize, "dequant_launch"):
            out = torch.empty(p, device="cuda")
            launch = lambda: quantize.dequant_launch(q, q.stride(0), coefs, base, out)  # noqa: E731
            launch()
            check_close(torch, f"dequant_accumulate_flat C={c} kernel alone", out,
                        ops.dequant_accumulate_flat_plain(q, s, w, base), **TOL)
            kernel_ms = median_ms(launch, torch, reps=reps, hide_host_ms=2 * wrapper_ms + 0.5)
        plain_ms = median_ms(lambda: ops.dequant_accumulate_flat_plain(q, s, w, base), torch,
                             reps=reps)
        yard_ms = median_ms(lambda: torch.addmv(base, q.float().t(), coefs), torch, reps=reps)
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
    # Rounds: (g) drops a client from round 1 on, so it runs 2; (f) and (h) ran 2 until
    # 2026 and run 1 since, to fit the script's time limit (their checks are per round).
    configs = {
        "f_secure": dict(secure=sa.SecureAggregationConfig(min_clients=n),
                         round=dict(min_clients=n, round_timeout_s=120.0), drop=None,
                         rounds=1),
        # As run_secure.py --dropout-tolerant --drop-client 7 --drop-round 1 configures it.
        "g_dropout_tolerant": dict(
            secure=sa.SecureAggregationConfig(min_clients=n - 1, dropout_tolerant=True,
                                              threshold=n // 2 + 1),
            round=dict(min_clients=n, min_completion_rate=0.5, round_timeout_s=8.0),
            drop=n - 1, rounds=2),
        "h_plain_network": dict(secure=None, round=dict(min_clients=n, round_timeout_s=120.0),
                                drop=None, rounds=1),
    }
    totals = dict.fromkeys(ops.launch_counts(), 0)
    for name, cfg in configs.items():
        secure, drop, rounds = cfg["secure"], cfg["drop"], cfg["rounds"]
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


def program_chunk(program: str):
    """The ``client_chunk`` of a candidate's program name (``cand_chunk<k>_...``; 0 is
    None, the materialised round)."""
    return int(program.split("_")[1].removeprefix("chunk")) or None


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
                  f"rounds_per_block={o.config.rounds_per_block} lora={o.config.adapter_rank} "
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


def phase_autotune(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(i): the autotuned flagship through ``Coordinator.from_autotune`` (held against
    a hand-built coordinator with the winner's knobs; the autotuned runner is
    :func:`phase_autotune_runner`'s).  Returns its launch counts."""
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability.profiling import TIMED_CALLS
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.tuning import TuningSpace
    from nanofed_tpu_torch.utils.trees import ravel

    calls = 2 + TIMED_CALLS  # the profiler's first, counting and timed calls
    cfg = FLAGSHIP
    n = cfg["num_clients"]
    model = get_model("mnist_cnn")
    data = flagship_data()
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
    return totals


def phase_autotune_runner(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(i): the autotuned runner with the online retuner and program profiling.  No
    finding reads its sweep's seconds (the flagship sweep's ranking is PERF.md's), so it
    runs beside (o)-(r); its winner may differ from one run to the next, and its
    launches are derived from the winner it wrote.  Returns its launch counts."""
    from nanofed_tpu_torch import run_experiment
    from nanofed_tpu_torch.observability.profiling import TIMED_CALLS
    from nanofed_tpu_torch.tuning import AutotuneResult

    calls = 2 + TIMED_CALLS  # the profiler's first, counting and timed calls
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
        add_launches(want, step_launches(program_chunk(program), SECURE_CLIENTS),
                     measured["rounds"])
    check_launches("(i) runner", grew, want, oom)
    return grew


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
    data = flagship_data()
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
    from nanofed_tpu_torch.data import load_mnist, pack_eval
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.security import ValidationConfig
    from nanofed_tpu_torch.trainer import TrainingConfig

    cfg = FLAGSHIP
    test = load_mnist("test", None, synthetic_size=cfg["train_size"] // 6)
    coordinator = Coordinator(
        model=get_model("mnist_cnn"),
        train_data=flagship_data(),
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


def phase_slice(torch, ops, run_experiment, card: str, out_dir: Path,
                keep: dict | None = None, names=("a_tutorial_parity", "b_flagship",
                                                 "c_validated")) -> dict[str, int]:
    """Drive the port's entry points on the card in the configurations ``names`` of
    five ((d) and (e) time nothing and run beside (o)-(r): :func:`phase_slice_guarded`);
    return the kernels' launch counts over them (each summary into ``keep``)."""
    from nanofed_tpu_torch.orchestration import cohort_size

    n, rounds = FLAGSHIP["num_clients"], FLAGSHIP["num_rounds"]
    cohort = cohort_size(n, 0.1)
    sigma, central_privacy = dp_config(n, cohort, rounds)
    if "d_central_dp" in names:
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
    for name in names:
        cfg = configs[name]
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
        if keep is not None:
            keep[name] = summary
    return totals


def phase_slice_guarded(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(d) central DP and (e) the trimmed mean through ``run_experiment``."""
    from nanofed_tpu_torch import run_experiment

    return phase_slice(torch, ops, run_experiment, card, out_dir,
                       names=("d_central_dp", "e_robust_trimmed_mean"))


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
# (l): the DP-SGD flagship's rounds (the flagship's 2 until 2026, cut to fit the script's
# time limit: round 0 read the same as round 1, 5.01 and 4.99 s on the H100).
DP_ROUNDS = 1
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


_POPULATIONS: dict[int, object] = {}


def flagship_data(num_clients: int | None = None):
    """The flagship's population on the host: 60 synthetic MNIST samples a client.  It
    is built once a process for each size and shared: the phases only read it, and each
    coordinator places its own copy on the card."""
    from nanofed_tpu_torch.data import federate, load_mnist

    num_clients = num_clients or FLAGSHIP["num_clients"]
    if num_clients not in _POPULATIONS:
        _POPULATIONS[num_clients] = federate(
            load_mnist("train", None, synthetic_size=60 * num_clients),
            num_clients=num_clients, batch_size=FLAGSHIP["batch_size"], seed=0)
    return _POPULATIONS[num_clients]


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
    make_private_local_fit(...))``, ``client_chunk=25``, ``DP_ROUNDS``, with each client's
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

    n, rounds = FLAGSHIP["num_clients"], DP_ROUNDS
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


def phase_scaffold_trainer(torch, ops, run_experiment, card: str,
                           out_dir: Path) -> dict[str, int]:
    """(m), then (n) over (m)'s model and population.  Returns (m)'s launch counts."""
    totals, params, population = phase_scaffold(torch, ops, run_experiment, card, out_dir)
    phase_trainer(torch, ops, card, out_dir, params, population)
    return totals


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


# (s): rounds per block, and (s1), (s3)'s two blocks of the flagship.  Blocks of 4 and
# 8 rounds until 2026, cut to 2 and 4 to fit the script's time limit: (s1) still holds
# a fused run of two blocks against single rounds, and (s3) checks one block's dispatch
# and profiles the other.
FUSED_RPB = 2
FUSED_ROUNDS = 4
FUSED_COHORT_ROUNDS = 2  # (s2): one block (4 until 2026)
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
    """(s): fused multi-round blocks.  (s1) the flagship at ``FUSED_RPB`` (two blocks)
    and at 1, ``FUSED_ROUNDS`` rounds each, a second fused run for the run-to-run gap;
    (s2) a validated 10% cohort with dropout as one block against single rounds, and a block
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
# (t2): cross_silo's rounds, its benchmark's 2 reduced to 1 in 2026 to fit the script's
# time limit (a ResNet-18 f32 round takes 13.6 s; round 0 read the same as round 1).
CIFAR_SILO_ROUNDS = 1
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
    line, 1 round; (t5) B1 and B3 timed at the two new shapes ((t4) times nothing and
    runs beside (o)-(r): :func:`phase_cifar_cross_check`).  Returns the main paths'
    launch counts."""
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

    # (t2) cross_silo: ResNet-18 on CIFAR-100 at full width, 8 clients, f32 (CIFAR_SILO_ROUNDS).
    silo = BENCHMARKS["cross_silo"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    summary, wall, grew = counted(
        torch, ops, card, "(t2) run_benchmark cross_silo",
        lambda: run_benchmark("cross_silo", out_dir=str(base / "silo"), device="cuda",
                              num_rounds=CIFAR_SILO_ROUNDS),
        {"weighted_mean_flat": CIFAR_SILO_ROUNDS, "row_sq_norms": CIFAR_SILO_ROUNDS})
    silo_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start_bytes
    add_launches(totals, grew)
    check_summary("(t2)", summary, CIFAR_SILO_ROUNDS)
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

    time_cifar_reduces(torch, ops, card)
    print(f"[{card}] (t) phase wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


def phase_cifar_cross_check(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
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
    return {}  # a cross-check: its launches count for no path


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


# (u1): single flagship rounds with telemetry (4 until 2026, cut to fit the script's time
# limit: the span and record checks are per round).
OBS_ROUNDS = 2
OBS_FUSED_ROUNDS = 2 * FUSED_RPB  # (u1): two blocks at rounds_per_block = FUSED_RPB
# (u1): timed rounds a coordinator, after its warm round (3 until 2026: the on/off
# medians now take 4 rounds a side, where they took 6).
OBS_TIMED_ROUNDS = 2
OBS_NETWORK_ROUNDS = 1  # (u3): rounds of (h)'s network round with metrics (2 until 2026)
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


def obs_coordinator(base: Path, name: str, rounds_per_block: int, num_rounds: int,
                    telemetry: bool):
    """(u)'s flagship coordinator, with ``telemetry_dir`` when ``telemetry``."""
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

    return Coordinator(
        get_model("mnist_cnn"), flagship_data(),
        CoordinatorConfig(num_rounds=num_rounds, seed=0, base_dir=base / name,
                          save_metrics=False, rounds_per_block=rounds_per_block),
        flagship_training(), client_chunk=125, device="cuda",
        telemetry_dir=base / name / "telemetry" if telemetry else None)


def phase_observability(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(u1): observability on the flagship with ``telemetry_dir``: ``OBS_ROUNDS`` single
    rounds, then two blocks at ``FUSED_RPB`` (the first block's dispatch under
    the sync check, the second block under ``torch.profiler``), the spans' names and
    nesting, the ``round`` records, ``summarize_telemetry``, the occupancy gauge on
    both bases, and the round with telemetry off and on, interleaved ((u2)-(u5) time
    nothing and run beside (o)-(r): :func:`phase_observability_entry`).  Returns the
    launch counts."""
    from nanofed_tpu_torch import observability as obs
    from nanofed_tpu_torch.orchestration import RoundStatus

    t_phase = time.perf_counter()
    n, chunk, rpb = FLAGSHIP["num_clients"], 125, FUSED_RPB
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "u_observability"
    gc.collect()

    def drive(tag: str, coord, rounds: int):
        want: dict[str, int] = {}
        add_launches(want, step_launches(chunk, n), rounds)
        out, wall, grew = counted(torch, ops, card, tag, coord.run, want)
        add_launches(totals, grew)
        if [m.status for m in out] != [RoundStatus.COMPLETED] * rounds:
            fail(f"{tag}: rounds {[m.status for m in out]}")
        return out, wall

    # (u1) single rounds with telemetry.
    single = obs_coordinator(base, "single", 1, OBS_ROUNDS, True)
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
    fused = obs_coordinator(base, "fused", rpb, OBS_FUSED_ROUNDS, True)
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
        coord = obs_coordinator(base, f"overhead_{i}_{mode}", 1, 1 + OBS_TIMED_ROUNDS,
                                mode == "on")
        out, _ = drive(f"(u1) overhead run {i} telemetry {mode}", coord,
                       1 + OBS_TIMED_ROUNDS)
        timed[mode].extend(m.duration_s for m in out[1:])
        del coord
        gc.collect()
    med_off, med_on = statistics.median(timed["off"]), statistics.median(timed["on"])
    print(f"[{card}] (u1) flagship round_s telemetry off {timed['off']} (median "
          f"{med_off:.6f}), on {timed['on']} (median {med_on:.6f}); on/off "
          f"{med_on / med_off:.6f}")

    print(f"[{card}] (u) phase wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


def phase_observability_entry(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(u2) one flagship round inside ``utils.profiling.trace``; (u3) (h)'s plain
    network round with the server's ``registry=`` and ``tracer=``, clients'
    ``registry=`` and the network coordinator's ``telemetry_dir=``: ``GET /metrics``,
    bytes and trace ids; (u4) the kernel-build manifest; (u5) ``run --telemetry-dir``,
    then ``metrics-summary`` and ``trace`` on it.  They time nothing, so they run beside
    (o)-(r).  Returns the launch counts."""
    import aiohttp

    from nanofed_tpu_torch import cli
    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch import observability as obs
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.ops import _build
    from nanofed_tpu_torch.security import secure_agg as sa
    from nanofed_tpu_torch.trainer import TrainingConfig, make_local_fit
    from nanofed_tpu_torch.tuning import compile_cache
    from nanofed_tpu_torch.utils import profiling as uprof

    t_phase = time.perf_counter()
    n, chunk = FLAGSHIP["num_clients"], 125
    model = get_model("mnist_cnn")
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "u_observability"

    # (u2) one flagship round inside the capture.
    cap = obs_coordinator(base, "captured", 1, 1, True)
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
               for k in ("weighted_sum_ring", "weighted_sum_regs", "row_sq_ring",
                         "row_sq_regs")}
    print(f"[{card}] (u2) capture {trace_file.name}: {trace_file.stat().st_size} bytes, "
          f"{len(events)} events; spans found {sorted(span_names & names)}; B1/B3 kernel "
          f"names {json.dumps(kernels)}")
    if not span_names <= names:
        fail(f"(u2) spans missing from the capture: {sorted(span_names - names)}")
    if not ((kernels["weighted_sum_ring"] or kernels["weighted_sum_regs"])
            and (kernels["row_sq_ring"] or kernels["row_sq_regs"])):
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
    rounds = OBS_NETWORK_ROUNDS
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
    print(f"[{card}] (u2)-(u5) wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


LM_RANK = 8  # (v): the adapters' rank
LM_CLIENTS, LM_SEQS, LM_BATCH, LM_LR = 8, 128, 16, 0.1  # (v1)-(v3): the base flagship's cohort
LM_MERGE_TOL = 1e-5  # (v1): merged params against base + s A@B in float64
LM_FUSED_ROUNDS = 2  # (v3): at rounds_per_block 2 and 1
# (v1): bf16 rounds, the last one traced.  Reduced from 3 in 2026 to fit the script's
# time limit: round 0 is FLOP-counted and round 1 traced, where round 1 was counted too.
LM_BF16_ROUNDS = 2
LM_LARGE_CLIENTS, LM_LARGE_SEQS, LM_LARGE_CHUNK = 4, 8, 2  # (v4)
LM_RESUME_ROUNDS = 4  # (v5): closed after 2 and resumed
LM_REDUCES = (  # (v): B1 and B3 at the transformer's shapes: (C, P, form)
    (8, 1_398_784, "normalised"), (8, 97_745_408, "normalised"), (2, 7_356_416, "accumulate"))


def capture_reduces(round_step_module):
    """Record the inputs of the round step's B1 and B3 calls (the kernels' wrappers as
    the round step imported them) in a dict, for holding the kernels against their plain
    versions on the path's own delta stacks afterwards; returns the dict and an undo."""
    seen: dict[str, tuple] = {}
    names = ("weighted_mean_flat", "weighted_sum_into", "row_sq_norms")
    originals = {n: getattr(round_step_module, n) for n in names}

    def wrap(name):
        fn = originals[name]

        def recorded(*args, **kwargs):
            seen[name] = args
            return fn(*args, **kwargs)

        return recorded

    for n in names:
        setattr(round_step_module, n, wrap(n))
    return seen, lambda: [setattr(round_step_module, n, f) for n, f in originals.items()]


def hold_reduces(torch, ops, card: str, tag: str, seen: dict) -> None:
    """B1 and B3 on the delta stack a round handed them, against their plain versions."""
    for name, args in seen.items():
        if name == "weighted_sum_into":
            _, x, w = args
            got = ops.weighted_sum_into(torch.zeros(x.shape[1], device="cuda"), x, w)
            want = ops.weighted_sum_into_plain(torch.zeros(x.shape[1], device="cuda"), x, w)
        elif name == "weighted_mean_flat":
            x, w = args[0], args[1]
            got, want = ops.weighted_mean_flat(x, w), ops.weighted_mean_flat_plain(x, w)
        else:
            x = args[0]
            got, want = ops.row_sq_norms(x), ops.row_sq_norms_plain(x)
        err = check_close(torch, f"{tag} {name} on the round's deltas", got, want, **TOL)
        print(f"[{card}] {tag} {name} on the round's [{x.shape[0]}, {x.shape[1]}] delta "
              f"stack against its plain version: max_abs_err={err:.3e}")


def time_lm_reduces(torch, ops, card: str, shapes=LM_REDUCES, tag: str = "(v)") -> None:
    """B1 (normalised or accumulate) and B3 at a transformer path's ``shapes`` ((C, P,
    form); default (v)'s), in the round's layout, against their plain versions and the
    library calls, with bounds."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    for c, p, form in shapes:
        x = round_layout(torch, c, p, seed=c + p)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        if form == "accumulate":
            acc = torch.zeros(p, device="cuda")
            name = "weighted_sum_into"
            err = check_close(torch, f"{tag} {name} C={c} P={p}",
                              ops.weighted_sum_into(acc.clone(), x, w),
                              ops.weighted_sum_into_plain(acc.clone(), x, w), **TOL)
            ms = median_ms(lambda: ops.weighted_sum_into(acc, x, w), torch)
            plain_ms = median_ms(lambda: ops.weighted_sum_into_plain(acc, x, w), torch)
            library_ms = median_ms(lambda: acc.addmv_(x.t(), w), torch)
            library, moved = "acc.addmv_(x.t(), w)", 4 * c * p + 8 * p + 4 * c
        else:
            name = "weighted_mean_flat"
            err = check_close(torch, f"{tag} {name} C={c} P={p}", ops.weighted_mean_flat(x, w),
                              ops.weighted_mean_flat_plain(x, w), **TOL)
            ms = median_ms(lambda: ops.weighted_mean_flat(x, w), torch)
            plain_ms = median_ms(lambda: ops.weighted_mean_flat_plain(x, w), torch)
            library_ms = median_ms(lambda: w @ x, torch)
            library, moved = "w @ x", 4 * c * p + 4 * c + 4 * p
        b_ms, b_by = bound_ms(moved, 2 * c * p)
        print(f"[{card}] {tag} {name} C={c} P={p}: kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms={library_ms:.6f} ({library}) bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.4f} max_abs_err={err:.3e} "
              f"{plan_line(torch, x, form == 'accumulate', False)}")
        if form == "normalised":
            err = check_close(torch, f"{tag} row_sq_norms C={c} P={p}", ops.row_sq_norms(x),
                              ops.row_sq_norms_plain(x), **TOL)
            ms = median_ms(lambda: ops.row_sq_norms(x), torch)
            plain_ms = median_ms(lambda: ops.row_sq_norms_plain(x), torch)
            library_ms = median_ms(lambda: torch.linalg.vecdot(x, x), torch)
            b_ms, b_by = bound_ms(4 * c * p + 4 * c, 2 * c * p)
            print(f"[{card}] {tag} row_sq_norms C={c} P={p}: kernel_ms={ms:.6f} "
                  f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
                  f"(torch.linalg.vecdot(x, x)) bound_ms={b_ms:.6f} ({b_by}) "
                  f"share_of_bound={b_ms / ms:.4f} max_abs_err={err:.3e}")
        del x
        torch.cuda.empty_cache()


def flop_counted_rounds(torch, coord, flops: list, traced: dict | None = None) -> None:
    """Run each of ``coord``'s round steps under ``FlopCounterMode``, appending its
    counted FLOPs (matrix products, forward and backward) to ``flops``; the count is
    host work inside the round, the device busy behind it.  With ``traced``, the step
    after the counted ones (``traced["call"]``) runs under ``torch.profiler`` instead,
    and its wall, busy ms and kernels land in ``traced``."""
    from torch.utils.flop_counter import FlopCounterMode

    step = coord._round_step

    def counted_step(*args, **kwargs):
        if traced is not None and len(flops) == traced["call"]:
            out, traced["wall"], traced["busy"], traced["top"] = device_profile(
                torch, lambda: step(*args, **kwargs))
            return out
        with FlopCounterMode(display=False) as counter:
            out = step(*args, **kwargs)
        flops.append(counter.get_total_flops())
        return out

    coord._round_step = counted_step


def lm_population(num_clients: int, seqs: int, batch: int, flagship: str, seed: int = 0):
    """A flagship's token-stream population on the host: ``num_clients`` x ``seqs``."""
    from nanofed_tpu_torch.data import federate, synthetic_token_streams
    from nanofed_tpu_torch.models.transformer import FLAGSHIP_CONFIGS

    vocab, seq_len = FLAGSHIP_CONFIGS[flagship][:2]
    return federate(synthetic_token_streams(num_clients * seqs, vocab=vocab, seq_len=seq_len,
                                            seed=seed),
                    num_clients=num_clients, batch_size=batch, seed=seed)


def phase_transformer(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(v): the causal transformer LM and LoRA adapter federation.  (v1) the ``base``
    flagship with rank-8 adapters through ``Coordinator(adapter=)``, 2 rounds f32 then
    ``LM_BF16_ROUNDS`` bf16; (v2) the same cohort's dense full fine-tune, 1 round f32, and
    the wire bytes of both deltas; (v3) fused blocks against single rounds; (v4) the
    ``large`` flagship's adapter round step ((v5) runs beside (o)-(r):
    :func:`phase_transformer_entry`).  Returns the launch counts."""
    from nanofed_tpu_torch.adapters import (
        AdapterSpec,
        adapter_param_count,
        init_adapters,
        make_adapter_apply,
    )
    from nanofed_tpu_torch.adapters.evidence import measure_wire_bytes
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.models.transformer import FLAGSHIP_CONFIGS, flagship
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.parallel import FrozenBase, build_round_step, init_server_state
    from nanofed_tpu_torch.parallel import round_step as round_step_module
    from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
    from nanofed_tpu_torch.utils.trees import ravel

    t_phase = time.perf_counter()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base_dir = out_dir / "v_transformer"
    gc.collect()
    torch.cuda.empty_cache()
    spec = AdapterSpec(rank=LM_RANK)
    model = flagship("base")
    t0 = time.perf_counter()
    population = lm_population(LM_CLIENTS, LM_SEQS, LM_BATCH, "base")
    print(f"[{card}] (v) base flagship {FLAGSHIP_CONFIGS['base']} (vocab, seq, width, depth, "
          f"heads): token streams {LM_CLIENTS} x {LM_SEQS} made in "
          f"{time.perf_counter() - t0:.3f} s; device bytes allocated at the phase's start "
          f"{torch.cuda.memory_allocated()}")

    def coordinator(name: str, rounds: int, dtype=None, adapter=spec, **cfg):
        return Coordinator(
            model, population, CoordinatorConfig(num_rounds=rounds, seed=0,
                                                 base_dir=base_dir / name,
                                                 save_metrics=False, **cfg),
            TrainingConfig(batch_size=LM_BATCH, local_epochs=1, learning_rate=LM_LR,
                           compute_dtype=dtype),
            adapter=adapter, device="cuda")

    def run_rounds(tag: str, coord, flops: list, want: dict):
        """Rounds one at a time: seconds, peak device memory and loss of each (a fused
        block runs whole before its first round is yielded, so its peak is the first
        round's)."""
        rows = []
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        for metrics in _rounds_with_peaks(torch, coord, rows):
            if metrics.status != RoundStatus.COMPLETED or not math.isfinite(
                    metrics.agg_metrics["loss"]):
                fail(f"{tag}: round {metrics.round_id} {metrics.status} "
                     f"{metrics.agg_metrics}")
        torch.cuda.synchronize()
        grew = ops.launch_counts()
        print(f"[{card}] {tag}: wall_s={time.perf_counter() - t_run:.3f} launches={grew}")
        if grew != {k: want.get(k, 0) for k in grew}:
            fail(f"{tag}: kernel launches {grew}, expected {want}")
        add_launches(totals, grew)
        for i, (metrics, peak) in enumerate(rows):
            f = flops[i] if i < len(flops) else None
            rate = f"{f:.4e} FLOPs, {f / metrics.duration_s / 1e12:.3f} TFLOP/s" if f else ""
            rpb = coord.config.rounds_per_block
            peak = peak if i % rpb == 0 else "(the block's, above)"
            print(f"[{card}] {tag} round {metrics.round_id}: round_s={metrics.duration_s:.6f} "
                  f"{rate} peak_device_bytes={peak} loss={metrics.agg_metrics['loss']:.6f}")
        return rows

    # (v1) rank-8 adapters, f32 then bf16.
    coord = coordinator("v1_f32", 2)
    counts = adapter_param_count(spec, coord.base_params)
    print(f"[{card}] (v1) rank-{LM_RANK} adapters: {counts['adapter_params']:,} adapter and "
          f"{counts['base_params']:,} base parameters, ratio {counts['ratio']}")
    if (counts["adapter_params"], counts["base_params"], counts["ratio"]) != (
            1_398_784, 97_745_408, 69.88):
        fail(f"(v1) adapter counts {counts}")
    merged = coord.merged_params()
    if not all(torch.equal(merged[k], coord.base_params[k]) for k in merged):
        fail("(v1) round 0's merged params are not the base (B starts at 0)")
    del merged
    before = {k: v.clone() for k, v in coord.params.items()}
    flops: list[float] = []
    flop_counted_rounds(torch, coord, flops)
    seen, undo = capture_reduces(round_step_module)
    first_delta = {}

    def keep_first(metrics):
        if metrics.round_id == 0:
            first_delta.update({k: coord.params[k] - before[k] for k in before})

    coord.on_round_end = keep_first
    run_rounds("(v1) base flagship, adapters, f32", coord, flops,
               {"weighted_mean_flat": 2, "row_sq_norms": 2})
    undo()
    hold_reduces(torch, ops, card, "(v1)", seen)
    seen.clear()
    merged = coord.merged_params()
    gap = 0.0
    for name, leaf in coord.base_params.items():
        want = leaf.double()
        if f"{name}/A" in coord.params:
            want = want + spec.scaling * (coord.params[f"{name}/A"].double()
                                          @ coord.params[f"{name}/B"].double())
        gap = max(gap, float((merged[name].double() - want).abs().max()))
    print(f"[{card}] (v1) merged params after round 1 against base + s A@B in float64: "
          f"max_abs={gap:.3e} (tolerance {LM_MERGE_TOL})")
    if gap > LM_MERGE_TOL:
        fail(f"(v1) the merge is {gap} from its float64 recomputation")
    del merged, coord, before
    gc.collect()
    torch.cuda.empty_cache()
    coord = coordinator("v1_bf16", LM_BF16_ROUNDS, dtype="bfloat16")
    bf16_flops: list[float] = []
    traced = {"call": LM_BF16_ROUNDS - 1}
    flop_counted_rounds(torch, coord, bf16_flops, traced)
    run_rounds(f"(v1) base flagship, adapters, bf16 (round {LM_BF16_ROUNDS - 1} traced)",
               coord, bf16_flops,
               {"weighted_mean_flat": LM_BF16_ROUNDS, "row_sq_norms": LM_BF16_ROUNDS})
    busy, wall = traced["busy"], traced["wall"]
    top = "; ".join(f"{k[:80]} {t:.3f} ms ({t / busy:.1%})" for k, t in traced["top"][:6])
    print(f"[{card}] (v1) one traced bf16 adapter round step: device busy {busy:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall (busy share {busy / (wall * 1e3):.4f}); top six by "
          f"device time: {top}")
    del coord
    gc.collect()
    torch.cuda.empty_cache()

    # (v2) the dense full fine-tune of the same cohort, 1 round f32.
    dense = coordinator("v2_dense", 1, adapter=None)
    dense_before = {k: v.clone() for k, v in dense.params.items()}
    dense_flops: list[float] = []
    flop_counted_rounds(torch, dense, dense_flops)
    seen, undo = capture_reduces(round_step_module)
    run_rounds("(v2) base flagship, dense full fine-tune, f32", dense, dense_flops,
               {"weighted_mean_flat": 1, "row_sq_norms": 1})
    undo()
    hold_reduces(torch, ops, card, "(v2)", seen)
    seen.clear()
    dense_delta = {k: (dense.params[k] - dense_before[k]).cpu() for k in dense_before}
    del dense, dense_before
    gc.collect()
    torch.cuda.empty_cache()
    time_lm_reduces(torch, ops, card)

    # The wire bytes of both deltas time nothing (no finding reads the encoding's
    # seconds): the host encodes them in a thread beside (v3), from host copies, so the
    # thread makes no CUDA call.
    first_delta = {k: v.cpu() for k, v in first_delta.items()}
    encoded: dict = {}

    def encode() -> None:
        t0 = time.perf_counter()
        encoded["wire"] = measure_wire_bytes(None, dense_delta, first_delta)
        encoded["s"] = time.perf_counter() - t0

    encoder = threading.Thread(target=encode, name="v2-wire-bytes")
    encoder.start()

    # (v3) fused blocks of 2 against single rounds, bf16, and the fused run again (the
    # run-to-run gap; its first block under the sync check).
    runs, blocks = {}, {}
    for name, rpb in (("single", 1), ("fused", 2), ("fused_again", 2)):
        coord = coordinator(f"v3_{name}", LM_FUSED_ROUNDS, dtype="bfloat16",
                            rounds_per_block=rpb)
        spent: list[float] = []
        caught: dict[str, object] = {}
        if rpb > 1:
            def with_sync_check(call, caught=caught):
                out, caught["sync"] = sync_warnings(torch, call)
                return out

            block_timer(torch, coord, spent,
                        around={0: with_sync_check} if name == "fused_again" else None)
        rows = run_rounds(f"(v3) {name}, rounds_per_block={rpb}", coord, [],
                          {"weighted_mean_flat": LM_FUSED_ROUNDS,
                           "row_sq_norms": LM_FUSED_ROUNDS})
        runs[name] = (ravel(coord.params), [m for m, _ in rows])
        blocks[name] = (spent, caught.get("sync"))
        del coord
        gc.collect()
    gap = float((runs["fused"][0] - runs["fused_again"][0]).abs().max())
    diff = float((runs["fused"][0] - runs["single"][0]).abs().max())
    f_per = [m.duration_s for m in runs["fused"][1]]
    s_per = [m.duration_s for m in runs["single"][1]]
    syncs = blocks["fused_again"][1]
    print(f"[{card}] (v3) {LM_FUSED_ROUNDS} bf16 adapter rounds: single round_s={s_per}; fused "
          f"round_s={f_per} (blocks dispatch-to-device-end s={blocks['fused'][0]}); fused/"
          f"single median={statistics.median(f_per) / statistics.median(s_per):.4f}; "
          f"max|dadapters| fused vs single={diff:.3e}, fused run-to-run gap={gap:.3e} "
          f"(tolerance {CROSS_TOL} + the gap); synchronizing operations inside a block's "
          f"dispatch: {len(syncs)}{' ' + repr(syncs[:3]) if syncs else ''}")
    if diff > CROSS_TOL + gap or not torch.isfinite(runs["fused"][0]).all():
        fail(f"(v3) fused adapters differ from single rounds by {diff} (gap {gap})")
    if syncs:
        fail(f"(v3) {len(syncs)} synchronizing operations inside an adapter block's dispatch")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    encoder.join()
    if "wire" not in encoded:
        fail("(v2) encoding the wire bytes raised (its traceback is above)")
    wire = encoded["wire"]
    print(f"[{card}] (v2) wire bytes of one round's update (seed 0, top-k 5%): q8 full "
          f"{wire['q8_bytes_full']:,} adapter {wire['q8_bytes_adapter']:,} "
          f"({wire['q8_reduction']}x); topk8 full {wire['topk8_bytes_full']:,} adapter "
          f"{wire['topk8_bytes_adapter']:,} ({wire['topk8_reduction']}x); encoding took "
          f"{encoded['s']:.3f} s, beside (v3)")
    del dense_delta, first_delta, encoded

    # (v4) the large flagship's adapter round step, bf16, in client chunks.
    large = flagship("large")
    vocab, seq_len = FLAGSHIP_CONFIGS["large"][:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = large.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counts = adapter_param_count(spec, base)
    print(f"[{card}] (v4) large flagship {FLAGSHIP_CONFIGS['large']}: "
          f"{counts['base_params']:,} base parameters initialised on the card in "
          f"{init_s:.3f} s; {counts['adapter_params']:,} adapter parameters")
    adapters = init_adapters(spec, base, rng=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    # Uniform token ids drawn on the card: the Markov chain's [32768, 32768] transition
    # matrix would take longer on the host than the round itself.
    x = torch.randint(0, vocab, (LM_LARGE_CLIENTS, LM_LARGE_SEQS, seq_len), generator=gen,
                      device="cuda")
    data = ClientData(x, torch.randint(0, vocab, (LM_LARGE_CLIENTS, LM_LARGE_SEQS),
                                       generator=gen, device="cuda"),
                      torch.ones((LM_LARGE_CLIENTS, LM_LARGE_SEQS), device="cuda"))
    training = TrainingConfig(batch_size=LM_LARGE_SEQS, local_epochs=1, learning_rate=LM_LR,
                              compute_dtype="bfloat16")
    frozen = FrozenBase(None, lambda b: make_adapter_apply(large.apply, spec, b))
    perms = draw_permutations(gen, LM_LARGE_CLIENTS, 1, LM_LARGE_SEQS)
    keys = client_keys(0, LM_LARGE_CLIENTS, "cuda")
    weights = data.mask.sum(1)
    attempts = []
    for chunk in (LM_LARGE_CHUNK, 1):
        step = build_round_step(large, training, client_chunk=chunk, frozen_base=frozen)
        n = LM_LARGE_CLIENTS // chunk
        seen, undo = capture_reduces(round_step_module)
        torch.cuda.reset_peak_memory_stats()
        try:
            out, wall, grew = counted(
                torch, ops, card, f"(v4) large flagship adapter round, client_chunk={chunk}",
                lambda: step(adapters, init_server_state(fedavg_strategy(), adapters), base,
                             data, weights, perms, keys),
                {"weighted_sum_into": n, "row_sq_norms": n})
        except torch.cuda.OutOfMemoryError as e:
            attempts.append(f"client_chunk={chunk}: out of device memory at peak "
                            f"{torch.cuda.max_memory_allocated()} ({str(e).splitlines()[0]})")
            print(f"[{card}] (v4) {attempts[-1]}")
            torch.cuda.empty_cache()
            continue
        finally:
            undo()
        add_launches(totals, grew)
        loss = float(out.metrics["loss"])
        print(f"[{card}] (v4) large flagship, {LM_LARGE_CLIENTS} clients x {LM_LARGE_SEQS} "
              f"sequences, bf16, client_chunk={chunk}: round_s={wall:.6f} peak_device_bytes="
              f"{torch.cuda.max_memory_allocated()} loss={loss:.6f} (earlier attempts: "
              f"{attempts or 'none'})")
        if not (math.isfinite(loss) and torch.isfinite(ravel(out.params)).all()):
            fail("(v4) the large flagship's adapter round is not finite")
        hold_reduces(torch, ops, card, "(v4)", seen)
        break
    else:
        fail(f"(v4) the large flagship's adapter round ran out of memory: {attempts}")
    del base, adapters, data, out, seen
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[{card}] (v) phase wall_s={time.perf_counter() - t_phase:.3f}")
    return totals


def phase_transformer_entry(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(v5): the entry points at the ``evidence`` config, ``run --model transformer_lm``
    through the command line and :func:`phase_transformer_evidence`.  They time nothing,
    so they run beside (o)-(r).  Returns their launch counts."""
    from nanofed_tpu_torch import cli

    base_dir = out_dir / "v_transformer"
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    tag = "(v5) nanofed-tpu-torch run --model transformer_lm --adapter-rank 4"
    summary, wall, grew = counted(torch, ops, card, tag, lambda: cli_summary(cli, [
        "run", "--model", "transformer_lm", "--clients", "8", "--rounds", "1",
        "--adapter-rank", "4", "--out-dir", str(base_dir / "v5_cli")]),
        {"weighted_mean_flat": 1, "row_sq_norms": 1})
    add_launches(totals, grew)
    check_summary(tag, summary, 1)
    print(f"[{card}] {tag}: adapter {summary['adapter']} round_s="
          f"{summary['round_durations_s']} eval {summary['final_eval_metrics']}")
    add_launches(totals, phase_transformer_evidence(torch, ops, card, base_dir))
    return totals


def _rounds_with_peaks(torch, coord, rows: list):
    """``coord``'s rounds, each with the peak device memory over it (reset before)."""
    rounds = coord.start_training()
    while True:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            metrics = next(rounds)
        except StopIteration:
            return
        rows.append((metrics, torch.cuda.max_memory_allocated()))
        yield metrics


def phase_transformer_evidence(torch, ops, card: str, base_dir: Path) -> dict[str, int]:
    """(v5): ``Coordinator(adapter=)`` at the ``evidence`` config with a ``ModelManager``
    and a state store, closed after 2 of 4 rounds and resumed against the uninterrupted
    run; then ``autotune(adapter=)`` over ranks 4/8/16 with the chunk and batch pinned."""
    from nanofed_tpu_torch.adapters import AdapterSpec, merge_adapters
    from nanofed_tpu_torch.models.transformer import FLAGSHIP_CONFIGS, flagship
    from nanofed_tpu_torch.observability.profiling import TIMED_CALLS
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.persistence import FileStateStore, ModelManager
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.tuning import PopulationSpec, TuningSpace, autotune
    from nanofed_tpu_torch.utils.trees import flatten_with_names, ravel, tree_size

    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    model = flagship("evidence")
    population = lm_population(LM_CLIENTS, 32, 16, "evidence")
    spec = AdapterSpec(rank=LM_RANK)
    training = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.2)
    print(f"[{card}] (v5) evidence config {FLAGSHIP_CONFIGS['evidence']}: "
          f"{tree_size(model.init(torch.Generator().manual_seed(0))):,} parameters")

    def make(name: str, **kw):
        return Coordinator(model, population,
                           CoordinatorConfig(num_rounds=LM_RESUME_ROUNDS, seed=0,
                                             base_dir=base_dir / name, save_metrics=False),
                           training, adapter=spec, device="cuda", **kw)

    want = {"weighted_mean_flat": 2 * LM_RESUME_ROUNDS, "row_sq_norms": 2 * LM_RESUME_ROUNDS}

    def both_runs():
        manager = ModelManager(base_dir / "v5_models")
        whole = make("v5_whole", model_manager=manager)
        whole.run()
        store = FileStateStore(base_dir / "v5_store")
        first = make("v5_first", state_store=store)
        rounds = first.start_training()
        next(rounds), next(rounds)
        rounds.close()
        resumed = make("v5_resumed", state_store=FileStateStore(base_dir / "v5_store"))
        if resumed.current_round != 2:
            fail(f"(v5) resumed at round {resumed.current_round}, not 2")
        resumed.run()
        return whole, resumed, manager

    (whole, resumed, manager), wall, grew = counted(
        torch, ops, card, "(v5) Coordinator(adapter=), uninterrupted and resumed", both_runs,
        want)
    add_launches(totals, grew)
    gap = float((ravel(whole.params) - ravel(resumed.params)).abs().max())
    params, version = manager.load_model()
    merged = merge_adapters(whole.base_params, whole.params, spec)
    published = max(float((params[k].cuda() - merged[k]).abs().max()) for k in merged)
    meta = json.loads(Path(version.config_path).read_text())["metadata"]
    ckpt = FileStateStore(base_dir / "v5_store").restore_latest()
    ckpt_leaves = sorted(flatten_with_names(ckpt.params))
    print(f"[{card}] (v5) resumed after 2 of {LM_RESUME_ROUNDS} rounds against uninterrupted: "
          f"max|dadapters|={gap:.3e} (tolerance {RESUME_TOL}); versioned model round "
          f"{version.round_number}: merged params, max|d| against the live merge "
          f"{published:.3e}, metadata adapter {meta.get('adapter')}; checkpoint leaves "
          f"{len(ckpt_leaves)} adapter leaves ({ckpt_leaves[0]} ...); merges "
          f"{whole._merge_count}")
    if gap > RESUME_TOL or published > 1e-6 or meta.get("adapter") != spec.to_dict():
        fail("(v5) the resumed run, or the versioned model, is not what it should be")
    if ckpt_leaves != sorted(whole.params):
        fail("(v5) the checkpoint does not hold the adapters")
    del whole, resumed, params, merged
    gc.collect()

    pop = PopulationSpec.from_client_data(population)
    space = dataclasses.replace(TuningSpace.default(pop, 1, 16, 1, adapter_rank=LM_RANK),
                                client_chunks=(None,), batch_sizes=(16,))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = autotune(model, pop, training, space=space, adapter=spec,
                      cache_dir=base_dir / "v5_cache", out_dir=base_dir / "v5_sweep",
                      device="cuda")
    torch.cuda.synchronize()
    grew = ops.launch_counts()
    print(f"[{card}] (v5) autotune(adapter=AdapterSpec(rank=8)): wall_s="
          f"{time.perf_counter() - t0:.3f} launches={grew}")
    want, oom = sweep_launches(result.to_dict(), LM_CLIENTS, 2 + TIMED_CALLS)
    check_launches("(v5) autotune(adapter=)", grew, want, oom)
    add_launches(totals, grew)
    print_sweep(card, "(v5)", result)
    ranks = sorted(o.config.adapter_rank for o in result.outcomes if o.feasible)
    if ranks != [4, 8, 16]:
        fail(f"(v5) the rank sweep profiled ranks {ranks}, not 4, 8 and 16")
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
    phase_transformer_cross_check(torch, ops, card)


def phase_transformer_cross_check(torch, ops, card: str) -> None:
    """(v6): a tiny transformer's frozen-base adapter round (vocab 256, seq 32, width 64,
    depth 2, rank 4, 8 clients, f32) on the card and on the CPU from the same inputs."""
    from nanofed_tpu_torch.adapters import AdapterSpec, init_adapters, make_adapter_apply
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.data import federate, synthetic_token_streams
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import FrozenBase, build_round_step, init_server_state
    from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
    from nanofed_tpu_torch.utils.trees import ravel

    model = get_model("transformer_lm", vocab=256, seq_len=32, width=64, depth=2, heads=4)
    spec = AdapterSpec(rank=4)
    host = federate(synthetic_token_streams(8 * 32, seed=5), 8, batch_size=16)
    base = model.init(torch.Generator().manual_seed(0))
    adapters = init_adapters(spec, base, rng=1)
    perms = draw_permutations(torch.Generator().manual_seed(1), 8, 2, host.y.shape[1])
    training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.3)
    step = build_round_step(model, training, fedavg_strategy(), frozen_base=FrozenBase(
        None, lambda b: make_adapter_apply(model.apply, spec, b)))
    results = {}
    for dev in ("cuda", "cpu"):
        device = torch.device(dev)
        data = ClientData(*host).to(device)
        ad = {k: v.to(device) for k, v in adapters.items()}
        ops.reset_launch_counts()
        results[dev] = step(ad, init_server_state(fedavg_strategy(), ad),
                            {k: v.to(device) for k, v in base.items()}, data,
                            data.mask.sum(1), perms.to(device), client_keys(7, 8, device))
        if dev == "cuda":
            torch.cuda.synchronize()
            grew = ops.launch_counts()
            want = {k: {"weighted_mean_flat": 1, "row_sq_norms": 1}.get(k, 0) for k in grew}
            if grew != want:
                fail(f"(v6) adapter round: launches {grew}, expected {want}")
    got = ravel(results["cuda"].params).cpu()
    diff = float((got - ravel(results["cpu"].params)).abs().max())
    loss_diff = abs(float(results["cuda"].metrics["loss"]) - float(results["cpu"].metrics["loss"]))
    print(f"[{card}] (v6) cross-check, tiny transformer adapter round (8 clients, 2 epochs of 2 "
          f"steps, f32) cuda vs cpu: max|dadapters|={diff:.3e} |dloss|={loss_diff:.3e} "
          f"(tolerance {CROSS_TOL})")
    if not (torch.isfinite(got).all() and diff <= CROSS_TOL and loss_diff <= CROSS_TOL):
        fail("(v6) the adapter round on the card disagrees with the CPU")


MESH_CHUNK = 125  # (w1), (w2): the flagship's client_chunk; (w2)'s 250 clients a rank
MESH_TOL = 1e-5  # (w2): a 4-rank round against one rank (sums over ranks in another order)
LM_MESH_CHUNK = 2  # (w3): each rank of the (1, 2) mesh fits all 8 clients, 2 at a time
MESH_STATE_SHARE = (0.45, 0.55)  # (w3): a rank's model state against the one-rank state
MESH_REDUCES = ((2, 97_745_408), (2, 1_398_784))  # (w3): B1 accumulate and B3 a chunk
MESH_VALIDATED_C = 250  # (w2): B2's denom form over one rank's rows


def flagship_coordinator(base_dir, rounds: int = FLAGSHIP["num_rounds"], **kw):
    """(b)'s configuration through ``Coordinator``: the flagship, ``client_chunk=125``."""
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

    return Coordinator(
        get_model("mnist_cnn"), flagship_data(),
        CoordinatorConfig(num_rounds=rounds, seed=0, base_dir=base_dir, save_metrics=False),
        flagship_training(), client_chunk=MESH_CHUNK, device="cuda", **kw)


class CollectiveTimer:
    """Times (synchronized) and sizes every all-reduce and all-gather a rank's mesh
    runs while entered."""

    def __init__(self, torch):
        import torch.distributed as dist

        from nanofed_tpu_torch.parallel import mesh

        self.totals = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0]}
        self._undo = []

        def timed(kind, fn):
            def call(out, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(out, *args, **kwargs)
                torch.cuda.synchronize()
                row = self.totals[kind]
                row[0] += 1
                row[1] += out.numel() * out.element_size()
                row[2] += time.perf_counter() - t0
                return res
            return call

        for owner, attr, kind in ((dist, "all_reduce", "all_reduce"),
                                  (mesh, "_gather_into", "all_gather")):
            original = getattr(owner, attr)
            setattr(owner, attr, timed(kind, original))
            self._undo.append((owner, attr, original))

    def close(self):
        for owner, attr, original in self._undo:
            setattr(owner, attr, original)


def state_bytes(torch, coord) -> int:
    """Bytes of a coordinator's params and tensor server state on its device."""
    return (sum(v.numel() * v.element_size() for v in coord.params.values())
            + sum(v.numel() * v.element_size() for v in coord.server_state.values()
                  if torch.is_tensor(v)))


def mesh_flagship_rank(rank: int, world: int, mesh_shape, out_dir: str, validated: bool):
    """(w1), (w2): the flagship on ``mesh_shape`` as one rank of the world, cuDNN's
    deterministic algorithms; with ``validated``, then one validated round (B2)."""
    import torch
    import torch.distributed as dist

    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.security import ValidationConfig

    torch.backends.cudnn.deterministic = True
    coord = flagship_coordinator(Path(out_dir) / f"w{world}", mesh_shape=mesh_shape)
    timer = CollectiveTimer(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rounds = coord.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    timer.close()
    out = {
        "round_s": [m.duration_s for m in rounds],
        "loss": [m.agg_metrics["loss"] for m in rounds],
        "counts": counts, "collectives": timer.totals,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "params": {k: v.cpu().numpy() for k, v in coord.full_params().items()},
    }
    if world == 1:
        # The mesh of one rank runs no collective: NCCL's own all-reduce of the [P]
        # aggregate over the world of one, timed alone.
        x = torch.ones(P_MNIST, device="cuda")
        out["nccl_allreduce_ms"] = median_ms(lambda: dist.all_reduce(x), torch)
    if validated:
        del coord
        coord = flagship_coordinator(Path(out_dir) / f"w{world}v", rounds=1,
                                     mesh_shape=mesh_shape, validation=ValidationConfig())
        ops.reset_launch_counts()
        (metrics,) = coord.run()
        torch.cuda.synchronize()
        out["validated_counts"] = ops.launch_counts()
        out["validated"] = {k: metrics.agg_metrics[k] for k in
                            ("loss", "valid_clients", "participating_clients")}
    return out


def lm_mesh_coordinator(base_dir, adapter, population, **kw):
    """(w3): the ``base`` flagship's cohort (8 clients of 128 sequences), FedAdam, one
    round in f32 in chunks of 2; dense, or rank-8 adapters over the frozen base."""
    from nanofed_tpu_torch.adapters import AdapterSpec
    from nanofed_tpu_torch.aggregation import fedadam_strategy
    from nanofed_tpu_torch.models.transformer import flagship
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.trainer import TrainingConfig

    return Coordinator(
        flagship("base"), population,
        CoordinatorConfig(num_rounds=1, seed=0, base_dir=base_dir, save_metrics=False),
        TrainingConfig(batch_size=LM_BATCH, local_epochs=1, learning_rate=LM_LR),
        strategy=fedadam_strategy(), client_chunk=LM_MESH_CHUNK,
        adapter=AdapterSpec(rank=LM_RANK) if adapter else None, device="cuda", **kw)


def run_lm_mesh(torch, ops, coord) -> dict:
    """One (w3) round with deterministic algorithms: state bytes before and after, the
    peak, the launches, the gathered params."""
    torch.cuda.synchronize()
    before = state_bytes(torch, coord)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (metrics,) = coord.run()
    torch.cuda.synchronize()
    return {
        "round_s": time.perf_counter() - t0, "loss": metrics.agg_metrics["loss"],
        "counts": ops.launch_counts(), "state_before": before,
        "state_after": state_bytes(torch, coord),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "params": coord.full_params(),
    }


def mesh_lm_rank(rank: int, world: int, out_dir: str) -> list[dict]:
    """(w3): the ``base`` round on the (1, 2) mesh as one rank, dense then with
    adapters; rank 0 saves the gathered params for the parent to hold against one
    rank's."""
    import torch

    from nanofed_tpu_torch import ops

    torch.use_deterministic_algorithms(True, warn_only=True)
    population = lm_population(LM_CLIENTS, LM_SEQS, LM_BATCH, "base")
    outs = []
    for adapter in (False, True):
        coord = lm_mesh_coordinator(Path(out_dir) / f"w3_{rank}_{adapter}", adapter,
                                    population, mesh_shape=(1, 2))
        out = run_lm_mesh(torch, ops, coord)
        del coord
        params = out.pop("params")
        if rank == 0:
            torch.save({k: v.cpu() for k, v in params.items()},
                       Path(out_dir) / f"w3_{'adapter' if adapter else 'dense'}.pt")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        outs.append(out)
    return outs


def spawned(torch, card: str, tag: str, fn, world: int, backend: str, args=()) -> list:
    """``fn`` on a new world of ranks on the card; a failing rank fails the script."""
    from nanofed_tpu_torch.parallel.launch import spawn_world

    t0 = time.perf_counter()
    try:
        out = spawn_world(fn, world, backend=backend, device="cuda", timeout_s=300, args=args)
    except (RuntimeError, TimeoutError) as e:
        fail(f"{tag}: {e}")
    print(f"[{card}] {tag}: world of {world} over {backend} ran in "
          f"{time.perf_counter() - t0:.3f} s")
    return out


def rank_counts(results: list, key: str = "counts") -> dict:
    total: dict[str, int] = {}
    for r in results:
        add_launches(total, r[key])
    return total


def time_mesh_reduces(torch, ops, card: str) -> None:
    """(w) B2's ``denom`` form at a (w2) rank's validated rows, and B1's accumulate form
    and B3 at (w3)'s chunks, against their plain versions and the library calls, with
    bounds."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    c, p = MESH_VALIDATED_C, P_MNIST
    x = round_layout(torch, c, p, seed=c)
    poison(x)
    w = torch.rand(c, device="cuda", generator=gen) + 0.5
    valid = torch.rand(c, device="cuda", generator=gen) > 0.1
    denom = (w * valid).sum() * 4  # the cohort's valid weight over four ranks
    err = check_close(torch, "(w) masked_weighted_mean_flat denom",
                      ops.masked_weighted_mean_flat(x, w, valid, denom=denom),
                      ops.masked_weighted_mean_flat_plain(x, w, valid, denom=denom), **TOL)
    ms = median_ms(lambda: ops.masked_weighted_mean_flat(x, w, valid, denom=denom), torch)
    plain_ms = median_ms(
        lambda: ops.masked_weighted_mean_flat_plain(x, w, valid, denom=denom), torch)
    b_ms, b_by = bound_ms(4 * c * p + 4 * c + c + 4 * p + 4, 2 * c * p)
    print(f"[{card}] (w) masked_weighted_mean_flat denom form C={c} P={p}: kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} library_ms=none bound_ms={b_ms:.6f} ({b_by}) "
          f"share_of_bound={b_ms / ms:.4f} max_abs_err={err:.3e} "
          f"{plan_line(torch, x, False, True)}")
    del x
    for c, p in MESH_REDUCES:
        x = round_layout(torch, c, p, seed=c + p)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        acc = torch.zeros(p, device="cuda")
        err = check_close(torch, f"(w) weighted_sum_into C={c} P={p}",
                          ops.weighted_sum_into(acc.clone(), x, w),
                          ops.weighted_sum_into_plain(acc.clone(), x, w), **TOL)
        ms = median_ms(lambda: ops.weighted_sum_into(acc, x, w), torch)
        plain_ms = median_ms(lambda: ops.weighted_sum_into_plain(acc, x, w), torch)
        library_ms = median_ms(lambda: acc.addmv_(x.t(), w), torch)
        b_ms, b_by = bound_ms(4 * c * p + 8 * p + 4 * c, 2 * c * p)
        print(f"[{card}] (w) weighted_sum_into C={c} P={p}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} (acc.addmv_(x.t(), w)) "
              f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
              f"max_abs_err={err:.3e} {plan_line(torch, x, True, False)}")
        err = check_close(torch, f"(w) row_sq_norms C={c} P={p}", ops.row_sq_norms(x),
                          ops.row_sq_norms_plain(x), **TOL)
        ms = median_ms(lambda: ops.row_sq_norms(x), torch)
        plain_ms = median_ms(lambda: ops.row_sq_norms_plain(x), torch)
        library_ms = median_ms(lambda: torch.linalg.vecdot(x, x), torch)
        b_ms, b_by = bound_ms(4 * c * p + 4 * c, 2 * c * p)
        print(f"[{card}] (w) row_sq_norms C={c} P={p}: kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"(torch.linalg.vecdot(x, x)) bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.4f} max_abs_err={err:.3e}")
        del x, acc
        torch.cuda.empty_cache()


def max_abs_gap(torch, a: dict, b: dict) -> float:
    return max(float((torch.as_tensor(a[k]).double() - torch.as_tensor(b[k]).double())
                     .abs().max()) for k in b)


def phase_mesh(torch, ops, card: str, out_dir: Path, slice_runs: dict) -> dict[str, int]:
    """(w) and (x), the sharded round across ranks (``parallel.mesh``) on the one card.
    (w1) this process as a world of one rank over NCCL: the flagship through
    ``Coordinator(mesh_shape=(1,))``, bit for bit the unsharded coordinator's run of
    (b)'s configuration; two NCCL ranks on one card refused; then one world of four
    ranks on ``cuda:0`` over gloo runs (w2), mesh (2, 2, 1): the same flagship (250
    clients a rank, 2 chunks each) within 1e-5 of (w1), every rank's params the same
    bits, the collectives' seconds and bytes, then one validated round (B2 on a rank's
    rows); and then (x1)-(x3) (:func:`check_scaffold_mesh`); (w4) ``--model-shards 2``
    on one rank (its ``torchrun`` run is :func:`start_beside`'s).  (w3), (x1)'s (1, 2)
    mesh and (x4) time nothing and run beside (o)-(r) (:func:`phase_mesh_pairs`).
    Returns the launch counts of every rank's main paths and this process's."""
    import contextlib
    import io

    import torch.distributed as dist

    from nanofed_tpu_torch import cli
    from nanofed_tpu_torch.parallel.mesh import initialize_distributed
    from nanofed_tpu_torch.persistence import FileStateStore

    t_phase = time.perf_counter()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base_dir = out_dir / "w_mesh"
    base_dir.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    p = P_MNIST
    flagship_counts = {"weighted_sum_into": 16, "row_sq_norms": 16}

    # (w0) (b)'s configuration on one device, unsharded, deterministic algorithms.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        unsharded = flagship_coordinator(base_dir / "w0")
        rounds, _, grew = counted(torch, ops, card, "(w0) flagship, unsharded",
                                  unsharded.run, flagship_counts)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    add_launches(totals, grew)
    want = {k: v.cpu() for k, v in unsharded.params.items()}
    del unsharded
    gc.collect()
    torch.cuda.empty_cache()
    w0_rounds = [m.duration_s for m in rounds]
    b_rounds = slice_runs["b_flagship"]["round_durations_s"]

    # (w1) this process as a world of one rank over NCCL.
    t0 = time.perf_counter()
    initialize_distributed("nccl", init_method=f"file://{base_dir / 'w1_rendezvous'}",
                           world_size=1, rank=0, device="cuda")
    try:
        w1 = mesh_flagship_rank(0, 1, (1,), str(base_dir), False)
        torch.backends.cudnn.deterministic = deterministic
    finally:
        dist.destroy_process_group()
    add_launches(totals, w1["counts"])
    same = all(torch.equal(torch.from_numpy(w1["params"][k]), want[k]) for k in want)
    print(f"[{card}] (w1) flagship on a world of one rank over NCCL ({time.perf_counter() - t0:.3f} s): "
          f"round_s={w1['round_s']} ((b) {b_rounds}, (w0) unsharded {w0_rounds}); params "
          f"bit-equal to (w0): {same}; launches={w1['counts']}; NCCL all-reduce of the [P] "
          f"f32 aggregate ({4 * p} bytes) at world 1: {w1['nccl_allreduce_ms']:.6f} ms; "
          f"peak_device_bytes={w1['peak_bytes']}")
    if not same:
        fail(f"(w1) the one-rank mesh run is {max_abs_gap(torch, w1['params'], want):.3e} "
             "from the unsharded run, not bit-equal")
    if w1["counts"] != {k: flagship_counts.get(k, 0) for k in w1["counts"]}:
        fail(f"(w1) kernel launches {w1['counts']}")

    # Two NCCL ranks on one card: refused before any process group, never gloo.
    try:
        initialize_distributed("nccl", init_method=f"file://{base_dir / 'w_refused'}",
                               world_size=2, rank=0, device="cuda")
        fail("(w) two NCCL ranks on one card were not refused")
    except RuntimeError as e:
        refused = ("NCCL refuses two ranks" in str(e)
                   and torch.cuda.get_device_name(0) in str(e) and not dist.is_initialized())
        print(f"[{card}] (w) a rank of two NCCL ranks on one card refused before the process "
              f"group, naming the card: {refused} ({e})")
        if not refused:
            fail(f"(w) two NCCL ranks failed otherwise: {e}")

    # (x1)'s one-rank checkpoint, which the world resumes on (2, 2, 1): two rounds of the
    # 100-client population, written before the world starts.
    torch.backends.cudnn.deterministic = True
    try:
        one = scaffold_coordinator(base_dir / "x1_one", flagship_data(SCAFFOLD_RESUME_CLIENTS),
                                   rounds=2,
                                   state_store=FileStateStore(base_dir / "x1_one_ckpt"))
        _, _, grew = counted(torch, ops, card, "(x1) population 100 on one rank, 2 rounds",
                             one.run, scaffold_launches(2))
        add_launches(totals, grew)
        one_state = controls_state(torch, one)
        del one
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()

    # (w2) then (x1)-(x3): one world of four ranks on cuda:0 over gloo.
    quad = spawned(torch, card, "(w2) flagship on (2, 2, 1), then (x1)-(x3) SCAFFOLD, "
                   "profiles and a block", quad_rank, 4, "gloo", args=(str(base_dir),))
    w2 = [r["w2"] for r in quad]
    add_launches(totals, rank_counts(w2))
    add_launches(totals, rank_counts(w2, "validated_counts"))
    gap = max_abs_gap(torch, w2[0]["params"], w1["params"])
    ranks_same = all(all(torch.equal(torch.from_numpy(r["params"][k]),
                                     torch.from_numpy(w2[0]["params"][k]))
                         for k in w2[0]["params"]) for r in w2[1:])
    for i, r in enumerate(w2):
        ar, ag = r["collectives"]["all_reduce"], r["collectives"]["all_gather"]
        print(f"[{card}] (w2) rank {i}: round_s={r['round_s']} launches={r['counts']} "
              f"all_reduce {ar[0]} calls, {ar[1]} bytes, {ar[2]:.6f} s; all_gather {ag[0]} "
              f"calls, {ag[1]} bytes, {ag[2]:.6f} s (2 rounds, each call synchronized, "
              f"waits for the other ranks included); peak_device_bytes={r['peak_bytes']}; "
              f"validated round {r['validated']} launches={r['validated_counts']}")
        if r["counts"] != {k: {"weighted_sum_into": 4, "row_sq_norms": 4}.get(k, 0)
                           for k in r["counts"]}:
            fail(f"(w2) rank {i} kernel launches {r['counts']}")
        if r["validated_counts"] != {k: int(k == "masked_weighted_mean_flat")
                                     for k in r["validated_counts"]}:
            fail(f"(w2) rank {i} validated round launches {r['validated_counts']}")
    print(f"[{card}] (w2) 4 ranks against (w1): max_abs={gap:.3e} (tolerance {MESH_TOL}); "
          f"every rank's params the same bits: {ranks_same}")
    if gap > MESH_TOL or not ranks_same:
        fail(f"(w2) params {gap} from (w1), ranks bit-identical: {ranks_same}")

    add_launches(totals, check_scaffold_mesh(torch, ops, card, base_dir,
                                             [r["x"] for r in quad], one_state))
    del quad, w2, one_state

    # (w4) --model-shards 2 on one rank.
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code = cli.main(["run", "--model-shards", "2", "--model", "mlp", "--clients", "8",
                         "--rounds", "1", "--train-size", "480", "--batch-size", "20",
                         "--out-dir", str(base_dir / "w4_refused")])
    message = ("model_shards=2 does not divide the 1 available devices — the 2-D mesh needs "
               "a full (devices/N, N) clients x model grid")
    print(f"[{card}] (w4) run --model-shards 2 on one rank: exit {code}, the JAX "
          f"validator's message: {message in err.getvalue()}")
    if code != 2 or message not in err.getvalue():
        fail(f"(w4) --model-shards 2 on one rank: exit {code} {err.getvalue()[-1000:]}")

    time_mesh_reduces(torch, ops, card)
    time_rank_mean(torch, ops, card)
    print(f"[{card}] (w) and (x) ranks share one card over gloo: these times are not a "
          f"multi-card round's; phase wall_s={time.perf_counter() - t_phase:.1f}")
    return totals


def quad_rank(rank: int, world: int, out_dir: str) -> dict:
    """(w2) then (x1)-(x3) as one rank of a world of four: one start-up for both."""
    import torch

    out = {"w2": mesh_flagship_rank(rank, world, (2, 2, 1), out_dir, True)}
    gc.collect()
    torch.cuda.empty_cache()
    out["x"] = scaffold_mesh_rank(rank, world, out_dir)
    return out


def lm_mesh_refs(torch, ops, base_dir: Path, totals: dict) -> list[dict]:
    """(w3)'s references: the base transformer's dense and adapter rounds on one rank
    (this process, no process group: the same mesh code), deterministic algorithms."""
    population = lm_population(LM_CLIENTS, LM_SEQS, LM_BATCH, "base")
    refs = []
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    for adapter in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            one = lm_mesh_coordinator(base_dir / f"w3_one_{adapter}", adapter, population,
                                      mesh_shape=(1,))
            ref = run_lm_mesh(torch, ops, one)
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        del one
        add_launches(totals, ref["counts"])
        ref["params"] = {k: v.cpu() for k, v in ref["params"].items()}
        refs.append(ref)
    del population
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def check_lm_mesh(torch, card: str, base_dir: Path, refs: list, ranks: list,
                  totals: dict) -> None:
    """(w3): the (1, 2) mesh's dense and adapter rounds each bit for bit one rank's
    (``refs``), each rank's model state and peak memory; ``ranks`` are the ranks'
    records of :func:`mesh_lm_rank`."""
    for j, adapter in enumerate((False, True)):
        tag = f"(w3) base {'adapter' if adapter else 'dense'} FedAdam round"
        ref = refs[j]
        add_launches(totals, rank_counts([r[j] for r in ranks]))
        got = torch.load(base_dir / f"w3_{'adapter' if adapter else 'dense'}.pt")
        same = all(torch.equal(got[k], ref["params"][k]) for k in ref["params"])
        gap = 0.0 if same else max_abs_gap(torch, got, ref["params"])
        print(f"[{card}] {tag} on one rank: round_s={ref['round_s']:.3f} "
              f"loss={ref['loss']:.6f} model state {ref['state_after']} bytes "
              f"peak_device_bytes={ref['peak_bytes']} launches={ref['counts']}")
        for i, rank_out in enumerate(ranks):
            r = rank_out[j]
            share = r["state_after"] / ref["state_after"]
            print(f"[{card}] {tag}, rank {i} of (1, 2): round_s={r['round_s']:.3f} "
                  f"loss={r['loss']:.6f} model state between rounds {r['state_before']} -> "
                  f"{r['state_after']} bytes ({share:.4f} of one rank's) "
                  f"peak_device_bytes={r['peak_bytes']} launches={r['counts']}")
            if not MESH_STATE_SHARE[0] <= share <= MESH_STATE_SHARE[1]:
                fail(f"{tag}: rank {i} holds {share:.4f} of the one-rank model state")
            if r["counts"] != ref["counts"]:
                fail(f"{tag}: rank {i} launches {r['counts']}, one rank {ref['counts']}")
        print(f"[{card}] {tag}: the (1, 2) mesh's params bit-equal to one rank's: {same} "
              f"(max_abs {gap:.3e})")
        if not same:
            fail(f"{tag}: the (1, 2) mesh is {gap} from one rank, not bit-equal")
        del got


SCAFFOLD_MESH_SHAPE = (2, 2, 1)  # (x1), (x2), (x3)
SCAFFOLD_MESH_TOL = 1e-5  # (x1): four ranks against one rank given the same cohorts
# (x1), (x3) train in float32: a bf16 fit turns a float32 ulp of the reduce's other
# summation order into a bf16 ulp, and SCAFFOLD's (2, 2, 1) run drifts 1.2e-5 from one
# rank after its second round (scripts/scaffold_mesh_drift.py).
MESH_DTYPE = "float32"
MESH_BLOCK_RPB = 4  # (x3): one fused block of the flagship, cohorts drawn on the card
MESH_BLOCK_COHORT = 5  # (x3): a fifth of the population a round, so each rank streams chunks
MESH_BLOCK_TOL = 1e-5  # (x3): against the one-device block with the same seeds
FED_CLIENTS = 4  # (x4): HTTP clients a host
FED_K = 4  # (x4): each host's FedBuff drain
FED_TOL = 1e-5  # (x4): the two hosts' reduce against one server draining the union


def scaffold_coordinator(base_dir, data, rounds: int = SCAFFOLD_ROUNDS, **kw):
    """(m)'s configuration through ``Coordinator(scaffold=True)``: ``mnist_cnn``, 10%
    cohorts in chunks of 25, trained in ``MESH_DTYPE``."""
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

    return Coordinator(
        get_model("mnist_cnn"), data,
        CoordinatorConfig(num_rounds=rounds, participation_rate=0.1, seed=0,
                          base_dir=base_dir, save_metrics=False),
        dataclasses.replace(flagship_training(), compute_dtype=MESH_DTYPE),
        client_chunk=SCAFFOLD_CHUNK, device="cuda", scaffold=True, **kw)


def controls_state(torch, coord) -> dict:
    """A SCAFFOLD coordinator's whole state on the host (a collective on a mesh)."""
    c_global, c_stack = coord.full_controls()
    state = coord.full_server_state()
    return {"params": {k: v.cpu() for k, v in coord.full_params().items()},
            "state": {k: v.cpu() for k, v in state.items() if torch.is_tensor(v)},
            "c_global": c_global.cpu(), "c_stack": c_stack.cpu()}


def same_state(torch, a: dict, b: dict) -> bool:
    return all(torch.equal(a[part][k], b[part][k]) for part in ("params", "state")
               for k in b[part]) and all(torch.equal(a[k], b[k]) for k in ("c_global", "c_stack"))


def mesh_block(torch, mesh, rounds: int):
    """(x3): one fused block of the flagship's 20% cohorts drawn on the card in chunks of
    25, in ``MESH_DTYPE``, on ``mesh`` (this rank's host rows) or one device; its
    params, ids and launches."""
    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.aggregation import fedavg_strategy
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import build_round_block, init_server_state, round_seeds
    from nanofed_tpu_torch.parallel.mesh import MeshLayout, host_client_slice

    model, data = get_model("mnist_cnn"), flagship_data()
    n = FLAGSHIP["num_clients"]
    full = {k: v.to("cuda") for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    layout = None if mesh is None else MeshLayout(mesh, full)
    block = build_round_block(
        model, dataclasses.replace(flagship_training(), compute_dtype=MESH_DTYPE),
        fedavg_strategy(), num_clients=n,
        step_clients=n // MESH_BLOCK_COHORT, cohort_size=n // MESH_BLOCK_COHORT,
        client_chunk=SCAFFOLD_CHUNK, device="cuda", mesh=mesh,
        params_like=full)
    lo, hi = (0, n) if mesh is None else host_client_slice(n, mesh)
    rows = data.select(slice(lo, hi)).to(torch.device("cuda"))
    num_samples = torch.as_tensor(data.mask.sum(1), device="cuda")
    gp = full if layout is None else layout.shard_params(full)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = block(gp, init_server_state(fedavg_strategy(), gp), rows, num_samples,
                round_seeds(0, range(rounds)), [1.0] * rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    params = res.params if layout is None else layout.gather_full(res.params)
    return {"params": {k: v.cpu() for k, v in params.items()}, "ids": res.cohort_ids.cpu(),
            "loss": res.metrics["loss"].cpu(), "counts": counts, "wall_s": wall,
            "exchange_bytes": block.cohort_exchange_bytes}


def as_numpy(tree):
    """Tensors in nested dicts and lists as numpy arrays: what a rank hands back to the
    parent (a tensor would cross the queue as shared memory the exiting rank frees)."""
    import torch

    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_numpy(v) for v in tree)
    return tree


def published_programs() -> dict:
    from nanofed_tpu_torch.observability import get_registry

    out = {}
    for line in get_registry().render_prometheus().splitlines():
        if line.startswith("nanofed_program_") and "{" in line:
            out[line.split(" ")[0]] = float(line.split(" ")[-1])
    return out


def scaffold_mesh_rank(rank: int, world: int, out_dir: str) -> dict:
    """(x1)-(x3) as one rank of four on (2, 2, 1): SCAFFOLD at (m)'s configuration, its
    programs profiled in lockstep, a 100-client run checkpointed by rank 0 and a
    one-rank checkpoint resumed here, then a fused block drawing its cohorts on the
    card; cuDNN's deterministic algorithms throughout."""
    import torch

    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.parallel.mesh import make_mesh
    from nanofed_tpu_torch.persistence import FileStateStore

    torch.backends.cudnn.deterministic = True
    out_dir = Path(out_dir)
    mesh = make_mesh(SCAFFOLD_MESH_SHAPE, device="cuda")
    coord = scaffold_coordinator(out_dir / "x1", flagship_data(), mesh=mesh)
    # Each round's host-local draw and its slot layout, for the one-rank reference.
    cohorts = [coord._sample_cohort(r) for r in range(SCAFFOLD_ROUNDS)]
    out = {"cohorts": cohorts, "slots": [coord._place_cohort(c) for c in cohorts],
           "stack_bytes": coord.c_stack.numel() * coord.c_stack.element_size()}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rounds = coord.run()
    torch.cuda.synchronize()
    out["counts"] = ops.launch_counts()
    out["round_s"] = [m.duration_s for m in rounds]
    out["loss"] = [m.agg_metrics["loss"] for m in rounds]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["exchange_bytes"] = coord.control_exchange_bytes
    out["params"] = {k: v.cpu() for k, v in coord.full_params().items()}
    out["c_global"] = coord.full_c_global().cpu()
    # (x2) every program profiled on every rank in lockstep; rank 0 publishes.
    t0 = time.perf_counter()
    reports = coord.profile_programs()
    out["profile_s"] = time.perf_counter() - t0
    out["reports"] = [r.to_dict() for r in reports]
    out["published"] = published_programs()
    del coord
    gc.collect()
    torch.cuda.empty_cache()
    # A 100-client population: three rounds checkpointed here, and a one-rank
    # checkpoint of two rounds resumed here for its third.
    small = flagship_data(SCAFFOLD_RESUME_CLIENTS)
    ran = scaffold_coordinator(out_dir / "x1_small", small, mesh=mesh,
                               state_store=FileStateStore(out_dir / "x1_mesh_ckpt"))
    ran.run()
    state = controls_state(torch, ran)
    if rank == 0:
        torch.save(state, out_dir / "x1_mesh_state.pt")
    del ran, state
    resumed = scaffold_coordinator(out_dir / "x1_resumed", small, mesh=mesh,
                                   state_store=FileStateStore(out_dir / "x1_one_ckpt"))
    out["resumed_round"] = resumed.current_round
    state = controls_state(torch, resumed)
    if rank == 0:
        torch.save(state, out_dir / "x1_resumed_state.pt")
    del resumed, state
    gc.collect()
    torch.cuda.empty_cache()
    # (x3) a fused block with cohorts drawn on the card.
    out["block"] = mesh_block(torch, mesh, MESH_BLOCK_RPB)
    return as_numpy(out)


def federation_rank(rank: int, world: int, out_dir: str) -> dict:
    """(x1)'s (1, 2) mesh, then (x4): rank h is host h of a (2, 1, 1) mesh.  It runs
    an ``HTTPServer`` with a card ingest buffer on localhost; four ``HTTPClient`` s
    submit full-width ``mnist_cnn`` params; the partial drain, one row all-reduce
    under a ``CollectiveWatchdog`` and the apply give the round, for FedAvg and then
    FedBuff (K = 4 a host, against two bases); each round both hosts commit a
    ``GenerationStore`` generation and read back the latest complete one."""
    import asyncio

    import torch
    import torch.distributed as dist

    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.communication import HTTPClient, HTTPServer
    from nanofed_tpu_torch.communication.federation import (
        apply_summed_row,
        build_cross_host_row_psum,
        host_partial_row,
    )
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.ingest import IngestConfig
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import CollectiveWatchdog
    from nanofed_tpu_torch.parallel.mesh import make_mesh
    from nanofed_tpu_torch.persistence import GenerationStore
    from nanofed_tpu_torch.utils.trees import ravel

    torch.backends.cudnn.deterministic = True
    out_dir = Path(out_dir)
    out: dict = {}
    # (x1) the same SCAFFOLD configuration on (1, 2).
    coord = scaffold_coordinator(out_dir / "x1_1x2", flagship_data(),
                                 mesh=make_mesh((1, 2), device="cuda"))
    ops.reset_launch_counts()
    rounds = coord.run()
    torch.cuda.synchronize()
    out["counts"] = ops.launch_counts()
    out["round_s"] = [m.duration_s for m in rounds]
    out["stack_bytes"] = coord.c_stack.numel() * coord.c_stack.element_size()
    out["params"] = {k: v.cpu() for k, v in coord.full_params().items()}
    out["c_global"] = coord.full_c_global().cpu()
    del coord
    gc.collect()
    torch.cuda.empty_cache()

    # (x4) two hosts.
    mesh = make_mesh((2, 1, 1), device="cuda")
    row_psum = build_cross_host_row_psum(mesh)
    watchdog = CollectiveWatchdog(deadline_s=120.0, host=rank)
    store = GenerationStore(out_dir / "x4_generations", host=rank)
    model = get_model("mnist_cnn")
    base = {k: v.cpu() for k, v in model.init(torch.Generator().manual_seed(0)).items()}

    async def submits(server, clients, versions):
        """Each client fetches version ``versions[i]`` and submits it plus its delta."""
        url = f"http://127.0.0.1:{server.port}"
        for i, (cid, version) in enumerate(zip(clients, versions)):
            async with HTTPClient(url, cid) as client:
                got, _, _ = await client.fetch_global_model()
                delta = fed_delta(torch, cid, got)
                await client.submit_update({k: got[k] + delta[k] for k in got},
                                           {"num_samples": 10 + i})

    async def run_round(policy: str) -> dict:
        clients = [f"h{rank}c{i}" for i in range(FED_CLIENTS)]
        server = HTTPServer(port=free_port(), ingest=IngestConfig(capacity=2 * FED_CLIENTS),
                            device="cuda", staleness_window=0 if policy == "fedavg" else 2)
        await server.start()
        try:
            params = {k: v.clone() for k, v in base.items()}
            await server.publish_model(params, 0)
            versions = [0] * FED_CLIENTS
            if policy == "fedbuff":
                # Half the clients train on version 0, half on version 1.
                await submits(server, clients[:2], [0, 0])
                params = {k: v + 0.01 for k, v in base.items()}
                await server.publish_model(params, 1)
                await submits(server, clients[2:], [1, 1])
            else:
                await submits(server, clients, versions)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if policy == "fedavg":
                num, mass, metas = await server.drain_ingest_fedavg_partial()
            else:
                num, metas, stats = await server.drain_ingest_fedbuff_partial(FED_K, 1)
                mass = float(len(metas))
            row = host_partial_row(num, mass, num.numel())
            torch.cuda.synchronize()
            drain_ms = (time.perf_counter() - t0) * 1e3
        finally:
            await server.stop()
        t0 = time.perf_counter()
        total = watchdog.run(row_psum, row, round_number=0 if policy == "fedavg" else 1)
        torch.cuda.synchronize()
        reduce_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        new, tail = apply_summed_row(ravel({k: v.cuda() for k, v in params.items()}), total,
                                     num.numel())
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        return {"new": new.cpu(), "mass": float(tail[0]), "drained": len(metas),
                "drain_ms": drain_ms, "all_reduce_ms": reduce_ms, "apply_ms": apply_ms,
                "row_bytes": row.numel() * row.element_size()}

    for gen, policy in enumerate(("fedavg", "fedbuff")):
        result = asyncio.run(run_round(policy))
        store.commit(gen, gen, {"flat": result["new"]}, {}, hosts=[0, 1],
                     meta={"policy": policy})
        dist.barrier()
        record = store.latest_complete()
        result["latest_complete"] = (record.generation, record.hosts, record.meta)
        out[policy] = result
    out["imports"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))
    return as_numpy(out)


def fed_delta(torch, cid: str, like: dict) -> dict:
    """(x4): a client's update, a seeded draw of 1e-3 scale, the same in every process."""
    gen = torch.Generator().manual_seed(int.from_bytes(cid.encode(), "little"))
    return {k: 1e-3 * torch.randn(v.shape, generator=gen) for k, v in like.items()}


def union_drain(torch, policy: str) -> torch.Tensor:
    """(x4)'s reference: one server on this process draining the union of both hosts'
    submits, as one host's round."""
    import asyncio

    from nanofed_tpu_torch.communication import HTTPClient, HTTPServer
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.ingest import IngestConfig
    from nanofed_tpu_torch.models import get_model

    base = {k: v.cpu() for k, v in get_model("mnist_cnn").init(
        torch.Generator().manual_seed(0)).items()}

    async def main():
        server = HTTPServer(port=free_port(), ingest=IngestConfig(capacity=4 * FED_CLIENTS),
                            device="cuda", staleness_window=0 if policy == "fedavg" else 2)
        await server.start()
        try:
            await server.publish_model(base, 0)
            url = f"http://127.0.0.1:{server.port}"

            async def submit(cid, i):
                async with HTTPClient(url, cid) as client:
                    got, _, _ = await client.fetch_global_model()
                    delta = fed_delta(torch, cid, got)
                    await client.submit_update({k: got[k] + delta[k] for k in got},
                                               {"num_samples": 10 + i})

            half = FED_CLIENTS // 2
            ids = [(f"h{h}c{i}", i) for h in range(2) for i in range(FED_CLIENTS)]
            if policy == "fedavg":
                for cid, i in ids:
                    await submit(cid, i)
                new, _ = await server.drain_ingest_fedavg()
                return new
            for cid, i in (x for x in ids if x[1] < half):
                await submit(cid, i)
            await server.publish_model({k: v + 0.01 for k, v in base.items()}, 1)
            for cid, i in (x for x in ids if x[1] >= half):
                await submit(cid, i)
            new, _, _ = await server.drain_ingest_fedbuff(2 * FED_K, 1)
            return new
        finally:
            await server.stop()

    return asyncio.run(main()).cpu()


def time_rank_mean(torch, ops, card: str) -> None:
    """(x1) B1's ``denom`` form at a (2, 2, 1) rank's SCAFFOLD rows (25 clients: the
    uniform participant mean over the rank's rows, divided by the cohort's count) against
    its plain version and the library call, with its bound."""
    c, p = SCAFFOLD_CHUNK, P_MNIST
    x = round_layout(torch, c, p, seed=17)
    w = (torch.rand(c, device="cuda", generator=torch.Generator(device="cuda").manual_seed(17))
         > 0.1).float()
    denom = w.sum() * 4  # the cohort's participants over four ranks
    err = check_close(torch, "(x1) weighted_mean_flat denom",
                      ops.weighted_mean_flat(x, w, denom=denom),
                      ops.weighted_mean_flat_plain(x, w, denom=denom), **TOL)
    ms = median_ms(lambda: ops.weighted_mean_flat(x, w, denom=denom), torch)
    plain_ms = median_ms(lambda: ops.weighted_mean_flat_plain(x, w, denom=denom), torch)
    library_ms = median_ms(lambda: (w / denom) @ x, torch)
    b_ms, b_by = bound_ms(4 * c * p + 4 * c + 4 * p + 4, 2 * c * p)
    print(f"[{card}] (x1) weighted_mean_flat denom form C={c} P={p}: kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} ((w / denom) @ x) "
          f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
          f"max_abs_err={err:.3e} {plan_line(torch, x, False, False)}")


def check_scaffold_mesh(torch, ops, card: str, base_dir: Path, ranks: list,
                        one_state: dict) -> dict[str, int]:
    """(x1)-(x3) from the four ranks' records: SCAFFOLD at (m)'s configuration on
    (2, 2, 1) against one rank given the same cohorts (1e-5); each rank's control-stack
    bytes and launches; a 100-client checkpoint from (2, 2, 1) resumed on one rank and
    one rank's (``one_state``) resumed on (2, 2, 1), bit for bit; (x2) the SCAFFOLD
    step profiled in lockstep on every rank; (x3) a fused block of R = 4, 20% cohorts
    drawn on the card over the hosts axis in chunks of 25, against the one-device block
    (1e-5).  Returns the launches of every rank and of this process's references."""
    from nanofed_tpu_torch.parallel.mesh import Mesh, client_slice
    from nanofed_tpu_torch.persistence import FileStateStore

    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    n, p = FLAGSHIP["num_clients"], P_MNIST

    # (x1) four ranks against one rank given their cohorts.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gc.collect()
        torch.cuda.empty_cache()
        given = ranks[0]
        ref = scaffold_coordinator(base_dir / "x1_ref_given", flagship_data())
        # The mesh's cohorts in the mesh's slot order: a bf16 fit's bits depend on the
        # clients its chunk holds (vmap batches them into one convolution).
        slots = {c.tobytes(): s for c, s in zip(given["cohorts"], given["slots"])}
        ref._sample_cohort = lambda r, c=given["cohorts"]: c[r]
        ref._place_cohort = lambda survived, s=slots: s[survived.tobytes()]
        _, wall, grew = counted(torch, ops, card, "(x1) one rank, given cohorts",
                                ref.run, scaffold_launches(SCAFFOLD_ROUNDS))
        add_launches(totals, grew)
        refs = {"given": {"params": {k: v.cpu() for k, v in ref.params.items()},
                          "c_global": ref.c_global.cpu(), "wall_s": wall,
                          "stack_bytes": ref.c_stack.numel() * ref.c_stack.element_size()}}
        del ref
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    want_counts = scaffold_launches(SCAFFOLD_ROUNDS)
    full_stack = n * p * 4
    for i, r in enumerate(ranks):
        add_launches(totals, r["counts"])
        lo, hi = client_slice(n, Mesh.describe(SCAFFOLD_MESH_SHAPE, i))
        print(f"[{card}] (x1) rank {i} of (2, 2, 1): round_s={r['round_s']} loss={r['loss']} "
              f"control stack rows [{lo}, {hi}) = {r['stack_bytes']} bytes "
              f"({r['stack_bytes'] / full_stack:.4f} of N x P x 4 = {full_stack}); last "
              f"round's control-row exchange {r['exchange_bytes']} bytes received; "
              f"launches={r['counts']} (expected {want_counts}); "
              f"peak_device_bytes={r['peak_bytes']}")
        if r["counts"] != {k: want_counts.get(k, 0) for k in r["counts"]}:
            fail(f"(x1) rank {i} launches {r['counts']}, expected {want_counts}")
        if r["stack_bytes"] * 4 != full_stack:
            fail(f"(x1) rank {i} holds {r['stack_bytes']} bytes of the control stack")
    gap = max(max_abs_gap(torch, ranks[0]["params"], refs["given"]["params"]),
              max_abs_gap(torch, {"c": ranks[0]["c_global"]}, {"c": refs["given"]["c_global"]}))
    ranks_same = all(all((r["params"][k] == ranks[0]["params"][k]).all()
                         for k in ranks[0]["params"])
                     and (r["c_global"] == ranks[0]["c_global"]).all() for r in ranks[1:])
    print(f"[{card}] (x1) (2, 2, 1) against one rank given the same cohorts in the same "
          f"slots: max|d(params, "
          f"c_global)|={gap:.3e} (tolerance {SCAFFOLD_MESH_TOL}); every rank's params and "
          f"c_global the same bits: {ranks_same}; one rank's wall {refs['given']['wall_s']:.3f}"
          f" s for {SCAFFOLD_ROUNDS} rounds, control stack {refs['given']['stack_bytes']} "
          f"bytes")
    if gap > SCAFFOLD_MESH_TOL or not ranks_same:
        fail(f"(x1) (2, 2, 1) is {gap} from one rank; ranks bit-identical: {ranks_same}")

    # Checkpoints across mesh shapes: (2, 2, 1)'s resumed on one rank; one rank's on
    # (2, 2, 1).
    resumed_mesh = torch.load(base_dir / "x1_resumed_state.pt")
    ok_in = ranks[0]["resumed_round"] == 2 and same_state(torch, resumed_mesh, one_state)
    back = scaffold_coordinator(base_dir / "x1_back", flagship_data(SCAFFOLD_RESUME_CLIENTS),
                                rounds=4, state_store=FileStateStore(base_dir / "x1_mesh_ckpt"))
    ok_out = back.current_round == 3 and same_state(
        torch, controls_state(torch, back), torch.load(base_dir / "x1_mesh_state.pt"))
    stack_mb = SCAFFOLD_RESUME_CLIENTS * p * 4 / 1e6
    print(f"[{card}] (x1) a one-rank round-1 checkpoint resumed on (2, 2, 1) at round "
          f"{ranks[0]['resumed_round']}, state bit-equal: {ok_in}; the (2, 2, 1) round-2 "
          f"checkpoint resumed on one rank at round {back.current_round}, state bit-equal: "
          f"{ok_out} ({SCAFFOLD_RESUME_CLIENTS} clients: a {stack_mb:.0f} MB control stack "
          "gathered for each checkpoint)")
    del back, resumed_mesh, one_state
    if not (ok_in and ok_out):
        fail(f"(x1) checkpoints across mesh shapes: into the mesh {ok_in}, out {ok_out}")

    # (x2) every rank's report; rank 0 alone published.
    for i, r in enumerate(ranks):
        for rep in r["reports"]:
            print(f"[{card}] (x2) rank {i} {rep['program']}: flops={rep['flops']:.6g} "
                  f"bytes_accessed={rep['bytes_accessed']:.6g} peak_bytes={rep['peak_bytes']} "
                  f"first_call_s={rep['compile_seconds']} measured_s={rep['measured_s']:.6f} "
                  f"num_devices={rep['num_devices']} attrs={rep['attrs']} "
                  f"(profile_programs {r['profile_s']:.3f} s)")
        if [rep["program"] for rep in r["reports"]] != ["scaffold_round_step"]:
            fail(f"(x2) rank {i} profiled {[rep['program'] for rep in r['reports']]}")
    print(f"[{card}] (x2) rank 0's gauges: {ranks[0]['published']}; ranks 1-3 published "
          f"{[len(r['published']) for r in ranks[1:]]} gauges")
    if not ranks[0]["published"] or any(r["published"] for r in ranks[1:]):
        fail("(x2) the gauges must come from rank 0 alone")

    # (x3) the block against one device with the same seeds.
    gc.collect()
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = mesh_block(torch, None, MESH_BLOCK_RPB)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cohort = n // MESH_BLOCK_COHORT
    want = {k: v * MESH_BLOCK_RPB for k, v in step_launches(SCAFFOLD_CHUNK, cohort).items()}
    if ref["counts"] != {k: want.get(k, 0) for k in ref["counts"]}:
        fail(f"(x3) one device's launches {ref['counts']}, expected {want}")
    block_counts = {k: v * MESH_BLOCK_RPB  # a rank streams its quarter of the cohort
                    for k, v in step_launches(SCAFFOLD_CHUNK, cohort // 4).items()}
    add_launches(totals, ref["counts"])
    got = ranks[0]["block"]
    ids_same = all(torch.equal(torch.from_numpy(r["block"]["ids"]), ref["ids"]) for r in ranks)
    gap = max_abs_gap(torch, got["params"], ref["params"])
    for i, r in enumerate(ranks):
        add_launches(totals, r["block"]["counts"])
        print(f"[{card}] (x3) rank {i}: block of {MESH_BLOCK_RPB} rounds in "
              f"{r['block']['wall_s']:.3f} s, cohort exchange "
              f"{r['block']['exchange_bytes']} bytes received a round; "
              f"launches={r['block']['counts']}")
        if r["block"]["counts"] != {k: block_counts.get(k, 0) for k in r["block"]["counts"]}:
            fail(f"(x3) rank {i} launches {r['block']['counts']}")
    crossed = int(((ref["ids"] // (n // 2))
                   != (torch.arange(ref["ids"].shape[1]) // (ref["ids"].shape[1] // 2))).sum())
    print(f"[{card}] (x3) one device: {ref['wall_s']:.3f} s, launches={ref['counts']}; the "
          f"mesh drew the same ids: {ids_same} ({crossed} of {ref['ids'].numel()} slots held "
          f"by the other host); max|d params|={gap:.3e} (tolerance {MESH_BLOCK_TOL}); loss "
          f"{got['loss'].tolist()} vs {ref['loss'].tolist()}")
    if not ids_same or gap > MESH_BLOCK_TOL or crossed == 0:
        fail(f"(x3) ids equal {ids_same}, params {gap} from one device, {crossed} crossed")
    return totals


def pair_rank(rank: int, world: int, out_dir: str) -> dict:
    """(w3) then (x1)'s (1, 2) mesh and (x4) as one rank of a world of two: one
    start-up for both."""
    import torch

    out = {"w3": mesh_lm_rank(rank, world, out_dir)}
    torch.use_deterministic_algorithms(False)  # (w3)'s; (x1) runs as its reference does
    gc.collect()
    torch.cuda.empty_cache()
    out["x"] = federation_rank(rank, world, out_dir)
    return out


def phase_mesh_pairs(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """One world of two gloo ranks on the card for (w3) (its records saved for
    :func:`check_lm_mesh`), then (x1)'s SCAFFOLD run on (1, 2) against one rank, bit for
    bit, and (x4): the two
    ranks as hosts, ingest servers, partial drains, one row all-reduce and the apply
    against one server draining the union, FedAvg and FedBuff, with generations
    committed.  No finding reads their seconds, so they run beside (o)-(r).  Returns the
    launch counts."""
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base_dir = out_dir / "mesh_pairs"
    base_dir.mkdir(parents=True, exist_ok=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = scaffold_coordinator(base_dir / "x1_ref_own", flagship_data())
        _, _, grew = counted(torch, ops, card, "(x1) one rank, own cohorts", ref.run,
                             scaffold_launches(SCAFFOLD_ROUNDS))
        add_launches(totals, grew)
        refs = {"own": {"params": {k: v.cpu() for k, v in ref.params.items()},
                        "c_global": ref.c_global.cpu()}}
        del ref
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    pairs = spawned(torch, card, "(w3) base dense and adapter rounds, then (x1) SCAFFOLD, on "
                    "(1, 2), then (x4) two hosts", pair_rank, 2, "gloo", args=(str(base_dir),))
    # (w3)'s ranks are held against their references by the parent (check_lm_mesh),
    # which computes them beside this world.
    torch.save([r["w3"] for r in pairs], base_dir / "w3_ranks.pt")
    two = [r["x"] for r in pairs]
    want_counts = scaffold_launches(SCAFFOLD_ROUNDS)
    for i, r in enumerate(two):
        add_launches(totals, r["counts"])
        print(f"[{card}] (x1) rank {i} of (1, 2): round_s={r['round_s']} control stack "
              f"{r['stack_bytes']} bytes; launches={r['counts']}")
        if r["counts"] != {k: want_counts.get(k, 0) for k in r["counts"]}:
            fail(f"(x1) (1, 2) rank {i} launches {r['counts']}")
    same = (all(torch.equal(torch.from_numpy(two[0]["params"][k]), refs["own"]["params"][k])
                for k in refs["own"]["params"])
            and torch.equal(torch.from_numpy(two[0]["c_global"]), refs["own"]["c_global"]))
    print(f"[{card}] (x1) (1, 2) params and c_global bit-equal to one rank: {same}")
    if not same:
        fail("(x1) the (1, 2) SCAFFOLD run is not bit-equal to one rank: max "
             f"{max_abs_gap(torch, two[0]['params'], refs['own']['params']):.3e}")

    # (x4) the two hosts against one server draining the union.
    if any(r["imports"] for r in two):
        fail(f"(x4) a host imported {two[0]['imports']}")
    for policy in ("fedavg", "fedbuff"):
        want = union_drain(torch, policy)
        for i, r in enumerate(two):
            x = r[policy]
            gap = float((torch.from_numpy(x["new"]) - want).abs().max())
            print(f"[{card}] (x4) {policy} host {i}: drained {x['drained']} (mass "
                  f"{x['mass']}), drain {x['drain_ms']:.3f} ms, row all-reduce of "
                  f"{x['row_bytes']} bytes {x['all_reduce_ms']:.3f} ms, apply "
                  f"{x['apply_ms']:.3f} ms; against one server draining the union "
                  f"max|d|={gap:.3e} (tolerance {FED_TOL}); latest complete generation "
                  f"{x['latest_complete']}")
            if gap > FED_TOL or x["latest_complete"][0] != ("fedavg", "fedbuff").index(policy):
                fail(f"(x4) {policy} host {i}: {gap} from the union, {x['latest_complete']}")
        if not (two[0][policy]["new"] == two[1][policy]["new"]).all():
            fail(f"(x4) {policy}: the hosts' params differ")
    return totals


CHAOS_CRASH_FRACTION = 0.25  # (y1): 250 of the flagship's 1000 clients crash in round 0
CHAOS_RATES = ((0.7, "COMPLETED"), (0.9, "FAILED"))  # (y1): 750 >= 700, 750 < 900
CHAOS_NET_ROUNDS = 3  # (y2): rounds 0 and 1, then the kill in round 2 and its resume
CHAOS_NET_TOL = 1e-5  # (y2): a float32 aggregate against its float64 FedAvg
CHAOS_NET_TIMEOUT_S = 600.0  # (y2): virtual seconds; a client's retry storm cannot reach it
# (y3)-(y5): the harness at full mnist_cnn width; 16 clients of 64 samples, batch 32, in
# chunks of 4 (a rank of 2 streams 2 chunks a round, one rank 4).
HARNESS_ARGS = ["--device", "cuda", "--model", "mnist_cnn", "--clients", "16",
                "--capacity", "64", "--batch-size", "32", "--client-chunk", "4"]
HARNESS_BENCH = dict(clients=2000, capacity=16, chunk=250, rounds=2)  # (y5)


def phase_chaos_simulator(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(y1): the flagship (b) through ``Coordinator(chaos=)``.  Every crash of
    ``FaultPlan.generate`` falls in round 0 (rounds [0, R/2) with R = 2), so both rounds
    sample the 750 survivors.  Launches the code predicts, written before the runs: the
    full-participation step fits all 1000 rows (a crashed client rides at weight 0), so a
    completed round is (b)'s 8 chunks of 125 (B1 accumulate and B3 8 each), and a failed
    round stops before the step (none)."""
    from nanofed_tpu_torch.faults import ChaosSchedule, FaultPlan
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability.registry import MetricsRegistry
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

    n, rounds, chunk = FLAGSHIP["num_clients"], FLAGSHIP["num_rounds"], MESH_CHUNK
    plan = FaultPlan.generate(0, list(range(n)), rounds, crash_fraction=CHAOS_CRASH_FRACTION)
    crashed = [{e.client for e in plan.events if e.round <= r} for r in range(rounds)]
    survivors = [sorted(set(range(n)) - c) for c in crashed]
    data = flagship_data()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    for rate, expect in CHAOS_RATES:
        want = ({"weighted_sum_into": rounds * (n // chunk), "row_sq_norms": rounds * (n // chunk)}
                if expect == "COMPLETED" else {})
        print(f"[{card}] (y1) completion rate {rate}: {len(plan.events)} planned crashes, "
              f"survivors {[len(s) for s in survivors]} a round, predicted {expect} rounds "
              f"and launches {want}")
        schedule = ChaosSchedule(plan, registry=MetricsRegistry())
        coord = Coordinator(
            get_model("mnist_cnn"), data,
            CoordinatorConfig(num_rounds=rounds, seed=0, min_completion_rate=rate,
                              base_dir=out_dir / f"y1_{rate}", save_metrics=False),
            flagship_training(), client_chunk=chunk, device="cuda", chaos=schedule)
        cohorts: list = []

        def recorded(r, _sample=coord._sample_cohort, _cohorts=cohorts):
            out = _sample(r)
            _cohorts.append(sorted(int(c) for c in out))
            return out

        coord._sample_cohort = recorded
        history, wall, grew = counted(torch, ops, card, f"(y1) rate {rate}", coord.run, want)
        statuses = [h.status.name for h in history]
        print(f"[{card}] (y1) rate {rate}: statuses {statuses}, clients "
              f"{[h.num_clients for h in history]}, counts {schedule.counts()}, "
              f"round_durations_s {[h.duration_s for h in history]}")
        if statuses != [expect] * rounds:
            fail(f"(y1) rate {rate}: statuses {statuses}, expected {expect} every round")
        if cohorts != survivors:
            fail(f"(y1) rate {rate}: the cohorts are not the plan's survivors")
        if schedule.counts() != {"crash": len(crashed[-1])}:
            fail(f"(y1) rate {rate}: counts {schedule.counts()}, planned {len(crashed[-1])} "
                 "crashes")
        if expect == "COMPLETED" and not all(torch.isfinite(v).all()
                                             for v in coord.params.values()):
            fail("(y1): non-finite params after the survivors' rounds")
        add_launches(totals, grew)
        del coord
        gc.collect()
        torch.cuda.empty_cache()
    return totals


async def chaos_network_client(torch, comm, faults, url, cid, index, local_fit, data,
                               template, clock, schedule):
    """test_chaos.py's scripted client on the card: fetch, train once a round, submit
    through ``ChaosClient`` under the plan, re-submit if the round is still open 2 virtual
    seconds later (a restarted server lost its buffer; a corrupted body was refused),
    retry through a server's restart, stop once training ends or the plan crashes it."""
    from nanofed_tpu_torch.core.exceptions import NanoFedError

    retry = comm.RetryPolicy(max_attempts=50, base_backoff_s=0.05, max_backoff_s=0.5,
                             seed=1234)
    num_samples = float(data.mask.sum())
    async with comm.HTTPClient(url, cid, timeout_s=120, retry=retry, clock=clock) as client:
        chaos = faults.ChaosClient(client, schedule, clock=clock)
        trained: dict[int, dict] = {}
        submitted: dict[int, float] = {}
        while True:
            try:
                params, rnd, active = await client.fetch_global_model(like=template)
            except NanoFedError:  # the server is restarting
                await clock.sleep(0.05)
                continue
            if not active or not chaos.alive(rnd):
                return
            if rnd in submitted and clock.time() - submitted[rnd] < 2.0:
                await clock.sleep(0.05)
                continue
            if rnd not in trained:
                gp = {k: v.to("cuda") for k, v in params.items()}
                trained[rnd] = train_client(torch, local_fit, gp, data, index, rnd)
            await chaos.submit(trained[rnd], {"num_samples": num_samples}, rnd)
            submitted[rnd] = clock.time()
            await clock.sleep(0.05)


def phase_chaos_network(torch, ops, card: str, out_dir: Path, setup) -> dict[str, int]:
    """(y2): (h)'s 8 clients on a ``VirtualClock`` under a hand-written plan, 3 rounds of
    7 required updates: client_7 crashes in round 1; client_6 straggles 3 virtual s in
    round 0; client_0's first two posts of round 0 are dropped; client_1's round-1 ACK is
    lost and it re-posts twice more (duplicates); client_2's round-1 body is corrupted;
    the server is killed in round 2 and a new server and coordinator resume from the
    ``FileStateStore``.  Predicted: every round COMPLETED, counts by kind the plan's (drop
    2, the rest 1), each aggregate the FedAvg of the updates the server drained (each
    client once) within 1e-5, B1 normalised once a completed round (3) at C = the
    drained count, nothing else."""
    import logging

    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch import faults
    from nanofed_tpu_torch.communication import network_coordinator
    from nanofed_tpu_torch.observability.registry import MetricsRegistry
    from nanofed_tpu_torch.persistence import FileStateStore
    from nanofed_tpu_torch.utils.clock import VirtualClock
    from nanofed_tpu_torch.utils.logger import LogConfig, Logger

    Logger().configure(LogConfig(level=logging.ERROR))  # no per-fault warning lines
    init, data, local_fit = setup
    n = SECURE_CLIENTS
    ev = faults.FaultEvent
    plan = faults.FaultPlan(seed=18, events=(
        ev(kind="delay", round=0, client="client_6", seconds=3.0),
        ev(kind="drop", round=0, client="client_0", count=2),
        ev(kind="crash", round=1, client="client_7"),
        ev(kind="ack_drop", round=1, client="client_1"),
        ev(kind="duplicate", round=1, client="client_1", count=2),
        ev(kind="corrupt", round=1, client="client_2"),
        ev(kind="server_kill", round=2),
    ))
    want_counts = {"delay": 1, "drop": 2, "crash": 1, "ack_drop": 1, "duplicate": 1,
                   "corrupt": 1, "server_kill": 1}
    registry = MetricsRegistry()
    schedule = faults.ChaosSchedule(plan, registry=registry)
    clock = VirtualClock()
    store = FileStateStore(out_dir / "y2_state")
    drained: dict[int, list] = {}
    reduced: list[int] = []
    publishes: dict[int, dict] = {}
    combine = network_coordinator.fedavg_combine

    def recorded_combine(stacked, weights):
        reduced.append(int(weights.shape[0]))
        return combine(stacked, weights)

    async def main():
        port = comm.free_port()
        url = f"http://127.0.0.1:{port}"
        clients = [asyncio.ensure_future(chaos_network_client(
            torch, comm, faults, url, f"client_{c}", c, local_fit, data[c], init, clock,
            schedule)) for c in range(n)]

        async def incarnation(final: bool):
            server = comm.HTTPServer(port=port, registry=registry, clock=clock, chaos=schedule)
            drain = server.drain_updates

            async def captured(*a):
                out = await drain(*a)
                drained[server._round] = list(out)
                return out

            server.drain_updates = captured
            publish = server.publish_model

            async def publish_and_keep(params, r):
                publishes[r] = {k: v.detach().cpu().clone() for k, v in params.items()}
                await publish(params, r)

            server.publish_model = publish_and_keep
            coordinator = comm.NetworkCoordinator(
                server, init, comm.NetworkRoundConfig(
                    num_rounds=CHAOS_NET_ROUNDS, min_clients=n, min_completion_rate=7 / 8,
                    round_timeout_s=CHAOS_NET_TIMEOUT_S, poll_interval_s=0.01),
                registry=registry, clock=clock, state_store=store, chaos=schedule,
                device="cuda")
            await server.start()
            try:
                try:
                    history = await coordinator.run()
                except faults.InjectedServerCrash as crash:
                    return coordinator, list(coordinator.history), crash
                if final:
                    await asyncio.wait_for(asyncio.gather(*clients), 120)
                return coordinator, history, None
            finally:
                await server.stop()

        try:
            first = await incarnation(final=False)
            second = await incarnation(final=True)
        finally:
            for task in clients:
                task.cancel()
        return first, second

    network_coordinator.fedavg_combine = recorded_combine
    try:
        want = {"weighted_mean_flat": CHAOS_NET_ROUNDS}
        print(f"[{card}] (y2) plan {plan.to_json()!r}; predicted counts {want_counts}, "
              f"launches {want}")
        runs, _, grew = counted(torch, ops, card, "(y2) chaos network round",
                                lambda: asyncio.run(main()), want)
    finally:
        network_coordinator.fedavg_combine = combine
    (c1, h1, crash1), (c2, h2, crash2) = runs
    history = h1 + h2
    rounds = [h["round"] for h in history]
    statuses = [h["status"] for h in history]
    print(f"[{card}] (y2) first server: rounds {[h['round'] for h in h1]}, crash "
          f"{crash1!r}; resumed at {c2.start_round}: rounds {[h['round'] for h in h2]}; "
          f"statuses {statuses}; clients {[h['num_clients'] for h in history]}; counts "
          f"{schedule.counts()}; B1's C a round {reduced}; virtual s {clock.time():.2f}")
    if crash1 is None or crash2 is not None or c2.start_round != 2:
        fail(f"(y2) the kill did not fire once in round 2 and resume there ({crash1!r}, "
             f"{crash2!r}, start_round {c2.start_round})")
    if rounds != list(range(CHAOS_NET_ROUNDS)) or statuses != ["COMPLETED"] * len(rounds):
        fail(f"(y2) rounds {rounds}, statuses {statuses}")
    if schedule.counts() != want_counts:
        fail(f"(y2) fault counts {schedule.counts()}, planned {want_counts}")
    text = registry.render_prometheus()
    print(f"[{card}] (y2) " + "; ".join(
        line for line in text.splitlines() if line.startswith("nanofed_updates_total{")))
    for r in range(CHAOS_NET_ROUNDS):
        updates = drained[r]
        ids = [u.client_id for u in updates]
        if len(ids) != len(set(ids)) or len(ids) != reduced[r]:
            fail(f"(y2) round {r}: drained {ids}, B1 reduced {reduced[r]}")
        if r >= 1 and "client_7" in ids:
            fail(f"(y2) round {r}: the crashed client_7 was aggregated")
        agg = published({"publishes": publishes, "coordinator": c2}, r, torch)
        check_fedavg(torch, card, f"(y2) round {r} ({len(ids)} updates accepted once)", agg,
                     [(float(u.metrics["num_samples"]), u.params) for u in updates],
                     CHAOS_NET_TOL)
    return grew


def start_harness(argv: list[str]) -> tuple[subprocess.Popen, float]:
    """``scripts/multihost_harness_torch.py`` with ``argv``, started (its workers' logs go
    to its stderr, printed only when it fails)."""
    root = Path(__file__).resolve().parent
    # A session of its own, so stop_harness reaches its workers too.
    proc = subprocess.Popen([sys.executable, str(root / "scripts" / "multihost_harness_torch.py"),
                             *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=root, start_new_session=True)
    return proc, time.perf_counter()


def atexit_stop(started: tuple[subprocess.Popen, float]):
    """Register the stop of a started subprocess for the interpreter's exit (a failed
    check exits through ``fail``); returns the callback, to unregister once read."""
    import atexit

    def stop() -> None:
        stop_harness(started)

    atexit.register(stop)
    return stop


def stop_harness(started: tuple[subprocess.Popen, float]) -> None:
    """Kill a started harness and every worker it spawned."""
    import os
    import signal

    proc = started[0]
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.communicate()


def finish_harness(card: str, tag: str, started: tuple[subprocess.Popen, float],
                   timeout_s: float) -> str:
    """Wait for a started harness; fail unless it exits 0.  Returns its stdout."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        stop_harness(started)
        fail(f"{tag}: the harness ran past {timeout_s} s")
    print(f"[{card}] {tag}: harness wall_s={time.perf_counter() - t0:.3f} rc={proc.returncode}")
    if proc.returncode != 0:
        print(out[-6000:])
        print(err[-10000:])
        fail(f"{tag}: the harness exited {proc.returncode}")
    return out


def harness_json(stdout: str) -> dict:
    """The first pretty-printed JSON object the harness printed."""
    start = stdout.index("{\n")
    return json.loads(stdout[start:stdout.index("\n}\n", start) + 2])


def sum_ranks(by_rank: list[dict]) -> dict[str, int]:
    total: dict[str, int] = {}
    for counts in by_rank:
        add_launches(total, counts)
    return total


def expect_ranks(tag: str, by_rank: list[dict], per_rank: dict[str, int]) -> None:
    for rank, counts in enumerate(by_rank):
        want = {k: per_rank.get(k, 0) for k in counts}
        if counts != want:
            fail(f"{tag} rank {rank}: kernel launches {counts}, expected {want}")


HARNESS_SMOKE_TIMED = 3  # (y3): rounds after the warm-up round


def start_chaos_smoke(card: str, out_dir: Path) -> tuple[subprocess.Popen, float]:
    """(y3) started: it checks parity and times nothing, so it runs beside (o)-(r)."""
    per_rank = {k: 2 * (HARNESS_SMOKE_TIMED + 1) for k in ("weighted_sum_into", "row_sq_norms")}
    print(f"[{card}] (y3) predicted launches a rank of 2: {per_rank}, one rank twice that")
    return start_harness(["smoke", *HARNESS_ARGS, "--rounds", str(HARNESS_SMOKE_TIMED),
                          "--timeout", "300", "--tmp-dir", str(out_dir / "y3")])


def finish_chaos_smoke(card: str, smoke: tuple[subprocess.Popen, float]) -> dict[str, int]:
    """(y3): the multi-host harness's ``smoke``, started by :func:`start_chaos_smoke`:
    2 gloo ranks against one rank.  Launches predicted from the round step's code: a
    rank streams its rows in chunks of 4, B1 accumulate and B3 once a chunk."""
    totals: dict[str, int] = {}
    per_rank = {k: 2 * (HARNESS_SMOKE_TIMED + 1) for k in ("weighted_sum_into", "row_sq_norms")}
    verdict = harness_json(finish_harness(card, "(y3) smoke", smoke, 420))
    gaps = (verdict["max_loss_delta"], verdict["max_param_delta"])
    print(f"[{card}] (y3) 2 gloo ranks, mesh {verdict['topology']['mesh_shape']}, against "
          f"one rank: max loss gap {gaps[0]:.3e}, max param gap {gaps[1]:.3e} (tolerance "
          f"{verdict['tolerance']}); losses {verdict['losses_multi']}; launches by rank "
          f"{verdict['launches_by_rank']}, one rank {verdict['launches_ref']}; "
          f"walltime_s {verdict['walltime_s']}")
    if max(gaps) > verdict["tolerance"] or verdict["topology"]["process_count"] != 2:
        fail(f"(y3) smoke gaps {gaps} over {verdict['tolerance']}")
    expect_ranks("(y3)", verdict["launches_by_rank"], per_rank)
    expect_ranks("(y3) one rank", [verdict["launches_ref"]],
                 {k: 2 * v for k, v in per_rank.items()})
    add_launches(totals, sum_ranks(verdict["launches_by_rank"]))
    add_launches(totals, verdict["launches_ref"])
    return totals


def phase_chaos_harness(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(y4) and (y5): the multi-host harness with gloo ranks on the card (they share it,
    so no time here is a round across cards).  Launches predicted from the round step's
    code: a rank streams its rows in chunks, B1 accumulate and B3 once a chunk."""
    from nanofed_tpu_torch.observability.telemetry import summarize_telemetry

    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    rounds, block = 6, 2
    finish_harness(card, "(y4) hostchaos", start_harness([
        "hostchaos", *HARNESS_ARGS, "--host-fault", "crash", "--rounds", str(rounds),
        "--block-size", str(block), "--rejoin-rounds", "2", "--watchdog-deadline", "20",
        "--stall-timeout", "15", "--compile-grace", "90", "--timeout", "300",
        "--tmp-dir", str(out_dir / "y4"), "--out-dir", str(out_dir / "y4_out")]), 900)
    (path,) = sorted((out_dir / "y4_out").glob("hostchaos_torch_*_2h.json"))
    art = json.loads(path.read_text())
    fl, rec, par = art["failure"], art["recovery"], art["parity"]
    resumed = rec["resumed_round"]
    rejoin = art["rejoin"]
    one_rank = {k: 4 * (rounds - resumed) for k in ("weighted_sum_into", "row_sq_norms")}
    two_ranks = {k: 2 * (rounds + 2 - rejoin["resumed_round"])
                 for k in ("weighted_sum_into", "row_sq_norms")}
    print(f"[{card}] (y4) {fl['kind']} on host {fl['host']} in round {fl['round']}: "
          f"detection_s={fl['detection_s']:.3f} (watchdog deadline "
          f"{fl['watchdog_deadline_s']}) exit codes {fl['worker_exit_codes']}; "
          f"recovery_s={rec['recovery_s']:.3f} of which startup_s={rec['startup_s']:.3f}, "
          f"phases {rec['phases']}; rounds lost {rec['rounds_lost']} (block {block}), "
          f"resumed generation {rec['resumed_generation']} at round {resumed}; parity gap "
          f"{par['max_loss_delta']:.3e} (bit-equal {par['bit_equal']}); orphans "
          f"{art['orphans']}; rejoined at round {rejoin['resumed_round']}, ran to "
          f"{rejoin['rounds'][-1]}; launches a rank: recovered "
          f"{art['recovered']['launches_by_rank']} (predicted {one_rank}), rejoined "
          f"{rejoin['launches_by_rank']} (predicted {two_ranks}), reference "
          f"{art['reference_unfailed_shrunk']['launches_by_rank']}; walltime_s "
          f"{art['walltime_s']:.3f}")
    if not (fl["kind"] == "host_crash" and fl["detection_s"] < fl["watchdog_deadline_s"]
            and rec["rounds_lost"] <= block and par["ok"] and not art["orphans"]
            and rejoin["rounds"][-1] == rounds + 1):
        fail(f"(y4) the drill's record does not hold: {json.dumps(art)[:3000]}")
    expect_ranks("(y4) recovered", art["recovered"]["launches_by_rank"], one_rank)
    expect_ranks("(y4) reference", art["reference_unfailed_shrunk"]["launches_by_rank"],
                 one_rank)
    expect_ranks("(y4) rejoined", rejoin["launches_by_rank"], two_ranks)
    for by_rank in (art["recovered"]["launches_by_rank"], rejoin["launches_by_rank"],
                    art["reference_unfailed_shrunk"]["launches_by_rank"]):
        add_launches(totals, sum_ranks(by_rank))
    digest = summarize_telemetry(out_dir / "y4" / "telemetry" / "telemetry.jsonl")
    if digest["host_failures"]["by_kind"] != {"host_crash": 1} or \
            digest["recoveries"]["count"] != 2:
        fail(f"(y4) metrics-summary of the drill's telemetry: {digest}")

    b = HARNESS_BENCH
    chunks = b["clients"] // 2 // b["chunk"]
    per_rank = {k: chunks * (b["rounds"] + 1) for k in ("weighted_sum_into", "row_sq_norms")}
    record = harness_json(finish_harness(card, "(y5) bench", start_harness([
        "bench", "--device", "cuda", "--model", "mnist_cnn", "--clients", str(b["clients"]),
        "--capacity", str(b["capacity"]), "--batch-size", str(b["capacity"]),
        "--client-chunk", str(b["chunk"]), "--rounds", str(b["rounds"]), "--timeout", "300",
        "--tmp-dir", str(out_dir / "y5"), "--out-dir", str(out_dir / "y5_out")]), 420))
    print(f"[{card}] (y5) bench {b['clients']} clients of {b['capacity']} samples on 2 gloo "
          f"ranks sharing the card: per_round_s {record['per_round_s']}, rounds_per_sec "
          f"{record['rounds_per_sec']:.4f}, clients_per_sec {record['clients_per_sec']:.1f}; "
          f"launches by rank {record['launches_by_rank']} (predicted {per_rank}); "
          f"walltime_s {record['walltime_s']}")
    if record["platform"] != "gpu" or not all(math.isfinite(v) for v in record["losses"]):
        fail(f"(y5) bench record {record}")
    expect_ranks("(y5)", record["launches_by_rank"], per_rank)
    add_launches(totals, sum_ranks(record["launches_by_rank"]))
    return totals


def phase_chaos(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(y): faults and chaos, (y1), (y4) and (y5) ((y2) and (y3) time nothing and run
    beside (o)-(r): :func:`phase_beside_network`, :func:`start_chaos_smoke`).  Returns
    the launches of (y1) and every rank of (y4)-(y5)."""
    t_phase = time.perf_counter()
    base = out_dir / "y_chaos"
    base.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    totals = phase_chaos_simulator(torch, ops, card, base)
    t1 = time.perf_counter()
    add_launches(totals, phase_chaos_harness(torch, ops, card, base))
    print(f"[{card}] (y) wall_s={time.perf_counter() - t_phase:.1f} ((y1) {t1 - t_phase:.1f}, "
          f"(y4)-(y5) {time.perf_counter() - t1:.1f}); launches {totals}")
    return totals


#: (z1): the JAX command line's ``loadtest`` defaults (``nanofed_tpu/cli.py``) on the system
#: clock, but 1,000 clients and a 5 s round timeout.  At its 10,000 a one-process tier
#: loses submits, the JAX package's as the port's on the same host (a submit whose
#: stamped version leaves the window five times fails), and both paths took 259.6 s on
#: the H100 machine, 120 s of it the engines waiting out aggregations no submit was left
#: to fill (PERF.md §6, ROADMAP queue C).
LOADTEST_DEFAULTS = dict(clients=1000, submits_per_client=1, model="digits_mlp",
                         async_buffer_k=64, ingest_capacity=1024, decode_workers=4,
                         max_inflight=512, arrival="poisson", arrival_rate=2000.0,
                         round_timeout_s=5.0)
#: (z2): the ingest path at full mnist_cnn width, a 256 x P buffer (1.23 GB).
LOADTEST_FULL = dict(clients=1000, model="mnist_cnn", async_buffer_k=64, ingest_capacity=256,
                     decode_workers=4, max_inflight=512, arrival="poisson", arrival_rate=250.0,
                     round_timeout_s=5.0)
#: (z3): the rounds of the JAX package's three-tenant leg
#: (``tests/integration/test_tenant_service.py``).  A sync round keeps one update a client
#: and drops what lands between its drain and the next publish, so at the command line's
#: 4 rounds on the system clock charlie's last round can starve (PERF.md §7).
TENANT_ROUNDS = 3
TENANT_REFUSED_BUDGET = 16 * 2**30  # (z4): the budget the 19.7 GB tenant does not fit
TENANT_FAT_CAPACITY = 4096  # (z4): ingest rows of the full-width FedBuff tenant
FEDERATE_ARGS = ["--device", "cuda", "--model", "mnist_cnn", "--clients", "256",
                 "--round-timeout-s", "1.5", "--round-quota", "32", "--ingest-capacity",
                 "256", "--arrival-rate", "200", "--timeout", "300"]  # (z5)


def check_loadtest(tag: str, rec: dict, clients: int) -> None:
    """No submit lost outright; every logical submit ends accepted, duplicate or
    terminated (the engine reached its target), and each landed one has a latency; the
    latencies are ordered and finite; aggregations completed."""
    lat = rec["submit_latency_s"]
    landed = rec["accepted"] + rec["duplicates"]
    ok = (rec["failed_submits"] == 0 and landed + rec["terminated_early"] == clients
          and lat["count"] == landed > 0 and math.isfinite(lat["p99_s"])
          and lat["p50_s"] <= lat["p99_s"] <= lat["max_s"]
          and rec["aggregations_completed"] > 0)
    if not ok:
        fail(f"{tag} {rec['mode']}: {json.dumps(rec)[:2000]}")


def loadtest_line(rec: dict) -> str:
    lat = rec["submit_latency_s"]
    pool = rec["decode_pool"]
    return (f"{rec['mode']}: p50_s {lat['p50_s']} p99_s {lat['p99_s']} max_s {lat['max_s']}, "
            f"rounds_per_sec {rec['rounds_per_sec']} ({rec['aggregations_completed']} of "
            f"{rec['aggregations_target']} aggregations, coordinator_wall_s "
            f"{rec['coordinator_wall_s']}, swarm_wall_s {rec['swarm_wall_s']}), aggregate "
            f"span {rec['aggregate_span']}, 429s {rec['http_429_total']}, retries "
            f"{rec['client_retries_total']}, stale refreshes {rec['stale_refreshes']}, "
            f"accepted {rec['accepted']}, duplicates {rec['duplicates']}, lost outright "
            f"{rec['failed_submits']}, terminated {rec['terminated_early']}, decode pool "
            + ("none" if pool is None else f"{pool['workers']} workers busy_s "
               f"{pool['busy_s']} utilization {pool['utilization']}"))


def phase_loadtest_defaults(torch, ops, card: str, out_dir: Path) -> None:
    """(z1).  Predicted launches: none (the FedBuff and ingest drains are plain
    products in both packages)."""
    from nanofed_tpu_torch.loadgen import run_loadtest_comparison

    art, wall, _ = counted(torch, ops, card, "(z1) loadtest, both paths", lambda:
                           run_loadtest_comparison(out_dir=out_dir / "z1",
                                                   telemetry_dir=out_dir / "z1",
                                                   device="cuda", **LOADTEST_DEFAULTS), {})
    for rec in art["modes"].values():
        print(f"[{card}] (z1) {loadtest_line(rec)}")
        check_loadtest("(z1)", rec, LOADTEST_DEFAULTS["clients"])
    print(f"[{card}] (z1) rounds/s ingest over per-submit "
          f"{art.get('rounds_per_sec_ratio_ingest_over_per_submit')}; wall_s {wall:.1f}")


def phase_loadtest(torch, ops, card: str, out_dir: Path) -> None:
    """(z2).  Predicted launches: none (the ingest drain is a plain product in both
    packages)."""
    from nanofed_tpu_torch.loadgen import run_loadtest

    rec, wall, _ = counted(torch, ops, card, "(z2) ingest at mnist_cnn width", lambda:
                           run_loadtest(mode="ingest", device="cuda", **LOADTEST_FULL), {})
    print(f"[{card}] (z2) {loadtest_line(rec)}; ingest.device_bytes "
          f"{rec['ingest']['device_bytes']} drains {rec['ingest']['drains']}; wall_s {wall:.1f}")
    check_loadtest("(z2)", rec, LOADTEST_FULL["clients"])
    want_bytes = LOADTEST_FULL["ingest_capacity"] * P_MNIST * 4
    if rec["ingest"]["device_bytes"] != want_bytes:
        fail(f"(z2) ingest.device_bytes {rec['ingest']['device_bytes']}, expected {want_bytes}")


def phase_tenants(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(z3): the default roster on the system clock, concurrent then sequential.  Each
    device section is counted by (listener, tenant), so the concurrent run's and every
    sequential run's sections meet their own scheduler's leases.  Predicted: B1
    normalised once a completed charlie round (sync FedAvg on ``linear``), nothing
    else."""
    from nanofed_tpu_torch.communication import network_coordinator as nc
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.service import run_tenant_service

    sections: dict[tuple[int, str], int] = {}
    real = nc.NetworkCoordinator._device_section
    combine = nc.fedavg_combine
    cohorts: list[int] = []  # C of each sync round's B1

    def counting(self):
        key = (id(self.server.transport), self.server.tenant)
        sections[key] = sections.get(key, 0) + 1
        return real(self)

    def recorded_combine(stacked, weights):
        cohorts.append(int(weights.shape[0]))
        return combine(stacked, weights)

    nc.NetworkCoordinator._device_section = counting
    nc.fedavg_combine = recorded_combine
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        art = run_tenant_service(virtual_clock=False, out_dir=out_dir / "z3",
                                 telemetry_dir=out_dir / "z3", tag="z3", device="cuda",
                                 rounds=TENANT_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = ops.launch_counts()
    finally:
        nc.NetworkCoordinator._device_section = real
        nc.fedavg_combine = combine
    tenants = art["tenants"]
    seq = art["sequential"]["per_tenant"]
    for name, t in tenants.items():
        st = art["scheduler"]["tenants"][name]
        print(f"[{card}] (z3) {name} ({t['model']}, {t['algorithm']}): rounds "
              f"{t['rounds_completed']}/{t['rounds_target']}, rounds_per_sec "
              f"{t['rounds_per_sec']}, p50_s {t['submit_latency_s']['p50_s']} p99_s "
              f"{t['submit_latency_s']['p99_s']}, accepted {t['accepted']} duplicates "
              f"{t['duplicates']} failed {t['failed_submits']} 429s {t['http_429_total']} "
              f"retries {t['retries']}, chaos {t['chaos_by_kind']}; leases {st['leases']} "
              f"device_seconds {st['device_seconds']} wait_seconds {st['wait_seconds']} "
              f"resident {st['resident_bytes']} peak {st['peak_extra_bytes']} "
              f"({st['footprint_basis']}); sequential rounds "
              f"{seq[name]['rounds_completed']} wall_s {seq[name]['wall_s']} leases "
              f"{seq[name]['scheduler']['leases']} device_seconds "
              f"{seq[name]['scheduler']['device_seconds']}")
    print(f"[{card}] (z3) concurrent {art['concurrent']}, sequential wall_s "
          f"{art['sequential']['wall_s']} aggregate_rounds_per_sec "
          f"{art['sequential']['aggregate_rounds_per_sec']}, concurrent over sequential "
          f"{art.get('concurrent_over_sequential')}; budget {art['scheduler']['hbm_budget_bytes']} "
          f"({art['scheduler']['hbm_budget_basis']}); wall_s {wall:.1f}; launches {grew}")
    if not (art["isolation"]["zero_rounds_lost"] and art["isolation"]["zero_failed_submits"]
            and all(tenants[n]["rounds_completed"] == tenants[n]["rounds_target"]
                    and tenants[n]["failed_submits"] == 0 for n in ("bravo", "charlie"))):
        fail(f"(z3) isolation: {art['isolation']}")
    if not (tenants["alpha"]["chaos_injected_total"] > 0
            and tenants["bravo"]["chaos_injected_total"] == 0
            and tenants["charlie"]["chaos_injected_total"] == 0):
        fail("(z3) the storm's counters moved outside alpha's registry")
    runs: list[dict[str, int]] = []  # by listener, in order of first use
    listeners: dict[int, int] = {}
    for (listener, name), n in sections.items():
        runs_index = listeners.setdefault(listener, len(listeners))
        if runs_index == len(runs):
            runs.append({})
        runs[runs_index][name] = n
    leases = [{n: st["leases"] for n, st in art["scheduler"]["tenants"].items()}] + [
        {n: seq[n]["scheduler"]["leases"]} for n in tenants]
    seconds = [st["device_seconds"] for st in art["scheduler"]["tenants"].values()] + [
        seq[n]["scheduler"]["device_seconds"] for n in tenants]
    if runs != leases or min(seconds) <= 0:
        fail(f"(z3) device sections {runs} against leases {leases}, device seconds {seconds}")
    charlie = tenants["charlie"]["rounds_completed"] + seq["charlie"]["rounds_completed"]
    want = {k: (charlie if k == "weighted_mean_flat" else 0) for k in grew}
    if grew != want or len(cohorts) != charlie:
        fail(f"(z3) kernel launches {grew}, expected {want}; B1 cohorts {cohorts}")
    # B1 at charlie's shape, timed as the kernel table's rows are.
    c = max(set(cohorts), key=cohorts.count)
    p = sum(int(v.numel()) for v in get_model("linear").init(
        torch.Generator().manual_seed(0)).values())
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(c, p, device="cuda", generator=gen)
    w = torch.rand(c, device="cuda", generator=gen) + 0.5
    err = check_close(torch, f"B1 at charlie's C={c}, P={p}", ops.weighted_mean_flat(x, w),
                      ops.weighted_mean_flat_plain(x, w), **TOL)
    ms = median_ms(lambda: ops.weighted_mean_flat(x, w), torch)
    plain_ms = median_ms(lambda: ops.weighted_mean_flat_plain(x, w), torch)
    lib_ms = median_ms(lambda: w @ x, torch)
    b_ms, b_by = bound_ms(4 * c * p + 4 * c + 4 * p, 2 * c * p)
    print(f"[{card}] (z3) B1 normalised at charlie's shape C={c}, P={p} (cohorts {cohorts}): "
          f"launches {charlie}, bound_ms={b_ms:.6f} ({b_by}) ms={ms:.6f} plain_ms="
          f"{plain_ms:.6f} library_ms={lib_ms:.6f} (w @ x) max_abs_err={err:.3e}")
    return grew


def phase_admission(torch, ops, card: str) -> dict[str, int]:
    """(z4): the bin-pack refuses a 19.7 GB tenant under 16 GiB and admits it under the
    card's ``total_memory`` beside a sync FedAvg tenant; both run, both are removed.
    Predicted launches: B1 normalised once a sync round at C = 8 (2), nothing else."""
    from nanofed_tpu_torch.communication.transport import free_port, tenant_base_url
    from nanofed_tpu_torch.loadgen import SwarmConfig, run_swarm
    from nanofed_tpu_torch.service import (
        AdmissionError,
        FederationService,
        TenantQuota,
        TenantSpec,
    )

    fat = TenantSpec(name="fat", model="mnist_cnn", algorithm="fedbuff", rounds=2,
                     async_buffer_k=8, quota=TenantQuota(ingest_capacity=TENANT_FAT_CAPACITY))
    sync = TenantSpec(name="sync", model="mnist_cnn", algorithm="fedavg", rounds=2,
                      min_clients=8)
    resident = (2 + TENANT_FAT_CAPACITY) * P_MNIST * 4

    async def refused() -> str:
        service = FederationService(port=free_port(), hbm_budget_bytes=TENANT_REFUSED_BUDGET,
                                    device="cuda")
        try:
            service.add_tenant(fat)
        except AdmissionError as e:
            if service.tenants() or service.transport.tenants() or service.scheduler.admitted():
                fail("(z4) a refused tenant stayed mounted")
            return str(e)
        fail("(z4) the 19.7 GB tenant was admitted under 16 GiB")

    message = asyncio.run(refused())
    print(f"[{card}] (z4) refused under {TENANT_REFUSED_BUDGET:,} B: {message}")
    if f"resident {resident:,} B" not in message or f"{TENANT_REFUSED_BUDGET:,} B" not in message:
        fail(f"(z4) the refusal does not carry the footprint's numbers: {message}")

    async def admitted() -> tuple:
        service = FederationService(port=free_port(), device="cuda")
        sessions = {s.name: service.add_tenant(s) for s in (fat, sync)}
        stats = service.scheduler.stats()
        await service.start()
        base = f"http://127.0.0.1:{service.transport.port}"
        try:
            run = asyncio.ensure_future(service.run())

            async def sync_rounds() -> list:
                out = []
                for r in range(sync.rounds):  # one cohort of 8 a round
                    while sessions["sync"].server.current_round < r:
                        await asyncio.sleep(0.01)
                    out.append(await run_swarm(
                        tenant_base_url(base, "sync"), sessions["sync"].params,
                        SwarmConfig(num_clients=8, arrival="burst", seed=10 + r,
                                    client_prefix=f"s{r}"),
                        registry=sessions["sync"].registry))
                return out

            swarms = await asyncio.gather(
                run_swarm(tenant_base_url(base, "fat"), sessions["fat"].params,
                          SwarmConfig(num_clients=2 * fat.async_buffer_k, arrival="burst",
                                      seed=1, client_prefix="f"),
                          registry=sessions["fat"].registry),
                sync_rounds())
            summaries = await asyncio.wait_for(run, 600)
            ingest_bytes = sessions["fat"].server.ingest_pipeline.buffer.device_bytes
            peak = torch.cuda.max_memory_allocated()
            after = service.scheduler.stats()
        finally:
            for name in ("fat", "sync"):
                service.remove_tenant(name)
            await service.stop()
        left = (service.tenants(), service.transport.tenants(), service.scheduler.admitted())
        return stats, summaries, swarms, ingest_bytes, peak, after, left

    torch.cuda.reset_peak_memory_stats()
    (stats, summaries, swarms, ingest_bytes, peak, after, left), wall, grew = counted(
        torch, ops, card, "(z4) admitted beside a sync tenant", lambda: asyncio.run(admitted()),
        {"weighted_mean_flat": sync.rounds})
    print(f"[{card}] (z4) admitted under {stats['hbm_budget_bytes']} B "
          f"({stats['hbm_budget_basis']})")
    for name, st in stats["tenants"].items():
        k = fat.async_buffer_k if name == "fat" else sync.min_clients
        print(f"[{card}] (z4) {name}: resident {st['resident_bytes']:,} B, peak measured "
              f"{st['peak_extra_bytes']:,} B against the analytic (K+2)*P*4 "
              f"{(k + 2) * P_MNIST * 4:,} B (K = {k}; {st['footprint_basis']}); "
              f"cost_hint_s {st['cost_hint_s']}; leases {after['tenants'][name]['leases']} "
              f"device_seconds {after['tenants'][name]['device_seconds']}; rounds "
              f"{summaries[name]['rounds_completed']}/{summaries[name]['rounds_target']}")
    fat_swarm, sync_swarms = swarms
    failed = fat_swarm.failed + sum(r.failed for r in sync_swarms)
    print(f"[{card}] (z4) fat ingest buffer {ingest_bytes:,} B on the card, process peak "
          f"{peak:,} B; swarms failed {failed}; wall_s {wall:.1f}; left mounted {left}")
    if any(summaries[n]["rounds_completed"] != 2 for n in ("fat", "sync")) or failed \
            or ingest_bytes != TENANT_FAT_CAPACITY * P_MNIST * 4 or any(left) \
            or "total_memory" not in stats["hbm_budget_basis"] \
            or any("max_memory_allocated" not in st["footprint_basis"]
                   for st in stats["tenants"].values()):
        fail(f"(z4) admitted run: {summaries}, stats {stats}")
    return grew


JOB_FLAG = "--job"
JOB_COUNTS = "chip_smoke job launches: "
BESIDE_TIMEOUT_S = 900.0  # the jobs' and harness runs' limit from their start


def phase_beside_network(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(k) and (y2): the network rounds resumed from a store, and under a chaos plan;
    then (an2) and (an3), strict mode's guard on the tutorial round and on reads."""
    totals = phase_network_resume(torch, ops, card, out_dir)
    base = out_dir / "y_chaos"
    base.mkdir(parents=True, exist_ok=True)
    add_launches(totals, phase_chaos_network(torch, ops, card, base, wire_setup(torch)))
    add_launches(totals, phase_analysis_guard(torch, ops, card, out_dir))
    return totals


def phase_beside_entry(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(u2)-(u5), (v5), (z1), (z5)'s command line and (fl4)'s FedBuff adapter artifact:
    entry points that time nothing."""
    import logging

    from nanofed_tpu_torch.utils.logger import LogConfig, Logger

    totals = phase_observability_entry(torch, ops, card, out_dir)
    add_launches(totals, phase_transformer_entry(torch, ops, card, out_dir))
    gc.collect()
    torch.cuda.empty_cache()
    Logger().configure(LogConfig(level=logging.WARNING))  # no line a submit
    base = out_dir / "z_service"
    base.mkdir(parents=True, exist_ok=True)
    phase_loadtest_defaults(torch, ops, card, base)
    add_launches(totals, phase_service_cli(torch, ops, card, base))
    base = out_dir / "fl_fleet"
    base.mkdir(parents=True, exist_ok=True)
    phase_fedbuff_adapter(torch, ops, card, base)
    return totals


# (nb): the launches of each code cell of the tutorial notebook, from its rounds.  A
# materialised round launches B1 normalised and B3 once (D: 10 rounds, G: 3 with
# central DP, H: 2 then 2 resumed, L: 6, O: 8); M's FedAvg arm 12 rounds and its SCAFFOLD
# arm 12 rounds of ``scaffold_launches``; each secure client's mask is one B5 and one B7
# (J: 3 clients; K: 3 survivors), the server's unmask one B6, K's recovery one B7.  E, F,
# I, N and P launch none (P's FedBuff combine is a plain sum).
NB_ROUND_CELLS = {"D": 10, "G": 3, "H": 4, "L": 6, "O": 8}


def notebook_launches() -> dict[str, dict[str, int]]:
    """Each code cell's expected launches, by its letter."""
    want: dict[str, dict[str, int]] = {letter: {} for letter in "ABCDEFGHIJKLMNOP"}
    for letter, rounds in NB_ROUND_CELLS.items():
        want[letter] = {"weighted_mean_flat": rounds, "row_sq_norms": rounds}
    add_launches(want["M"], {"weighted_mean_flat": 12, "row_sq_norms": 12})
    add_launches(want["M"], scaffold_launches(12))
    want["J"] = {"quantize_u32": 3, "add_mask": 3, "dequantize_u32": 1}
    want["K"] = {"quantize_u32": 3, "add_mask": 3 + 1, "dequantize_u32": 1}
    return want


def phase_notebook(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(nb): the tutorial notebook of ``scripts/build_notebook_torch.py`` built for the
    card and run cell by cell with its in-process runner in ``out_dir / "nb"`` (the
    committed notebook is not touched); every code cell's launches held against
    :func:`notebook_launches`.  Returns the notebook's launches."""
    builder = evidence_script("build_notebook_torch")
    want = notebook_launches()
    totals: dict[str, int] = {}
    seen: list[dict] = []
    before = [ops.launch_counts()]

    def on_cell(index: int, cell: dict) -> None:
        torch.cuda.synchronize()
        now = ops.launch_counts()
        grew = {k: now[k] - before[0][k] for k in now}
        before[0] = now
        seen.append(grew)
        add_launches(totals, grew)

    t0 = time.perf_counter()
    try:
        nb = builder.execute(builder.build("cuda"), "cuda", out_dir / "nb", on_cell=on_cell)
    except builder.CellError as e:
        fail(f"(nb) {e}")
    wall = time.perf_counter() - t0
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    letters = [c["metadata"]["nanofed_cell"] for c in code]
    if letters != list("ABCDEFGHIJKLMNOP") or len(seen) != len(code):
        fail(f"(nb) cells {letters}, {len(seen)} of them run")
    for letter, cell, grew in zip(letters, code, seen):
        kinds = [o["output_type"] for o in cell["outputs"]]
        if not kinds or "error" in kinds:
            fail(f"(nb) cell {letter}: outputs {kinds}")
        expected = {k: want[letter].get(k, 0) for k in grew}
        if grew != expected:
            fail(f"(nb) cell {letter}: kernel launches {grew}, expected {expected}")
    text = "".join("".join(o.get("text", "")) for o in code[0]["outputs"])
    print(f"[{card}] (nb) the tutorial notebook on the card: {len(code)} code cells in "
          f"{wall:.1f} s, launches {totals}; cell A: {text.strip().splitlines()[0]}")
    return totals


# Work that times nothing (no finding reads its seconds), each job in a process of its
# own beside (o)-(r) and the cross-check (``python3 chip_smoke.py --job NAME DIR``), its
# phases in turn.  The jobs share the card's 80 GB with the parent's (w3) references
# (12 GB), so none holds much: (w3)'s ranks take about 25 GB and the other two-rank
# meshes run after it in the same world, the kernel checks up to about 8 GB.  (n)'s
# evaluator fits 1000 clients at once (tens of GB), so (m) and (n) stay in the serial
# part, as do (c) (15 GB), (v) and (z4).
JOBS = {
    "mesh_pairs": (phase_mesh_pairs,),
    "checks, runner": (phase_kernel_checks, phase_slice_guarded, phase_cifar_cross_check,
                       phase_autotune_runner),
    "network": (phase_beside_network,),
    "entry": (phase_beside_entry,),
    "notebook": (phase_notebook,),
}


def run_job(torch, ops, name: str, out_dir: Path) -> None:
    """One of ``JOBS`` in this process: its launch counts as the last line."""
    from nanofed_tpu_torch.ops import _build

    _build.build()  # the parent's build, loaded
    card = nvidia_smi()
    out_dir.mkdir(parents=True, exist_ok=True)
    # Jobs share the host's cores with (o)-(r) and one another: two threads each for
    # the CPU's tensor ops, where torch would take them all.
    torch.set_num_threads(2)
    counts: dict[str, int] = {}
    for phase in JOBS[name]:
        t0 = time.perf_counter()
        add_launches(counts, phase(torch, ops, card, out_dir))
        torch.cuda.synchronize()
        print(f"[{card}] job {name}: {phase.__name__} wall_s={time.perf_counter() - t0:.1f}")
        gc.collect()
        torch.cuda.empty_cache()
    print(JOB_COUNTS + json.dumps({k: counts.get(k, 0) for k in ops.launch_counts()}))


def start_job(name: str, out_dir: Path) -> tuple:
    """``python3 chip_smoke.py --job NAME DIR`` started, its output to a log in a
    directory of its own under ``out_dir``; it and every process it spawns are stopped
    at the interpreter's exit unless read."""
    root = Path(__file__).resolve().parent
    job_dir = out_dir / f"job_{len(list(out_dir.glob('job_*')))}"
    job_dir.mkdir(parents=True, exist_ok=True)
    log = job_dir / "job.log"
    with open(log, "w") as handle:
        proc = subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), JOB_FLAG, name,
                                 str(job_dir)], stdout=handle, stderr=subprocess.STDOUT,
                                cwd=root, start_new_session=True)
    started = (proc, time.perf_counter())
    return name, log, started, atexit_stop(started)


def finish_job(job: tuple, timeout_s: float) -> dict[str, int]:
    """Wait for a started job; print its output; fail unless it exits 0.  Returns its
    launch counts."""
    import atexit

    name, log, started, stop = job
    proc, t0 = started
    try:
        proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_harness(started)
        print(log.read_text()[-8000:])
        fail(f"job {name}: ran past {timeout_s} s")
    atexit.unregister(stop)
    text = log.read_text()
    print(text, end="" if text.endswith("\n") else "\n")
    if proc.returncode != 0:
        fail(f"job {name} exited {proc.returncode}")
    last = [line for line in text.splitlines() if line.startswith(JOB_COUNTS)]
    return json.loads(last[-1][len(JOB_COUNTS):])


def start_beside(card: str, out_dir: Path) -> dict:
    """Everything that times nothing, started: ``JOBS``, (w4)'s ``torchrun`` run, (z5)'s
    ``federate`` and (y3)'s ``smoke``.  They run beside one another and beside (o)-(r)'s
    network rounds, whose seconds no finding reads, and the cross-check of part 4,
    which times nothing either; never beside a phase whose seconds a finding reads.
    Each is stopped at the interpreter's exit unless read."""
    from nanofed_tpu_torch.communication.transport import free_port

    torchrun = (subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
         "--master_port", str(free_port()), "-m", "nanofed_tpu_torch.cli", "run",
         "--distributed", "--model", "mlp", "--clients", "8", "--rounds", "1", "--epochs",
         "1", "--train-size", "480", "--batch-size", "20", "--out-dir", str(out_dir / "w4")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True),
        time.perf_counter())
    federate = start_harness(["federate", *FEDERATE_ARGS, "--tmp-dir", str(out_dir / "fed"),
                              "--out-dir", str(out_dir / "fed_out")])
    smoke = start_chaos_smoke(card, out_dir)
    beside = {"torchrun": (torchrun, atexit_stop(torchrun)),
              "federate": (federate, atexit_stop(federate)),
              "smoke": (smoke, atexit_stop(smoke)),
              "jobs": [start_job(name, out_dir) for name in JOBS], "seconds": {}}
    started = {"(w4) torchrun": torchrun, "(z5) federate": federate, "(y3) smoke": smoke,
               **{f"job {job[0]}": job[2] for job in beside["jobs"]}}

    def watch() -> None:
        """Each run's seconds from its start to its end, as it ends."""
        t_wait = time.perf_counter()
        while (len(beside["seconds"]) < len(started)
               and time.perf_counter() - t_wait < BESIDE_TIMEOUT_S):
            for name, (proc, t0) in started.items():
                if name not in beside["seconds"] and proc.poll() is not None:
                    beside["seconds"][name] = round(time.perf_counter() - t0, 1)
            time.sleep(0.2)

    beside["watcher"] = threading.Thread(target=watch, name="beside-watcher", daemon=True)
    beside["watcher"].start()
    print(f"[{card}] (w4) torchrun, (z5) federate, (y3) smoke and the jobs {list(JOBS)} "
          "started beside (o)-(r) and the cross-check")
    return beside


def finish_beside(card: str, beside: dict) -> tuple[dict[str, int], dict[str, float]]:
    """Read everything :func:`start_beside` started, once all of it has ended.  Returns
    the launches of their main paths and each one's seconds from its start to its end."""
    import atexit

    beside["watcher"].join()
    seconds = beside["seconds"]
    finish_torchrun(card, *beside["torchrun"])
    finish_federate(card, *beside["federate"])
    smoke, stop = beside["smoke"]
    totals = finish_chaos_smoke(card, smoke)
    atexit.unregister(stop)
    for job in beside["jobs"]:
        add_launches(totals, finish_job(job, BESIDE_TIMEOUT_S))
    print(f"[{card}] beside (o)-(r): seconds from each start to its end {json.dumps(seconds)}")
    return totals, seconds


def finish_torchrun(card: str, started: tuple, stop) -> None:
    """(w4): ``nanofed-tpu-torch run --distributed`` under ``torchrun`` (one rank over
    NCCL) exits 0 with its rounds on the card."""
    import atexit

    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        fail("(w4) torchrun run --distributed ran past 300 s")
    atexit.unregister(stop)
    if proc.returncode != 0:
        fail(f"(w4) torchrun run --distributed exited {proc.returncode}: {stderr[-2000:]}")
    summary = json.loads(stdout)
    print(f"[{card}] (w4) torchrun --nproc_per_node 1 run --distributed (nccl), beside the "
          f"cross-check: exit 0 {time.perf_counter() - t0:.3f} s after its start, "
          f"rounds_completed={summary['rounds_completed']} "
          f"params_device={summary['params_device']}")
    if summary["rounds_completed"] != 1 or "cuda" not in summary["params_device"]:
        fail(f"(w4) torchrun run --distributed summary {summary}")


def finish_federate(card: str, started: tuple, stop) -> None:
    """(z5): ``scripts/multihost_harness_torch.py federate`` on 2 gloo ranks sharing the
    card, every host's params within 1e-5 of the numpy replay of the drained rounds,
    nothing lost, no orphans."""
    import atexit

    record = harness_json(finish_harness(card, "(z5) federate", started, 600))
    atexit.unregister(stop)
    oracle = record["oracle"]
    print(f"[{card}] (z5) federate 2 gloo ranks on the card: oracle gaps "
          f"{oracle['max_abs_gap_by_host']} (tolerance {oracle['tolerance']}), hosts "
          f"bit-equal {oracle['hosts_bit_equal']}; rounds {record['rounds']}; wire "
          f"{record['wire']}; walltime_s {record['walltime_s']}")
    if not (max(oracle["max_abs_gap_by_host"]) <= 1e-5 and oracle["hosts_bit_equal"]
            and record["zero_lost_submits"] and record["platform"] == "gpu"
            and not record["orphans"]):
        fail(f"(z5) federate record {json.dumps(record)[:3000]}")


def phase_service_cli(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(z5): ``loadtest`` and ``tenants`` through ``cli.main`` at small sizes (no B1:
    the two tenants are FedBuff); its ``federate`` run is :func:`start_beside`'s."""
    import contextlib
    import io

    from nanofed_tpu_torch import cli
    from nanofed_tpu_torch.observability.telemetry import summarize_telemetry

    d = out_dir / "z5"

    def run_cli():
        with contextlib.redirect_stdout(io.StringIO()):
            lt = cli.main(["loadtest", "--device", "cuda", "--clients", "200",
                           "--async-buffer", "25", "--rate", "5000", "--max-inflight", "128",
                           "--ingest-capacity", "128", "--virtual-clock",
                           "--out-dir", str(d), "--telemetry-dir", str(d)])
            tn = cli.main(["tenants", "--device", "cuda", "--tenants", "2", "--rounds", "2",
                           "--clients", "24", "--virtual-clock", "--no-sequential",
                           "--tag", "z5", "--out-dir", str(d), "--telemetry-dir", str(d)])
        return lt, tn

    (lt, tn), wall, grew = counted(torch, ops, card, "(z5) cli loadtest and tenants",
                                   run_cli, {})
    loadtest = json.loads(sorted(d.glob("loadtest_*.json"))[-1].read_text())
    tenants = json.loads((d / "tenants_z5.json").read_text())
    digest = summarize_telemetry(d / "telemetry.jsonl")
    print(f"[{card}] (z5) loadtest exit {lt}: "
          + "; ".join(loadtest_line(r) for r in loadtest["modes"].values())
          + f"; tenants exit {tn}: isolation {tenants['isolation']}; metrics-summary "
          f"loadtests {sorted(digest['loadtests'])} tenants {sorted(digest['tenants'])}")
    if (lt, tn) != (0, 0) or sorted(digest["loadtests"]) != ["ingest", "per-submit"] \
            or sorted(digest["tenants"]) != ["alpha", "bravo"]:
        fail(f"(z5) cli exits {(lt, tn)}, digest {digest}")
    return grew


def phase_service(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(z): load and service, (z2)-(z4) ((z1) and (z5) time nothing and run beside
    (o)-(r)).  Returns the launches of (z2)-(z4)."""
    import logging

    from nanofed_tpu_torch.utils.logger import LogConfig, Logger

    Logger().configure(LogConfig(level=logging.WARNING))  # no line a submit
    t_phase = time.perf_counter()
    base = out_dir / "z_service"
    base.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    phase_loadtest(torch, ops, card, base)
    t1 = time.perf_counter()
    add_launches(totals, phase_tenants(torch, ops, card, base))
    t2 = time.perf_counter()
    add_launches(totals, phase_admission(torch, ops, card))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{card}] (z) wall_s={time.perf_counter() - t_phase:.1f} ((z2) "
          f"{t1 - t_phase:.1f}, (z3) {t2 - t1:.1f}, (z4) {time.perf_counter() - t2:.1f}); "
          f"launches {totals}")
    return totals


FLEET_POPULATION = 24  # (fl1): sub-swarms of 7 phones, 5 edge boxes and 1 silo a round
FLEET_CAPACITY = 16  # (fl1): ingest rows, 6.25 GB at the base transformer's width
FLEET_ROUNDS = 2  # (fl1): publish, swarm, drain, publish (depth cut from 3 to fit the time)
FLEET_ROW_RTOL = 1e-5  # (fl1): a buffered row against its float64 host recomputation
FLEET_VIEW_RTOL = 1e-4  # (fl1): a view's image against numpy's float64 truncated SVD
FLEET_TAIL_TOL = 1e-6  # (fl1): the projection error against the singular-value tail
FLEET_ROUTE_RTOL = 1e-5  # (fl2): the padded route against the dense one
FLEET_CHECK_LEAVES = ("head/kernel", "block_0/attn/wq/kernel")  # (fl1): 768x8192, 768x768
FLEET_EVIDENCE = dict(num_clients=30, num_rounds=4, swarm_clients=60)  # (fl4), cut depth
FLEDBUFF_CLIENTS = 100  # (fl4): the FedBuff adapter artifact's clients (its default: 400)
FLEDBUFF_AGGREGATIONS = 4  # (fl4): of the 6 that 200 submits fill at K = 32 (default: 12)


def rel_gap(got, want) -> float:
    """max|got - want| over max|want| (numpy float64)."""
    import numpy as np

    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def fleet_host_row(spec, tree: dict, view_tree: dict, slices: dict, size: int):
    """A tier submit's row recomputed on the host in float64: ``scaling * A @ B`` of the
    decoded tree minus the view's, zeros off the targets."""
    import numpy as np

    row = np.zeros(size, np.float64)
    for name, (offset, shape) in slices.items():
        def image(t):
            return spec.scaling * (t[f"{name}/A"].double().numpy() @ t[f"{name}/B"].double().numpy())
        row[offset:offset + shape[0] * shape[1]] = (image(tree) - image(view_tree)).ravel()
    return row


def fleet_host_route_s(gateway, tier: str, body: bytes, view) -> float:
    """Seconds of one submit's row built on the host, as the JAX gateway builds it: the
    decode, ``adapter_delta`` and ``ravel`` in host float32, minus the view's host image
    (copied to the host before the clock starts)."""
    from nanofed_tpu_torch.adapters import adapter_delta
    from nanofed_tpu_torch.fleet import decode_tier_submit
    from nanofed_tpu_torch.utils.trees import ravel

    image = view.flat_dense.cpu().numpy()
    t0 = time.perf_counter()
    tree = decode_tier_submit(gateway.profile.tier(tier), body, view.tree, view.tree)
    row = ravel(adapter_delta(gateway.spec(tier), gateway.base_like, tree)).numpy() - image
    del row
    return time.perf_counter() - t0


def phase_fleet_wire(torch, ops, card: str, out_dir: Path) -> tuple[dict, list]:
    """(fl1): the fleet over live HTTP at the base transformer's width.  Returns the
    per-round numbers and round 1's decoded cohort (for (fl2))."""
    import numpy as np

    import aiohttp

    from nanofed_tpu_torch.adapters import AdapterSpec
    from nanofed_tpu_torch.communication import HTTPServer
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.fleet import (
        AdapterUpdate,
        FleetGateway,
        decode_tier_submit,
        reference_fleet,
        run_fleet_swarm,
        tier_swarm_configs,
    )
    from nanofed_tpu_torch.fleet.aggregate import factor_leaves, factors_error
    from nanofed_tpu_torch.ingest import IngestConfig
    from nanofed_tpu_torch.models.transformer import flagship
    from nanofed_tpu_torch.observability.registry import MetricsRegistry
    from nanofed_tpu_torch.utils.clock import VirtualClock
    from nanofed_tpu_torch.utils.trees import tree_size, unravel

    profile = reference_fleet()
    configs = tier_swarm_configs(profile, FLEET_POPULATION)
    sizes = {name: c.num_clients for name, c in configs.items()}
    if sizes != {"phone": 7, "edge": 5, "silo": 1}:
        fail(f"(fl1) sub-swarms {sizes}, not 7/5/1")
    params = {k: v.cuda() for k, v in flagship("base").init(
        torch.Generator().manual_seed(0)).items()}
    p = tree_size(params)
    gateway = FleetGateway(profile, params, device="cuda")
    n_leaves = len(gateway._slices)
    print(f"[{card}] (fl1) base transformer P={p:,}, {n_leaves} targeted leaves "
          f"({sum(int(np.prod(s)) for _, s in gateway._slices.values()):,} parameters); "
          f"sub-swarms {sizes} of {FLEET_POPULATION}; ingest {FLEET_CAPACITY} rows "
          f"({FLEET_CAPACITY * p * 4:,} B)")
    decode_s: dict[str, list[float]] = {t: [] for t in profile.tier_names()}
    captured: dict[int, list] = {}  # round -> [(tier, body)]
    real_decode = gateway.decode_submit

    def decode(tier, body, round_number):
        t0 = time.perf_counter()
        row = real_decode(tier, body, round_number)
        decode_s[tier].append(time.perf_counter() - t0)
        captured.setdefault(round_number, []).append((tier, body))
        return row

    gateway.decode_submit = decode
    registry = MetricsRegistry()
    clock = VirtualClock()
    server = HTTPServer(port=free_port(), registry=registry, clock=clock, max_inflight=128,
                        ingest=IngestConfig(capacity=FLEET_CAPACITY), fleet=gateway,
                        device="cuda")
    url = f"http://127.0.0.1:{server.port}"
    rounds: list[dict] = []
    cohort: list = []

    def check_views_against_numpy(global_params) -> list[str]:
        """The two leaves' views against numpy's float64 truncated SVD of the same
        global delta, and the projection error against the singular-value tail."""
        lines = []
        for leaf in FLEET_CHECK_LEAVES:
            delta = (global_params[leaf].double() - gateway._base[leaf].double()).cpu().numpy()
            u, s, vt = np.linalg.svd(delta, full_matrices=False)
            offset, shape = gateway._slices[leaf]
            factors = factor_leaves({leaf: torch.from_numpy(delta).cuda()}, [leaf])
            for tier, spec in gateway.specs.items():
                r = spec.rank
                want = (u[:, :r] * s[:r]) @ vt[:r]
                got = gateway.view(tier).flat_dense[offset:offset + shape[0] * shape[1]]
                gap = rel_gap(got.view(shape).cpu().numpy(), want)
                tail = float(np.sqrt(np.sum(s[r:] ** 2) / np.sum(s ** 2)))
                err = factors_error(factors, r)[leaf]
                lines.append(f"{leaf} {tier} r={r}: image rel gap {gap:.3e}, error {err:.6e} "
                             f"tail {tail:.6e}")
                if gap > FLEET_VIEW_RTOL or abs(err - tail) > FLEET_TAIL_TOL:
                    fail(f"(fl1) {leaf} {tier}: view image rel gap {gap:.3e} (tolerance "
                         f"{FLEET_VIEW_RTOL}), error {err} against tail {tail}")
        return lines

    async def campaign():
        global_params = params
        await server.start()
        try:
            t0 = time.perf_counter()
            await server.publish_model(params=global_params, round_number=0)
            publish = {"wall_s": time.perf_counter() - t0, **gateway.last_publish_s}
            for tier in profile.tier_names():
                tree = gateway.view(tier).tree
                dead = [k for k, a in tree.items() if k.endswith("/A")
                        and bool((a.abs().sum(0) == 0).any())]
                if dead or any(bool(tree[k].any()) for k in tree if k.endswith("/B")):
                    fail(f"(fl1) round 0's {tier} view does not revive every direction: {dead}")
            async with aiohttp.ClientSession() as http:
                for r in range(FLEET_ROUNDS):
                    for lst in decode_s.values():
                        lst.clear()
                    bases = {t: gateway.view(t).tree for t in profile.tier_names()}
                    for tier in profile.tier_names():  # one client of a tier fetches its view
                        async with http.get(f"{url}/model",
                                            headers={"X-NanoFed-Tier": tier}) as resp:
                            if await resp.read() != gateway.payload(tier):
                                fail(f"(fl1) GET /model for {tier} is not its view's payload")
                    t1 = time.perf_counter()
                    results = await run_fleet_swarm(url, profile, bases, FLEET_POPULATION,
                                                    seed=r, clock=clock, registry=registry,
                                                    canned_payloads=1)
                    swarm_s = time.perf_counter() - t1
                    for tier, res in results.items():
                        if res.failed or res.accepted != sizes[tier]:
                            fail(f"(fl1) round {r} {tier}: {res.accepted} accepted of "
                                 f"{sizes[tier]} submits, {res.failed} failed")
                    checked = []
                    if r == 0:
                        # One buffered row a tier against its float64 host recomputation.
                        buf = server.ingest_pipeline.buffer
                        seen = set()
                        for tier, body in captured.get(0, []):
                            if tier in seen:
                                continue
                            seen.add(tier)
                            view = gateway.view(tier, 0)
                            tree = decode_tier_submit(profile.tier(tier), body, view.tree,
                                                      view.tree)
                            want = fleet_host_row(gateway.spec(tier), tree, view.tree,
                                                  gateway._slices, p)
                            gaps = []
                            for m in buf.occupied():  # until one of the tier's rows holds
                                if m.metrics.get("tier") == tier:
                                    gaps.append(rel_gap(buf._buf[m.slot].cpu().numpy(), want))
                                    if gaps[-1] <= FLEET_ROW_RTOL:
                                        break
                            host_s = fleet_host_route_s(gateway, tier, body, view)
                            t_card = time.perf_counter()
                            real_decode(tier, body, 0)
                            card_s = time.perf_counter() - t_card
                            checked.append(f"{tier} {min(gaps):.3e}; one submit alone: the "
                                           f"host route (the JAX gateway's: densify and "
                                           f"subtract in host float32) {host_s:.4f} s, the "
                                           f"card route {card_s:.4f} s")
                            if min(gaps) > FLEET_ROW_RTOL:
                                fail(f"(fl1) no buffered {tier} row within {FLEET_ROW_RTOL} "
                                     f"of its host recomputation: {gaps}")
                    if r == 1:
                        for tier, body in captured.get(1, []):
                            view = gateway.view(tier, 1)
                            tree = decode_tier_submit(profile.tier(tier), body, view.tree,
                                                      view.tree)
                            cohort.append(AdapterUpdate(
                                spec=gateway.spec(tier), tier=tier,
                                adapters={k: v.cuda() for k, v in tree.items()}))
                    torch.cuda.synchronize()
                    before = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t2 = time.perf_counter()
                    flat, metas = await server.drain_ingest_fedavg()
                    torch.cuda.synchronize()
                    drain_s = time.perf_counter() - t2
                    drain_peak = torch.cuda.max_memory_allocated() - before
                    global_params = {k: v.clone() for k, v in unravel(flat, params).items()}
                    del flat
                    t3 = time.perf_counter()
                    await server.publish_model(params=global_params, round_number=r + 1)
                    next_publish = {"wall_s": time.perf_counter() - t3,
                                    **gateway.last_publish_s}
                    async with http.get(f"{url}/metrics") as resp:
                        text = await resp.text()
                    bytes_by_tier = {
                        f"{t} {d}": prom_value(text, f'nanofed_fleet_bytes_total{{tier="{t}",'
                                                     f'direction="{d}"}}')
                        for t in profile.tier_names() for d in ("rx", "tx")}
                    accepted = {t: prom_value(text, f'nanofed_fleet_updates_total{{tier="{t}",'
                                                    'result="accepted"}')
                                for t in profile.tier_names()}
                    if accepted != {t: float(sizes[t] * (r + 1)) for t in sizes}:
                        fail(f"(fl1) round {r}: accepted by tier {accepted}")
                    views = check_views_against_numpy(global_params) if r == 0 else []
                    rounds.append({
                        "round": r, "publish": publish, "swarm_s": swarm_s,
                        "decode_s": {t: (statistics.median(v) if v else None)
                                     for t, v in decode_s.items()},
                        "drain_s": drain_s, "drain_peak_bytes": drain_peak,
                        "drained": len(metas), "bytes": bytes_by_tier,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "allocated_bytes": torch.cuda.memory_allocated(),
                        "rows_checked": checked, "views_checked": views})
                    publish = next_publish
        finally:
            server.stop_training()
            await server.stop()
        return global_params

    torch.cuda.reset_peak_memory_stats()
    global_params, wall, _ = counted(torch, ops, card, "(fl1) the fleet over live HTTP",
                                     lambda: asyncio.run(campaign()), {})
    for rec in rounds:
        pub = rec["publish"]
        print(f"[{card}] (fl1) round {rec['round']}: publish {pub['wall_s']:.3f} s (factor "
              f"{pub['factor_s']:.3f}, views {pub['views_s']:.3f}, encode {pub['encode_s']:.3f}); "
              f"swarm {rec['swarm_s']:.3f} s; decode s/submit "
              + ", ".join(f"{t} {v:.4f}" for t, v in rec["decode_s"].items() if v is not None)
              + f"; drain {rec['drain_s']:.4f} s over {rec['drained']} rows (peak +"
              f"{rec['drain_peak_bytes']:,} B); bytes {rec['bytes']}; card peak "
              f"{rec['peak_bytes']:,} B, allocated {rec['allocated_bytes']:,} B")
        for line in rec["rows_checked"]:
            print(f"[{card}] (fl1) round 0 buffered row vs float64 host: {line}")
        for line in rec["views_checked"]:
            print(f"[{card}] (fl1) round 1 view: {line}")
    last = rounds[-1]["publish"]
    print(f"[{card}] (fl1) final publish {last['wall_s']:.3f} s; wall_s {wall:.1f}; "
          f"launches 0 as predicted (the drain is a plain product)")
    del global_params
    return {"rounds": rounds, "params": params, "p": p, "gateway": gateway}, cohort


def phase_fleet_routes(torch, card: str, params: dict, cohort: list) -> None:
    """(fl2): both aggregation routes over round 1's decoded cohort on the card
    (uniform weights)."""
    from nanofed_tpu_torch.fleet import aggregate_dense, aggregate_padded

    out = {}
    for name, route in (("dense", aggregate_dense), ("padded", aggregate_padded)):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        agg = route(cohort, params)
        torch.cuda.synchronize()
        out[name] = (agg, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - before)
    dense, padded = out["dense"][0], out["padded"][0]
    scale = max(float(v.abs().max()) for v in dense.values()) or 1.0
    gap = max(float((dense[k] - padded[k]).abs().max()) for k in dense) / scale
    ranks = sorted({u.spec.rank for u in cohort})
    print(f"[{card}] (fl2) {len(cohort)} updates, ranks {ranks}: dense {out['dense'][1]:.4f} s "
          f"peak +{out['dense'][2]:,} B; padded {out['padded'][1]:.4f} s peak "
          f"+{out['padded'][2]:,} B; rel gap {gap:.3e} (tolerance {FLEET_ROUTE_RTOL})")
    if gap > FLEET_ROUTE_RTOL:
        fail(f"(fl2) padded route {gap:.3e} from the dense one")


def phase_fleet_tuning(torch, ops, card: str, out_dir: Path, wire: dict) -> dict[str, int]:
    """(fl3): the fleet footprint against a drain's measured peak, the mix sweep under the
    card's budget, and ``TuningSpace.for_fleet`` at the evidence config (chunk and batch
    pinned), its per-rank step costs fed to the mix sweep."""
    from nanofed_tpu_torch.adapters import AdapterSpec, adapter_param_count
    from nanofed_tpu_torch.fleet import reference_fleet, sweep_fleet_mix
    from nanofed_tpu_torch.models.transformer import flagship
    from nanofed_tpu_torch.observability.profiling import TIMED_CALLS
    from nanofed_tpu_torch.service.scheduler import TenantFootprint
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.tuning import PopulationSpec, TuningSpace, autotune

    profile = reference_fleet()
    fp = TenantFootprint.for_fleet(profile, wire["params"], ingest_capacity=FLEET_CAPACITY)
    peaks = [rec["drain_peak_bytes"] for rec in wire["rounds"]]
    allocated = max(rec["allocated_bytes"] for rec in wire["rounds"])
    print(f"[{card}] (fl3) TenantFootprint.for_fleet: resident {fp.resident_bytes:,} B, peak "
          f"{fp.peak_extra_bytes:,} B ({fp.basis}); measured: a drain's peak "
          f"+{max(peaks):,} B (rounds {peaks}), allocated after a publish {allocated:,} B")
    outcomes = sweep_fleet_mix(profile, wire["params"], FLEET_POPULATION,
                               ingest_capacity=FLEET_CAPACITY, device="cuda")
    feasible = [o for o in outcomes if o.feasible]
    print(f"[{card}] (fl3) sweep_fleet_mix under total_memory: {len(feasible)} of "
          f"{len(outcomes)} feasible; best {feasible[0].to_dict() if feasible else None}")
    model = flagship("evidence")
    population = lm_population(LM_CLIENTS, 32, 16, "evidence")
    pop = PopulationSpec.from_client_data(population)
    space = dataclasses.replace(TuningSpace.for_fleet(profile, pop, 1, 16, 1),
                                client_chunks=(None,), batch_sizes=(16,))
    if space.adapter_ranks != (2, 4, 8, 16, 32, 64):
        fail(f"(fl3) for_fleet ranks {space.adapter_ranks}")
    training = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.2)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = autotune(model, pop, training, space=space, adapter=AdapterSpec(rank=8),
                      cache_dir=out_dir / "fl3_cache", out_dir=out_dir / "fl3_sweep",
                      device="cuda")
    torch.cuda.synchronize()
    grew = ops.launch_counts()
    print(f"[{card}] (fl3) autotune over TuningSpace.for_fleet: wall_s="
          f"{time.perf_counter() - t0:.3f} launches={grew}")
    want, oom = sweep_launches(result.to_dict(), LM_CLIENTS, 2 + TIMED_CALLS)
    check_launches("(fl3) autotune(TuningSpace.for_fleet)", grew, want, oom)
    print(f"[{card}] (fl3) launches equal sweep_launches: {want} ({oom} out-of-memory)")
    costs = {o.config.adapter_rank: o.cost["measured_s_per_round"]
             for o in result.outcomes if o.feasible and "measured_s_per_round" in o.cost}
    if sorted(costs) != [2, 4, 8, 16, 32, 64]:
        fail(f"(fl3) measured step costs for ranks {sorted(costs)}")
    priced = sweep_fleet_mix(profile, wire["params"], FLEET_POPULATION,
                             ingest_capacity=FLEET_CAPACITY, step_costs=costs, device="cuda")
    print(f"[{card}] (fl3) per-rank step costs {costs}; priced best "
          f"{priced[0].to_dict()}")
    # B1 and B3 at the sweep's smallest and largest adapter shapes, timed (no count).
    like = model.init(torch.Generator().manual_seed(0))
    time_lm_reduces(torch, ops, card, tuple(
        (LM_CLIENTS, adapter_param_count(AdapterSpec(rank=r), like)["adapter_params"],
         "normalised") for r in (2, 64)), "(fl3)")
    return grew


def phase_fleet_evidence(torch, ops, card: str, out_dir: Path) -> None:
    """(fl4): the fleet evidence at cut depth (no launch: the drains are plain
    products)."""
    from nanofed_tpu_torch.fleet.evidence import generate_fleet_evidence

    art, wall, _ = counted(torch, ops, card, "(fl4) generate_fleet_evidence", lambda:
                           generate_fleet_evidence(out_dir=out_dir / "fl4", device="cuda",
                                                   **FLEET_EVIDENCE), {})
    print(f"[{card}] (fl4) {FLEET_EVIDENCE}: {art['conclusion']}; reached {art['reached']}; "
          f"wall_s {wall:.1f}")
    if art["mixed"]["parity_max_abs_diff"] > 1e-6 or art["swarm"]["failed_total"]:
        fail(f"(fl4) parity {art['mixed']['parity_max_abs_diff']}, lost "
             f"{art['swarm']['failed_total']}")


def phase_fedbuff_adapter(torch, ops, card: str, out_dir: Path) -> None:
    """(fl4): the FedBuff adapter artifact at cut depth (no launch)."""
    from nanofed_tpu_torch.adapters.evidence import generate_fedbuff_adapter_artifact

    art, wall, _ = counted(torch, ops, card, "(fl4) generate_fedbuff_adapter_artifact",
                           lambda: generate_fedbuff_adapter_artifact(
                               out_dir=out_dir / "fl4", clients=FLEDBUFF_CLIENTS,
                               aggregations=FLEDBUFF_AGGREGATIONS, device="cuda"), {})
    print(f"[{card}] (fl4) FedBuff adapter artifact at {FLEDBUFF_CLIENTS} clients and "
          f"{FLEDBUFF_AGGREGATIONS} aggregations (its defaults: 400 and 12): "
          f"{art['conclusion']}; reached {art['reached']}; wall_s {wall:.1f}")
    if art["fedbuff"]["failed_submits"] or not art["reached"]:
        fail("(fl4) the FedBuff adapter scenario lost submits or did not reach its target")


def phase_fleet(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(fl): the heterogeneous fleet, (fl1)-(fl3) ((fl4) times nothing and runs beside
    (o)-(r): :func:`phase_fleet_evidence`).  Returns the launches of (fl3)'s profiled
    sweep, the only ones."""
    import logging

    from nanofed_tpu_torch.utils.logger import LogConfig, Logger

    Logger().configure(LogConfig(level=logging.WARNING))
    t_phase = time.perf_counter()
    base = out_dir / "fl_fleet"
    base.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    wire, cohort = phase_fleet_wire(torch, ops, card, base)
    t1 = time.perf_counter()
    phase_fleet_routes(torch, card, wire["params"], cohort)
    del cohort, wire["gateway"]
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    totals = phase_fleet_tuning(torch, ops, card, base, wire)
    del wire
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{card}] (fl) wall_s={time.perf_counter() - t_phase:.1f} ((fl1) {t1 - t_phase:.1f}, "
          f"(fl2) {t2 - t1:.1f}, (fl3) {time.perf_counter() - t2:.1f}); launches {totals}")
    return totals


AN_ROUNDS = 3  # (an1): one fused block of AN_BLOCK rounds, then one single round
AN_BLOCK = 2


def phase_analysis(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(an): strict mode and the program audit on the card, (an1) and (an4) ((an2) and
    (an3) time nothing and run beside (o)-(r): :func:`phase_analysis_guard`).  Returns
    the launches of (an1)'s strict and plain runs."""
    import contextlib
    import logging

    from nanofed_tpu_torch.analysis import contracts
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
    from nanofed_tpu_torch.utils.logger import LogConfig, Logger
    from nanofed_tpu_torch.utils.trees import ravel

    Logger().configure(LogConfig(level=logging.WARNING))
    t_phase = time.perf_counter()
    split: dict[str, float] = {}

    def lap(label: str) -> None:
        split[label] = round(time.perf_counter() - t_phase - sum(split.values()), 1)
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "an_analysis"
    gc.collect()
    torch.cuda.empty_cache()
    model = get_model("mnist_cnn")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    # Bit-equality between two runs needs cuDNN's deterministic algorithms, as (w1).
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        # (an1) the flagship: an untimed plain run warms the card (kernel builds, cuDNN
        # plans, the allocator), so neither timed run's rounds are the cold ones.  The
        # strict run counts the guard's entries and reads the sync debug mode inside
        # each.
        data, training, chunk = flagship_data(), flagship_training(), 125
        want: dict[str, int] = {}
        add_launches(want, step_launches(chunk, FLAGSHIP["num_clients"]), AN_ROUNDS)

        def build(strict: bool, tag: str):
            t0 = time.perf_counter()
            coord = Coordinator(
                model, data, CoordinatorConfig(num_rounds=AN_ROUNDS, seed=0,
                                               rounds_per_block=AN_BLOCK,
                                               base_dir=base / tag, save_metrics=False),
                training, client_chunk=chunk, device="cuda", strict=strict)
            torch.cuda.synchronize()
            return coord, time.perf_counter() - t0

        real_guard = contracts.strict_mode
        entries: list[int] = []

        @contextlib.contextmanager
        def counting_guard(device=None):
            with real_guard(device):
                entries.append(torch.cuda.get_sync_debug_mode())
                yield

        lap("data")
        warm, _ = build(False, "warm")
        warm.run()
        torch.cuda.synchronize()
        del warm
        gc.collect()
        lap("warm run")
        runs: dict[bool, list] = {False: [], True: []}
        params_seen, strict_coord = [], None
        for i, strict in enumerate((False, True)):
            coord, ctor_s = build(strict, f"an1_{i}")
            entries.clear()
            contracts.strict_mode = counting_guard
            try:
                rounds, wall, grew = counted(torch, ops, card,
                                             f"(an1) flagship strict={strict} run {i}",
                                             coord.run, want)
            finally:
                contracts.strict_mode = real_guard
            add_launches(totals, grew)
            if [m.status for m in rounds] != [RoundStatus.COMPLETED] * AN_ROUNDS:
                fail(f"(an1) strict={strict}: rounds {[m.status for m in rounds]}")
            # The guard: one entry a dispatch (the block and the single round), each
            # with the sync debug mode at "error" (2); none in a plain run.
            want_entries = [2, 2] if strict else []
            print(f"[{card}] (an1) run {i} strict={strict}: guard entries with the sync "
                  f"debug mode read inside: {entries}")
            if entries != want_entries:
                fail(f"(an1) run {i}: guard entries {entries}, expected {want_entries}")
            runs[strict].append((ctor_s, [m.duration_s for m in rounds]))
            params_seen.append(ravel(coord.params))
            if strict and strict_coord is None:
                strict_coord = coord
            else:
                del coord
            gc.collect()
        same = all(torch.equal(x, params_seen[0]) for x in params_seen[1:])
        finite = bool(torch.isfinite(params_seen[0]).all())
        del params_seen
        lap("timed runs")

        def mean(xs):
            return sum(xs) / len(xs)

        ctor = {k: mean([c for c, _ in v]) for k, v in runs.items()}
        block = {k: mean([r for _, rs in v for r in rs[:AN_BLOCK]]) for k, v in runs.items()}
        single = {k: mean([rs[AN_BLOCK] for _, rs in v]) for k, v in runs.items()}
        # The construction's contract checks again, on the built coordinator: their
        # seconds and the peak device memory they add (the factories' transient clones;
        # the programs themselves run on meta tensors).  (an4) times the audit.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        strict_coord._check_contracts()
        contract_s = time.perf_counter() - t0
        check_peak = torch.cuda.max_memory_allocated() - before
        lap("contract checks again")
        print(f"[{card}] (an1) flagship ({FLAGSHIP['num_clients']} clients, "
              f"{FLAGSHIP['compute_dtype']}, client_chunk={chunk}) "
              f"{AN_ROUNDS} rounds as one {AN_BLOCK}-round block then one single round, "
              f"after an untimed warm run, plain then strict: construction plain "
              f"{[round(c, 3) for c, _ in runs[False]]} strict "
              f"{[round(c, 3) for c, _ in runs[True]]} s (strict adds "
              f"{ctor[True] - ctor[False]:.3f} s; the contract checks again "
              f"{contract_s:.3f} s, their peak above the allocated {before} bytes: "
              f"{check_peak} bytes); round_s plain "
              f"{[rs for _, rs in runs[False]]} strict {[rs for _, rs in runs[True]]}; "
              f"strict/plain block round {block[True] / block[False]:.4f}, single round "
              f"{single[True] / single[False]:.4f}; params bit-equal={same}")
        if not (same and finite):
            fail(f"(an1) strict params differ from plain ones (bit-equal {same}, finite "
                 f"{finite})")

        # (an4) the audit of every registered program at full width: the construction's
        # audit again, with an ``audit`` record and a span a program.
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        reports = strict_coord.audit_programs()
        audit_all_s = time.perf_counter() - t0
        audit_peak = torch.cuda.max_memory_allocated() - before
        lap("(an4)")
        print(f"[{card}] (an4) audit_programs(): {audit_all_s:.3f} s, peak above the "
              f"allocated: {audit_peak} bytes; " + "; ".join(
                  f"{r.program} ok={r.ok} checks={list(r.checks)} ranks={r.ranks} "
                  f"collectives={len(r.schedule)}" for r in reports))
        if sorted(r.program for r in reports) != ["round_block", "round_step"] or not all(
                r.ok for r in reports):
            fail(f"(an4) audit: {[f.render() for r in reports for f in r.findings]}")
        del strict_coord, runs, data
        gc.collect()
        torch.cuda.empty_cache()

    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    print(f"[{card}] (an) wall_s={time.perf_counter() - t_phase:.1f} ({split}); launches "
          f"{totals}")
    return totals


def phase_analysis_guard(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(an2) the tutorial round strict and plain, and a strict step that reads a device
    value; (an3) reads under the guard raise, a B1 launch does not.  Their seconds
    compare nothing, so they run beside (o)-(r).  Returns the launches of (an2)'s
    strict and plain runs."""
    import logging

    from nanofed_tpu_torch.analysis import strict_mode
    from nanofed_tpu_torch.data import federate, load_mnist
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.utils.logger import LogConfig, Logger
    from nanofed_tpu_torch.utils.trees import ravel

    Logger().configure(LogConfig(level=logging.WARNING))
    totals: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    base = out_dir / "an_analysis"
    model = get_model("mnist_cnn")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    # Bit-equality between two runs needs cuDNN's deterministic algorithms, as (w1).
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        # (an2) the tutorial round, materialised, plain then strict.
        tutorial = federate(load_mnist("train", None, synthetic_size=TUTORIAL_SAMPLES),
                            num_clients=2, batch_size=64, seed=0, proportions=[0.75, 0.25])
        # One local epoch (the tutorial's two cut to one): the strict construction's meta
        # traces walk every local step, and the script's time is bounded.
        tut_training = TrainingConfig(batch_size=64, local_epochs=1, learning_rate=0.1)
        tut_params, tut_round = {}, {}
        for strict in (False, True):
            coord = Coordinator(model, tutorial, CoordinatorConfig(
                num_rounds=1, seed=0, base_dir=base / f"tutorial_{strict}",
                save_metrics=False), tut_training, device="cuda", strict=strict)
            rounds, _, grew = counted(torch, ops, card, f"(an2) tutorial strict={strict}",
                                      coord.run, step_launches(None, 2))
            add_launches(totals, grew)
            tut_params[strict] = ravel(coord.params)
            tut_round[strict] = rounds[0].duration_s
            del coord
        same = torch.equal(tut_params[True], tut_params[False])
        print(f"[{card}] (an2) tutorial round (12k + 4k samples, 1 epoch, f32), "
              f"materialised: round_s plain {tut_round[False]:.3f} strict "
              f"{tut_round[True]:.3f}; params bit-equal={same}")
        if not (same and bool(torch.isfinite(tut_params[True]).all())):
            fail("(an2) the strict tutorial round differs from the plain one")
        # A strict coordinator whose round step reads a device value with .item(): the
        # construction's checks passed on the real step, so only the guard stands
        # between the read and the card, and its dispatch must raise.  Two clients of
        # 128 samples: the construction's meta traces walk every local step.
        small = federate(load_mnist("train", None, synthetic_size=256), num_clients=2,
                         batch_size=64, seed=0)
        coord = Coordinator(model, small, CoordinatorConfig(
            num_rounds=1, seed=0, base_dir=base / "reading", save_metrics=False),
            tut_training, device="cuda", strict=True)
        real_step = coord._round_step

        def reading_step(*args, **kwargs):
            result = real_step(*args, **kwargs)
            result.metrics["loss"].item()
            return result

        coord._round_step = reading_step
        try:
            coord.run()
            dispatch_raised = "no"
        except RuntimeError as e:
            dispatch_raised = str(e).splitlines()[0]
        torch.cuda.synchronize()
        del coord, real_step, small
        print(f"[{card}] (an2) a strict round step that reads .item() on the card: the "
              f"dispatch raised: {dispatch_raised}")
        if "synchroniz" not in dispatch_raised:
            fail(f"(an2) the guarded dispatch of a reading step did not raise: "
                 f"{dispatch_raised}")

        # (an3) the guard is not vacuous: each read raises, a B1 launch alone does not.
        x = torch.randn(8, 4096, device="cuda")
        w = torch.rand(8, device="cuda")
        host = torch.ones(1024)
        torch.cuda.synchronize()
        reads = {".item()": lambda: x.sum().item(), "bool()": lambda: bool(x.sum() > 0),
                 "pageable copy to the card": lambda: host.to("cuda")}
        raised = {}
        for name, read in reads.items():
            try:
                with strict_mode():
                    read()
                raised[name] = False
            except RuntimeError as e:
                raised[name] = "synchroniz" in str(e)
        ops.reset_launch_counts()
        with strict_mode():
            out = ops.weighted_mean_flat(x, w)
        torch.cuda.synchronize()
        launched = ops.launch_counts()["weighted_mean_flat"]
        err = float((out - ops.weighted_mean_flat_plain(x, w)).abs().max())
        print(f"[{card}] (an3) under strict_mode on the card: raised {raised}; a B1 "
              f"launch alone ran ({launched} launch, max_abs_err {err:.3e} against its "
              "plain version)")
        if not all(raised.values()) or launched != 1 or err > 1e-5:
            fail(f"(an3) the guard: raised {raised}, B1 launches {launched}, err {err}")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return totals


EV_MAX_ROUNDS = 30  # (ev1): record_accuracy_torch's default run (60 rounds) cut to 30
EV_TARGET = 0.97  # (ev1): held-out accuracy of mnist_cnn on the real digits at 28x28
EV_CLIENTS = 4  # (ev3): run_experiment's digits_mlp round
# (ev4): B1 and B3 at the evidence runs' shapes (C, P, form): (ev1)'s 8 mnist_cnn
# clients, digits_mlp(128) at 100 and 1000 clients, digits_mlp(96)'s byzantine cohort of 16, mnist_cnn's DP cohort of 24
# (B1's denom form moves the same bytes) and its label-skew cohort of 10, the fedprox and
# SCAFFOLD cohort of 9 (SCAFFOLD's control-delta sum in the accumulate form), the
# personalization population of 20, the cohort-gather arms' 24 and 240 rows of
# mlp(64->512->10) and asyncfed's sync round of 6 digits_mlp(32) clients.
P_DIGITS_MLP = {32: 2_410, 96: 7_210, 128: 9_610}
P_GATHER_MLP = 38_410
EV_REDUCES = ((8, P_MNIST, "normalised"), (100, P_DIGITS_MLP[128], "normalised"),
              (1000, P_DIGITS_MLP[128], "normalised"), (16, P_DIGITS_MLP[96], "normalised"),
              (24, P_MNIST, "normalised"), (10, P_MNIST, "normalised"),
              (9, P_DIGITS_MLP[96], "normalised"),
              (9, P_DIGITS_MLP[96], "accumulate"), (20, P_DIGITS_MLP[96], "normalised"),
              (24, P_GATHER_MLP, "normalised"), (240, P_GATHER_MLP, "normalised"),
              (6, P_DIGITS_MLP[32], "normalised"))


def evidence_script(name: str):
    """``scripts/<name>.py`` of this checkout, loaded as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def script_launches(tag: str, artifact: dict, want: dict) -> dict[str, int]:
    """The launches an evidence function counted (it zeroes the counts at its start and
    reads them at its end); fail unless they equal ``want``."""
    grew = artifact["device"]["kernel_launches"]
    want = {k: want.get(k, 0) for k in grew}
    if grew != want:
        fail(f"{tag}: kernel launches {grew}, expected {want}")
    return grew


def phase_evidence(torch, ops, run_experiment, card: str, out_dir: Path) -> dict[str, int]:
    """(ev): real data on the card.  (ev1) ``record_accuracy_torch``'s default run,
    ``mnist_cnn`` on the bundled digits upsampled to 28x28, 8 clients, to 97% held-out
    accuracy within ``EV_MAX_ROUNDS``; (ev2) ``record_evidence_torch``'s byzantine mode
    at the reference's depth (16 clients, 2 attackers, 20 rounds, 5 arms of
    ``digits_mlp(96)``), which must hold every defense; (ev3) ``run_experiment(
    model="digits_mlp")``, the command line's path, one round of ``EV_CLIENTS``; (ev4)
    B1 and B3 at the evidence runs' shapes.  Returns the launches of (ev1)-(ev3)."""
    totals: dict[str, int] = {}
    t0 = time.perf_counter()
    acc = evidence_script("record_accuracy_torch").record_accuracy(
        max_rounds=EV_MAX_ROUNDS, device="cuda", base_dir=out_dir / "ev1")
    rounds = len(acc["trajectory"])
    grew = script_launches("(ev1)", acc, {"weighted_mean_flat": rounds, "row_sq_norms": rounds})
    add_launches(totals, grew)
    final = acc["final_test_accuracy"]
    print(f"[{card}] (ev1) {acc['model']} on {acc['dataset']}, {acc['num_clients']} clients: "
          f"held-out accuracy {final} at round {acc['reached_at_round']}, wall clock to "
          f"{EV_TARGET:.0%} {acc['wall_clock_to_target_s']} s; trajectory "
          f"{[row['test_accuracy'] for row in acc['trajectory']]}; B1 normalised "
          f"{grew['weighted_mean_flat']}, B3 {grew['row_sq_norms']}")
    if not acc["reached"] or final < EV_TARGET:
        fail(f"(ev1): held-out accuracy {final} after {rounds} rounds, not {EV_TARGET}")
    t1 = time.perf_counter()

    byz = evidence_script("record_evidence_torch").run_byzantine(device="cuda",
                                                                  base_dir=out_dir / "ev2")
    n = byz["regime"]["num_rounds"]
    # Per round: plain FedAvg B1 and B3 (2 arms); the trimmed mean and the median B3
    # alone; Multi-Krum B1 twice (the params, then its [C, 2] scalars) and B3.
    grew = script_launches("(ev2)", byz, {"weighted_mean_flat": 4 * n, "row_sq_norms": 5 * n})
    add_launches(totals, grew)
    print(f"[{card}] (ev2) {byz['summary']}; defense_holds_per_arm "
          f"{byz['defense_holds_per_arm']}; B1 normalised {grew['weighted_mean_flat']}, "
          f"B3 {grew['row_sq_norms']}; {time.perf_counter() - t1:.1f} s")
    if not byz["defense_holds"]:
        fail(f"(ev2): a defense did not hold: {byz['defense_holds_per_arm']}")
    t2 = time.perf_counter()

    summary, _, grew = counted(
        torch, ops, card, "(ev3) run_experiment(model='digits_mlp')",
        lambda: run_experiment(model="digits_mlp", num_clients=EV_CLIENTS, num_rounds=1,
                               local_epochs=1, batch_size=16, eval_every=1,
                               out_dir=out_dir / "ev3", device="cuda"),
        {"weighted_mean_flat": 1, "row_sq_norms": 1})
    add_launches(totals, grew)
    check_summary("(ev3)", summary, 1)
    print(f"[{card}] (ev3) digits_mlp on the bundled digits: held-out accuracy "
          f"{summary['final_eval_metrics']['accuracy']:.4f} after 1 round of {EV_CLIENTS}")
    t3 = time.perf_counter()
    time_lm_reduces(torch, ops, card, EV_REDUCES, "(ev4)")
    print(f"[{card}] (ev) wall_s={time.perf_counter() - t0:.1f} ((ev1) {t1 - t0:.1f}, (ev2) "
          f"{t2 - t1:.1f}, (ev3) {t3 - t2:.1f}, (ev4) {time.perf_counter() - t3:.1f}); "
          f"launches {totals}")
    return totals


RT_CONFIG = "reference"  # (rt): the reference script's configuration


def phase_retune(torch, ops, card: str, out_dir: Path) -> dict[str, int]:
    """(rt): the online retuner's lifecycle (``scripts/record_retune_evidence_torch.py``
    at its reference configuration) on the card.  It fails on the structural checks and
    on launches other than the derived ones, never on which candidate wins.  Returns its
    launches."""
    from nanofed_tpu_torch.observability.profiling import TIMED_CALLS

    script = evidence_script("record_retune_evidence_torch")
    t0 = time.perf_counter()
    try:
        art = script.record_retune(RT_CONFIG, "cuda", out_dir / "rt", check_outcome=False)
    except AssertionError as e:
        fail(f"(rt) a structural check failed: {e}")
    wall = time.perf_counter() - t0
    grew = art["device"]["kernel_launches"]
    rows = 32  # the reference configuration's clients
    rpb, rounds = script.RPB, script.NUM_ROUNDS
    # Both candidates of the sweep's chunk axis (None, 1) must be feasible: a rejected
    # candidate's partial runs are not derivable.
    if sorted((r["config"]["client_chunk"] or 0) for r in art["aot_ranking"]) != [0, 1]:
        fail(f"(rt) the sweep ranked {art['aot_ranking']}, not both chunks None and 1")

    calls = 2 + TIMED_CALLS  # the profiler's first, counting and timed calls
    want: dict[str, int] = {"dequant_accumulate_flat": calls,
                            "masked_weighted_mean_flat": calls}  # the epilogue table
    for row in art["aot_ranking"]:
        add_launches(want, step_launches(row["config"]["client_chunk"], rows), calls * rpb)
    for name in art["probe"]:
        add_launches(want, step_launches(program_chunk(name), rows), script.PROBE_ROUNDS)
    premise, swap = art["premise"], art["swap"]
    at = swap["round"] if swap is not None else rounds
    add_launches(want, step_launches(program_chunk(premise["aot_winner"]), rows), at)
    if swap is not None:
        add_launches(want, step_launches(program_chunk(swap["new_program"]), rows), rounds - at)
    want = {k: want.get(k, 0) for k in grew}
    print(f"[{card}] (rt) retune lifecycle ({RT_CONFIG}): AOT winner {premise['aot_winner']} "
          f"(scores {premise['aot_scores']}), measured winner {premise['measured_winner']}, "
          f"steady s/round {premise['steady_state_s_per_round']}; {premise['retuner']}"
          + (f" at round {swap['round']}" if swap is not None else "")
          + f"; decisions {json.dumps(art['decisions'])}; post-swap {art['post_swap']}; "
          f"wall_s={wall:.1f} launches={grew}")
    if grew != want:
        fail(f"(rt) kernel launches {grew}, expected {want}")
    return grew


def final_stretch(torch, ops, card: str, out_dir: Path, counts: dict, mark) -> dict:
    """Everything that times nothing, side by side: (o)-(r), part 4, (fl4)'s fleet
    evidence and (w3)'s references in this process, :func:`start_beside`'s runs beside
    them; then (w3)'s ranks against the references.  Adds the launches of the main
    paths to ``counts``; returns each beside run's seconds from its start."""
    gc.collect()
    torch.cuda.empty_cache()  # the jobs beside share the card's memory
    beside = start_beside(card, out_dir)
    add_launches(counts, phase_wire(torch, ops, card))
    mark("phase_wire")
    phase_cross_check(torch, ops, card)
    mark("phase_cross_check")
    (out_dir / "fl_fleet").mkdir()
    phase_fleet_evidence(torch, ops, card, out_dir / "fl_fleet")
    mark("phase_fleet_evidence")
    lm_refs = lm_mesh_refs(torch, ops, out_dir / "w3_refs", counts)
    mark("(w3) references")
    beside_counts, beside_s = finish_beside(card, beside)
    add_launches(counts, beside_counts)
    pairs_dir = next(job[1].parent for job in beside["jobs"]
                     if job[0] == "mesh_pairs") / "mesh_pairs"
    ranks_w3 = torch.load(pairs_dir / "w3_ranks.pt", weights_only=False)  # the job's
    check_lm_mesh(torch, card, pairs_dir, lm_refs, ranks_w3, counts)
    mark("beside (o)-(r) read")
    return beside_s


def main() -> None:
    t_script = time.perf_counter()
    last = [t_script]
    budget: dict[str, float] = {}

    def mark(label: str) -> None:
        now = time.perf_counter()
        print(f"chip_smoke: {label} done at {now - t_script:.1f} s ({now - last[0]:.1f} s)")
        budget[label] = round(now - last[0], 1)
        last[0] = now
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
    if sys.argv[1:2] == [JOB_FLAG]:
        run_job(torch, ops, sys.argv[2], Path(sys.argv[3]))
        return

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
    mark("phase_kernels")
    records.update(phase_quantize(torch, ops, card))
    mark("phase_quantize")
    records["dequant_accumulate_flat"] = phase_dequant(torch, ops, card)
    mark("phase_dequant")
    counts: dict[str, int] = dict.fromkeys(ops.launch_counts(), 0)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "runs") as tmp:
        slice_runs: dict = {}
        for label, run in (
                ("phase_slice", lambda: phase_slice(torch, ops, run_experiment, card, Path(tmp),
                                                    slice_runs)),
                ("phase_secure", lambda: phase_secure(torch, ops, card)),
                ("phase_autotune", lambda: phase_autotune(torch, ops, card, Path(tmp))),
                ("phase_resume", lambda: phase_resume(torch, ops, run_experiment, card,
                                                      Path(tmp))),
                ("phase_dp", lambda: phase_dp(torch, ops, card, Path(tmp))),
                ("phase_scaffold", lambda: phase_scaffold_trainer(torch, ops, run_experiment,
                                                                  card, Path(tmp))),
                ("phase_fused", lambda: phase_fused(torch, ops, card, Path(tmp))),
                ("phase_cifar", lambda: phase_cifar(torch, ops, card, Path(tmp))),
                ("phase_observability", lambda: phase_observability(torch, ops, card,
                                                                    Path(tmp))),
                ("phase_transformer", lambda: phase_transformer(torch, ops, card, Path(tmp))),
                ("phase_mesh", lambda: phase_mesh(torch, ops, card, Path(tmp), slice_runs)),
                ("phase_chaos", lambda: phase_chaos(torch, ops, card, Path(tmp))),
                ("phase_service", lambda: phase_service(torch, ops, card, Path(tmp))),
                ("phase_fleet", lambda: phase_fleet(torch, ops, card, Path(tmp))),
                ("phase_analysis", lambda: phase_analysis(torch, ops, card, Path(tmp))),
                ("phase_evidence", lambda: phase_evidence(torch, ops, run_experiment, card,
                                                          Path(tmp))),
                ("phase_retune", lambda: phase_retune(torch, ops, card, Path(tmp)))):
            add_launches(counts, run())
            mark(label)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "runs") as tmp:
        beside_s = final_stretch(torch, ops, card, Path(tmp), counts, mark)
    print(f"kernels: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main paths: {missing}")

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
    whole = time.perf_counter() - t_script
    print(f"chip_smoke: whole script wall_s={whole:.1f}")
    print("chip_smoke: phase seconds " + json.dumps(
        {**budget, "beside, from each start": beside_s, "whole": round(whole, 1)}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
