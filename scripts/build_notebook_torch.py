#!/usr/bin/env python
"""Build and execute the PyTorch/CUDA port's tutorial notebook
(``examples/mnist/tutorial_torch.ipynb``; counterpart of ``scripts/build_notebook.py``
and its ``examples/mnist/tutorial.ipynb``).

The notebook keeps the reference tutorial's sections in their order (markdown 0-17,
code cells A-P, paired as the reference's ``build()`` pairs them), retold for the
port: PyTorch modules and plain functions, the hand-written CUDA kernels, one card.
Every code cell calls the port's public API on the device cell A resolves.

The script writes nbformat 4.5 JSON itself (cell ids included), so it needs
``nbformat`` nowhere; it executes the cells with ``nbclient`` when ``nbclient`` and
``ipykernel`` import, and otherwise with its in-process runner (:func:`run_inprocess`):
one namespace and one asyncio event loop for every cell (the aiohttp servers of J, K
and P bind to a loop), top-level ``await``, each cell's stdout, stderr and the port's
log lines captured as ``stream`` outputs, and a cell that raises ends the run with its
error output and a nonzero exit.  The notebook's metadata records which runner ran it
and the device (name, power limit, torch and CUDA versions).

Usage (from the repo root; the card by default):
    python scripts/build_notebook_torch.py                  # build and execute on cuda
    python scripts/build_notebook_torch.py --device cpu     # execute on the CPU
    python scripts/build_notebook_torch.py --no-execute     # build only
    python scripts/build_notebook_torch.py --workdir DIR --out NB

Relative paths in the cells (``runs/tutorial`` and so on) resolve under ``--workdir``
(default: the repo root).  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import ast
import asyncio
import contextlib
import io
import json
import logging
import os
import sys
import time
import traceback
import uuid
from pathlib import Path
from typing import Callable

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

NOTEBOOK = REPO / "examples" / "mnist" / "tutorial_torch.ipynb"
CELL_TIMEOUT_S = 600

MD = [
    # 0
    """# NanoFed tutorial on PyTorch and CUDA: federated learning on one GPU

This is the PyTorch/CUDA port's telling of the tutorial (`examples/mnist/tutorial.ipynb`
is the JAX package's). The reference federation (camille-004/nanofed) runs an aiohttp
server plus client coroutines that exchange weights as JSON over localhost. Here the
simulated federated round is **one batched PyTorch program on the card**:

```
round = vmap(local_fit) over the clients ; weighted reduce (a CUDA kernel)
```

- every **client** is a row of stacked tensors `[clients, samples, ...]`, trained in
  one `torch.func.vmap`ped local fit (cuDNN and cuBLAS do the convolutions and products),
- **local training** runs the same steps for every client at once,
- **aggregation** (FedAvg) is `[C, P] x [C] -> [P]`: a hand-written CUDA kernel
  (`nanofed_tpu_torch/ops/csrc/reduce.cu`), with another for the update norms
  (`dp_reduce.cu`),
- the network mode (sections 9, 10 and 15) runs real aiohttp servers and clients, and
  secure aggregation quantizes and masks on the card with the kernels of `quantize.cu`.
""",
    # 1
    """## 1. Device setup

Every entry point of the port takes a device and defaults to the card
(`nanofed_tpu_torch.core.device.resolve_device`: `None` means `"cuda"`, and a missing
card raises rather than falling back). A CPU tensor takes each kernel's plain PyTorch
version; a CUDA tensor launches the kernel. `ops.launch_counts()` counts the launches.""",
    # 2
    """## 2. Data: real images, federated

We use a real dataset that ships with the port (1,797 handwritten 8×8 digit images, UCI
optdigits, `nanofed_tpu_torch/data/digits.csv.gz`; MNIST IDX files load with
`load_mnist(data_dir=...)`). `federate` partitions it into per-client shards and packs
them into ONE `ClientData` batch of `[clients, samples, ...]` arrays with a padding mask:
a batched program wants equal shapes, not ragged Python lists.""",
    # 3
    """## 3. Model: a pure `(init, apply)` pair

No `nn.Module`s: a model is a named pair of plain functions over a flat parameter dict
(`"fc1/kernel"`, ...), which is what lets one program train every client at once.""",
    # 4
    """## 4. Train: the coordinator drives batched rounds

`Coordinator` is the round engine (the reference's `Coordinator.train_round` polls an
HTTP buffer at 1 Hz; this one calls the round step). Round 0 pays the process's start-up
on the card (cuDNN's choice of algorithms, kernel loads); the later rounds are
milliseconds at this scale.""",
    # 5
    """### Inspect the metrics artifacts

Per-round metrics land in `metrics/metrics_round_N.json` with per-client detail: the
format of the reference's artifacts (its `coordinator.py:247-280`).""",
    # 6
    """## 5. Evaluation trajectory

`eval_every` evaluates the global model on held-out data inside the round loop; the
history gives accuracy over rounds.""",
    # 7
    """## 6. Differential privacy in one argument

`central_privacy` turns the reduce into DP-FedAvg: per-client update clipping (the norms
from the `row_sq_norms` kernel) and Gaussian noise inside the aggregation, and the
coordinator accounts the (ε, δ) spend per round (`privacy_epsilon` in the metrics).""",
    # 8
    """## 7. Checkpoint & resume

`FileStateStore` checkpoints round state; a new `Coordinator` with the same store picks
up at the next round: resume is part of the engine.""",
    # 9
    """## 8. Privacy calibration: pick σ for your budget, not by hand

`noise_multiplier_for_budget` inverts the RDP accountant: give it (ε, δ) and the round
count, get the smallest σ that stays within budget.""",
    # 10
    """## 9. Secure aggregation over a REAL network

The masked round end to end on localhost aiohttp: clients enroll X25519 keys, fetch the
roster (canonical order and server-computed normalized weights), pre-scale, quantize and
pairwise-mask their update, and POST the masked uint32 vector. The server sums modulo
2^32 (the pairwise masks cancel *exactly*) and dequantizes the cohort's weighted mean.
It never sees an individual update. (This is the single-round no-dropout Bonawitz
variant; a missing client fails the round closed.)

The cohort enrolls with the port's `cuda` mask backend: each client quantizes with the
`quantize_u32` kernel and adds every pairwise mask in one `add_mask` launch, and the
server dequantizes the sum with `dequantize_u32`, all on the card. (The JAX tutorial uses
the host backend; a cohort uses one backend, pinned at enrollment.)""",
    # 11
    """## 10. Dropout-tolerant secure aggregation (double masking)

In a real federation dropout is the common case: one flaky phone must not kill the
cohort's round. `dropout_tolerant=True` runs the Bonawitz §4 double-masking variant:

1. each round, every client draws a **fresh ephemeral mask key and self-mask seed** and
   Shamir-shares both across the cohort (sealed blobs routed through, but unreadable
   by, the server; per-round freshness means a reveal burns only that round);
2. clients mask with pairwise streams **plus a self mask** and submit;
3. whoever misses the timeout is *dropped*: survivors answer the server's **unmask
   request** with shares of the dropped clients' mask keys and the survivors' self
   seeds, never both secrets of one client;
4. the coordinator reconstructs the orphaned masks (one `add_mask` launch for all the
   corrections), completes the round as the **weighted FedAvg of the survivors**, and
   evicts the dropped client.

Below, `c3` vanishes mid-round (after the share barrier: its masks are already in
everyone's vectors) and the round still completes from 3 survivors.

> **Serving this over the wire** (`nanofed-tpu-torch serve --secure --dropout-tolerant`):
> `--min-clients` is a true *minimum*: enrollment stays open for stragglers (cap it
> with `--max-clients`) until the roster quiesces, and the Shamir threshold is derived
> from the cohort that **actually enrolled** (`max(configured, n//2+1)`), announced to
> clients in the roster and re-derived per round as evictions shrink the cohort. The
> static `threshold=3` below is the library-level equivalent for this fixed 4-client
> cohort.""",
    # 12
    """## 11. Per-round learning-rate schedules

Round-wise client-lr decay is standard FL practice the reference lacks. The schedule's
scale enters the round step as an argument (`round_step(..., lr_scale)`), so one round
program serves every round, and a resumed run continues the schedule exactly (it is a
pure function of the round index).

The *server* optimizer needs no machinery: its state persists across rounds, so a
server learning-rate schedule steps per round natively.""",
    # 13
    """## 12. SCAFFOLD: correct the drift instead of damping it

Under non-IID data, FedAvg's local steps follow each client's own gradient field and
drift toward local optima; FedProx pulls iterates back with a proximal term.
**SCAFFOLD** (Karimireddy et al. 2020) removes the drift at its source: every local step
is corrected by (server control − client control), so in expectation each client walks
the *global* descent direction even on a one-class shard. The population's client
controls live as ONE `[clients, P]` tensor on the card: under partial participation the
cohort's control rows are gathered beside its data rows and the round's deltas
scattered back.

Partial participation is where it shines, and the correction is one round stale: it
wants a *smaller* local lr than FedAvg's tuned value (the paper's η_l = O(1/K) bound).
On the card, over 3 seeds of 25 rounds at 30% participation, SCAFFOLD's last-5-round
accuracy was 0.9469 against FedAvg's 0.8954 and FedProx's 0.8359
(`runs/scaffold_torch.json`, NVIDIA H100 80GB HBM3, 700.00 W).""",
    # 14
    """## 13. q8-delta wire compression

In a real cross-device federation the client-to-server update is the bandwidth bill.
`HTTPClient(update_encoding="q8-delta")` ships each round's **delta** stochastically
rounded to int8 with per-leaf absmax scales: unbiased (FedAvg's mean averages the
rounding noise away), and signatures still verify, because the client signs the
server's exact float32 reconstruction. On the flagship CNN's trained delta the port's
q8 payload is **5.32×** smaller than the binary npz one and 32.71× smaller than the
reference's JSON float lists, with the same final accuracy after 15 fully quantized
rounds (`runs/wire_compression_torch.json`, NVIDIA H100 80GB HBM3, 700.00 W). Below,
the codec itself on a real trained delta.""",
    # 15
    """## 14. Personalized evaluation

Global accuracy understates what federation gives each participant under non-IID
data: a client holding two classes does not need the 10-class decision boundary; it
needs a model that is excellent on ITS distribution after a few local steps.
`split_client_data` carves an honest per-client held-out split, and
`make_personalized_evaluator` fine-tunes the global model on each client's train split
and tests on its held-out split, for the whole population in one batched program that
reuses the rounds' local fit. On the card, 20 label-skewed clients went from 0.9134
(global) to 0.9916 (personalized), a gain of **+0.0782**
(`runs/personalization_torch.json`, NVIDIA H100 80GB HBM3, 700.00 W).""",
    # 16
    """## 15. Asynchronous federation (FedBuff)

The synchronous protocol is a barrier: every round waits for its slowest client.
`NetworkRoundConfig(async_buffer_k=K)` (CLI: `serve --async-buffer K`) removes it: the
server accepts updates based on any of the last `staleness_window` published versions
and aggregates exactly K whenever they arrive, each delta computed against the version
its client fetched and discounted by `(1+s)^-α` (Nguyen et al. 2022). Below, three
clients at different speeds feed a live aiohttp server: no aggregation waits for a
cohort, and stale updates contribute at a discount instead of gating anyone. On the
card, with one slow client of six, FedBuff spent the barrier's 72 updates **2.11×**
faster, and in the barrier's wall time reached 0.9667 against 0.9556
(`runs/asyncfed_torch.json`, NVIDIA H100 80GB HBM3, 700.00 W).""",
    # 17
    """## Where to go next

- **Scale**: `client_chunk` trains 1000 clients in chunks on one card
  (`nanofed-tpu-torch bench mnist_1000`); `compute_dtype="bfloat16"` runs the local
  fits in bf16. Measured on one NVIDIA H100 80GB HBM3 at 700.00 W: **0.438 s** for a
  1000-client `mnist_cnn` round (60 samples a client, 2 epochs, bf16, chunks of 125;
  PERF.md §5, `chip_smoke.py` phase (w)).
- **Real networks**: `nanofed_tpu_torch.communication` has a binary-payload HTTP
  server and client with RSA-PSS-signed updates and optional q8-delta compression;
  `examples/secure_federation/run_secure_torch.py` is the full secure-aggregation
  protocol as a script (`--dropout-tolerant --drop-client 2` shows multi-round recovery
  and eviction), and `nanofed-tpu-torch serve --secure --dropout-tolerant` hosts it.
- **Robustness**: `--robust-trim K` (or `method="median"`) bounds Byzantine clients
  structurally: with 2 poisoned clients of 16 on the card, plain FedAvg fell to 0.0778
  while the trimmed mean held 0.9806 and the median and Multi-Krum 0.9778
  (`runs/byzantine_torch.json`, NVIDIA H100 80GB HBM3, 700.00 W).
- **Profiling**: `Coordinator.profile_programs()` runs each round program and reports
  its counted FLOPs, bytes and measured time; `torch.profiler` traces a round on the card.
- **Benchmarks**: `nanofed-tpu-torch bench --list`; accuracy evidence in
  `runs/accuracy_digits_100c_torch.json` (97% reached at round 19 with 100 clients) and
  `runs/accuracy_digits_cnn28_torch.json` (the flagship CNN at 97.5% on real images,
  round 6).""",
]

CODE = [
    # A (after MD 1)
    """import torch
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.core.device import device_record, resolve_device

DEVICE = resolve_device("cuda")   # raises without a card; "cpu" runs the kernels' plain versions
info = device_record(DEVICE)
print(f"device: {info['name']} ({info['nvidia_smi']}); torch {info['torch']}, CUDA {info['cuda']}")
print("kernels:", list(ops.launch_counts()))""",
    # B (after MD 2)
    """from nanofed_tpu_torch.data import federate, load_digits_dataset, pack_eval

train, test = load_digits_dataset("train"), load_digits_dataset("test")
print(f"train {train.x.shape}, test {test.x.shape}  (real 8x8 digit images)")

client_data = federate(train, num_clients=8, scheme="iid", batch_size=16, seed=0)
print("federated:", type(client_data)(*(a.shape for a in client_data)))""",
    # C (after MD 3)
    """from nanofed_tpu_torch.models import get_model, list_models
from nanofed_tpu_torch.trainer import TrainingConfig

print("model zoo:", list_models())
model = get_model("digits_mlp", hidden=96)
training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.5)
params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
print("params:", {k: tuple(v.shape) for k, v in params.items()})""",
    # D (after MD 4)
    """import time
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

coord = Coordinator(
    model=model,
    train_data=client_data,
    config=CoordinatorConfig(num_rounds=10, seed=0, base_dir="runs/tutorial",
                             eval_every=2),
    training=training,
    eval_data=pack_eval(test, batch_size=128),
    device=DEVICE,
)
t0 = time.time()
history = coord.run()
print(f"{len(history)} rounds in {time.time()-t0:.2f}s "
      f"(round 0 includes the card's start-up)")
for m in history[-3:]:
    print(f"  round {m.round_id}: loss={m.agg_metrics['loss']:.4f} "
          f"acc={m.agg_metrics['accuracy']:.4f} ({m.duration_s*1e3:.1f} ms)")""",
    # E (after MD 5)
    """import json, pathlib
artifact = json.loads(pathlib.Path("runs/tutorial/metrics/metrics_round_9.json").read_text())
print(json.dumps({k: v for k, v in artifact.items() if k != "clients"}, indent=2))
print("per-client weights:", [round(w, 3) for w in artifact["clients"]["weights"]])""",
    # F (after MD 6)
    """final = coord.evaluate()
print("final held-out:", final)
accs = [(m.round_id, m.eval_metrics["accuracy"]) for m in history if m.eval_metrics]
for r, a in accs:
    print(f"  round {r}: test acc {a:.4f} " + "#" * int(a * 40))""",
    # G (after MD 7)
    """from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig
from nanofed_tpu_torch.privacy import PrivacyConfig

dp_coord = Coordinator(
    model=model,
    train_data=client_data,
    config=CoordinatorConfig(num_rounds=3, seed=0, base_dir="runs/tutorial_dp"),
    training=training,
    central_privacy=PrivacyAwareAggregationConfig(
        privacy=PrivacyConfig(epsilon=8.0, delta=1e-5,
                              max_gradient_norm=1.0, noise_multiplier=0.7),
    ),
    device=DEVICE,
)
dp_history = dp_coord.run()
for m in dp_history:
    print(f"round {m.round_id}: acc={m.agg_metrics['accuracy']:.4f} "
          f"ε spent={m.agg_metrics['privacy_epsilon']:.3f} "
          f"(δ={m.agg_metrics['privacy_delta']:.0e})")""",
    # H (after MD 8)
    """import shutil

from nanofed_tpu_torch.persistence import FileStateStore

# Fresh store: a leftover checkpoint from an earlier run would make BOTH
# coordinators resume instead of demonstrating train -> crash -> resume.
shutil.rmtree("runs/tutorial_ckpt", ignore_errors=True)
store = FileStateStore("runs/tutorial_ckpt")
c1 = Coordinator(model=model, train_data=client_data,
                 config=CoordinatorConfig(num_rounds=2, seed=0,
                                          base_dir="runs/tutorial_ckpt"),
                 training=training, state_store=store, device=DEVICE)
c1.run()
print("trained rounds 0-1; store has round", store.restore_latest().round_number)

c2 = Coordinator(model=model, train_data=client_data,
                 config=CoordinatorConfig(num_rounds=4, seed=0,
                                          base_dir="runs/tutorial_ckpt"),
                 training=training, state_store=FileStateStore("runs/tutorial_ckpt"),
                 device=DEVICE)
resumed = c2.run()
print("resumed coordinator ran rounds:", [m.round_id for m in resumed])""",
    # I (after MD 9)
    """from nanofed_tpu_torch.privacy.accounting import RDPAccountant, noise_multiplier_for_budget

rounds = 10
sigma = noise_multiplier_for_budget(epsilon=8.0, delta=1e-5,
                                    sampling_rate=1.0, num_events=rounds)
print(f"calibrated sigma for (eps=8, delta=1e-5) over {rounds} rounds: {sigma:.4f}")

acc = RDPAccountant()
acc.add_noise_event(sigma, 1.0, count=rounds)
print(f"spend check: eps={acc.get_privacy_spent(1e-5).epsilon_spent:.4f} <= 8.0")""",
    # J (after MD 10)
    """import asyncio, socket
from nanofed_tpu_torch.communication import (HTTPClient, HTTPServer,
                                             NetworkCoordinator, NetworkRoundConfig)
from nanofed_tpu_torch.security.secure_agg import (ClientKeyPair, SecureAggregationConfig,
                                                   mask_update)

with socket.socket() as s:      # pick a free port (portable notebook)
    s.bind(("127.0.0.1", 0))
    PORT = s.getsockname()[1]

def seeded(seed):
    return torch.Generator(device=DEVICE).manual_seed(seed)

cfg = SecureAggregationConfig(min_clients=3)
init = model.init(seeded(0))
local = {f"c{i}": model.init(seeded(10 + i)) for i in range(3)}

async def secure_client(cid, n_samples):
    kp = ClientKeyPair.generate()
    async with HTTPClient(f"http://127.0.0.1:{PORT}", cid, timeout_s=30) as c:
        # The cohort's mask backend: the card's kernels (B5 quantize, B7 masks).
        assert await c.register_secagg(kp.public_bytes(), n_samples, backend="cuda")
        roster = await c.fetch_secagg_roster()
        for _ in range(200):                      # bounded: a failed round must error,
            try:                                  # not hang the notebook
                params, rnd, active = await c.fetch_global_model(like=init)
                break
            except Exception:
                await asyncio.sleep(0.05)
        else:
            raise TimeoutError("model never published")
        masked = mask_update(local[cid], roster.index_of(cid), kp,
                             roster.ordered_keys(), rnd, cfg,
                             weight=roster.weights[cid], backend="cuda", device=DEVICE)
        await c.submit_masked_update(masked, {"num_samples": n_samples})

async def secure_round():
    server = HTTPServer(port=PORT)
    await server.start()
    try:
        nc = NetworkCoordinator(server, init,
                                NetworkRoundConfig(num_rounds=1, min_clients=3,
                                                   round_timeout_s=30),
                                secure=cfg, device=DEVICE)
        await asyncio.gather(nc.run(), secure_client("c0", 30.0),
                             secure_client("c1", 10.0), secure_client("c2", 20.0))
        return nc
    finally:
        await server.stop()

before = ops.launch_counts()
nc = await secure_round()
after = ops.launch_counts()
print("history:", nc.history)
delta = {k: float((nc.params[k].cpu() - init[k].cpu()).abs().max()) for k in init}
print("aggregate moved (max |leaf delta|):", delta)
print("kernel launches:", {k: after[k] - before[k]
                           for k in ("quantize_u32", "add_mask", "dequantize_u32")})""",
    # K (after MD 11): dropout-tolerant double masking with a mid-round crash
    """import hashlib
from nanofed_tpu_torch.security.secure_agg import (build_unmask_reveals,
                                                   make_dropout_shares, open_share_inbox)

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    PORT2 = s.getsockname()[1]

# threshold > n/2 (split-view defense); min_clients=3 is the privacy floor the
# 3 survivors still satisfy.
cfg_t = SecureAggregationConfig(min_clients=3, threshold=3, dropout_tolerant=True)
order4 = [f"c{i}" for i in range(4)]
local4 = {c: model.init(seeded(20 + i)) for i, c in enumerate(order4)}

async def tolerant_client(cid, n_samples, drops=False):
    identity = ClientKeyPair.generate()
    async with HTTPClient(f"http://127.0.0.1:{PORT2}", cid, timeout_s=30) as c:
        assert await c.register_secagg(identity.public_bytes(), n_samples, backend="cuda")
        roster = await c.fetch_secagg_roster()
        for _ in range(200):
            try:
                params, rnd, active = await c.fetch_global_model(like=init)
                break
            except Exception:
                await asyncio.sleep(0.05)
        else:
            raise TimeoutError("model never published")
        # Round start: fresh ephemeral secrets, Shamir-shared across the cohort.
        participants = await c.fetch_secagg_participants()
        mask_key = ClientKeyPair.generate()
        ctx = f"{c.secagg_session}:{rnd}"
        self_seed, sealed = make_dropout_shares(
            identity, mask_key, participants,
            {p: roster.public_keys[p] for p in participants}, cfg_t.threshold,
            my_id=cid, context=ctx)
        assert await c.deposit_secagg_shares(
            rnd, mask_key.public_bytes(), sealed,
            self_seed_commitment=hashlib.sha256(self_seed).digest())
        epks, inbox = await c.fetch_secagg_inbox(rnd)
        held = open_share_inbox(identity, cid, roster.public_keys, inbox, epks, ctx)
        if drops:
            print(f"  {cid}: crashing mid-round (after the share barrier)")
            return
        masked = mask_update(local4[cid], participants.index(cid), mask_key,
                             [epks[p] for p in participants], rnd, cfg_t,
                             weight=roster.weights[cid], backend="cuda",
                             self_seed=self_seed, device=DEVICE)
        await c.submit_masked_update(masked, {"num_samples": n_samples})
        for _ in range(600):                       # answer the unmask round
            request = await c.poll_unmask_request()
            if request is not None and cid in request["survivors"]:
                await c.submit_unmask_reveals(
                    request["round"], build_unmask_reveals(request, cid, held))
                return
            status = await c.check_server_status()
            if not status.get("training_active", True):
                return
            await asyncio.sleep(0.05)

async def tolerant_round():
    server = HTTPServer(port=PORT2)
    await server.start()
    try:
        nc = NetworkCoordinator(server, init,
                                NetworkRoundConfig(num_rounds=1, min_clients=4,
                                                   min_completion_rate=0.5,
                                                   round_timeout_s=2.5),
                                secure=cfg_t, device=DEVICE)
        await asyncio.gather(nc.run(),
                             tolerant_client("c0", 30.0), tolerant_client("c1", 10.0),
                             tolerant_client("c2", 20.0),
                             tolerant_client("c3", 40.0, drops=True))
        return nc
    finally:
        await server.stop()

before = ops.launch_counts()
nc2 = await tolerant_round()
after = ops.launch_counts()
print("history:", nc2.history)
print("kernel launches:", {k: after[k] - before[k]
                           for k in ("quantize_u32", "add_mask", "dequantize_u32")})
assert nc2.history[0]["status"] == "COMPLETED" and nc2.history[0]["num_dropped"] == 1""",
    # L (after MD 12): per-round lr schedule, one round program
    """sched_coord = Coordinator(
    model=model,
    train_data=client_data,
    config=CoordinatorConfig(num_rounds=6, seed=0, base_dir="runs/tutorial_sched",
                             save_metrics=False, eval_every=2,
                             lr_schedule="cosine", lr_min_factor=0.2),
    training=TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.5),
    eval_data=pack_eval(test, batch_size=128),
    device=DEVICE,
)
scales = []
for m in sched_coord.start_training():
    scales.append(m.agg_metrics["lr_scale"])
    acc = m.eval_metrics.get("accuracy")
    print(f"round {m.round_id}: lr_scale={scales[-1]:.3f}"
          + (f"  test acc {acc:.4f}" if acc is not None else ""))
assert scales[0] == 1.0 and all(a >= b for a, b in zip(scales, scales[1:]))
assert scales[-1] > 0.2  # decayed toward, but never onto, the floor""",
    # M (after MD 13): SCAFFOLD vs FedAvg under drift + partial participation
    """drift_data = federate(train, num_clients=16, scheme="dirichlet",
                      batch_size=16, seed=1, alpha=0.05)  # ~1-2 classes per client

finals = {}
for name, scaffold in (("fedavg", False), ("scaffold", True)):
    c = Coordinator(
        model=model, train_data=drift_data,
        config=CoordinatorConfig(num_rounds=12, seed=0, participation_rate=0.5,
                                 base_dir="runs/nb_scaffold", save_metrics=False),
        training=TrainingConfig(batch_size=16, local_epochs=16, learning_rate=0.2),
        eval_data=pack_eval(test, batch_size=128),
        scaffold=scaffold,
        device=DEVICE,
    )
    c.run()
    finals[name] = c.evaluate()["accuracy"]
    print(f"{name:9s} final held-out accuracy: {finals[name]:.4f}")
print(f"drift correction buys {finals['scaffold'] - finals['fedavg']:+.4f}")""",
    # N (after MD 14): q8-delta codec on a real trained delta
    """from nanofed_tpu_torch.communication import (decode_delta_q8, encode_delta_q8,
                                             encode_params)
from nanofed_tpu_torch.trainer import client_keys, draw_permutations, make_local_fit

fit_training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.2)
fit = make_local_fit(model, fit_training)
one = client_data.select(slice(0, 1)).to(DEVICE)          # client 0 as a cohort of one
perms = draw_permutations(seeded(3), 1, fit_training.local_epochs, one.y.shape[1])
res = fit(params, one, perms, client_keys(3, 1, DEVICE))
trained = {k: v[0] for k, v in res.params.items()}
delta = {k: (trained[k] - params[k]).float().cpu() for k in params}

wire_q8 = encode_delta_q8(delta, seed=0)
wire_npz = encode_params(trained)
dq = decode_delta_q8(wire_q8, like=delta)
err = max(float((dq[k] - delta[k]).abs().max()) for k in delta)
print(f"npz full params: {len(wire_npz):7d} bytes")
print(f"q8 delta:        {len(wire_q8):7d} bytes  ({len(wire_npz)/len(wire_q8):.2f}x smaller)")
print(f"max dequantization error: {err:.2e} (bounded by absmax/127 per leaf)")""",
    # O (after MD 15): personalized evaluation on the drift federation
    """from nanofed_tpu_torch.trainer import make_personalized_evaluator, split_client_data

fit_cd, heldout_cd = split_client_data(drift_data, test_fraction=0.25, seed=0)
pers_coord = Coordinator(
    model=model, train_data=fit_cd,
    config=CoordinatorConfig(num_rounds=8, seed=0, base_dir="runs/nb_pers",
                             save_metrics=False),
    training=TrainingConfig(batch_size=16, local_epochs=4, learning_rate=0.5),
    device=DEVICE,
)
pers_coord.run()
evaluate = make_personalized_evaluator(
    model, TrainingConfig(batch_size=16, local_epochs=3, learning_rate=0.1))
out = evaluate(pers_coord.params, fit_cd.to(DEVICE), heldout_cd.to(DEVICE), seed=7)
print(f"on clients' OWN held-out data:")
print(f"  global model:       {float(out['global_accuracy']):.4f}")
print(f"  after 3 fine-tune epochs: {float(out['personal_accuracy']):.4f}"
      f"  (gain {float(out['personalization_gain']):+.4f})")""",
    # P (after MD 16): FedBuff async federation over live aiohttp (top-level await)
    """import asyncio
from nanofed_tpu_torch.communication import (HTTPClient, HTTPServer,
                                             NetworkCoordinator, NetworkRoundConfig)

async_training = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.3)
async_fit = make_local_fit(model, async_training)
async_init = model.init(seeded(0))

def fit_client(global_params, idx, seed):
    data = client_data.select(slice(idx, idx + 1)).to(DEVICE)
    perms = draw_permutations(seeded(seed), 1, async_training.local_epochs, data.y.shape[1])
    r = async_fit(global_params, data, perms, client_keys(seed, 1, DEVICE))
    return {k: v[0] for k, v in r.params.items()}, float(r.metrics.loss[0])

_ = fit_client(async_init, 0, 0)  # warm the card's kernels outside the timed federation

async def nb_client(cid, idx, delay, port):
    async with HTTPClient(f"http://127.0.0.1:{port}", cid, timeout_s=30) as c:
        while True:
            try:
                fetched, rnd, active = await c.fetch_global_model(like=async_init)
                if not active:
                    return
                trained, loss = fit_client({k: v.to(DEVICE) for k, v in fetched.items()},
                                           idx, idx * 100 + rnd)
                await asyncio.sleep(delay)   # heterogeneous device speed
                await c.submit_update(trained, {"loss": loss, "num_samples": 100.0})
            except Exception:
                return

import socket
with socket.socket() as _s:      # pick a free port (portable notebook)
    _s.bind(("127.0.0.1", 0))
    PORT = _s.getsockname()[1]
server = HTTPServer(port=PORT)
coord = NetworkCoordinator(server, async_init, NetworkRoundConfig(
    num_rounds=6, async_buffer_k=2, staleness_window=6,
    round_timeout_s=20.0, poll_interval_s=0.01), device=DEVICE)
await server.start()
tasks = [asyncio.ensure_future(nb_client(f"c{i}", i, 0.08 if i == 0 else 0.02, PORT))
         for i in range(3)]
history = await coord.run()
await asyncio.gather(*tasks)
await server.stop()
all_staleness = []
for h in history:
    s = h.get("staleness", [])   # FAILED records carry no staleness
    all_staleness += s
    print(f"aggregation {h['aggregation']} [{h['status']}]: "
          f"{h['num_clients']} updates, staleness {s}")
stale = sum(v > 0 for v in all_staleness)
print(f"{stale}/{len(all_staleness)} aggregated updates were stale — "
      "discounted by (1+s)^-0.5, and no aggregation waited for a cohort")
assert stale > 0  # the demo only teaches what its own run shows""",
]

#: Code cells by letter, A-P, in notebook order.
LETTERS = "ABCDEFGHIJKLMNOP"


def _cell_id() -> str:
    return uuid.uuid4().hex[:8]


def _source(text: str) -> list[str]:
    lines = text.splitlines(keepends=True)
    return lines if lines else [""]


def code_sources(device: str = "cuda") -> list[str]:
    """The code cells A-P, on ``device`` (cell A resolves it; every other cell reads
    ``DEVICE``)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    cells = list(CODE)
    cells[0] = cells[0].replace('resolve_device("cuda")', f'resolve_device("{device}")')
    return cells


def build(device: str = "cuda") -> dict:
    """The notebook as nbformat 4.5 JSON: MD[0], then each MD[i] with CODE[i-1], then
    the closing MD (the pairing of the reference's ``build()``)."""
    assert len(MD) == len(CODE) + 2 == len(LETTERS) + 2
    cells = [{"cell_type": "markdown", "id": _cell_id(), "metadata": {},
              "source": _source(MD[0])}]
    for md_i, code in enumerate(code_sources(device), start=1):
        cells.append({"cell_type": "markdown", "id": _cell_id(), "metadata": {},
                      "source": _source(MD[md_i])})
        cells.append({"cell_type": "code", "id": _cell_id(), "execution_count": None,
                      "metadata": {"nanofed_cell": LETTERS[md_i - 1]}, "outputs": [],
                      "source": _source(code)})
    cells.append({"cell_type": "markdown", "id": _cell_id(), "metadata": {},
                  "source": _source(MD[-1])})
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python",
                              "version": ".".join(map(str, sys.version_info[:3]))},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def write(nb: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(nb, indent=1, ensure_ascii=False) + "\n")


def source_text(cell: dict) -> str:
    src = cell["source"]
    return "".join(src) if isinstance(src, list) else src


class _Tee(io.TextIOBase):
    """A cell's stream: every write becomes a ``stream`` output, consecutive writes to
    the same stream merged (as a kernel's outputs read)."""

    def __init__(self, name: str, outputs: list) -> None:
        self.name, self.outputs = name, outputs

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        if text:
            last = self.outputs[-1] if self.outputs else None
            if last is not None and last["output_type"] == "stream" and last["name"] == self.name:
                last["text"] += text
            else:
                self.outputs.append({"output_type": "stream", "name": self.name,
                                     "text": text})
        return len(text)


@contextlib.contextmanager
def _captured(outputs: list):
    """stdout, stderr and the port's log handlers into ``outputs`` for one cell."""
    out, err = _Tee("stdout", outputs), _Tee("stderr", outputs)
    port_log = logging.getLogger("nanofed_tpu_torch")
    handlers = [h for h in port_log.handlers
                if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)]
    saved = [h.setStream(err) for h in handlers]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            yield
    finally:
        for h, stream in zip(handlers, saved):
            h.setStream(stream)


def _text_lines(outputs: list) -> None:
    """Stream texts as line lists, as nbformat stores them."""
    for o in outputs:
        if o["output_type"] == "stream" and isinstance(o["text"], str):
            o["text"] = _source(o["text"])


async def _cell(code, ns: dict) -> None:
    """One cell inside the running loop, as a kernel runs it: a cell with a top-level
    ``await`` compiles to a coroutine, which is awaited."""
    result = eval(code, ns)  # noqa: S307 - the notebook's own cells
    if asyncio.iscoroutine(result):
        await result


def run_inprocess(nb: dict, workdir: Path, on_cell: Callable[[int, dict], None] | None = None,
                  namespace: dict | None = None) -> dict:
    """Execute every code cell of ``nb`` in this process, in order, in one namespace
    and on one asyncio event loop, with ``workdir`` as the working directory.  A cell
    may ``await`` at top level.  Fills each cell's ``outputs`` and ``execution_count``
    and returns ``nb``.  ``on_cell(index, cell)`` runs after each code cell (the
    notebook's i-th code cell).  A cell that raises gets an ``error`` output and the
    run raises :class:`CellError`."""
    ns = namespace if namespace is not None else {"__name__": "__main__"}
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    cwd = Path.cwd()
    os.chdir(workdir)
    try:
        count = 0
        for cell in nb["cells"]:
            if cell["cell_type"] != "code":
                continue
            count += 1
            outputs: list = []
            cell["outputs"], cell["execution_count"] = outputs, count
            src = source_text(cell)
            try:
                with _captured(outputs):
                    code = compile(src, f"<cell {count}>", "exec",
                                   flags=ast.PyCF_ALLOW_TOP_LEVEL_AWAIT)
                    loop.run_until_complete(asyncio.wait_for(_cell(code, ns), CELL_TIMEOUT_S))
            except BaseException as e:  # noqa: BLE001 - recorded, then raised
                outputs.append({
                    "output_type": "error", "ename": type(e).__name__, "evalue": str(e),
                    "traceback": traceback.format_exception(type(e), e, e.__traceback__),
                })
                _text_lines(outputs)
                raise CellError(count, cell.get("metadata", {}).get("nanofed_cell"), e) from e
            _text_lines(outputs)
            if on_cell is not None:
                on_cell(count - 1, cell)
    finally:
        os.chdir(cwd)
        pending = asyncio.all_tasks(loop)
        for task in pending:
            task.cancel()
        if pending:
            loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
        loop.close()
        asyncio.set_event_loop(None)
    return nb


class CellError(RuntimeError):
    """A notebook cell raised."""

    def __init__(self, index: int, letter: str | None, error: BaseException) -> None:
        super().__init__(f"code cell {index} ({letter or '?'}) raised "
                         f"{type(error).__name__}: {error}")
        self.index, self.letter, self.error = index, letter, error


def nbclient_available() -> bool:
    try:
        import ipykernel  # noqa: F401
        import nbclient  # noqa: F401
        import nbformat  # noqa: F401
    except ImportError:
        return False
    return True


def run_nbclient(nb: dict, workdir: Path) -> dict:
    """Execute ``nb`` with ``nbclient`` in a Python kernel started in ``workdir``, with
    the repo root on the kernel's ``PYTHONPATH`` (this process's environment is left
    as it is).  A cell that raises ends the run with :class:`CellError`."""
    import nbformat
    from nbclient import NotebookClient
    from nbclient.exceptions import CellExecutionError

    node = nbformat.reads(json.dumps(nb), as_version=4)
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)
    try:
        NotebookClient(node, timeout=CELL_TIMEOUT_S, kernel_name="python3",
                       resources={"metadata": {"path": str(workdir)}}).execute(
            env=dict(os.environ, PYTHONPATH=path))
    except CellExecutionError as e:
        code = [c for c in node.cells if c.cell_type == "code"]
        index = next((i for i, c in enumerate(code, 1)
                      if any(o.output_type == "error" for o in c.get("outputs", []))), 0)
        letter = code[index - 1].metadata.get("nanofed_cell") if index else None
        raise CellError(index, letter, e) from e
    return json.loads(nbformat.writes(node))


def execute(nb: dict, device: str = "cuda", workdir: Path = REPO,
            on_cell: Callable[[int, dict], None] | None = None) -> dict:
    """Execute ``nb`` and record the runner and the device in its metadata.  The runner
    is nbclient when it and ipykernel import, else the in-process one; ``on_cell``
    (see :func:`run_inprocess`) asks for the in-process runner."""
    from nanofed_tpu_torch.core.device import device_record, resolve_device

    dev = resolve_device(device)  # raises here, before any cell, without a card
    runner = "nbclient" if on_cell is None and nbclient_available() else "inprocess"
    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if runner == "nbclient":
        nb = run_nbclient(nb, workdir)
    else:
        nb = run_inprocess(nb, workdir, on_cell)
    record = device_record(dev)
    record.pop("kernel_launches")
    nb["metadata"]["nanofed"] = {
        "runner": runner,
        "device": record,
        "executed_s": round(time.perf_counter() - t0, 1),
        "built_by": "scripts/build_notebook_torch.py",
    }
    return nb


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--no-execute", action="store_true", help="build only")
    ap.add_argument("--workdir", default=str(REPO),
                    help="working directory of the cells (default: the repo root)")
    ap.add_argument("--out", default=str(NOTEBOOK), help="notebook path")
    args = ap.parse_args()
    out = Path(args.out)
    nb = build(args.device)
    write(nb, out)
    print(f"wrote {out} ({len(nb['cells'])} cells)")
    if args.no_execute:
        return 0
    print(f"executing on {args.device} ...", flush=True)
    try:
        nb = execute(nb, args.device, Path(args.workdir))
    except CellError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    write(nb, out)
    print(f"executed with {nb['metadata']['nanofed']['runner']} in "
          f"{nb['metadata']['nanofed']['executed_s']} s and saved with outputs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
