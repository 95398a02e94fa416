"""Multi-process federation harness of the PyTorch/CUDA port (counterpart of
``scripts/multihost_harness.py``).

One file, two jobs: a launcher (the default entry) spawns worker processes of this
same script; each worker is one rank of a ``torch.distributed`` world, joined through
``nanofed_tpu_torch.parallel.mesh.initialize_distributed`` over a ``file://``
rendezvous (a fresh path for every world: a stale file breaks the next bring-up).
Every knob rides argv, so the launcher and its workers cannot drift.  The workers are
plain subprocesses, not ``parallel.launch.spawn_world``: the supervisor must see each
worker's own exit code and kill and re-form a world itself.

Ranks run on ``--device`` (default ``cuda``: rank r on ``cuda:{r % cards}``, over
gloo, so ranks may share one card; ``--device cpu`` runs them on the CPU).  Modes:

* ``smoke``: 2 ranks on a ``(2, 1, 1)`` hosts mesh, each holding only its own host's
  client rows (:func:`client_rows`, the JAX harness's numpy draws), held against one
  rank on the same workload (the two worlds run side by side): per-round losses and
  final params within :data:`SMOKE_TOL`.
* ``bench``: rounds/s and clients/s of the hosts-mesh round streamed in
  ``client_chunk`` chunks, with the topology block, written to
  ``<out-dir>/multihost_torch_*.json``.  Ranks that share one card measure the
  program (chunked streaming, host-local then cross-host reduce, one controller per
  rank), not a round across several cards.
* ``hostchaos``: the host fault-tolerance drill.  A supervisor spawns the world under
  a seeded fault plan (``host_crash``/``host_stall``/``dcn_degrade``,
  ``nanofed_tpu_torch.faults``); the workers heartbeat
  (``parallel.resilience.Heartbeat``), run every dispatch inside
  ``CollectiveWatchdog.run`` and commit block-boundary generations
  (``persistence.GenerationStore``) under logical host ids.  When the plan kills or
  stalls a host the supervisor detects it (process exit or frozen heartbeat), kills
  and reaps every worker, re-forms the world over the survivors, resumes from the
  newest generation every participant committed, runs the unfailed shrunk world from
  the same generation for loss parity and, beside it, optionally lets the failed host
  rejoin, and
  writes ``<out-dir>/hostchaos_torch_*.json`` (detection and recovery seconds with the
  start-up seconds named apart, rounds lost, parity gap, orphans) and
  ``host_failure``/``recovery`` records into ``telemetry.jsonl``.
* ``federate`` needs the load generator (ROADMAP queue A item 18) and exits 2.

Run from the repo root, e.g. ``python3 scripts/multihost_harness_torch.py smoke
--device cpu --clients 8``.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # the supervisor and the workers import the port
    sys.path.insert(0, str(REPO))

SMOKE_TOL = 5e-5  # host-local then cross-host reduce vs one rank: re-association only

#: Worker exit code when the collective watchdog (or a gloo error) surfaced a PEER's
#: failure, distinct from the planned victim's own death (HOST_CRASH_RC, imported so
#: the supervisor's match cannot drift from what the injector exits with).
PEER_FAILURE_RC = 32
from nanofed_tpu_torch.faults.host_injector import (  # noqa: E402
    HOST_CRASH_EXIT_CODE as HOST_CRASH_RC,
)

FEDERATE_REFUSAL = (
    "federate needs the load generator (loadgen), which comes with ROADMAP queue A "
    "item 18 (load and service); run scripts/multihost_harness.py federate for it"
)


def _worker_env() -> dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    return env


def client_rows(client_ids, capacity: int, feat: tuple[int, ...], seed: int):
    """Deterministic synthetic data for a range of global client ids: the same rows
    whichever process (and however many) materialises them, so a world of ranks is
    comparable to one rank.  The JAX harness's draws, number for number."""
    import numpy as np

    xs, ys = [], []
    for cid in client_ids:
        rng = np.random.default_rng(seed * 1_000_003 + int(cid))
        y = rng.integers(0, 10, size=capacity)
        x = rng.normal(0, 1, size=(capacity, *feat)).astype(np.float32)
        x[..., 0, 0, 0] += y  # class signal in one coordinate
        xs.append(x.astype(np.float32))
        ys.append(y.astype(np.int32))
    mask = np.ones((len(xs), capacity), np.float32)
    return np.stack(xs), np.stack(ys), mask


def _exit_now(rc: int) -> None:
    """Leave without interpreter teardown: a gloo collective whose peer died is
    wedged in the watchdog's daemon thread, and a normal exit (or
    ``destroy_process_group``) could wait on it."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def run_worker(args: argparse.Namespace) -> int:
    """One rank: join the world, build the hosts mesh, hold only this host's client
    rows, run the round program, report through files."""
    t0 = time.time()
    import numpy as np
    import torch
    import torch.distributed as dist

    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.aggregation.base import fedavg_strategy
    from nanofed_tpu_torch.core.device import resolve_device
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import build_round_step, init_server_state
    from nanofed_tpu_torch.parallel.mesh import (
        MeshLayout,
        host_client_slice,
        initialize_distributed,
        make_mesh,
        pad_client_count,
    )
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.trainer.local import client_keys, draw_permutations

    n = args.num_processes
    pid = args.process_id
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        # Bit-stable convolutions, so a re-formed world is comparable to an unfailed
        # one; TF32 is already off (resolve_device).
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if n > 1:
        info = initialize_distributed(
            "gloo", init_method=f"file://{args.rendezvous}", world_size=n, rank=pid,
            local_rank=pid, device=args.device, timeout_s=args.timeout)
        dev = torch.device(info["device"])
        mesh = make_mesh((n, 1, 1), device=dev)
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev if dev.index is not None else 0)
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = None

    def log(msg: str) -> None:
        print(f"[{time.time() - t0:6.1f}s p{pid}] {msg}", file=sys.stderr, flush=True)

    log(f"up: rank {pid} of {n} on {dev}")
    model = get_model(args.model)
    feat = tuple(model.input_shape)
    padded = pad_client_count(args.clients, n)
    start, stop = (0, padded) if mesh is None else host_client_slice(padded, mesh)
    ids = np.arange(start, stop)
    x, y, mask = client_rows(ids, args.capacity, feat, args.seed)
    mask[ids >= args.clients] = 0.0  # padding rows carry zero weight
    data = ClientData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                      mask=torch.from_numpy(mask)).to(dev)
    weights = torch.from_numpy(mask.sum(axis=1)).to(dev)
    log(f"holds rows [{start}, {stop}) of {padded}: {x.nbytes / 1e6:.1f} MB")

    training = TrainingConfig(batch_size=args.batch_size, local_epochs=1,
                              learning_rate=0.1)
    strategy = fedavg_strategy()
    full = {name: p.to(dev)
            for name, p in model.init(torch.Generator().manual_seed(args.seed)).items()}
    sos_full = init_server_state(strategy, full)
    start_round = 0
    if args.job == "hostchaos" and args.resume:
        from nanofed_tpu_torch.persistence import GenerationStore
        from nanofed_tpu_torch.utils.trees import (
            from_numpy_params,
            from_numpy_server_state,
        )

        rec = GenerationStore(args.ckpt_dir).latest_complete()
        if rec is not None:
            # The newest generation committed by ALL its participants: the only
            # legal recovery point (at most one block lost).
            full = from_numpy_params(rec.params, device=dev)
            sos_full = from_numpy_server_state(rec.server_state, strategy, full)
            start_round = rec.round_number
            log(f"resumed generation {rec.generation} at round {start_round} "
                f"(committed by hosts {list(rec.hosts)})")
        else:
            log("resume requested but no complete generation yet: fresh start")
    layout = None if mesh is None else MeshLayout(mesh, full)
    params = full if layout is None else layout.shard_params(full)
    sos = sos_full
    step = build_round_step(model, training, strategy, client_chunk=args.client_chunk,
                            mesh=mesh, params_like=full)

    def round_inputs(r: int) -> tuple[torch.Tensor, torch.Tensor]:
        # Functions of (seed, round, client id) over the whole padded population, so
        # every world shape fits each client on the same sample order and dropout masks.
        round_seed = args.seed * 1_000_003 + r
        perms = draw_permutations(torch.Generator().manual_seed(round_seed), padded, 1,
                                  args.capacity)[start:stop].to(dev)
        return perms, client_keys(round_seed, padded, dev)[start:stop]

    def full_params(p):
        return p if layout is None else layout.gather_full(p)

    ops.reset_launch_counts()
    topology = {"process_count": n, "hosts": n, "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                else "cpu"),
                "mesh_shape": [n, 1, 1] if mesh is not None else [1]}
    if args.job == "hostchaos":
        rc = _hostchaos_rounds(args, log, dev, step, params, sos, data, weights,
                               round_inputs, full_params, start_round, topology)
        if rc != 0:
            _exit_now(rc)
        if dist.is_initialized():
            dist.destroy_process_group()
        return rc

    losses: list[float] = []
    round_times: list[float] = []
    for r in range(args.rounds + 1):  # +1: round 0 pays the warm-up
        perms, keys = round_inputs(r)
        t = time.perf_counter()
        res = step(params, sos, data, weights, perms, keys)
        params, sos = res.params, res.server_opt_state
        loss = float(res.metrics["loss"])  # waits for the round
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t
        losses.append(loss)
        if r > 0:
            round_times.append(dt)
        log(f"round {r}: loss={loss:.6f} ({dt:.3f}s" + (", warm-up)" if r == 0 else ")"))
    final = full_params(params)
    if args.out is not None:
        _launches_path(args.out, pid).write_text(json.dumps(ops.launch_counts()))
    if pid == 0 and args.out is not None:
        flat = np.concatenate([v.detach().cpu().numpy().ravel() for v in final.values()])
        np.save(args.out + ".params.npy", flat)
        Path(args.out).write_text(json.dumps({
            "mode": args.job, "losses": losses, "round_times_s": round_times,
            "topology": topology,
        }, indent=2))
        log(f"wrote {args.out}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _hostchaos_rounds(args, log, dev, step, params, sos, data, weights, round_inputs,
                      full_params, start_round: int, topology: dict) -> int:
    """The fault-tolerant worker round loop: chaos at the host boundary, heartbeats, a
    watchdog deadline around every dispatch, generation commits at block boundaries.
    The round program is the smoke's: chaos and resilience live on the host side."""
    import torch

    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.faults import ChaosSchedule, FaultPlan, HostChaosInjector
    from nanofed_tpu_torch.parallel import CollectiveWatchdog, Heartbeat, HostFailure
    from nanofed_tpu_torch.persistence import GenerationStore
    from nanofed_tpu_torch.utils.trees import to_numpy_params, to_numpy_server_state

    host = args.host_id
    hosts_list = [int(h) for h in args.hosts_list.split(",")]
    injector = None
    if args.fault_plan:
        injector = HostChaosInjector(ChaosSchedule(FaultPlan.load(args.fault_plan)),
                                     host=host)
    hb = Heartbeat(args.hb_dir, host)
    store = GenerationStore(args.ckpt_dir, host=host)
    watchdog = CollectiveWatchdog(args.watchdog_deadline)
    progress = Path(args.progress) if args.progress else None
    pid = args.process_id

    def dispatch(params, sos, perms, keys):
        # On the watchdog's thread: the rank's card must be current here too, and the
        # wait for the round (where a dead peer's hang lives) stays inside the bracket.
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        res = step(params, sos, data, weights, perms, keys)
        loss = float(res.metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, loss

    def commit(rounds_done: int, params, sos) -> None:
        gen = rounds_done // args.block_size
        full = full_params(params)
        store.commit(gen, rounds_done, to_numpy_params(full),
                     to_numpy_server_state(sos, full), hosts=hosts_list)
        hb.beat(round_number=rounds_done, generation=gen, status="committed")
        log(f"committed generation {gen} at round {rounds_done}")

    if progress is not None and pid == 0:
        # Start-up ends here: the world is formed and the data is on the device.
        with progress.open("a") as f:
            f.write(json.dumps({"event": "ready", "wall_t": time.time()}) + "\n")
    losses: list[float] = []
    executed: list[int] = []
    first_dispatch = True
    for r in range(start_round, args.rounds):
        delay = 0.0
        if injector is not None:
            injector.maybe_fail(r)  # may os._exit (crash) or park (stall)
            delay = injector.dcn_delay_s(r)
            if delay:
                log(f"chaos: dcn_degrade {delay:.3f}s before round {r}")
                time.sleep(delay)
        hb.beat(round_number=r, generation=r // args.block_size, status="dispatch")
        perms, keys = round_inputs(r)
        # The first dispatch pays the CUDA and cuDNN warm-up: the deadline must not
        # misread it (or a planned degraded link) as a dead peer.
        grace = delay + (args.compile_grace if first_dispatch else 0.0)
        try:
            res, loss = watchdog.run(
                dispatch, params, sos, perms, keys, round_number=r, dcn_grace_s=grace,
                # A rank waiting on its peers is alive: keep beating.
                tick=lambda: hb.beat(round_number=r, generation=r // args.block_size,
                                     status="dispatch"))
        except HostFailure as exc:
            log(f"watchdog: {exc}")
            hb.beat(round_number=r, status="peer_failure")
            return PEER_FAILURE_RC
        except Exception as exc:  # a gloo error: a peer is gone
            log(f"dispatch failed (peer loss?): {type(exc).__name__}: {exc}")
            hb.beat(round_number=r, status="peer_failure")
            return PEER_FAILURE_RC
        first_dispatch = False
        params, sos = res.params, res.server_opt_state
        losses.append(loss)
        executed.append(r)
        hb.beat(round_number=r + 1, generation=(r + 1) // args.block_size,
                status="running")
        if progress is not None and pid == 0:
            with progress.open("a") as f:
                f.write(json.dumps({"round": r, "loss": loss, "wall_t": time.time()}) + "\n")
        log(f"round {r}: loss={loss:.6f}")
        if (r + 1) % args.block_size == 0:
            commit(r + 1, params, sos)

    hb.beat(round_number=args.rounds, status="done")
    if args.out is not None:
        _launches_path(args.out, pid).write_text(json.dumps(ops.launch_counts()))
    if pid == 0 and args.out is not None:
        Path(args.out).write_text(json.dumps({
            "mode": "hostchaos", "start_round": start_round, "rounds": executed,
            "losses": losses, "topology": {**topology, "host_ids": hosts_list},
        }, indent=2))
        log(f"wrote {args.out}")
    return 0


# ---------------------------------------------------------------------------------------
# Launcher side
# ---------------------------------------------------------------------------------------


def _rendezvous(tmp: Path) -> Path:
    """A fresh ``file://`` rendezvous path for one world, absolute (a relative path
    would read as the URL's host)."""
    d = tmp.resolve() / "rendezvous"
    d.mkdir(parents=True, exist_ok=True)
    return d / f"world_{uuid.uuid4().hex}"


def _spawn(args: argparse.Namespace, worker_args: list[str], n: int,
           out: str) -> list[subprocess.Popen]:
    rdv = _rendezvous(Path(args.tmp_dir))
    procs = []
    for pid in range(n):
        cmd = [sys.executable, str(Path(__file__).resolve()), "worker",
               "--process-id", str(pid), "--num-processes", str(n),
               "--rendezvous", str(rdv), "--device", args.device,
               "--timeout", str(args.timeout), "--out", out, *worker_args]
        procs.append(subprocess.Popen(cmd, env=_worker_env()))
    return procs


def _launches_path(out: str | Path, rank: int) -> Path:
    return Path(f"{out}.rank{rank}.launches.json")


def world_launches(out: str | Path, n: int) -> list[dict[str, int]]:
    """Every rank's kernel launches over its run (each rank zeroes its counts after
    its set-up and writes them at its end, beside the world's result)."""
    return [json.loads(_launches_path(out, rank).read_text()) for rank in range(n)]


def _reap(procs: list[subprocess.Popen], grace_s: float = 5.0) -> None:
    """Terminate AND reap every still-running worker: SIGTERM first, SIGKILL after
    the grace, ``wait()`` always, so no worker outlives this call (a zombie or a
    stalled rank would hold its card's memory and poison the next world)."""
    for q in procs:
        if q.poll() is None:
            q.terminate()
    deadline = time.time() + grace_s
    for q in procs:
        if q.poll() is not None:
            continue
        try:
            q.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


def _wait(procs: list[subprocess.Popen], timeout_s: float) -> None:
    """Wait for every worker, polling ALL of them: a fast failure of one rank while
    another blocks in the rendezvous surfaces at once with its exit code.  Every
    failure path reaps the survivors before raising."""
    deadline = time.time() + timeout_s
    pending = list(procs)
    while pending:
        for p in list(pending):
            rc = p.poll()
            if rc is None:
                continue
            if rc != 0:
                _reap(procs)
                raise SystemExit(f"worker exited rc={rc}")
            pending.remove(p)
        if pending:
            if time.time() > deadline:
                _reap(procs)
                raise SystemExit(f"worker timed out after {timeout_s:.0f}s")
            time.sleep(0.2)


def _workload_args(args: argparse.Namespace, job: str) -> list[str]:
    out = ["--job", job, "--clients", str(args.clients), "--capacity", str(args.capacity),
           "--batch-size", str(args.batch_size), "--rounds", str(args.rounds),
           "--model", args.model, "--seed", str(args.seed)]
    if args.client_chunk is not None:
        out += ["--client-chunk", str(args.client_chunk)]
    return out


def run_smoke(args: argparse.Namespace) -> int:
    """``--num-processes`` ranks on a hosts mesh vs one rank: losses and final params
    within :data:`SMOKE_TOL`."""
    import numpy as np

    tmp = Path(args.tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    mode_args = _workload_args(args, "smoke")
    multi_out = str(tmp / "multihost_smoke_multi.json")
    ref_out = str(tmp / "multihost_smoke_ref.json")
    t0 = time.time()
    # The two worlds are independent: they run side by side (the smoke checks parity,
    # it times nothing).
    print(f"# spawning a {args.num_processes}-rank hosts-mesh run and the one-rank "
          f"reference (gloo, {args.device})", flush=True)
    _wait(_spawn(args, mode_args, args.num_processes, multi_out)
          + _spawn(args, mode_args, 1, ref_out), args.timeout)

    multi = json.loads(Path(multi_out).read_text())
    ref = json.loads(Path(ref_out).read_text())
    p_multi = np.load(multi_out + ".params.npy")
    p_ref = np.load(ref_out + ".params.npy")
    loss_delta = max(abs(a - b) for a, b in zip(multi["losses"], ref["losses"]))
    param_delta = float(np.abs(p_multi - p_ref).max())
    verdict = {
        "losses_multi": multi["losses"],
        "losses_ref": ref["losses"],
        "max_loss_delta": loss_delta,
        "max_param_delta": param_delta,
        "tolerance": SMOKE_TOL,
        "launches_by_rank": world_launches(multi_out, args.num_processes),
        "launches_ref": world_launches(ref_out, 1)[0],
        "topology": multi["topology"],
        "walltime_s": round(time.time() - t0, 3),
    }
    print(json.dumps(verdict, indent=2))
    if multi["topology"]["process_count"] != args.num_processes:
        raise SystemExit(f"the world had {multi['topology']['process_count']} ranks, "
                         f"not {args.num_processes}")
    if not (loss_delta <= SMOKE_TOL and param_delta <= SMOKE_TOL):
        raise SystemExit(f"smoke parity failed: max loss delta {loss_delta}, max param "
                         f"delta {param_delta} (tolerance {SMOKE_TOL})")
    print(f"multihost-smoke OK: {args.num_processes}-rank hosts mesh == one rank within "
          f"{SMOKE_TOL}")
    return 0


def run_bench(args: argparse.Namespace) -> int:
    """Rounds/s and clients/s of the streamed hosts-mesh round, with its topology."""
    tmp = Path(args.tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    if args.client_chunk is None:
        args.client_chunk = 250
    worker_out = str(tmp / "multihost_bench_worker.json")
    t0 = time.time()
    print(f"# spawning a {args.num_processes}-rank bench at {args.clients} clients",
          flush=True)
    _wait(_spawn(args, _workload_args(args, "bench"), args.num_processes, worker_out),
          args.timeout)
    worker = json.loads(Path(worker_out).read_text())
    times = worker["round_times_s"]
    median = sorted(times)[len(times) // 2]
    topo = worker["topology"]
    shared = args.device != "cpu" and topo["device_name"] != "cpu"
    record = {
        "metric": "multihost_fedavg_round_walltime",
        "unit": "s",
        "value": median,
        "per_round_s": times,
        "rounds_per_sec": 1.0 / median,
        "clients_per_sec": args.clients / median,
        "num_clients": args.clients,
        "samples_per_client": args.capacity,
        "client_chunk": args.client_chunk,
        "model": args.model,
        "losses": worker["losses"],
        "launches_by_rank": world_launches(worker_out, args.num_processes),
        "topology": topo,
        "platform": "gpu" if shared else "cpu",
        "basis": (
            f"{args.num_processes} torch.distributed ranks over gloo on one machine"
            + (f", all on {topo['device_name']}" if shared else ", on the CPU")
            + ": measures the round program (chunked streaming, host-local then "
            "cross-host reduce, one controller per rank), not a round across several "
            "cards"),
        "harness": "scripts/multihost_harness_torch.py bench",
        "walltime_s": round(time.time() - t0, 3),
    }
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (f"multihost_torch_{time.strftime('%Y%m%dT%H%M%S')}_"
                      f"{args.clients}clients.json")
    path.write_text(json.dumps(record, indent=2))
    print(json.dumps(record, indent=2))
    print(f"# artifact written to {path}")
    return 0


def _spawn_hostchaos(args: argparse.Namespace, host_ids: list[int], *, rounds: int,
                     hb_dir: Path, ckpt_dir: Path, resume: bool, plan_path: Path | None,
                     out: Path | None, progress: Path | None) -> list[subprocess.Popen]:
    """One hostchaos worker per LOGICAL host id.  Ranks renumber 0..n-1 every world;
    logical ids survive re-formations: they are what the plan targets, what the
    heartbeats and commit markers are keyed by, and what lets a host rejoin as
    itself."""
    worker_args = _workload_args(args, "hostchaos")
    worker_args[worker_args.index("--rounds") + 1] = str(rounds)
    worker_args += [
        "--block-size", str(args.block_size),
        "--watchdog-deadline", str(args.watchdog_deadline),
        "--compile-grace", str(args.compile_grace),
        "--hosts-list", ",".join(str(h) for h in host_ids),
        "--hb-dir", str(hb_dir), "--ckpt-dir", str(ckpt_dir),
    ]
    if resume:
        worker_args += ["--resume"]
    if plan_path is not None:
        worker_args += ["--fault-plan", str(plan_path)]
    rdv = _rendezvous(Path(args.tmp_dir))
    procs = []
    n = len(host_ids)
    for pid, host in enumerate(host_ids):
        cmd = [sys.executable, str(Path(__file__).resolve()), "worker",
               "--process-id", str(pid), "--num-processes", str(n),
               "--rendezvous", str(rdv), "--device", args.device,
               "--timeout", str(args.timeout), "--host-id", str(host), *worker_args]
        if out is not None:
            cmd += ["--out", str(out)]
        if progress is not None and pid == 0:
            cmd += ["--progress", str(progress)]
        procs.append(subprocess.Popen(cmd, env=_worker_env()))
    return procs


def _read_progress(path: Path) -> list[dict]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue  # torn tail line from a killed writer
    return out


def _fresh_dir(path: Path) -> Path:
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    return path


def run_hostchaos(args: argparse.Namespace) -> int:
    """The kill-and-recover drill (see the module docstring)."""
    from nanofed_tpu_torch.faults import FaultPlan
    from nanofed_tpu_torch.observability.telemetry import RunTelemetry
    from nanofed_tpu_torch.observability.tracing import (
        FLIGHT_RECORDER_FILENAME,
        FlightRecorder,
        mttr_decomposition,
    )
    from nanofed_tpu_torch.parallel.resilience import (
        HostMonitor,
        no_orphans,
        resilience_metrics,
    )
    from nanofed_tpu_torch.persistence import GenerationStore

    if args.num_processes < 2:
        raise SystemExit("hostchaos needs --num-processes >= 2 (someone must survive "
                         "to recover)")
    P, R, B = args.num_processes, args.rounds, args.block_size
    tmp = Path(args.tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    hb_a, hb_c = _fresh_dir(tmp / "hb_a"), _fresh_dir(tmp / "hb_c")
    hb_d, hb_e = _fresh_dir(tmp / "hb_d"), _fresh_dir(tmp / "hb_e")
    ckpt = _fresh_dir(tmp / "ckpt")
    ref_ckpt = tmp / "ckpt_ref"
    if ref_ckpt.exists():
        shutil.rmtree(ref_ckpt)

    if args.plan:
        plan = FaultPlan.load(args.plan)
    else:
        plan = FaultPlan.generate(
            args.seed, [], R, hosts=P,
            host_crash_count=1 if args.host_fault == "crash" else 0,
            host_stall_count=1 if args.host_fault == "stall" else 0)
    host_events = [e for e in plan.events if e.kind in ("host_crash", "host_stall")]
    if not host_events:
        raise SystemExit("the hostchaos plan contains no host_crash/host_stall event — "
                         "nothing to drill")
    if len(host_events) > 1:
        # The recovered world is fed the plan again; a second terminal event would
        # kill a survivor mid-recovery with nobody supervising.
        raise SystemExit(
            f"the hostchaos drill handles ONE terminal host fault per run; this plan "
            f"has {len(host_events)} ({[e.to_dict() for e in host_events]})")
    max_dcn = max((e.seconds for e in plan.events if e.kind == "dcn_degrade"),
                  default=0.0)
    if max_dcn >= args.watchdog_deadline:
        # The degraded host widens its own deadline, but its peers cannot know the plan.
        raise SystemExit(
            f"plan injects dcn_degrade of {max_dcn}s but --watchdog-deadline is "
            f"{args.watchdog_deadline}s: peers would misread the degraded link as a "
            "dead host — raise the deadline above the worst planned delay")
    plan_path = tmp / "hostchaos_plan.json"
    plan.save(plan_path)

    metrics = resilience_metrics()
    if args.telemetry_dir is None:
        telemetry_dir = _fresh_dir(tmp / "telemetry")  # ours to wipe
    else:
        telemetry_dir = Path(args.telemetry_dir)  # an operator's: records append
        telemetry_dir.mkdir(parents=True, exist_ok=True)
    tel = RunTelemetry(telemetry_dir)
    recorder = FlightRecorder(name="hostchaos-supervisor")
    all_pids: list[int] = []
    t0 = time.time()
    hosts = list(range(P))

    # ---- phase A: the full world under the plan, until the failure ----
    print(f"# hostchaos: {P}-host world on {args.device}, plan: "
          + ", ".join(f"{e.kind}@r{e.round} host {e.host}" for e in host_events),
          flush=True)
    progress_a = tmp / "progress_a.jsonl"
    progress_a.unlink(missing_ok=True)
    procs = _spawn_hostchaos(args, hosts, rounds=R, hb_dir=hb_a, ckpt_dir=ckpt,
                             resume=False, plan_path=plan_path, out=tmp / "hc_a.json",
                             progress=progress_a)
    all_pids += [p.pid for p in procs]
    monitor = HostMonitor(hb_a, stall_timeout_s=args.stall_timeout)

    def _hb_status(host: int) -> str:
        try:
            return str(json.loads((hb_a / f"host_{host}.hb.json").read_text())
                       .get("status", "?"))
        except (OSError, json.JSONDecodeError, ValueError):
            return "?"

    victim: int | None = None
    kind: str | None = None
    deadline = time.time() + args.timeout
    exits: dict[int, int] = {}
    exit_order: list[int] = []
    while victim is None:
        for i, p in enumerate(procs):
            rc = p.poll()
            if rc is not None and i not in exits:
                exits[i] = rc
                exit_order.append(i)
                if rc == HOST_CRASH_RC:
                    victim, kind = hosts[i], "host_crash"
                    metrics["host_failures"].inc(kind=kind)
        if victim is None:
            stalled = monitor.stalled()
            if stalled:
                victim, kind = stalled[0].host, "host_stall"
        if victim is None and any(rc == PEER_FAILURE_RC for rc in exits.values()):
            # A worker that exited blaming a peer is never the victim, nor is one whose
            # last beat declared peer_failure.  Once exactly one blameless worker
            # remains, it is: crashed if it died before the first blame, else stalled.
            blaming = {i for i in range(len(procs))
                       if exits.get(i) == PEER_FAILURE_RC
                       or _hb_status(hosts[i]) == "peer_failure"}
            candidates = [i for i in range(len(procs)) if i not in blaming]
            if len(candidates) == 1 and all(i in exits for i in blaming):
                i = candidates[0]
                victim = hosts[i]
                first_blame = min((exit_order.index(j) for j in blaming if j in exits),
                                  default=len(exit_order))
                died_first = i in exits and exit_order.index(i) < first_blame
                kind = "host_crash" if died_first else "host_stall"
                metrics["host_failures"].inc(kind=kind)
        if victim is None and len(exits) == len(procs):
            if all(rc == 0 for rc in exits.values()):
                _reap(procs)
                raise SystemExit("hostchaos: every worker completed without the planned "
                                 "failure firing — raise --rounds or fix the plan")
            organic = [i for i in exit_order if exits[i] not in (0, PEER_FAILURE_RC)]
            if not organic:
                _reap(procs)
                raise SystemExit(
                    f"hostchaos: every worker exited blaming a peer (exit codes "
                    f"{dict(sorted(exits.items()))}) — a systemic failure, no victim to "
                    "name; read the worker logs")
            victim, kind = hosts[organic[0]], "host_crash"
            metrics["host_failures"].inc(kind=kind)
        if victim is None and time.time() > deadline:
            _reap(procs)
            raise SystemExit(f"hostchaos: no failure detected within {args.timeout:.0f}s")
        if victim is None:
            time.sleep(0.1)
    t_detect = time.time()
    recorder.note("kill_detected", host=victim, fault=kind)
    last_beat_wall = victim_round = None
    try:
        payload = json.loads((hb_a / f"host_{victim}.hb.json").read_text())
        last_beat_wall = float(payload.get("wall_t", 0)) or None
        victim_round = payload.get("round")
    except (OSError, json.JSONDecodeError, ValueError):
        pass
    detection_s = t_detect - last_beat_wall if last_beat_wall else None
    # Kill and reap everyone, survivors included: the old world is dead, and a rank
    # wedged in gloo would hold its card's memory forever.
    _reap(procs)
    recorder.note("reaped", victim=victim, fault=kind)
    dump_path = recorder.dump(telemetry_dir / FLIGHT_RECORDER_FILENAME,
                              extra={"victim": victim, "kind": kind})
    plan_round = next((e.round for e in host_events if e.host == victim), victim_round)
    fail_round = plan_round if plan_round is not None else 0
    print(f"# failure detected: {kind} on host {victim} (round {fail_round}, detection "
          f"{detection_s}s) — reaped {len(procs)} workers", flush=True)
    tel.record("host_failure", kind=kind, host=victim, round=fail_round,
               detection_s=detection_s,
               detail=f"exit codes {exits}" if exits else "heartbeat frozen")

    # The reference starts from the identical recovery point: copy before the
    # recovered world extends the store.
    shutil.copytree(ckpt, ref_ckpt)
    rec = GenerationStore(ckpt).latest_complete()
    resumed_round = rec.round_number if rec is not None else 0
    resumed_gen = rec.generation if rec is not None else None
    rounds_lost = fail_round - resumed_round
    print(f"# recovery point: generation {resumed_gen} (round {resumed_round}); rounds "
          f"lost = {rounds_lost} (block size {B})", flush=True)

    # ---- phase C: re-form over the survivors, resume, finish the run ----
    survivors = [h for h in hosts if h != victim]
    metrics["mesh_reshapes"].inc()
    progress_c = tmp / "progress_c.jsonl"
    progress_c.unlink(missing_ok=True)
    procs = _spawn_hostchaos(args, survivors, rounds=R, hb_dir=hb_c, ckpt_dir=ckpt,
                             resume=True, plan_path=plan_path, out=tmp / "hc_c.json",
                             progress=progress_c)
    all_pids += [p.pid for p in procs]
    respawn_mark = recorder.note("respawned", hosts=survivors)
    _wait(procs, args.timeout)
    if not (telemetry_dir.exists() and tel.path.exists()):
        raise SystemExit(f"telemetry did not survive the worker crash: {tel.path}")
    recovered = json.loads((tmp / "hc_c.json").read_text())
    prog_c = _read_progress(progress_c)
    rounds_c = [p for p in prog_c if "round" in p]
    ready_c = next((p for p in prog_c if p.get("event") == "ready"), None)
    if not rounds_c:
        raise SystemExit("hostchaos: the recovered world reported no rounds")
    recovery_s = rounds_c[0]["wall_t"] - t_detect
    metrics["recovery_seconds"].observe(recovery_s)

    def mono(wall: float) -> float:
        # A worker's wall stamp on the recorder's monotonic axis, through the respawn
        # mark (both clocks were read in this process).
        return respawn_mark["t_mono"] + max(0.0, wall - respawn_mark["t_wall"])

    if ready_c is not None:
        recorder.note("ready", wall=ready_c["wall_t"], t_mono=mono(ready_c["wall_t"]))
    recorder.note("first_progress", wall=rounds_c[0]["wall_t"],
                  t_mono=mono(rounds_c[0]["wall_t"]))
    # Marks noted after the fact carry the worker's time: the recorder keeps the
    # caller's t_mono where it is given.
    mttr_phases = mttr_decomposition(recorder.snapshot(), [
        ("kill_detected", None), ("reaped", "reap"), ("respawned", "respawn"),
        ("ready", "bring_up"), ("first_progress", "first_round")])
    if detection_s is not None:
        mttr_phases = {"detect": detection_s, **mttr_phases}
    recorder.dump(telemetry_dir / FLIGHT_RECORDER_FILENAME,
                  extra={"victim": victim, "kind": kind, "mttr_phases": mttr_phases})
    print(f"# world re-formed over hosts {survivors}: first post-recovery round done "
          f"{recovery_s:.3f}s after detection (phases: {mttr_phases})", flush=True)
    tel.record("recovery", recovery_s=recovery_s, resumed_generation=resumed_gen,
               resumed_round=resumed_round, rounds_lost=rounds_lost, hosts_before=P,
               hosts_after=len(survivors), reshape=True, rejoin=False,
               mttr_phases=mttr_phases,
               flight_recorder=None if dump_path is None else str(dump_path))

    # ---- phase D (optional): the failed host rejoins at a generation boundary, beside
    # phase E: the parity reference, an UNFAILED run of the shrunk world from the same
    # recovery point (the two worlds share nothing) ----
    procs = _spawn_hostchaos(args, survivors, rounds=R, hb_dir=hb_e, ckpt_dir=ref_ckpt,
                             resume=True, plan_path=None, out=tmp / "hc_e.json",
                             progress=None)
    rejoin_block = None
    if args.rejoin_rounds > 0:
        metrics["mesh_reshapes"].inc()
        total = R + args.rejoin_rounds
        procs += _spawn_hostchaos(args, hosts, rounds=total, hb_dir=hb_d, ckpt_dir=ckpt,
                                  resume=True, plan_path=None, out=tmp / "hc_d.json",
                                  progress=tmp / "progress_d.jsonl")
    all_pids += [p.pid for p in procs]
    _wait(procs, args.timeout)
    if args.rejoin_rounds > 0:
        rejoined = json.loads((tmp / "hc_d.json").read_text())
        rejoin_block = {"hosts": hosts, "resumed_round": rejoined["start_round"],
                        "rounds": rejoined["rounds"], "losses": rejoined["losses"],
                        "launches_by_rank": world_launches(tmp / "hc_d.json", P)}
        if not (rejoined["rounds"] and rejoined["rounds"][-1] == total - 1):
            raise SystemExit(f"the rejoined world did not reach round {total - 1}: "
                             f"{rejoined}")
        print(f"# host {victim} rejoined at round {rejoined['start_round']}: the full "
              f"{P}-host world ran to round {total - 1}", flush=True)
        tel.record("recovery", resumed_generation=rejoined["start_round"] // B,
                   resumed_round=rejoined["start_round"], rounds_lost=0,
                   hosts_before=len(survivors), hosts_after=P, reshape=True, rejoin=True)

    reference = json.loads((tmp / "hc_e.json").read_text())

    pairs = list(zip(recovered["losses"], reference["losses"]))
    loss_delta = max((abs(a - b) for a, b in pairs), default=float("inf"))
    orphans = no_orphans(all_pids)
    # Start-up: from the respawn to the re-formed world holding its data on the
    # device (process start, torch and CUDA start-up, rendezvous, model build).
    startup_s = ready_c["wall_t"] - respawn_mark["t_wall"] if ready_c else None
    artifact = {
        "record_type": "hostchaos",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "seed": args.seed,
        "plan": json.loads(plan.to_json()),
        "rounds": R,
        "block_size": B,
        "clients": args.clients,
        "model": args.model,
        "device": recovered["topology"]["device_name"],
        "topology": {"hosts_before": P, "hosts_after": len(survivors),
                     "mesh_before": [P, 1, 1], "mesh_after": [len(survivors), 1, 1]},
        "failure": {
            "kind": kind, "host": victim, "round": fail_round,
            "detection_s": detection_s,
            "stall_timeout_s": args.stall_timeout,
            "watchdog_deadline_s": args.watchdog_deadline,
            "worker_exit_codes": {str(hosts[i]): rc for i, rc in sorted(exits.items())},
        },
        "recovery": {
            "recovery_s": recovery_s,
            "startup_s": startup_s,
            "phases": mttr_phases,
            "resumed_generation": resumed_gen,
            "resumed_round": resumed_round,
            "rounds_lost": rounds_lost,
            "at_most_one_block": rounds_lost <= B,
        },
        "pre_failure_losses": [p["loss"] for p in _read_progress(progress_a) if "round" in p],
        "recovered": {"rounds": recovered["rounds"], "losses": recovered["losses"],
                      "launches_by_rank": world_launches(tmp / "hc_c.json", len(survivors))},
        "reference_unfailed_shrunk": {
            "rounds": reference["rounds"], "losses": reference["losses"],
            "launches_by_rank": world_launches(tmp / "hc_e.json", len(survivors))},
        "parity": {"max_loss_delta": loss_delta, "bit_equal": all(a == b for a, b in pairs),
                   "tolerance": args.parity_tol, "ok": loss_delta <= args.parity_tol},
        "rejoin": rejoin_block,
        "orphans": orphans,
        "basis": (
            f"{P} torch.distributed ranks over gloo on one machine "
            f"({recovered['topology']['device_name']}); the drill measures the recovery "
            "machinery — detection, reap, world re-formation, generation resume — and "
            "the recovery seconds include process start, world bring-up and the first "
            "round's warm-up (startup_s names the start-up part)"),
        "harness": "scripts/multihost_harness_torch.py hostchaos",
        "walltime_s": time.time() - t0,
    }
    tel.close()
    if rounds_lost > B:
        raise SystemExit(f"at-most-one-block violated: lost {rounds_lost} rounds > {B}")
    if loss_delta > args.parity_tol:
        raise SystemExit(f"the recovered trajectory left the unfailed shrunk world's: max "
                         f"loss delta {loss_delta} > {args.parity_tol}")
    if orphans:
        raise SystemExit(f"orphan worker processes survived the run: {orphans}")
    if recovered["rounds"][-1] != R - 1:
        raise SystemExit(f"the recovered world stopped at round {recovered['rounds'][-1]}")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"hostchaos_torch_{time.strftime('%Y%m%dT%H%M%S')}_{P}h.json"
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    print(json.dumps(artifact, indent=2))
    print(f"# artifact written to {path}")
    print(f"# telemetry: {telemetry_dir} (digest: python -m nanofed_tpu_torch.cli "
          f"metrics-summary {telemetry_dir})")
    print(f"hostchaos OK: {kind} on host {victim} at round {fail_round} -> recovered on "
          f"{len(survivors)} host(s) in {recovery_s:.3f}s, {rounds_lost} round(s) re-run "
          f"(<= {B}), parity delta {loss_delta:.2e}, zero orphans")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "mode", choices=["smoke", "bench", "hostchaos", "federate", "worker"],
        help="smoke: a hosts-mesh world vs one rank; bench: rounds/s artifact; "
        "hostchaos: seeded kill-and-recover drill; federate: needs item 18; worker: "
        "internal (one rank)")
    parser.add_argument("--clients", type=int, default=None)
    parser.add_argument("--capacity", type=int, default=8, help="samples per client")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=3,
                        help="timed rounds (smoke/bench run one more warm-up round)")
    parser.add_argument("--model", default="digits_mlp")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--client-chunk", type=int, default=None)
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; ranks over gloo, sharing cards as needed) "
                        "or cpu")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="per-world worker timeout (also the process group's)")
    parser.add_argument("--job", choices=["smoke", "bench", "hostchaos"], default="smoke",
                        help="(worker) which launcher job this worker serves")
    parser.add_argument("--process-id", type=int, default=0, help="(worker) its rank")
    parser.add_argument("--rendezvous", default=None,
                        help="(worker) the world's file:// rendezvous path")
    parser.add_argument("--out", default=None, help="(worker) result JSON path")
    parser.add_argument("--out-dir", default="runs")
    parser.add_argument("--tmp-dir", default="runs/multihost_torch_tmp")
    parser.add_argument("--plan", default=None,
                        help="(hostchaos) fault-plan JSON; default: one host fault drawn "
                        "from --seed")
    parser.add_argument("--host-fault", choices=["crash", "stall"], default="crash",
                        help="(hostchaos) which host fault the generated plan draws")
    parser.add_argument("--block-size", type=int, default=2,
                        help="rounds per checkpoint generation (the most a failure loses)")
    parser.add_argument("--stall-timeout", type=float, default=15.0,
                        help="(hostchaos) heartbeat age that flags a host as stalled")
    parser.add_argument("--watchdog-deadline", type=float, default=20.0,
                        help="deadline of a dispatch (the detection window for a dead or "
                        "stalled peer)")
    parser.add_argument("--compile-grace", type=float, default=90.0,
                        help="extra watchdog allowance for the first dispatch (CUDA and "
                        "cuDNN warm-up must not read as a dead peer)")
    parser.add_argument("--parity-tol", type=float, default=SMOKE_TOL,
                        help="(hostchaos) max post-recovery loss gap to the unfailed "
                        "shrunk world")
    parser.add_argument("--rejoin-rounds", type=int, default=2,
                        help="(hostchaos) rounds after the failed host rejoins (0: no "
                        "rejoin)")
    parser.add_argument("--telemetry-dir", default=None,
                        help="(hostchaos) where the supervisor writes telemetry.jsonl "
                        "(default under --tmp-dir)")
    parser.add_argument("--fault-plan", default=None, help="(worker) fault-plan JSON path")
    parser.add_argument("--host-id", type=int, default=0,
                        help="(worker) LOGICAL host id, stable across re-formations")
    parser.add_argument("--hosts-list", default="0",
                        help="(worker) comma-separated logical host ids of the world "
                        "(the commit markers' participant set)")
    parser.add_argument("--hb-dir", default=None)
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--progress", default=None,
                        help="(worker) per-round progress JSONL path")
    parser.add_argument("--resume", action="store_true",
                        help="(worker) resume from the newest complete generation")
    args = parser.parse_args(argv)

    if args.clients is None:
        args.clients = 100_000 if args.mode == "bench" else 16
    if args.mode == "federate":
        print(f"error: {FEDERATE_REFUSAL}", file=sys.stderr)
        return 2
    if args.mode == "worker":
        return run_worker(args)
    if args.mode == "smoke":
        return run_smoke(args)
    if args.mode == "hostchaos":
        return run_hostchaos(args)
    return run_bench(args)


if __name__ == "__main__":
    sys.exit(main())
