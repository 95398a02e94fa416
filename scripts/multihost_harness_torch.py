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
* ``federate``: one stack from the wire to the cross-host reduce.  Every rank is a
  host running a live ``HTTPServer`` with a device ingest buffer; the supervisor
  drives one ``loadgen`` swarm a host (real sockets, the schedule and backoffs on a
  ``VirtualClock``, the other hosts as failover targets).  Each round a host drains
  its buffer host-locally (``drain_ingest_fedavg_partial``: ``Σ w δ`` and the mass)
  and joins ONE all-reduce of its ``[P+1+1]`` row over the hosts
  (``communication.federation``); the last lane is a stop vote, so the hosts agree on
  the final round through the collective they already run.  The all-reduce runs on an
  executor thread under the collective watchdog, so the listener keeps accepting while
  gloo blocks.  The supervisor holds every host's final params against a numpy
  ``einsum`` replay of the drained rounds (:func:`federate_oracle`, within
  :data:`FEDERATE_TOL`), asserts that no submit was lost, and writes
  ``<out-dir>/federation_torch_*.json``.  ``--kill-round`` crashes one host by plan:
  its clients reroute to the survivors live, the supervisor reaps the world, re-forms
  it over the survivors from the newest generation every host committed and re-drives
  the dead host's population; the replay drops the rounds drained after that
  generation, and no submit may be lost.

No worker outlives its supervisor: the supervisor reaps every worker it started on
every exit path (SIGTERM included, raised as ``SystemExit``), and a worker dies with
its supervisor (``parallel.launch.die_with_parent``), so a SIGKILLed supervisor, which
reaps nothing, leaves no stalled rank behind.

Run from the repo root, e.g. ``python3 scripts/multihost_harness_torch.py smoke
--device cpu --clients 8``.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
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

#: ``federate``: every host's final params against the numpy replay of the drained
#: rounds (float32 device products against float64 sums).
FEDERATE_TOL = 1e-5


#: The environment variable that hands a worker its supervisor's pid.
SUPERVISOR_PID_ENV = "NANOFED_HARNESS_SUPERVISOR_PID"

#: Every worker this supervisor started; ``main`` reaps them on every exit path.
_WORKERS: list[subprocess.Popen] = []


def _worker_env() -> dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env[SUPERVISOR_PID_ENV] = str(os.getpid())
    return env


def _popen(cmd: list[str]) -> subprocess.Popen:
    """Start one worker and register it for the supervisor's final reap."""
    proc = subprocess.Popen(cmd, env=_worker_env())
    _WORKERS.append(proc)
    return proc


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
    from nanofed_tpu_torch.parallel.launch import die_with_parent

    if SUPERVISOR_PID_ENV in os.environ:  # before the world forms: no rank outlives it
        die_with_parent(int(os.environ[SUPERVISOR_PID_ENV]))
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
    if args.job == "federate":
        return _federate_worker(args, log, dev, mesh)
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


def _flat(params) -> "torch.Tensor":
    import torch

    return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in params.values()])


def _federate_worker(args: argparse.Namespace, log, dev, mesh) -> int:
    """One federate host: a live listener and a device ingest buffer, drained
    host-locally each round, then ONE all-reduce over the hosts of the ``[P+1+1]`` row
    (numerator, mass, stop vote), on an executor thread under the collective watchdog
    so the listener keeps accepting while gloo blocks.  Hosts pace on a shared beat:
    round r's deadline is r+1 round timeouts after the warm all-reduce, which every
    host leaves together."""
    import asyncio

    import numpy as np
    import torch

    from nanofed_tpu_torch.communication.federation import (
        apply_summed_row,
        build_cross_host_row_psum,
        host_partial_row,
    )
    from nanofed_tpu_torch.communication.http_server import HTTPServer
    from nanofed_tpu_torch.ingest import IngestConfig
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability.registry import MetricsRegistry
    from nanofed_tpu_torch.orchestration.engine import RoundLedger, completion_required
    from nanofed_tpu_torch.parallel.resilience import (
        CollectiveWatchdog,
        Heartbeat,
        HostFailure,
    )
    from nanofed_tpu_torch.persistence import GenerationStore
    from nanofed_tpu_torch.utils.trees import from_numpy_params, unravel

    host = args.host_id
    hosts_list = [int(h) for h in args.hosts_list.split(",")]
    like = {name: leaf.to(dev) for name, leaf in get_model(args.model).init(
        torch.Generator().manual_seed(args.seed)).items()}
    flat = _flat(like)
    flat_size = int(flat.numel())
    # A world of one host (a kill drill's lone survivor): its row is the sum.
    psum_fn = build_cross_host_row_psum(mesh) if mesh is not None else (lambda row: row)
    injector = None
    if args.fault_plan:
        from nanofed_tpu_torch.faults import ChaosSchedule, FaultPlan, HostChaosInjector

        injector = HostChaosInjector(ChaosSchedule(FaultPlan.load(args.fault_plan)),
                                     host=host)
    hb = Heartbeat(args.hb_dir, host)
    store = GenerationStore(args.ckpt_dir, host=host)
    watchdog = CollectiveWatchdog(args.watchdog_deadline)
    stop_file = Path(args.stop_file) if args.stop_file else None
    start_round = 0
    if args.resume:
        rec = store.latest_complete()
        if rec is not None:
            flat = _flat(from_numpy_params(rec.params, device=dev))
            start_round = rec.round_number
            log(f"resumed generation {rec.generation} at round {start_round} (committed "
                f"by hosts {list(rec.hosts)})")
        else:
            log("resume requested but no complete generation: fresh start")

    # The warm all-reduce is the bring-up barrier: a listener opens only once every
    # peer reached it, and every host's beat is anchored at its end.
    psum_fn(host_partial_row(None, 0.0, flat_size, extra=(0.0,), device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    anchor = time.monotonic()
    anchor_wall = time.time()
    log(f"cross-host all-reduce warm on a ({args.num_processes}, 1, 1) mesh (bring-up "
        "barrier passed)")

    registry = MetricsRegistry()
    telemetry = None
    if args.telemetry_dir:
        from nanofed_tpu_torch.observability import RunTelemetry

        # One stream a worker; clock_sync pins its wall clock to the barrier's epoch.
        telemetry = RunTelemetry(Path(args.telemetry_dir) / f"host_{host}",
                                 registry=registry)
        telemetry.record("clock_sync", host=host, anchor_wall=round(anchor_wall, 6),
                         process_id=args.process_id)
    ledger = RoundLedger(registry, telemetry=telemetry, track_dropouts=True)
    required = completion_required(args.round_quota, args.min_completion_rate)
    n_hosts = len(hosts_list)
    progress = Path(args.progress) if args.progress else None

    async def _serve() -> dict:
        server = HTTPServer(
            port=args.wire_port, registry=registry, max_inflight=512,
            # >= 1: at window 0 a publish clears the ingest buffer, dropping submits
            # accepted but not yet drained.
            staleness_window=max(1, args.staleness_window),
            ingest=IngestConfig(capacity=args.ingest_capacity), device=dev,
            tracer=None if telemetry is None else telemetry.tracer)
        await server.start()
        await server.publish_model(unravel(flat, like), start_round)
        if args.ready_file:
            ready = Path(args.ready_file)
            tmp_path = ready.with_suffix(".tmp")
            tmp_path.write_text(json.dumps({"host": host, "round": start_round,
                                            "url": f"http://127.0.0.1:{args.wire_port}"}))
            tmp_path.replace(ready)  # atomic: the supervisor never reads a torn file
        log(f"listener up on :{args.wire_port}")

        loop = asyncio.get_running_loop()
        base = flat
        rounds_meta: list[dict] = []
        clients_seen: set[str] = set()
        rerouted_total = 0
        r = start_round
        while True:
            if injector is not None:
                injector.maybe_fail(r)  # a planned host_crash leaves through os._exit
                delay = injector.dcn_delay_s(r)
                if delay:
                    await asyncio.sleep(delay)
            hb.beat(round_number=r, status="collecting")
            t_round = time.perf_counter()
            start_wall = time.time()
            pipeline = server.ingest_pipeline
            decode_before = pipeline.decode_busy_seconds()
            # The strict shared beat: no early dispatch on a full quota, so the hosts
            # enter the all-reduce together.  The quota scores the round's outcome.
            deadline = anchor + (r - start_round + 1) * args.round_timeout_s
            stop_seen = None
            while True:
                if stop_file is not None and stop_file.exists():
                    # Written once every swarm submit landed: drain what is left after
                    # a short grace and vote stop.
                    if stop_seen is None:
                        stop_seen = time.monotonic()
                    elif time.monotonic() - stop_seen > 0.5:
                        break
                if time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.02)
            wait_measured = time.perf_counter() - t_round
            seg_decode = min(max(0.0, pipeline.decode_busy_seconds() - decode_before),
                             wait_measured)
            t_drain = time.perf_counter()
            out, mass, metas = await server.drain_ingest_fedavg_partial()
            seg_drain = time.perf_counter() - t_drain
            want_stop = (stop_file is not None and stop_file.exists()) or \
                (r + 1) >= args.rounds
            row = host_partial_row(out, mass, flat_size,
                                   extra=(1.0 if want_stop else 0.0,), device=dev)
            hb.beat(round_number=r, status="dispatch")
            dispatch_t: dict = {}

            def dispatch(row=row, base=base):
                # One collective; the apply happens on every host from the same summed
                # row, so the new params are the same bits everywhere.
                t0 = time.perf_counter()
                total = psum_fn(row)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                applied = apply_summed_row(base, total, flat_size)
                dispatch_t["collective"] = t1 - t0
                dispatch_t["apply"] = time.perf_counter() - t1
                return applied

            try:
                new_flat, tail = await loop.run_in_executor(None, lambda: watchdog.run(
                    dispatch, round_number=r,
                    tick=lambda: hb.beat(round_number=r, status="dispatch")))
            except HostFailure as exc:
                log(f"watchdog: {exc}")
                hb.beat(round_number=r, status="peer_failure")
                _exit_now(PEER_FAILURE_RC)
            except Exception as exc:  # a gloo error: a peer died
                log(f"dispatch failed (peer loss?): {type(exc).__name__}: {exc}")
                hb.beat(round_number=r, status="peer_failure")
                _exit_now(PEER_FAILURE_RC)
            global_mass, stop_votes = (float(v) for v in tail.tolist())
            if global_mass > 0.0:
                base = new_flat
                status = "COMPLETED" if len(metas) >= required else "DEGRADED"
            else:
                status = "FAILED"  # every host drained empty; the params stay
            rerouted = sum(1 for m in metas if not str(m.client_id).startswith(f"h{host}_"))
            rerouted_total += rerouted
            clients_seen.update(str(m.client_id) for m in metas)
            sentinel = want_stop and not metas and global_mass <= 0.0
            round_r = r
            r += 1
            t_publish = time.perf_counter()
            await server.publish_model(unravel(base, like), r)
            seg_publish = time.perf_counter() - t_publish
            dt = time.perf_counter() - t_round
            hb.beat(round_number=r, status="running")
            if not sentinel:
                segments = {
                    "wire_wait": max(0.0, wait_measured - seg_decode),
                    "decode": seg_decode, "drain": seg_drain,
                    "collective": dispatch_t.get("collective", 0.0),
                    "apply": dispatch_t.get("apply", 0.0), "publish": seg_publish,
                }
                ledger.charge(
                    status=status, num_clients=len(metas), duration_s=dt,
                    expected=args.round_quota, segments=segments,
                    telemetry_fields={
                        "round": round_r, "host": host, "status": status,
                        "duration_s": round(dt, 6), "start_wall": round(start_wall, 6),
                        "drained": len(metas), "mass": round(float(mass), 3),
                        "rerouted_in": rerouted, "traces": [m.trace for m in metas],
                    })
                line = {"round": round_r, "drained": len(metas),
                        "mass": round(float(mass), 3), "global_mass": global_mass,
                        "rerouted_in": rerouted, "duration_s": round(dt, 4),
                        "status": status, "wall_t": time.time(),
                        # The replay's input: who was drained, on which base, at what
                        # weight (federate_oracle).
                        "drains": [[m.client_id, int(m.round_number), float(m.weight)]
                                   for m in metas]}
                rounds_meta.append({k: v for k, v in line.items() if k != "drains"})
                if progress is not None:
                    with progress.open("a") as f:
                        f.write(json.dumps(line) + "\n")
                log(f"round {round_r}: drained {len(metas)} (mass {mass:.1f}, {rerouted} "
                    f"rerouted in) global mass {global_mass:.1f} [{status}] {dt:.2f}s")
            if r % args.block_size == 0 and not sentinel:
                store.commit(r // args.block_size, r, unravel(base, like), {},
                             hosts=hosts_list)
            if stop_votes >= n_hosts - 0.5:
                log(f"stop consensus at round {r} ({stop_votes:.0f}/{n_hosts} votes)")
                break
        if r % args.block_size != 0:
            store.commit(r // args.block_size + 1, r, unravel(base, like), {},
                         hosts=hosts_list)
        server.stop_training()
        await asyncio.sleep(0.2)  # let /status pollers see the stop
        hb.beat(round_number=r, status="done")
        np.save(args.out + ".params.npy", base.detach().cpu().numpy())
        result = {
            "mode": "federate", "host": host, "start_round": start_round, "end_round": r,
            "rounds": rounds_meta,
            "clients_distinct": len(clients_seen), "rerouted_in_total": rerouted_total,
            "topology": {"process_count": args.num_processes, "hosts": n_hosts,
                         "host_ids": hosts_list, "device": str(dev),
                         "mesh_shape": [args.num_processes, 1, 1]},
        }
        await server.stop()
        if telemetry is not None:
            telemetry.close()
        return result

    result = asyncio.run(_serve())
    Path(args.out).write_text(json.dumps(result, indent=2))
    log(f"wrote {args.out}")
    import torch.distributed as dist

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
        procs.append(_popen(cmd))
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


def _exit_on_sigterm(signum: int, frame: object) -> None:
    """SIGTERM as ``SystemExit``, so the supervisor's final reap runs."""
    raise SystemExit(128 + signum)


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
        procs.append(_popen(cmd))
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


def federate_oracle(model: str, seed: int, swarms: dict[str, dict], progress: list[dict]):
    """The numpy replay of a federate run: every round's drained rows from all hosts,
    ``base_r + einsum("c,cp->p", w, X - B_stamp) / Σ w`` in float64, where ``X`` is a
    client's canned body decoded and ``B_stamp`` the published version it was computed
    against (the einsum of ``tests/integration/test_ingest_parity.py``'s oracle).
    ``swarms`` maps a client-id prefix to its :class:`SwarmConfig` fields; ``progress``
    is every host's per-round lines.  Returns the final flat params (float64)."""
    import numpy as np
    import torch

    from nanofed_tpu_torch.communication.codec import decode_params
    from nanofed_tpu_torch.loadgen.swarm import SwarmConfig, make_canned_payloads
    from nanofed_tpu_torch.models import get_model

    like = get_model(model).init(torch.Generator().manual_seed(seed))

    def flat(params) -> np.ndarray:
        return np.concatenate([np.asarray(v, np.float64).ravel() for v in params.values()])

    bodies = {prefix: [flat(decode_params(b, like=like))
                       for b in make_canned_payloads(like, SwarmConfig(**cfg))]
              for prefix, cfg in swarms.items()}
    versions = [flat(like)]
    by_round: dict[int, list] = {}
    for line in progress:
        by_round.setdefault(int(line["round"]), []).extend(line["drains"])
    def body(cid: str) -> np.ndarray:
        prefix, index = cid.rsplit("_", 1)
        return bodies[prefix][int(index) % len(bodies[prefix])]

    for r in range(max(by_round, default=-1) + 1):
        rows = by_round.get(r, [])
        base = versions[r]
        if rows:
            num = np.zeros_like(base)
            for i in range(0, len(rows), 64):  # 64 rows at a time bound the memory
                chunk = rows[i:i + 64]
                x = np.stack([body(cid) - versions[stamp] for cid, stamp, _ in chunk])
                num += np.einsum("c,cp->p", np.array([w for *_, w in chunk]), x)
            base = base + num / sum(w for *_, w in rows)
        versions.append(base)
    return versions[-1]


def _spawn_federate(args: argparse.Namespace, host_ids: list[int], ports: list[int], *,
                    phase: str, hb_dir: Path, ckpt: Path, resume: bool,
                    plan_path: Path | None, stop_file: Path, tmp: Path,
                    telemetry_dir: Path) -> list[subprocess.Popen]:
    """One federate worker a LOGICAL host id (dense ranks a phase, stable host ids and
    ports across the kill), each with its own ready, progress and result files, on a
    fresh rendezvous."""
    rdv = _rendezvous(tmp)
    procs = []
    for rank, h in enumerate(host_ids):
        cmd = [sys.executable, str(Path(__file__).resolve()), "worker", "--job", "federate",
               "--process-id", str(rank), "--num-processes", str(len(host_ids)),
               "--rendezvous", str(rdv), "--device", args.device,
               "--timeout", str(args.timeout), "--rounds", str(args.max_rounds),
               "--model", args.model, "--seed", str(args.seed),
               "--block-size", str(args.block_size),
               "--watchdog-deadline", str(args.federate_watchdog), "--host-id", str(h),
               "--hosts-list", ",".join(map(str, host_ids)), "--hb-dir", str(hb_dir),
               "--ckpt-dir", str(ckpt), "--wire-port", str(ports[h]),
               "--ingest-capacity", str(args.ingest_capacity),
               "--staleness-window", str(args.staleness_window),
               "--round-quota", str(args.round_quota),
               "--min-completion-rate", str(args.min_completion_rate),
               "--round-timeout-s", str(args.round_timeout_s),
               "--stop-file", str(stop_file),
               "--ready-file", str(tmp / f"fed_ready_h{h}.json"),
               "--progress", str(tmp / f"fed_progress_{phase}_h{h}.jsonl"),
               "--out", str(tmp / f"fed_result_{phase}_h{h}.json"),
               "--telemetry-dir", str(telemetry_dir)]
        if resume:
            cmd.append("--resume")
        if plan_path is not None:
            cmd += ["--fault-plan", str(plan_path)]
        procs.append(_popen(cmd))
    return procs


def run_federate(args: argparse.Namespace) -> int:
    """``--num-processes`` hosts, each a listener and an ingest buffer joined by one
    cross-host all-reduce a round, under one swarm a host; every host's final params
    against :func:`federate_oracle`, no submit lost, no orphan.  With ``--kill-round`` a
    planned ``host_crash`` kills one host mid-campaign: its clients reroute to the
    survivors live, the world re-forms over the survivors from the newest generation
    every host committed, the dead host's population is re-driven, and the rounds the
    kill lost (after that generation) leave the replay."""
    import asyncio

    import numpy as np
    import torch

    from nanofed_tpu_torch.communication.retry import RetryPolicy
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.faults.plan import FaultEvent, FaultPlan
    from nanofed_tpu_torch.loadgen.swarm import SwarmConfig, latency_digest, run_swarm
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability.critical_path import federation_timeline
    from nanofed_tpu_torch.observability.telemetry import RunTelemetry
    from nanofed_tpu_torch.observability.tracing import (
        FLIGHT_RECORDER_FILENAME,
        FlightRecorder,
        mttr_decomposition,
    )
    from nanofed_tpu_torch.parallel.resilience import no_orphans
    from nanofed_tpu_torch.persistence import GenerationStore
    from nanofed_tpu_torch.utils.clock import VirtualClock

    n = args.num_processes
    if n < 2:
        raise SystemExit("federate needs --num-processes >= 2 (one listener a host)")
    tmp = Path(args.tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    hb_dir = _fresh_dir(tmp / "fed_hb")
    ckpt = _fresh_dir(tmp / "fed_ckpt")
    telemetry_dir = (_fresh_dir(tmp / "fed_telemetry") if args.telemetry_dir is None
                     else Path(args.telemetry_dir))
    telemetry_dir.mkdir(parents=True, exist_ok=True)
    stop_file = tmp / "federate_stop"
    stop_file.unlink(missing_ok=True)
    for stale in [*tmp.glob("fed_result_*"), *tmp.glob("fed_progress_*"),
                  *tmp.glob("fed_ready_*")]:
        stale.unlink()
    hosts = list(range(n))
    counts = [args.clients // n + (1 if i < args.clients % n else 0) for i in hosts]
    ports = ([args.wire_port + h for h in hosts] if args.wire_port
             else [free_port() for _ in hosts])
    urls = [f"http://127.0.0.1:{port}" for port in ports]
    kill = args.kill_round is not None
    victim = args.kill_host if args.kill_host is not None else n - 1
    plan = plan_path = None
    if kill:
        plan = FaultPlan(seed=args.seed, events=(
            FaultEvent(kind="host_crash", round=args.kill_round, host=victim),))
        plan_path = tmp / "federate_plan.json"
        plan.save(plan_path)
    # The workers' deterministic init: the servers reconstruct against the same base.
    base_params = get_model(args.model).init(torch.Generator().manual_seed(args.seed))
    recorder = FlightRecorder(name="federate-supervisor")
    all_pids: list[int] = []
    t0 = time.time()
    common = dict(hb_dir=hb_dir, ckpt=ckpt, stop_file=stop_file, tmp=tmp,
                  telemetry_dir=telemetry_dir)

    def _wait_ready(procs: list, live: list[int]) -> None:
        deadline = time.time() + args.timeout
        while not all((tmp / f"fed_ready_h{h}.json").exists() for h in live):
            for q in procs:
                if q.poll() is not None:
                    _reap(procs)
                    raise SystemExit(f"federate worker exited rc={q.returncode} during "
                                     "bring-up")
            if time.time() > deadline:
                _reap(procs)
                raise SystemExit(f"federate workers not ready within {args.timeout:.0f}s")
            time.sleep(0.1)

    def _cfg(owner: int) -> dict:
        # One canned-body pool an owner across phases, so the replay knows every body.
        return dict(num_clients=counts[owner], submits_per_client=args.submits_per_client,
                    arrival="uniform", arrival_rate=args.arrival_rate,
                    seed=args.seed + 17 * owner, client_prefix=f"h{owner}",
                    connector_limit=256, canned_payloads=4)

    def _job(owner: int, salt: int, primary: int, live: list[int], indices) -> tuple:
        # Generous retries: backoffs ride the virtual clock, and no client may exhaust
        # while a failover target is alive.
        config = SwarmConfig(
            retry=RetryPolicy(max_attempts=64, base_backoff_s=0.05, max_backoff_s=1.0,
                              multiplier=1.5, budget_s=None,
                              seed=args.seed + 31 * owner + salt),
            failover_urls=tuple(urls[j] for j in live if j != primary), **_cfg(owner))
        return urls[primary], config, indices

    async def _drive(procs: list, live: list[int], jobs: list, expect_kill: bool):
        """The sub-swarms beside a worker monitor: the planned victim's exit starts the
        reroute grace; any other exit stops the swarms (their pending submits terminate
        early and are re-driven or reported)."""
        stop_event = asyncio.Event()
        clock = VirtualClock()
        state: dict = {"t_kill": None, "unexpected": None}

        async def monitor() -> None:
            while not stop_event.is_set():
                rcs = [q.poll() for q in procs]
                killed = dict(zip(live, rcs)).get(victim) == HOST_CRASH_RC and expect_kill
                if killed and state["t_kill"] is None:
                    # Noted before the survivors' exits: a gloo peer fails at once when
                    # the victim dies, so both can show in one poll.
                    state["t_kill"] = time.time()
                    recorder.note("kill_detected", host=victim, rc=HOST_CRASH_RC)
                    print(f"# host {victim} killed by plan (rc={HOST_CRASH_RC}); wire "
                          f"clients reroute to survivors for {args.reroute_grace:.1f}s",
                          flush=True)
                for h, rc in zip(live, rcs):
                    if rc is None or (killed and h == victim):
                        continue
                    if rc == PEER_FAILURE_RC and expect_kill:
                        stop_event.set()
                        return
                    else:
                        state["unexpected"] = (h, rc)
                        stop_event.set()
                        return
                if state["t_kill"] is not None and \
                        time.time() - state["t_kill"] >= args.reroute_grace:
                    recorder.note("grace_elapsed", grace_s=args.reroute_grace)
                    stop_event.set()
                    return
                if all(rc is not None for rc in rcs):
                    stop_event.set()
                    return
                await asyncio.sleep(0.2)  # real time: a process liveness poll

        mon = asyncio.ensure_future(monitor())
        try:
            results = await asyncio.gather(*(
                run_swarm(url, base_params, config, clock=clock, stop=stop_event,
                          client_indices=indices) for url, config, indices in jobs))
        finally:
            stop_event.set()
            mon.cancel()
            try:
                await mon
            except (asyncio.CancelledError, Exception):
                pass
        return results, state

    # ---- phase A: every host, the whole population
    print(f"# federate: {n} hosts x wire listeners on {args.device}, {args.clients} wire "
          "clients" + (f"; planned host_crash on host {victim} at round {args.kill_round}"
                       if kill else ""), flush=True)
    procs = _spawn_federate(args, hosts, ports, phase="a", resume=False,
                            plan_path=plan_path, **common)
    all_pids += [q.pid for q in procs]
    recorder.note("spawned", phase="a", hosts=hosts)
    _wait_ready(procs, hosts)
    print("# all listeners ready; releasing the swarm", flush=True)
    results_a, state_a = asyncio.run(_drive(
        procs, hosts, [_job(h, 0, h, hosts, None) for h in hosts], kill))
    swarm_a = dict(zip(hosts, results_a))
    if state_a["unexpected"] is not None:
        _reap(procs)
        raise SystemExit(f"federate worker host {state_a['unexpected'][0]} exited "
                         f"rc={state_a['unexpected'][1]} mid-campaign")
    results_c: dict[int, object] = {}
    survivors = hosts
    recovery = None
    resumed_round = None
    if not kill:
        stop_file.write_text("stop\n")
        _wait(procs, args.timeout)
    else:
        if state_a["t_kill"] is None:
            _reap(procs)
            raise SystemExit("the kill was planned but the victim never died: lower "
                             "--kill-round or raise the population")
        # The survivors are blocked in an all-reduce the victim will never join.
        _reap(procs)
        recorder.note("reaped", victim=victim, phase="a")
        dump_path = recorder.dump(telemetry_dir / FLIGHT_RECORDER_FILENAME,
                                  extra={"victim": victim, "kill_round": args.kill_round})
        survivors = [h for h in hosts if h != victim]
        rec = GenerationStore(ckpt).latest_complete()
        resumed_round = rec.round_number if rec is not None else 0
        recovery = {"victim": victim, "kill_round": args.kill_round,
                    "reroute_grace_s": args.reroute_grace,
                    "resumed_generation": rec.generation if rec is not None else None,
                    "resumed_round": resumed_round, "hosts_after": len(survivors),
                    "flight_recorder": None if dump_path is None else str(dump_path)}
        print(f"# phase C: re-forming over hosts {survivors} at round {resumed_round}; "
              f"re-driving the dead host's {counts[victim]} wire clients", flush=True)
        for h in survivors:
            (tmp / f"fed_ready_h{h}.json").unlink(missing_ok=True)
        procs = _spawn_federate(args, survivors, ports, phase="c", resume=True,
                                plan_path=None, **common)
        all_pids += [q.pid for q in procs]
        recorder.note("respawned", phase="c", hosts=survivors)
        _wait_ready(procs, survivors)
        ready_mark = recorder.note("ready", phase="c", hosts=survivors)
        # The dead host's population is striped over the survivors (a planned re-drive,
        # spread up front); the survivors' clients that terminated early re-drive too.
        owners, jobs_c = [], []
        for j, s in enumerate(survivors):
            stripe = list(range(counts[victim]))[j::len(survivors)]
            if stripe:
                owners.append(victim)
                jobs_c.append(_job(victim, 1 + j, s, survivors, stripe))
        for h in survivors:
            missing = sorted(set(range(counts[h])) - set(swarm_a[h].completed_indices))
            if missing:
                owners.append(h)
                jobs_c.append(_job(h, 1, h, survivors, missing))
        results, state_c = asyncio.run(_drive(procs, survivors, jobs_c, False))
        if state_c["unexpected"] is not None:
            _reap(procs)
            raise SystemExit(f"federate worker host {state_c['unexpected'][0]} exited "
                             f"rc={state_c['unexpected'][1]} during recovery")
        for owner, res in zip(owners, results):
            prev = results_c.get(owner)
            if prev is None:
                results_c[owner] = res
                continue
            for field in ("accepted", "duplicates", "rejected_429", "retries",
                          "stale_refreshes", "failed", "terminated_early", "reroutes"):
                setattr(prev, field, getattr(prev, field) + getattr(res, field))
            prev.latencies_s += res.latencies_s
            prev.completed_indices += res.completed_indices
        stop_file.write_text("stop\n")
        _wait(procs, args.timeout)
        # "recompile" ends at the recovered world's first drained round, read back
        # from the phase-C progress and mapped onto the monotonic axis.
        walls = [line["wall_t"] for h in survivors
                 for line in _read_progress(tmp / f"fed_progress_c_h{h}.jsonl")[:1]]
        if walls:
            recorder.note("first_progress", wall=round(min(walls), 6),
                          t_mono=round(ready_mark["t_mono"]
                                       + max(0.0, min(walls) - ready_mark["t_wall"]), 6))
        phases = mttr_decomposition(recorder.snapshot(), [
            ("kill_detected", None), ("grace_elapsed", "reroute_grace"),
            ("reaped", "reap"), ("respawned", "respawn"), ("ready", "bring_up"),
            ("first_progress", "recompile")])
        recovery["mttr_phases"] = phases
        recovery["recovery_s"] = round(sum(phases.values()), 3)
        recorder.dump(telemetry_dir / FLIGHT_RECORDER_FILENAME,
                      extra={"victim": victim, "kill_round": args.kill_round,
                             "mttr_phases": phases})

    # ---- accounting, the replay and the checks
    all_results = list(swarm_a.values()) + list(results_c.values())
    latencies = [x for res in all_results for x in res.latencies_s]
    failed = sum(res.failed for res in all_results)
    lost = {}
    for h in hosts:
        done = set(swarm_a[h].completed_indices)
        if h in results_c:
            done |= set(results_c[h].completed_indices)
        if len(done & set(range(counts[h]))) < counts[h]:
            lost[h] = counts[h] - len(done & set(range(counts[h])))
    lines_a = {h: _read_progress(tmp / f"fed_progress_a_h{h}.jsonl") for h in hosts}
    lines_c = {h: _read_progress(tmp / f"fed_progress_c_h{h}.jsonl") for h in survivors}
    # The rounds a kill lost (after the resumed generation) died with phase A.
    kept = [line for h in hosts for line in lines_a[h]
            if resumed_round is None or line["round"] < resumed_round]
    progress = kept + [line for h in survivors for line in lines_c.get(h, [])]
    final_phase = "c" if kill else "a"
    want = federate_oracle(args.model, args.seed, {f"h{h}": _cfg(h) for h in hosts},
                           progress)
    finals = [np.load(tmp / f"fed_result_{final_phase}_h{h}.json.params.npy")
              for h in survivors]
    gaps = [float(np.abs(f.astype(np.float64) - want).max()) for f in finals]
    same_bits = all(np.array_equal(finals[0], f) for f in finals[1:])
    every = [line for h in hosts for line in lines_a[h]] + \
        [line for h in survivors for line in lines_c.get(h, [])]
    durations = sorted(line["duration_s"] for line in every)
    median_round = durations[len(durations) // 2] if durations else None
    rerouted_drained = sum(line.get("rerouted_in", 0) for line in every)
    orphans = no_orphans(all_pids)
    timeline = federation_timeline(telemetry_dir)
    digest = latency_digest(latencies)
    wire = {
        "accepted": sum(res.accepted for res in all_results),
        "duplicates": sum(res.duplicates for res in all_results), "failed": failed,
        "terminated_early": sum(res.terminated_early for res in all_results),
        "reroutes": sum(res.reroutes for res in all_results),
        "rerouted_updates_drained": rerouted_drained, "submit_latency": digest,
    }
    artifact = {
        "record_type": "federation",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "seed": args.seed, "model": args.model, "wire_clients": args.clients,
        "submits_per_client": args.submits_per_client, "per_host_clients": counts,
        "topology": {"hosts": n, "mesh_shape": [n, 1, 1], "wire_ports": ports,
                     "device": args.device, "survivors": survivors},
        "rounds": {
            "drained_rounds": len(every), "median_round_s": median_round,
            "rounds_per_sec": round(1.0 / median_round, 4) if median_round else None,
            "round_quota": args.round_quota,
            "min_completion_rate": args.min_completion_rate,
            "updates_aggregated": sum(line["drained"] for line in progress),
        },
        "wire": wire,
        "chaos": {"plan": json.loads(plan.to_json()), **recovery} if kill else None,
        "oracle": {"max_abs_gap_by_host": gaps, "tolerance": FEDERATE_TOL,
                   "hosts_bit_equal": same_bits, "rounds_replayed": len(progress),
                   "basis": "numpy einsum replay of every drained round kept, float64"},
        "critical_path": {"rounds": timeline["rounds"],
                          "segments": timeline.get("segments"),
                          "coverage": timeline.get("coverage")},
        "trace_resolution": timeline["trace_resolution"],
        "zero_lost_submits": failed == 0 and not lost,
        "orphans": orphans,
        "platform": "gpu" if args.device.startswith("cuda") else "cpu",
        "basis": ("worker processes over gloo, one rank a host, with a real aiohttp wire "
                  "tier: each host drains its ingest buffer host-locally and joins one "
                  "cross-host all-reduce a round; the swarm's arrivals and backoffs ride "
                  "a VirtualClock, submit latencies are wall-clock against live "
                  "sockets.  Ranks that share one card measure the program, not a "
                  "round across cards."),
        "harness": "scripts/multihost_harness_torch.py federate",
        "walltime_s": round(time.time() - t0, 1),
    }
    tel = RunTelemetry(telemetry_dir)
    tel.record("federation", wire_clients=args.clients, hosts=n, survivors=len(survivors),
               rounds=len(every), rounds_per_sec=artifact["rounds"]["rounds_per_sec"],
               p99_submit_s=digest["p99_s"], accepted=wire["accepted"],
               duplicates=wire["duplicates"], failed=failed, reroutes=wire["reroutes"],
               rerouted_updates_drained=rerouted_drained,
               terminated_early_redriven=wire["terminated_early"],
               zero_lost_submits=artifact["zero_lost_submits"],
               host_killed=victim if kill else None, kill_round=args.kill_round)
    if kill:
        tel.record("host_failure", kind="host_crash", host=victim, round=args.kill_round)
        tel.record("recovery", **recovery)
    tel.close()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (f"federation_torch_{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
                  f"_{n}h.json")
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    print(json.dumps(artifact, indent=2))
    print(f"# artifact: {path}", flush=True)
    problems = []
    if failed or lost:
        problems.append(f"lost submits: {failed} failed, clients never completed {lost}")
    if not all(lines_a[h] for h in hosts):
        problems.append(f"a host drained no rounds in phase A: "
                        f"{ {h: len(v) for h, v in lines_a.items()} }")
    if max(gaps) > FEDERATE_TOL or not same_bits:
        problems.append(f"final params against the oracle: gaps {gaps} (tolerance "
                        f"{FEDERATE_TOL}), hosts bit-equal {same_bits}")
    if kill and not (wire["reroutes"] > 0 and rerouted_drained > 0):
        problems.append(f"the kill rerouted no client ({wire['reroutes']} reroutes, "
                        f"{rerouted_drained} rerouted updates drained)")
    if kill and len(list(telemetry_dir.glob("host_*/telemetry.jsonl"))) < n:
        problems.append("the dead host's telemetry stream did not survive")
    if orphans:
        problems.append(f"orphan workers survived: {orphans}")
    if problems:
        raise SystemExit("federate failed: " + "; ".join(problems))
    print(f"federate OK: {n} hosts, {len(every)} drained rounds, {wire['accepted']} "
          f"accepted, oracle gap {max(gaps):.3e}")
    return 0

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "mode", choices=["smoke", "bench", "hostchaos", "federate", "worker"],
        help="smoke: a hosts-mesh world vs one rank; bench: rounds/s artifact; "
        "hostchaos: seeded kill-and-recover drill; federate: wire clients into the "
        "cross-host reduce; worker: internal (one rank)")
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
    parser.add_argument("--job", choices=["smoke", "bench", "hostchaos", "federate"],
                        default="smoke",
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
    parser.add_argument("--wire-port", type=int, default=0,
                        help="(federate) host h listens on this + h; 0 picks free ports "
                        "(a worker: its own port)")
    parser.add_argument("--ingest-capacity", type=int, default=8192,
                        help="(federate) ingest buffer rows a host")
    parser.add_argument("--staleness-window", type=int, default=8,
                        help="(federate) versions a submit may lag (>= 1)")
    parser.add_argument("--round-quota", type=int, default=1024,
                        help="(federate) drained updates a host must reach for a "
                        "COMPLETED round (below: DEGRADED, still applied)")
    parser.add_argument("--min-completion-rate", type=float, default=1.0)
    parser.add_argument("--round-timeout-s", type=float, default=10.0,
                        help="(federate) the shared beat: seconds a round")
    parser.add_argument("--submits-per-client", type=int, default=1)
    parser.add_argument("--arrival-rate", type=float, default=4000.0,
                        help="(federate) virtual submits/s a host's swarm")
    parser.add_argument("--max-rounds", type=int, default=10_000,
                        help="(federate) rounds before the hosts vote stop on their own")
    parser.add_argument("--federate-watchdog", type=float, default=240.0,
                        help="(federate) deadline of a round's all-reduce")
    parser.add_argument("--kill-round", type=int, default=None,
                        help="(federate) a planned host_crash at this round: live "
                        "reroutes, the world re-formed over the survivors, the dead "
                        "host's clients re-driven")
    parser.add_argument("--kill-host", type=int, default=None,
                        help="(federate) the host --kill-round kills (default: the last)")
    parser.add_argument("--reroute-grace", type=float, default=6.0,
                        help="(federate) seconds the swarm reroutes to survivors after "
                        "the kill before the world re-forms")
    parser.add_argument("--stop-file", default=None, help="(worker) federate stop flag")
    parser.add_argument("--ready-file", default=None, help="(worker) federate ready flag")
    args = parser.parse_args(argv)

    if args.clients is None:
        args.clients = 100_000 if args.mode == "bench" else 16
    if args.mode == "worker":
        return run_worker(args)
    run = {"smoke": run_smoke, "bench": run_bench, "hostchaos": run_hostchaos,
           "federate": run_federate}[args.mode]
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    try:
        return run(args)
    finally:
        _reap(_WORKERS)


if __name__ == "__main__":
    sys.exit(main())
