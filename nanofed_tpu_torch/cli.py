"""Command line of the PyTorch/CUDA port (counterpart of ``nanofed_tpu/cli.py``),
installed as ``nanofed-tpu-torch``; ``python -m nanofed_tpu_torch.cli`` runs the same.

``run`` drives a simulated federated experiment (``--dp-epsilon`` engages
budget-calibrated central DP), ``bench`` runs the BASELINE.json suite, ``profile``
profiles the round programs without running a federation (``--sweep``: the autotune
sweep), ``serve`` hosts the network-mode federation server, ``metrics-summary``
digests a run's ``telemetry.jsonl``, ``trace`` merges per-host telemetry streams into
one timeline, and ``info`` prints the environment and the model zoo.  ``--telemetry-dir``
on ``run``, ``profile`` and ``serve`` says where the telemetry goes.  ``run``, ``bench``, ``profile`` and ``serve`` run on
``--device`` (default ``cuda``: without a card they raise unless given
``--device cpu``).

The port profiles by RUNNING each program (``observability.profiling``): the JAX
package asks XLA's cost model and runs nothing, so ``profile`` and ``profile
--sweep`` cost a few round times per program here.

The JAX command line's subcommands and flags of later slices are registered, so
``--help`` lists them, and refused with the ROADMAP queue A item that brings them:
a refused subcommand, or a refused flag set to anything but the JAX default, exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

# Subcommands of later slices: name -> (help, ROADMAP queue A item).
LATER_SUBCOMMANDS: dict[str, tuple[str, str]] = {
    "chaos-plan": ("generate a seeded FaultPlan JSON", "item 17 (multi-host federation "
                   "and faults)"),
    "audit": ("audit the round programs", "item 21 (analysis)"),
    "loadtest": ("synthetic client swarm load harness", "item 18 (load and service)"),
    "tenants": ("multi-tenant federation service drill", "item 18 (load and service)"),
}

# Flags of later slices, by subcommand: dest -> (flag, type, JAX default, item).
_ADAPTERS = "item 16 (transformer, adapters and fleet)"
_GPUS = "item 9b (several GPUs)"
LATER_SLICE_FLAGS: dict[str, dict[str, tuple[str, type, Any, str]]] = {
    "run": {
        "adapter_rank": ("--adapter-rank", int, None, _ADAPTERS),
        "adapter_alpha": ("--adapter-alpha", float, None, _ADAPTERS),
        "model_shards": ("--model-shards", int, 1, _GPUS),
        "hosts": ("--hosts", int, 1, _GPUS),
        "distributed": ("--distributed", bool, False, _GPUS),
        "strict": ("--strict", bool, False, "item 21 (analysis)"),
    },
    "profile": {
        "adapter_rank": ("--adapter-rank", int, None, _ADAPTERS),
        "model_shards": ("--model-shards", int, 1, _GPUS),
        "hosts": ("--hosts", int, 1, _GPUS),
    },
    "serve": {
        "chaos_plan": ("--chaos-plan", str, None,
                       "item 17 (multi-host federation and faults)"),
        "max_inflight": ("--max-inflight", int, None, "item 18 (load and service)"),
    },
}


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _refused_flags(args: argparse.Namespace) -> int | None:
    """Exit code 2 with the item named when a later slice's flag is set."""
    for dest, (flag, _, default, item) in LATER_SLICE_FLAGS.get(args.cmd, {}).items():
        if getattr(args, dest) != default:
            return _error(f"{flag} is not supported by nanofed_tpu_torch yet: it comes "
                          f"with ROADMAP queue A {item} (run nanofed-tpu for it)")
    return None


def _cmd_info(_args: argparse.Namespace) -> int:
    import torch

    from nanofed_tpu_torch.models import list_models

    available = torch.cuda.is_available()
    print(json.dumps({
        "package": "nanofed_tpu_torch",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": available,
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())] if available else [],
        "models": list_models(),
    }, indent=2))
    return 0


def _central_privacy(args: argparse.Namespace) -> tuple[Any, int | None]:
    """The σ-calibrated central-DP config of ``--dp-epsilon`` (or None), or an exit
    code for an infeasible budget."""
    if args.dp_epsilon is None:
        return None, None
    from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig
    from nanofed_tpu_torch.orchestration import cohort_size
    from nanofed_tpu_torch.privacy import PrivacyConfig
    from nanofed_tpu_torch.privacy.accounting import noise_multiplier_for_budget

    # Calibrated at the realized per-client inclusion probability, as the coordinator
    # accounts the spend (cohort / N).
    cohort = cohort_size(args.clients, args.participation)
    try:
        sigma = noise_multiplier_for_budget(
            args.dp_epsilon, args.dp_delta, sampling_rate=cohort / args.clients,
            num_events=args.rounds,
        )
        config = PrivacyAwareAggregationConfig(privacy=PrivacyConfig(
            epsilon=args.dp_epsilon, delta=args.dp_delta,
            max_gradient_norm=args.dp_clip, noise_multiplier=sigma,
        ))
    except ValueError as e:
        return None, _error(f"invalid DP budget: {e}")
    print(f"# central DP: sigma={sigma:.4f} calibrated for (eps={args.dp_epsilon}, "
          f"delta={args.dp_delta}) over {args.rounds} rounds (tight RDP accounting)",
          file=sys.stderr)
    return config, None


def _cmd_run(args: argparse.Namespace) -> int:
    from nanofed_tpu_torch.core.device import resolve_device
    from nanofed_tpu_torch.experiments import run_experiment

    device = resolve_device(args.device)
    robust = args.robust_trim is not None or args.robust_method is not None
    if robust and args.dp_epsilon is not None:
        return _error("--robust-trim cannot be combined with --dp-epsilon — the DP "
                      "guarantee is calibrated for the clipped mean; a trimmed mean has a "
                      "different sensitivity and the stated budget would be wrong")
    if args.scaffold and (args.dp_epsilon is not None or robust):
        return _error("--scaffold cannot be combined with --dp-epsilon, --robust-trim, or "
                      "--robust-method — DP noise / robust trimming/selection would bias "
                      "the control estimate every later round relies on")
    if args.retune_every > 0 and not args.autotune:
        return _error("--retune-every requires --autotune — the online retuner re-ranks "
                      "the sweep's candidate table; without a sweep there is no table")
    if args.autotune:
        pinned = [flag for flag, engaged in (
            ("--client-chunk", args.client_chunk is not None),
            ("--rounds-per-block", args.rounds_per_block != 1),
        ) if engaged]
        if pinned:
            return _error(f"--autotune cannot be combined with {', '.join(pinned)} — the "
                          "sweep picks those knobs; drop --autotune to set them by hand")
    central_privacy, code = _central_privacy(args)
    if code is not None:
        return code
    metrics = run_experiment(
        model=args.model,
        num_clients=args.clients,
        num_rounds=args.rounds,
        local_epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        scheme=args.scheme,
        participation=args.participation,
        data_dir=args.data_dir,
        out_dir=args.out_dir,
        seed=args.seed,
        train_size=args.train_size,
        client_chunk=args.client_chunk,
        compute_dtype=args.dtype,
        central_privacy=central_privacy,
        lr_schedule=args.lr_schedule,
        lr_min_factor=args.lr_min_factor,
        lr_decay_every=args.lr_decay_every,
        lr_decay_gamma=args.lr_decay_gamma,
        robust_trim_k=args.robust_trim,
        robust_method=args.robust_method,
        scaffold=args.scaffold,
        rounds_per_block=args.rounds_per_block,
        client_metrics_every=args.client_metrics_every,
        profile_programs=args.profile_programs,
        autotune=args.autotune,
        retune_every=args.retune_every,
        telemetry_dir=args.telemetry_dir,
        device=device,
    )
    print(json.dumps(metrics, indent=2, default=str))
    return 0


def _profile_inputs(args: argparse.Namespace):
    """The model, its client data and the training config ``profile`` works on."""
    from nanofed_tpu_torch.data import federate
    from nanofed_tpu_torch.experiments import load_datasets_for
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.trainer import TrainingConfig

    mdl = get_model(args.model)
    train, _ = load_datasets_for(mdl, args.data_dir, args.train_size, args.seed)
    client_data = federate(train, num_clients=args.clients, scheme="iid",
                           batch_size=args.batch_size, seed=args.seed)
    training = TrainingConfig(batch_size=args.batch_size, local_epochs=args.epochs,
                              learning_rate=args.lr, compute_dtype=args.dtype)
    return mdl, client_data, training


def _cmd_sweep(args: argparse.Namespace) -> int:
    """``profile --sweep``: the autotune sweep (``nanofed_tpu_torch.tuning``) — profile
    every candidate round configuration, rank them, print the ranked table and the
    fused-epilogue comparison; the table lands as ``<out-dir>/autotune_*.json`` and
    the result is cached, so a repeat sweep profiles nothing."""
    import dataclasses

    from nanofed_tpu_torch.core.device import resolve_device
    from nanofed_tpu_torch.tuning import (
        AutotuneError,
        PopulationSpec,
        TuningSpace,
        autotune,
        format_candidate_table,
    )

    device = resolve_device(args.device)
    mdl, client_data, training = _profile_inputs(args)
    pop = PopulationSpec.from_client_data(client_data)
    num_rounds = max(args.rounds_per_block, 8)
    space = None
    if args.client_chunk is not None:  # pin that axis to the one value, never ignore it
        space = dataclasses.replace(
            TuningSpace.default(pop, 1, training.batch_size, num_rounds),
            client_chunks=(args.client_chunk,),
        )
    telemetry = None
    if args.telemetry_dir is not None:
        from nanofed_tpu_torch.observability import RunTelemetry

        telemetry = RunTelemetry(args.telemetry_dir)
    try:
        result = autotune(mdl, pop, training, participation=args.participation,
                          num_rounds=num_rounds, space=space, telemetry=telemetry,
                          force=args.force_sweep, device=device)
    except AutotuneError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if telemetry is not None:
            telemetry.close()
    if args.json:
        print(json.dumps(result.to_dict(), indent=2))
        return 0
    print(format_candidate_table(result))
    epi = result.epilogues
    if epi and "error" not in epi:
        print()
        for path in ("q8", "validated"):
            cmp_ = epi[path]
            pct = cmp_.get("bytes_accessed_reduction_pct")
            print(f"{path} epilogue: fused {cmp_['fused_bytes_accessed']:,.0f} bytes vs "
                  f"unfused {cmp_['unfused_bytes_accessed']:,.0f} bytes"
                  + (f" ({pct:+.1f}% reduction)" if pct is not None else ""))
        print(f"epilogue basis: {epi['basis']}")
    if result.cache_hit:
        print("\n(cache hit: nothing profiled this invocation)")
    if result.artifact_path:
        print(f"ranked table written to {result.artifact_path}")
    return 0


def _cmd_profile(args: argparse.Namespace) -> int:
    """Profile the round programs — single step, fused block, SCAFFOLD — without
    running a federation, and print what each costs (``observability.profiling``:
    counted FLOPs and bytes, peak device bytes, measured time, roofline verdict)."""
    if args.sweep:
        return _cmd_sweep(args)
    from nanofed_tpu_torch.core.device import resolve_device
    from nanofed_tpu_torch.observability import format_cost_table
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig

    device = resolve_device(args.device)
    mdl, client_data, training = _profile_inputs(args)

    def build(scaffold: bool, rounds_per_block: int) -> Coordinator:
        # save_metrics=False: profiling leaves no run artifacts behind (telemetry
        # lands only where --telemetry-dir points); num_rounds only has to admit
        # the block length.
        return Coordinator(
            model=mdl, train_data=client_data,
            config=CoordinatorConfig(
                num_rounds=max(1, rounds_per_block), participation_rate=args.participation,
                seed=args.seed, save_metrics=False, rounds_per_block=rounds_per_block,
            ),
            training=training, scaffold=scaffold, client_chunk=args.client_chunk,
            device=device, telemetry_dir=args.telemetry_dir,
        )

    coordinators = [build(scaffold=False, rounds_per_block=args.rounds_per_block)]
    if not args.no_scaffold:
        coordinators.append(build(scaffold=True, rounds_per_block=1))
    reports = []
    for coord in coordinators:
        reports.extend(coord.profile_programs())
        if coord.telemetry is not None:
            coord.telemetry.close()
    if args.json:
        print(json.dumps([r.to_dict() for r in reports], indent=2))
    else:
        print(format_cost_table(reports))
    return 0 if reports else 1


def _serve_refusal(args: argparse.Namespace) -> str | None:
    """The JAX ``serve``'s refusals of flag combinations, word for word."""
    if args.secure and args.validate:
        return ("--validate cannot be combined with --secure — masked updates are "
                "indistinguishable from noise; range enforcement in secure mode comes "
                "from quantization bounds and client-side DP clipping")
    if args.dropout_tolerant and not args.secure:
        return "--dropout-tolerant requires --secure (it is a secure-aggregation mode)"
    if args.ingest_batch is not None and args.validate:
        return ("--ingest-batch cannot be combined with --validate — batched ingest "
                "folds updates into a device buffer at submit time, so per-update "
                "shape/norm/z-score checks have nothing to inspect")
    if args.ingest_batch is None and (args.ingest_capacity is not None
                                      or args.decode_workers is not None):
        return ("--ingest-capacity/--decode-workers only apply with --ingest-batch (they "
                "size the batched ingest pipeline)")
    if args.async_buffer is not None:
        explicit = [flag for flag, value in (
            ("--min-clients", args.min_clients),
            ("--completion-rate", args.completion_rate),
            ("--max-clients", args.max_clients),
        ) if value is not None]
        if explicit:
            return (f"{', '.join(explicit)} only appl"
                    f"{'ies' if len(explicit) == 1 else 'y'} to synchronous cohort rounds "
                    "— asynchronous --async-buffer mode has no cohort barrier "
                    "(aggregations fire when K updates are buffered)")
    min_clients = args.min_clients if args.min_clients is not None else 1
    if args.max_clients is not None and not args.dropout_tolerant:
        return ("--max-clients only applies to the --dropout-tolerant enrollment window "
                "(plain --secure cohorts are exactly --min-clients)")
    if args.max_clients is not None and args.max_clients < min_clients:
        return (f"--max-clients ({args.max_clients}) must be >= --min-clients "
                f"({min_clients}) — reaching the cap freezes the enrollment window, "
                "which would close below the minimum")
    if args.async_buffer is not None and (args.secure or args.validate):
        return ("--async-buffer cannot be combined with --secure or --validate — "
                "asynchronous aggregation mixes staleness levels these round-locked "
                "mechanisms assume away")
    if args.async_buffer is not None and args.async_buffer < 1:
        return "--async-buffer must be >= 1"
    if (args.async_buffer is not None and args.staleness_window is not None
            and args.staleness_window < 1):
        return "--staleness-window must be >= 1 in async mode"
    if args.staleness_window is not None and args.async_buffer is None:
        return "--staleness-window only applies with --async-buffer"
    return None


def _cmd_serve(args: argparse.Namespace) -> int:
    """Host a network-mode federation server and its round engine as one command."""
    import asyncio

    import torch

    from nanofed_tpu_torch.communication import (
        HTTPServer,
        NetworkCoordinator,
        NetworkRoundConfig,
    )
    from nanofed_tpu_torch.core.device import resolve_device
    from nanofed_tpu_torch.models import get_model

    device = resolve_device(args.device)
    refusal = _serve_refusal(args)
    if refusal is not None:
        return _error(refusal)
    min_clients = args.min_clients if args.min_clients is not None else 1
    completion_rate = args.completion_rate if args.completion_rate is not None else 1.0
    ingest = None
    if args.ingest_batch is not None:
        from nanofed_tpu_torch.ingest import IngestConfig

        # The JAX package sizes its compiled flush programs by the batch; the port
        # compiles nothing, so --ingest-batch only engages the buffer.
        try:
            ingest = IngestConfig(
                capacity=args.ingest_capacity if args.ingest_capacity is not None else 1024,
                decode_workers=args.decode_workers if args.decode_workers is not None else 4,
            )
        except ValueError as e:
            return _error(f"invalid ingest config: {e}")
    secure = None
    if args.secure:
        from nanofed_tpu_torch.security.secure_agg import SecureAggregationConfig

        # Dropout-tolerant mode keeps one eviction's worth of slack below the enrolled
        # cohort; the Shamir threshold is derived when the roster freezes.
        floor = max(2, min_clients - 1) if args.dropout_tolerant else min_clients
        secure = SecureAggregationConfig(min_clients=floor,
                                         dropout_tolerant=args.dropout_tolerant)
    validation = None
    if args.validate:
        from nanofed_tpu_torch.security.validation import ValidationConfig

        validation = ValidationConfig(max_norm=args.max_norm)
    state_store = None
    if args.state_dir is not None:
        from nanofed_tpu_torch.persistence import FileStateStore

        state_store = FileStateStore(args.state_dir)
    model = get_model(args.model)
    params = {name: p.to(device)
              for name, p in model.init(torch.Generator().manual_seed(args.seed)).items()}

    async def serve() -> list[dict]:
        server = HTTPServer(host=args.host, port=args.port, ingest=ingest, device=device)
        await server.start()
        try:
            coordinator = NetworkCoordinator(
                server, params,
                NetworkRoundConfig(
                    num_rounds=args.rounds,
                    min_clients=min_clients,
                    min_completion_rate=completion_rate,
                    round_timeout_s=args.timeout,
                    max_clients=args.max_clients,
                    straggler_evict_after=args.evict_stragglers,
                    async_buffer_k=args.async_buffer,
                    staleness_window=(args.staleness_window
                                      if args.staleness_window is not None else 4),
                ),
                validation=validation, secure=secure, device=device,
                state_store=state_store, telemetry_dir=args.telemetry_dir,
            )
            return await coordinator.run()
        finally:
            await server.stop()

    try:
        history = asyncio.run(serve())
    except TimeoutError as e:
        # The cohort never completed enrollment: keep the JSON output.
        print(json.dumps([{"status": "FAILED", "error": str(e)}]))
        return 1
    print(json.dumps(history, indent=2, default=str))
    return 0 if all(h["status"] == "COMPLETED" for h in history) else 1


def _cmd_bench(args: argparse.Namespace) -> int:
    from nanofed_tpu_torch.benchmarks import BENCHMARKS, run_benchmark
    from nanofed_tpu_torch.core.device import resolve_device

    if args.list:
        print(json.dumps(sorted(BENCHMARKS), indent=2))
        return 0
    overrides: dict[str, Any] = {}
    if args.train_size is not None:
        overrides["train_size"] = args.train_size
    if args.rounds is not None:
        overrides["num_rounds"] = args.rounds
    if args.client_chunk is not None:
        overrides["client_chunk"] = args.client_chunk
    if args.dtype is not None:
        overrides["compute_dtype"] = args.dtype
    summary = run_benchmark(args.name, out_dir=args.out_dir,
                            device=resolve_device(args.device), **overrides)
    print(json.dumps(summary, indent=2, default=str))
    return 0


def _cmd_metrics_summary(args: argparse.Namespace) -> int:
    """Digest a run's ``telemetry.jsonl``: per-phase span durations, round outcomes and
    headline counters, as one JSON document."""
    from nanofed_tpu_torch.observability import find_latest_telemetry, summarize_telemetry

    path = find_latest_telemetry(args.path)
    if path is None:
        print(f"error: no telemetry.jsonl found under {args.path!r} — run with "
              "--telemetry-dir (or the default runs dir with metrics saving on) "
              "first", file=sys.stderr)
        return 1
    print(json.dumps(summarize_telemetry(path), indent=2))
    return 0


def _cmd_trace(args: argparse.Namespace) -> int:
    """Merge a run's per-host ``telemetry.jsonl`` streams into one clock-aligned story:
    the per-round critical-path digest on stdout and, with ``--chrome-out``, a
    host-laned Chrome/Perfetto timeline."""
    from pathlib import Path

    from nanofed_tpu_torch.observability import (
        clock_offsets,
        federation_timeline,
        load_host_streams,
        merge_timeline,
    )

    root = Path(args.path)
    streams = load_host_streams(root)
    if not streams:
        print(f"error: no telemetry.jsonl streams found under {root} — run with "
              "--telemetry-dir first", file=sys.stderr)
        return 1
    if args.chrome_out is not None:
        timeline = merge_timeline(streams, clock_offsets(streams))
        out = Path(args.chrome_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(timeline))
        print(f"# wrote {len(timeline['traceEvents'])} trace events to {out}",
              file=sys.stderr)
    digest = federation_timeline(root, include_trace_map=args.trace_map)
    print(json.dumps(digest, indent=2))
    resolution = digest.get("trace_resolution") or {}
    return 0 if resolution.get("resolved", True) else 1


def _add_telemetry_dir(p: argparse.ArgumentParser, text: str) -> None:
    p.add_argument("--telemetry-dir", default=None, help=text)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; without a card this "
                   "raises unless given --device cpu)")


def _add_later_flags(p: argparse.ArgumentParser, cmd: str) -> None:
    for dest, (flag, kind, default, item) in LATER_SLICE_FLAGS[cmd].items():
        note = f"not in nanofed_tpu_torch yet (ROADMAP queue A {item})"
        if kind is bool:
            p.add_argument(flag, dest=dest, action="store_true", help=note)
        else:
            p.add_argument(flag, dest=dest, type=kind, default=default, help=note)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="nanofed-tpu-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="print torch, CUDA, the visible cards and the model zoo")

    run = sub.add_parser("run", help="run a federated training experiment")
    run.add_argument("--model", default="mnist_cnn")
    run.add_argument("--clients", type=int, default=10)
    run.add_argument("--rounds", type=int, default=2)
    run.add_argument("--epochs", type=int, default=2)
    run.add_argument("--batch-size", type=int, default=64)
    run.add_argument("--lr", type=float, default=0.1)
    run.add_argument("--scheme", default="iid", choices=["iid", "label_skew", "dirichlet"])
    run.add_argument("--participation", type=float, default=1.0)
    run.add_argument("--data-dir", default=None,
                     help="MNIST IDX files, or cifar-10-batches-py/ and cifar-100-python/; "
                     "synthetic data of the same shapes without them")
    run.add_argument("--out-dir", default="runs")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--train-size", type=int, default=None,
                     help="cap the (synthetic) training set size; default = full dataset")
    run.add_argument("--client-chunk", type=int, default=None,
                     help="train and reduce the clients in sequential chunks of this many")
    run.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                     help="local-training compute dtype (mixed precision when bfloat16)")
    run.add_argument("--rounds-per-block", type=int, default=1,
                     help="run blocks of this many rounds with no host barrier between "
                     "them; falls back to single rounds for --scaffold/--robust-*/--dp-epsilon")
    run.add_argument("--client-metrics-every", type=int, default=1,
                     help="per-client detail in the round metrics JSON every N rounds; 0 = never")
    run.add_argument("--lr-schedule", default="constant",
                     choices=["constant", "cosine", "linear", "step"],
                     help="per-round client-lr schedule")
    run.add_argument("--lr-min-factor", type=float, default=0.0,
                     help="terminal lr fraction for cosine/linear; floor for step")
    run.add_argument("--lr-decay-every", type=int, default=10,
                     help="step schedule: rounds between decays")
    run.add_argument("--lr-decay-gamma", type=float, default=0.5,
                     help="step schedule: multiplier per decay")
    run.add_argument("--scaffold", action="store_true",
                     help="SCAFFOLD control variates; refuses --dp-epsilon and --robust-*")
    run.add_argument("--robust-trim", type=int, default=None, metavar="K",
                     help="coordinate-wise trimmed mean dropping K extremes per side")
    run.add_argument("--robust-method", default=None,
                     choices=["trimmed_mean", "median", "multi_krum"],
                     help="robust estimator (trimmed_mean when --robust-trim is set)")
    run.add_argument("--dp-epsilon", type=float, default=None,
                     help="central DP-FedAvg with noise calibrated to this epsilon budget "
                     "over the run's rounds")
    run.add_argument("--dp-delta", type=float, default=1e-5)
    run.add_argument("--dp-clip", type=float, default=1.0,
                     help="central-DP per-update clip norm C")
    run.add_argument("--autotune", action="store_true",
                     help="pick client_chunk / rounds-per-block / batch size from a sweep "
                     "that profiles each candidate round; incompatible with "
                     "--client-chunk/--rounds-per-block")
    run.add_argument("--retune-every", type=int, default=0, metavar="N",
                     help="re-rank the sweep's table by measured round times every N "
                     "rounds (requires --autotune); 0 = off")
    run.add_argument("--profile-programs", action="store_true",
                     help="profile the round programs at construction; the reports land "
                     "in the summary")
    _add_telemetry_dir(run, "write the run's telemetry.jsonl (phase spans + round records "
                       "+ final metrics snapshot) here instead of the default <out-dir>; "
                       "read it back with `nanofed-tpu-torch metrics-summary`")
    _add_device(run)
    _add_later_flags(run, "run")

    serve = sub.add_parser("serve", help="host a network-mode federation server")
    serve.add_argument("--model", default="mnist_cnn")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8080)
    serve.add_argument("--rounds", type=int, default=2)
    serve.add_argument("--min-clients", type=int, default=None,
                       help="synchronous rounds: cohort size to wait for (default 1)")
    serve.add_argument("--completion-rate", type=float, default=None,
                       help="synchronous rounds: fraction of --min-clients required "
                       "(default 1.0)")
    serve.add_argument("--timeout", type=float, default=300.0)
    serve.add_argument("--seed", type=int, default=0)
    serve.add_argument("--secure", action="store_true",
                       help="secure-aggregation rounds (pairwise-masked updates)")
    serve.add_argument("--dropout-tolerant", action="store_true",
                       help="with --secure: double masking and Shamir recovery of dropped "
                       "clients' masks")
    serve.add_argument("--max-clients", type=int, default=None,
                       help="with --dropout-tolerant: cap the enrollment window")
    serve.add_argument("--validate", action="store_true",
                       help="validate every drained update (shape / finite / norm / "
                       "z-score)")
    serve.add_argument("--async-buffer", type=int, default=None, metavar="K",
                       help="FedBuff: aggregate whenever K updates are buffered")
    serve.add_argument("--staleness-window", type=int, default=None,
                       help="async mode only: accept updates on any of the last W "
                       "versions (default 4)")
    serve.add_argument("--max-norm", type=float, default=100.0,
                       help="per-leaf norm cap for --validate")
    serve.add_argument("--ingest-batch", type=int, default=None, metavar="K",
                       help="buffer plain submits on the device and reduce each drain in "
                       "one product (the port compiles nothing, so K only engages it)")
    serve.add_argument("--ingest-capacity", type=int, default=None, metavar="N",
                       help="with --ingest-batch: buffer rows (default 1024)")
    serve.add_argument("--decode-workers", type=int, default=None, metavar="N",
                       help="with --ingest-batch: decode pool size (default 4)")
    serve.add_argument("--evict-stragglers", type=int, default=0, metavar="K",
                       help="evict a client after K consecutive missed rounds; 0 = never")
    serve.add_argument("--state-dir", default=None, metavar="DIR",
                       help="checkpoint every completed round here and resume from it")
    _add_telemetry_dir(serve, "write this server run's telemetry.jsonl (round/phase spans "
                       "+ round records) here; live metrics are always scrapable at "
                       "GET /metrics")
    _add_device(serve)
    _add_later_flags(serve, "serve")

    profile = sub.add_parser(
        "profile",
        help="profile the round programs (single step, fused block, SCAFFOLD) without "
        "running a federation: counted FLOPs and bytes, peak device bytes, measured "
        "time, roofline verdict; --sweep runs the autotune sweep instead")
    profile.add_argument("--model", default="mnist_cnn")
    profile.add_argument("--clients", type=int, default=16)
    profile.add_argument("--epochs", type=int, default=1)
    profile.add_argument("--batch-size", type=int, default=64)
    profile.add_argument("--lr", type=float, default=0.1)
    profile.add_argument("--seed", type=int, default=0)
    profile.add_argument("--data-dir", default=None)
    profile.add_argument("--train-size", type=int, default=1024)
    profile.add_argument("--participation", type=float, default=1.0)
    profile.add_argument("--rounds-per-block", type=int, default=4,
                         help="also profile the fused R-round block (1 = single step only)")
    profile.add_argument("--client-chunk", type=int, default=None)
    profile.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    profile.add_argument("--no-scaffold", action="store_true",
                         help="skip the SCAFFOLD round program")
    profile.add_argument("--sweep", action="store_true",
                         help="run the autotune sweep: profile every candidate, print the "
                         "ranked table and the fused-epilogue comparison")
    profile.add_argument("--force-sweep", action="store_true",
                         help="with --sweep: ignore the cached sweep result")
    profile.add_argument("--json", action="store_true",
                         help="full report dicts as JSON instead of the table")
    _add_telemetry_dir(profile, "also append program_profile records (with --sweep: the "
                       "compile and autotune records) to a telemetry.jsonl here (read back "
                       "with `nanofed-tpu-torch metrics-summary`)")
    _add_device(profile)
    _add_later_flags(profile, "profile")

    bench = sub.add_parser("bench", help="run a named benchmark (BASELINE.json suite)")
    bench.add_argument("name", nargs="?", default="mnist_iid")
    bench.add_argument("--list", action="store_true", help="list benchmark names")
    bench.add_argument("--rounds", type=int, default=None)
    bench.add_argument("--train-size", type=int, default=None)
    bench.add_argument("--client-chunk", type=int, default=None)
    bench.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    bench.add_argument("--out-dir", default="runs/bench")
    _add_device(bench)

    summary = sub.add_parser(
        "metrics-summary",
        help="digest a run's telemetry.jsonl: per-phase durations, round outcomes, "
        "headline counters")
    summary.add_argument(
        "path", nargs="?", default="runs",
        help="a telemetry.jsonl, a run dir containing one, or a tree to search for the "
        "most recent one (default: runs)")

    trace = sub.add_parser(
        "trace",
        help="merge a run's per-host telemetry.jsonl streams into one clock-aligned "
        "timeline: per-round critical-path digest + trace resolution on stdout, "
        "optional Chrome/Perfetto trace file")
    trace.add_argument(
        "path", nargs="?", default="runs",
        help="a --telemetry-dir (per-host streams live in host_*/ subdirs; default: runs)")
    trace.add_argument(
        "--chrome-out", default=None, metavar="TRACE.json",
        help="also write the merged host-laned Chrome trace_event file here")
    trace.add_argument(
        "--trace-map", action="store_true",
        help="include the full submit-trace -> consuming-round map in the digest")

    for name, (text, item) in LATER_SUBCOMMANDS.items():
        sub.add_parser(name, help=f"{text} (not in nanofed_tpu_torch yet: ROADMAP queue "
                       f"A {item})")
    return parser


COMMANDS = {"info": _cmd_info, "run": _cmd_run, "bench": _cmd_bench,
            "profile": _cmd_profile, "serve": _cmd_serve,
            "metrics-summary": _cmd_metrics_summary, "trace": _cmd_trace}


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    # A later slice's subcommand is refused whatever arguments follow it.
    args, extra = parser.parse_known_args(argv)
    if args.cmd in LATER_SUBCOMMANDS:
        return _error(f"`{args.cmd}` is not supported by nanofed_tpu_torch yet: it comes "
                      f"with ROADMAP queue A {LATER_SUBCOMMANDS[args.cmd][1]} (run "
                      "nanofed-tpu for it)")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    refused = _refused_flags(args)
    if refused is not None:
        return refused
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
