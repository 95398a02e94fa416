"""Evidence harness for heterogeneous fleet federation (counterpart of
``nanofed_tpu/fleet/evidence.py``).

* :func:`generate_fleet_evidence` writes ``fleet_<tag>_*.json``: a 3-tier fleet
  (rank-4 topk8 phones, rank-8 q8 edge boxes, rank-32 f32 silos) trained in process
  with every submit crossing the real wire codecs and both aggregation routes (dense
  reference and padded einsum) held equal every round, against a homogeneous
  max-rank f32 baseline on the same population and arrivals; then the per-tier
  sub-swarms over live HTTP on a ``VirtualClock`` (per-tier latency, nothing lost).  It
  also writes the ``fleet`` telemetry record that ``metrics-summary`` folds into its
  ``fleets`` block.
* :func:`generate_fedbuff_staleness_ablation` writes ``fedbuff_staleness_<tag>.json``:
  the FedBuff staleness exponent swept over one event-driven replay of poisson
  arrivals and lognormal service times through ``DeviceIngestBuffer.drain_fedbuff``,
  everything but the exponent fixed by the seed.

Host numpy draws (data, cohorts, delays, codec seeds, revived directions) are the JAX
package's; local training is torch autograd on ``device``, so trajectories agree with
the JAX package's to a stated tolerance, not bit for bit.  ``base_params=`` starts a
run from given initial weights (the JAX package's, in the parity tests).  Run both with
``python -m nanofed_tpu_torch.fleet.evidence [--out-dir DIR] [--device cpu]``;
``device=None`` means the card.
"""

from __future__ import annotations

import asyncio
import dataclasses
import heapq
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.utils.logger import Logger

_LOG = Logger()

#: The in-process fleet's classifier: the JAX evidence's ``mlp`` shape.
MLP_SHAPE = dict(in_features=64, hidden=128, num_classes=10)


def _stamp() -> str:
    from nanofed_tpu_torch.utils.dates import get_current_time

    return get_current_time().strftime("%Y%m%dT%H%M%S")


def _max_abs_diff(a: Params, b: Params) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _env(dev: torch.device) -> dict[str, Any]:
    return {"torch": torch.__version__,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}


def homogenize(profile: Any, codec: str = "f32") -> Any:
    """The baseline mix: the same tiers, fractions, arrivals and availability, every
    tier at the profile's max rank on the ``codec`` wire."""
    from nanofed_tpu_torch.fleet.profile import FleetProfile

    tiers = tuple(
        dataclasses.replace(t, adapter_rank=profile.max_rank, codec=codec)
        for t in profile.tiers
    )
    return FleetProfile(name=f"{profile.name}_homogeneous", tiers=tiers)


def _mlp(seed: int, dev: torch.device, base_params: Params | None):
    from nanofed_tpu_torch.models import get_model

    model = get_model("mlp", **MLP_SHAPE)
    base = (model.init(torch.Generator().manual_seed(seed)) if base_params is None
            else base_params)
    return model, {name: leaf.detach().to(dev, torch.float32) for name, leaf in base.items()}


def _masked_nll(logp: torch.Tensor, y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    nll = -logp.gather(-1, y[:, None])[:, 0]
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _make_fit(model, spec, base: Params, local_steps: int, learning_rate: float):
    """``local_steps`` full-batch SGD steps on the adapters (the JAX ``lax.scan``)."""
    from nanofed_tpu_torch.adapters import make_adapter_apply

    apply = make_adapter_apply(model.apply, spec, base)

    def fit(adapters: Params, x: torch.Tensor, y: torch.Tensor, m: torch.Tensor) -> Params:
        ad = {k: v.detach().clone().requires_grad_(True) for k, v in adapters.items()}
        for _ in range(local_steps):
            grads = torch.autograd.grad(_masked_nll(apply(ad, x), y, m), list(ad.values()))
            ad = {k: (v - learning_rate * g).detach().requires_grad_(True)
                  for (k, v), g in zip(ad.items(), grads)}
        return {k: v.detach() for k, v in ad.items()}

    return fit


def _rows(data, i: int, dev: torch.device) -> tuple[torch.Tensor, ...]:
    return (torch.as_tensor(np.asarray(data.x[i]), device=dev),
            torch.as_tensor(np.asarray(data.y[i]), device=dev).long(),
            torch.as_tensor(np.asarray(data.mask[i]), device=dev))


def run_fleet_convergence(profile: Any, num_clients: int = 30, num_rounds: int = 20,
                          local_steps: int = 8, learning_rate: float = 0.5, seed: int = 0,
                          device: DeviceLike = None,
                          base_params: Params | None = None) -> dict[str, Any]:
    """One in-process fleet federation: every participant fetches its tier's view
    (the truncated-SVD projection of the global, dead directions revived), trains its
    tier-rank adapters, and submits through its tier's real codec; the server
    aggregates what the codec delivered, by both routes, and applies the padded one.
    ``parity_max_abs_diff`` is the largest gap between the routes over the rounds."""
    from nanofed_tpu_torch.data import federate, pack_eval, synthetic_classification
    from nanofed_tpu_torch.fleet.aggregate import AdapterUpdate, aggregate_dense, aggregate_padded
    from nanofed_tpu_torch.fleet.gateway import FleetGateway
    from nanofed_tpu_torch.fleet.wire import TierClientState, decode_tier_submit

    dev = resolve_device(device)
    model, base = _mlp(seed, dev, base_params)
    shape = (MLP_SHAPE["in_features"],)
    train = synthetic_classification(64 * num_clients, num_classes=MLP_SHAPE["num_classes"],
                                     shape=shape, seed=seed)
    test = synthetic_classification(1024, num_classes=MLP_SHAPE["num_classes"], shape=shape,
                                    seed=seed + 1)
    data = federate(train, num_clients=num_clients, batch_size=32, seed=seed)
    ex, ey, em = _rows(pack_eval(test, batch_size=256), slice(None), dev)

    gateway = FleetGateway(profile, base, revive_seed=seed, device=dev)
    split = profile.population_split(num_clients)
    ranges: dict[str, np.ndarray] = {}  # contiguous client ranges per tier, in order
    lo = 0
    for t in profile.tiers:
        ranges[t.name] = np.arange(lo, lo + split[t.name])
        lo += split[t.name]

    fits = {}
    for name, spec in gateway.specs.items():
        # The common alpha scales a tier's delta by alpha/rank and a gradient step moves
        # it by that factor squared: the local lr is normalised so every tier takes
        # comparable delta-space steps.
        scale = (spec.alpha if spec.alpha is not None else spec.rank) / spec.rank
        fits[name] = _make_fit(model, spec, base, local_steps, learning_rate / scale**2)

    rng = np.random.default_rng(seed)
    global_params = dict(base)
    states: dict[int, TierClientState] = {}
    wire_bytes = {t.name: 0 for t in profile.tiers}
    submit_counts = {t.name: 0 for t in profile.tiers}
    losses: list[float] = []
    parity_max = 0.0
    for r in range(num_rounds):
        gateway.publish(r, global_params)
        updates = []
        for tier in profile.tiers:
            view = gateway.view(tier.name, r)
            spec = gateway.spec(tier.name)
            pool = ranges[tier.name]
            k = max(1, int(round(len(pool) * tier.availability)))
            chosen = rng.choice(pool, size=min(k, len(pool)), replace=False)
            for ci in chosen:
                ci = int(ci)
                st = states.get(ci)
                if st is None:
                    st = states[ci] = TierClientState(tier, spec, view.tree)
                st.set_base(view.tree)
                start = {name: leaf.to(dev) for name, leaf in view.tree.items()}
                trained = fits[tier.name](start, *_rows(data, ci, dev))
                body = st.encode(trained, seed=seed + 7919 * r + ci)
                st.commit()
                wire_bytes[tier.name] += len(body)
                submit_counts[tier.name] += 1
                # The server sees what the codec delivered, not the raw tree.
                on_server = decode_tier_submit(tier, body, template=view.tree,
                                               published=view.tree)
                updates.append(AdapterUpdate(
                    spec=spec, adapters={k: v.to(dev) for k, v in on_server.items()},
                    weight=float(np.asarray(data.mask[ci]).sum()), tier=tier.name))
        dense_agg = aggregate_dense(updates, base)
        padded_agg = aggregate_padded(updates, base)
        parity_max = max(parity_max, _max_abs_diff(dense_agg, padded_agg))
        global_params = {name: base[name] + padded_agg[name] for name in base}
        with torch.no_grad():
            losses.append(round(float(_masked_nll(model.apply(global_params, ex), ey, em)), 4))
    total = int(sum(wire_bytes.values()))
    return {
        "profile": profile.name,
        "tiers": {
            t.name: {
                "rank": t.adapter_rank,
                "codec": t.codec,
                "clients": int(split[t.name]),
                "availability": t.availability,
                "submits": submit_counts[t.name],
                "wire_bytes": int(wire_bytes[t.name]),
                "bytes_per_submit": int(wire_bytes[t.name] / max(submit_counts[t.name], 1)),
            }
            for t in profile.tiers
        },
        "rounds": num_rounds,
        "losses": losses,
        "final_loss": losses[-1],
        "loss_descending": bool(losses[-1] < losses[0]),
        "wire_bytes_total": total,
        "parity_max_abs_diff": parity_max,
        "basis": (
            "in-process fleet FedAvg on synthetic_classification: per-tier "
            "truncated-SVD views, local SGD on tier-rank adapters, submits "
            "decoded from the REAL codec payloads (len() of those payloads "
            "is the wire accounting), dense and padded aggregation routes "
            "both computed every round"
        ),
    }


async def _swarm_leg(profile: Any, num_clients: int = 60, submits_per_client: int = 2,
                     seed: int = 0, device: DeviceLike = None) -> dict[str, Any]:
    """Per-tier sub-swarms against a live fleet server on a ``VirtualClock``: mixed
    codec payloads on one ``/update``, per-tier latency digests, per-tier rx/tx bytes
    from the server's own registry."""
    from nanofed_tpu_torch.communication.http_server import HTTPServer
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.fleet.gateway import FleetGateway
    from nanofed_tpu_torch.fleet.swarm import fleet_swarm_digest, run_fleet_swarm
    from nanofed_tpu_torch.ingest import IngestConfig
    from nanofed_tpu_torch.observability.registry import MetricsRegistry
    from nanofed_tpu_torch.utils.clock import VirtualClock

    dev = resolve_device(device)
    _, base = _mlp(seed, dev, None)
    clock = VirtualClock()
    registry = MetricsRegistry()
    gateway = FleetGateway(profile, base, revive_seed=seed, device=dev)
    port = free_port()
    server = HTTPServer(port=port, registry=registry, max_inflight=128, clock=clock,
                        ingest=IngestConfig(capacity=4 * num_clients, decode_workers=4),
                        fleet=gateway, device=dev)
    await server.start()
    try:
        await server.publish_model(params=base, round_number=0)
        tier_bases = {name: gateway.view(name).tree for name in profile.tier_names()}
        results = await run_fleet_swarm(
            f"http://127.0.0.1:{port}", profile, tier_bases, num_clients,
            submits_per_client=submits_per_client, seed=seed, clock=clock,
            registry=registry)
    finally:
        await server.stop()
    digest = fleet_swarm_digest(results, profile)
    fleet_bytes = registry.snapshot().get("nanofed_fleet_bytes_total", {}).get("values", {})
    digest["server_bytes_by_tier"] = {k: int(v) for k, v in sorted(fleet_bytes.items())}
    digest["clock"] = "virtual"
    digest["population"] = num_clients
    digest["submits_per_client"] = submits_per_client
    digest["basis"] = (
        "per-tier sub-swarms over live HTTP on the VirtualClock: latency "
        "digests from the swarm harness, byte counts from the server's "
        "nanofed_fleet_bytes_total counter (tier,direction)"
    )
    return digest


def generate_fleet_evidence(out_dir: str | Path = "runs", tag: str = "r16",
                            num_clients: int = 30, num_rounds: int = 20,
                            swarm_clients: int = 60, seed: int = 0,
                            device: DeviceLike = None) -> dict[str, Any]:
    """The headline fleet artifact (module note): writes
    ``<out_dir>/fleet_<tag>_<stamp>.json`` and a ``fleet`` telemetry record under
    ``<out_dir>/fleet_<tag>_telemetry``."""
    from nanofed_tpu_torch.fleet.profile import reference_fleet
    from nanofed_tpu_torch.observability.telemetry import RunTelemetry

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    profile = reference_fleet()
    run = dict(num_clients=num_clients, num_rounds=num_rounds, seed=seed, device=dev)
    _LOG.info("fleet evidence: mixed %s convergence ...", profile.name)
    mixed = run_fleet_convergence(profile, **run)
    _LOG.info("fleet evidence: homogeneous baseline convergence ...")
    baseline = run_fleet_convergence(homogenize(profile), **run)
    _LOG.info("fleet evidence: live-server swarm leg ...")
    swarm = asyncio.run(_swarm_leg(profile, num_clients=swarm_clients, seed=seed,
                                   device=dev))

    wire_ratio = round(baseline["wire_bytes_total"] / max(mixed["wire_bytes_total"], 1), 2)
    loss_gap = round(mixed["final_loss"] - baseline["final_loss"], 4)
    p99_by_tier = {name: rec["latency"].get("p99_s") for name, rec in swarm["tiers"].items()}
    # "comparable loss": within 25% relative or 0.05 absolute (the relative bound alone
    # means nothing once both runs sit near zero loss)
    comparable = mixed["final_loss"] <= max(baseline["final_loss"] * 1.25,
                                            baseline["final_loss"] + 0.05)
    reached = bool(
        len(profile.tiers) >= 3
        and mixed["loss_descending"]
        and baseline["loss_descending"]
        and mixed["parity_max_abs_diff"] < 1e-5
        and comparable
        and mixed["wire_bytes_total"] * 2 <= baseline["wire_bytes_total"]
        and swarm["failed_total"] == 0
    )
    artifact = {
        "record_type": "fleet",
        "tag": tag,
        "created": _stamp(),
        "env": {**_env(dev), "basis": (
            "trajectories, payload bytes and VirtualClock latencies are "
            "platform-independent")},
        "profile": profile.to_dict(),
        "mixed": mixed,
        "homogeneous_baseline": baseline,
        "comparison": {
            "wire_reduction_vs_homogeneous": wire_ratio,
            "final_loss_gap": loss_gap,
            "basis": (
                "identical population, arrival pattern, rounds, and seeds; "
                "only ranks and codecs differ"
            ),
        },
        "swarm": swarm,
        "reached": reached,
        "conclusion": (
            f"{len(profile.tiers)}-tier fleet (ranks "
            f"{[t.adapter_rank for t in profile.tiers]}, codecs "
            f"{[t.codec for t in profile.tiers]}): loss "
            f"{mixed['losses'][0]:.3f} -> {mixed['final_loss']:.3f} vs "
            f"homogeneous rank-{profile.max_rank} baseline "
            f"{baseline['final_loss']:.3f} at {wire_ratio}x fewer aggregate "
            f"wire bytes; dense/padded aggregation parity "
            f"{mixed['parity_max_abs_diff']:.2e}; live-server swarm: "
            f"{swarm['accepted_total']} accepted, {swarm['failed_total']} "
            "lost submits"
        ),
    }
    tel = RunTelemetry(out_dir / f"fleet_{tag}_telemetry")
    tel.record(
        "fleet",
        profile=profile.name,
        tiers=len(profile.tiers),
        population=num_clients,
        max_rank=profile.max_rank,
        rounds=num_rounds,
        accepted_total=swarm["accepted_total"],
        failed_total=swarm["failed_total"],
        rejected_429_total=swarm["rejected_429_total"],
        wire_bytes_by_tier={name: rec["wire_bytes"] for name, rec in mixed["tiers"].items()},
        p99_s_by_tier=p99_by_tier,
        parity_max_abs_diff=mixed["parity_max_abs_diff"],
    )
    tel.close()
    path = out_dir / f"fleet_{tag}_{_stamp()}.json"
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    artifact["artifact_path"] = str(path)
    _LOG.info("fleet evidence artifact: %s", path)
    return artifact


# ---------------------------------------------------------------------------
# FedBuff staleness-exponent ablation
# ---------------------------------------------------------------------------


def _fedbuff_sim(alpha: float, num_clients: int = 40, buffer_k: int = 8,
                 num_aggregations: int = 30, staleness_window: int = 10,
                 arrival_rate: float = 200.0, delay_sigma: float = 1.0,
                 adapter_rank: int = 8, local_steps: int = 8, learning_rate: float = 0.5,
                 seed: int = 7, device: DeviceLike = None,
                 base_params: Params | None = None) -> dict[str, Any]:
    """One asynchronous FedBuff federation at staleness exponent ``alpha``: an
    event-driven replay (poisson arrival gaps, lognormal service times, so slow
    clients submit stale deltas) through the ingest buffer's ``drain_fedbuff``.
    Everything but ``alpha`` is fixed by ``seed``."""
    from nanofed_tpu_torch.adapters import AdapterSpec, init_adapters, make_adapter_apply
    from nanofed_tpu_torch.data import federate, pack_eval, synthetic_classification
    from nanofed_tpu_torch.ingest.buffer import DeviceIngestBuffer
    from nanofed_tpu_torch.utils.trees import ravel, unravel

    dev = resolve_device(device)
    model, base = _mlp(seed, dev, base_params)
    spec = AdapterSpec(rank=adapter_rank)
    shape = (MLP_SHAPE["in_features"],)
    train = synthetic_classification(64 * num_clients, num_classes=MLP_SHAPE["num_classes"],
                                     shape=shape, seed=seed)
    test = synthetic_classification(1024, num_classes=MLP_SHAPE["num_classes"], shape=shape,
                                    seed=seed + 1)
    data = federate(train, num_clients=num_clients, batch_size=32, seed=seed)
    ex, ey, em = _rows(pack_eval(test, batch_size=256), slice(None), dev)
    fit = _make_fit(model, spec, base, local_steps, learning_rate)
    apply = make_adapter_apply(model.apply, spec, base)

    adapters0 = init_adapters(spec, base, rng=seed)
    buf = DeviceIngestBuffer(adapters0, capacity=4 * buffer_k, device=dev)
    published = {0: adapters0}  # published adapter trees by version (the live window)
    published_flat = {0: ravel(adapters0).cpu().numpy()}
    version = 0
    rng = np.random.default_rng(seed)
    # event queue: (completion_time, tiebreak, client, version_fetched)
    events: list[tuple[float, int, int, int]] = []
    tiebreak = 0
    now = 0.0
    for c in range(num_clients):
        now += rng.exponential(1.0 / arrival_rate)
        service = rng.lognormal(mean=0.0, sigma=delay_sigma) / arrival_rate
        heapq.heappush(events, (now + service, tiebreak, c, version))
        tiebreak += 1

    losses: list[float] = []
    staleness_all: list[int] = []
    skipped_total = 0
    while len(losses) < num_aggregations and events:
        t, _, client, v_fetched = heapq.heappop(events)
        if v_fetched in published:
            start = published[v_fetched]
            trained = fit(start, *_rows(data, client, dev))
            delta = (ravel(trained) - ravel(start)).cpu().numpy()
            buf.offer(delta, client_id=f"c{client}", round_number=v_fetched,
                      weight=float(np.asarray(data.mask[client]).sum()))
        # the client fetches the current version at once and goes again
        service = rng.lognormal(mean=0.0, sigma=delay_sigma) / arrival_rate
        gap = rng.exponential(1.0 / arrival_rate)
        heapq.heappush(events, (t + gap + service, tiebreak, client, version))
        tiebreak += 1

        if buf.fill >= buffer_k:
            window = range(max(0, version - staleness_window), version + 1)
            try:
                out, _, stats = buf.drain_fedbuff(buffer_k, version, window,
                                                  published_flat[version],
                                                  staleness_exponent=alpha)
            except ValueError:
                skipped_total += buffer_k
                continue
            staleness_all.extend(stats["staleness"])
            skipped_total += stats["num_skipped_out_of_window"]
            version += 1
            published_flat[version] = out.cpu().numpy()
            published[version] = {k: v.clone() for k, v in unravel(out, adapters0).items()}
            floor = version - staleness_window
            for old in [v for v in published if v < floor]:
                del published[old]
                del published_flat[old]
            with torch.no_grad():
                losses.append(round(float(_masked_nll(apply(published[version], ex),
                                                      ey, em)), 4))

    # a divergent run's losses go non-finite: None keeps the artifact strict JSON
    final = losses[-1] if losses else float("nan")
    diverged = bool(not losses or not np.isfinite(final) or final > 3 * losses[0])

    def fin(x: float) -> float | None:
        return round(float(x), 4) if np.isfinite(x) else None

    return {
        "staleness_exponent": alpha,
        "aggregations": len(losses),
        "final_loss": fin(final) if losses else None,
        "min_loss": fin(min(losses)) if losses else None,
        "losses": [fin(x) for x in losses],
        "mean_staleness": round(float(np.mean(staleness_all)), 3) if staleness_all else 0.0,
        "max_staleness": int(max(staleness_all)) if staleness_all else 0,
        "skipped_out_of_window": int(skipped_total),
        "diverged": diverged,
    }


def generate_fedbuff_staleness_ablation(out_dir: str | Path = "runs", tag: str = "r16",
                                        alphas: tuple[float, ...] = (0.0, 0.25, 0.5, 1.0,
                                                                     2.0),
                                        seed: int = 7, device: DeviceLike = None,
                                        **sim_kwargs: Any) -> dict[str, Any]:
    """The staleness exponent swept over one delay schedule (:func:`_fedbuff_sim`);
    writes ``<out_dir>/fedbuff_staleness_<tag>.json`` ranking the exponents by final
    loss."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sweep: dict[str, Any] = {}
    for alpha in alphas:
        _LOG.info("fedbuff staleness ablation: alpha=%s ...", alpha)
        sweep[str(alpha)] = _fedbuff_sim(alpha, seed=seed, device=dev, **sim_kwargs)
    ranked = sorted((rec["final_loss"], a) for a, rec in sweep.items() if not rec["diverged"])
    best_alpha = ranked[0][1] if ranked else None
    exercised = all(rec["mean_staleness"] > 0 for rec in sweep.values())
    spread = (round(max(r[0] for r in ranked) - min(r[0] for r in ranked), 4)
              if len(ranked) >= 2 else None)
    reached = bool(len(sweep) == len(alphas) and exercised and best_alpha is not None
                   and all(rec["aggregations"] > 0 for rec in sweep.values()))
    artifact = {
        "record_type": "fedbuff_staleness",
        "tag": tag,
        "created": _stamp(),
        "env": _env(dev),
        "scenario": {
            "reference": "runs/fedbuff_adapter_r15_*.json",
            "arrival": "poisson",
            "delay": "lognormal service times (sigma=1.0) — slow clients "
                     "submit stale deltas",
            "aggregator": "DeviceIngestBuffer.drain_fedbuff "
                          "(lr·(1+s)^-α/K, Nguyen et al. 2022)",
            "basis": (
                "event-driven replay: identical seeds, delays, cohort, and "
                "data across every α — the exponent is the only moving part"
            ),
        },
        "sweep": sweep,
        "best_alpha": best_alpha,
        "final_loss_spread": spread,
        "reached": reached,
        "conclusion": (
            "staleness-exponent ablation over the r15 FedBuff scenario: "
            + ", ".join(
                f"α={a} -> " + ("DIVERGED" if rec["diverged"] else f"{rec['final_loss']}")
                for a, rec in sweep.items()
            )
            + (
                f"; best α={best_alpha} (mean staleness "
                f"{sweep[str(alphas[0])]['mean_staleness']}, spread {spread})"
                if best_alpha is not None else "; every exponent diverged"
            )
        ),
    }
    path = out_dir / f"fedbuff_staleness_{tag}.json"
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    artifact["artifact_path"] = str(path)
    _LOG.info("fedbuff staleness artifact: %s", path)
    return artifact


def main(argv: list[str] | None = None) -> int:
    """Write both artifacts and print their verdicts; exit 1 unless both ``reached``."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m nanofed_tpu_torch.fleet.evidence")
    parser.add_argument("--out-dir", default="runs")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    fleet = generate_fleet_evidence(out_dir=args.out_dir, device=args.device)
    stale = generate_fedbuff_staleness_ablation(out_dir=args.out_dir, device=args.device)
    print(json.dumps({
        "fleet": {k: fleet[k] for k in ("reached", "conclusion", "artifact_path")},
        "fedbuff_staleness": {k: stale[k] for k in ("reached", "conclusion", "artifact_path")},
    }, indent=2))
    return 0 if (fleet["reached"] and stale["reached"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
