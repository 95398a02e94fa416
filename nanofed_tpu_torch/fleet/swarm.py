"""Fleet load generation: per-tier sub-swarms on one clock, one server (counterpart of
``nanofed_tpu/fleet/swarm.py``).

A homogeneous swarm (``loadgen.swarm``) is one arrival process over one body pool.  A
fleet is several at once: the phone tier's bursty poisson trickle of small topk8 bodies
lands on the same ``/update`` endpoint as the silo tier's burst of full f32 trees, and
per-tier decode routing, admission under mixed body sizes and ingest backpressure
show only when the sub-swarms interleave.  :func:`run_fleet_swarm` builds one
``SwarmConfig`` per tier from the profile (population by ``population_split`` times
availability, arrival and skew from the tier, codec-correct canned bodies against the
tier's published view, the ``tier`` header stamped) and drives them concurrently on one
injected clock, so a mixed schedule runs on a ``VirtualClock`` like the single-tier
smokes.  The configs and the digest are the JAX package's.
"""

from __future__ import annotations

import asyncio
from typing import Any

from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.fleet.profile import FleetProfile
from nanofed_tpu_torch.loadgen.swarm import (
    SwarmConfig,
    SwarmResult,
    latency_digest,
    run_swarm,
)
from nanofed_tpu_torch.utils.clock import Clock

__all__ = ["fleet_swarm_digest", "run_fleet_swarm", "tier_swarm_configs"]


def tier_swarm_configs(
    profile: FleetProfile,
    num_clients: int,
    submits_per_client: int = 1,
    seed: int = 0,
    delta_scale: float = 1e-3,
    apply_availability: bool = True,
    **overrides: Any,
) -> dict[str, SwarmConfig]:
    """One ``SwarmConfig`` per tier: population from the profile's
    largest-remainder split (scaled by availability — the clients who actually
    show up this round), arrival/skew/codec from the tier, disjoint client-id
    spaces, per-tier seeds.  ``overrides`` pass through to every tier's config
    (retry policy, connector limit, ...)."""
    split = profile.population_split(num_clients)
    configs: dict[str, SwarmConfig] = {}
    for i, tier in enumerate(profile.tiers):
        participants = split[tier.name]
        if apply_availability:
            participants = max(1, int(round(participants * tier.availability)))
        configs[tier.name] = SwarmConfig(
            num_clients=participants,
            submits_per_client=submits_per_client,
            arrival=tier.arrival,
            arrival_rate=tier.arrival_rate,
            weight_skew=tier.weight_skew,
            delta_scale=delta_scale,
            seed=seed + 101 * i,
            encoding=tier.encoding,
            topk_fraction=tier.topk_fraction,
            tier=tier.name,
            client_prefix=f"fleet_{tier.name}",
            **overrides,
        )
    return configs


async def run_fleet_swarm(
    server_url: str,
    profile: FleetProfile,
    tier_bases: dict[str, Params],
    num_clients: int,
    submits_per_client: int = 1,
    seed: int = 0,
    clock: Clock | None = None,
    registry: Any | None = None,
    **overrides: Any,
) -> dict[str, SwarmResult]:
    """Drive every tier's sub-swarm concurrently against one live server.

    ``tier_bases`` maps tier name -> the tier's PUBLISHED adapter tree (a
    fleet server's ``FleetGateway.view(tier).tree``): the f32 tier's canned
    bodies are noisy variants of it, the delta tiers' bodies are noise deltas
    the server reconstructs against it.  Returns per-tier raw results —
    :func:`fleet_swarm_digest` folds them into the artifact block."""
    missing = [t for t in profile.tier_names() if t not in tier_bases]
    if missing:
        raise NanoFedError(f"tier_bases missing entries for tiers: {missing}")
    configs = tier_swarm_configs(
        profile, num_clients, submits_per_client=submits_per_client,
        seed=seed, **overrides,
    )
    names = list(configs)
    results = await asyncio.gather(*(
        run_swarm(
            server_url, tier_bases[name], configs[name],
            clock=clock, registry=registry,
        )
        for name in names
    ))
    return dict(zip(names, results))


def fleet_swarm_digest(
    results: dict[str, SwarmResult], profile: FleetProfile
) -> dict[str, Any]:
    """Per-tier submit outcome + latency digest, plus fleet-wide totals — the
    shape the fleet telemetry record and the runs/ artifact carry."""
    out: dict[str, Any] = {"tiers": {}, "profile": profile.name}
    tot_accepted = tot_failed = tot_429 = 0
    for name, r in results.items():
        tier = profile.tier(name)
        out["tiers"][name] = {
            "codec": tier.codec,
            "rank": tier.adapter_rank,
            "logical_submits": (
                r.accepted + r.duplicates + r.failed + r.terminated_early
            ),
            "accepted": r.accepted,
            "duplicates": r.duplicates,
            "rejected_429": r.rejected_429,
            "retries": r.retries,
            "stale_refreshes": r.stale_refreshes,
            "failed": r.failed,
            "terminated_early": r.terminated_early,
            "latency": latency_digest(r.latencies_s),
        }
        tot_accepted += r.accepted
        tot_failed += r.failed
        tot_429 += r.rejected_429
    out["accepted_total"] = tot_accepted
    out["failed_total"] = tot_failed
    out["rejected_429_total"] = tot_429
    return out
