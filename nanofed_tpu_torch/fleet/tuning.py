"""Fleet-mix tuning: sweep per-tier ranks analytically, price ranks once (counterpart
of ``nanofed_tpu/fleet/tuning.py``).

A fleet has a rank per tier, so a profiled sweep of every mix is exponential in tiers
and unnecessary: for a fixed mix (fractions and codecs do not move in a rank sweep) the
two things a candidate changes are analytic.  Wire bytes a round follow from parameter
counts, codec bytes and expected participants (``FleetProfile.wire_bytes_per_round``),
and device-memory feasibility from the max-rank tier (``TenantFootprint.for_fleet``).

* :func:`mix_candidates`: the cross product of per-tier ``{r/2, r, 2r}`` ladders;
* :func:`sweep_fleet_mix`: every candidate scored without running anything, filtered
  by the device-memory budget and ranked by wire bytes per unit of fleet capacity
  (the availability-weighted mean rank); ties fall back to the candidate key.

Per-rank step costs come from ``TuningSpace.for_fleet``, the union of the ladders
profiled once each (linear in distinct ranks); ``step_costs=`` annotates the ranking
with them and does not change it.  The budget resolves through
``tuning.autotuner.resolve_hbm_budget`` (explicit, the environment variable, the
card's ``total_memory``, unbounded on the CPU); the scores are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Mapping

from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.device import DeviceLike
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.fleet.profile import FleetProfile

__all__ = [
    "FleetMixCandidate",
    "FleetMixOutcome",
    "mix_candidates",
    "profile_with_ranks",
    "sweep_fleet_mix",
]


def _ladder(rank: int) -> tuple[int, ...]:
    """The homogeneous autotuner's rank ladder, per tier."""
    return tuple(sorted({max(1, rank // 2), rank, 2 * rank}))


@dataclass(frozen=True, order=True)
class FleetMixCandidate:
    """One per-tier rank assignment, tiers in profile order.  Ordered, so the
    dataclass ordering is the deterministic last-resort tie-break."""

    ranks: tuple[tuple[str, int], ...]  # ((tier_name, rank), ...)

    def rank_for(self, tier_name: str) -> int:
        for name, r in self.ranks:
            if name == tier_name:
                return r
        raise NanoFedError(f"mix candidate has no tier {tier_name!r}")

    def to_dict(self) -> dict[str, int]:
        return dict(self.ranks)


def mix_candidates(profile: FleetProfile) -> list[FleetMixCandidate]:
    """Cross product of every tier's ladder — ``3^tiers`` candidates minus
    ladder collisions, each a full per-tier rank assignment."""
    names = profile.tier_names()
    ladders = [_ladder(profile.tier(n).adapter_rank) for n in names]
    return [
        FleetMixCandidate(ranks=tuple(zip(names, combo)))
        for combo in itertools.product(*ladders)
    ]


def profile_with_ranks(
    profile: FleetProfile, candidate: FleetMixCandidate
) -> FleetProfile:
    """The profile re-ranked to the candidate (fractions, codecs, arrivals
    untouched — the mix is fixed, only ranks move)."""
    tiers = tuple(
        dataclasses.replace(t, adapter_rank=candidate.rank_for(t.name))
        for t in profile.tiers
    )
    return dataclasses.replace(profile, tiers=tiers)


@dataclass
class FleetMixOutcome:
    """One candidate's analytic fate: wire/memory numbers, feasibility, and
    the score the ranking sorts by (lower is better)."""

    candidate: FleetMixCandidate
    feasible: bool
    reject_reason: str | None = None
    wire_bytes_per_round: int = 0
    capacity: float = 0.0  # availability-weighted mean rank
    hbm_resident_bytes: int = 0
    hbm_peak_bytes: int = 0
    score: float | None = None
    step_cost_s: float | None = None  # from measured per-rank costs, if given
    detail: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "ranks": self.candidate.to_dict(),
            "feasible": self.feasible,
            **({"reject_reason": self.reject_reason}
               if self.reject_reason else {}),
            "wire_bytes_per_round": self.wire_bytes_per_round,
            "capacity": round(self.capacity, 3),
            "hbm_resident_bytes": self.hbm_resident_bytes,
            "hbm_peak_bytes": self.hbm_peak_bytes,
            **({"score": round(self.score, 2)} if self.score is not None else {}),
            **({"step_cost_s": self.step_cost_s}
               if self.step_cost_s is not None else {}),
        }


def sweep_fleet_mix(
    profile: FleetProfile,
    base_like: Params,
    num_clients: int,
    hbm_budget_bytes: int | None = None,
    ingest_capacity: int = 64,
    agg_k: int = 8,
    step_costs: Mapping[int, float] | None = None,
    device: DeviceLike = None,
) -> list[FleetMixOutcome]:
    """Score every mix candidate analytically; returns outcomes sorted best
    first (feasible before infeasible, then ascending score, then candidate
    order).  Score = wire bytes per round / fleet capacity — bytes paid per
    unit of availability-weighted rank, so a candidate that halves the
    phone tier's rank only wins if the byte saving beats the capacity loss.
    ``step_costs`` (rank -> measured seconds, from the profiled
    ``TuningSpace.for_fleet`` sweep) annotates each outcome with the max-rank
    tier's measured step cost; it does not change the ranking — wall-clock
    feasibility is the profiled sweep's verdict, not this one's.  The budget is
    ``resolve_hbm_budget(hbm_budget_bytes, device)``: ``device=None`` means the card
    (its ``total_memory``); on the CPU nothing is rejected, as with the JAX
    package's ``hbm_budget_bytes=None``."""
    from nanofed_tpu_torch.service.scheduler import TenantFootprint
    from nanofed_tpu_torch.tuning.autotuner import resolve_hbm_budget

    hbm_budget_bytes, _ = resolve_hbm_budget(hbm_budget_bytes, device=device)
    outcomes: list[FleetMixOutcome] = []

    for cand in mix_candidates(profile):
        p = profile_with_ranks(profile, cand)
        wire = p.wire_bytes_per_round(base_like, num_clients)
        capacity = sum(
            t.fraction * t.availability * t.adapter_rank for t in p.tiers
        )
        fp = TenantFootprint.for_fleet(
            p, base_like, ingest_capacity=ingest_capacity, agg_k=agg_k
        )
        out = FleetMixOutcome(
            candidate=cand,
            feasible=True,
            wire_bytes_per_round=int(wire["total_bytes_per_round"]),
            capacity=capacity,
            hbm_resident_bytes=fp.resident_bytes,
            hbm_peak_bytes=fp.peak_extra_bytes,
            detail={"wire": wire, "footprint_basis": fp.basis},
        )
        if step_costs is not None:
            out.step_cost_s = step_costs.get(p.max_rank)
        if (
            hbm_budget_bytes is not None
            and fp.resident_bytes + fp.peak_extra_bytes > hbm_budget_bytes
        ):
            out.feasible = False
            out.reject_reason = (
                f"hbm: resident {fp.resident_bytes} + peak "
                f"{fp.peak_extra_bytes} > budget {hbm_budget_bytes}"
            )
        else:
            out.score = out.wire_bytes_per_round / max(capacity, 1e-9)
        outcomes.append(out)
    outcomes.sort(
        key=lambda o: (
            not o.feasible,
            o.score if o.score is not None else float("inf"),
            o.candidate,
        )
    )
    return outcomes
