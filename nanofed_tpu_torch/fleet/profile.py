"""Fleet profiles: the tier mix as a first-class dimension of a federation run
(counterpart of ``nanofed_tpu/fleet/profile.py``).

A :class:`DeviceTier` declares what ONE device class trains and ships: the LoRA
``adapter_rank`` its compute budget affords (``nanofed_tpu_torch.adapters``), the wire
``codec`` its bandwidth affords (``topk8`` for the thin wire, ``q8`` for edge boxes,
full ``f32`` for silos; ``communication.codec``), and the ``batch_size`` and
``arrival``/``arrival_rate``/``availability`` process its duty cycle affords (the
``loadgen`` arrival machinery).

A :class:`FleetProfile` is a NAMED mix of tiers with per-tier population fractions,
validated at construction (fractions sum to 1, names unique, ranks positive), so the
fleet aggregator, the swarm, the autotuner and the scheduler read one vetted object.
``population_split`` turns a fraction mix into exact client counts deterministically
(largest remainder), so two processes splitting the same population agree.  The
validation messages, the split and the analytic wire sizing are the JAX package's,
number for number (pure Python and numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from nanofed_tpu_torch.core.exceptions import NanoFedError

__all__ = [
    "CODEC_ENCODINGS",
    "DeviceTier",
    "FleetProfile",
    "reference_fleet",
]

#: Tier codec name -> X-NanoFed-Encoding wire value (``communication.codec``).
#: ``f32`` ships the full federated tree as plain npz; ``q8``/``topk8`` ship
#: the factor-space delta through the quantized codecs.
CODEC_ENCODINGS: dict[str, str] = {
    "f32": "npz",
    "q8": "q8-delta",
    "topk8": "topk8-delta",
}


@dataclass(frozen=True)
class DeviceTier:
    """One device class's training/wire/arrival shape (see module doc).

    ``fraction`` is this tier's share of the fleet population (all tiers in a
    profile sum to 1).  ``availability`` is the per-round participation
    probability — a phone tier at 0.3 contributes ~30% of its population per
    round, a silo at 1.0 shows up every round.  ``topk_fraction`` only applies
    to the ``topk8`` codec (kept coordinates per leaf).  ``weight_skew`` is
    the lognormal sigma over reported sample counts (the loadgen knob)."""

    name: str
    fraction: float
    adapter_rank: int = 8
    codec: str = "q8"
    batch_size: int = 16
    arrival: str = "poisson"
    arrival_rate: float = 100.0
    availability: float = 1.0
    local_steps: int = 1
    weight_skew: float = 0.0
    topk_fraction: float = 0.05

    def __post_init__(self) -> None:
        if not self.name or "/" in self.name:
            raise NanoFedError(f"tier name must be non-empty, '/'-free: {self.name!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise NanoFedError(
                f"tier {self.name!r}: fraction must be in (0, 1], got {self.fraction}"
            )
        if self.adapter_rank < 1:
            raise NanoFedError(
                f"tier {self.name!r}: adapter_rank must be >= 1, got {self.adapter_rank}"
            )
        if self.codec not in CODEC_ENCODINGS:
            raise NanoFedError(
                f"tier {self.name!r}: unknown codec {self.codec!r} "
                f"(one of {sorted(CODEC_ENCODINGS)})"
            )
        if self.batch_size < 1:
            raise NanoFedError(f"tier {self.name!r}: batch_size must be >= 1")
        if self.arrival not in ("poisson", "uniform", "burst"):
            raise NanoFedError(
                f"tier {self.name!r}: unknown arrival process {self.arrival!r}"
            )
        if self.arrival_rate <= 0:
            raise NanoFedError(f"tier {self.name!r}: arrival_rate must be > 0")
        if not 0.0 < self.availability <= 1.0:
            raise NanoFedError(
                f"tier {self.name!r}: availability must be in (0, 1], "
                f"got {self.availability}"
            )
        if self.local_steps < 1:
            raise NanoFedError(f"tier {self.name!r}: local_steps must be >= 1")
        if not 0.0 < self.topk_fraction <= 1.0:
            raise NanoFedError(
                f"tier {self.name!r}: topk_fraction must be in (0, 1]"
            )

    @property
    def encoding(self) -> str:
        """The X-NanoFed-Encoding wire value this tier's submits carry."""
        return CODEC_ENCODINGS[self.codec]

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "fraction": self.fraction,
            "adapter_rank": self.adapter_rank,
            "codec": self.codec,
            "batch_size": self.batch_size,
            "arrival": self.arrival,
            "arrival_rate": self.arrival_rate,
            "availability": self.availability,
            "local_steps": self.local_steps,
            "weight_skew": self.weight_skew,
            "topk_fraction": self.topk_fraction,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DeviceTier":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass(frozen=True)
class FleetProfile:
    """A named tier mix, validated at construction (see module doc)."""

    name: str
    tiers: tuple[DeviceTier, ...] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        if not self.name:
            raise NanoFedError("fleet profile needs a name")
        if not self.tiers:
            raise NanoFedError(f"fleet profile {self.name!r} needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise NanoFedError(
                f"fleet profile {self.name!r}: duplicate tier names in {names}"
            )
        total = sum(t.fraction for t in self.tiers)
        if abs(total - 1.0) > 1e-6:
            raise NanoFedError(
                f"fleet profile {self.name!r}: tier fractions sum to {total:.6f}, "
                "must sum to 1"
            )

    # -- lookups -----------------------------------------------------------

    def tier(self, name: str) -> DeviceTier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise NanoFedError(
            f"fleet profile {self.name!r} has no tier {name!r} "
            f"(tiers: {[t.name for t in self.tiers]})"
        )

    def tier_names(self) -> list[str]:
        return [t.name for t in self.tiers]

    @property
    def max_rank(self) -> int:
        """The largest tier rank — what sizes the padded aggregation buckets
        and the scheduler's device-memory footprint."""
        return max(t.adapter_rank for t in self.tiers)

    @property
    def max_rank_tier(self) -> DeviceTier:
        return max(self.tiers, key=lambda t: t.adapter_rank)

    # -- derived shapes ----------------------------------------------------

    def population_split(self, num_clients: int) -> dict[str, int]:
        """Exact per-tier client counts for a population of ``num_clients``:
        largest-remainder apportionment (deterministic, order-stable), every
        tier gets at least one client when the population allows."""
        if num_clients < len(self.tiers):
            raise NanoFedError(
                f"population {num_clients} smaller than the tier count "
                f"{len(self.tiers)} of profile {self.name!r}"
            )
        exact = {t.name: num_clients * t.fraction for t in self.tiers}
        counts = {name: int(np.floor(v)) for name, v in exact.items()}
        # Give starved tiers their guaranteed seat before remainder ordering.
        for name in counts:
            if counts[name] == 0:
                counts[name] = 1
        leftover = num_clients - sum(counts.values())
        remainders = sorted(
            counts, key=lambda n: (-(exact[n] - int(np.floor(exact[n]))), n)
        )
        i = 0
        while leftover != 0:
            name = remainders[i % len(remainders)]
            if leftover > 0:
                counts[name] += 1
                leftover -= 1
            elif counts[name] > 1:  # never starve a tier back to zero
                counts[name] -= 1
                leftover += 1
            i += 1
        return counts

    def specs(self, **spec_kwargs: Any) -> dict[str, Any]:
        """Per-tier :class:`~nanofed_tpu_torch.adapters.AdapterSpec` at each tier's
        rank (extra kwargs — targets, alpha, min_dim — shared across tiers).
        ``alpha`` defaults to the profile's max rank so every tier's effective
        delta scale ``alpha/rank`` is computed on a COMMON alpha: padding a
        tier's factors into the max-rank bucket then needs only a scalar
        rescale (see ``fleet.aggregate.pad_adapters_to_rank``)."""
        from nanofed_tpu_torch.adapters import AdapterSpec

        spec_kwargs.setdefault("alpha", float(self.max_rank))
        return {
            t.name: AdapterSpec(rank=t.adapter_rank, **spec_kwargs)
            for t in self.tiers
        }

    def wire_bytes_per_round(
        self, base_like: Any, num_clients: int
    ) -> dict[str, Any]:
        """ANALYTIC per-round client->server wire bytes by tier: adapter
        parameter count at the tier's rank x the codec's bytes/parameter
        (f32: 4, q8: ~1 + scale overhead, topk8: ~5 x kept fraction — int8
        value + uint32 index per kept coordinate) x expected participants.
        The sizing guide only — evidence artifacts measure the real payloads
        through the codecs (``fleet.evidence``)."""
        from nanofed_tpu_torch.adapters import AdapterSpec, adapter_param_count

        split = self.population_split(num_clients)
        out: dict[str, Any] = {}
        total = 0.0
        for t in self.tiers:
            counts = adapter_param_count(AdapterSpec(rank=t.adapter_rank), base_like)
            p = counts["adapter_params"]
            per_update = {
                "f32": 4.0 * p,
                "q8": 1.0 * p,
                "topk8": 5.0 * t.topk_fraction * p,
            }[t.codec]
            participants = split[t.name] * t.availability
            tier_total = per_update * participants
            out[t.name] = {
                "clients": split[t.name],
                "expected_participants_per_round": round(participants, 2),
                "adapter_params": p,
                "bytes_per_update": int(per_update),
                "bytes_per_round": int(tier_total),
            }
            total += tier_total
        out["total_bytes_per_round"] = int(total)
        out["basis"] = (
            "analytic pre-deflate sizing: params(rank) x codec bytes/param x "
            "expected participants; measured payloads live in fleet.evidence"
        )
        return out

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "tiers": [t.to_dict() for t in self.tiers]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetProfile":
        return cls(
            name=str(d["name"]),
            tiers=tuple(DeviceTier.from_dict(t) for t in d["tiers"]),
        )


def reference_fleet(
    name: str = "phone_edge_silo",
    phone_rank: int = 4,
    edge_rank: int = 8,
    silo_rank: int = 32,
) -> FleetProfile:
    """The canonical 3-tier mix the evidence artifacts and smoke tests use:
    a thin-wire phone majority (topk8, low availability, bursty poisson), an
    edge-box middle (q8), and a small always-on datacenter-silo tail (full
    f32).  Fractions follow the cross-device shape the communication survey
    describes: population mass at the thin edge, byte mass at the silos."""
    return FleetProfile(
        name=name,
        tiers=(
            DeviceTier(
                name="phone", fraction=0.70, adapter_rank=phone_rank,
                codec="topk8", batch_size=8, arrival="poisson",
                arrival_rate=200.0, availability=0.4, weight_skew=1.0,
            ),
            DeviceTier(
                name="edge", fraction=0.25, adapter_rank=edge_rank,
                codec="q8", batch_size=16, arrival="uniform",
                arrival_rate=60.0, availability=0.8, weight_skew=0.5,
            ),
            DeviceTier(
                name="silo", fraction=0.05, adapter_rank=silo_rank,
                codec="f32", batch_size=64, arrival="burst",
                arrival_rate=10.0, availability=1.0,
            ),
        ),
    )
