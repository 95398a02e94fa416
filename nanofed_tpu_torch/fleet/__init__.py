"""Heterogeneous fleet federation: tiered devices, tiered ranks, tiered wires
(counterpart of ``nanofed_tpu/fleet``).

``fleet.profile`` declares the tier mix (:class:`DeviceTier`, :class:`FleetProfile`);
``fleet.aggregate`` aggregates adapters of different ranks into one dense update (the
dense reference route, the equal padded route, truncated-SVD redistribution);
``fleet.wire`` owns the per-tier codec paths and the topk8 error-feedback client
state; ``fleet.gateway`` is the server edge (per-tier views, submit rows for the ingest
buffer, on the card by default); ``fleet.swarm`` drives per-tier sub-swarms on one
clock; ``fleet.tuning`` sweeps the mix; ``fleet.evidence`` writes the artifacts.
Served by ``HTTPServer(fleet=)``.
"""


from nanofed_tpu_torch.fleet.aggregate import (
    AdapterUpdate,
    aggregate_dense,
    aggregate_padded,
    pad_adapters_to_rank,
    project_to_rank,
    projection_error,
    redistribute,
    revive_adapters,
)
from nanofed_tpu_torch.fleet.gateway import FleetGateway, TierView
from nanofed_tpu_torch.fleet.profile import (
    CODEC_ENCODINGS,
    DeviceTier,
    FleetProfile,
    reference_fleet,
)
from nanofed_tpu_torch.fleet.swarm import (
    fleet_swarm_digest,
    run_fleet_swarm,
    tier_swarm_configs,
)
from nanofed_tpu_torch.fleet.tuning import (
    FleetMixCandidate,
    FleetMixOutcome,
    mix_candidates,
    profile_with_ranks,
    sweep_fleet_mix,
)
from nanofed_tpu_torch.fleet.wire import TierClientState, decode_tier_submit

__all__ = [
    "AdapterUpdate",
    "CODEC_ENCODINGS",
    "DeviceTier",
    "FleetGateway",
    "FleetMixCandidate",
    "FleetMixOutcome",
    "FleetProfile",
    "TierClientState",
    "TierView",
    "aggregate_dense",
    "aggregate_padded",
    "decode_tier_submit",
    "fleet_swarm_digest",
    "mix_candidates",
    "pad_adapters_to_rank",
    "profile_with_ranks",
    "project_to_rank",
    "projection_error",
    "redistribute",
    "reference_fleet",
    "revive_adapters",
    "run_fleet_swarm",
    "sweep_fleet_mix",
    "tier_swarm_configs",
]
