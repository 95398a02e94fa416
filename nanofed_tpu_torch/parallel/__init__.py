from nanofed_tpu_torch.parallel.multi_round import (
    RoundBlockResult,
    build_round_block,
    round_seeds,
)
from nanofed_tpu_torch.parallel.resilience import (
    CollectiveWatchdog,
    Heartbeat,
    HostFailure,
    HostMonitor,
    HostState,
    no_orphans,
    resilience_metrics,
)
from nanofed_tpu_torch.parallel.round_step import (
    FrozenBase,
    RoundStepResult,
    apply_server_update,
    build_round_step,
    client_deltas,
    init_server_state,
)
from nanofed_tpu_torch.parallel.scaffold_step import (
    ScaffoldStepResult,
    build_scaffold_round_step,
)

__all__ = [
    "CollectiveWatchdog",
    "FrozenBase",
    "Heartbeat",
    "HostFailure",
    "HostMonitor",
    "HostState",
    "RoundBlockResult",
    "RoundStepResult",
    "ScaffoldStepResult",
    "apply_server_update",
    "build_round_block",
    "build_round_step",
    "build_scaffold_round_step",
    "client_deltas",
    "init_server_state",
    "no_orphans",
    "resilience_metrics",
    "round_seeds",
]
