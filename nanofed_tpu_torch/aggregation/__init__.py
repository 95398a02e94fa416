from nanofed_tpu_torch.aggregation.base import (
    ServerAdam,
    ServerSGD,
    Strategy,
    fedadam_strategy,
    fedavg_strategy,
    fedavgm_strategy,
    fedyogi_strategy,
)
from nanofed_tpu_torch.aggregation.fedavg import (
    aggregate_metrics,
    compute_weights,
    fedavg_combine,
)

__all__ = [
    "ServerAdam",
    "ServerSGD",
    "Strategy",
    "aggregate_metrics",
    "compute_weights",
    "fedadam_strategy",
    "fedavg_combine",
    "fedavg_strategy",
    "fedavgm_strategy",
    "fedyogi_strategy",
]
