from nanofed_tpu_torch.aggregation.base import (
    AggregationResult,
    ServerAdam,
    ServerSGD,
    Strategy,
    fedadam_strategy,
    fedavg_strategy,
    fedavgm_strategy,
    fedyogi_strategy,
    validate_updates,
)
from nanofed_tpu_torch.aggregation.fedavg import (
    aggregate_metrics,
    compute_weights,
    fedavg_combine,
)
from nanofed_tpu_torch.aggregation.privacy import (
    PrivacyAwareAggregationConfig,
    apply_central_privacy,
    central_mechanism,
    epsilon_adjusted_weights,
    record_central_privacy,
    validate_private_round,
)
from nanofed_tpu_torch.aggregation.robust import (
    RobustAggregationConfig,
    coordinate_median,
    multi_krum,
    robust_aggregate,
    robust_floor,
    trimmed_mean,
)

__all__ = [
    "AggregationResult",
    "PrivacyAwareAggregationConfig",
    "RobustAggregationConfig",
    "ServerAdam",
    "ServerSGD",
    "Strategy",
    "aggregate_metrics",
    "apply_central_privacy",
    "central_mechanism",
    "compute_weights",
    "coordinate_median",
    "epsilon_adjusted_weights",
    "fedadam_strategy",
    "fedavg_combine",
    "fedavg_strategy",
    "fedavgm_strategy",
    "fedyogi_strategy",
    "multi_krum",
    "record_central_privacy",
    "robust_aggregate",
    "robust_floor",
    "trimmed_mean",
    "validate_private_round",
    "validate_updates",
]
