"""Security (counterpart of ``nanofed_tpu/security/``): so far the in-round update
validation; signing and secure aggregation come with the network slice."""

from nanofed_tpu_torch.security.validation import (
    StackedLeafStats,
    ValidationConfig,
    ValidationReport,
    apply_validation_mask,
    loo_zscore,
    stacked_leaf_stats,
    validate_client_updates,
    validate_stats,
)

__all__ = [
    "StackedLeafStats",
    "ValidationConfig",
    "ValidationReport",
    "apply_validation_mask",
    "loo_zscore",
    "stacked_leaf_stats",
    "validate_client_updates",
    "validate_stats",
]
