from nanofed_tpu_torch.orchestration.coordinator import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.orchestration.engine import RoundLedger, completion_required
from nanofed_tpu_torch.orchestration.types import (
    RoundMetrics,
    RoundStatus,
    cohort_size,
)

__all__ = [
    "Coordinator",
    "CoordinatorConfig",
    "RoundLedger",
    "RoundMetrics",
    "RoundStatus",
    "cohort_size",
    "completion_required",
]
