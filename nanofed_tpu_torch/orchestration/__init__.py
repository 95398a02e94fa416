from nanofed_tpu_torch.orchestration.coordinator import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.orchestration.engine import RoundLedger, completion_required
from nanofed_tpu_torch.orchestration.types import (
    ClientInfo,
    RoundMetrics,
    RoundStatus,
    TrainingProgress,
    cohort_size,
)

__all__ = [
    "ClientInfo",
    "Coordinator",
    "CoordinatorConfig",
    "RoundLedger",
    "RoundMetrics",
    "RoundStatus",
    "TrainingProgress",
    "cohort_size",
    "completion_required",
]
