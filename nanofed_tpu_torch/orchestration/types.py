"""Round / progress value types (counterpart of ``nanofed_tpu/orchestration/types.py``)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


def cohort_size(num_clients: int, participation_rate: float) -> int:
    """Clients sampled per round: ceil(N * rate), floored at 1, capped at N."""
    return min(num_clients, max(1, math.ceil(num_clients * participation_rate)))


class RoundStatus(Enum):
    PENDING = "pending"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass(frozen=True)
class ClientInfo:
    """Host-side record of one simulated client."""

    client_id: str
    num_samples: int


@dataclass(frozen=True)
class RoundMetrics:
    """One round's outcome: id, status, participating clients, aggregated train
    metrics, eval metrics and wall-clock."""

    round_id: int
    status: RoundStatus
    num_clients: int
    agg_metrics: dict[str, float] = field(default_factory=dict)
    eval_metrics: dict[str, float] = field(default_factory=dict)
    duration_s: float = 0.0
    timestamp: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "round_id": self.round_id,
            "status": self.status.value,
            "num_clients": self.num_clients,
            "agg_metrics": self.agg_metrics,
            "eval_metrics": self.eval_metrics,
            "duration_s": self.duration_s,
            "timestamp": self.timestamp,
        }



@dataclass(frozen=True)
class TrainingProgress:
    """Live progress snapshot (``Coordinator.training_progress``)."""

    current_round: int
    total_rounds: int
    completed_rounds: int
    failed_rounds: int
    global_metrics: dict[str, float] = field(default_factory=dict)
