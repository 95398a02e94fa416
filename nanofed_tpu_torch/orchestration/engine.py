"""The cohort completion gate (counterpart of ``nanofed_tpu/orchestration/engine.py``;
its ``RoundLedger`` comes with the observability slice)."""

from __future__ import annotations

import math


def completion_required(expected: int, min_completion_rate: float) -> int:
    """How many of ``expected`` participants must report for a round to COMPLETE:
    ``ceil(expected * rate)``, floored at one twice over."""
    return max(1, math.ceil(max(1, expected) * min_completion_rate))
