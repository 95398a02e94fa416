"""The cohort completion gate and round-outcome accounting (counterpart of
``nanofed_tpu/orchestration/engine.py``).

:func:`completion_required` is the one gating expression; :class:`RoundLedger` is
where a round engine charges each round's outcome.  The JAX ledger feeds a metrics
registry and a telemetry file; those sinks come with the observability slice, so
this ledger keeps the same quantities as plain attributes.
"""

from __future__ import annotations

import math
import time
from collections import Counter


def completion_required(expected: int, min_completion_rate: float) -> int:
    """How many of ``expected`` participants must report for a round to COMPLETE:
    ``ceil(expected * rate)``, floored at one twice over."""
    return max(1, math.ceil(max(1, expected) * min_completion_rate))


class RoundLedger:
    """Round-outcome accounting: rounds by lowercased status, each round's duration and
    the last cohort size, as the JAX ledger's ``nanofed_rounds_total``,
    ``nanofed_round_duration_seconds`` and ``nanofed_cohort_size`` count them."""

    def __init__(self) -> None:
        self.rounds: Counter[str] = Counter()
        self.durations_s: list[float] = []
        self.cohort_size = 0

    def charge(self, *, status: str, num_clients: int, duration_s: float) -> None:
        """Charge one round outcome."""
        self.rounds[str(status).lower()] += 1
        self.durations_s.append(float(duration_s))
        self.cohort_size = int(num_clients)

    @staticmethod
    def now() -> float:
        """Round-duration timestamps: always the real ``perf_counter``."""
        return time.perf_counter()
