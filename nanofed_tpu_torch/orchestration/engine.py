"""The cohort completion gate and round-outcome accounting (counterpart of
``nanofed_tpu/orchestration/engine.py``).

:func:`completion_required` is the one gating expression; :class:`RoundLedger` is
where every round engine (the simulated coordinator's single rounds and fused blocks,
the network coordinator's sync rounds and FedBuff aggregations) charges each round's
outcome: the JAX package's instruments on the front's metrics registry, the ``round``
telemetry record, and the same quantities as plain attributes (``rounds``,
``durations_s``, ``cohort_size``).
"""

from __future__ import annotations

import math
import time
from collections import Counter
from typing import Any

from nanofed_tpu_torch.observability.registry import MetricsRegistry

__all__ = ["RoundLedger", "completion_required"]


def completion_required(expected: int, min_completion_rate: float) -> int:
    """How many of ``expected`` participants must report for a round to COMPLETE:
    ``ceil(expected * rate)``, floored at one twice over."""
    return max(1, math.ceil(max(1, expected) * min_completion_rate))


class RoundLedger:
    """Round-outcome accounting shared by every round engine front.

    Owns the JAX package's instruments — ``nanofed_rounds_total{status}``,
    ``nanofed_round_duration_seconds``, ``nanofed_cohort_size``, with
    ``track_dropouts`` ``nanofed_dropouts_total``, and
    ``nanofed_round_critical_path_seconds{segment}`` — created once against the
    front's ``registry`` with the JAX names and help strings, and the ``round``
    telemetry record.  One :meth:`charge` per round outcome."""

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        telemetry: Any | None = None,
        track_dropouts: bool = False,
    ) -> None:
        self.registry = registry
        self.telemetry = telemetry
        self.rounds: Counter[str] = Counter()
        self.durations_s: list[float] = []
        self.cohort_size = 0
        self._m_rounds = registry.counter(
            "nanofed_rounds_total", "Federation rounds by outcome", labels=("status",)
        )
        self._m_round_duration = registry.histogram(
            "nanofed_round_duration_seconds", "Wall time per federation round"
        )
        self._m_cohort = registry.gauge(
            "nanofed_cohort_size", "Clients whose updates entered the last aggregate"
        )
        self._m_dropouts = (
            registry.counter(
                "nanofed_dropouts_total",
                "Sampled clients that dropped out of a round",
            )
            if track_dropouts
            else None
        )
        self._m_critical_path = registry.histogram(
            "nanofed_round_critical_path_seconds",
            "Per-round walltime by critical-path segment "
            "(wire_wait/decode/drain/collective/apply/publish)",
            labels=("segment",),
        )

    def charge(
        self,
        *,
        status: str,
        num_clients: int,
        duration_s: float,
        expected: int | None = None,
        telemetry_fields: dict[str, Any] | None = None,
        segments: dict[str, float] | None = None,
    ) -> None:
        """Charge one round outcome: counter by lowercased status, duration
        observation, cohort gauge, dropouts (when tracked and ``expected`` is given),
        the critical-path ``segments`` (segment name -> seconds), and — when this
        front has telemetry — the ``round`` record, with ``segments`` rounded."""
        status = str(status).lower()
        self.rounds[status] += 1
        self.durations_s.append(float(duration_s))
        self.cohort_size = int(num_clients)
        self._m_rounds.inc(status=status)
        self._m_round_duration.observe(duration_s)
        self._m_cohort.set(num_clients)
        if self._m_dropouts is not None and expected is not None:
            self._m_dropouts.inc(max(0, expected - num_clients))
        if segments:
            for seg, seconds in segments.items():
                self._m_critical_path.observe(float(seconds), segment=str(seg))
        if self.telemetry is not None and telemetry_fields is not None:
            if segments:
                telemetry_fields = dict(telemetry_fields)
                telemetry_fields.setdefault("segments", {
                    str(seg): round(float(v), 6) for seg, v in segments.items()
                })
            self.telemetry.record("round", **telemetry_fields)

    @staticmethod
    def now() -> float:
        """Round-duration timestamps: always the real ``perf_counter``."""
        return time.perf_counter()
