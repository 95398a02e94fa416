"""Per-round learning-rate schedules (a copy of ``nanofed_tpu/trainer/schedules.py``).

The scale is a pure function of the round index, so a resumed run continues the
schedule exactly.  The Coordinator computes it on the host each round and passes it
to the round step as a Python float (there is no compiled program to protect);
``lr_scale`` multiplies each local SGD step (the full update, after momentum
accumulation), which is equivalent to running that round at
``learning_rate * lr_scale``.
"""

from __future__ import annotations

import math

SCHEDULES = ("constant", "cosine", "linear", "step")


def lr_schedule_scale(
    schedule: str,
    round_id: int,
    total_rounds: int,
    *,
    min_factor: float = 0.0,
    decay_every: int = 10,
    gamma: float = 0.5,
) -> float:
    """The lr multiplier for ``round_id`` (0-based) of ``total_rounds``.

    - ``constant``: 1.0 forever.
    - ``cosine``: half-cosine from 1.0 at round 0 toward ``min_factor``
      (Loshchilov & Hutter 2017, without restarts).
    - ``linear``: straight line from 1.0 toward ``min_factor`` over the run.
    - ``step``: multiply by ``gamma`` every ``decay_every`` rounds (classic staircase);
      never below ``min_factor``.

    Decay progress is ``round_id / total_rounds`` — the LAST trained round sits one
    step above the floor, never on it: with the default ``min_factor=0.0``, landing
    exactly on the floor would make the final round a full-cost silent no-op (every
    client trains, scale 0 zeroes every update).  Rounds past ``total_rounds`` (e.g.
    a resumed run extended beyond its original plan) hold the terminal value rather
    than extrapolating — for every schedule, step included.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown lr schedule {schedule!r}; choose from {SCHEDULES}")
    if not 0.0 <= min_factor <= 1.0:
        raise ValueError("min_factor must be in [0, 1]")
    if schedule == "constant":
        return 1.0
    if schedule == "step":
        if decay_every < 1:
            raise ValueError("decay_every must be >= 1")
        if not 0.0 < gamma <= 1.0:
            raise ValueError("gamma must be in (0, 1]")
        effective = min(round_id, max(total_rounds - 1, 0))
        return max(min_factor, gamma ** (effective // decay_every))
    # cosine / linear interpolate over the run; a 1-round run has no room to decay.
    if total_rounds <= 1:
        return 1.0
    frac = min(round_id / total_rounds, 1.0)
    if schedule == "cosine":
        return min_factor + (1.0 - min_factor) * 0.5 * (1.0 + math.cos(math.pi * frac))
    return 1.0 + (min_factor - 1.0) * frac  # linear


def lr_schedule_scales(
    schedule: str,
    first_round: int,
    num_rounds: int,
    total_rounds: int,
    *,
    min_factor: float = 0.0,
    decay_every: int = 10,
    gamma: float = 0.5,
) -> list[float]:
    """The scales of rounds ``first_round .. first_round+num_rounds-1``: element r
    is exactly ``lr_schedule_scale`` of that round (the per-round schedule array a
    fused round block consumes in the JAX package)."""
    return [
        lr_schedule_scale(
            schedule, first_round + i, total_rounds,
            min_factor=min_factor, decay_every=decay_every, gamma=gamma,
        )
        for i in range(num_rounds)
    ]
