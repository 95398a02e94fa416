"""Closed-loop online retuning: measured round walltimes re-rank the autotune table
(counterpart of ``nanofed_tpu/tuning/retuner.py``; the logic is unchanged).

The autotuner scores candidates from one profiled execution each; an
:class:`OnlineRetuner` consumes the round walltimes the coordinator actually
realizes, keeps a measured seconds-per-round table beside the sweep's scores, and at
round boundaries proposes swapping the live round program for a candidate the
measurements rank higher.  Swap mechanics stay in the coordinator; the retuner is
pure bookkeeping and decision, unit-testable without running a round.

Calibration: with only the incumbent measured, an alternative's expected walltime
is the incumbent's measured seconds-per-round scaled by the score ratio
(``est(c) = measured(cur) * score(c)/score(cur)``).  Once a swap lands, the new
incumbent's real measurements replace the estimate.  A swap needs a
:attr:`~OnlineRetuner.hysteresis` relative win so measurement noise cannot flap
programs.

Scope rule: only ``client_chunk``/``rounds_per_block`` are hot-swappable — the
mesh shape (hosts x model_shards), batch size, and adapter rank define the layouts
of the resident params and data.  Ineligible candidates are recorded as such in the
decision's ``considered`` table, never silently dropped.  The port's coordinator
swaps both, and refuses a ``rounds_per_block > 1`` its configuration cannot fuse.

``write_back()`` stamps the measured numbers into the autotune cache entry
(``.nanofed_torch_cache/autotune_<key16>.json``), so the NEXT run's cache hit
starts from measurements.  The coordinator passes each observation's
device-occupancy ratio (``observability.update_device_occupancy``, from its spans),
so measured rows carry ``measured_occupancy_mean`` as the JAX package's do.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from nanofed_tpu_torch.tuning.autotuner import (
    DEFAULT_CACHE_DIR,
    AutotuneResult,
    CandidateConfig,
    CandidateOutcome,
    candidate_program_name,
)
from nanofed_tpu_torch.utils.logger import Logger

__all__ = ["OnlineRetuner", "RetuneDecision"]

_log = Logger()


@dataclass
class RetuneDecision:
    """One retune verdict: swap (``new is not None``) or hold, with the full
    measured/estimated basis so the telemetry record audits itself."""

    old: CandidateConfig
    new: CandidateConfig | None
    #: The incumbent's measured seconds per round (the basis everything else
    #: is compared against).
    measured_s_per_round: float
    #: The winner's estimated (or measured) seconds per round.
    candidate_s_per_round: float | None
    #: Fractional improvement the winner promises ((old-new)/old); None on hold.
    delta: float | None
    #: "measured" when the winner has its own measurements, "estimated (aot
    #: score x measured calibration)" otherwise.
    basis: str
    #: Why a hold held, stated ("no eligible alternative", "hysteresis", ...).
    reason: str | None = None
    #: Every candidate looked at: config, eligibility, estimate.
    considered: list[dict[str, Any]] = field(default_factory=list)

    @property
    def swap(self) -> bool:
        return self.new is not None

    def to_dict(self) -> dict[str, Any]:
        return {
            "swap": self.swap,
            "old": self.old.to_dict(),
            "new": self.new.to_dict() if self.new is not None else None,
            "old_program": candidate_program_name(self.old),
            **(
                {"new_program": candidate_program_name(self.new)}
                if self.new is not None else {}
            ),
            "measured_s_per_round": round(self.measured_s_per_round, 6),
            **(
                {"candidate_s_per_round": round(self.candidate_s_per_round, 6)}
                if self.candidate_s_per_round is not None else {}
            ),
            **({"delta": round(self.delta, 4)} if self.delta is not None else {}),
            "basis": self.basis,
            **({"reason": self.reason} if self.reason else {}),
            "considered": self.considered,
        }


@dataclass
class _Measurement:
    rounds: int = 0
    walltime_s: float = 0.0
    occupancy_sum: float = 0.0
    occupancy_n: int = 0

    @property
    def s_per_round(self) -> float | None:
        if self.rounds <= 0:
            return None
        return self.walltime_s / self.rounds

    @property
    def occupancy_mean(self) -> float | None:
        if self.occupancy_n <= 0:
            return None
        return self.occupancy_sum / self.occupancy_n

    def to_dict(self) -> dict[str, Any]:
        return {
            "rounds": self.rounds,
            "walltime_s": round(self.walltime_s, 6),
            "s_per_round": round(self.s_per_round, 6),
            **(
                {"occupancy_mean": round(self.occupancy_mean, 4)}
                if self.occupancy_mean is not None else {}
            ),
        }


class OnlineRetuner:
    """Measured-walltime re-ranking over an :class:`AutotuneResult`'s
    candidate table.

    The coordinator feeds :meth:`observe` one call per completed block (or
    single round) and asks :meth:`propose` at swap-safe boundaries; everything
    in between is arithmetic.  ``min_rounds`` guards against deciding off a
    single block's noise; ``hysteresis`` is the relative win an alternative
    must promise before a swap fires."""

    def __init__(
        self,
        result: AutotuneResult,
        *,
        hysteresis: float = 0.05,
        min_rounds: int = 2,
        cache_dir: str | Path | None = DEFAULT_CACHE_DIR,
    ) -> None:
        if not 0.0 <= hysteresis < 1.0:
            raise ValueError(f"hysteresis must be in [0, 1), got {hysteresis}")
        self.result = result
        self.hysteresis = float(hysteresis)
        self.min_rounds = int(min_rounds)
        self.cache_dir = Path(cache_dir) if cache_dir is not None else None
        self._measured: dict[CandidateConfig, _Measurement] = {}
        self.decisions: list[RetuneDecision] = []
        self._score: dict[CandidateConfig, float] = {
            o.config: float(o.score)
            for o in result.outcomes
            if o.feasible and o.score is not None
        }

    # ------------------------------------------------------------------ feed

    def observe(
        self,
        config: CandidateConfig,
        rounds: int,
        walltime_s: float,
        occupancy: float | None = None,
    ) -> None:
        """Accumulate one realized block: ``rounds`` rounds took
        ``walltime_s`` seconds under ``config`` (occupancy: the
        ``nanofed_device_occupancy_ratio`` gauge at the block boundary)."""
        if rounds <= 0 or not math.isfinite(walltime_s) or walltime_s < 0:
            return
        m = self._measured.setdefault(config, _Measurement())
        m.rounds += int(rounds)
        m.walltime_s += float(walltime_s)
        if occupancy is not None and math.isfinite(occupancy):
            m.occupancy_sum += float(occupancy)
            m.occupancy_n += 1

    def measured_s_per_round(self, config: CandidateConfig) -> float | None:
        m = self._measured.get(config)
        return m.s_per_round if m is not None else None

    # -------------------------------------------------------------- decision

    def _eligible(self, current: CandidateConfig, cand: CandidateConfig) -> str | None:
        """None when ``cand`` is hot-swappable from ``current``; otherwise the
        stated reason it is not."""
        if cand == current:
            return "incumbent"
        if (cand.hosts, cand.model_shards) != (current.hosts, current.model_shards):
            return "mesh shape differs (would reshard resident params/data)"
        if cand.batch_size != current.batch_size:
            return "batch size differs (would reshape the resident client data)"
        if cand.adapter_rank != current.adapter_rank:
            return "adapter rank differs (would rebuild the federated tree)"
        return None

    def _estimate(
        self, current: CandidateConfig, cand: CandidateConfig, cur_s: float,
    ) -> tuple[float, str] | None:
        """(seconds-per-round estimate, basis) for ``cand``, or None when the
        table holds nothing to estimate from."""
        own = self.measured_s_per_round(cand)
        if own is not None:
            return own, "measured"
        cur_score = self._score.get(current)
        cand_score = self._score.get(cand)
        if cur_score is None or cand_score is None or cur_score <= 0:
            return None
        return (
            cur_s * (cand_score / cur_score),
            "estimated (aot score x measured calibration)",
        )

    def propose(self, current: CandidateConfig) -> RetuneDecision:
        """The retune verdict for the incumbent ``current``, given everything
        observed so far.  Pure — recording/acting on the decision is the
        caller's job (the coordinator swaps at the next safe boundary)."""
        m = self._measured.get(current)
        cur_s = m.s_per_round if m is not None else None
        if cur_s is None or m.rounds < self.min_rounds:
            decision = RetuneDecision(
                old=current, new=None,
                measured_s_per_round=cur_s if cur_s is not None else float("nan"),
                candidate_s_per_round=None, delta=None, basis="measured",
                reason=(
                    f"insufficient measurements ({m.rounds if m else 0} rounds "
                    f"< min_rounds {self.min_rounds})"
                ),
            )
            self.decisions.append(decision)
            return decision

        considered: list[dict[str, Any]] = []
        best: tuple[float, str, CandidateConfig] | None = None
        for cand in sorted(self._score, key=lambda c: c.key):
            why_not = self._eligible(current, cand)
            row: dict[str, Any] = {"config": cand.to_dict()}
            if why_not is not None:
                row["ineligible"] = why_not
                considered.append(row)
                continue
            est = self._estimate(current, cand, cur_s)
            if est is None:
                row["ineligible"] = "no basis to estimate (unscored candidate)"
                considered.append(row)
                continue
            s, basis = est
            row["s_per_round"] = round(s, 6)
            row["basis"] = basis
            considered.append(row)
            if best is None or s < best[0]:
                best = (s, basis, cand)

        if best is None:
            decision = RetuneDecision(
                old=current, new=None, measured_s_per_round=cur_s,
                candidate_s_per_round=None, delta=None, basis="measured",
                reason="no eligible alternative", considered=considered,
            )
        else:
            s, basis, cand = best
            delta = (cur_s - s) / cur_s
            if s < cur_s * (1.0 - self.hysteresis):
                decision = RetuneDecision(
                    old=current, new=cand, measured_s_per_round=cur_s,
                    candidate_s_per_round=s, delta=delta, basis=basis,
                    considered=considered,
                )
            else:
                decision = RetuneDecision(
                    old=current, new=None, measured_s_per_round=cur_s,
                    candidate_s_per_round=s, delta=delta, basis=basis,
                    reason=(
                        f"hysteresis: best alternative wins {delta:+.1%}, "
                        f"needs > {self.hysteresis:.1%}"
                    ),
                    considered=considered,
                )
        self.decisions.append(decision)
        _log.info(
            "retune %s: %s",
            "SWAP" if decision.swap else "hold",
            (f"{candidate_program_name(decision.old)} -> "
             f"{candidate_program_name(decision.new)} ({decision.delta:+.1%})"
             if decision.swap else decision.reason),
        )
        return decision

    # ------------------------------------------------------------ write-back

    def measured_table(self) -> dict[str, dict[str, Any]]:
        """Program-name-keyed measured numbers (what lands in the cache entry
        and the run summary)."""
        return {
            candidate_program_name(c): m.to_dict()
            for c, m in sorted(
                self._measured.items(), key=lambda kv: kv[0].key
            )
            if m.rounds > 0
        }

    def write_back(self) -> Path | None:
        """Stamp measured seconds-per-round into the autotune cache entry so
        the next run's cache hit starts from measurements.  Each measured
        candidate's ``cost`` gains ``measured_s_per_round`` /
        ``measured_rounds`` (and occupancy); the entry gains a top-level
        ``measured`` block with the swap history.  Best-effort: returns the
        path written, or None (no cache dir / no entry / nothing measured —
        a foreign cache entry is never half-written)."""
        if self.cache_dir is None or not self._measured:
            return None
        path = self.cache_dir / f"autotune_{self.result.cache_key[:16]}.json"
        try:
            d = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if d.get("cache_key") != self.result.cache_key:
            return None
        by_key = {
            CandidateConfig.from_dict(o["config"]): o
            for o in d.get("candidates", [])
        }
        for config, m in self._measured.items():
            row = by_key.get(config)
            if row is None or m.rounds <= 0:
                continue
            cost = row.setdefault("cost", {})
            cost["measured_s_per_round"] = round(m.s_per_round, 6)
            cost["measured_rounds"] = m.rounds
            if m.occupancy_mean is not None:
                cost["measured_occupancy_mean"] = round(m.occupancy_mean, 4)
        d["measured"] = {
            "basis": (
                "realized per-block round walltimes (host tax included), "
                "written back by OnlineRetuner"
            ),
            "table": self.measured_table(),
            "swaps": [
                dec.to_dict() for dec in self.decisions if dec.swap
            ],
        }
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(d, indent=2, sort_keys=True) + "\n")
        tmp.replace(path)
        return path

    # ------------------------------------------------------------- reporting

    def summary(self) -> dict[str, Any]:
        """The run-summary block: measurements, decisions, swap count."""
        swaps = [d for d in self.decisions if d.swap]
        return {
            "decisions": len(self.decisions),
            "swaps": len(swaps),
            "hysteresis": self.hysteresis,
            "measured": self.measured_table(),
            **(
                {"swap_history": [d.to_dict() for d in swaps]} if swaps else {}
            ),
        }


def outcome_for(result: AutotuneResult, config: CandidateConfig) -> CandidateOutcome | None:
    """The table row for ``config`` in ``result`` (None when absent)."""
    for o in result.outcomes:
        if o.config == config:
            return o
    return None
