"""Defense against malformed or malicious client updates, the stacked in-round part
(counterpart of ``nanofed_tpu/security/validation.py``).

The checks run over the stacked ``[C, ...]`` client axis and return per-client
boolean tensors; an invalid client is not rejected with an exception, its
aggregation weight is zeroed (:func:`apply_validation_mask`).  The round step
(``parallel.round_step``) runs the same statistics on its flat delta buffer and
reduces with kernel B2.

The host path of the network mode checks one ``ModelUpdate`` at a time and returns a
:class:`ValidationResult` (``validate_shape``, ``validate_range``,
``validate_statistics``).  Its norms are the JAX package's: float64 numpy on the
host, so a client near ``max_norm`` or the z-score threshold gets the same verdict
from both packages (a float32 norm on the card could decide otherwise).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from nanofed_tpu_torch.core.types import ModelUpdate, Params


class ValidationResult(enum.Enum):
    """Host-path verdicts on one update."""

    VALID = enum.auto()
    INVALID_SHAPE = enum.auto()
    INVALID_RANGE = enum.auto()
    INVALID_SIGNATURE = enum.auto()
    ANOMALOUS = enum.auto()


@dataclass(frozen=True)
class ValidationConfig:
    """``max_norm`` bounds each parameter leaf's L2 norm; ``z_score_threshold`` flags
    clients whose *global* update norm deviates from the cohort; statistics are
    skipped below ``min_clients_for_stats`` participants.  ``signature_required`` is
    advisory metadata (signatures are a transport concern)."""

    max_norm: float = 10.0
    max_update_size: int = 1024 * 1024 * 100
    min_clients_for_stats: int = 5
    z_score_threshold: float = 2.0
    signature_required: bool = False


class ValidationReport(NamedTuple):
    """Per-client validation outcome for one round, all shapes ``[C]``; ``valid`` is
    the conjunction used for weight masking."""

    finite: torch.Tensor  # bool — every leaf entry finite
    range_ok: torch.Tensor  # bool — every leaf norm <= max_norm
    anomalous: torch.Tensor  # bool — cohort z-score above threshold
    global_norm: torch.Tensor  # float — per-client global update norm
    z_score: torch.Tensor  # float — |norm - cohort mean| / cohort std
    valid: torch.Tensor  # bool — finite & range_ok & ~anomalous

    def num_valid(self) -> int:
        return int(self.valid.sum())


class StackedLeafStats(NamedTuple):
    """Per-client validity statistics of a stacked ``[C, ...]`` update, all ``[C]``
    except ``leaf_sq`` (``[L, C]``)."""

    finite: torch.Tensor  # bool — every leaf entry finite
    leaf_sq: torch.Tensor  # [L, C] float32 squared norm per leaf (non-finite zeroed)
    global_norm: torch.Tensor  # float32 global L2 norm
    sanitized: Params | None  # the input, zeroed in place, when asked for


def stacked_leaf_stats(stacked: Params, sanitize_in_place: bool = False) -> StackedLeafStats:
    """Finiteness and norms over the leading client axis, in float32, one leaf at a
    time (the temporaries are one leaf's size, not the update's).

    Non-finite entries count as zero in the norms, so ``finite`` alone reports NaN
    and inf.  With ``sanitize_in_place`` they are also zeroed in ``stacked`` itself,
    which comes back as ``sanitized`` (no second copy of a large buffer; a weighted
    reduce of it is then safe, where weight 0 alone is not: 0 * NaN = NaN).
    Without it ``sanitized`` is None: the caller's reduce sanitizes as it reads, as
    kernel B2 does."""
    finite, leaf_sq = [], []
    for leaf in stacked.values():
        flat = leaf.reshape(leaf.shape[0], -1)
        finite.append(torch.isfinite(flat).all(1))
        if sanitize_in_place:
            safe = torch.nan_to_num_(flat, nan=0.0, posinf=0.0, neginf=0.0)
        else:
            safe = torch.nan_to_num(flat.float(), nan=0.0, posinf=0.0, neginf=0.0)
        leaf_sq.append(torch.linalg.vecdot(safe, safe))
    leaf_sq_t = torch.stack(leaf_sq)
    return StackedLeafStats(
        finite=torch.stack(finite).all(0),
        leaf_sq=leaf_sq_t,
        global_norm=torch.sqrt(leaf_sq_t.sum(0)),
        sanitized=stacked if sanitize_in_place else None,
    )


def loo_zscore(
    norms: torch.Tensor,
    eligible: torch.Tensor,
    z_score_threshold: float,
    min_cohort: float,
    sum_fn: Callable[[torch.Tensor], torch.Tensor] = torch.sum,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Leave-one-out cohort z-score over eligible clients.

    Clients that already failed finiteness or range checks are left out of the
    cohort (their norms would poison the mean and std the honest clients are judged
    against), and each client is judged against the cohort EXCLUDING itself (a
    self-inclusive z-score with ddof=1 is capped at (n-1)/sqrt(n), so at a cohort of
    5 a single attacker could never reach a threshold of 2).

    ``sum_fn`` is the cohort's sum: the local one over a stacked axis, or across a
    mesh (``parallel.mesh.sum_fn_of(layout)``), so each rank judges its clients
    against the whole cohort's n, sum and sum of squares.
    """
    n = sum_fn(eligible)
    s = sum_fn(norms * eligible)
    ss = sum_fn(norms.square() * eligible)
    n_rest = torch.clamp(n - 1.0, min=1.0)
    mean_rest = (s - norms * eligible) / n_rest
    var_rest = (ss - norms.square() * eligible - n_rest * mean_rest.square()) / torch.clamp(
        n_rest - 1.0, min=1.0
    )
    var_rest = torch.clamp(var_rest, min=0.0)  # numerical floor
    z = (norms - mean_rest).abs() / (torch.sqrt(var_rest) + 1e-8) * eligible
    anomalous = (z > z_score_threshold) & (n >= min_cohort)
    return z, anomalous


def validate_stats(
    stats: StackedLeafStats, config: ValidationConfig, participating: torch.Tensor,
    sum_fn: Callable[[torch.Tensor], torch.Tensor] = torch.sum,
) -> ValidationReport:
    """The verdicts from precomputed statistics: per-leaf range check, then the
    leave-one-out z-score over the participating clients that passed the
    finiteness and range checks (the cohort's sums through ``sum_fn``, as
    :func:`loo_zscore` takes them)."""
    range_ok = (torch.sqrt(stats.leaf_sq) <= config.max_norm).all(0)
    eligible = participating.float() * stats.finite * range_ok
    z, anomalous = loo_zscore(
        stats.global_norm, eligible, config.z_score_threshold,
        float(config.min_clients_for_stats), sum_fn=sum_fn,
    )
    valid = stats.finite & range_ok & ~anomalous
    return ValidationReport(stats.finite, range_ok, anomalous, stats.global_norm, z, valid)


def validate_client_updates(
    stacked: Params, config: ValidationConfig | None = None
) -> ValidationReport:
    """Finiteness, the per-leaf norm bound and the cohort z-score over a stacked
    update (leaves ``[C, ...]``), every client a participant."""
    config = config or ValidationConfig()
    stats = stacked_leaf_stats(stacked)
    return validate_stats(stats, config, torch.ones_like(stats.finite))


def apply_validation_mask(weights: torch.Tensor, report: ValidationReport) -> torch.Tensor:
    """Zero the aggregation weight of every invalid client."""
    return weights * report.valid.to(weights.dtype)


# ---------------------------------------------------------------------------------------
# Host path: one ModelUpdate at a time, float64 numpy norms.
# ---------------------------------------------------------------------------------------


def reference_shapes(params: Params) -> dict[str, tuple[int, ...]]:
    """Name -> shape of the global model: the host-path shape reference."""
    return {name: tuple(leaf.shape) for name, leaf in params.items()}


def _host_leaves(update: ModelUpdate) -> list[tuple[str, np.ndarray]]:
    """The update's leaves as numpy arrays (bf16 widened to float32, exactly)."""
    out = []
    for name, leaf in update.params.items():
        t = leaf.detach().cpu()
        out.append((name, (t.float() if t.dtype == torch.bfloat16 else t).numpy()))
    return out


def validate_shape(update: ModelUpdate,
                   reference: Mapping[str, tuple[int, ...]]) -> ValidationResult:
    """Every reference leaf present with exactly its shape."""
    got = dict(_host_leaves(update))
    for key, shape in reference.items():
        if key not in got or tuple(got[key].shape) != tuple(shape):
            return ValidationResult.INVALID_SHAPE
    return ValidationResult.VALID


def validate_range(update: ModelUpdate, config: ValidationConfig) -> ValidationResult:
    """Finite values and each leaf's float64 L2 norm at most ``max_norm``."""
    for _, leaf in _host_leaves(update):
        if not np.all(np.isfinite(leaf)):
            return ValidationResult.INVALID_RANGE
        if np.linalg.norm(leaf.astype(np.float64).ravel()) > config.max_norm:
            return ValidationResult.INVALID_RANGE
    return ValidationResult.VALID


def update_flat_norm(update: ModelUpdate) -> float:
    """Float64 L2 norm of one update's whole parameter vector (the statistic of the
    cohort z-score)."""
    vecs = [leaf.astype(np.float64).ravel() for _, leaf in _host_leaves(update)]
    return float(np.linalg.norm(np.concatenate(vecs)))


def validate_statistics(update: ModelUpdate, reference_updates: Sequence[ModelUpdate],
                        config: ValidationConfig) -> ValidationResult:
    """The z-score of the update's norm against the cohort's norms (ddof 1); VALID
    below ``min_clients_for_stats``."""
    if len(reference_updates) < config.min_clients_for_stats:
        return ValidationResult.VALID
    norms = np.array([update_flat_norm(u) for u in reference_updates])
    z = abs(update_flat_norm(update) - norms.mean()) / (norms.std(ddof=1) + 1e-8)
    if z > config.z_score_threshold:
        return ValidationResult.ANOMALOUS
    return ValidationResult.VALID
