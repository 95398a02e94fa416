"""Byzantine-robust aggregation: coordinate-wise trimmed mean, coordinate median and
Multi-Krum (counterpart of ``nanofed_tpu/aggregation/robust.py``).

The functions take the round's layout: a flat ``[C, P]`` matrix of client updates
(rows contiguous; the row stride may exceed P) and ``like``, params whose leaves give
the per-leaf column segments in ravel order.  Each returns ``(aggregate [P], ok,
kept)``.  ``ok`` is False below the method's participant floor; the aggregate is then
zero and the caller leaves params untouched.

Masking discipline, as in the JAX package: non-participants are pushed to the top of
each coordinate's sort order as ``+inf``, so the m participants occupy ranks
``[0, m)``.  The estimators are UNWEIGHTED over the kept ranks or selected clients:
sample-count weighting would let an attacker amplify itself.  Sorting along the client
axis is ``torch.sort`` (the JAX sort is XLA, not Pallas); Multi-Krum's Gram matrices
are full-f32 ``matmul``s (TF32 is off in the port), and its mean over the selected
clients is kernel B1 with an explicit denominator.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.ops.reduce import weighted_mean_flat
from nanofed_tpu_torch.utils.trees import unravel_stacked

RobustResult = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class RobustAggregationConfig:
    """``method="trimmed_mean"`` (default): ``trim_k`` clients trimmed from EACH end
    of every coordinate; floor ``2 * trim_k + 1`` participants.  ``method="median"``:
    the coordinate-wise median; ``trim_k`` is ignored; floor 3.
    ``method="multi_krum"``: Multi-Krum (Blanchard et al. 2017) with ``f = trim_k``:
    each client is scored by its summed squared distance to its ``m - f - 2`` nearest
    peers and the ``m - f`` best are averaged; floor ``2f + 3``."""

    trim_k: int = 1
    method: str = "trimmed_mean"  # trimmed_mean | median | multi_krum

    def __post_init__(self) -> None:
        if self.method not in ("trimmed_mean", "median", "multi_krum"):
            raise ValueError(
                f"unknown robust method {self.method!r}; "
                "choose trimmed_mean, median, or multi_krum"
            )
        if self.method in ("trimmed_mean", "multi_krum") and self.trim_k < 1:
            raise ValueError(
                "trim_k must be >= 1 (0 is just the plain mean; for multi_krum it "
                "is f, the assumed Byzantine count)"
            )


def _rank_mean(x: torch.Tensor, mask: torch.Tensor, like: Params, lo: torch.Tensor,
               hi: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Mean of ranks ``[lo, hi)`` of every coordinate, sorted along the client axis
    with non-participants as +inf; zeros unless ``ok``.  ``lo``, ``hi`` and ``ok`` are
    0-d device tensors: the window is a mask over the ranks, not a slice, so nothing
    is read on the host.  One leaf at a time, so the sort's temporaries are one
    leaf's size."""
    ranks = torch.arange(x.shape[0], device=x.device)[:, None]
    keep = (ranks >= lo) & (ranks < hi)
    denom = torch.clamp(hi - lo, min=1).float()
    out = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    offset = 0
    for seg in unravel_stacked(x, like).values():
        seg = seg.reshape(seg.shape[0], -1)
        vals = torch.where(mask[:, None], seg.float(), torch.inf)
        srt = torch.sort(vals, dim=0).values
        mean = torch.where(keep, srt, 0.0).sum(0) / denom
        out[offset : offset + seg.shape[1]] = torch.where(ok, mean, 0.0)
        offset += seg.shape[1]
    return out


def trimmed_mean(
    x: torch.Tensor, participating: torch.Tensor, trim_k: int, like: Params
) -> RobustResult:
    """Coordinate-wise trimmed mean over the participating clients (``participating``
    a ``[C]`` {0, 1} mask): ranks ``[trim_k, m - trim_k)`` averaged.  ``kept`` is the
    number of ranks averaged per coordinate (0 when not ok)."""
    mask = participating.bool()
    m = mask.sum()
    ok = m >= 2 * trim_k + 1
    agg = _rank_mean(x, mask, like, torch.full_like(m, trim_k), m - trim_k, ok)
    kept = torch.where(ok, torch.clamp(m - 2 * trim_k, min=0), 0).float()
    return agg, ok, kept


def coordinate_median(
    x: torch.Tensor, participating: torch.Tensor, like: Params
) -> RobustResult:
    """Coordinate-wise median over the participating clients (even counts average the
    two middle ranks); ``ok`` needs 3 participants.  ``kept`` is the participant count
    m (every participant's ordering contributes to a median)."""
    mask = participating.bool()
    m = mask.sum()
    ok = m >= 3
    agg = _rank_mean(x, mask, like, (m - 1) // 2, m // 2 + 1, ok)
    return agg, ok, torch.where(ok, m, 0).float()


def multi_krum(
    x: torch.Tensor, participating: torch.Tensor, f: int, like: Params
) -> RobustResult:
    """Multi-Krum over the participating clients: ``score(i)`` sums the squared L2
    distances to i's ``m - f - 2`` nearest participating peers, and the ``m - f``
    lowest scores are averaged, unweighted, by kernel B1 (weights = the selection,
    denominator = its size).  ``ok`` needs ``2f + 3`` participants.  The participant
    count stays a 0-d device tensor: the neighbour window is a mask over the ranks."""
    mask = participating.bool()
    c = mask.shape[0]
    m = mask.sum()
    ok = m >= 2 * f + 3

    # Pairwise squared distances leaf by leaf, so the [C, C] Gram matrices are the
    # only O(C^2) temporaries.  Full f32 (TF32 off): sq_i + sq_j - 2 * dot cancels,
    # and reduced precision would let rounding drive the neighbour ranking.
    dist2 = torch.zeros((c, c), dtype=torch.float32, device=x.device)
    for seg in unravel_stacked(x, like).values():
        flat = seg.reshape(c, -1).float()
        sq = torch.linalg.vecdot(flat, flat)
        gram = flat @ flat.T
        dist2 += torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    pair_ok = mask[:, None] & mask[None, :]
    dist2 = torch.where(pair_ok, dist2, torch.inf)

    # score(i): row i sorted (self-distance 0 at rank 0, +inf at the tail), ranks
    # [1, 1 + n_near) summed.
    n_near = torch.clamp(m - f - 2, min=1)
    ranks = torch.arange(c, device=x.device)
    near = (ranks >= 1) & (ranks < 1 + n_near)
    srt = torch.sort(dist2, dim=1).values
    scores = torch.where(mask, torch.where(near[None, :], srt, 0.0).sum(1), torch.inf)
    order = torch.argsort(scores, stable=True)
    score_rank = torch.empty_like(order)
    score_rank[order] = ranks
    n_sel = torch.clamp(m - f, min=1)
    sel = ((score_rank < n_sel) & mask).float()
    agg = weighted_mean_flat(x, sel, denom=n_sel.float())
    agg = torch.where(ok, agg, 0.0)
    return agg, ok, torch.where(ok, n_sel, 0).float()


def robust_aggregate(
    config: RobustAggregationConfig, x: torch.Tensor, participating: torch.Tensor,
    like: Params,
) -> RobustResult:
    """Dispatch on ``config.method``: the one entry point the round step uses."""
    if config.method == "median":
        return coordinate_median(x, participating, like)
    if config.method == "multi_krum":
        return multi_krum(x, participating, config.trim_k, like)
    return trimmed_mean(x, participating, config.trim_k, like)


def robust_floor(config: RobustAggregationConfig) -> int:
    """Minimum participants below which the round fails closed."""
    if config.method == "median":
        return 3
    if config.method == "multi_krum":
        return 2 * config.trim_k + 3
    return 2 * config.trim_k + 1

