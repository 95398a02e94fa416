"""FedAvg reductions (counterpart of ``nanofed_tpu/aggregation/fedavg.py``).

One device, so the JAX package's in-mesh ``psum`` forms collapse to local sums; the
weighted mean of client params runs in kernel B1 (``ops.weighted_mean_tree``).
"""

from __future__ import annotations

import torch

from nanofed_tpu_torch.core.types import ClientMetrics, Params
from nanofed_tpu_torch.ops.reduce import weighted_mean_tree


def compute_weights(
    num_samples: torch.Tensor, participation: torch.Tensor | None = None
) -> torch.Tensor:
    """FedAvg weights: client sample counts, zeroed for non-participants (a count
    of zero is a padding client and gets weight 0 either way)."""
    w = torch.clamp(num_samples, min=0.0)
    if participation is not None:
        w = w * participation
    return w


def fedavg_combine(stacked_params: Params, weights: torch.Tensor) -> Params:
    """Sample-count-weighted mean of stacked client params ``[C, ...]``."""
    return weighted_mean_tree(stacked_params, weights)


def aggregate_metrics(metrics: ClientMetrics, weights: torch.Tensor) -> dict[str, torch.Tensor]:
    """Weighted mean loss/accuracy; ``samples`` counts participants only
    (weights > 0)."""
    den = torch.clamp(weights.sum(), min=1e-12)
    participating = (weights > 0).to(metrics.samples.dtype)
    return {
        "loss": (metrics.loss * weights).sum() / den,
        "accuracy": (metrics.accuracy * weights).sum() / den,
        "samples": (metrics.samples * participating).sum(),
    }
