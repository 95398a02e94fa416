"""FedAvg reductions (counterpart of ``nanofed_tpu/aggregation/fedavg.py``).

The weighted mean of client params runs in kernel B1 (``ops.weighted_mean_tree``).
The in-mesh forms take the rank's ``parallel.mesh.MeshLayout`` where the JAX package
takes its client axis names: the rank's local contraction (B1), then one all-reduce
over the client shards (host-local, then across hosts).  With ``layout=None`` they
are the one-device reduce.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from nanofed_tpu_torch.core.types import ClientMetrics, Params
from nanofed_tpu_torch.ops.reduce import weighted_mean_flat, weighted_mean_tree

if TYPE_CHECKING:
    from nanofed_tpu_torch.parallel.mesh import MeshLayout


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
    return psum_weighted_metrics(metrics, weights, None)


def _psum(x: torch.Tensor, layout: "MeshLayout | None") -> torch.Tensor:
    return x if layout is None else layout.client_psum(x)


def psum_weighted_mean(
    delta: torch.Tensor, weights: torch.Tensor, layout: "MeshLayout | None"
) -> torch.Tensor:
    """In-mesh weighted mean over the client shards of ``delta`` ``[C_local, P]``
    (this rank's clients, float32, contiguous rows) with ``weights`` ``[C_local]``:
    the global total weight (one scalar all-reduce), this rank's rows through B1
    divided by it, then ONE ``[P]`` all-reduce of the result.  All-zero weights
    give zeros."""
    total = _psum(weights.sum(), layout)
    return _psum(weighted_mean_flat(delta, weights, denom=total), layout)


def psum_weighted_metrics(
    metrics: ClientMetrics, weights: torch.Tensor, layout: "MeshLayout | None"
) -> dict[str, torch.Tensor]:
    """In-mesh weighted metric means and the participants' sample count: the three
    weighted sums travel as one all-reduce, the sample count as another."""
    participating = (weights > 0).to(metrics.samples.dtype)
    sums = _psum(torch.stack([
        weights.sum(), (metrics.loss * weights).sum(), (metrics.accuracy * weights).sum(),
    ]), layout)
    den = torch.clamp(sums[0], min=1e-12)
    return {
        "loss": sums[1] / den,
        "accuracy": sums[2] / den,
        "samples": _psum((metrics.samples * participating).sum(), layout),
    }
