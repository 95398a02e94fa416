"""Core value types (counterpart of ``nanofed_tpu/core/types.py``).

Params are a flat ``dict[str, Tensor]`` keyed by the JAX package's ``/``-path names
(``conv1/bias``, ``conv1/kernel``, ...) in its ravel order, with its layouts (HWIO
conv kernels, ``[in, out]`` dense kernels), so weights and flat ``[P]`` vectors
interchange with no transposes (see ``utils.trees``).
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, TypeAlias

import numpy as np
import torch

Params: TypeAlias = dict[str, torch.Tensor]


class ClientData(NamedTuple):
    """Padded training data for one client, or ``[C, N, ...]`` for a batch of clients.

    ``x``/``y`` are padded to a common capacity ``N``; ``mask`` marks real samples
    (1.0) vs padding (0.0).  The host-side packing functions (``data.batching``) fill it with
    numpy arrays, exactly as the JAX package does; :meth:`to` moves it to a device.
    """

    x: Any  # [N, ...features] or [C, N, ...]
    y: Any  # [N] or [C, N] integer labels
    mask: Any  # [N] or [C, N] float {0., 1.}

    def to(self, device: torch.device) -> "ClientData":
        """Tensors on ``device``: x and mask float32, y int64 (torch's index type)."""

        def put(a: Any, dtype: torch.dtype) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(
                device=device, dtype=dtype
            )

        return ClientData(
            x=put(self.x, torch.float32), y=put(self.y, torch.int64),
            mask=put(self.mask, torch.float32),
        )

    def select(self, key: Any) -> "ClientData":
        """Index the leading (client) axis of every field: a slice or index tensor."""
        return ClientData(self.x[key], self.y[key], self.mask[key])


class ClientMetrics(NamedTuple):
    """Per-client scalar training metrics as tensors (``[C]`` when stacked)."""

    loss: torch.Tensor
    accuracy: torch.Tensor
    samples: torch.Tensor


class ClientUpdates(NamedTuple):
    """Stacked client results for one aggregation: ``params`` leaves ``[C, ...]``,
    ``weights`` ``[C]`` (sample counts), ``metrics`` ``[C]`` each."""

    params: Params
    weights: torch.Tensor
    metrics: ClientMetrics


class ModelUpdate(NamedTuple):
    """One client's update record on the host/transport path (the network mode's
    buffer entry): params on the CPU as the wire decoded them."""

    client_id: str
    round_number: int
    params: Params
    metrics: Mapping[str, Any]
    timestamp: str
    privacy_spent: Any | None = None
