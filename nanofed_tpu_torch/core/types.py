"""Core value types (counterpart of ``nanofed_tpu/core/types.py``).

Params are a flat ``dict[str, Tensor]`` keyed by the JAX package's ``/``-path names
(``conv1/bias``, ``conv1/kernel``, ...) in its ravel order, with its layouts (HWIO
conv kernels, ``[in, out]`` dense kernels), so weights and flat ``[P]`` vectors
interchange with no transposes (see ``utils.trees``).

The server optimizer's state in a checkpoint is the JAX package's optax state: a
``(transform, schedule)`` tuple of the records below, whose leaves are nested dicts of
numpy arrays shaped like the params (``utils.trees.to_numpy_server_state``).  The
records carry optax's field names, so a checkpoint of either package loads in the
other (``persistence.serialization`` maps them to and from optax's classes).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
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

    @property
    def num_samples(self) -> Any:
        """Number of real (unpadded) samples: ``mask`` summed over its last axis."""
        return self.mask.sum(-1)

    def to(self, device: torch.device) -> "ClientData":
        """Tensors on ``device``: mask float32, y int64 (torch's index type), x float32,
        or int64 when it holds integer ids (a token stream indexes an embedding)."""

        def put(a: Any, dtype: torch.dtype) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(
                device=device, dtype=dtype
            )

        x = torch.as_tensor(np.asarray(self.x) if not torch.is_tensor(self.x) else self.x)
        x_dtype = torch.float32 if x.is_floating_point() else torch.int64
        return ClientData(
            x=put(x, x_dtype), y=put(self.y, torch.int64),
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

    def to_dict(self) -> dict[str, Any]:
        """One client's metrics as plain numbers (the keys of the reference's
        ``TrainingMetrics``)."""
        return {
            "loss": float(self.loss),
            "accuracy": float(self.accuracy),
            "samples_processed": int(self.samples),
        }


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


@dataclass(frozen=True, slots=True)
class ModelVersion:
    """Frozen record of a saved global model version (the JAX package's
    ``ModelVersion``)."""

    version_id: str
    created_at: datetime
    model_path: str
    config_path: str
    round_number: int = -1


class EmptyState(NamedTuple):
    """optax ``EmptyState``: a stateless transform (constant-lr scaling, plain SGD)."""


class TraceState(NamedTuple):
    """optax ``TraceState``: the momentum trace of ``sgd(lr, momentum)``."""

    trace: Any


class ScaleByAdamState(NamedTuple):
    """optax ``ScaleByAdamState`` (Adam and Yogi): step count and both moments."""

    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """optax ``ScaleByScheduleState``: the step count a learning-rate schedule reads."""

    count: Any
