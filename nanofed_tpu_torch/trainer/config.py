"""Training configuration (counterpart of ``nanofed_tpu/trainer/config.py``: the same
fields and checks)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``; raises ValueError for a name that is not
    a floating dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dtype


@dataclass(frozen=True, slots=True)
class TrainingConfig:
    """Static hyperparameters of local training.

    ``prox_mu > 0`` is FedProx (the local objective gains ``mu/2 ||w - w_global||^2``).
    ``collect_batch_metrics`` returns per-step loss curves.  ``compute_dtype=
    "bfloat16"`` runs forward/backward in bf16 while params, gradients and the
    optimizer update stay float32; loss and metrics reduce in float32.
    """

    batch_size: int = 64
    local_epochs: int = 1
    learning_rate: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    max_batches: int | None = None
    prox_mu: float = 0.0
    collect_batch_metrics: bool = False
    compute_dtype: str | None = None  # e.g. "bfloat16"; None = params' float32

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.local_epochs < 1:
            raise ValueError("local_epochs must be >= 1")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be > 0")
        if self.max_batches is not None and self.max_batches < 1:
            raise ValueError("max_batches must be >= 1 when set")
        if self.prox_mu < 0:
            raise ValueError("prox_mu must be >= 0")
        if self.compute_dtype is not None:
            torch_dtype(self.compute_dtype)
