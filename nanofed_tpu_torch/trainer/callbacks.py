"""Host-side training callbacks (counterpart of ``nanofed_tpu/trainer/callbacks.py``).

Callbacks are metric sinks replayed after the fit: ``local_fit`` returns per-epoch
(and optionally per-batch) metric tensors, and the host ``Trainer`` feeds them to the
callbacks in order, as the JAX package does.  The files written and the values seen
are the JAX package's; the timing is post-hoc.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Protocol, runtime_checkable

from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry


@runtime_checkable
class Callback(Protocol):
    """The three hooks a ``Trainer`` replays."""

    def on_epoch_start(self, epoch: int) -> None: ...

    def on_epoch_end(self, epoch: int, metrics: dict[str, Any]) -> None: ...

    def on_batch_end(self, epoch: int, batch: int, metrics: dict[str, Any]) -> None: ...


class BaseCallback:
    """No-op base so subclasses override only what they need."""

    def on_epoch_start(self, epoch: int) -> None:  # noqa: B027
        pass

    def on_epoch_end(self, epoch: int, metrics: dict[str, Any]) -> None:  # noqa: B027
        pass

    def on_batch_end(self, epoch: int, batch: int, metrics: dict[str, Any]) -> None:  # noqa: B027
        pass


class TelemetryCallback(BaseCallback):
    """Bridges per-epoch / per-batch local-training metrics into the metrics
    registry (observability subsystem), so client-side training progress shows up
    on ``GET /metrics`` next to the round engine's counters.

    Per-epoch: ``nanofed_local_epochs_total{client=...}`` increments and the last
    loss/accuracy land in ``nanofed_local_last_loss`` / ``_last_accuracy`` gauges,
    with the loss distribution in the ``nanofed_local_epoch_loss`` histogram.
    Per-batch: ``nanofed_local_batches_total{client=...}``.  Non-numeric or
    non-finite metric values are skipped (the callback must never fail training).
    """

    def __init__(self, client_id: str = "client",
                 registry: MetricsRegistry | None = None) -> None:
        self._client_id = client_id
        reg = registry or get_registry()
        self._epochs = reg.counter(
            "nanofed_local_epochs_total", "Local training epochs completed",
            labels=("client",),
        )
        self._batches = reg.counter(
            "nanofed_local_batches_total", "Local training batches completed",
            labels=("client",),
        )
        self._last_loss = reg.gauge(
            "nanofed_local_last_loss", "Last epoch's training loss",
            labels=("client",),
        )
        self._last_accuracy = reg.gauge(
            "nanofed_local_last_accuracy", "Last epoch's training accuracy",
            labels=("client",),
        )
        self._loss_hist = reg.histogram(
            "nanofed_local_epoch_loss", "Per-epoch training loss distribution",
            labels=("client",),
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0),
        )

    @staticmethod
    def _finite(metrics: dict[str, Any], key: str) -> float | None:
        try:
            v = float(metrics.get(key))
        except (TypeError, ValueError):
            return None
        return v if math.isfinite(v) else None

    def on_epoch_end(self, epoch: int, metrics: dict[str, Any]) -> None:
        self._epochs.inc(client=self._client_id)
        loss = self._finite(metrics, "loss")
        if loss is not None:
            self._last_loss.set(loss, client=self._client_id)
            self._loss_hist.observe(loss, client=self._client_id)
        accuracy = self._finite(metrics, "accuracy")
        if accuracy is not None:
            self._last_accuracy.set(accuracy, client=self._client_id)

    def on_batch_end(self, epoch: int, batch: int, metrics: dict[str, Any]) -> None:
        self._batches.inc(client=self._client_id)


class MetricsLogger(BaseCallback):
    """JSON metrics file sink: accumulates epoch and batch metrics and rewrites one
    JSON file atomically once per epoch."""

    def __init__(self, path: str | Path, client_id: str = "client") -> None:
        self._path = Path(path)
        self._client_id = client_id
        self._epochs: list[dict[str, Any]] = []
        self._batches: list[dict[str, Any]] = []

    def on_batch_end(self, epoch: int, batch: int, metrics: dict[str, Any]) -> None:
        self._batches.append({"epoch": epoch, "batch": batch, **metrics})

    def on_epoch_end(self, epoch: int, metrics: dict[str, Any]) -> None:
        self._epochs.append({"epoch": epoch, **metrics})
        self._flush()

    def _flush(self) -> None:
        self._path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "client_id": self._client_id,
            "epochs": self._epochs,
            "batches": self._batches,
        }
        tmp = self._path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2))
        tmp.replace(self._path)
