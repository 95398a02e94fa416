"""Host-facing Trainer: the standalone single-client API (counterpart of
``nanofed_tpu/trainer/api.py``).

``Trainer.fit`` runs all local epochs of one client through ``make_local_fit`` (the
round's own fit, over a stack of one client), then replays the per-epoch and
per-batch metrics into the callbacks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ClientData, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.trainer.callbacks import Callback
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import (
    GradFn,
    LocalFitResult,
    client_keys,
    draw_permutations,
    make_evaluator,
    make_local_fit,
)
from nanofed_tpu_torch.utils.logger import Logger, log_exec


class Trainer:
    """Single-client trainer over a functional model, on ``device`` (default the card).

    >>> trainer = Trainer(model, TrainingConfig(batch_size=64, local_epochs=2))
    >>> params, metrics = trainer.fit(params, client_data, seed=0)
    """

    def __init__(
        self,
        model: Model,
        config: TrainingConfig,
        grad_fn: GradFn | None = None,
        callbacks: Sequence[Callback] = (),
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.callbacks = list(callbacks)
        # collect_batch_metrics feeds on_batch_end; force it on when callbacks exist.
        if self.callbacks and not config.collect_batch_metrics:
            self.config = dataclasses.replace(config, collect_batch_metrics=True)
        self._local_fit = make_local_fit(model, self.config, grad_fn=grad_fn)
        self._evaluate = make_evaluator(model, batch_size=self.config.batch_size)

    @log_exec(block=True)
    def fit(
        self,
        params: Params,
        data: ClientData,
        perms: torch.Tensor | None = None,
        keys: torch.Tensor | None = None,
        seed: int = 0,
    ) -> tuple[Params, dict[str, float]]:
        """Run all local epochs on one client's ``data`` (``[N, ...]``); returns the new
        params and the final epoch's metrics.  ``perms`` (``[E, N]``) and ``keys`` (the
        client's int32 key, a 0-d tensor) default to draws from ``seed``."""
        data = data.to(self.device)
        n = data.y.shape[0]
        if perms is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            perms = draw_permutations(gen, 1, self.config.local_epochs, n)[0]
        if keys is None:
            keys = client_keys(seed, 1, self.device)[0]
        result: LocalFitResult = self._local_fit(
            {name: p.to(self.device) for name, p in params.items()},
            ClientData(data.x[None], data.y[None], data.mask[None]),
            perms.to(self.device)[None],
            keys.to(self.device).reshape(1),
        )
        self._replay_callbacks(result)
        m = result.metrics
        return {name: p[0] for name, p in result.params.items()}, {
            "loss": float(m.loss[0]),
            "accuracy": float(m.accuracy[0]),
            "samples_processed": int(m.samples[0]),
        }

    def evaluate(self, params: Params, data: ClientData) -> dict[str, float]:
        out = self._evaluate(params, data.to(self.device))
        return {k: float(v) for k, v in out.items()}

    def _replay_callbacks(self, result: LocalFitResult) -> None:
        if not self.callbacks:
            return
        e_loss = np.asarray(result.epoch_loss[0].cpu())
        e_acc = np.asarray(result.epoch_accuracy[0].cpu())
        b_loss = np.asarray(result.batch_loss[0].cpu())
        log = Logger()
        with log.context("trainer"):
            for e in range(len(e_loss)):
                for cb in self.callbacks:
                    cb.on_epoch_start(e)
                if self.config.collect_batch_metrics:
                    for b in range(b_loss.shape[1]):
                        for cb in self.callbacks:
                            cb.on_batch_end(e, b, {"loss": float(b_loss[e, b])})
                for cb in self.callbacks:
                    cb.on_epoch_end(
                        e, {"loss": float(e_loss[e]), "accuracy": float(e_acc[e])}
                    )
                log.debug("epoch %d: loss=%.4f acc=%.4f", e, e_loss[e], e_acc[e])
