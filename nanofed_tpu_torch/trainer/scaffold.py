"""SCAFFOLD local training: control-variate-corrected SGD (counterpart of
``nanofed_tpu/trainer/scaffold.py``; Karimireddy et al. 2020).

Every local step is plain SGD on the corrected gradient,

    y  <-  y - eta_l * (grad f_i(y) + c - c_i),

with ``c - c_i`` formed once per fit.  After K real steps the client re-estimates its
control (option II, no extra gradient pass):

    dc_i  =  -c + (x - y) / (K * eta_l),        0 when K = 0.

Controls are flat: the server control ``c`` is a ``[P]`` vector and the clients'
controls are ``[k, P]`` rows, both in ravel order, and the fit returns ``dc_i`` as
``[k, P]`` rows, so the round step and the Coordinator keep the population's controls
as one ``[N, P]`` matrix on the device.  The batching and padding discipline is
``make_local_fit``'s (``trainer.local``, the same helper): a batch that is all padding
is a no-op and does not count toward K.  Momentum, weight decay and FedProx are
refused: option II estimates the mean local gradient only for plain SGD.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import (
    GradFn,
    _batched_grad,
    _epoch_batches,
    _epoch_metrics,
    _where_rows,
    make_grad_fn,
)
from nanofed_tpu_torch.utils.trees import ravel_stacked, unravel_stacked


class ScaffoldFitResult(NamedTuple):
    params: Params  # the clients' final local params y, stacked [k, ...]
    metrics: ClientMetrics  # [k], of the final epoch (the same contract as local_fit)
    delta_c: torch.Tensor  # [k, P] dc_i in ravel order (0 for a client without a real step)
    epoch_loss: torch.Tensor  # [k, E]
    epoch_accuracy: torch.Tensor  # [k, E]


def make_scaffold_local_fit(
    model: Model, config: TrainingConfig, grad_fn: GradFn | None = None,
) -> Callable[..., ScaffoldFitResult]:
    """Build ``fit(global_params, data, perms, c_global, c_client, keys=None,
    lr_scale=1.0)`` over ``[k]`` clients: ``c_global`` is the server control ``[P]``,
    ``c_client`` the clients' controls ``[k, P]``; the rest as ``make_local_fit``.
    ``lr_scale`` scales the SGD step and the control estimate's eta alike."""
    if config.momentum != 0.0 or config.weight_decay != 0.0:
        raise ValueError(
            "SCAFFOLD requires plain SGD locally: the option-II control update "
            "(x - y)/(K*eta) equals the mean local gradient only without momentum/"
            "weight decay — set TrainingConfig.momentum=0 and weight_decay=0"
        )
    if config.prox_mu != 0.0:
        raise ValueError(
            "prox_mu > 0 with SCAFFOLD would fold the proximal gradient into the "
            "control estimate — choose ONE drift remedy (FedProx via prox_mu on the "
            "standard path, or SCAFFOLD here)"
        )
    needs_key = bool(getattr(grad_fn, "needs_key", False))
    batched_grad = _batched_grad(
        grad_fn or make_grad_fn(model.apply, compute_dtype=config.compute_dtype))

    def scaffold_fit(
        global_params: Params,
        data: ClientData,
        perms: torch.Tensor,
        c_global: torch.Tensor,
        c_client: torch.Tensor,
        keys: torch.Tensor | None = None,
        lr_scale: float = 1.0,
    ) -> ScaffoldFitResult:
        k = data.y.shape[0]
        batches = _epoch_batches(model, config, data, perms, keys, needs_key)
        # c - c_i is constant over the fit (controls move once a round).
        correction = unravel_stacked(c_global[None] - c_client, global_params)
        eta = config.learning_rate * lr_scale
        params = {name: p.expand(k, *p.shape).clone() for name, p in global_params.items()}
        taken = torch.zeros(k, device=data.y.device)
        e_loss, e_acc = [], []
        for e in range(config.local_epochs):
            step_stats = []
            for b in batches(e):
                grads, stats = batched_grad(params, b)
                # A batch of pure padding is a no-op and does not count toward K.
                nonempty = stats.count > 0
                params = {
                    name: _where_rows(nonempty, p - eta * (grads[name] + correction[name]), p)
                    for name, p in params.items()
                }
                taken = taken + nonempty.float()
                step_stats.append(stats)
            loss, acc, _ = _epoch_metrics(step_stats, collect_batch=False)
            e_loss.append(loss)
            e_acc.append(acc)

        # Option II: dc_i = -c + (x - y) / (K * eta); a client with K = 0 keeps its control.
        k_eta = (torch.clamp(taken, min=1.0) * eta)[:, None]
        x_minus_y = ravel_stacked({name: g - params[name] for name, g in global_params.items()})
        delta_c = torch.where((taken > 0)[:, None], -c_global[None] + x_minus_y / k_eta,
                              torch.zeros((), device=c_global.device))
        return ScaffoldFitResult(
            params=params,
            metrics=ClientMetrics(loss=e_loss[-1], accuracy=e_acc[-1],
                                  samples=data.mask.sum(1)),
            delta_c=delta_c,
            epoch_loss=torch.stack(e_loss, 1),
            epoch_accuracy=torch.stack(e_acc, 1),
        )

    scaffold_fit.supports_lr_scale = True
    return scaffold_fit


def zero_controls(params: Params) -> torch.Tensor:
    """A fresh server control: ``[P]`` zeros on the params' device (round 1 with zero
    controls is uniform FedAvg)."""
    first = next(iter(params.values()))
    return torch.zeros(sum(p.numel() for p in params.values()), device=first.device)


def stack_zero_controls(params: Params, num_clients: int) -> torch.Tensor:
    """The population's client controls: ``[num_clients, P]`` zeros."""
    first = next(iter(params.values()))
    return torch.zeros((num_clients, sum(p.numel() for p in params.values())),
                       device=first.device)


__all__ = [
    "ScaffoldFitResult",
    "make_scaffold_local_fit",
    "stack_zero_controls",
    "zero_controls",
]
