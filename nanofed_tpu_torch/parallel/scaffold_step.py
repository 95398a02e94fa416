"""The SCAFFOLD federated round on one device (counterpart of
``nanofed_tpu/parallel/scaffold_step.py``; on one device every psum is the identity).

Per round (Karimireddy et al. 2020, Alg. 1):

* every client's corrected fit (``trainer.scaffold``), chunk by chunk under
  ``client_chunk``: its ``delta y_i`` lands in a ``[C, P]`` buffer and its ``dc_i`` in
  another, zeroed outside the cohort;
* the model moves by the server optimizer on the uniform participant mean of
  ``delta y``: kernel B1's normalised form over ``[C, P]`` with 0/1 weights (sample
  weighting would re-bias the drift the controls remove);
* the server control moves by ``sum_participants dc_i / N_total``: B1's accumulate
  form over the ``[C, P]`` ``dc`` rows into a ``[P]`` zero, divided by the real
  population N_total (not the padded stack);
* each client's ``update_sq_norms`` is kernel B3 over ``delta y``.

The reduces run once over the whole ``[C, P]`` buffers after the last chunk, so the
summation order does not depend on ``client_chunk``: a chunked round equals the
unchunked one bit for bit on one device (the JAX package has no streamed SCAFFOLD
either, since the ``[C, P]`` ``dc`` output exists anyway).  A round with total weight
0 moves neither the model, the server state nor the server control.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from nanofed_tpu_torch.aggregation.base import Strategy, fedavg_strategy
from nanofed_tpu_torch.aggregation.fedavg import aggregate_metrics
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.ops.dp_reduce import row_sq_norms
from nanofed_tpu_torch.ops.reduce import weighted_mean_flat, weighted_sum_into
from nanofed_tpu_torch.parallel.round_step import (
    _cat_metrics,
    _rows,
    apply_server_update,
    client_deltas,
)
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import GradFn
from nanofed_tpu_torch.trainer.scaffold import make_scaffold_local_fit
from nanofed_tpu_torch.utils.trees import ravel


class ScaffoldStepResult(NamedTuple):
    params: Params  # new global params
    server_opt_state: Any  # server optimizer state (flat [P] tensors)
    c_global: torch.Tensor  # updated server control [P]
    delta_c: torch.Tensor  # [C, P] per-client control deltas (zero for non-participants)
    metrics: dict[str, torch.Tensor]
    client_metrics: ClientMetrics  # per-client [C]
    update_sq_norms: torch.Tensor  # [C]


def build_scaffold_round_step(
    model: Model,
    training: TrainingConfig,
    num_clients_total: int,
    strategy: Strategy | None = None,
    grad_fn: GradFn | None = None,
    client_chunk: int | None = None,
    device: DeviceLike = None,
) -> Callable[..., ScaffoldStepResult]:
    """Returns ``scaffold_step(global_params, server_opt_state, c_global, c_stack,
    data, weights, perms, keys=None, lr_scale=1.0) -> ScaffoldStepResult`` on
    ``device`` (default the card).

    ``c_global`` is the server control ``[P]``, ``c_stack`` the step's clients'
    controls ``[C, P]`` (the Coordinator gathers a cohort's rows and scatter-adds the
    returned ``delta_c``); ``data``, ``weights``, ``perms`` and ``keys`` are as for
    ``build_round_step``.  ``weights`` (sample counts x participation) weight the
    reported metrics; the model aggregate is the uniform participant mean.
    ``num_clients_total`` is the real population N.  ``client_chunk`` must divide C
    when smaller."""
    dev = resolve_device(device)
    server_tx = (strategy or fedavg_strategy()).server_tx
    fit = make_scaffold_local_fit(model, training, grad_fn=grad_fn)

    def scaffold_step(
        global_params: Params,
        server_opt_state: Any,
        c_global: torch.Tensor,
        c_stack: torch.Tensor,
        data: ClientData,
        weights: torch.Tensor,
        perms: torch.Tensor,
        keys: torch.Tensor | None = None,
        lr_scale: float = 1.0,
    ) -> ScaffoldStepResult:
        c = weights.shape[0]
        gp_flat = ravel(global_params)
        if gp_flat.device.type != dev.type:
            raise ValueError(f"the params are on {gp_flat.device}, the step runs on {dev}")
        k = client_chunk if client_chunk is not None and client_chunk < c else c
        if c % k != 0:
            raise ValueError(f"client_chunk {client_chunk} must divide client count {c}")
        p = gp_flat.numel()
        stride = -(-p // 4) * 4  # rows 16-byte aligned for the kernels
        dy_rows = torch.empty((c, stride), device=dev)
        delta_y, delta_c = dy_rows[:, :p], torch.empty((c, stride), device=dev)[:, :p]
        participating = (weights > 0).float()
        zero = torch.zeros((), device=dev)
        chunk_metrics = []
        for start in range(0, c, k):
            sl = slice(start, start + k)
            result = fit(global_params, data.select(sl), perms[sl], c_global, c_stack[sl],
                         _rows(keys, sl), lr_scale=lr_scale)
            client_deltas(result.params, gp_flat, out=dy_rows[sl])
            delta_c[sl] = torch.where(participating[sl, None] > 0, result.delta_c, zero)
            chunk_metrics.append(result.metrics)
            del result
        client_metrics = _cat_metrics(chunk_metrics)

        update_sq_norms = row_sq_norms(delta_y)  # B3
        agg = weighted_mean_flat(delta_y, participating)  # B1: the uniform participant mean
        total_w = weights.sum()
        new_params, new_sos = apply_server_update(
            server_tx, gp_flat, global_params, server_opt_state, agg, total_w)
        c_sum = torch.zeros_like(c_global)
        weighted_sum_into(c_sum, delta_c, participating)  # B1: the participants' dc sum
        new_c = c_global + c_sum / float(num_clients_total) if bool(total_w > 0) else c_global

        metrics = aggregate_metrics(client_metrics, weights)
        metrics["participating_clients"] = (weights > 0).sum()
        return ScaffoldStepResult(new_params, new_sos, new_c, delta_c, metrics,
                                  client_metrics, update_sq_norms)

    return scaffold_step
