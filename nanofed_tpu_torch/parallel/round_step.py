"""The federated round on one device (counterpart of
``nanofed_tpu/parallel/round_step.py``, its single-device plain path).

One round: every client's local fit, the client deltas as one contiguous
``[k, P]`` float32 buffer in ravel order, each client's squared update norm (kernel
B3), the sample-weighted mean delta (kernel B1), and the server optimizer.  Two forms
of the reduce, as in the JAX package:

* materialised (``client_chunk`` unset): all clients fit at once and B1's normalised
  form reduces the ``[C, P]`` deltas;
* streamed (``client_chunk=k``): clients fit k at a time and B1's accumulate form
  folds each chunk into one running ``[P]`` sum, so memory scales with k and the
  ``[C, P]`` deltas never exist; the sum is divided by ``max(sum w, 1e-12)`` at the
  end.

A round with zero total weight (no participants) leaves params and server state
untouched.  The multi-GPU mesh, validation, robust aggregation and central DP come
with later slices.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from nanofed_tpu_torch.aggregation.base import Strategy, fedavg_strategy
from nanofed_tpu_torch.aggregation.fedavg import aggregate_metrics
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.ops.dp_reduce import row_sq_norms
from nanofed_tpu_torch.ops.reduce import weighted_mean_flat, weighted_sum_into
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import make_local_fit
from nanofed_tpu_torch.utils.trees import ravel, unravel


class RoundStepResult(NamedTuple):
    params: Params  # new global params
    server_opt_state: Any  # server optimizer state (flat [P] tensors)
    metrics: dict[str, torch.Tensor]  # weighted scalar metrics of the round
    client_metrics: ClientMetrics  # per-client [C] (for the round metrics JSON)
    update_sq_norms: torch.Tensor  # [C] squared L2 norm of each client's delta


RoundStepFn = Callable[..., RoundStepResult]


def client_deltas(stacked: Params, global_flat: torch.Tensor) -> torch.Tensor:
    """``params_k - global`` for stacked params ``[k, ...]`` as one ``[k, P]`` view in
    ravel order.  Rows are padded to a multiple of 4 floats so every row starts
    16-byte aligned and the kernels load ``float4``s."""
    k = next(iter(stacked.values())).shape[0]
    p = global_flat.numel()
    stride = -(-p // 4) * 4
    buf = torch.empty((k, stride), dtype=torch.float32, device=global_flat.device)
    offset = 0
    for leaf in stacked.values():
        n = leaf[0].numel()
        torch.sub(
            leaf.reshape(k, n), global_flat[offset : offset + n], out=buf[:, offset : offset + n]
        )
        offset += n
    return buf[:, :p]


def init_server_state(strategy: Strategy, global_params: Params) -> Any:
    return strategy.server_tx.init(ravel(global_params))


def build_round_step(
    model: Model,
    training: TrainingConfig,
    strategy: Strategy | None = None,
    client_chunk: int | None = None,
) -> RoundStepFn:
    """Returns ``round_step(global_params, server_opt_state, data, weights, perms,
    generator=None) -> RoundStepResult``.

    ``data`` is ``ClientData`` tensors ``[C, N, ...]`` on the device, ``weights`` is
    ``[C]`` float32 (sample counts x participation; zero drops a client),
    ``perms`` is ``[C, E, N]`` (see ``trainer.local.draw_permutations``) and
    ``generator`` draws the dropout masks.  ``client_chunk`` must divide C when it
    is smaller than C.  Initialise ``server_opt_state`` with
    :func:`init_server_state`.
    """
    strategy = strategy or fedavg_strategy()
    fit = make_local_fit(model, training)
    server_tx = strategy.server_tx

    def apply_server_update(gp_flat, like, sos, agg_delta, total_w):
        # The negative delta is the "gradient", so SGD(1.0) applies +delta exactly.
        if not bool(total_w > 0):
            return like, sos
        updates, new_sos = server_tx.update(-agg_delta, sos)
        return unravel(gp_flat + updates, like), new_sos

    def round_step(
        global_params: Params,
        server_opt_state: Any,
        data: ClientData,
        weights: torch.Tensor,
        perms: torch.Tensor,
        generator: torch.Generator | None = None,
    ) -> RoundStepResult:
        c = weights.shape[0]
        gp_flat = ravel(global_params)
        total_w = weights.sum()
        if client_chunk is not None and client_chunk < c:
            if c % client_chunk != 0:
                raise ValueError(f"client_chunk {client_chunk} must divide client count {c}")
            acc = torch.zeros_like(gp_flat)
            chunk_metrics, sq_norms = [], []
            for start in range(0, c, client_chunk):
                sl = slice(start, start + client_chunk)
                result = fit(global_params, data.select(sl), perms[sl], generator)
                chunk_metrics.append(result.metrics)
                delta = client_deltas(result.params, gp_flat)
                del result  # free the chunk's params before its reduce and the next fit
                sq_norms.append(row_sq_norms(delta))
                weighted_sum_into(acc, delta, weights[sl])
                del delta
            client_metrics = ClientMetrics(
                *(torch.cat(parts) for parts in zip(*chunk_metrics))
            )
            update_sq_norms = torch.cat(sq_norms)
            agg_delta = acc / torch.clamp(total_w, min=1e-12)
        else:
            result = fit(global_params, data, perms, generator)
            delta = client_deltas(result.params, gp_flat)
            client_metrics = result.metrics
            agg_delta = weighted_mean_flat(delta, weights)
            update_sq_norms = row_sq_norms(delta)
        new_params, new_sos = apply_server_update(
            gp_flat, global_params, server_opt_state, agg_delta, total_w
        )
        metrics = aggregate_metrics(client_metrics, weights)
        metrics["participating_clients"] = (weights > 0).sum()
        return RoundStepResult(new_params, new_sos, metrics, client_metrics, update_sq_norms)

    return round_step
