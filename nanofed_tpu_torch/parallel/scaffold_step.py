"""The SCAFFOLD federated round on one device, or as one rank of a world (counterpart
of ``nanofed_tpu/parallel/scaffold_step.py``; on one device every psum is the
identity).

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

On a mesh (``mesh=``, ``parallel.mesh``) each rank fits its client rows with its rows
of the control stack; the uniform participant mean is B1 over the rank's rows divided
by the whole cohort's participant count, then one ``[P]`` all-reduce over the client
shards (host-local, then across hosts: ``MeshLayout.client_psum``), and the control
delta sum is B1's accumulate form over the rank's rows, then one ``[P]`` all-reduce.
With a model axis, params, the server state and ``c_global`` are this rank's model
shard: both are gathered once (``MeshLayout.gather_full``) for the fits, and the
aggregates are sliced back (``MeshLayout.slice_shard``) before the server update, as
the JAX ``layout.gather_full``/``slice_shard`` do; the control stack's rows stay
whole, sharded over the clients only.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from nanofed_tpu_torch.aggregation.base import Strategy, fedavg_strategy
from nanofed_tpu_torch.aggregation.fedavg import psum_weighted_mean, psum_weighted_metrics
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.ops.dp_reduce import row_sq_norms
from nanofed_tpu_torch.ops.reduce import weighted_mean_flat, weighted_sum_into
from nanofed_tpu_torch.parallel.mesh import Mesh, MeshLayout
from nanofed_tpu_torch.parallel.round_step import (
    _cat_metrics,
    _rows,
    apply_server_update,
    client_deltas,
)
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import GradFn
from nanofed_tpu_torch.trainer.scaffold import make_scaffold_local_fit
from nanofed_tpu_torch.utils.trees import ravel, unravel


class ScaffoldStepResult(NamedTuple):
    params: Params  # new global params (a rank's model shard on a mesh)
    server_opt_state: Any  # server optimizer state (flat [P] tensors, or the shard's)
    c_global: torch.Tensor  # updated server control [P] (or the shard's)
    delta_c: torch.Tensor  # [C, P] per-client control deltas (zero for non-participants);
    #                        on a mesh, this rank's rows
    metrics: dict[str, torch.Tensor]
    client_metrics: ClientMetrics  # per-client [C], the whole cohort's on every rank
    update_sq_norms: torch.Tensor  # [C], the whole cohort's on every rank


def build_scaffold_round_step(
    model: Model,
    training: TrainingConfig,
    num_clients_total: int,
    strategy: Strategy | None = None,
    grad_fn: GradFn | None = None,
    client_chunk: int | None = None,
    device: DeviceLike = None,
    mesh: Mesh | None = None,
    params_like: Params | None = None,
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
    when smaller.

    ``mesh`` makes the call this rank's part of the round (JAX ``build_scaffold_round_
    step`` on a mesh): ``c_stack``, ``data``, ``weights``, ``perms`` and ``keys`` are
    this rank's client rows (``parallel.mesh.client_slice``) and ``delta_c`` comes
    back for those rows; metrics, client metrics and update norms are the whole
    cohort's on every rank.  With a model axis ``params_like`` (the full params, or
    their shapes) is required, and ``global_params``, the server state and
    ``c_global`` are this rank's shard (``MeshLayout.shard_params``/``slice_shard``).
    The step runs on the mesh's device."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    server_tx = (strategy or fedavg_strategy()).server_tx
    fit = make_scaffold_local_fit(model, training, grad_fn=grad_fn)
    layout = None if mesh is None else MeshLayout(mesh, params_like)
    psum = (lambda x: x) if layout is None else layout.client_psum
    gather = (lambda x: x) if layout is None else layout.client_all_gather

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
        # Model axis: the fits read the full params and server control, gathered once;
        # the updates run on this rank's shards.
        shard_params = global_params
        cg_full = c_global
        if layout is not None and layout.model_sharded:
            global_params = layout.gather_full(shard_params)
            cg_full = ravel(layout.gather_full(unravel(c_global, shard_params)))
        gp_flat = ravel(global_params)
        shard_flat = gp_flat if global_params is shard_params else ravel(shard_params)
        if gp_flat.device.type not in (dev.type, "meta"):
            raise ValueError(f"the params are on {gp_flat.device}, the step runs on {dev}")
        at = gp_flat.device  # the step's device (``meta`` in the analysis' shape trace)
        k = client_chunk if client_chunk is not None and client_chunk < c else c
        if c % k != 0:
            raise ValueError(f"client_chunk {client_chunk} must divide client count {c}")
        p = gp_flat.numel()
        stride = -(-p // 4) * 4  # rows 16-byte aligned for the kernels
        dy_rows = torch.empty((c, stride), device=at)
        delta_y, delta_c = dy_rows[:, :p], torch.empty((c, stride), device=at)[:, :p]
        participating = (weights > 0).float()
        zero = torch.zeros((), device=at)
        chunk_metrics = []
        for start in range(0, c, k):
            sl = slice(start, start + k)
            result = fit(global_params, data.select(sl), perms[sl], cg_full, c_stack[sl],
                         _rows(keys, sl), lr_scale=lr_scale)
            client_deltas(result.params, gp_flat, out=dy_rows[sl])
            delta_c[sl] = torch.where(participating[sl, None] > 0, result.delta_c, zero)
            chunk_metrics.append(result.metrics)
            del result
        client_metrics = _cat_metrics(chunk_metrics)

        update_sq_norms = row_sq_norms(delta_y)  # B3
        # B1: the uniform participant mean (on a mesh, the rank's rows over the whole
        # cohort's participants, then one all-reduce).
        if layout is None:
            agg = weighted_mean_flat(delta_y, participating)
        else:
            agg = layout.slice_shard(psum_weighted_mean(delta_y, participating, layout))
        total_w = psum(weights.sum())
        new_params, new_sos = apply_server_update(
            server_tx, shard_flat, shard_params, server_opt_state, agg, total_w)
        c_sum = torch.zeros_like(gp_flat)
        weighted_sum_into(c_sum, delta_c, participating)  # B1: the participants' dc sum
        if layout is not None:
            c_sum = layout.slice_shard(psum(c_sum))
        # An empty round moves no control: the gate is a select on the device.
        new_c = torch.where(total_w > 0, c_global + c_sum / float(num_clients_total),
                            c_global)

        metrics = psum_weighted_metrics(client_metrics, weights, layout)
        metrics["participating_clients"] = psum((weights > 0).sum())
        return ScaffoldStepResult(new_params, new_sos, new_c, delta_c, metrics,
                                  ClientMetrics(*(gather(m) for m in client_metrics)),
                                  gather(update_sq_norms))

    return scaffold_step
