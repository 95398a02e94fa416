"""The federated round on one device, or as one rank of a world (counterpart of
``nanofed_tpu/parallel/round_step.py``: its single-device path, and with ``mesh=``
its ``build_sharded_round``).

One round: every client's local fit, the client deltas as one contiguous ``[k, P]``
float32 buffer in ravel order (rows padded to 4 floats), each client's squared update
norm (kernel B3), the aggregated delta, and the server optimizer.  Two forms of the
plain FedAvg reduce, as in the JAX package:

* materialised (``client_chunk`` unset): all clients fit at once and B1's normalised
  form reduces the ``[C, P]`` deltas;
* streamed (``client_chunk=k``): clients fit k at a time and B1's accumulate form
  folds each chunk into one running ``[P]`` sum, so memory scales with k and the
  ``[C, P]`` deltas never exist; the sum is divided by ``max(sum w, 1e-12)`` at the
  end.

The guarded rounds follow the JAX round line by line (on one device every psum is
the identity and every all-gather the input; on a mesh each is one collective over
the client shards, ``parallel.mesh.MeshLayout``):

* ``validation`` — per-client finiteness, per-leaf norm bound and a leave-one-out
  z-score zero the weights of invalid clients.  The deltas must materialise (the
  z-score needs every client), chunk by chunk into one buffer when ``client_chunk``
  is set.  The reduce is kernel B2, which sanitizes NaN and inf as it reads.
* ``central_privacy`` — DP-FedAvg: each delta clipped to C (coefficient
  ``min(1, C / (norm + 1e-12))`` from B3's norms, folded into B1's weights),
  a uniform mean over the participants, then noise of std σ·C/K from a standard
  ``[P]`` draw the caller passes (``noise``).  It streams under ``client_chunk``.
* ``robust`` — trimmed mean, coordinate median or Multi-Krum over the materialised
  deltas; the round's loss and accuracy are the same estimator over the client
  scalars, and a round below the method's floor leaves params untouched.

Frozen-base rounds (``frozen_base=FrozenBase(...)``, the adapters' hook): the
federated params are the small trainable tree (LoRA adapters) and the base model is
an extra read-only input of every call.  The per-client fit is built from
``frozen_base.bind(base)`` inside the call and closes over the base, which is not
stacked per client, gets no optimizer state and is never an output; every reduce
above then runs at the adapters' size.

Validation composes with DP and with robust aggregation: the buffer is then
sanitized in place before the clip or the sort (B1 would turn a NaN row into NaN even
at weight 0).  Robust aggregation together with central DP is refused.  A round with
zero total weight leaves params and server state untouched, by a select on the
device (``apply_server_update``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from nanofed_tpu_torch.aggregation.base import Strategy, fedavg_strategy
from nanofed_tpu_torch.aggregation.fedavg import (
    psum_weighted_mean,
    psum_weighted_metrics,
)
from nanofed_tpu_torch.aggregation.privacy import PrivacyAwareAggregationConfig
from nanofed_tpu_torch.aggregation.robust import RobustAggregationConfig, robust_aggregate
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.ops.dp_reduce import row_sq_norms
from nanofed_tpu_torch.ops.reduce import (
    masked_weighted_mean_flat,
    weighted_mean_flat,
    weighted_sum_into,
)
from nanofed_tpu_torch.parallel.mesh import Mesh, MeshLayout, sum_fn_of
from nanofed_tpu_torch.security.validation import (
    ValidationConfig,
    stacked_leaf_stats,
    validate_stats,
)
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import GradFn, make_local_fit
from nanofed_tpu_torch.utils.trees import ravel, unravel, unravel_stacked


class FrozenBase(NamedTuple):
    """A frozen base for the round (counterpart of the JAX ``FrozenBase``):
    ``bind(base)`` returns an apply with the zoo signature ``apply(trainable, x, *,
    dropout=None)`` closing over the base (for adapters, ``adapters.
    make_adapter_apply`` with the spec).  ``base_like`` names the base's leaves for a
    reader of shapes; the JAX package builds its mesh specs from it, and the round
    here reads only the base it is called with (it may be None)."""

    base_like: Params | None
    bind: Callable[[Params], Callable[..., torch.Tensor]]


class RoundStepResult(NamedTuple):
    params: Params  # new global params
    server_opt_state: Any  # server optimizer state (flat [P] tensors)
    metrics: dict[str, torch.Tensor]  # weighted scalar metrics of the round
    client_metrics: ClientMetrics  # per-client [C] (for the round metrics JSON)
    update_sq_norms: torch.Tensor  # [C] squared L2 norm of each client's delta


RoundStepFn = Callable[..., RoundStepResult]


def client_deltas(
    stacked: Params, global_flat: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """``params_k - global`` for stacked params ``[k, ...]`` as one ``[k, P]`` view in
    ravel order, written into ``out`` (``[k, stride]``, rows contiguous) when given.
    Rows are padded to a multiple of 4 floats so every row starts 16-byte aligned and
    the kernels load ``float4``s."""
    k = next(iter(stacked.values())).shape[0]
    p = global_flat.numel()
    if out is None:
        out = torch.empty((k, -(-p // 4) * 4), dtype=torch.float32, device=global_flat.device)
    offset = 0
    for leaf in stacked.values():
        n = leaf[0].numel()
        torch.sub(
            leaf.reshape(k, n), global_flat[offset : offset + n], out=out[:, offset : offset + n]
        )
        offset += n
    return out[:, :p]


def init_server_state(strategy: Strategy, global_params: Params) -> Any:
    return strategy.server_tx.init(ravel(global_params))


def apply_server_update(
    server_tx: Any, gp_flat: torch.Tensor, like: Params, sos: Any, agg_delta: torch.Tensor,
    total_w: torch.Tensor,
) -> tuple[Params, Any]:
    """The server optimizer's step on the aggregated delta: new params shaped like
    ``like`` and the new server state; with ``total_w`` 0 both are left as they are.
    The negative delta is the "gradient", so SGD(1.0) applies +delta exactly.

    The zero-weight identity is a select on the device, so the step never reads the
    device back: the server state's counters (Adam's ``count``, a schedule's
    ``schedule_count``) are 0-d int64 tensors on the device (``aggregation.base``),
    gated like the rest.  Only the checkpoint format turns them into ints
    (``utils.trees.to_numpy_server_state``)."""
    ok = total_w > 0
    updates, new_sos = server_tx.update(-agg_delta, sos)
    new_sos = {key: torch.where(ok, new, sos[key]) for key, new in new_sos.items()}
    return unravel(torch.where(ok, gp_flat + updates, gp_flat), like), new_sos


def _rows(t: torch.Tensor | None, sl: slice) -> torch.Tensor | None:
    return None if t is None else t[sl]


def _cat_metrics(parts: list[ClientMetrics]) -> ClientMetrics:
    return ClientMetrics(*(torch.cat(field) for field in zip(*parts)))


def build_round_step(
    model: Model,
    training: TrainingConfig,
    strategy: Strategy | None = None,
    client_chunk: int | None = None,
    grad_fn: GradFn | None = None,
    local_fit: Callable | None = None,
    central_privacy: PrivacyAwareAggregationConfig | None = None,
    validation: ValidationConfig | None = None,
    robust: RobustAggregationConfig | None = None,
    frozen_base: FrozenBase | None = None,
    mesh: Mesh | None = None,
    params_like: Params | None = None,
) -> RoundStepFn:
    """Returns ``round_step(global_params, server_opt_state, data, weights, perms,
    keys=None, noise=None, lr_scale=1.0) -> RoundStepResult``; with ``frozen_base``,
    ``round_step(global_params, server_opt_state, base_params, data, weights, perms,
    keys=None, noise=None, lr_scale=1.0)`` (the JAX ``adapter_round_step``: the base
    is the third argument, and ``global_params`` the trainable tree).

    ``data`` is ``ClientData`` tensors ``[C, N, ...]`` on the device, ``weights`` is
    ``[C]`` float32 (sample counts x participation; zero drops a client), ``perms``
    is ``[C, E, N]`` (``trainer.local.draw_permutations``), ``keys`` the clients'
    ``[C]`` int32 dropout keys (``trainer.local.client_keys``; needed when the model
    has dropout) and ``noise`` a standard ``[P]`` draw (unit Gaussian or Laplace,
    as the privacy config's noise type says; needed under ``central_privacy``).
    ``lr_scale`` (the round's lr-schedule scale, ``trainer.schedules``) multiplies
    every local step.
    ``client_chunk`` must divide C when it is smaller than C.  ``local_fit``
    replaces the default fit (same signature as ``trainer.local.make_local_fit``'s);
    ``grad_fn`` builds the default fit with another gradient; passing both is
    refused.  Initialise ``server_opt_state`` with :func:`init_server_state`.

    ``mesh`` (``parallel.mesh.make_mesh``) makes the call this rank's part of the
    round spread over a world of ranks (JAX ``build_sharded_round``): ``data``,
    ``weights``, ``perms`` and ``keys`` are this rank's client rows
    (``parallel.mesh.client_slice``), ``noise`` the whole round's one draw, the same
    on every rank.  Every reduce is the rank's local contraction followed by an
    all-reduce over the client shards (host-local, then across hosts); robust
    aggregation all-gathers the deltas instead.  The round's metrics, and the
    all-gathered ``[C]`` client metrics and update norms, are the whole cohort's on
    every rank.  With a model axis, ``params_like`` (the full params, or anything
    with their shapes) is required: ``global_params`` and the server state are this
    rank's shard (``MeshLayout.shard_params``), gathered once before the fits, and
    the server update runs on the shard of the aggregate.  A frozen base is sharded
    and gathered the same way (``frozen_base.base_like`` gives its full shapes).
    Without ``mesh`` the call is the one-device round, unchanged.
    """
    if robust is not None and central_privacy is not None:
        raise ValueError(
            "robust= cannot be combined with central_privacy=: the DP guarantee is "
            "calibrated for the clipped uniform MEAN (sensitivity C/K); a trimmed "
            "mean has a different sensitivity and the stated budget would be wrong"
        )
    if local_fit is not None and grad_fn is not None:
        raise ValueError(
            "pass either grad_fn (used to build the default local fit) or a complete "
            "local_fit, not both — a supplied local_fit ignores grad_fn"
        )
    if frozen_base is not None and (local_fit is not None or grad_fn is not None):
        # The bound apply exists only inside the call (it closes over the base), so a
        # build-time fit or gradient could never see the base it needs.
        raise ValueError(
            "frozen_base= builds the local fit from bind(gathered_base) "
            "inside the round body; a custom local_fit/grad_fn cannot "
            "close over the base and is refused"
        )
    strategy = strategy or fedavg_strategy()
    layout = None if mesh is None else MeshLayout(mesh, params_like)
    base_layout = None
    if layout is not None and frozen_base is not None and layout.model_sharded:
        if frozen_base.base_like is None:
            raise ValueError("a model-sharded frozen base needs frozen_base.base_like= "
                             "(the full base's shapes)")
        base_layout = MeshLayout(mesh, frozen_base.base_like)
    psum = (lambda x: x) if layout is None else layout.client_psum
    gather = (lambda x: x) if layout is None else layout.client_all_gather
    dense_fit = None if frozen_base is not None else (
        local_fit or make_local_fit(model, training, grad_fn=grad_fn))
    server_tx = strategy.server_tx

    def clip_coefs(sq_norms: torch.Tensor) -> torch.Tensor:
        """Per-client clip to the central-DP bound C: ``min(1, C / (norm + 1e-12))``
        (the round's ``tree_clip_by_global_norm``)."""
        clip = central_privacy.privacy.max_gradient_norm
        return torch.clamp(clip / (torch.sqrt(sq_norms) + 1e-12), max=1.0)

    def add_central_noise(agg: torch.Tensor, noise: torch.Tensor, participants: torch.Tensor):
        p = central_privacy.privacy
        return agg + noise * (p.noise_multiplier * p.max_gradient_norm / participants)

    def streamed(fit, global_params, gp_flat, data, weights, perms, keys, noise, lr_scale):
        """Fold each chunk's weighted delta sum into one ``[P]`` accumulator."""
        acc = torch.zeros_like(gp_flat)
        chunk_metrics, sq_norms = [], []
        for start in range(0, weights.shape[0], client_chunk):
            sl = slice(start, start + client_chunk)
            result = fit(global_params, data.select(sl), perms[sl], _rows(keys, sl),
                         lr_scale=lr_scale)
            chunk_metrics.append(result.metrics)
            delta = client_deltas(result.params, gp_flat)
            del result  # free the chunk's params before its reduce and the next fit
            sq = row_sq_norms(delta)
            if central_privacy is not None:
                # Clip, then uniform weights over participants (the clip rides in
                # the weights); the reported norms are the clipped ones.
                coef = clip_coefs(sq)
                w = (weights[sl] > 0).float() * coef
                sq = coef.square() * sq
            else:
                w = weights[sl]
            weighted_sum_into(acc, delta, w)
            sq_norms.append(sq)
            del delta
        acc = psum(acc)  # the one [P] all-reduce of a streamed round
        if central_privacy is not None:
            participants = torch.clamp(psum((weights > 0).sum().float()), min=1.0)
            agg = add_central_noise(acc / participants, noise, participants)
        else:
            agg = acc / torch.clamp(psum(weights.sum()), min=1e-12)
        return agg, _cat_metrics(chunk_metrics), torch.cat(sq_norms)

    def fit_materialised(fit, global_params, gp_flat, data, perms, keys, lr_scale):
        """Every client's delta in one ``[C, stride]`` buffer, chunk by chunk."""
        c = perms.shape[0]
        k = client_chunk if client_chunk is not None and client_chunk < c else c
        p = gp_flat.numel()
        buf = torch.empty((c, -(-p // 4) * 4), dtype=torch.float32, device=gp_flat.device)
        chunk_metrics = []
        for start in range(0, c, k):
            sl = slice(start, start + k)
            result = fit(global_params, data.select(sl), perms[sl], _rows(keys, sl),
                         lr_scale=lr_scale)
            client_deltas(result.params, gp_flat, out=buf[sl])
            chunk_metrics.append(result.metrics)
            del result
        return buf[:, :p], _cat_metrics(chunk_metrics)

    def finish(client_metrics, update_sq_norms) -> tuple[ClientMetrics, torch.Tensor]:
        """The whole cohort's per-client rows on every rank."""
        return ClientMetrics(*(gather(m) for m in client_metrics)), gather(update_sq_norms)

    def run_round(fit, shard_params, server_opt_state, data, weights, perms, keys, noise,
                  lr_scale) -> RoundStepResult:
        # Model axis: the fits read full params, gathered once; the server update
        # runs on this rank's shard.
        global_params = shard_params if layout is None else layout.gather_full(shard_params)
        c = weights.shape[0]
        gp_flat = ravel(global_params)
        shard_flat = gp_flat if global_params is shard_params else ravel(shard_params)

        def server_update(agg, total_w):
            if layout is not None:
                agg = layout.slice_shard(agg)
            return apply_server_update(server_tx, shard_flat, shard_params,
                                       server_opt_state, agg, total_w)

        if central_privacy is not None and (noise is None or noise.shape != gp_flat.shape):
            raise ValueError(f"central_privacy needs noise=, a standard [{gp_flat.numel()}] draw")
        chunking = client_chunk is not None and client_chunk < c
        if chunking and c % client_chunk != 0:
            raise ValueError(f"client_chunk {client_chunk} must divide client count {c}")

        if chunking and validation is None and robust is None:
            agg, client_metrics, update_sq_norms = streamed(
                fit, global_params, gp_flat, data, weights, perms, keys, noise, lr_scale
            )
            new_params, new_sos = server_update(agg, psum(weights.sum()))
            metrics = psum_weighted_metrics(client_metrics, weights, layout)
            metrics["participating_clients"] = psum((weights > 0).sum())
            return RoundStepResult(new_params, new_sos, metrics,
                                   *finish(client_metrics, update_sq_norms))

        delta, client_metrics = fit_materialised(fit, global_params, gp_flat, data, perms,
                                                 keys, lr_scale)
        update_sq_norms = None
        if validation is not None:
            # Checks on the client DELTA: range per leaf, z-score on the global norm.
            # Sanitize the buffer itself only where a later pass would read the NaNs
            # (the clip's B1, the robust sort); B2 sanitizes as it reads.
            participating = weights > 0
            stats = stacked_leaf_stats(
                unravel_stacked(delta, global_params),
                sanitize_in_place=central_privacy is not None or robust is not None,
            )
            valid = validate_stats(stats, validation, participating,
                                   sum_fn=sum_fn_of(layout)).valid
            weights_in = weights
            weights = weights * valid.float()
            # A rejected client's metrics may be NaN: zero its whole row.
            client_metrics = ClientMetrics(
                *(torch.where(valid, m, torch.zeros_like(m)) for m in client_metrics)
            )
            update_sq_norms = stats.leaf_sq.sum(0)  # the sanitized norms

        total_w = psum(weights.sum())
        robust_kept = None
        if robust is not None:
            # Order statistics need every client's delta on every rank.
            part = gather((weights > 0).float())
            agg, ok, robust_kept = robust_aggregate(robust, gather(delta), part,
                                                    global_params)
            total_w = total_w * ok  # below the floor: params and server state untouched
            if update_sq_norms is None:
                update_sq_norms = row_sq_norms(delta)
        elif central_privacy is not None:
            if update_sq_norms is None:
                update_sq_norms = row_sq_norms(delta)
            coef = clip_coefs(update_sq_norms)
            uniform = (weights > 0).float()
            participants = psum(uniform.sum())
            agg = psum(weighted_mean_flat(delta, uniform * coef, denom=participants))
            agg = add_central_noise(agg, noise, torch.clamp(participants, min=1.0))
            update_sq_norms = coef.square() * update_sq_norms  # of the clipped deltas
        elif validation is not None:
            if layout is None:
                agg = masked_weighted_mean_flat(delta, weights_in, valid)  # kernel B2
            else:
                # B2 divided by the whole cohort's valid weight, then summed over ranks.
                agg = psum(masked_weighted_mean_flat(delta, weights_in, valid,
                                                     denom=total_w))
        else:
            if layout is None:
                agg = weighted_mean_flat(delta, weights)
            else:
                agg = psum_weighted_mean(delta, weights, layout)
            update_sq_norms = row_sq_norms(delta)
        new_params, new_sos = server_update(agg, total_w)

        metrics = psum_weighted_metrics(client_metrics, weights, layout)
        if robust_kept is not None:
            # The reported loss and accuracy are the same estimator over the client
            # scalars: a NaN loss of a trimmed client must not ride the weighted mean.
            scalars = gather(torch.stack([client_metrics.accuracy, client_metrics.loss], 1))
            like = {"accuracy": scalars[0, 0], "loss": scalars[0, 1]}
            robust_scalars, _, _ = robust_aggregate(robust, scalars, part, like)
            metrics["accuracy"], metrics["loss"] = robust_scalars[0], robust_scalars[1]
            metrics["robust_kept_clients"] = robust_kept
        if validation is not None:
            # participating = the PRE-validation cohort; valid = those that survived.
            metrics["participating_clients"] = psum(participating.sum())
            metrics["valid_clients"] = psum((valid & participating).sum())
        else:
            metrics["participating_clients"] = psum((weights > 0).sum())
        return RoundStepResult(new_params, new_sos, metrics,
                               *finish(client_metrics, update_sq_norms))

    if frozen_base is None:
        def round_step(
            global_params: Params,
            server_opt_state: Any,
            data: ClientData,
            weights: torch.Tensor,
            perms: torch.Tensor,
            keys: torch.Tensor | None = None,
            noise: torch.Tensor | None = None,
            lr_scale: float = 1.0,
        ) -> RoundStepResult:
            return run_round(dense_fit, global_params, server_opt_state, data, weights,
                             perms, keys, noise, lr_scale)

        return round_step

    def adapter_round_step(
        global_params: Params,
        server_opt_state: Any,
        base_params: Params,
        data: ClientData,
        weights: torch.Tensor,
        perms: torch.Tensor,
        keys: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        lr_scale: float = 1.0,
    ) -> RoundStepResult:
        # The base is read only: closed over by this call's fit, never stacked per
        # client, never an output.  A model-sharded base is gathered once a call.
        if base_layout is not None:
            base_params = base_layout.gather_full(base_params)
        bound = dataclasses.replace(model, apply=frozen_base.bind(base_params))
        return run_round(make_local_fit(bound, training), global_params, server_opt_state,
                         data, weights, perms, keys, noise, lr_scale)

    return adapter_round_step
