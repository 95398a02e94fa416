"""Fused multi-round blocks on one device (counterpart of
``nanofed_tpu/parallel/multi_round.py``).

The JAX package scans R rounds inside one jitted program so the host pays its
dispatch, barrier and metrics transfer once a block.  PyTorch runs eagerly, so here a
block is a host loop over R rounds that enqueues every round's work on the device and
never reads a device value back between rounds: the completion gate, the zero-weight
identity and the server optimizer's counters are device values, and the per-round
metrics are stacked on the device and cross to the host once, after the block.

``build_round_block`` calls the round step ``parallel.round_step.build_round_step``
builds, with the same closures, so the fused and single-round paths cannot drift:

* per-round cohorts arrive as stacked ``[R, K]`` index and mask tensors (the
  ``Coordinator`` path: cohorts are a host function of the seed, so a fused run
  reproduces the single-round run) or are resampled on the device each round when
  none are passed (a ``torch.randperm`` without replacement, then simulated dropout);
* each round draws its permutations and dropout keys as the coordinator's
  ``_train_round`` does, from the round seed ``seed * 100_003 + r`` (:func:`round_seeds`),
  and gathers the cohort's data, permutations and keys by client id;
* the lr schedule rides as ``[R]`` host floats (``trainer.schedules``).

With ``frozen_base`` (adapters) the base is a loop-invariant input of the block,
passed once and handed to every round; the carry from round to round is the
adapter-sized params and server state only.

A round whose surviving cohort falls below ``min_completion_rate`` is gated to zero
total weight on the device, which the round step defines as the identity for params
AND server state.  Its training still runs, as it does in the JAX block.

Stated difference: on-device resampling draws from Philox generators seeded from the
round seed and the JAX salts, where the JAX block folds the salts into a Threefry key,
so the sampled ids differ from the JAX block's; they are valid, deterministic draws
(``tests/test_torch_multi_round.py``).

On a mesh with a hosts axis a rank holds only its host's rows of the population, while
an on-device cohort is one global draw (the JAX block gathers the cohort's rows
wherever they live and re-lays them in the joint (hosts, clients) layout).  So each
round the ranks of a hosts line (one rank a host, the same client coordinate) run one
all-gather: every rank packs, for the line's slots, the bytes of the data rows
(``x``, ``y``, ``mask``) its host holds and zeros elsewhere, and takes its own slots'
rows from the host that holds each.  The pack is sized by the slots, not by the draw,
so nothing is read back to the host.  A slot's permutation, dropout key and sample
count are functions of its client id on every rank already, so a fused round trains
each client as the single-round draw does (stated difference: one exchange a round,
``round_block.cohort_exchange_bytes`` received by each rank).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch

from nanofed_tpu_torch.aggregation.base import Strategy
from nanofed_tpu_torch.aggregation.fedavg import compute_weights
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    HOST_AXIS,
    Mesh,
    MeshLayout,
    client_shard_count,
    client_slice,
    host_axis_size,
    host_client_slice,
)
from nanofed_tpu_torch.parallel.round_step import FrozenBase, build_round_step
from nanofed_tpu_torch.security.validation import ValidationConfig
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import GradFn, client_keys, draw_permutations

# Salts mixed into the round seed for on-device sampling (the JAX block's), so the
# cohort draw, the dropout draw and the round's training draws are separate streams.
_COHORT_SALT = 0xC0F0
_DROPOUT_SALT = 0xD409
_MASK64 = (1 << 64) - 1


class RoundBlockResult(NamedTuple):
    """Stacked outcome of one R-round block; the leading axis of every stacked field
    is the round within the block."""

    params: Params  # end-of-block global params
    server_opt_state: Any  # end-of-block server state (counters 0-d on the device)
    metrics: dict[str, torch.Tensor]  # weighted scalar metrics per round, each [R]
    survivors: torch.Tensor  # [R] int32: surviving sampled clients per round
    client_metrics: ClientMetrics | None  # [R, K] (None unless collect_client_detail)
    update_sq_norms: torch.Tensor | None  # [R, K]
    weights: torch.Tensor | None  # [R, K] realized aggregation weights
    cohort_ids: torch.Tensor | None  # [R, K] sampled client ids (device sampling only)


RoundBlockFn = Callable[..., RoundBlockResult]


def round_seeds(seed: int, round_ids: Sequence[int]) -> list[int]:
    """The ``[R]`` per-round seeds a block consumes: ``seed * 100_003 + r`` for each
    round id, the single-round coordinator's round seed (the counterpart of
    ``stack_round_keys``), so fused and single-round runs draw the same."""
    return [seed * 100_003 + int(r) for r in round_ids]


def _salted(seed: int, salt: int) -> int:
    """A 63-bit generator seed from a round seed and a salt (splitmix64's finalizer)."""
    z = (seed * 0x9E3779B97F4A7C15 + salt) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def pad_permutations(perms: torch.Tensor, rows: int) -> torch.Tensor:
    """The population's ``[C, E, N]`` permutations with padding clients' rows
    (identity orders; a padding client has no samples) up to ``rows``: the real
    clients' rows are drawn for the real population alone, so padding to a mesh's
    client shards leaves every client's draws as on one device."""
    extra = rows - perms.shape[0]
    if extra == 0:
        return perms
    ident = torch.arange(perms.shape[-1], device=perms.device).expand(
        extra, *perms.shape[1:])
    return torch.cat([perms, ident])


def _stack_metrics(parts: list[ClientMetrics]) -> ClientMetrics:
    return ClientMetrics(*(torch.stack(field) for field in zip(*parts)))


def build_round_block(
    model: Model,
    training: TrainingConfig,
    strategy: Strategy | None = None,
    *,
    num_clients: int,
    padded_clients: int | None = None,
    step_clients: int | None = None,
    cohort_size: int | None = None,
    dropout_rate: float = 0.0,
    min_completion_rate: float = 0.5,
    grad_fn: GradFn | None = None,
    local_fit: Callable | None = None,
    validation: ValidationConfig | None = None,
    client_chunk: int | None = None,
    collect_client_detail: bool = True,
    cohort_mode: bool | None = None,
    device: DeviceLike = None,
    frozen_base: FrozenBase | None = None,
    scaffold: bool = False,
    robust: Any = None,
    central_privacy: Any = None,
    mesh: Mesh | None = None,
    params_like: Params | None = None,
) -> RoundBlockFn:
    """Build the R-round block function.

    Returns ``round_block(global_params, server_opt_state, data, num_samples,
    round_seeds, lr_scales, cohort_idx=None, cohort_mask=None, perms=None,
    keys=None, base_params=None) -> RoundBlockResult`` where

    * ``data`` is the whole population's ``ClientData`` (``[C_pad, N, ...]`` on
      ``device``) and ``num_samples`` its ``[C_pad]`` sample counts;
    * ``round_seeds`` are the ``[R]`` round seeds (:func:`round_seeds`) and
      ``lr_scales`` the ``[R]`` schedule scales, host ints and floats;
    * ``cohort_idx``/``cohort_mask`` (``[R, step_clients]`` on ``device``) carry
      host-sampled cohorts (client id per slot, survivor mask).  Pass both or
      neither: with neither, each round resamples its cohort on the device;
    * ``perms`` (``[R, C_pad, E, N]``) and ``keys`` (``[R, C_pad]`` int32) replace the
      rounds' drawn permutations and dropout keys, per client id (gathered like the
      drawn ones); tests inject the JAX package's permutations this way;
    * ``base_params`` is the frozen base, passed exactly when the block was built with
      ``frozen_base`` (every round reads it; no round writes it).

    ``num_clients`` is the population, ``padded_clients`` the data's rows (default
    ``num_clients``), ``step_clients`` the round step's width (default
    ``padded_clients``) and ``cohort_size`` the sampled K (default ``num_clients``).
    ``cohort_mode`` is the JAX builder's: True gathers the cohort's rows (slot-ordered
    mask), False runs the whole population (client-id-ordered mask over
    ``step_clients == padded_clients`` slots); it defaults to "a strict subset is
    sampled or stepped".  ``validation`` and ``client_chunk`` are the round step's.

    ``mesh`` and ``params_like`` make every round the round step's sharded form
    (``build_round_step(..., mesh=)``), so the block shares its collectives.  Then
    ``data`` holds this rank's HOST rows of the population
    (``parallel.mesh.host_client_slice``), ``num_samples`` stays the whole
    population's, cohorts stay whole (``[R, step_clients]``, every rank the same) and
    each rank trains its slot segment (``parallel.mesh.client_slice``); the stacked
    per-client detail is the whole cohort's on every rank.  On-device resampling draws
    the same ids on every rank (the same seeds on the same device type); over a hosts
    axis each round's slots fetch their clients' rows from the hosts that hold them
    in one all-gather (see the module note).
    The JAX builder's ``axis_name`` and ``donate`` have no meaning here and are not
    taken.  ``frozen_base`` is the round step's.
    SCAFFOLD, robust aggregation and central DP are not fused, as in the JAX package,
    and raise ``ValueError``: they run on the single-round path.
    """
    unfused = [name for name, active in (
        ("SCAFFOLD", scaffold), ("robust aggregation", robust is not None),
        ("central DP", central_privacy is not None)) if active]
    if unfused:
        raise ValueError(
            f"{' + '.join(unfused)} is not fused (as in the JAX package): run it on the "
            "single-round path (parallel.build_round_step)"
        )
    dev = resolve_device(device)
    padded_clients = num_clients if padded_clients is None else padded_clients
    step_clients = padded_clients if step_clients is None else step_clients
    cohort_size = num_clients if cohort_size is None else cohort_size
    if not 0 < num_clients <= padded_clients:
        raise ValueError("need 0 < num_clients <= padded_clients")
    if not 0 < step_clients <= padded_clients:
        raise ValueError("need 0 < step_clients <= padded_clients")
    if not 0 < cohort_size <= min(num_clients, step_clients):
        raise ValueError("need 0 < cohort_size <= min(num_clients, step_clients)")
    if cohort_mode is None:
        cohort_mode = cohort_size < num_clients or step_clients < padded_clients
    if not cohort_mode and step_clients != padded_clients:
        raise ValueError(
            "cohort_mode=False runs the full population: step_clients must equal "
            f"padded_clients (got {step_clients} != {padded_clients})"
        )
    # Local import: orchestration imports parallel at module level.
    from nanofed_tpu_torch.orchestration.engine import completion_required

    required = completion_required(cohort_size, min_completion_rate)
    step = build_round_step(
        model, training, strategy, client_chunk=client_chunk, grad_fn=grad_fn,
        local_fit=local_fit, validation=validation, frozen_base=frozen_base,
        mesh=mesh, params_like=params_like,
    )
    # This rank's slots of the step and the first population row it holds.
    if mesh is None:
        slots, row0 = slice(0, step_clients), 0
    else:
        shards = client_shard_count(mesh)
        if step_clients % shards or padded_clients % host_axis_size(mesh):
            raise ValueError(
                f"step_clients {step_clients} and padded_clients {padded_clients} must "
                f"divide over the mesh's {shards} client shards (pad_client_count)")
        slots = slice(*client_slice(step_clients, mesh))
        row0 = host_client_slice(padded_clients, mesh)[0]
    exchange = mesh is not None and host_axis_size(mesh) > 1 and cohort_mode
    if exchange:
        # The hosts line's slots: the segment of client coordinate c on every host.
        n_hosts, n_cli = mesh.dims[0], mesh.dims[1]
        per = step_clients // (n_hosts * n_cli)
        c = mesh.coords[CLIENT_AXIS]
        line_slots = torch.cat([
            torch.arange((h * n_cli + c) * per, (h * n_cli + c + 1) * per)
            for h in range(n_hosts)]).to(dev)
        rows_per_host = padded_clients // n_hosts
        host = mesh.coords[HOST_AXIS]
        hosts_line = MeshLayout(mesh, params_like)
    epochs = training.local_epochs

    def data_bytes(data: ClientData) -> tuple[torch.Tensor, list]:
        """The host's rows as one ``[rows, bytes]`` uint8 matrix, and how to undo it."""
        parts, layout = [], []
        for t in data:
            flat = t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)
            parts.append(flat)
            layout.append((t.dtype, tuple(t.shape[1:]), flat.shape[1]))
        return torch.cat(parts, 1), layout

    def fetch_rows(packed: torch.Tensor, layout: list, idx: torch.Tensor) -> ClientData:
        """This rank's slots' data rows from the hosts that hold them: one all-gather
        over the hosts line of each host's rows for the line's slots (zeros where
        another host holds the client)."""
        ids = idx[line_slots.to(idx.device)]
        held = (ids // rows_per_host) == host
        local = torch.where(held, ids - row0, torch.zeros_like(ids))
        pack = packed[local] * held[:, None].to(torch.uint8)
        gathered = hosts_line.hosts_all_gather(pack).view(n_hosts, len(ids), -1)
        round_block.cohort_exchange_bytes = gathered.numel()
        mine = slice(host * per, (host + 1) * per)
        rows = gathered[ids[mine] // rows_per_host,
                        torch.arange(per, device=ids.device) + mine.start]
        fields, at = [], 0
        for dtype, shape, width in layout:
            fields.append(rows[:, at: at + width].contiguous().view(dtype).reshape(per, *shape))
            at += width
        return ClientData(*fields)

    def resample(seed: int, at: torch.device,
                 gen_at: torch.device) -> tuple[torch.Tensor | None, torch.Tensor]:
        """This round's cohort drawn on the device ``at`` (generators on ``gen_at``):
        ``(idx, mask)``."""
        drop = None
        if dropout_rate > 0:
            drop = torch.Generator(device=gen_at).manual_seed(_salted(seed, _DROPOUT_SALT))
        if not cohort_mode:
            mask = (torch.arange(step_clients, device=at) < num_clients).float()
            if drop is not None:
                mask = mask * (torch.rand(step_clients, generator=drop, device=at)
                               >= dropout_rate).float()
            return None, mask
        gen = torch.Generator(device=gen_at).manual_seed(_salted(seed, _COHORT_SALT))
        perm = torch.randperm(num_clients, generator=gen, device=at)
        idx = torch.zeros(step_clients, dtype=torch.int64, device=at)
        idx[:cohort_size] = perm[:cohort_size]
        mask = torch.zeros(step_clients, device=at)
        if drop is None:
            mask[:cohort_size] = 1.0
        else:
            mask[:cohort_size] = (torch.rand(cohort_size, generator=drop, device=at)
                                  >= dropout_rate).float()
        return idx, mask

    def round_block(
        global_params: Params,
        server_opt_state: Any,
        data: ClientData,
        num_samples: torch.Tensor,
        round_seeds: Sequence[int],
        lr_scales: Sequence[float],
        cohort_idx: torch.Tensor | None = None,
        cohort_mask: torch.Tensor | None = None,
        perms: torch.Tensor | None = None,
        keys: torch.Tensor | None = None,
        base_params: Params | None = None,
    ) -> RoundBlockResult:
        if (base_params is None) != (frozen_base is None):
            raise ValueError(
                "base_params must be passed exactly when the block was built "
                "with frozen_base="
            )
        # The frozen base rides into every round's step ahead of the round's data.
        base = () if frozen_base is None else (base_params,)
        seeds = [int(s) for s in round_seeds]
        scales = [float(s) for s in lr_scales]
        if len(scales) != len(seeds):
            raise ValueError(f"{len(seeds)} round seeds but {len(scales)} lr scales")
        if (cohort_mask is None) != (cohort_idx is None) and cohort_mode:
            raise ValueError(
                "pass BOTH cohort_idx and cohort_mask (host-sampled cohorts) or "
                "NEITHER (on-device resampling)"
            )
        if keys is not None and perms is None:
            raise ValueError("keys= replaces the drawn keys only together with perms=")
        fetching = exchange and cohort_mask is None
        if fetching:
            packed, layout = data_bytes(data)
        n = data.y.shape[1]
        # The call's device is the data's: on ``meta`` tensors (the analysis' shape
        # trace) the generators live on the host and each draw is a meta shape.
        at = data.y.device
        gen_at = torch.device("cpu") if at.type == "meta" else at
        gp, sos = global_params, server_opt_state
        rows: dict[str, list] = {
            "metrics": [], "survivors": [], "client": [], "norms": [], "weights": [],
            "ids": [],
        }
        for i, seed in enumerate(seeds):
            # The round's draws, in _train_round's order.
            if perms is None:
                gen = torch.Generator(device=gen_at).manual_seed(seed)
                perms_r = pad_permutations(
                    draw_permutations(gen, num_clients, epochs, n, device=at),
                    padded_clients)
                keys_r = client_keys(seed, padded_clients, at)
            else:
                perms_r, keys_r = perms[i], None if keys is None else keys[i]
            if cohort_mask is None:
                idx, mask = resample(seed, at, gen_at)
            else:
                idx = cohort_idx[i] if cohort_mode else None
                mask = cohort_mask[i]
            survivors = mask.sum()
            # Below the completion floor the round is gated to zero weight: the round
            # step's identity for params and server state, decided on the device.
            mask_eff = mask * (survivors >= required)
            # The cohort's weights are whole on every rank; this rank trains its
            # slots (all of them on one device).
            if cohort_mode:
                ids = idx[slots]
                data_r = (fetch_rows(packed, layout, idx) if fetching
                          else data.select(ids - row0))
                weights = compute_weights(num_samples[idx], mask_eff)
            else:
                ids = slots
                data_r = data.select(slice(slots.start - row0, slots.stop - row0))
                weights = compute_weights(num_samples, mask_eff)
            perms_r = perms_r[ids]
            keys_r = None if keys_r is None else keys_r[ids]
            result = step(gp, sos, *base, data_r, weights[slots], perms_r, keys_r,
                          lr_scale=scales[i])
            gp, sos = result.params, result.server_opt_state
            rows["metrics"].append(result.metrics)
            rows["survivors"].append(survivors)
            if collect_client_detail:
                rows["client"].append(result.client_metrics)
                rows["norms"].append(result.update_sq_norms)
                rows["weights"].append(weights)
                if cohort_mask is None and cohort_mode:
                    rows["ids"].append(idx)
            del result, data_r, perms_r, keys_r
        metrics = {k: torch.stack([m[k] for m in rows["metrics"]])
                   for k in rows["metrics"][0]}
        detail = collect_client_detail
        return RoundBlockResult(
            params=gp,
            server_opt_state=sos,
            metrics=metrics,
            survivors=torch.stack(rows["survivors"]).to(torch.int32),
            client_metrics=_stack_metrics(rows["client"]) if detail else None,
            update_sq_norms=torch.stack(rows["norms"]) if detail else None,
            weights=torch.stack(rows["weights"]) if detail else None,
            cohort_ids=torch.stack(rows["ids"]) if rows["ids"] else None,
        )

    round_block.cohort_exchange_bytes = 0
    return round_block
