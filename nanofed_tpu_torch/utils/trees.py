"""Param names, ravel order and flat views (counterpart of ``nanofed_tpu/utils/trees.py``).

The JAX package's params are nested dicts of arrays.  Here they are one flat
``dict[str, Tensor]`` whose keys are the JAX package's ``/``-path names
(``tree_flatten_with_names``) and whose order is its ravel order
(``jax.flatten_util.ravel_pytree``: sorted dict keys at every level).  So a flat
``[P]`` vector means the same coordinates in both packages, and
:func:`from_numpy_params` / :func:`to_numpy_params` carry weights across with no
transposes.  A checkpoint's params and server state cross at the state store's
boundary the same way (:func:`from_checkpoint_params`,
:func:`to_numpy_server_state`, :func:`from_numpy_server_state`): inside the round
they stay flat.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.exceptions import CheckpointError
from nanofed_tpu_torch.core.types import (
    EmptyState,
    Params,
    ScaleByAdamState,
    ScaleByScheduleState,
    TraceState,
)


def _flatten(nested: Mapping[str, Any], prefix: tuple[str, ...]) -> list[tuple[tuple[str, ...], Any]]:
    out = []
    for key in sorted(nested):
        value = nested[key]
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.extend(_flatten(value, path))
        else:
            out.append((path, value))
    return out


def flatten_with_names(nested: Mapping[str, Any]) -> dict[str, Any]:
    """Nested dict -> flat ``{"a/b": leaf}`` in ravel order (sorted keys per level)."""
    return {"/".join(path): leaf for path, leaf in _flatten(nested, ())}


def from_numpy_params(nested: Mapping[str, Any], device: DeviceLike = None) -> Params:
    """The JAX package's params (after ``jax.device_get`` / ``np.asarray``) as port
    params: same names, order, shapes and float32 values, on ``device``."""
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.array(leaf, dtype=np.float32)).to(dev)
        for name, leaf in flatten_with_names(nested).items()
    }


def unflatten_names(flat: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`flatten_with_names`: ``{"a/b": leaf}`` -> nested dicts of the
    same leaves (no copies)."""
    nested: dict[str, Any] = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = nested
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return nested


def to_numpy_params(params: Params) -> dict[str, Any]:
    """Inverse of :func:`from_numpy_params`: a nested dict of numpy arrays."""
    return unflatten_names({name: leaf.detach().cpu().numpy() for name, leaf in params.items()})


def _leaves_like(nested: Any, like: Params, what: str) -> Params:
    """A nested dict of arrays as flat tensors on ``like``'s device: exactly
    ``like``'s names, shapes and dtypes, or a ``CheckpointError``."""
    if not isinstance(nested, Mapping):
        raise CheckpointError(f"{what} is a {type(nested).__name__}, not a dict of arrays")
    arrays = flatten_with_names(nested)
    if set(arrays) != set(like):
        raise CheckpointError(
            f"{what} has leaves {sorted(set(arrays) - set(like))[:5]} the model lacks and "
            f"lacks {sorted(set(like) - set(arrays))[:5]}")
    out = {}
    for name, leaf in like.items():
        t = torch.from_numpy(np.array(arrays[name]))
        if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
            raise CheckpointError(
                f"{what} leaf '{name}' is {t.dtype} {tuple(t.shape)}, the model's "
                f"{leaf.dtype} {tuple(leaf.shape)}")
        out[name] = t.to(leaf.device)
    return out


def from_checkpoint_params(nested: Mapping[str, Any], like: Params) -> Params:
    """A checkpoint's params (the JAX package's nested dict of numpy arrays) as port
    params on ``like``'s device, with ``like``'s names, shapes and dtypes checked."""
    return _leaves_like(nested, like, "the checkpoint's params")


def from_checkpoint_stack(nested: Mapping[str, Any], like: Params, rows: int) -> torch.Tensor:
    """A checkpoint's stacked tree (leaves ``[rows, *shape]``, the JAX package's
    per-client state such as SCAFFOLD's control stack) as one ``[rows, P]`` float32
    matrix in ravel order on ``like``'s device, names, shapes and dtypes checked."""
    if not isinstance(nested, Mapping):
        raise CheckpointError(f"the checkpoint's stack is a {type(nested).__name__}, "
                              "not a dict of arrays")
    arrays = flatten_with_names(nested)
    if set(arrays) != set(like):
        raise CheckpointError(
            f"the checkpoint's stack has leaves {sorted(set(arrays) - set(like))[:5]} the "
            f"model lacks and lacks {sorted(set(like) - set(arrays))[:5]}")
    device = next(iter(like.values())).device
    out = torch.empty((rows, tree_size(like)), device=device)
    for name, view in unravel_stacked(out, like).items():
        arr = np.asarray(arrays[name])
        if arr.shape != (rows, *like[name].shape) or arr.dtype != np.float32:
            raise CheckpointError(
                f"the checkpoint's stack leaf '{name}' is {arr.dtype} {arr.shape}, this "
                f"run needs float32 {(rows, *like[name].shape)} (one row per client of "
                "the population)")
        view.copy_(torch.from_numpy(np.require(arr, requirements="W")))
    return out


def to_numpy_server_state(state: Mapping[str, Any], like: Params) -> tuple:
    """The port's flat server state as the JAX package's optax state: a
    ``(transform, schedule)`` tuple of ``core.types`` records whose trees are nested
    dicts of numpy arrays shaped like ``like`` and whose counts are int32 (a count
    that rides on the device as a 0-d tensor is read back here, the one place the
    format needs it)."""

    def tree(flat: torch.Tensor) -> dict[str, Any]:
        return to_numpy_params(unravel(flat, like))

    if "mu" in state:
        transform = ScaleByAdamState(np.asarray(int(state["count"]), np.int32),
                                     tree(state["mu"]), tree(state["nu"]))
    elif "trace" in state:
        transform = TraceState(tree(state["trace"]))
    else:
        transform = EmptyState()
    schedule = (ScaleByScheduleState(np.asarray(int(state["schedule_count"]), np.int32))
                if "schedule_count" in state else EmptyState())
    return (transform, schedule)


def from_numpy_server_state(state: Any, strategy: Any, like: Params) -> dict[str, Any]:
    """Inverse of :func:`to_numpy_server_state`, checked against what ``strategy``'s
    server optimizer keeps (its transform, and whether its learning rate is a
    schedule) and against ``like``'s leaves; vectors land on ``like``'s device and
    counts become 0-d int64 tensors there, as ``server_tx.init`` makes them."""
    if not (isinstance(state, tuple) and len(state) == 2):
        raise CheckpointError(
            f"the checkpoint's server state is a {type(state).__name__}, not an optax "
            "(transform, learning rate) pair")

    def flat(tree: Any, field: str) -> torch.Tensor:
        leaves = _leaves_like(tree, like, f"the checkpoint's server state '{field}'")
        return torch.cat([leaf.reshape(-1) for leaf in leaves.values()])

    def counter(count: Any) -> torch.Tensor:
        return torch.full((), int(count), dtype=torch.int64, device=device)

    device = next(iter(like.values())).device
    transform, schedule = state
    out: dict[str, Any] = {}
    if isinstance(transform, ScaleByAdamState):
        out.update(count=counter(transform.count), mu=flat(transform.mu, "mu"),
                   nu=flat(transform.nu, "nu"))
    elif isinstance(transform, TraceState):
        out["trace"] = flat(transform.trace, "trace")
    elif not isinstance(transform, EmptyState):
        raise CheckpointError(f"unknown server transform state {type(transform).__name__}")
    if isinstance(schedule, ScaleByScheduleState):
        out["schedule_count"] = counter(schedule.count)
    elif not isinstance(schedule, EmptyState):
        raise CheckpointError(f"unknown learning-rate state {type(schedule).__name__}")
    want = strategy.server_tx.init(torch.zeros(0))
    if set(out) != set(want):
        raise CheckpointError(
            f"the checkpoint's server state keeps {sorted(out)}, strategy "
            f"{strategy.name!r} keeps {sorted(want)}")
    return out


def tree_size(params: Params) -> int:
    """Total number of scalar parameters."""
    return sum(leaf.numel() for leaf in params.values())


def ravel(params: Params) -> torch.Tensor:
    """One ``[P]`` vector in ravel order (a copy)."""
    return torch.cat([leaf.reshape(-1) for leaf in params.values()])


def unravel(flat: torch.Tensor, like: Params) -> Params:
    """Views of a ``[P]`` vector shaped like ``like`` (no copy)."""
    out, offset = {}, 0
    for name, leaf in like.items():
        n = leaf.numel()
        out[name] = flat[offset : offset + n].view(leaf.shape)
        offset += n
    if offset != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} values, params need {offset}")
    return out


def ravel_stacked(stacked: Params) -> torch.Tensor:
    """Stacked params (leaves ``[C, ...]``) -> one ``[C, P]`` matrix in ravel order."""
    c = next(iter(stacked.values())).shape[0]
    return torch.cat([leaf.reshape(c, -1) for leaf in stacked.values()], dim=1)


def unravel_stacked(flat: torch.Tensor, like: Params) -> Params:
    """Views of a ``[C, P]`` matrix (rows contiguous; the row stride may exceed P) as
    stacked leaves ``[C, *shape]`` shaped like ``like``: each leaf is its column
    segment of the flat layout, so writing a leaf writes the matrix (no copy)."""
    c = flat.shape[0]
    out, offset = {}, 0
    for name, leaf in like.items():
        n = leaf.numel()
        out[name] = flat[:, offset : offset + n].view(c, *leaf.shape)
        offset += n
    if offset != flat.shape[1]:
        raise ValueError(f"flat matrix has {flat.shape[1]} columns, params need {offset}")
    return out


def tree_sq_norm(params: Params) -> torch.Tensor:
    """Squared global L2 norm over every leaf."""
    return torch.stack([leaf.square().sum() for leaf in params.values()]).sum()


def tree_clip_by_global_norm(
    params: Params, max_norm: float | torch.Tensor
) -> tuple[Params, torch.Tensor]:
    """Scale ``params`` so its global norm is at most ``max_norm``; returns
    ``(clipped, pre_clip_norm)`` with the JAX package's coefficient
    ``min(1, max_norm / (norm + 1e-12))``."""
    norm = tree_sq_norm(params).sqrt()
    coef = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {name: leaf * coef for name, leaf in params.items()}, norm


def tree_weighted_mean(stacked: Params, weights: torch.Tensor, eps: float = 1e-12) -> Params:
    """Weighted mean over the leading axis of every leaf (plain per-leaf form; the
    flat kernel form is ``ops.weighted_mean_tree``)."""
    denom = torch.clamp(weights.sum(), min=eps)

    def leaf_mean(leaf: torch.Tensor) -> torch.Tensor:
        w = weights.to(leaf.dtype).reshape((-1,) + (1,) * (leaf.ndim - 1))
        return (leaf * w).sum(0) / denom.to(leaf.dtype)

    return {name: leaf_mean(leaf) for name, leaf in stacked.items()}


# ---------------------------------------------------------------------------
# The JAX package's ``tree_*`` arithmetic on the port's flat params
# ---------------------------------------------------------------------------


def tree_zeros_like(params: Params) -> Params:
    return {name: torch.zeros_like(leaf) for name, leaf in params.items()}


def tree_add(a: Params, b: Params) -> Params:
    return {name: leaf + b[name] for name, leaf in a.items()}


def tree_sub(a: Params, b: Params) -> Params:
    return {name: leaf - b[name] for name, leaf in a.items()}


def tree_scale(params: Params, s: torch.Tensor | float) -> Params:
    return {name: leaf * s for name, leaf in params.items()}


def tree_where(pred: torch.Tensor | bool, a: Params, b: Params) -> Params:
    """Leafwise ``where(pred, a, b)`` with a scalar or broadcastable predicate."""
    pred = torch.as_tensor(pred)
    return {name: torch.where(pred.to(leaf.device), leaf, b[name]) for name, leaf in a.items()}


def tree_vdot(a: Params, b: Params) -> torch.Tensor:
    """Sum of elementwise products across all leaves (a full inner product)."""
    return torch.stack([torch.vdot(leaf.reshape(-1), b[name].reshape(-1))
                        for name, leaf in a.items()]).sum()


def tree_global_norm(params: Params) -> torch.Tensor:
    """Global L2 norm over all leaves."""
    return tree_sq_norm(params).sqrt()


def tree_cast(params: Params, dtype: torch.dtype) -> Params:
    return {name: leaf.to(dtype) for name, leaf in params.items()}


def tree_ravel(params: Params) -> tuple[torch.Tensor, Any]:
    """One 1-D vector in ravel order plus the function that unravels a vector like it
    (``jax.flatten_util.ravel_pytree``'s pair; :func:`ravel` and :func:`unravel`)."""
    like = {name: leaf.detach() for name, leaf in params.items()}
    return ravel(params), lambda flat: unravel(flat, like)


def tree_flatten_with_names(tree: Mapping[str, Any]) -> tuple[list[tuple[str, Any]], list[str]]:
    """``[(path_name, leaf), ...]`` of a flat or nested dict (nested keys sorted, as the
    JAX ravel order) plus the names, which rebuild it (``dict(zip(names, leaves))``,
    then :func:`unflatten_names` for a nested tree): the port's treedef."""
    named = list(flatten_with_names(tree).items())
    return named, [name for name, _ in named]


def tree_map_with_path_names(fn: Any, tree: Mapping[str, Any]) -> dict[str, Any]:
    """Map with the ``/``-joined path name of each leaf, keeping a nested tree nested."""

    def walk(node: Mapping[str, Any], prefix: str) -> dict[str, Any]:
        return {key: walk(value, f"{prefix}{key}/") if isinstance(value, Mapping)
                else fn(f"{prefix}{key}", value) for key, value in node.items()}

    return walk(tree, "")
