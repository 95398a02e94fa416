"""Param names, ravel order and flat views (counterpart of ``nanofed_tpu/utils/trees.py``).

The JAX package's params are nested dicts of arrays.  Here they are one flat
``dict[str, Tensor]`` whose keys are the JAX package's ``/``-path names
(``tree_flatten_with_names``) and whose order is its ravel order
(``jax.flatten_util.ravel_pytree``: sorted dict keys at every level).  So a flat
``[P]`` vector means the same coordinates in both packages, and
:func:`from_numpy_params` / :func:`to_numpy_params` carry weights across with no
transposes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import Params


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


def to_numpy_params(params: Params) -> dict[str, Any]:
    """Inverse of :func:`from_numpy_params`: a nested dict of numpy arrays."""
    nested: dict[str, Any] = {}
    for name, leaf in params.items():
        *parents, last = name.split("/")
        node = nested
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf.detach().cpu().numpy()
    return nested


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
