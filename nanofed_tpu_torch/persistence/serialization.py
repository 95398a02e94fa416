"""Param (de)serialization in the npz layout (counterpart of
``nanofed_tpu/persistence/serialization.py``; so far the part the wire codec needs).

The JAX package keys an npz archive by ``/``-joined pytree paths and tags leaves whose
dtype npy cannot store (bfloat16 and the other ``ml_dtypes``) as ``<name>::dtype::<dtype>``
with their raw bytes as a ``uint8 [..., itemsize]`` array.  The port's params are
already one flat ``dict[str, Tensor]`` under the same names, so the same archive is
written and read here with no nesting: a payload or checkpoint of either package loads
in the other.  Tagged leaves become torch tensors of that dtype (no ``ml_dtypes``
needed).  The model manager and the state store come with the persistence slice.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from nanofed_tpu_torch.core.exceptions import CheckpointError
from nanofed_tpu_torch.core.types import Params

#: Key suffix tagging leaves whose dtype the npy format cannot represent natively.
#: Shared by checkpoints and the wire codec, as in the JAX package.
DTYPE_TAG = "::dtype::"

# Tagged dtypes by name (numpy's ml_dtypes names), and their torch counterparts.
_TAGGED_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def to_storable(name: str, leaf: torch.Tensor) -> tuple[str, np.ndarray]:
    """``(name, leaf)`` -> an npz-safe ``(name, array)`` on the host: a dtype numpy
    lacks becomes its raw bytes (``uint8 [..., itemsize]``) under a tagged name."""
    t = leaf.detach().cpu().contiguous()
    for dtype_name, dtype in _TAGGED_DTYPES.items():
        if t.dtype == dtype:
            raw = t.reshape(-1).view(torch.uint8).numpy()
            return f"{name}{DTYPE_TAG}{dtype_name}", raw.reshape(
                tuple(t.shape) + (t.element_size(),))
    return name, t.numpy()


def from_storable(name: str, arr: np.ndarray) -> tuple[str, torch.Tensor]:
    """Invert :func:`to_storable`: ``(name, array)`` -> ``(name, tensor)`` on the CPU."""
    if DTYPE_TAG in name:
        name, dtype_name = name.split(DTYPE_TAG, 1)
        dtype = _TAGGED_DTYPES.get(dtype_name)
        if dtype is None:
            raise CheckpointError(f"leaf '{name}' has an unsupported tagged dtype {dtype_name!r}")
        raw = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8))
        return name, raw.reshape(-1).view(dtype).reshape(arr.shape[:-1])
    return name, torch.from_numpy(np.array(arr))


def flatten_to_arrays(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Flat params -> ``{storable_name: array}`` for npz serialization."""
    return dict(to_storable(name, leaf) for name, leaf in params.items())


def unflatten_from_arrays(
    arrays: Mapping[str, torch.Tensor], like: Params | None, source: str = "payload"
) -> Params:
    """``{name: tensor}`` -> params.  With a template ``like``: exactly its leaves, in
    its order, with names, shapes and dtypes checked (the server's structural barrier
    for incoming updates); without one, the leaves as they came."""
    if like is None:
        return dict(arrays)
    missing = [name for name in like if name not in arrays]
    if missing:
        raise CheckpointError(f"{source} is missing leaves {missing[:5]} for the given template")
    out = {}
    for name, leaf in like.items():
        arr = arrays[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointError(
                f"shape mismatch for '{name}': {source} {tuple(arr.shape)} vs template "
                f"{tuple(leaf.shape)}"
            )
        if arr.dtype != leaf.dtype:
            raise CheckpointError(
                f"dtype mismatch for '{name}': {source} {arr.dtype} vs template {leaf.dtype}"
            )
        out[name] = arr
    return out
