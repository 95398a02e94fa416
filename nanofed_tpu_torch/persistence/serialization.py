"""Checkpoint (de)serialization in the JAX package's formats (counterpart of
``nanofed_tpu/persistence/serialization.py``).

Params: the JAX package keys an npz archive by ``/``-joined pytree paths and tags
leaves whose dtype npy cannot store (bfloat16 and the other ``ml_dtypes``) as
``<name>::dtype::<dtype>`` with their raw bytes as a ``uint8 [..., itemsize]`` array.
The port's params are already one flat ``dict[str, Tensor]`` under the same names, so
the same archive is written and read here with no nesting: a payload, versioned model
or checkpoint of either package loads in the other.  Tagged leaves become torch
tensors of that dtype (no ``ml_dtypes`` needed).

Round state: a pickle of numpy-leaf trees, whose server state is optax's.  Reading
one imports none of ``jax``, ``optax`` or ``ml_dtypes``: the unpickler maps optax's
state classes (``OPTAX_STATE_CLASSES``) to the port's records of the same fields
(``core.types``), admits numpy's array globals and a few builtins, and refuses every
other global with a ``CheckpointError`` naming it.  A bfloat16 leaf in a pickle names
``ml_dtypes`` and is refused (bfloat16 params travel in npz archives).  Writing gives
a stream the JAX package's plain ``pickle.load`` turns into real optax states: the
records are written as references to optax's classes by module and name, called with
their fields.

Every file is published durably: written to a temporary name, fsynced, renamed, and
the directory fsynced.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO, Mapping

import numpy as np
import torch

from nanofed_tpu_torch.core.exceptions import CheckpointError
from nanofed_tpu_torch.core.types import (
    EmptyState,
    Params,
    ScaleByAdamState,
    ScaleByScheduleState,
    TraceState,
)

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
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
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


def flatten_to_arrays(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
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


# ----------------------------------------------------------------------
# Durable publication
# ----------------------------------------------------------------------


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a just-published rename survives power loss.  Platforms
    whose directory fds reject fsync degrade to the pre-fsync durability, never an
    error."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_file(f: BinaryIO) -> None:
    """Flush and fsync an OPEN file: the rename that publishes it must never point at
    data still in the page cache."""
    f.flush()
    os.fsync(f.fileno())


def _publish(tmp: Path, path: Path) -> None:
    """Durable atomic publish of a closed, fsynced temporary file: rename, then fsync
    the parent directory (the rename itself is metadata a crash can lose)."""
    tmp.replace(path)
    _fsync_dir(path.parent)


def write_text_durable(path: str | Path, text: str) -> None:
    """Durably publish a small text file (a checkpoint's ``metadata.json``, which
    marks the checkpoint complete) through the same fsync / rename / fsync-dir
    sequence as the state it vouches for."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        _fsync_file(f)
    _publish(tmp, path)


# ----------------------------------------------------------------------
# npz archives
# ----------------------------------------------------------------------


def save_pytree_npz(path: str | Path, params: Mapping[str, Any]) -> None:
    """Save flat params (tensors or arrays by ``/``-path name) as a compressed
    ``.npz``, the JAX package's layout."""
    arrays = flatten_to_arrays(params)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        _fsync_file(f)
    _publish(tmp, path)


def load_pytree_npz(path: str | Path, like: Params | None = None) -> Params:
    """Load an ``.npz`` archive of either package as flat params on the CPU.  With
    ``like``, exactly its leaves in its order, names, shapes and dtypes checked."""
    path = Path(path)
    if not path.exists():
        raise CheckpointError(f"checkpoint not found: {path}")
    with np.load(path) as data:
        arrays = dict(from_storable(name, data[name]) for name in data.files)
    return unflatten_from_arrays(arrays, like, source=str(path))


# ----------------------------------------------------------------------
# Pickled round state
# ----------------------------------------------------------------------

#: optax's server-state classes (optax 0.2.6) by (module, name), and the port's
#: records of the same fields that stand for them.  The one place those paths live.
OPTAX_STATE_CLASSES: dict[tuple[str, str], type] = {
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax.transforms._accumulation", "TraceState"): TraceState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
}

# The globals a pickled numpy array names (numpy 1.x and 2.x paths), and the
# builtins a plain state may hold.
_NUMPY_GLOBALS = {("numpy", "dtype"), ("numpy", "ndarray")} | {
    (f"numpy.{core}.{module}", name)
    for core in ("core", "_core")
    for module, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))
}
_SAFE_BUILTINS = {"complex", "set", "frozenset", "slice", "bytearray"}


@dataclass(frozen=True)
class _ClassRef:
    """A reference to a class by module and name, pickled as ``STACK_GLOBAL`` without
    importing the module (the writer's stand-in for an optax class)."""

    module: str
    name: str

    def __call__(self, *args: Any) -> Any:  # save_reduce requires a callable
        raise TypeError(f"{self.module}.{self.name} is only a pickled reference")


_OPTAX_REFS = {cls: _ClassRef(*key) for key, cls in OPTAX_STATE_CLASSES.items()}


class _StatePickler(pickle._Pickler):
    """The pure-Python pickler, which lets a reference be written by name: each
    port record becomes ``<optax class>(*fields)``."""

    dispatch = pickle._Pickler.dispatch.copy()

    def reducer_override(self, obj: Any) -> Any:
        ref = _OPTAX_REFS.get(type(obj))
        return NotImplemented if ref is None else (ref, tuple(obj))

    def _save_class_ref(self, ref: _ClassRef) -> None:
        self.save(ref.module)
        self.save(ref.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(ref)

    dispatch[_ClassRef] = _save_class_ref


class _StateUnpickler(pickle.Unpickler):
    """Admits optax's state classes (as the port's records), numpy's array globals
    and a few builtins; refuses every other global."""

    def __init__(self, f: BinaryIO, source: str) -> None:
        super().__init__(f)
        self._source = source

    def find_class(self, module: str, name: str) -> Any:
        record = OPTAX_STATE_CLASSES.get((module, name))
        if record is not None:
            return record
        if (module, name) in _NUMPY_GLOBALS or (module == "builtins"
                                                  and name in _SAFE_BUILTINS):
            return super().find_class(module, name)
        if module.split(".")[0] == "ml_dtypes":
            raise CheckpointError(
                f"{self._source} holds a {module}.{name} leaf: a pickled state with "
                "an ml_dtypes array (bfloat16, fp8) cannot be read without ml_dtypes, "
                "which the port does not use; keep such leaves in npz archives")
        raise CheckpointError(
            f"{self._source} names the global {module}.{name}, which a round state of "
            "either package never holds; refusing to load it")


def tree_to_numpy(tree: Any) -> Any:
    """Every tensor leaf of a nested dict / list / tuple / record tree as a numpy
    array on the host."""
    if torch.is_tensor(tree):
        if tree.dtype in _TAGGED_DTYPES.values():
            raise CheckpointError(
                f"a {tree.dtype} leaf cannot be pickled without ml_dtypes; keep it in an "
                "npz archive")
        return tree.detach().cpu().numpy()
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return tree


def save_state_pickle(path: str | Path, tree: Any) -> None:
    """Pickle a round state (numpy or tensor leaves, the server state as optax
    records) so the JAX package's ``load_state_pickle`` reads it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        _StatePickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(tree_to_numpy(tree))
        _fsync_file(f)
    _publish(tmp, path)


def load_state_pickle(path: str | Path) -> Any:
    """Load a round state of either package without importing jax, optax or
    ml_dtypes (see the module docstring for what is refused)."""
    path = Path(path)
    if not path.exists():
        raise CheckpointError(f"checkpoint not found: {path}")
    with open(path, "rb") as f:
        return _StateUnpickler(f, str(path)).load()
