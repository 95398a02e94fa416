"""Binary wire format for model parameters (counterpart of
``nanofed_tpu/communication/codec.py``).

A payload is an in-memory compressed ``.npz`` archive in the checkpoint layout
(``persistence.serialization``): ``/``-path names, dtype-tagged leaves.  The port's
params are a flat ``dict[str, Tensor]`` under the same names, so both packages write
the same keys and arrays and each decodes the other's payloads.  Decoding with a
template checks names, shapes and dtypes: the server's structural barrier for
incoming updates.  Decoded leaves are CPU tensors.

The two compressed update encodings are the JAX package's, in the same numpy float32
arithmetic, so the same seed gives the same arrays in both packages:

* ``q8-delta``: the round delta, per-leaf absmax scale, stochastically rounded to int8
  (``<name>::q8q`` payload, ``<name>::q8s`` scale);
* ``topk8-delta``: each leaf's top ``fraction`` coordinates by magnitude as uint32
  indices (``<name>::tk8i``) plus the same int8 values and scale; the client keeps the
  un-sent tail for error feedback.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from nanofed_tpu_torch.core.exceptions import CheckpointError, NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.persistence.serialization import (
    flatten_to_arrays,
    from_storable,
    unflatten_from_arrays,
)

Q8_QUANT_TAG = "::q8q"
Q8_SCALE_TAG = "::q8s"
Q8_INDEX_TAG = "::tk8i"

#: Wire values for the X-NanoFed-Encoding header.
ENCODING_Q8_DELTA = "q8-delta"
ENCODING_TOPK8 = "topk8-delta"


def _np32(leaf: torch.Tensor) -> np.ndarray:
    return leaf.detach().cpu().to(torch.float32).numpy()


def _savez(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def encode_params(params: Params) -> bytes:
    """Params -> compressed npz bytes (leaves fetched to the host)."""
    return _savez(flatten_to_arrays(params))


def decode_params(payload: bytes, like: Params | None = None) -> Params:
    """npz bytes -> params, template-ordered and validated when ``like`` is given."""
    with np.load(io.BytesIO(payload)) as data:
        arrays = dict(from_storable(name, data[name]) for name in data.files)
    try:
        return unflatten_from_arrays(arrays, like, source="payload")
    except CheckpointError as e:
        raise NanoFedError(str(e)) from e


def _stochastic_int8(x: np.ndarray, rng: np.random.Generator) -> tuple[np.ndarray, float]:
    """``x`` float32 -> (int8 values, scale ``max|x| / 127``), rounded stochastically
    (floor + Bernoulli(frac): unbiased).  All-zero input gives scale 0 and zeros."""
    absmax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = absmax / 127.0
    if scale == 0.0:
        return np.zeros(x.shape, dtype=np.int8), scale
    scaled = x / scale
    floor = np.floor(scaled)
    q = floor + (rng.random(scaled.shape, dtype=np.float32) < (scaled - floor))
    return np.clip(q, -127, 127).astype(np.int8), scale


def encode_delta_q8(delta: Params, seed: int | None = None) -> bytes:
    """Round delta -> compressed npz of int8 leaves + per-leaf float32 scales.
    ``seed`` fixes the stochastic rounding (None draws from OS entropy)."""
    rng = np.random.default_rng(seed)
    arrays: dict[str, np.ndarray] = {}
    for name, leaf in delta.items():
        q, scale = _stochastic_int8(_np32(leaf), rng)
        arrays[f"{name}{Q8_QUANT_TAG}"] = q
        arrays[f"{name}{Q8_SCALE_TAG}"] = np.float32(scale)
    return _savez(arrays)


def _to_template(arrays: dict[str, np.ndarray], like: Params, source: str) -> Params:
    tensors = {
        name: torch.from_numpy(arr).to(like[name].dtype if name in like else torch.float32)
        for name, arr in arrays.items()
    }
    try:
        return unflatten_from_arrays(tensors, like, source=source)
    except CheckpointError as e:
        raise NanoFedError(str(e)) from e


def decode_delta_q8(payload: bytes, like: Params) -> Params:
    """q8 npz bytes -> the dequantized delta in the template's order and dtypes
    (dequantized in float32, then cast).  A template is required."""
    with np.load(io.BytesIO(payload)) as data:
        quants: dict[str, np.ndarray] = {}
        scales: dict[str, np.float32] = {}
        for key in data.files:
            if key.endswith(Q8_QUANT_TAG):
                quants[key[: -len(Q8_QUANT_TAG)]] = data[key].astype(np.float32)
            elif key.endswith(Q8_SCALE_TAG):
                scales[key[: -len(Q8_SCALE_TAG)]] = data[key]
            else:
                raise NanoFedError(
                    f"q8 payload contains non-q8 entry {key!r} — plain and "
                    "quantized encodings must not be mixed in one payload"
                )
    unscaled = set(quants) ^ set(scales)
    if unscaled:
        raise NanoFedError(
            f"q8 payload has mismatched quant/scale entries for {sorted(unscaled)[:5]}"
        )
    arrays = {name: q * scales[name] for name, q in quants.items()}
    return _to_template(arrays, like, "q8 payload")


def _add(base: Params, delta: Params) -> Params:
    """``base + delta`` in numpy float32 (the arithmetic client and server share, so
    a signature over the reconstruction composes); float32 CPU tensors."""
    return {name: torch.from_numpy(_np32(g) + _np32(delta[name])) for name, g in base.items()}


def reconstruct_q8(base: Params, payload: bytes) -> Params:
    """q8-delta bytes + base params -> full float32 params."""
    return _add(base, decode_delta_q8(payload, like=base))


def encode_delta_topk8(delta: Params, fraction: float = 0.05, seed: int | None = None) -> bytes:
    """Round delta -> npz of per-leaf (sorted uint32 indices, int8 values, scale):
    the ``fraction`` of each leaf's coordinates largest in magnitude (at least one)."""
    if not 0.0 < fraction <= 1.0:
        raise NanoFedError(f"topk fraction must be in (0, 1], got {fraction}")
    rng = np.random.default_rng(seed)
    arrays: dict[str, np.ndarray] = {}
    for name, leaf in delta.items():
        x = _np32(leaf).ravel()
        k = max(1, int(np.ceil(fraction * x.size)))
        idx = np.argpartition(np.abs(x), -k)[-k:].astype(np.uint32)
        idx.sort()
        q, scale = _stochastic_int8(x[idx], rng)
        arrays[f"{name}{Q8_INDEX_TAG}"] = idx
        arrays[f"{name}{Q8_QUANT_TAG}"] = q
        arrays[f"{name}{Q8_SCALE_TAG}"] = np.float32(scale)
    return _savez(arrays)


def decode_delta_topk8(payload: bytes, like: Params) -> Params:
    """topk8 npz bytes -> the dense delta (zeros off the shipped coordinates) in the
    template's order and dtypes; out-of-range indices are refused."""
    with np.load(io.BytesIO(payload)) as data:
        idxs: dict[str, np.ndarray] = {}
        quants: dict[str, np.ndarray] = {}
        scales: dict[str, np.float32] = {}
        for key in data.files:
            if key.endswith(Q8_INDEX_TAG):
                idxs[key[: -len(Q8_INDEX_TAG)]] = data[key]
            elif key.endswith(Q8_QUANT_TAG):
                quants[key[: -len(Q8_QUANT_TAG)]] = data[key].astype(np.float32)
            elif key.endswith(Q8_SCALE_TAG):
                scales[key[: -len(Q8_SCALE_TAG)]] = data[key]
            else:
                raise NanoFedError(f"topk8 payload contains non-topk8 entry {key!r}")
    if not (set(idxs) == set(quants) == set(scales)):
        raise NanoFedError("topk8 payload has mismatched index/quant/scale entries")
    arrays: dict[str, np.ndarray] = {}
    for name, idx in idxs.items():
        if name not in like:
            raise NanoFedError(f"topk8 payload leaf '{name}' not in template")
        leaf = like[name]
        if idx.size != quants[name].size:
            raise NanoFedError(f"topk8 leaf '{name}': index/value length mismatch")
        if idx.size and int(idx.max()) >= leaf.numel():
            raise NanoFedError(
                f"topk8 leaf '{name}': index {int(idx.max())} out of range for "
                f"size {leaf.numel()}"
            )
        dense = np.zeros(leaf.numel(), np.float32)
        dense[idx.astype(np.int64)] = quants[name] * scales[name]
        arrays[name] = dense.reshape(tuple(leaf.shape))
    return _to_template(arrays, like, "topk8 payload")


def reconstruct_topk8(base: Params, payload: bytes) -> Params:
    """topk8 bytes + base -> full float32 params (the counterpart of
    :func:`reconstruct_q8`)."""
    return _add(base, decode_delta_topk8(payload, like=base))
