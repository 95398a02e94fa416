"""LoRA adapters over flat parameter dicts (counterpart of
``nanofed_tpu/adapters/lora.py``).

The base model stays frozen on the device, and each adapted kernel ``W [d_in,
d_out]`` carries a trainable low-rank delta ``(alpha / rank) * A @ B`` with ``A [d_in,
rank]`` and ``B [rank, d_out]``; a stacked kernel ``[L, d_in, d_out]`` (the scan
layout) adapts per layer with ``A [L, d_in, rank]``, ``B [L, rank, d_out]``.  Only the
adapter tree is federated: aggregated, encoded, checkpointed.  ``B`` starts at zero,
so the first merged model is the base exactly.

An adapter tree is a flat dict like params: the targeted leaf ``name`` gives the
entries ``name/A`` and ``name/B``, in the ravel order of the nested tree, which is the
JAX package's adapter tree leaf for leaf (checkpoints and wire payloads interchange).
Only shapes are read from a ``base_like`` argument.
"""

from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch

from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.utils.trees import flatten_with_names, unflatten_names

__all__ = [
    "AdapterSpec",
    "adapter_delta",
    "adapter_param_count",
    "adapter_wire_ratio",
    "init_adapters",
    "make_adapter_apply",
    "merge_adapters",
    "target_paths",
    "unmerge_adapters",
]


@dataclass(frozen=True)
class AdapterSpec:
    """Which leaves get adapters and at what rank.

    ``targets`` are fnmatch patterns over the '/'-joined leaf names; a matching 2-D
    leaf (or 3-D stacked ``[L, d_in, d_out]`` kernel) whose two trailing dims are both
    at least ``min_dim`` is adapted.  The default adapts every dense kernel: the
    transformer's ``wq/wk/wv/wo``, ``fc1/fc2`` and the head; embeddings, biases and
    norm scales stay frozen whole.  The merged delta is ``(alpha / rank) * A @ B``;
    ``alpha=None`` means ``alpha == rank`` (scale 1.0)."""

    rank: int = 8
    alpha: float | None = None
    targets: tuple[str, ...] = ("*kernel",)
    min_dim: int = 8
    init_scale: float = 0.01

    def __post_init__(self) -> None:
        if self.rank < 1:
            raise NanoFedError(f"adapter rank must be >= 1, got {self.rank}")
        if self.alpha is not None and self.alpha <= 0:
            raise NanoFedError(f"adapter alpha must be > 0, got {self.alpha}")
        if self.min_dim < 1:
            raise NanoFedError(f"min_dim must be >= 1, got {self.min_dim}")
        if not self.targets:
            raise NanoFedError("AdapterSpec needs at least one target pattern")

    @property
    def scaling(self) -> float:
        """The merged-delta multiplier ``alpha / rank``."""
        return (self.alpha if self.alpha is not None else float(self.rank)) / self.rank

    def matches(self, path: str, shape: tuple[int, ...]) -> bool:
        """Does the leaf at ``path`` with ``shape`` get an adapter?  2-D leaves adapt as
        one ``A``/``B`` pair, 3-D leaves as a stack of ``L`` pairs."""
        if len(shape) not in (2, 3) or min(shape[-2:]) < self.min_dim:
            return False
        return any(fnmatch.fnmatch(path, pat) for pat in self.targets)

    def to_dict(self) -> dict[str, Any]:
        return {
            "rank": self.rank,
            "alpha": self.alpha if self.alpha is not None else float(self.rank),
            "targets": list(self.targets),
            "min_dim": self.min_dim,
        }


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape") else leaf))


def target_paths(spec: AdapterSpec, base_like: Mapping[str, Any]) -> list[str]:
    """The base leaves ``spec`` adapts, in ravel order.  ``base_like`` maps names to
    tensors, arrays or shapes."""
    out = [name for name, leaf in base_like.items() if spec.matches(name, _shape(leaf))]
    if not out:
        raise NanoFedError(
            f"AdapterSpec{spec.to_dict()} matches no leaf of the base tree — "
            "check the target patterns against the model's parameter paths"
        )
    return out


def _adapter_tree(arrays: dict[str, Any]) -> dict[str, Any]:
    """``{"name/A": a, "name/B": b}`` in the nested adapter tree's ravel order."""
    return flatten_with_names(unflatten_names(arrays))


def init_adapters(spec: AdapterSpec, base_like: Mapping[str, Any], rng: int = 0) -> Params:
    """Fresh adapters: ``A ~ U(-s, s)`` with ``s = init_scale / sqrt(rank)``, ``B =
    0``, so the merged model equals the base at the start.  ``rng`` is an int seed
    of a host numpy draw, the JAX package's bit for bit (a JAX key has no meaning
    here and is not taken); the tensors land on the base's device (the CPU when
    ``base_like`` holds shapes)."""
    if not isinstance(rng, (int, np.integer)) or isinstance(rng, bool):
        raise TypeError(f"init_adapters takes an int seed, got {type(rng).__name__}")
    first = next(iter(base_like.values()))
    device = first.device if torch.is_tensor(first) else "cpu"
    host = np.random.default_rng(int(rng))
    s = spec.init_scale / math.sqrt(spec.rank)
    arrays: dict[str, Any] = {}
    for name in target_paths(spec, base_like):
        *lead, d_in, d_out = _shape(base_like[name])
        a = host.uniform(-s, s, size=(*lead, d_in, spec.rank)).astype(np.float32)
        arrays[f"{name}/A"] = torch.from_numpy(a).to(device)
        arrays[f"{name}/B"] = torch.zeros((*lead, spec.rank, d_out), device=device)
    return _adapter_tree(arrays)


def _delta(spec: AdapterSpec, adapters: Params, name: str) -> torch.Tensor | None:
    a = adapters.get(f"{name}/A")
    if a is None:
        return None
    return spec.scaling * (a @ adapters[f"{name}/B"])


def adapter_delta(spec: AdapterSpec, base_like: Mapping[str, Any], adapters: Params) -> Params:
    """The dense delta the adapters represent: ``scaling * A @ B`` at adapted leaves,
    exact zeros elsewhere, shaped like the base."""
    dev = next(iter(adapters.values())).device
    out = {}
    for name, leaf in base_like.items():
        d = _delta(spec, adapters, name)
        out[name] = d if d is not None else torch.zeros(_shape(leaf), device=dev)
    return out


def merge_adapters(base: Params, adapters: Params, spec: AdapterSpec) -> Params:
    """Base + low-rank deltas -> ordinary params, each in its base leaf's dtype (what
    the bound apply runs every forward pass, so ``A``/``B`` get gradients)."""
    out = {}
    for name, leaf in base.items():
        d = _delta(spec, adapters, name)
        out[name] = leaf if d is None else leaf + d.to(leaf.dtype)
    return out


def unmerge_adapters(merged: Params, adapters: Params, spec: AdapterSpec) -> Params:
    """The base back from merged params and their adapters (exact to rounding)."""
    out = {}
    for name, leaf in merged.items():
        d = _delta(spec, adapters, name)
        out[name] = leaf if d is None else leaf - d.to(leaf.dtype)
    return out


def make_adapter_apply(apply_fn: Callable[..., torch.Tensor], spec: AdapterSpec,
                       base: Params) -> Callable[..., torch.Tensor]:
    """Bind a frozen base into the zoo's apply signature: ``apply(adapters, x, *,
    dropout=None)`` merges, then calls ``apply_fn(merged, x, dropout=...)``, as the JAX
    package does (training is backprop through the merge)."""

    def apply(adapters: Params, x: torch.Tensor, *, dropout=None) -> torch.Tensor:
        return apply_fn(merge_adapters(base, adapters, spec), x, dropout=dropout)

    return apply


def adapter_param_count(spec: AdapterSpec, base_like: Mapping[str, Any]) -> dict[str, int]:
    """Trainable against frozen parameter counts and their float32 bytes."""
    base_total = 0
    trainable = 0
    for name, leaf in base_like.items():
        shape = _shape(leaf)
        base_total += int(np.prod(shape) or 1)
        if spec.matches(name, shape):
            *lead, d_in, d_out = shape
            trainable += int(np.prod(lead) or 1) * spec.rank * (d_in + d_out)
    return {
        "base_params": base_total,
        "adapter_params": trainable,
        "base_bytes_f32": base_total * 4,
        "adapter_bytes_f32": trainable * 4,
        "ratio": round(base_total / max(trainable, 1), 2),
    }


def adapter_wire_ratio(spec: AdapterSpec, base_like: Mapping[str, Any]) -> float:
    """Uncompressed payload ratio full/adapter, by parameter count."""
    counts = adapter_param_count(spec, base_like)
    return counts["base_params"] / max(counts["adapter_params"], 1)
