"""Heterogeneous-rank adapter aggregation: rank-4 phones and rank-32 silos in one
global update (counterpart of ``nanofed_tpu/fleet/aggregate.py``).

LoRA factors of different ranks cannot be averaged factor-wise (``mean(A_i @ B_i) !=
mean(A_i) @ mean(B_i)``, and the shapes differ across tiers).  What is well defined
across ranks is the dense delta ``scaling * A @ B`` each client's adapters represent
(``adapters.lora.adapter_delta``), so the fleet's global update lives in dense-delta
space, reached two ways:

* :func:`aggregate_dense`, the reference: the weighted mean of per-client dense deltas;
* :func:`aggregate_padded`, the fast path: every client's factors zero-padded into a
  common max-rank bucket with ``w_i * scaling_i / Σw`` folded into ``A``, and the
  whole cohort contracted in one ``'cir,cro->io'`` einsum a leaf.  Padded rows and
  columns are zero, so it equals the dense route to float tolerance.  The JAX package
  computes it as a stock einsum outside any Pallas kernel, and so does the port.

Redistribution closes the loop: :func:`project_to_rank` compresses the aggregated
dense delta onto one tier's rank by truncated SVD in float64 (Eckart–Young), and
:func:`redistribute` does it for every tier.  :func:`factor_leaves` factors each
targeted leaf once and :func:`truncate_factors` cuts that one factorization to any
rank: the SVD of a leaf does not depend on the rank it is cut to, so the gateway
factors once a publish for every tier (a stated difference from the JAX gateway, which
factors each leaf once a tier).  The factorization runs on the delta's device with
``torch.linalg.svd``, batched over leaves of one shape; singular vectors are defined
up to sign, so only the dense images ``scaling * A @ B`` are comparable across
packages, never the raw factors.  Adapted leaves must be 2-D (the JAX projection
slices the factors of a 2-D leaf; a stacked ``[L, d_in, d_out]`` kernel is refused).

Adapter trees are flat ``{"<leaf>/A": ..., "<leaf>/B": ...}`` dicts in the nested
tree's ravel order, as ``adapters.lora`` builds them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from nanofed_tpu_torch.adapters.lora import AdapterSpec, adapter_delta, target_paths
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.utils.trees import flatten_with_names, unflatten_names

__all__ = [
    "AdapterUpdate",
    "aggregate_dense",
    "aggregate_padded",
    "factor_leaves",
    "factors_error",
    "pad_adapters_to_rank",
    "project_to_rank",
    "projection_error",
    "redistribute",
    "revive_adapters",
    "truncate_factors",
]


@dataclass(frozen=True)
class AdapterUpdate:
    """One client's contribution to a heterogeneous round: its tier's spec, its
    trained adapter tree and its FedAvg weight (sample count)."""

    spec: AdapterSpec
    adapters: Params
    weight: float = 1.0
    tier: str = ""

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise NanoFedError(f"update weight must be > 0, got {self.weight}")


def _tree(arrays: Mapping[str, Any]) -> dict[str, Any]:
    """Flat arrays in the nested tree's ravel order (the JAX package's leaf order)."""
    return flatten_with_names(unflatten_names(dict(arrays)))


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _device(tree: Params) -> torch.device:
    first = next(iter(tree.values()))
    return first.device if torch.is_tensor(first) else torch.device("cpu")


def _check_compatible(updates: Sequence[AdapterUpdate]) -> None:
    if not updates:
        raise NanoFedError("cannot aggregate an empty update set")
    t0, m0 = updates[0].spec.targets, updates[0].spec.min_dim
    for u in updates[1:]:
        if u.spec.targets != t0 or u.spec.min_dim != m0:
            raise NanoFedError(
                "heterogeneous-rank aggregation requires every tier to target "
                f"the same leaves: {u.spec.targets}/{u.spec.min_dim} vs "
                f"{t0}/{m0} — ranks may differ, target sets may not"
            )


def aggregate_dense(updates: Sequence[AdapterUpdate], base_like: Mapping[str, Any]) -> Params:
    """The reference route: ``Σ_i (w_i / Σw) * scaling_i * (A_i @ B_i)`` per targeted
    leaf, float32 zeros elsewhere; base-shaped, on the adapters' device."""
    if not updates:
        raise NanoFedError("cannot aggregate an empty update set")
    total_w = float(sum(u.weight for u in updates))
    dev = _device(updates[0].adapters)
    acc = {name: torch.zeros(_shape(leaf), dtype=torch.float32, device=dev)
           for name, leaf in base_like.items()}
    for u in updates:
        coef = u.weight / total_w
        for name, leaf in adapter_delta(u.spec, base_like, u.adapters).items():
            acc[name] = acc[name] + coef * leaf.to(dev, torch.float32)
    return acc


def aggregate_padded(updates: Sequence[AdapterUpdate], base_like: Mapping[str, Any],
                     pad_rank: int | None = None) -> Params:
    """The fast path: each client's factors padded into a ``pad_rank`` bucket (default:
    the cohort's max rank) with ``w_i * scaling_i / Σw`` folded into ``A_i``, each
    leaf's cohort contracted in one einsum.  Equal to the dense route; needs one
    target set across tiers."""
    _check_compatible(updates)
    ranks = [u.spec.rank for u in updates]
    bucket = max(ranks) if pad_rank is None else int(pad_rank)
    if bucket < max(ranks):
        raise NanoFedError(
            f"pad_rank {bucket} smaller than the cohort's max rank {max(ranks)}"
        )
    total_w = float(sum(u.weight for u in updates))
    paths = set(target_paths(updates[0].spec, base_like))
    dev = _device(updates[0].adapters)
    out: Params = {}
    for name, leaf in base_like.items():
        shape = _shape(leaf)
        if name not in paths:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
            continue
        d_in, d_out = shape
        a_stack = torch.zeros((len(updates), d_in, bucket), dtype=torch.float32, device=dev)
        b_stack = torch.zeros((len(updates), bucket, d_out), dtype=torch.float32, device=dev)
        for c, u in enumerate(updates):
            r = u.spec.rank
            coef = u.weight * u.spec.scaling / total_w
            a_stack[c, :, :r] = coef * u.adapters[f"{name}/A"].to(dev, torch.float32)
            b_stack[c, :r, :] = u.adapters[f"{name}/B"]
        out[name] = torch.einsum("cir,cro->io", a_stack, b_stack)
    return out


def pad_adapters_to_rank(adapters: Params, from_spec: AdapterSpec,
                         to_spec: AdapterSpec) -> Params:
    """A low-rank tier's adapters at a higher rank with the same delta: ``A``'s columns
    and ``B``'s rows zero-padded to ``to_spec.rank``, ``A`` rescaled by
    ``from_spec.scaling / to_spec.scaling``."""
    if to_spec.rank < from_spec.rank:
        raise NanoFedError(
            f"cannot pad rank {from_spec.rank} down to {to_spec.rank} — "
            "use project_to_rank for compression"
        )
    if (from_spec.targets, from_spec.min_dim) != (to_spec.targets, to_spec.min_dim):
        raise NanoFedError("pad_adapters_to_rank requires matching target sets between specs")
    rescale = from_spec.scaling / to_spec.scaling
    grow = to_spec.rank - from_spec.rank
    out: Params = {}
    for name, leaf in adapters.items():
        x = leaf.to(torch.float32)
        if name.endswith("/A"):
            out[name] = torch.nn.functional.pad(rescale * x, (0, grow))
        elif name.endswith("/B"):
            out[name] = torch.nn.functional.pad(x, (0, 0, 0, grow))
        else:
            raise NanoFedError(f"unexpected adapter leaf {name!r}")
    return out


#: Float64 thin SVDs ``(u, s, vt)`` of a dense delta's targeted leaves by name, in
#: target order, on the delta's device.
Factorization = dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def factor_leaves(dense_delta: Params, paths: Sequence[str]) -> Factorization:
    """Each leaf of ``paths`` factored once in float64 with ``torch.linalg.svd``
    (``full_matrices=False``), leaves of one shape in one batched call."""
    by_shape: dict[tuple[int, ...], list[str]] = {}
    for name in paths:
        shape = _shape(dense_delta[name])
        if len(shape) != 2:
            raise NanoFedError(
                f"fleet projection factors 2-D leaves; {name!r} has shape {shape}")
        by_shape.setdefault(shape, []).append(name)
    factors: dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
    for names in by_shape.values():
        stack = torch.stack([dense_delta[n].to(torch.float64) for n in names])
        u, s, vt = torch.linalg.svd(stack, full_matrices=False)
        for i, n in enumerate(names):
            factors[n] = (u[i], s[i], vt[i])
    return {name: factors[name] for name in paths}


def truncate_factors(factors: Factorization, spec: AdapterSpec) -> Params:
    """The rank-``spec.rank`` adapters of a factorization: ``A = U_r sqrt(S_r)``, ``B =
    sqrt(S_r) V_r^T / scaling`` (float32), zero-padded where a leaf's rank is lower."""
    arrays: dict[str, torch.Tensor] = {}
    for name, (u, s, vt) in factors.items():
        r = min(spec.rank, s.shape[0])
        root = torch.sqrt(s[:r])
        a = (u[:, :r] * root).to(torch.float32)
        b = ((root[:, None] * vt[:r]) / spec.scaling).to(torch.float32)
        if r < spec.rank:
            a = torch.nn.functional.pad(a, (0, spec.rank - r))
            b = torch.nn.functional.pad(b, (0, 0, 0, spec.rank - r))
        arrays[f"{name}/A"] = a
        arrays[f"{name}/B"] = b
    return _tree(arrays)


def project_to_rank(dense_delta: Params, spec: AdapterSpec,
                    base_like: Mapping[str, Any]) -> Params:
    """A base-shaped dense delta compressed onto ``spec``'s rank: per targeted leaf the
    truncated SVD (the Frobenius-optimal rank-r approximation), split symmetrically so
    ``scaling * A @ B`` reproduces the truncation; a leaf of lower true rank pads with
    zeros.  The redistribution direction: the fleet's update flowing down to a tier."""
    return truncate_factors(factor_leaves(dense_delta, target_paths(spec, base_like)), spec)


def factors_error(factors: Factorization, rank: int) -> dict[str, float]:
    """:func:`projection_error` of an existing factorization cut to ``rank``."""
    out: dict[str, float] = {}
    num = den = 0.0
    for name, (_, s, _) in factors.items():
        sq = (s.double() ** 2).cpu().numpy()
        tail = float(np.sum(sq[rank:]))
        total = float(np.sum(sq))
        out[name] = float(np.sqrt(tail / total)) if total > 0 else 0.0
        num += tail
        den += total
    out["__overall__"] = float(np.sqrt(num / den)) if den > 0 else 0.0
    return out


def projection_error(dense_delta: Params, spec: AdapterSpec,
                     base_like: Mapping[str, Any]) -> dict[str, float]:
    """Relative Frobenius error per targeted leaf of the rank-``spec.rank`` truncation
    (what :func:`project_to_rank` drops), plus an ``__overall__`` aggregate."""
    return factors_error(factor_leaves(dense_delta, target_paths(spec, base_like)),
                         spec.rank)


def revive_adapters(adapters: Params, spec: AdapterSpec, seed: int = 0) -> Params:
    """Give dead adapter directions gradient flow without changing the delta.  A
    direction ``j`` is dead when ``A[:, j]`` and ``B[j, :]`` are both zero (every
    direction a truncated SVD zero-padded, and every direction at round 0); its ``A``
    column is redrawn as ``U(-s, s)`` with ``s = init_scale / sqrt(rank)`` while ``B``
    stays zero.  The draws are a host ``default_rng(seed)`` stream in the tree's leaf
    order, the JAX package's bit for bit."""
    host = np.random.default_rng(int(seed))
    s = spec.init_scale / math.sqrt(spec.rank)
    out: Params = {}
    for name, leaf in _tree(adapters).items():
        if not name.endswith("/A"):
            out[name] = leaf.to(torch.float32)
            continue
        a = leaf.to(torch.float32).clone()
        b = adapters[name[:-2] + "/B"].to(torch.float32)
        dead = (a.abs().sum(dim=0) == 0) & (b.abs().sum(dim=1) == 0)
        n_dead = int(dead.sum())
        if n_dead:
            fresh = host.uniform(-s, s, size=(a.shape[0], n_dead)).astype(np.float32)
            a[:, dead] = torch.from_numpy(fresh).to(a.device)
        out[name] = a
    return out


def redistribute(dense_delta: Params, profile: Any, base_like: Mapping[str, Any],
                 specs: dict[str, AdapterSpec] | None = None) -> dict[str, Params]:
    """One aggregated dense delta projected onto every tier of ``profile``:
    ``{tier_name: adapter_tree}``; ``specs`` defaults to ``profile.specs()``.  Each
    leaf is factored once for all the tiers (tiers of one target set)."""
    tier_specs = specs if specs is not None else profile.specs()
    names = profile.tier_names()
    paths = {tuple(target_paths(tier_specs[n], base_like)) for n in names}
    if len(paths) != 1:
        return {n: project_to_rank(dense_delta, tier_specs[n], base_like) for n in names}
    factors = factor_leaves(dense_delta, list(paths.pop()))
    return {n: truncate_factors(factors, tier_specs[n]) for n in names}
