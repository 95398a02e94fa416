"""Server-side fleet state: per-tier published views over one dense global
(counterpart of ``nanofed_tpu/fleet/gateway.py``).

In fleet mode the server's global model stays a dense params dict, published each
round and aggregated through the ingest buffer in flat dense-delta space.  What changes
is the edge: each tier sees the global through its own low-rank window, and the
:class:`FleetGateway` owns that edge.

* :meth:`FleetGateway.publish` forms the dense delta of the new global against the
  frozen round-0 base and projects it onto every tier's rank by truncated SVD, reviving
  zero-padded directions with the LoRA init draw (``revive_adapters``: every tier's
  view is rank-deficient at round 0).  A view is the projected adapter tree (host
  tensors), its npz payload (what ``GET /model`` with a tier header serves) and its
  flat dense image (the base tier submits are measured against).
* :meth:`FleetGateway.decode_submit` decodes a tier submit (any codec) into the adapter
  tree the client holds, densifies it and returns the flat dense delta against the
  tier's view: a row for the ingest buffer, which never learns tiers exist.

Views are versioned with the ingest pipeline's window rule, so wire acceptance and
tier-delta reconstruction agree on which rounds are alive; ``stats()`` is the JAX
gateway's.

Stated differences, each pinned by a test in ``tests/test_torch_fleet.py``:

* a publish factors each targeted leaf ONCE, in float64 on the gateway's ``device``
  (``torch.linalg.svd``, batched by shape), and cuts that one factorization to every
  tier's rank; the JAX gateway runs one host float64 SVD a leaf a tier.  The SVD of a
  leaf does not depend on the rank it is cut to, so the views are the same numbers;
* the dense images and submit rows are built on ``device`` (a view's ``flat_dense`` is
  a tensor there, a submit's row too, which the ingest buffer copies into its slot on
  the card); the JAX gateway builds numpy rows on the host.  On the card this route
  was the faster one (PERF.md, phase (fl1)).

``device=None`` means the card and raises without one; tests pass ``device="cpu"``.
``last_publish_s`` holds the last publish's seconds: the factorization, the tier views
(truncation, revival and dense images) and the payload encoding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Mapping

import torch

from nanofed_tpu_torch.adapters.lora import AdapterSpec, target_paths
from nanofed_tpu_torch.communication.codec import encode_params
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.fleet.aggregate import factor_leaves, revive_adapters, truncate_factors
from nanofed_tpu_torch.fleet.profile import FleetProfile
from nanofed_tpu_torch.fleet.wire import decode_tier_submit

__all__ = ["FleetGateway", "TierView"]


@dataclass(frozen=True)
class TierView:
    """One tier's published window onto one round's global model."""

    tree: Params  # the tier-rank adapter tree, CPU tensors (what the tier fetches)
    flat_dense: torch.Tensor  # flat dense image of ``tree``, [P] float32 on the device
    payload: bytes  # npz of ``tree``: the GET /model body for this tier


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape") else leaf))


class FleetGateway:
    """Per-tier publish and decode state for an ``HTTPServer(fleet=)``.

    ``base_like`` is the frozen round-0 base the whole fleet adapts (a params dict);
    every dense delta, published or submitted, is measured against it.
    ``spec_kwargs`` (targets, min_dim, ...) are shared across tiers as
    ``FleetProfile.specs`` shares them; ranks come from the tiers."""

    def __init__(self, profile: FleetProfile, base_like: Params,
                 spec_kwargs: dict[str, Any] | None = None, revive_seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.profile = profile
        self.device = resolve_device(device)
        self.specs: dict[str, AdapterSpec] = profile.specs(**(spec_kwargs or {}))
        self.revive_seed = revive_seed
        self.current_round: int | None = None
        self._views: dict[int, dict[str, TierView]] = {}  # round -> tier -> view
        self.base_like = {name: _shape(leaf) for name, leaf in base_like.items()}
        paths = {tuple(target_paths(spec, base_like)) for spec in self.specs.values()}
        if len(paths) != 1:
            raise NanoFedError("every tier of a fleet must target the same leaves")
        self._paths = list(paths.pop())
        # Each targeted leaf's (offset, shape) in the flat [P] ravel order.
        self._slices: dict[str, tuple[int, tuple[int, ...]]] = {}
        offset = 0
        for name, shape in self.base_like.items():
            if name in self._paths:
                self._slices[name] = (offset, shape)
            offset += int(torch.Size(shape).numel())
        self.flat_size = offset
        self._base = {name: base_like[name].detach().to(self.device, torch.float32)
                      for name in self._paths}
        self.last_publish_s: dict[str, float] = {}

    def spec(self, tier_name: str) -> AdapterSpec:
        try:
            return self.specs[tier_name]
        except KeyError:
            raise NanoFedError(
                f"fleet profile {self.profile.name!r} has no tier {tier_name!r}"
            ) from None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dense_image(self, spec: AdapterSpec, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``ravel(adapter_delta(spec, base, tree))`` as one [P] float32 tensor on the
        device, written leaf by leaf (``scaling * A @ B``, zeros off the targets)."""
        out = torch.zeros(self.flat_size, dtype=torch.float32, device=self.device)
        for name, (offset, shape) in self._slices.items():
            a = tree[f"{name}/A"].to(self.device, torch.float32)
            b = tree[f"{name}/B"].to(self.device, torch.float32)
            leaf = out[offset:offset + shape[0] * shape[1]].view(shape)
            torch.matmul(a, b, out=leaf)
            leaf.mul_(spec.scaling)
        return out

    # ------------------------------------------------------------------
    # Publish side
    # ------------------------------------------------------------------

    def publish(self, round_number: int, params: Params, window: int = 0) -> None:
        """Project the new global onto every tier and version the views with the ingest
        pipeline's pruning rule (keep ``[round - window, round]``)."""
        t0 = time.perf_counter()
        dense = {name: params[name].detach().to(self.device, torch.float32) - base
                 for name, base in self._base.items()}
        factors = factor_leaves(dense, self._paths)
        del dense
        self._sync()
        t1 = time.perf_counter()
        trees: dict[str, Params] = {}
        images: dict[str, torch.Tensor] = {}
        for name, spec in self.specs.items():
            tree = revive_adapters(truncate_factors(factors, spec), spec,
                                   seed=self.revive_seed + round_number)
            images[name] = self.dense_image(spec, tree)
            trees[name] = {k: v.cpu() for k, v in tree.items()}
        del factors
        self._sync()
        t2 = time.perf_counter()
        views = {name: TierView(tree=trees[name], flat_dense=images[name],
                                payload=encode_params(trees[name]))
                 for name in self.specs}
        self.last_publish_s = {"factor_s": t1 - t0, "views_s": t2 - t1,
                               "encode_s": time.perf_counter() - t2}
        self._views[round_number] = views
        self.current_round = round_number
        floor = round_number - max(0, window)
        for old in [r for r in self._views if r < floor]:
            del self._views[old]

    def view(self, tier_name: str, round_number: int | None = None) -> TierView:
        """The tier's view for ``round_number`` (default: current); raises outside the
        live window, which the server maps onto its stale-round rejection."""
        rnd = self.current_round if round_number is None else round_number
        views = self._views.get(rnd)
        if views is None or tier_name not in views:
            raise NanoFedError(
                f"no published fleet view for tier {tier_name!r} at round {rnd}"
            )
        return views[tier_name]

    def payload(self, tier_name: str, round_number: int | None = None) -> bytes:
        """The npz body ``GET /model`` serves a client of this tier."""
        return self.view(tier_name, round_number).payload

    # ------------------------------------------------------------------
    # Submit side
    # ------------------------------------------------------------------

    def decode_submit(self, tier_name: str, body: bytes, round_number: int) -> torch.Tensor:
        """Tier payload -> the flat dense-delta row for the ingest buffer: decoded by the
        tier's codec against the tier's view for the client's round (host), densified
        and measured against the view's dense image (on the device).  The server runs
        it in its decode pool; it ends in a synchronize, so the pool's time is the
        row's."""
        tier = self.profile.tier(tier_name)
        view = self.view(tier_name, round_number)
        new_tree = decode_tier_submit(tier, body, template=view.tree, published=view.tree)
        row = self.dense_image(self.spec(tier_name), new_tree).sub_(view.flat_dense)
        self._sync()
        return row

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        """Per-tier shape of the current views (rank, codec, payload bytes) and the live
        rounds, for ``/status`` surfaces and the fleet telemetry record."""
        out: dict[str, Any] = {
            "profile": self.profile.name,
            "round": self.current_round,
            "live_rounds": sorted(self._views),
            "tiers": {},
        }
        if self.current_round is not None:
            for name, v in self._views[self.current_round].items():
                out["tiers"][name] = {
                    "rank": self.spec(name).rank,
                    "codec": self.profile.tier(name).codec,
                    "payload_bytes": len(v.payload),
                }
        return out
