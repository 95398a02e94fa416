"""Per-tier wire paths: one adapter tree, three codecs, isolated residuals
(counterpart of ``nanofed_tpu/fleet/wire.py``).

In a mixed fleet the same logical object, a tier's adapter tree, crosses the wire three
ways: a silo ships the whole tree as plain npz (``f32``), an edge box its factor-space
delta through the q8 quantizer, a phone the top-k sparsified delta.  This module owns
both halves of that contract:

* :func:`decode_tier_submit`, the server side: payload -> the full adapter tree the
  client now holds, by the tier's codec, against the tier's last published tree;
* :class:`TierClientState`, the client side without a transport: the delta-base pinning
  and topk8 error feedback of ``communication.http_client.HTTPClient``, one state a
  client, so a phone's unsent tail never leaks into another client's or another tier's
  accounting.  The staged-residual contract is the JAX package's: ``encode`` folds the
  residual in and stages the new tail, ``commit`` banks it, ``reject`` folds the whole
  delta into the residual and pins ``_pending_base`` at the local tree.

The q8 codec needs no residual (stochastic rounding is unbiased); topk8's dropped tail
does (error feedback).  Trees are flat dicts of CPU float32 tensors, and the arithmetic
is the codec's numpy float32, so bodies are byte-equal to the JAX package's for the
same trees and seeds.
"""

from __future__ import annotations

import math

import torch

from nanofed_tpu_torch.adapters.lora import AdapterSpec
from nanofed_tpu_torch.communication.codec import (
    decode_delta_topk8,
    decode_params,
    encode_delta_q8,
    encode_delta_topk8,
    encode_params,
    reconstruct_q8,
    reconstruct_topk8,
)
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.fleet.profile import CODEC_ENCODINGS, DeviceTier

__all__ = ["TierClientState", "decode_tier_submit"]


def decode_tier_submit(tier: DeviceTier, body: bytes, template: Params,
                       published: Params) -> Params:
    """Payload -> the full adapter tree the client holds, by the tier's codec.
    ``template`` checks an f32 payload's names, shapes and dtypes; ``published`` (the
    tree the server last served this tier) is the base both delta codecs reconstruct
    onto, in the codec's float32 arithmetic.  CPU tensors."""
    if tier.codec == "f32":
        return decode_params(body, like=template)
    if tier.codec == "q8":
        return reconstruct_q8(published, body)
    if tier.codec == "topk8":
        return reconstruct_topk8(published, body)
    raise NanoFedError(f"tier {tier.name!r}: unknown codec {tier.codec!r}")


def _f32(tree: Params) -> Params:
    return {name: leaf.detach().to("cpu", torch.float32) for name, leaf in tree.items()}


def _f32_delta(new: Params, base: Params) -> Params:
    base = _f32(base)
    return {name: leaf - base[name] for name, leaf in _f32(new).items()}


class TierClientState:
    """One client's wire state for one tier.

    A round: ``payload = encode(trained_tree)``, POST, then ``commit()`` on 200 or
    ``reject(trained_tree)`` otherwise; a fresh publish arrives by ``set_base(tree)``.
    For ``f32``/``q8`` commit and reject are bookkeeping; for ``topk8`` they are the
    staged-residual contract of ``HTTPClient.submit_update``."""

    def __init__(self, tier: DeviceTier, spec: AdapterSpec, base: Params):
        if spec.rank != tier.adapter_rank:
            raise NanoFedError(
                f"tier {tier.name!r} trains rank {tier.adapter_rank} but the "
                f"spec says rank {spec.rank}"
            )
        self.tier = tier
        self.spec = spec
        self.base = base  # the tier tree the server last published to us
        self._residual: Params | None = None  # topk8 error-feedback accumulator
        # After a rejected topk8 submit the whole unsent delta is in _residual;
        # _pending_base is the local tree that fold covered, so a retry measures only
        # the training after it.
        self._pending_base: Params | None = None
        self._staged_residual: Params | None = None
        self._pending_delta: Params | None = None
        self._last_body_len = 0
        self.bytes_sent = 0
        self.submits = 0

    @property
    def encoding(self) -> str:
        return CODEC_ENCODINGS[self.tier.codec]

    def set_base(self, base: Params) -> None:
        """A fresh published tier tree: later deltas measure against it.  The residual
        stays (it rides the next delta); retry bookkeeping resets."""
        self.base = base
        self._pending_base = None
        self._staged_residual = None

    def encode(self, new_tree: Params, seed: int | None = None) -> bytes:
        """The wire bytes for this client's local tree.  topk8 folds the residual in
        before encoding and stages (does not commit) the new unsent tail."""
        if self.tier.codec == "f32":
            body = encode_params(new_tree)
        else:
            delta_base = self._pending_base if self._pending_base is not None else self.base
            delta = _f32_delta(new_tree, delta_base)
            if self.tier.codec == "q8":
                body = encode_delta_q8(delta, seed=seed)
            else:
                if self._residual is not None:
                    delta = {name: d + self._residual[name] for name, d in delta.items()}
                body = encode_delta_topk8(delta, fraction=self.tier.topk_fraction, seed=seed)
                sent = decode_delta_topk8(body, like=self.base)
                # Staged, not committed: the sent mass leaves the residual only once
                # the server accepts, or a rejected submit would lose it on both sides.
                self._staged_residual = {name: d - sent[name].to(torch.float32)
                                         for name, d in delta.items()}
                self._pending_delta = delta
        self._last_body_len = len(body)
        return body

    def commit(self) -> None:
        """The server accepted: the staged residual becomes the residual, retry
        bookkeeping clears, byte accounting advances."""
        if self._staged_residual is not None:
            self._residual = self._staged_residual
            self._staged_residual = None
        self._pending_base = None
        self.bytes_sent += self._last_body_len
        self.submits += 1

    def reject(self, new_tree: Params) -> None:
        """The server rejected: nothing was applied there.  topk8 folds the whole
        combined delta into the residual and pins ``_pending_base`` at the local tree,
        so a retry carries only the training after the fold."""
        if self.tier.codec == "topk8" and self._staged_residual is not None:
            self._residual = self._pending_delta
            self._pending_base = new_tree
            self._staged_residual = None

    def residual_norm(self) -> float:
        """The l2 norm of the accumulated unsent tail, in float64 (0 without one)."""
        if self._residual is None:
            return 0.0
        return math.sqrt(sum(float(leaf.double().square().sum())
                             for leaf in self._residual.values()))
