"""The device-resident ingest buffer: fixed slots, one batched product per drain
(counterpart of ``nanofed_tpu/ingest/buffer.py``).

Layout: one preallocated ``[capacity, P]`` float32 tensor of flattened client deltas
on the card, plus host-side slot bookkeeping: a free list and per-slot metadata
(client id, base round, aggregation weight, metrics, arrival sequence).  An accepted
offer stages its host row (no device work on the serving event loop); the staged rows
reach the card in one ``index_copy_`` at the next drain.  A row that is already a
tensor (a fleet tier's submit, densified on the card by ``fleet.FleetGateway``) is
copied into its slot at once: the JAX buffer takes host rows only.  A drain is one product::

    new_flat = base_flat + coefs @ buffer        # torch.addmv, [P] + [capacity]·[capacity, P]

with the policy in a host coefficient vector: FedAvg ``w_i / Σw`` on the drained
slots, FedBuff ``lr · (1+τ_i)^-α / K``, exact 0.0 elsewhere.  The partial drains are
the host-local stage of a hierarchical federation (``communication.federation``):
the same product with no base and unnormalised coefficients (``w_i``, or
``(1+τ_i)^-α``), because the normaliser is global.  The JAX package computes
the same product as a plain ``jnp`` expression outside any Pallas kernel, so this is
no port of a kernel.

One difference from the reference: a slot's row is zeroed on the card when the slot
is freed.  The reference keeps a freed row's contents and relies on its 0.0
coefficient, but ``0 × NaN`` is NaN: a non-finite delta (ingest cannot combine with
validation) would otherwise reach every later drain (ROADMAP, the freed-slot finding).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping, NamedTuple

import numpy as np
import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.utils.trees import tree_size

__all__ = ["DeviceIngestBuffer", "IngestConfig", "SlotMeta"]


@dataclass(frozen=True)
class IngestConfig:
    """``capacity`` bounds the card's memory (``capacity * P * 4`` bytes) and is the
    backpressure point: a submit arriving at a full buffer is answered 429 +
    Retry-After.  ``decode_workers`` sizes the bounded decode pool.  The JAX
    package's ``batch_size`` sizes the compiled flush programs it warms; the port
    compiles nothing, so it has no such field."""

    capacity: int = 256
    decode_workers: int = 4

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.decode_workers < 1:
            raise ValueError("decode_workers must be >= 1")


class SlotMeta(NamedTuple):
    """Host record of one occupied slot."""

    slot: int
    client_id: str
    round_number: int  # the base version this delta was computed against
    weight: float  # FedAvg aggregation weight (client sample count)
    metrics: Mapping[str, Any]
    seq: int  # arrival order: FedBuff drains the K oldest
    trace: str = ""  # the submit's X-NanoFed-Trace trace id; "" when untraced


def _fedbuff_stats(live: list[SlotMeta], skipped: int, staleness: list[int],
                   discounts: list[float]) -> dict[str, Any]:
    return {
        "num_aggregated": len(live),
        "num_skipped_out_of_window": skipped,
        "staleness": staleness,
        "mean_staleness": float(np.mean(staleness)),
        "discounts": [round(float(d), 4) for d in discounts],
    }


class DeviceIngestBuffer:
    """Preallocated slot buffer of flattened client deltas on ``device`` (default:
    the card).  Not thread-safe by itself: the owning ``IngestPipeline`` runs every
    mutation under the HTTP server's lock."""

    def __init__(self, template: Params, capacity: int, device: DeviceLike = None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.flat_size = tree_size(template)
        self.capacity = int(capacity)
        self._buf = torch.zeros((self.capacity, self.flat_size), dtype=torch.float32,
                                device=self.device)
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self._meta: dict[int, SlotMeta] = {}
        self._client_slot: dict[str, int] = {}
        self._seq = 0
        self._staged: dict[int, np.ndarray] = {}  # slot -> host row, flushed at a drain
        self._dirty: set[int] = set()  # slots whose card row holds a flushed delta

    @property
    def fill(self) -> int:
        return len(self._meta)

    @property
    def device_bytes(self) -> int:
        return self.capacity * self.flat_size * 4

    def occupied(self) -> list[SlotMeta]:
        """Occupied slots in arrival order."""
        return sorted(self._meta.values(), key=lambda m: m.seq)

    def client_ids(self) -> set[str]:
        """The clients holding a live slot (a copy; :meth:`has_client` asks for one)."""
        return set(self._client_slot)

    def has_client(self, client_id: str) -> bool:
        return client_id in self._client_slot

    def offer(self, flat_delta: Any, *, client_id: str, round_number: int, weight: float,
              metrics: Mapping[str, Any] | None = None, trace: str = "") -> int | None:
        """Stage one client's flattened delta into a slot; the slot, or None when the
        buffer is full.  ``trace`` is the submit's trace id, kept in the slot's record.  One live slot per client: a client's newer submit replaces
        its unaggregated older one in place (latest wins).  A host array is staged and
        reaches the card at the next drain; a tensor (a fleet tier's row, built on the
        card) is copied into its slot at once."""
        slot = self._client_slot.get(client_id)
        if slot is None:
            if not self._free:
                return None
            slot = self._free.pop()
        row = flat_delta if torch.is_tensor(flat_delta) else np.asarray(flat_delta, np.float32)
        if tuple(row.shape) != (self.flat_size,):
            raise ValueError(f"flat delta shape {tuple(row.shape)} != ({self.flat_size},)")
        if torch.is_tensor(row):
            self._staged.pop(slot, None)
            self._buf[slot].copy_(row)
            self._dirty.add(slot)
        else:
            self._staged[slot] = row
        self._seq += 1
        self._meta[slot] = SlotMeta(slot=slot, client_id=client_id,
                                    round_number=int(round_number), weight=float(weight),
                                    metrics=dict(metrics or {}), seq=self._seq,
                                    trace=trace)
        self._client_slot[client_id] = slot
        return slot

    def _release(self, slots: Iterable[int]) -> None:
        """Free slots; the card rows they held are zeroed in one launch."""
        zero = []
        for slot in slots:
            meta = self._meta.pop(slot, None)
            if meta is None:
                continue
            self._staged.pop(slot, None)
            if slot in self._dirty:
                zero.append(slot)
                self._dirty.discard(slot)
            if self._client_slot.get(meta.client_id) == slot:
                del self._client_slot[meta.client_id]
            self._free.append(slot)
        if zero:
            self._buf.index_fill_(0, torch.tensor(zero, device=self.device), 0.0)

    def _flush(self) -> None:
        """Every staged row onto the card in one ``index_copy_``."""
        if not self._staged:
            return
        slots = list(self._staged)
        rows = torch.from_numpy(np.stack([self._staged[s] for s in slots]))
        self._buf.index_copy_(0, torch.tensor(slots, device=self.device),
                              rows.to(self.device, non_blocking=False))
        self._dirty.update(slots)
        self._staged.clear()

    def clear(self) -> int:
        """Free every slot (a sync round's publish); returns how many were dropped."""
        n = self.fill
        self._release(list(self._meta))
        return n

    def _run_reduce(self, coefs: np.ndarray, base_flat: Any = None) -> torch.Tensor:
        """``base + coefs @ buffer``, or ``coefs @ buffer`` without a base."""
        coefs_dev = torch.from_numpy(coefs).to(self.device)
        if base_flat is None:
            self._flush()
            return torch.mv(self._buf.t(), coefs_dev)
        base = torch.as_tensor(np.asarray(base_flat, np.float32)).to(self.device)
        if base.shape != (self.flat_size,):
            raise ValueError(f"base shape {tuple(base.shape)} != ({self.flat_size},)")
        self._flush()
        return torch.addmv(base, self._buf.t(), coefs_dev)

    def drain_fedavg(self, base_flat: Any) -> tuple[torch.Tensor | None, list[SlotMeta]]:
        """Drain every occupied slot as one weighted FedAvg step,
        ``base + Σ (w_i/Σw) δ_i``: ``(new_flat, metas)``, or ``(None, [])`` when empty."""
        metas = self.occupied()
        if not metas:
            return None, []
        total = sum(m.weight for m in metas)
        coefs = np.zeros(self.capacity, np.float32)
        for m in metas:
            coefs[m.slot] = m.weight / total
        out = self._run_reduce(coefs, base_flat)
        self._release([m.slot for m in metas])
        return out, metas

    def drain_fedavg_partial(self) -> tuple[torch.Tensor | None, float, list[SlotMeta]]:
        """Drain every occupied slot as the host-local stage of a hierarchical FedAvg:
        ``(Σ w_i δ_i, Σ w_i, metas)``, unnormalised, because the normaliser is global.
        Summing the hosts' partials (one cross-host all-reduce of numerator ‖ mass)
        and dividing once gives :meth:`drain_fedavg` of the union of the buffers.
        ``(None, 0.0, [])`` when empty (such a host adds zeros to the all-reduce)."""
        metas = self.occupied()
        if not metas:
            return None, 0.0, []
        coefs = np.zeros(self.capacity, np.float32)
        for m in metas:
            coefs[m.slot] = m.weight
        out = self._run_reduce(coefs)
        self._release([m.slot for m in metas])
        return out, float(sum(m.weight for m in metas)), metas

    def drain_fedbuff_partial(self, k: int, current_version: int,
                              valid_versions: Iterable[int], staleness_exponent: float = 0.5
                              ) -> tuple[torch.Tensor, list[SlotMeta], dict]:
        """The host-local stage of a hierarchical FedBuff step: this host's K oldest
        slots' in-window ones as the unnormalised discounted sum ``Σ (1+τ_i)^-α δ_i``
        (no ``server_lr`` and no ``1/K``: both are global, applied after the
        cross-host all-reduce of numerator ‖ live count).  The window, skip and
        consume contract is :meth:`drain_fedbuff`'s, the all-out-of-window
        ``ValueError`` included."""
        window = {int(v) for v in valid_versions}
        metas = self.occupied()[: max(1, int(k))]
        live = [m for m in metas if m.round_number in window]
        skipped = len(metas) - len(live)
        if not live:
            self._release([m.slot for m in metas])
            raise ValueError(f"no aggregatable updates: all {skipped} buffered bases have "
                             "left the version window")
        coefs = np.zeros(self.capacity, np.float32)
        staleness, discounts = [], []
        for m in live:
            s = current_version - m.round_number
            d = (1.0 + s) ** (-staleness_exponent)
            staleness.append(s)
            discounts.append(d)
            coefs[m.slot] = d
        out = self._run_reduce(coefs)
        self._release([m.slot for m in metas])
        return out, live, _fedbuff_stats(live, skipped, staleness, discounts)

    def drain_fedbuff(self, k: int, current_version: int, valid_versions: Iterable[int],
                      base_flat: Any, staleness_exponent: float = 0.5,
                      server_lr: float = 1.0) -> tuple[torch.Tensor, list[SlotMeta], dict]:
        """Drain the K oldest slots as one FedBuff step,
        ``base + lr · (1/K) Σ (1+τ_i)^-α δ_i`` over the in-window ones (K their count).
        Out-of-window slots are consumed with a 0.0 coefficient; newer slots stay.
        Raises ``ValueError`` when every drained slot is out of window."""
        window = {int(v) for v in valid_versions}
        metas = self.occupied()[: max(1, int(k))]
        live = [m for m in metas if m.round_number in window]
        skipped = len(metas) - len(live)
        if not live:
            self._release([m.slot for m in metas])
            raise ValueError(f"no aggregatable updates: all {skipped} buffered bases have "
                             "left the version window")
        coefs = np.zeros(self.capacity, np.float32)
        staleness, discounts = [], []
        for m in live:
            s = current_version - m.round_number
            d = (1.0 + s) ** (-staleness_exponent)
            staleness.append(s)
            discounts.append(d)
            coefs[m.slot] = server_lr * d / len(live)
        out = self._run_reduce(coefs, base_flat)
        self._release([m.slot for m in metas])
        return out, live, _fedbuff_stats(live, skipped, staleness, discounts)
