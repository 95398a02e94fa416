"""The asyncio-facing half of batched ingest: a bounded decode pool and the drains
(counterpart of ``nanofed_tpu/ingest/pipeline.py``).

Every CPU-bound submit stage (npz decode, delta reconstruction, signature verify,
flattening) runs on a fixed-size worker pool, never on the event loop and never on
``asyncio.to_thread``'s growing pool.  The pipeline also keeps the flat float32 base
of every published version in the staleness window (the server's acceptance window,
pruned by the same rule), which delta flattening and FedBuff staleness key off.
Every mutation goes through the owning server's asyncio lock.
"""

from __future__ import annotations

import asyncio
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping

import numpy as np
import torch

from nanofed_tpu_torch.core.device import DeviceLike
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.ingest.buffer import DeviceIngestBuffer, IngestConfig, SlotMeta
from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry

__all__ = ["IngestPipeline", "flatten_params", "weight_from_metrics"]


def weight_from_metrics(metrics: Mapping[str, Any] | None) -> float:
    """A client-supplied sample count as a FedAvg weight: a non-numeric, non-finite or
    non-positive count falls back to 1.0."""
    for key in ("num_samples", "samples_processed"):
        if metrics and key in metrics:
            try:
                v = float(metrics[key])
            except (TypeError, ValueError):
                continue
            if math.isfinite(v) and v > 0:
                return v
    return 1.0


def flatten_params(params: Params) -> np.ndarray:
    """Host float32 ``[P]`` in ravel order (the params' order, each leaf C-order):
    the JAX package's ``ravel_pytree`` layout."""
    if not params:
        return np.zeros((0,), np.float32)
    return np.concatenate([leaf.detach().cpu().to(torch.float32).numpy().ravel()
                           for leaf in params.values()])


class IngestPipeline:
    """Bounded decode pool + device buffer + version base cache.  The owning
    ``HTTPServer`` builds one at its first ``publish_model`` (the template fixes P)
    and runs every ``offer``/``drain_*``/``note_version`` under its lock."""

    def __init__(self, template: Params, config: IngestConfig,
                 registry: MetricsRegistry | None = None, device: DeviceLike = None) -> None:
        self.config = config
        self.buffer = DeviceIngestBuffer(template, config.capacity, device=device)
        self._executor = ThreadPoolExecutor(max_workers=config.decode_workers,
                                            thread_name_prefix="nanofed-ingest-decode")
        self._version_flat: dict[int, np.ndarray] = {}
        self._queue_depth = 0
        self._busy_s = 0.0
        self._busy_lock = threading.Lock()  # += from concurrent pool workers
        reg = registry or get_registry()
        self._m_fill = reg.gauge("nanofed_ingest_buffer_fill",
                                 "Occupied slots in the device-resident ingest buffer")
        self._m_offers = reg.counter(
            "nanofed_ingest_offers_total",
            "Buffer offers by result (accepted / replaced / buffer_full)", labels=("result",))
        self._m_drains = reg.counter(
            "nanofed_ingest_drains_total",
            "Batched-reduce drains by policy (fedavg / fedbuff / fedavg_partial / "
            "fedbuff_partial)", labels=("policy",))
        self._m_batch = reg.histogram(
            "nanofed_ingest_drain_batch_size", "Client deltas folded per batched-reduce drain",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._m_decode_s = reg.histogram("nanofed_ingest_decode_seconds",
                                         "Wall time per decode-pool job (decode/verify/flatten)")
        self._m_queue = reg.gauge(
            "nanofed_ingest_decode_queue_depth",
            "Submit-pipeline jobs queued or running in the bounded decode pool")
        self._m_bytes = reg.gauge("nanofed_ingest_device_bytes",
                                  "Bytes preallocated for the device-resident ingest buffer")
        self._m_bytes.set(self.buffer.device_bytes)

    async def run_decode(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Run one CPU-bound submit stage on the bounded pool; its wall time lands in
        ``nanofed_ingest_decode_seconds`` and exceptions propagate unchanged."""

        def timed() -> Any:
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self._busy_lock:
                    self._busy_s += dt
                self._m_decode_s.observe(dt)

        self._queue_depth += 1
        self._m_queue.set(self._queue_depth)
        try:
            return await asyncio.get_running_loop().run_in_executor(self._executor, timed)
        finally:
            self._queue_depth -= 1
            self._m_queue.set(self._queue_depth)

    def decode_busy_seconds(self) -> float:
        """Total worker-busy wall seconds since construction (utilization =
        busy / (decode_workers * elapsed))."""
        return self._busy_s

    def close(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)

    def note_version(self, round_number: int, params: Params, window: int = 0) -> None:
        """Keep version ``round_number``'s flat base and prune to the staleness
        ``window`` (0: the current round only, the sync acceptance rule)."""
        self._version_flat[int(round_number)] = flatten_params(params)
        floor = int(round_number) - max(0, int(window))
        for old in [v for v in self._version_flat if v < floor]:
            del self._version_flat[old]

    def base_flat(self, round_number: int) -> np.ndarray | None:
        return self._version_flat.get(int(round_number))

    @property
    def fill(self) -> int:
        return self.buffer.fill

    def offer(self, flat_delta: Any, *, client_id: str, round_number: int,
              metrics: Mapping[str, Any] | None = None, trace: str = "") -> int | None:
        replaced = self.buffer.has_client(client_id)
        slot = self.buffer.offer(flat_delta, client_id=client_id, round_number=round_number,
                                 weight=weight_from_metrics(metrics), metrics=metrics or {},
                                 trace=trace)
        if slot is None:
            self._m_offers.inc(result="buffer_full")
        else:
            self._m_offers.inc(result="replaced" if replaced else "accepted")
        self._m_fill.set(self.buffer.fill)
        return slot

    def clear(self) -> int:
        dropped = self.buffer.clear()
        self._m_fill.set(0)
        return dropped

    def drain_fedavg(self, base_round: int) -> tuple[torch.Tensor | None, list[SlotMeta]]:
        """One FedAvg drain against version ``base_round``'s cached base:
        ``(new_flat, metas)``, or ``(None, [])`` on an empty buffer."""
        base = self.base_flat(base_round)
        if base is None:
            raise ValueError(f"no cached base for round {base_round}")
        out, metas = self.buffer.drain_fedavg(base)
        if metas:
            self._m_drains.inc(policy="fedavg")
            self._m_batch.observe(len(metas))
        self._m_fill.set(self.buffer.fill)
        return out, metas

    def drain_fedavg_partial(self) -> tuple[torch.Tensor | None, float, list[SlotMeta]]:
        """The host-local stage of a hierarchical FedAvg drain: the unnormalised
        ``(Σ w_i δ_i, Σ w_i, metas)`` of every occupied slot, with no base (the apply
        runs once, after the cross-host all-reduce of the partials)."""
        out, mass, metas = self.buffer.drain_fedavg_partial()
        if metas:
            self._m_drains.inc(policy="fedavg_partial")
            self._m_batch.observe(len(metas))
        self._m_fill.set(self.buffer.fill)
        return out, mass, metas

    def drain_fedbuff_partial(self, k: int, current_version: int,
                              staleness_exponent: float = 0.5
                              ) -> tuple[torch.Tensor, list[SlotMeta], dict]:
        """The host-local stage of a hierarchical FedBuff drain: the unnormalised
        discounted sum of this host's K oldest in-window slots (``server_lr`` and the
        global ``1/K`` apply after the cross-host all-reduce); the cached version
        window decides which bases are in window, as in :meth:`drain_fedbuff`."""
        try:
            out, metas, stats = self.buffer.drain_fedbuff_partial(
                k, current_version, self._version_flat,
                staleness_exponent=staleness_exponent)
        finally:
            self._m_fill.set(self.buffer.fill)
        self._m_drains.inc(policy="fedbuff_partial")
        self._m_batch.observe(len(metas))
        return out, metas, stats

    def drain_fedbuff(self, k: int, current_version: int, staleness_exponent: float = 0.5,
                      server_lr: float = 1.0) -> tuple[torch.Tensor, list[SlotMeta], dict]:
        """One FedBuff drain of the K oldest slots applied to the current version; the
        cached version window decides which bases are in window."""
        base = self.base_flat(current_version)
        if base is None:
            raise ValueError(f"no cached base for version {current_version}")
        try:
            out, metas, stats = self.buffer.drain_fedbuff(
                k, current_version, self._version_flat, base,
                staleness_exponent=staleness_exponent, server_lr=server_lr)
        finally:
            self._m_fill.set(self.buffer.fill)
        self._m_drains.inc(policy="fedbuff")
        self._m_batch.observe(len(metas))
        return out, metas, stats
