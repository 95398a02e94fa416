"""Round engine for the network mode (counterpart of
``nanofed_tpu/communication/network_coordinator.py``).

Publish the global model, wait for ``ceil(min_clients * min_completion_rate)`` updates
or time out, aggregate, repeat.  The aggregation runs on ``device`` (default: the
card): the plain round stacks the buffered updates and reduces them with
``fedavg_combine`` (kernel B1); a secure round modular-sums the masked vectors on the
host and dequantizes the sum with kernel B6, and the dropout-tolerant variant
reconstructs the dropped clients' orphaned masks first (kernel B7 under the ``cuda``
backend).

This slice runs the synchronous rounds: plain FedAvg, the no-dropout masked round and
the dropout-tolerant masked round.  Later slices bring async FedBuff
(``NetworkRoundConfig.async_buffer_k``), validation and robust aggregation over the
wire, checkpoints (``state_store``), fault injection (``chaos``), telemetry and the
service's device gate; setting one raises ``NotImplementedError`` naming its slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Any

import torch

from nanofed_tpu_torch.aggregation.fedavg import fedavg_combine
from nanofed_tpu_torch.communication.http_server import (
    HTTPServer,
    refuse_later_slice_options,
)
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ClientMetrics, ClientUpdates, ModelUpdate, Params
from nanofed_tpu_torch.orchestration.engine import RoundLedger, completion_required
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger
from nanofed_tpu_torch.utils.trees import unravel

if TYPE_CHECKING:
    # Imported where used: secure_agg needs ``cryptography``, which the plain network
    # path must not require.
    from nanofed_tpu_torch.security.secure_agg import SecureAggregationConfig

#: Coordinator options of later slices, with the JAX defaults (accepted).
LATER_SLICE_OPTIONS: dict[str, tuple[Any, str]] = {
    "validation": (None, "update validation over the wire (network-validation item)"),
    "robust": (None, "robust aggregation over the wire (network-validation item)"),
    "telemetry_dir": (None, "telemetry (observability slice, queue A item 19)"),
    "registry": (None, "metrics registry (observability slice, queue A item 19)"),
    "state_store": (None, "round checkpoints (persistence slice)"),
    "chaos": (None, "fault injection (faults slice, queue A item 17)"),
    "device_gate": (None, "the service's device scheduler (service slice, queue A item 18)"),
}


@dataclass(frozen=True)
class NetworkRoundConfig:
    """Round settings of the network path: the JAX package's fields, less the
    FedBuff staleness settings, which come with the async slice."""

    num_rounds: int = 1
    min_clients: int = 1
    min_completion_rate: float = 1.0
    round_timeout_s: float = 300.0
    poll_interval_s: float = 0.05
    # Dropout-tolerant enrollment window: min_clients is a true MINIMUM; enrollment
    # stays open (up to max_clients) until the count has been quiet for
    # enrollment_grace_s, then the roster freezes.
    max_clients: int | None = None
    enrollment_grace_s: float = 1.0
    # Straggler eviction (sync, non-secure rounds): a seen client that misses this
    # many CONSECUTIVE rounds leaves the expected population; 0 disables.
    straggler_evict_after: int = 0
    # Asynchronous buffered aggregation (FedBuff): a later slice, which brings its
    # staleness settings with it; any value but None raises NotImplementedError.
    async_buffer_k: int | None = None


def _metric(metrics: dict, key: str, default: float, *alt_keys: str,
            positive: bool = False) -> float:
    """Defensive float coercion of a client-supplied metric: non-numeric or
    non-finite values (and, with ``positive``, values <= 0) fall back to
    ``default``, so one client's bad metrics JSON cannot kill the round."""
    for k in (key, *alt_keys):
        if k in metrics:
            try:
                v = float(metrics[k])
            except (TypeError, ValueError):
                continue
            if math.isfinite(v) and not (positive and v <= 0):
                return v
    return default


def stack_model_updates(updates: list[ModelUpdate], device: DeviceLike = None) -> ClientUpdates:
    """Stack ``ModelUpdate`` records into one batch on ``device``: leaves ``[C, ...]``,
    weights the clients' sample counts."""
    dev = resolve_device(device)
    params = {name: torch.stack([u.params[name] for u in updates]).to(dev)
              for name in updates[0].params}
    weights = torch.tensor(
        [_metric(u.metrics, "num_samples", 1.0, "samples_processed", positive=True)
         for u in updates], dtype=torch.float32, device=dev)
    metrics = ClientMetrics(
        loss=torch.tensor([_metric(u.metrics, "loss", 0.0) for u in updates],
                          dtype=torch.float32, device=dev),
        accuracy=torch.tensor([_metric(u.metrics, "accuracy", 0.0) for u in updates],
                              dtype=torch.float32, device=dev),
        samples=weights,
    )
    return ClientUpdates(params=params, weights=weights, metrics=metrics)


class NetworkCoordinator:
    """Drives federated rounds over an :class:`HTTPServer`.

    ``secure`` switches the rounds to Bonawitz secure aggregation: clients enroll
    (X25519 keys and sample counts), pre-scale their update by the server-published
    normalized weight, mask it with pairwise PRG streams, and the coordinator sees only
    masked vectors and the cohort's weighted mean.  By default every enrolled client
    must report or the round FAILS (a missing client's masks would not cancel); with
    ``secure.dropout_tolerant`` the double-masking variant recovers the round from the
    survivors.  The mask backend is the one the cohort enrolled with
    (``server.secagg_backend()``); the server's unmask arithmetic runs on ``device``.
    """

    def __init__(
        self,
        server: HTTPServer,
        params: Params,
        config: NetworkRoundConfig,
        secure: SecureAggregationConfig | None = None,
        clock: Clock | None = None,
        device: DeviceLike = None,
        **later_slice_options: Any,
    ) -> None:
        refuse_later_slice_options("NetworkCoordinator", later_slice_options,
                                   LATER_SLICE_OPTIONS)
        if config.async_buffer_k is not None:
            raise NotImplementedError(
                "NetworkCoordinator: async_buffer_k (async/FedBuff federation, "
                "network-ingest slice) not supported by this slice of nanofed_tpu_torch "
                "(run nanofed_tpu for it)")
        self.device = resolve_device(device)
        self.server = server
        self.params = {name: leaf.to(self.device) for name, leaf in params.items()}
        self.config = config
        self.secure = secure
        self.history: list[dict[str, Any]] = []
        self._clock = clock or SYSTEM_CLOCK
        self._log = Logger()
        self._ledger = RoundLedger()
        # Straggler accounting (sync rounds): consecutive missed rounds per ever-seen
        # client, and the evicted set the round barrier excludes.
        self._known_clients: set[str] = set()
        self._absence: dict[str, int] = {}
        self._evicted_stragglers: set[str] = set()

    @property
    def ledger(self) -> RoundLedger:
        return self._ledger

    async def _wait_for_clients(self, required: int) -> bool:
        """Poll the update buffer until ``required`` updates arrive or timeout."""
        deadline = self._clock.time() + self.config.round_timeout_s
        while self._clock.time() < deadline:
            if self.server.num_updates() >= required:
                return True
            await self._clock.sleep(self.config.poll_interval_s)
        return self.server.num_updates() >= required

    def _required_clients(self) -> int:
        """This round's barrier: the completion rate over the live expected population
        (min_clients minus evicted stragglers)."""
        return completion_required(self.config.min_clients - len(self._evicted_stragglers),
                                   self.config.min_completion_rate)

    def _note_participation(self, reported: set[str]) -> list[str]:
        """Track absences after a sync round's drain; returns the clients newly evicted.
        A returning evictee rejoins the expected set."""
        if self.config.straggler_evict_after <= 0:
            return []
        returned = reported & self._evicted_stragglers
        if returned:
            self._log.info("stragglers returned, rejoining the barrier: %s", sorted(returned))
            self._evicted_stragglers -= returned
        self._known_clients |= reported
        newly_evicted: list[str] = []
        for cid in reported:
            self._absence[cid] = 0
        for cid in sorted(self._known_clients - reported - self._evicted_stragglers):
            self._absence[cid] = self._absence.get(cid, 0) + 1
            if self._absence[cid] >= self.config.straggler_evict_after:
                self._evicted_stragglers.add(cid)
                newly_evicted.append(cid)
        if newly_evicted:
            self._log.warning("evicting stragglers after %d consecutive missed rounds: %s "
                              "(barrier degrades to %d required)",
                              self.config.straggler_evict_after, newly_evicted,
                              self._required_clients())
        return newly_evicted

    async def _tolerant_secure_round(self, round_number: int, required: int) -> dict[str, Any]:
        """One dropout-tolerant masked round (double masking): wait for the cohort until
        the timeout, then the UNMASK round: survivors reveal Shamir shares of dropped
        clients' pair keys and of survivors' self-mask seeds, the coordinator removes
        the orphaned masks, and the round completes as the weighted FedAvg of the
        survivors."""
        from nanofed_tpu_torch.security.secure_agg import dequantize_sum, recover_unmasked_sum

        cohort = self.server.secagg_active_order()
        expected = len(cohort)
        threshold = self.server.secagg_threshold() or self.secure.threshold
        if threshold > expected:
            self._log.warning("secure round %d FAILED: threshold %d exceeds active cohort %d",
                              round_number, threshold, expected)
            record = {"round": round_number, "status": "FAILED", "num_clients": 0,
                      "num_dropped": 0, "secure": True,
                      "reason": (f"threshold {threshold} exceeds the {expected}-"
                                 "client active cohort (unsatisfiable)")}
            self.history.append(record)
            return record
        deadline = self._clock.time() + self.config.round_timeout_s
        while self.server.num_masked_updates() < expected and self._clock.time() < deadline:
            await self._clock.sleep(self.config.poll_interval_s)
        masked = await self.server.drain_masked_updates()
        survivors = [c for c in cohort if c in masked]
        dropped = [c for c in cohort if c not in masked]

        def fail(reason: str) -> dict[str, Any]:
            self._log.warning("secure round %d FAILED: %s", round_number, reason)
            record = {"round": round_number, "status": "FAILED",
                      "num_clients": len(survivors), "num_dropped": len(dropped),
                      "secure": True, "reason": reason}
            self.history.append(record)
            return record

        # min_clients is the privacy floor; reveals are not solicited for a round that
        # cannot complete.
        floor = self.secure.min_clients
        if len(survivors) < max(required, threshold, floor, 1):
            reason = (f"{len(survivors)}/{expected} masked updates (need "
                      f"max(required={required}, threshold={threshold}, "
                      f"min_clients={floor}))")
            # Evict clients known dead (never everyone: a total stall is systemic):
            # the non-depositors if the share barrier stalled, else the non-submitters.
            if not self.server.secagg_shares_complete():
                alive = set(self.server.secagg_round_epks())
                gone = [c for c in cohort if c not in alive]
            else:
                gone = dropped
            if gone and len(gone) < len(cohort):
                await self.server.evict_secagg_clients(gone)
                reason += f"; evicted unresponsive clients {gone}"
            return fail(reason)
        epks = self.server.secagg_round_epks()
        missing_epks = [c for c in cohort if c not in epks]
        if any(c in survivors for c in missing_epks):
            return fail(f"survivors without ephemeral keys: {missing_epks}")
        # A client that dropped before depositing its shares added no masks anywhere.
        dropped_after_shares = [c for c in dropped if c in epks]
        # The survivors' SELF masks must be removed even with no dropouts.
        await self.server.open_unmask(round_number, dropped_after_shares, survivors)
        deadline = self._clock.time() + self.config.round_timeout_s
        while (self.server.num_unmask_reveals() < len(survivors)
               and self._clock.time() < deadline):
            await self._clock.sleep(self.config.poll_interval_s)
        reveals = await self.server.drain_unmask_reveals()
        if len(reveals) < threshold:
            if dropped and len(dropped) < len(cohort):
                await self.server.evict_secagg_clients(dropped)
            return fail(f"only {len(reveals)}/{len(survivors)} unmask reveals "
                        f"(threshold {threshold})")
        try:
            total = recover_unmasked_sum(
                masked, [c for c in cohort if c in epks], epks, round_number, reveals,
                replace(self.secure, threshold=threshold),
                backend=self.server.secagg_backend(),
                self_seed_commitments=self.server.secagg_round_commitments(),
                device=self.device,
            )
        except Exception as e:  # noqa: BLE001 - a failed recovery fails the round, not the run
            return fail(f"mask recovery failed: {e}")
        # Clients pre-scaled by full-cohort weights: renormalize to the survivors' mass.
        # B6 gives float32(dequantize(total)), exact while |total| < 2^24; the division
        # runs in float64 and rounds once, as the JAX package's host division does.
        weights = self.server.secagg_weights()
        survivor_mass = sum(weights[s] for s in survivors)
        flat = dequantize_sum(total, self.secure.frac_bits, self.device)
        self.params = unravel((flat.to(torch.float64) / survivor_mass).to(torch.float32),
                              self.params)
        if dropped:
            # Their round secrets were revealed: evict them.
            await self.server.evict_secagg_clients(dropped)
        record = {"round": round_number, "status": "COMPLETED",
                  "num_clients": len(survivors), "num_dropped": len(dropped), "secure": True}
        self.history.append(record)
        self._log.info("secure round %d: recovered aggregate from %d survivors (%d dropped)",
                       round_number, len(survivors), len(dropped))
        return record

    async def _secure_round(self, round_number: int, required: int) -> dict[str, Any]:
        """One masked round: wait for the FULL cohort, modular-sum, unmask."""
        if self.secure.dropout_tolerant:
            return await self._tolerant_secure_round(round_number, required)
        from nanofed_tpu_torch.security.secure_agg import unmask_sum

        cohort = self.server.secagg_client_order()
        expected = len(cohort)
        deadline = self._clock.time() + self.config.round_timeout_s
        while self.server.num_masked_updates() < expected and self._clock.time() < deadline:
            await self._clock.sleep(self.config.poll_interval_s)
        masked = await self.server.drain_masked_updates()
        if len(masked) < expected or expected < required:
            # Any missing cohort member leaves uncancelled pairwise masks in the sum.
            self._log.warning("secure round %d FAILED: %d/%d masked updates",
                              round_number, len(masked), expected)
            record = {"round": round_number, "status": "FAILED",
                      "num_clients": len(masked), "secure": True}
            self.history.append(record)
            return record
        # Clients pre-scaled by their normalized weight: once the masks cancel, the
        # modular sum IS the weighted mean.
        self.params = unmask_sum([masked[c] for c in cohort], self.params, self.secure,
                                 device=self.device)
        record = {"round": round_number, "status": "COMPLETED",
                  "num_clients": len(masked), "secure": True}
        self.history.append(record)
        self._log.info("secure round %d: aggregated %d masked updates", round_number,
                       len(masked))
        return record

    async def train_round(self, round_number: int) -> dict[str, Any]:
        """One federation round, charged to the ledger."""
        t0 = RoundLedger.now()
        record = await self._train_round_inner(round_number)
        self._ledger.charge(status=str(record.get("status", "?")),
                            num_clients=record.get("num_clients", 0),
                            duration_s=RoundLedger.now() - t0)
        return record

    async def _train_round_inner(self, round_number: int) -> dict[str, Any]:
        await self.server.publish_model(self.params, round_number)
        required = self._required_clients()
        if self.secure is not None:
            return await self._secure_round(round_number, required)
        ok = await self._wait_for_clients(required)
        updates = await self.server.drain_updates()
        newly_evicted = self._note_participation({u.client_id for u in updates})
        if not ok or len(updates) < required:
            self._log.warning("round %d FAILED: %d/%d updates", round_number, len(updates),
                              required)
            record = {"round": round_number, "status": "FAILED",
                      "num_clients": len(updates), "num_rejected": 0, "required": required}
        else:
            record = self._aggregate_round(round_number, updates)
            record["required"] = required
            self._log.info("round %d: %s", round_number, record["metrics"])
        if newly_evicted:
            record["evicted_stragglers"] = newly_evicted
        self.history.append(record)
        return record

    def _aggregate_round(self, round_number: int, updates: list[ModelUpdate]) -> dict[str, Any]:
        """Stack the drained updates on the device and fold them into the global params
        (weighted FedAvg, kernel B1 on the card)."""
        stacked = stack_model_updates(updates, self.device)
        self.params = fedavg_combine(stacked.params, stacked.weights)
        w = stacked.weights
        round_metrics = {
            "loss": float((stacked.metrics.loss * w).sum() / w.sum()),
            "accuracy": float((stacked.metrics.accuracy * w).sum() / w.sum()),
        }
        return {"round": round_number, "status": "COMPLETED", "num_clients": len(updates),
                "num_rejected": 0, "metrics": round_metrics}

    async def run(self) -> list[dict[str, Any]]:
        """All rounds, then signal termination to polling clients.  In secure mode,
        opens enrollment first and waits for the cohort."""
        if self.secure is not None:
            await self._enroll_cohort()
        for r in range(self.config.num_rounds):
            await self.train_round(r)
        self.server.stop_training()
        return self.history

    async def _enroll_cohort(self) -> None:
        """Open secure-aggregation enrollment for ``min_clients`` and wait for the
        cohort.  Dropout-tolerant mode enrolls in a window: the roster freezes once
        ``min_clients`` are in and the count has been quiet for
        ``enrollment_grace_s`` (or ``max_clients`` is reached), and the Shamir
        threshold derives from who enrolled (more than half, never below the
        configured one)."""
        tolerant = self.secure.dropout_tolerant
        if tolerant:
            await self.server.open_secagg(
                self.config.min_clients, window=True, max_clients=self.config.max_clients,
                threshold_for=lambda n: max(self.secure.threshold, n // 2 + 1),
            )
        else:
            await self.server.open_secagg(self.config.min_clients)
        deadline = self._clock.time() + self.config.round_timeout_s
        while (self.server.secagg_enrolled() < self.config.min_clients
               and self._clock.time() < deadline):
            await self._clock.sleep(self.config.poll_interval_s)
        if self.server.secagg_enrolled() < self.config.min_clients:
            self.server.stop_training()
            raise TimeoutError("secure-aggregation cohort incomplete before round 0")
        if not tolerant:
            return
        if not self.server.secagg_roster_complete():
            last_n, last_t = self.server.secagg_enrolled(), self._clock.time()
            while self._clock.time() < deadline:
                n = self.server.secagg_enrolled()
                if n != last_n:
                    last_n, last_t = n, self._clock.time()
                elif self._clock.time() - last_t >= self.config.enrollment_grace_s:
                    break
                if self.server.secagg_roster_complete():
                    break  # max_clients froze it implicitly
                await self._clock.sleep(self.config.poll_interval_s)
        n = await self.server.close_secagg()
        frozen_t = self.server.secagg_threshold()
        if frozen_t is not None and frozen_t > n:
            self.server.stop_training()
            raise ValueError(
                f"secure-aggregation threshold {frozen_t} exceeds the {n}-client cohort "
                "that enrolled; lower the configured threshold or raise min_clients")
        self._log.info("secagg cohort frozen: %d enrolled (min %d), threshold %s", n,
                       self.config.min_clients, frozen_t)
