"""Round engine for the network mode (counterpart of
``nanofed_tpu/communication/network_coordinator.py``).

Publish the global model, wait for ``ceil(min_clients * min_completion_rate)`` updates
or time out, aggregate, repeat.  The aggregation runs on ``device`` (default: the
card): the plain round stacks the buffered updates and reduces them with
``fedavg_combine`` (kernel B1); a secure round modular-sums the masked vectors on the
host and dequantizes the sum with kernel B6, and the dropout-tolerant variant
reconstructs the dropped clients' orphaned masks first (kernel B7 under the ``cuda``
backend).

Synchronous rounds: plain FedAvg, validated (``validation=``: shape, range and a
leave-one-out z-score on the host, float64 norms as in the JAX package), robust
(``robust=``: trimmed mean, median or Multi-Krum, unweighted, the reported loss and
accuracy riding the same estimator), the no-dropout masked round and the
dropout-tolerant masked round.  Asynchronous rounds: FedBuff
(``NetworkRoundConfig.async_buffer_k``), each aggregation the K oldest buffered updates
of any in-window version, discounted by ``(1+τ)^-α``.  On a server with ``ingest=``
both run on the device buffer's one-product drains.

With ``state_store=`` (``persistence.FileStateStore``) every COMPLETED round or
aggregation is checkpointed off the event loop (the params as the JAX package's nested
numpy dict, and the evicted stragglers), and a new coordinator resumes from the latest
checkpoint of either package: it publishes the restored params at the round after it.

Observability, as the JAX engine's: every round is a ``round`` span over ``publish``,
``cohort-sample`` (the barrier wait and the drain) and ``aggregate`` (or
``secure-aggregate``), each FedBuff aggregation the same under ``aggregation=``; the
outcome is charged to the ``RoundLedger`` on ``registry`` (default: the server's), with
the validation-reject and straggler-eviction counters beside it.  With
``telemetry_dir`` the spans and ``round`` records stream into ``telemetry.jsonl``,
closed with the registry snapshot when :meth:`NetworkCoordinator.run` exits.
Fault injection (``chaos``) and the service's device gate come with later items;
setting one raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from nanofed_tpu_torch.aggregation.fedavg import fedavg_combine
from nanofed_tpu_torch.aggregation.robust import (
    RobustAggregationConfig,
    robust_aggregate,
    robust_floor,
)
from nanofed_tpu_torch.communication.http_server import (
    HTTPServer,
    refuse_later_slice_options,
)
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ClientMetrics, ClientUpdates, ModelUpdate, Params
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.observability.spans import SpanTracer
from nanofed_tpu_torch.observability.telemetry import RunTelemetry
from nanofed_tpu_torch.orchestration.engine import RoundLedger, completion_required
from nanofed_tpu_torch.persistence import FileStateStore
from nanofed_tpu_torch.security.validation import (
    ValidationConfig,
    ValidationResult,
    loo_zscore,
    reference_shapes,
    update_flat_norm,
    validate_range,
    validate_shape,
)
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger
from nanofed_tpu_torch.utils.trees import (
    from_checkpoint_params,
    ravel_stacked,
    to_numpy_params,
    unravel,
)

if TYPE_CHECKING:
    # Imported where used: secure_agg needs ``cryptography``, which the plain network
    # path must not require.
    from nanofed_tpu_torch.security.secure_agg import SecureAggregationConfig

#: Coordinator options of later slices, with the JAX defaults (accepted).
LATER_SLICE_OPTIONS: dict[str, tuple[Any, str]] = {
    "chaos": (None, "fault injection (faults slice, queue A item 17)"),
    "device_gate": (None, "the service's device scheduler (service slice, queue A item 18)"),
}


@dataclass(frozen=True)
class NetworkRoundConfig:
    """Round settings of the network path (the JAX package's fields)."""

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
    # Asynchronous buffered aggregation (FedBuff): aggregate as soon as async_buffer_k
    # updates are buffered; updates on any of the last staleness_window published
    # versions count, discounted by (1 + staleness)^-staleness_exponent.  num_rounds
    # then counts aggregations.
    async_buffer_k: int | None = None
    staleness_window: int = 4
    staleness_exponent: float = 0.5
    async_server_lr: float = 1.0

    def __post_init__(self) -> None:
        if self.async_buffer_k is not None:
            if self.async_buffer_k < 1:
                raise ValueError("async_buffer_k must be >= 1")
            if self.staleness_window < 1:
                raise ValueError("async mode needs staleness_window >= 1")
            if self.staleness_exponent < 0:
                raise ValueError("staleness_exponent must be >= 0")
            if self.async_server_lr <= 0:
                raise ValueError("async_server_lr must be > 0")


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


def fedbuff_combine(
    global_params: Params,
    updates: list[ModelUpdate],
    version_params: dict[int, Params],
    current_version: int,
    staleness_exponent: float = 0.5,
    server_lr: float = 1.0,
    device: DeviceLike = None,
) -> tuple[Params, dict[str, Any]]:
    """FedBuff aggregation (Nguyen et al. 2022) on ``device`` (default: the card):
    ``global + lr · (1/K) Σ (1+τ_i)^-α δ_i``, each delta against the version its client
    trained from (``version_params[round_number]``), unnormalised, unweighted by
    sample counts.  Updates whose base has left the window are skipped.  Raises
    ``ValueError`` when nothing is aggregatable.

    The arithmetic is the JAX package's float32 (each discount over K rounded to
    float32, products and sums in float32), but the discounted deltas are summed in
    client-id order where the JAX package sums them in arrival order, so the result
    does not depend on which update arrived first.  The stats list the updates in
    the order given."""
    dev = resolve_device(device)
    live, discounts, staleness, skipped = [], [], [], 0
    for u in updates:
        if u.round_number not in version_params:
            skipped += 1
            continue
        s = current_version - u.round_number
        live.append(u)
        discounts.append((1.0 + s) ** (-staleness_exponent))
        staleness.append(s)
    if not live:
        raise ValueError(f"no aggregatable updates: all {skipped} buffered bases have left "
                         "the version window")
    k = len(live)
    # One coefficient per update: two updates of one client carry their own
    # staleness.  The stable sort keeps a repeated client's updates in buffer order.
    coefs = [float(np.float32(d / k)) for d in discounts]
    agg = {name: torch.zeros(leaf.shape, dtype=torch.float32, device=dev)
           for name, leaf in global_params.items()}
    for i in sorted(range(k), key=lambda i: live[i].client_id):
        u, base = live[i], version_params[live[i].round_number]
        for name, acc in agg.items():
            delta = (u.params[name].to(dev, torch.float32)
                     - base[name].to(dev, torch.float32))
            acc += coefs[i] * delta
    lr = float(np.float32(server_lr))
    new_params = {name: (g.to(dev, torch.float32) + lr * agg[name]).to(g.dtype)
                  for name, g in global_params.items()}
    stats = {
        "num_aggregated": k,
        "num_skipped_out_of_window": skipped,
        "staleness": staleness,
        "mean_staleness": float(np.mean(staleness)),
        "discounts": [round(float(d), 4) for d in discounts],
    }
    return new_params, stats


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

    ``validation`` (a ``ValidationConfig``) drops invalid drained updates before they
    reach the aggregate: wrong shape, non-finite or over ``max_norm`` per leaf, then
    the leave-one-out z-score over the range-valid survivors.  ``robust`` (a
    ``RobustAggregationConfig``) replaces the weighted FedAvg by the robust estimator;
    it cannot combine with ``secure`` (the server sees only masked vectors).  Neither
    combines with asynchronous rounds or with a server's ingest buffer, as in the JAX
    package.
    """

    def __init__(
        self,
        server: HTTPServer,
        params: Params,
        config: NetworkRoundConfig,
        validation: ValidationConfig | None = None,
        secure: SecureAggregationConfig | None = None,
        robust: RobustAggregationConfig | None = None,
        clock: Clock | None = None,
        device: DeviceLike = None,
        state_store: FileStateStore | None = None,
        telemetry_dir: str | Path | None = None,
        registry: MetricsRegistry | None = None,
        **later_slice_options: Any,
    ) -> None:
        refuse_later_slice_options("NetworkCoordinator", later_slice_options,
                                   LATER_SLICE_OPTIONS)
        if robust is not None and secure is not None:
            raise ValueError(
                "robust= cannot be combined with secure=: the server only ever "
                "sees masked (uniformly random) vectors, so it cannot compute "
                "order statistics over individual updates — that blindness is the "
                "point of secure aggregation"
            )
        if server.ingest is not None:
            bad = [name for name, v in (("validation", validation), ("robust", robust))
                   if v is not None]
            if bad:
                raise ValueError(
                    f"batched ingest (server ingest=) cannot be combined with "
                    f"{', '.join(bad)} — these inspect INDIVIDUAL updates, "
                    "which the device-resident buffer folds away at submit "
                    "time; disable ingest or drop the per-update mechanism"
                )
        if config.async_buffer_k is not None:
            bad = [name for name, v in (("secure", secure), ("robust", robust),
                                        ("validation", validation)) if v is not None]
            if bad:
                raise ValueError(
                    f"async_buffer_k cannot be combined with {', '.join(bad)} — "
                    "asynchronous aggregation mixes staleness levels that these "
                    "round-locked mechanisms assume away"
                )
            # The server enforces the window: one place to configure it.
            server.staleness_window = config.staleness_window
        elif server.staleness_window > 0:
            raise ValueError(
                "server was built with staleness_window > 0 but the coordinator "
                "is synchronous — set NetworkRoundConfig(async_buffer_k=...) or "
                "use a sync server (staleness_window=0)"
            )
        self.device = resolve_device(device)
        self.server = server
        self.params = {name: leaf.to(self.device) for name, leaf in params.items()}
        self.config = config
        self.validation = validation
        self.secure = secure
        self.robust = robust
        self._ingest_mode = server.ingest is not None
        self.state_store = state_store
        self.history: list[dict[str, Any]] = []
        self._clock = clock or SYSTEM_CLOCK
        self._log = Logger()
        self.metrics_registry = registry or server.metrics_registry
        self.telemetry = (
            RunTelemetry(telemetry_dir, registry=self.metrics_registry)
            if telemetry_dir is not None
            else None
        )
        self._tracer = (
            self.telemetry.tracer
            if self.telemetry is not None
            # keep_records=False: only the histogram consumes these spans.
            else SpanTracer(registry=self.metrics_registry, keep_records=False)
        )
        self._ledger = RoundLedger(self.metrics_registry, telemetry=self.telemetry)
        self._m_validation_rejects = self.metrics_registry.counter(
            "nanofed_validation_rejections_total",
            "Drained updates rejected by host-path validation",
        )
        self._m_straggler_evictions = self.metrics_registry.counter(
            "nanofed_straggler_evictions_total",
            "Clients evicted from the sync round barrier after consecutive misses",
        )
        # Straggler accounting (sync rounds): consecutive missed rounds per ever-seen
        # client, and the evicted set the round barrier excludes.
        self._known_clients: set[str] = set()
        self._absence: dict[str, int] = {}
        self._evicted_stragglers: set[str] = set()
        # Crash recovery: the restored round is where the crashed run got to; this
        # engine starts at the round after it, publishing the restored params.
        self.start_round = 0
        if state_store is not None:
            restored = state_store.restore_latest()
            if restored is not None:
                self.params = from_checkpoint_params(restored.params, self.params)
                self.start_round = restored.round_number + 1
                engine_state = restored.server_state or {}
                if isinstance(engine_state, dict):
                    # str(): the JAX package pickles each id as a 0-d numpy string array.
                    self._evicted_stragglers = {
                        str(cid) for cid in engine_state.get("evicted_stragglers", ())}
                    self._known_clients = set(self._evicted_stragglers)
                self._log.info("resumed from checkpoint: round %d (restarting at %d, %d "
                               "evicted stragglers restored)", restored.round_number,
                               self.start_round, len(self._evicted_stragglers))

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
            self._m_straggler_evictions.inc(len(newly_evicted))
            self._log.warning("evicting stragglers after %d consecutive missed rounds: %s "
                              "(barrier degrades to %d required)",
                              self.config.straggler_evict_after, newly_evicted,
                              self._required_clients())
        return newly_evicted

    def _validate_updates(self, updates: list[ModelUpdate]
                          ) -> tuple[list[ModelUpdate], dict[str, str]]:
        """The updates that pass shape, range and the cohort z-score, and the verdict
        name of each rejected client.  The z-score runs over the range-valid
        survivors only (a NaN norm would poison it), leave-one-out, on the host."""
        shapes = reference_shapes(self.params)
        survivors, rejected = [], {}
        for u in updates:
            verdict = validate_shape(u, shapes)
            if verdict is ValidationResult.VALID:
                verdict = validate_range(u, self.validation)
            if verdict is not ValidationResult.VALID:
                self._log.warning("rejecting update from %s: %s", u.client_id, verdict.name)
                rejected[u.client_id] = verdict.name
                continue
            survivors.append(u)
        if len(survivors) > 1:
            norms = torch.tensor([update_flat_norm(u) for u in survivors], dtype=torch.float32)
            _, anomalous = loo_zscore(norms, torch.ones_like(norms),
                                      self.validation.z_score_threshold,
                                      float(self.validation.min_clients_for_stats))
            kept = []
            for u, bad in zip(survivors, anomalous.tolist()):
                if bad:
                    self._log.warning("rejecting update from %s: ANOMALOUS", u.client_id)
                    rejected[u.client_id] = ValidationResult.ANOMALOUS.name
                else:
                    kept.append(u)
            survivors = kept
        return survivors, rejected

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
        """One federation round, instrumented: the round and its phases are spans, the
        outcome is charged to the ledger and, with a ``telemetry_dir``, appended as a
        ``round`` record."""
        t0 = time.perf_counter()
        with self._tracer.span("round", round=round_number):
            record = await self._train_round_inner(round_number)
        duration = time.perf_counter() - t0
        self._ledger.charge(
            status=str(record.get("status", "?")),
            num_clients=record.get("num_clients", 0), duration_s=duration,
            telemetry_fields={"duration_s": round(duration, 6), **record},
        )
        await self._checkpoint_round(round_number, record)
        return record

    async def _checkpoint_round(self, round_number: int, record: dict[str, Any]) -> None:
        """Persist a COMPLETED round's params and engine state off the event loop: the
        recovery point a restarted coordinator resumes from.  FAILED rounds are not
        checkpointed (the params did not change)."""
        if self.state_store is None or record.get("status") != "COMPLETED":
            return
        await asyncio.to_thread(
            self.state_store.checkpoint, round_number, to_numpy_params(self.params),
            {"evicted_stragglers": sorted(self._evicted_stragglers)},
            dict(record.get("metrics") or {}),
        )

    async def _train_round_inner(self, round_number: int) -> dict[str, Any]:
        with self._tracer.span("publish", round=round_number):
            await self.server.publish_model(self.params, round_number)
        required = self._required_clients()
        if self.secure is not None:
            with self._tracer.span("secure-aggregate", round=round_number):
                return await self._secure_round(round_number, required)
        with self._tracer.span("cohort-sample", round=round_number):
            ok = await self._wait_for_clients(required)
            # Client-id order, not arrival order: the float32 sums (and with them a
            # resumed run) do not depend on which update arrived first.
            updates = ([] if self._ingest_mode else
                       sorted(await self.server.drain_updates(), key=lambda u: u.client_id))
        if self._ingest_mode:
            return await self._ingest_round_tail(round_number, required, ok)
        num_received, rejected = len(updates), {}
        if self.validation is not None and updates:
            updates, rejected = self._validate_updates(updates)
        num_rejected = num_received - len(updates)
        if num_rejected:
            self._m_validation_rejects.inc(num_rejected)
        newly_evicted = self._note_participation({u.client_id for u in updates})
        if not ok or len(updates) < required:
            self._log.warning("round %d FAILED: %d/%d updates (%d rejected)", round_number,
                              len(updates), required, num_rejected)
            record = {"round": round_number, "status": "FAILED",
                      "num_clients": len(updates), "num_rejected": num_rejected,
                      "required": required}
        else:
            with self._tracer.span("aggregate", round=round_number,
                                   num_clients=len(updates)):
                record = self._aggregate_round(round_number, updates, num_rejected)
            record["required"] = required
            if record["status"] == "COMPLETED":
                self._log.info("round %d: %s", round_number, record["metrics"])
        if rejected:
            record["rejected"] = rejected
        if newly_evicted:
            record["evicted_stragglers"] = newly_evicted
        self.history.append(record)
        return record

    async def _ingest_round_tail(self, round_number: int, required: int,
                                 ok: bool) -> dict[str, Any]:
        """A sync round on the ingest buffer: one product over every buffered delta
        against the round's base, the weighted FedAvg of the clients' params."""
        with self._tracer.span("aggregate", round=round_number, ingest=True):
            new_flat, metas = await self.server.drain_ingest_fedavg()
        newly_evicted = self._note_participation({m.client_id for m in metas})
        record: dict[str, Any] = {"round": round_number, "num_clients": len(metas),
                                  "num_rejected": 0, "required": required, "ingest": True}
        if not ok or len(metas) < required:
            self._log.warning("round %d FAILED: %d/%d batched updates", round_number,
                              len(metas), required)
            record["status"] = "FAILED"
        else:
            self.params = unravel(new_flat.to(self.device), self.params)
            wsum = sum(m.weight for m in metas)
            record["status"] = "COMPLETED"
            record["metrics"] = {
                "loss": sum(_metric(m.metrics, "loss", 0.0) * m.weight for m in metas) / wsum,
                "accuracy": sum(_metric(m.metrics, "accuracy", 0.0) * m.weight
                                for m in metas) / wsum,
            }
            self._log.info("round %d (batched ingest): %s", round_number, record["metrics"])
        if newly_evicted:
            record["evicted_stragglers"] = newly_evicted
        self.history.append(record)
        return record

    def _aggregate_round(self, round_number: int, updates: list[ModelUpdate],
                         num_rejected: int) -> dict[str, Any]:
        """Stack the updates on the device and fold them into the global params:
        weighted FedAvg (kernel B1 on the card), or the robust estimator, unweighted,
        with every update participating and the round's loss and accuracy as two more
        coordinates of the same call (the JAX package's ``{"accuracy", "loss",
        "params"}`` tree, in its leaf order)."""
        stacked = stack_model_updates(updates, self.device)
        if self.robust is None:
            self.params = fedavg_combine(stacked.params, stacked.weights)
            w = stacked.weights
            round_metrics = {
                "loss": float((stacked.metrics.loss * w).sum() / w.sum()),
                "accuracy": float((stacked.metrics.accuracy * w).sum() / w.sum()),
            }
        else:
            c = len(updates)
            x = torch.cat([stacked.metrics.accuracy[:, None], stacked.metrics.loss[:, None],
                           ravel_stacked(stacked.params)], dim=1)
            del stacked
            like = {"accuracy": x.new_zeros(()), "loss": x.new_zeros(()),
                    **{f"params/{name}": leaf for name, leaf in self.params.items()}}
            agg, trim_ok, _ = robust_aggregate(
                self.robust, x, torch.ones(c, dtype=torch.float32, device=self.device), like)
            if not bool(trim_ok):
                floor = robust_floor(self.robust)
                self._log.warning("round %d FAILED: %d updates < robust floor %d",
                                  round_number, c, floor)
                return {"round": round_number, "status": "FAILED", "num_clients": c,
                        "num_rejected": num_rejected,
                        "reason": f"{c} updates below the robust floor {floor}"}
            self.params = unravel(agg[2:], self.params)
            round_metrics = {"loss": float(agg[1]), "accuracy": float(agg[0])}
        return {"round": round_number, "status": "COMPLETED", "num_clients": len(updates),
                "num_rejected": num_rejected, "metrics": round_metrics}

    async def _wait_for_buffer(self, k: int) -> int:
        """Async mode: poll until ``k`` updates are buffered or the timeout; the
        buffered count at exit."""
        deadline = self._clock.time() + self.config.round_timeout_s
        while self._clock.time() < deadline:
            n = self.server.num_updates()
            if n >= k:
                return n
            await self._clock.sleep(self.config.poll_interval_s)
        return self.server.num_updates()

    async def _fedbuff_step(self, agg_i: int, version: int, k: int, got: int,
                            taken: list[ModelUpdate]) -> dict[str, Any]:
        """One FedBuff aggregation applied to the current version: the ingest buffer's
        one-product drain of the K oldest buffered updates, or the ``taken`` list
        updates through :func:`fedbuff_combine`."""
        try:
            if self._ingest_mode:
                new_flat, drained, stats = await self.server.drain_ingest_fedbuff(
                    k, version, staleness_exponent=self.config.staleness_exponent,
                    server_lr=self.config.async_server_lr)
                self.params = unravel(new_flat.to(self.device), self.params)
            else:
                drained = taken
                self.params, stats = fedbuff_combine(
                    self.params, drained, self.server.published_versions, version,
                    staleness_exponent=self.config.staleness_exponent,
                    server_lr=self.config.async_server_lr, device=self.device)
        except ValueError as e:
            return self._async_stale_drain_record(agg_i, version, e)
        losses = [_metric(u.metrics, "loss", float("nan")) for u in drained]
        finite = [v for v in losses if math.isfinite(v)]
        record = {"aggregation": agg_i, "version": version + 1, "status": "COMPLETED",
                  "num_clients": stats["num_aggregated"], "buffered_at_drain": got,
                  "metrics": {"loss": float(np.mean(finite)) if finite else None},
                  "drained": [u.client_id for u in drained], **stats}
        if self._ingest_mode:
            record["ingest"] = True
        self._log.info("aggregation %d -> version %d: %d updates, staleness %s", agg_i,
                       version + 1, stats["num_aggregated"], stats["staleness"])
        return record

    async def _run_async(self) -> list[dict[str, Any]]:
        """The FedBuff loop: publish the current version, wait for ``async_buffer_k``
        buffered updates of any in-window staleness (no cohort barrier), apply the
        discounted aggregate.  ``num_rounds`` counts aggregations; a timeout with an
        empty buffer records a FAILED aggregation and publishes the same version
        again.  A resumed engine starts at the checkpointed version."""
        k = self.config.async_buffer_k
        version = self.start_round
        for agg_i in range(self.start_round, self.config.num_rounds):
            t0 = time.perf_counter()
            with self._tracer.span("round", aggregation=agg_i, version=version):
                with self._tracer.span("publish", aggregation=agg_i):
                    await self.server.publish_model(self.params, version)
                with self._tracer.span("cohort-sample", aggregation=agg_i):
                    got = await self._wait_for_buffer(k)
                    # Exactly K per aggregation; the surplus stays for the next one.
                    taken = [] if self._ingest_mode else await self.server.take_updates(k)
                if not (got if self._ingest_mode else taken):
                    record = {"aggregation": agg_i, "version": version, "status": "FAILED",
                              "num_clients": 0,
                              "reason": f"timeout with an empty buffer (wanted {k})"}
                else:
                    attrs = ({"num_clients": got, "ingest": True} if self._ingest_mode
                             else {"num_clients": len(taken)})
                    with self._tracer.span("aggregate", aggregation=agg_i, **attrs):
                        record = await self._fedbuff_step(agg_i, version, k, got, taken)
            if record["status"] == "COMPLETED":
                version += 1
            else:
                self._log.warning("aggregation %d FAILED: %s", agg_i, record["reason"])
            self.history.append(record)
            duration = time.perf_counter() - t0
            self._ledger.charge(
                status=record["status"], num_clients=record["num_clients"],
                duration_s=duration,
                telemetry_fields={
                    "duration_s": round(duration, 6),
                    **{key: v for key, v in record.items() if key != "discounts"},
                },
            )
            if record["status"] == "COMPLETED":
                # Keyed by the produced version: a resumed engine starts from it.
                await self._checkpoint_round(version - 1, record)
        await self.server.publish_model(self.params, version)
        self.server.stop_training()
        return self.history

    def _async_stale_drain_record(self, agg_i: int, version: int,
                                  e: ValueError) -> dict[str, Any]:
        """A drain whose every update's base left the window: a FAILED aggregation (the
        slots were consumed, the version does not advance), not a crashed run."""
        return {"aggregation": agg_i, "version": version, "status": "FAILED",
                "num_clients": 0, "reason": str(e)}

    async def run(self) -> list[dict[str, Any]]:
        """All rounds, then signal termination to polling clients.  In secure mode,
        opens enrollment first and waits for the cohort.  With ``async_buffer_k`` it
        runs the FedBuff loop instead.  Telemetry is closed on the way out, a raised
        enrollment timeout included."""
        try:
            return await self._run_all_rounds()
        finally:
            if self.telemetry is not None:
                self.telemetry.close()

    async def _run_all_rounds(self) -> list[dict[str, Any]]:
        if self.config.async_buffer_k is not None:
            return await self._run_async()
        if self.secure is not None:
            await self._enroll_cohort()
        # After a resume, completed rounds are not re-run: the restored params are
        # published at the next one.
        for r in range(self.start_round, self.config.num_rounds):
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
