"""The swarm: canned payloads, arrival processes and the submit loop (counterpart of
``nanofed_tpu/loadgen/swarm.py``).

* **No real training.**  A load test measures the server tier; a swarm client is a
  coroutine and a pre-encoded body.  The bodies are valid (the server's decode and
  structure checks run for real) and their content repeats: a small pool of canned
  bodies (base params plus seeded noise) serves the whole population.
* **One logical submit is the production client contract.**  A fresh idempotency key
  for each logical submit, the same bytes through every retry, 429 ``Retry-After`` as
  a backoff floor through ``RetryPolicy``'s arithmetic, and protocol 400s final for
  that round (a stale-round 400 refreshes the round and starts a new logical submit).
  A failed attempt after the server announced the end of training abandons the submit
  as terminated, as a refresh does.  The JAX swarm retries on until its budget is spent
  and counts the submit lost, although no retry could reach an aggregation: a full
  ingest buffer is never drained again, so its 429s last.
* **Time is injectable.**  Arrival offsets and backoff sleeps ride the ``Clock``, so a
  smoke runs the schedule on a ``VirtualClock``; latency is always measured on the
  real monotonic clock.

One ``aiohttp.ClientSession`` (connector limit ``connector_limit``) serves the whole
swarm, and one :class:`_RoundTracker` polls each server's ``/status`` for all of it.
The numpy draws (noise, arrivals, weights) are the JAX package's, number for number.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from dataclasses import dataclass, field
from typing import Any

import aiohttp
import numpy as np
import torch

from nanofed_tpu_torch.communication.codec import ENCODING_Q8_DELTA, ENCODING_TOPK8
from nanofed_tpu_torch.communication.http_server import (
    HEADER_CLIENT,
    HEADER_ENCODING,
    HEADER_METRICS,
    HEADER_ROUND,
    HEADER_SUBMIT,
    HEADER_TIER,
    HEADER_TRACE,
)
from nanofed_tpu_torch.communication.retry import RetryPolicy, parse_retry_after
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.observability.tracing import new_trace
from nanofed_tpu_torch.utils.aio import spawn_logged
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

__all__ = [
    "SwarmConfig",
    "SwarmResult",
    "latency_digest",
    "make_canned_payloads",
    "run_swarm",
]


@dataclass(frozen=True)
class SwarmConfig:
    """One synthetic population.

    ``arrival`` draws each client's first-submit offset: ``poisson`` (exponential gaps
    at ``arrival_rate`` submits/s), ``uniform`` (spread evenly over ``num_clients /
    arrival_rate`` seconds) or ``burst`` (everyone at t=0).  ``weight_skew`` is the
    sigma of a lognormal over the reported ``num_samples`` (0: homogeneous).
    ``encoding`` is the canned bodies' codec (``npz`` full params, or the q8 and topk8
    delta codecs, whose bodies carry the noise as the delta).  ``tier`` stamps
    ``X-NanoFed-Tier`` on every submit (read by the fleet slice; the server ignores it
    until then); ``client_prefix`` keeps sub-swarms' ids apart; ``failover_urls`` are
    servers a client rotates to when an attempt run dies at the connection level."""

    num_clients: int = 1000
    submits_per_client: int = 1
    arrival: str = "poisson"
    arrival_rate: float = 2000.0
    weight_skew: float = 0.0
    canned_payloads: int = 8
    delta_scale: float = 1e-3
    seed: int = 0
    retry: RetryPolicy | None = field(
        default_factory=lambda: RetryPolicy(
            max_attempts=8, base_backoff_s=0.05, max_backoff_s=2.0, budget_s=60.0,
            seed=0))
    #: Stale-round refreshes a client submit may take (each is a new logical submit).
    max_stale_refreshes: int = 4
    #: Sockets the shared connector may hold; submits beyond it queue in the connector
    #: (part of measured latency).
    connector_limit: int = 512
    encoding: str = "npz"
    #: topk8 only: the kept fraction per leaf.
    topk_fraction: float = 0.05
    tier: str | None = None
    client_prefix: str = "swarm"
    failover_urls: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        if self.submits_per_client < 1:
            raise ValueError("submits_per_client must be >= 1")
        if self.arrival not in ("poisson", "uniform", "burst"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.arrival_rate <= 0:
            raise ValueError("arrival_rate must be > 0")
        if self.canned_payloads < 1:
            raise ValueError("canned_payloads must be >= 1")
        if self.encoding not in ("npz", ENCODING_Q8_DELTA, ENCODING_TOPK8):
            raise ValueError(f"unknown encoding {self.encoding!r}")
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError("topk_fraction must be in (0, 1]")


@dataclass
class SwarmResult:
    """The raw outcome; :func:`latency_digest` turns it into the artifact's latency
    block."""

    latencies_s: list[float]
    accepted: int = 0
    duplicates: int = 0
    rejected_429: int = 0  # 429 answers observed (each may be retried past)
    retries: int = 0  # attempts re-sent across all submits
    stale_refreshes: int = 0
    failed: int = 0  # logical submits that never got a 200
    terminated_early: int = 0  # submits abandoned because training ended
    reroutes: int = 0  # failover rotations to another server
    wall_s: float = 0.0
    #: Clients whose every logical submit got a 200 (a re-drive takes the rest).
    completed_indices: list[int] = field(default_factory=list)


def latency_digest(latencies_s: list[float]) -> dict[str, Any]:
    """p50, p99, mean and max of the measured submit latencies (empty-safe)."""
    if not latencies_s:
        return {"count": 0, "p50_s": None, "p99_s": None, "mean_s": None, "max_s": None}
    xs = sorted(latencies_s)
    n = len(xs)

    def pct(p: float) -> float:
        return xs[min(n - 1, int(math.ceil(p * n)) - 1)]

    return {
        "count": n,
        "p50_s": round(pct(0.50), 6),
        "p99_s": round(pct(0.99), 6),
        "mean_s": round(math.fsum(xs) / n, 6),
        "max_s": round(xs[-1], 6),
    }


def make_canned_payloads(base_params: Params, config: SwarmConfig) -> list[bytes]:
    """Pre-encode the shared body pool: ``canned_payloads`` variants of ``base +
    N(0, delta_scale)`` (the noise drawn leaf by leaf in the params' order, as the JAX
    package draws it over its tree), encoded once through ``config.encoding``.  For
    the delta codecs the body IS the noise, so the server's reconstruction against
    ``base_params`` lands on the ``base + noise`` that npz ships whole."""
    from nanofed_tpu_torch.communication.codec import (
        encode_delta_q8,
        encode_delta_topk8,
        encode_params,
    )

    base = {name: leaf.detach().cpu().to(torch.float32).numpy()
            for name, leaf in base_params.items()}
    rng = np.random.default_rng(config.seed)
    bodies = []
    for i in range(config.canned_payloads):
        noise = {name: rng.normal(scale=config.delta_scale,
                                  size=leaf.shape).astype(np.float32)
                 for name, leaf in base.items()}
        if config.encoding == ENCODING_Q8_DELTA:
            bodies.append(encode_delta_q8(_tensors(noise), seed=config.seed + i))
        elif config.encoding == ENCODING_TOPK8:
            bodies.append(encode_delta_topk8(_tensors(noise),
                                             fraction=config.topk_fraction,
                                             seed=config.seed + i))
        else:
            bodies.append(encode_params(_tensors(
                {name: base[name] + d for name, d in noise.items()})))
    return bodies


def _tensors(arrays: dict[str, np.ndarray]) -> Params:
    return {name: torch.from_numpy(a) for name, a in arrays.items()}


def arrival_offsets(config: SwarmConfig) -> np.ndarray:
    """Per-client first-submit offsets in seconds (sorted for poisson and uniform)."""
    n = config.num_clients
    rng = np.random.default_rng(config.seed + 1)
    if config.arrival == "burst":
        return np.zeros(n)
    if config.arrival == "uniform":
        return np.linspace(0.0, n / config.arrival_rate, n, endpoint=False)
    gaps = rng.exponential(1.0 / config.arrival_rate, size=n)
    return np.cumsum(gaps)


class _RoundTracker:
    """One status poller for the whole swarm: the server's current round and liveness,
    refreshed every ``poll_s``."""

    def __init__(self, session: aiohttp.ClientSession, url: str, clock: Clock,
                 poll_s: float = 0.05) -> None:
        self._session = session
        self._url = url
        self._clock = clock
        self._poll_s = poll_s
        self.round = 0
        self.training_active = True
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        await self._refresh()
        # stop() swallows the poller's exception to protect the measurement;
        # spawn_logged keeps its traceback in the log.
        self._task = spawn_logged(self._loop(), name="round-tracker")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    async def _refresh(self) -> None:
        try:
            async with self._session.get(self._url) as resp:
                if resp.status == 200:
                    payload = await resp.json()
                    self.round = int(payload.get("round", self.round))
                    self.training_active = bool(payload.get("training_active", True))
        except asyncio.CancelledError:
            raise
        except Exception:
            # Transient (timeout, disconnect, a malformed body under overload): the
            # next poll re-checks.  Any escape would kill the swarm's one poller.
            pass

    async def _loop(self) -> None:
        while self.training_active:
            await self._clock.sleep(self._poll_s)
            await self._refresh()


async def _submit_once(
    session: aiohttp.ClientSession,
    targets: list[tuple[str, _RoundTracker]],
    target_ref: list[int],
    body: bytes,
    client_id: str,
    seq: int,
    weight: float,
    config: SwarmConfig,
    clock: Clock,
    result: SwarmResult,
    sem: asyncio.Semaphore,
    stop: asyncio.Event | None = None,
) -> bool:
    """One LOGICAL submit: the same bytes and idempotency key through every retry, a
    fresh key and a refreshed round after a stale-round 400.  True iff it landed (200,
    accepted or duplicate).

    The round header is stamped when the request reaches the wire (inside ``sem``,
    which caps in-flight submits at the connector limit), as a real client builds its
    request when it sends it.  When an attempt run ends in a connection-level failure
    (status -1: no live server answered) the client rotates ``target_ref`` to the next
    failover target and re-enters as a fresh logical submit, at most one full cycle
    per logical submit; the rotation sticks for the client's later submits."""
    policy = config.retry
    rng = policy.rng_for(client_id) if policy is not None else None
    metrics_header = json.dumps({"num_samples": weight, "loss": 0.5, "accuracy": 0.5})
    t0 = time.perf_counter()
    rotations_left = len(targets) - 1
    while True:
        update_url, tracker = targets[target_ref[0] % len(targets)]
        rotate = False
        for refresh in range(config.max_stale_refreshes + 1):
            if stop is not None and stop.is_set():
                result.terminated_early += 1
                return False
            if not tracker.training_active:
                result.terminated_early += 1
                return False
            headers: dict[str, str] | None = None
            submitted_round = tracker.round
            deadline = (clock.time() + policy.budget_s
                        if policy is not None and policy.budget_s is not None else None)
            attempt = 1
            while True:
                retry_after = None
                status = -1
                duplicate = False
                try:
                    async with sem:
                        if headers is None:
                            # First wire entry of this logical submit: stamp the
                            # current round and key; retries re-send these headers.
                            submitted_round = tracker.round
                            headers = {
                                HEADER_CLIENT: client_id,
                                HEADER_ROUND: str(submitted_round),
                                HEADER_METRICS: metrics_header,
                                HEADER_SUBMIT: f"{client_id}:{submitted_round}:{seq}:{refresh}",
                                # The submit key's identity: one trace across this
                                # logical submit's retries, deterministic by seed.
                                HEADER_TRACE: new_trace(client_id, submitted_round, seq,
                                                        refresh).header(),
                            }
                            if config.encoding != "npz":
                                headers[HEADER_ENCODING] = config.encoding
                            if config.tier is not None:
                                headers[HEADER_TIER] = config.tier
                        async with session.post(update_url, data=body,
                                                headers=headers) as resp:
                            status = resp.status
                            if status == 200:
                                try:
                                    duplicate = bool((await resp.json()).get("duplicate"))
                                except Exception:
                                    duplicate = False
                            elif status == 429:
                                result.rejected_429 += 1
                                retry_after = parse_retry_after(
                                    resp.headers.get("Retry-After"))
                            else:
                                await resp.read()
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    status = -1
                if status == 200:
                    result.latencies_s.append(time.perf_counter() - t0)
                    if duplicate:
                        result.duplicates += 1
                    else:
                        result.accepted += 1
                    return True
                if status == 400:
                    # Final for THIS round: refresh and submit anew (the straggler's
                    # re-sync).
                    break
                if not tracker.training_active:
                    # Training ended (or the swarm was stopped): nothing drains the
                    # buffer any more, so no retry can land in an aggregation.
                    result.terminated_early += 1
                    return False
                retryable = status in (429, 502, 503, 504) or status == -1
                exhausted = policy is None or not retryable or attempt >= policy.max_attempts
                if not exhausted:
                    delay = policy.backoff_s(attempt, rng, retry_after)
                    if deadline is not None and clock.time() + delay > deadline:
                        exhausted = True
                if exhausted:
                    if status == -1 and rotations_left > 0:
                        rotate = True
                        break
                    result.failed += 1
                    return False
                result.retries += 1
                await clock.sleep(delay)
                attempt += 1
            if rotate:
                break
            # The stale-round fall-through: re-read the round before the next try.
            result.stale_refreshes += 1
            if tracker.round == submitted_round:
                await clock.sleep(0.05)
        if rotate:
            rotations_left -= 1
            target_ref[0] = (target_ref[0] + 1) % len(targets)
            result.reroutes += 1
            continue
        result.failed += 1
        return False


def _record_swarm_metrics(result: SwarmResult, registry: Any) -> None:
    """The swarm's client-side numbers as ``nanofed_loadtest_*`` instruments, beside
    the server's wire counters in one registry."""
    lat = registry.histogram(
        "nanofed_loadtest_submit_seconds",
        "End-to-end latency per logical swarm submit (retries included)",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2, 5, 10, 30, 60),
    )
    for v in result.latencies_s:
        lat.observe(v)
    submits = registry.counter("nanofed_loadtest_submits_total",
                               "Swarm logical submits by outcome", labels=("result",))
    for result_name, count in (("accepted", result.accepted),
                               ("duplicate", result.duplicates),
                               ("failed", result.failed),
                               ("terminated", result.terminated_early)):
        if count:
            submits.inc(count, result=result_name)
    retries = registry.counter("nanofed_loadtest_retries_total",
                               "Swarm submit attempts re-sent after a retryable failure")
    if result.retries:
        retries.inc(result.retries)
    reroutes = registry.counter(
        "nanofed_loadtest_reroutes_total",
        "Swarm clients rotated to a failover server after connection loss")
    if result.reroutes:
        reroutes.inc(result.reroutes)


async def run_swarm(
    server_url: str,
    base_params: Params,
    config: SwarmConfig,
    clock: Clock | None = None,
    registry: Any | None = None,
    stop: asyncio.Event | None = None,
    client_indices: Any | None = None,
) -> SwarmResult:
    """Drive the population against a live server; returns the counts and latencies
    (published to ``registry`` as ``nanofed_loadtest_*`` when given).  Every client is
    one coroutine: sleep to its arrival offset, then ``submits_per_client`` logical
    submits back to back.  ``stop``, when set, abandons pending submits as
    ``terminated_early``; ``client_indices`` restricts the population to those clients
    (same ids, offsets, weights and bodies as the full run)."""
    clock = clock or SYSTEM_CLOCK
    bodies = make_canned_payloads(base_params, config)
    offsets = arrival_offsets(config)
    rng = np.random.default_rng(config.seed + 2)
    weights = (np.exp(rng.normal(0.0, config.weight_skew, config.num_clients)) * 10.0
               if config.weight_skew > 0 else np.full(config.num_clients, 10.0))
    result = SwarmResult(latencies_s=[])
    connector = aiohttp.TCPConnector(limit=config.connector_limit)
    timeout = aiohttp.ClientTimeout(total=300.0)
    urls = [server_url, *config.failover_urls]
    t0 = time.perf_counter()
    async with aiohttp.ClientSession(connector=connector, timeout=timeout) as session:
        trackers = [_RoundTracker(session, u.rstrip("/") + "/status", clock) for u in urls]
        for tracker in trackers:
            await tracker.start()
        targets = [(u.rstrip("/") + "/update", tr) for u, tr in zip(urls, trackers)]
        # In-flight cap = the connector limit: requests are stamped only once a slot
        # frees, so their headers are fresh at wire time.
        sem = asyncio.Semaphore(config.connector_limit)

        async def one_client(i: int) -> None:
            target_ref = [0]  # sticky failover rotation across this client's submits
            await clock.sleep(float(offsets[i]))
            landed_all = True
            for s in range(config.submits_per_client):
                if stop is not None and stop.is_set():
                    result.terminated_early += 1
                    landed_all = False
                    continue
                tracker = targets[target_ref[0] % len(targets)][1]
                if not tracker.training_active:
                    result.terminated_early += 1
                    landed_all = False
                    continue
                landed = await _submit_once(
                    session, targets, target_ref, bodies[i % len(bodies)],
                    f"{config.client_prefix}_{i}", s, float(weights[i]), config, clock,
                    result, sem, stop)
                landed_all = landed_all and landed
            if landed_all:
                result.completed_indices.append(i)

        indices = (range(config.num_clients) if client_indices is None
                   else [int(i) for i in client_indices])
        try:
            await asyncio.gather(*(one_client(i) for i in indices))
        finally:
            for tracker in trackers:
                await tracker.stop()
    result.wall_s = time.perf_counter() - t0
    if registry is not None:
        _record_swarm_metrics(result, registry)
    return result
