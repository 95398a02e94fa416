"""HTTP federation server, the network mode (counterpart of
``nanofed_tpu/communication/http_server.py``).

``GET /model`` serves the current global params (npz, ``communication.codec``),
``POST /update`` buffers client updates for the current round (stale rounds are a
400), ``GET /status`` reports the round, ``GET /metrics`` renders the metrics
registry as Prometheus text, and the secure-aggregation endpoints run the
SecAgg protocol: enrollment (``/secagg/register``, ``/secagg/roster``), the per-round
share exchange of the dropout-tolerant variant (``/secagg/shares``), the unmask round
(``/secagg/unmask``) and masked submissions (``POST /update`` with
``X-NanoFed-SecAgg: masked``, an npz holding one uint32 ``masked`` vector).  The wire
protocol is the JAX package's, so JAX clients federate against this server and port
clients against the JAX one.

Mask backends: the first enrollment pins the cohort's backend and a mixed cohort is
refused with 409.  The port accepts ``host`` (numpy, interoperable with JAX parties)
and ``cuda`` (the port's card kernels); ``device`` (the TPU kernel's stream, which the
port cannot expand) is refused with 400.

The update pipeline is the JAX package's:

* compressed submits (``X-NanoFed-Encoding: q8-delta`` or ``topk8-delta``) are
  reconstructed against the base the client fetched, snapshotted under the lock
  before the decode thread starts, in the codec's numpy float32 arithmetic (the
  arithmetic the client signs); an unknown encoding is a 400;
* ``staleness_window=W > 0`` is the asynchronous (FedBuff) protocol: an update based
  on any of the last W published versions is accepted and kept across publishes,
  one per client (the latest wins), and the round engine takes the K oldest;
* ``require_signatures=True`` with ``client_keys`` (client id -> PEM) makes every
  update, enrollment, share deposit, unmask reveal and masked vector carry an
  RSA-PSS signature (``security.signing``); an unsigned or forged one is a 403 and
  never reaches a buffer;
* ``ingest=IngestConfig(...)`` switches plain submits to the device-resident buffer
  (``nanofed_tpu_torch.ingest``) on ``device`` (default: the card): decoded deltas
  are staged into a ``[capacity, P]`` buffer, a full buffer answers 429 +
  Retry-After, and the round engine drains it with one batched product.

Wire metrics (``registry=``, default the process-wide registry) carry the JAX
package's families: body bytes received and sent by endpoint, update submissions by
kind and result, secure-aggregation evictions, 429s and read timeouts (the fleet
families are registered and stay at 0 until the fleet slice).  A submit's
``X-NanoFed-Trace`` header is parsed leniently, and with ``tracer=`` (a
``SpanTracer``) the offloaded decode runs inside a ``submit-decode`` span carrying its
trace id.

The server options of later slices raise ``NotImplementedError`` naming their item
(:data:`LATER_SLICE_OPTIONS`).  ``aiohttp`` is needed to build a server, not to
import this module.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import io
import json
import math
import secrets
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

import numpy as np

from nanofed_tpu_torch.communication.codec import (
    ENCODING_Q8_DELTA,
    ENCODING_TOPK8,
    decode_params,
    encode_params,
    reconstruct_q8,
    reconstruct_topk8,
)
from nanofed_tpu_torch.communication.transport import (
    HTTPTransport,
    read_body_bounded,
    require_aiohttp,
    web,
)
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import ModelUpdate, Params
from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry
from nanofed_tpu_torch.observability.tracing import TraceContext, parse_trace
from nanofed_tpu_torch.security.secure_agg import check_backend
from nanofed_tpu_torch.utils.dates import get_current_time
from nanofed_tpu_torch.utils.logger import Logger

MAX_REQUEST_SIZE = 100 * 1024 * 1024

#: Idempotency keys remembered per client (a retry storm's duplicates dedupe against
#: a window of recent submits).
SUBMIT_KEY_WINDOW = 16

#: Metadata travels in headers; the body is pure npz bytes.
HEADER_CLIENT = "X-NanoFed-Client"
HEADER_ROUND = "X-NanoFed-Round"
HEADER_METRICS = "X-NanoFed-Metrics"
HEADER_STATUS = "X-NanoFed-Status"
HEADER_SIGNATURE = "X-NanoFed-Signature"  # base64 RSA-PSS signature (security.signing)
HEADER_SECAGG = "X-NanoFed-SecAgg"  # "masked" flags a pairwise-masked uint32 payload
HEADER_ENCODING = "X-NanoFed-Encoding"  # absent/"npz" = full params; or q8/topk8 delta
HEADER_SUBMIT = "X-NanoFed-Submit"  # idempotency key: one per LOGICAL submit
HEADER_TRACE = "X-NanoFed-Trace"  # W3C-style trace context: 00-<trace>-<span>-<flags>

#: Server options of later slices, with the JAX defaults (accepted).  Any other value
#: raises NotImplementedError naming the slice.
LATER_SLICE_OPTIONS: dict[str, tuple[Any, str]] = {
    "chaos": (None, "chaos hooks (faults slice, queue A item 17)"),
    "max_inflight": (None, "admission control (service slice, queue A item 18)"),
    "retry_after_s": (0.25, "admission control (service slice, queue A item 18)"),
    "clock": (None, "chaos hooks (faults slice, queue A item 17)"),
    "transport": (None, "shared multi-tenant transports (service slice, queue A item 18)"),
    "tenant": (None, "shared multi-tenant transports (service slice, queue A item 18)"),
    "fleet": (None, "heterogeneous fleets (fleet slice, queue A item 16)"),
}


def refuse_later_slice_options(owner: str, options: dict[str, Any],
                               table: dict[str, tuple[Any, str]]) -> None:
    """Raise for an option outside ``table`` (TypeError) or set to a value other
    than its JAX default (NotImplementedError naming its slice)."""
    unknown = sorted(set(options) - set(table))
    if unknown:
        raise TypeError(f"{owner}: unexpected arguments {unknown}")
    refused = [f"{name} ({table[name][1]})" for name, value in options.items()
               if value != table[name][0]]
    if refused:
        raise NotImplementedError(
            f"{owner}: {', '.join(refused)} not supported by this slice of "
            "nanofed_tpu_torch (run nanofed_tpu for it)"
        )


def _error(message: str, status: int, **headers: str) -> web.Response:
    return web.json_response({"status": "error", "message": message}, status=status,
                             headers=headers or None)


def _signature(headers: Mapping[str, str]) -> bytes:
    """The request's base64 signature header as bytes (b"" when absent or bad)."""
    try:
        return base64.b64decode(headers.get(HEADER_SIGNATURE, ""))
    except Exception:
        return b""


@dataclass(frozen=True)
class ServerEndpoints:
    model: str = "/model"
    update: str = "/update"
    status: str = "/status"
    test: str = "/test"
    secagg_register: str = "/secagg/register"
    secagg_roster: str = "/secagg/roster"
    secagg_shares: str = "/secagg/shares"
    secagg_unmask: str = "/secagg/unmask"
    metrics: str = "/metrics"


class HTTPServer:
    """Serves the global model and buffers client updates for the round engine.

    Every mutation of the round state happens under ``self._lock``; handlers read
    lock-free only where no ``await`` separates the read from its use."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        endpoints: ServerEndpoints | None = None,
        max_request_size: int = MAX_REQUEST_SIZE,
        client_keys: Mapping[str, bytes] | None = None,
        require_signatures: bool = False,
        staleness_window: int = 0,
        read_timeout_s: float = 30.0,
        ingest: Any | None = None,
        device: DeviceLike = None,
        registry: MetricsRegistry | None = None,
        tracer: Any | None = None,
        **later_slice_options: Any,
    ) -> None:
        """``client_keys`` maps client id -> PEM public key; with
        ``require_signatures`` every update and secure-aggregation body must carry a
        valid signature from a registered client or it is refused with 403.
        ``staleness_window=W > 0`` accepts updates on any of the last W published
        versions (async FedBuff; the coordinator wires it).  ``ingest`` (an
        ``ingest.IngestConfig``) buffers plain submits on ``device`` (default: the
        card, which must be there; ``device`` is used by nothing else).
        ``read_timeout_s`` bounds how long a request body may take to arrive (a
        stalled read is answered 408).  ``registry`` (default: the process-wide one)
        receives the wire metrics and is what ``GET /metrics`` renders; ``tracer`` (a
        ``SpanTracer``) opens a ``submit-decode`` span around each admitted submit's
        decode, tagged with its trace id (None records nothing)."""
        refuse_later_slice_options("HTTPServer", later_slice_options, LATER_SLICE_OPTIONS)
        require_aiohttp()
        if staleness_window < 0:
            raise ValueError("staleness_window must be >= 0")
        if read_timeout_s <= 0:
            raise ValueError("read_timeout_s must be > 0")
        self.host = host
        self.port = port
        self.endpoints = endpoints or ServerEndpoints()
        self.client_keys = dict(client_keys or {})
        self.require_signatures = require_signatures
        self.staleness_window = staleness_window
        self.read_timeout_s = read_timeout_s
        self.ingest = ingest
        # The ingest buffer's device, resolved now so a missing card fails at
        # construction; the pipeline itself is built at the first publish (P).
        self._ingest_device = resolve_device(device) if ingest is not None else None
        self._ingest_pipeline: Any | None = None
        self._log = Logger()
        self._lock = asyncio.Lock()
        # client -> recent (submit key, fingerprint) pairs (see _submit_fingerprint)
        self._seen_submits: dict[str, deque[tuple[str, str]]] = {}
        self._updates: dict[str, ModelUpdate] = {}
        self._params: Params | None = None  # host copy of the published model
        self._params_bytes: bytes | None = None
        self._param_count = 0
        self._round = 0
        self._version_params: dict[int, Params] = {}  # async mode: the base window
        self._training_active = True
        # Secure aggregation: the roster (X25519 public key, sample count per client),
        # opened by the round engine, and a separate buffer for masked vectors.
        self._secagg_expected: int | None = None
        self._secagg_window = False  # exact cohort vs minimum + close window
        self._secagg_max: int | None = None
        self._secagg_threshold_for: Callable[[int], int] | None = None
        self._secagg_threshold: int | None = None
        self._secagg_closed = False
        self._secagg_session = ""
        self._secagg_backend: str | None = None  # pinned by the first enrollment
        self._secagg_roster: dict[str, dict[str, Any]] = {}
        self._masked_updates: dict[str, tuple[np.ndarray, dict[str, Any]]] = {}
        # Dropout-tolerant mode, all per round (cleared on publish_model): ephemeral
        # mask keys, self-seed commitments, sealed share blobs the server routes but
        # cannot read, and the unmask request/reveal exchange.  Clients declared
        # dropped are evicted from the active cohort.
        self._secagg_evicted: set[str] = set()
        self._round_share_epks: dict[str, bytes] = {}
        self._round_share_bhs: dict[str, bytes] = {}
        self._round_share_blobs: dict[str, dict[str, str]] = {}  # recipient -> sender -> blob
        self._round_share_senders: dict[str, dict[str, str]] = {}  # sender -> its deposit
        self._unmask_request: dict[str, Any] | None = None
        self._unmask_reveals: dict[str, dict[str, Any]] = {}
        self.evictions = 0
        self._tracer = tracer
        # Wire metrics, the JAX package's families, counted at the handlers.
        self.metrics_registry = registry or get_registry()
        self._m_bytes_rx = self.metrics_registry.counter(
            "nanofed_bytes_received_total",
            "Request body bytes received, by endpoint", labels=("endpoint",),
        )
        self._m_bytes_tx = self.metrics_registry.counter(
            "nanofed_bytes_sent_total",
            "Response body bytes served, by endpoint", labels=("endpoint",),
        )
        self._m_updates = self.metrics_registry.counter(
            "nanofed_updates_total",
            "Client update submissions by kind (plain/masked) and result",
            labels=("kind", "result"),
        )
        self._m_evictions = self.metrics_registry.counter(
            "nanofed_secagg_evictions_total",
            "Clients evicted from the secure-aggregation cohort",
        )
        self._m_429 = self.metrics_registry.counter(
            "nanofed_http_429_total",
            "Requests shed by admission control (429 + Retry-After), by endpoint",
            labels=("endpoint",),
        )
        self._m_read_timeouts = self.metrics_registry.counter(
            "nanofed_read_timeouts_total",
            "Request bodies that failed to arrive within read_timeout_s (408)",
        )
        # The fleet families (the fleet slice writes them).
        self.metrics_registry.counter(
            "nanofed_fleet_bytes_total",
            "Fleet-mode body bytes by tier and direction (rx=submit, tx=model)",
            labels=("tier", "direction"),
        )
        self.metrics_registry.counter(
            "nanofed_fleet_updates_total",
            "Fleet-mode tier submits by tier and result",
            labels=("tier", "result"),
        )
        ep = self.endpoints
        self._routes: dict[tuple[str, str], Any] = {
            ("GET", ep.model): self._handle_get_model,
            ("POST", ep.update): self._handle_submit_update,
            ("GET", ep.status): self._handle_status,
            ("GET", ep.test): self._handle_test,
            ("POST", ep.secagg_register): self._handle_secagg_register,
            ("GET", ep.secagg_roster): self._handle_secagg_roster,
            ("POST", ep.secagg_shares): self._handle_secagg_shares_post,
            ("GET", ep.secagg_shares): self._handle_secagg_shares_get,
            ("GET", ep.secagg_unmask): self._handle_unmask_get,
            ("POST", ep.secagg_unmask): self._handle_unmask_post,
            ("GET", ep.metrics): self._handle_metrics,
        }
        self.transport = HTTPTransport(host=host, port=port,
                                       max_request_size=max_request_size,
                                       registry=self.metrics_registry)
        self.transport.add_session(self)

    # ------------------------------------------------------------------
    # Round-engine API
    # ------------------------------------------------------------------

    async def publish_model(self, params: Params, round_number: int) -> None:
        """Set the global params served to clients and advance the round.  Masked
        updates and the round's share state are dropped (a straggler's masks are bound
        to the OLD round and would not cancel); so are buffered plain updates in sync
        mode.  In async mode the version joins the window and the buffer stays: a
        straggler's update on an in-window version is still aggregatable."""
        host = {name: leaf.detach().cpu() for name, leaf in params.items()}
        payload = encode_params(host)
        async with self._lock:
            self._params = host
            self._params_bytes = payload
            self._param_count = sum(int(leaf.numel()) for leaf in host.values())
            self._round = round_number
            if self.ingest is not None:
                if self._ingest_pipeline is None:
                    from nanofed_tpu_torch.ingest import IngestPipeline

                    self._ingest_pipeline = IngestPipeline(host, self.ingest,
                                                           device=self._ingest_device)
                # The flat base window follows the same pruning rule as the version
                # window below, so acceptance and reconstruction cannot disagree.
                self._ingest_pipeline.note_version(round_number, host,
                                                   window=self.staleness_window)
                if self.staleness_window == 0:
                    self._ingest_pipeline.clear()
            if self.staleness_window > 0:
                self._version_params[round_number] = host
                floor = round_number - self.staleness_window
                for old in [r for r in self._version_params if r < floor]:
                    del self._version_params[old]
            else:
                self._updates.clear()
            self._masked_updates.clear()
            self._clear_round_shares_locked()
            self._unmask_request = None
            self._unmask_reveals.clear()

    def _clear_round_shares_locked(self) -> None:
        self._round_share_epks.clear()
        self._round_share_bhs.clear()
        self._round_share_blobs.clear()
        self._round_share_senders.clear()

    def num_updates(self) -> int:
        """Lock-free hint; the engine re-checks through its drain."""
        if self._ingest_pipeline is not None:
            return self._ingest_pipeline.fill
        return len(self._updates)

    async def drain_updates(self) -> list[ModelUpdate]:
        """Atomically take the buffered updates for aggregation."""
        async with self._lock:
            updates = list(self._updates.values())
            self._updates.clear()
        return updates

    @property
    def published_versions(self) -> dict[int, Params]:
        """Async mode's version window (version -> host params): the one source of
        which bases are still reconstructable and aggregatable."""
        return dict(self._version_params)

    async def take_updates(self, k: int) -> list[ModelUpdate]:
        """Atomically take up to ``k`` buffered updates in arrival order, leaving the
        rest buffered: a FedBuff step aggregates exactly K."""
        async with self._lock:
            keys = list(self._updates)[:k]
            return [self._updates.pop(key) for key in keys]

    async def drain_ingest_fedavg(self) -> tuple[Any | None, list[Any]]:
        """Sync-round drain of the ingest buffer, one product against the current
        round's base: ``(new_flat_params, slot_metas)``, ``(None, [])`` when empty."""
        async with self._lock:
            return self._ingest_pipeline.drain_fedavg(self._round)

    async def drain_ingest_fedbuff(
        self, k: int, current_version: int, staleness_exponent: float = 0.5,
        server_lr: float = 1.0,
    ) -> tuple[Any, list[Any], dict[str, Any]]:
        """Async drain: one product over the K oldest buffered deltas (discounted,
        out-of-window slots skipped) applied to the current version."""
        async with self._lock:
            return self._ingest_pipeline.drain_fedbuff(
                k, current_version, staleness_exponent=staleness_exponent,
                server_lr=server_lr)

    @property
    def ingest_pipeline(self) -> Any | None:
        """The ingest pipeline once the first publish built it (None without
        ``ingest=``)."""
        return self._ingest_pipeline

    def stop_training(self) -> None:
        """Signal clients to stop polling."""
        self._training_active = False

    @property
    def current_round(self) -> int:
        return self._round

    # ------------------------------------------------------------------
    # Secure-aggregation round-engine API
    # ------------------------------------------------------------------

    async def open_secagg(
        self,
        expected_clients: int,
        *,
        window: bool = False,
        max_clients: int | None = None,
        threshold_for: Callable[[int], int] | None = None,
    ) -> None:
        """Open enrollment.  ``window=False``: the cohort is exactly
        ``expected_clients`` and the roster is complete when they are in.
        ``window=True`` (the dropout-tolerant shape): ``expected_clients`` is a
        minimum, enrollment stays open up to ``max_clients`` until
        :meth:`close_secagg` freezes it, and ``threshold_for(n)`` derives the Shamir
        threshold from the cohort that enrolled.  Each call issues a fresh session
        nonce and forgets every earlier cohort."""
        if window and max_clients is not None and max_clients < expected_clients:
            raise ValueError(
                f"max_clients ({max_clients}) must be >= the enrollment minimum "
                f"({expected_clients})"
            )
        async with self._lock:
            self._secagg_expected = int(expected_clients)
            self._secagg_window = bool(window)
            self._secagg_max = int(max_clients) if max_clients is not None else None
            self._secagg_threshold_for = threshold_for
            self._secagg_threshold = None
            self._secagg_closed = False
            self._secagg_session = secrets.token_hex(16)
            self._secagg_backend = None
            self._secagg_roster.clear()
            self._masked_updates.clear()
            self._secagg_evicted.clear()
            self._clear_round_shares_locked()
            self._unmask_request = None
            self._unmask_reveals.clear()

    async def close_secagg(self) -> int:
        """Freeze a window-mode roster (idempotent); returns the cohort size."""
        async with self._lock:
            return self._close_secagg_locked()

    def _close_secagg_locked(self) -> int:
        if not self._secagg_closed:
            self._secagg_closed = True
            if self._secagg_threshold_for is not None:
                self._secagg_threshold = int(
                    self._secagg_threshold_for(len(self._secagg_roster)))
        return len(self._secagg_roster)

    def secagg_enrolled(self) -> int:
        return len(self._secagg_roster)

    def secagg_threshold(self) -> int | None:
        """The Shamir threshold for the current round (window mode, after the freeze),
        derived from the ACTIVE cohort so evictions never make it unreachable; None in
        exact mode or before the freeze."""
        if not self._secagg_closed or self._secagg_threshold_for is None:
            return self._secagg_threshold
        return int(self._secagg_threshold_for(len(self.secagg_active_order())))

    def secagg_roster_complete(self) -> bool:
        if self._secagg_expected is None:
            return False
        if self._secagg_window:
            return self._secagg_closed
        return len(self._secagg_roster) >= self._secagg_expected

    def secagg_client_order(self) -> list[str]:
        """Canonical cohort order (sorted ids): the mask sign convention."""
        return sorted(self._secagg_roster)

    def num_masked_updates(self) -> int:
        return len(self._masked_updates)

    async def drain_masked_updates(self) -> dict[str, np.ndarray]:
        """Atomically take the buffered masked vectors (client id -> uint32 array)."""
        async with self._lock:
            taken = {cid: vec for cid, (vec, _) in self._masked_updates.items()}
            self._masked_updates.clear()
        return taken

    def secagg_backend(self) -> str:
        """The cohort's mask backend (pinned at first enrollment; 'host' when empty)."""
        return self._secagg_backend or "host"

    def secagg_public_keys(self) -> dict[str, bytes]:
        return {c: e["public_key"] for c, e in self._secagg_roster.items()}

    def secagg_weights(self) -> dict[str, float]:
        """Normalized FedAvg weights over the FULL enrolled cohort."""
        total = sum(e["num_samples"] for e in self._secagg_roster.values())
        return {c: e["num_samples"] / total for c, e in self._secagg_roster.items()}

    def secagg_active_order(self) -> list[str]:
        """This round's active cohort: enrolled minus evicted, canonical order."""
        return sorted(set(self._secagg_roster) - self._secagg_evicted)

    async def evict_secagg_clients(self, client_ids: Iterable[str]) -> None:
        """Remove dropped clients from the active cohort (their round secrets were
        revealed); the round's share state goes with them."""
        async with self._lock:
            ids = set(client_ids)
            newly = len(ids - self._secagg_evicted)
            self.evictions += newly
            if newly:
                self._m_evictions.inc(newly)
            self._secagg_evicted.update(ids)
            self._clear_round_shares_locked()

    def secagg_shares_complete(self) -> bool:
        """True once every active member deposited this round's key and shares."""
        active = self.secagg_active_order()
        return bool(active) and set(self._round_share_senders) >= set(active)

    def secagg_round_epks(self) -> dict[str, bytes]:
        return dict(self._round_share_epks)

    def secagg_round_commitments(self) -> dict[str, bytes]:
        return dict(self._round_share_bhs)

    async def open_unmask(self, round_number: int, dropped: list[str],
                          survivors: list[str]) -> None:
        """Publish the unmask request survivors poll for."""
        async with self._lock:
            self._unmask_request = {"round": int(round_number), "dropped": sorted(dropped),
                                    "survivors": sorted(survivors)}
            self._unmask_reveals.clear()

    def num_unmask_reveals(self) -> int:
        return len(self._unmask_reveals)

    async def drain_unmask_reveals(self) -> dict[str, dict[str, Any]]:
        """Atomically take the reveals and close the unmask request."""
        async with self._lock:
            taken = dict(self._unmask_reveals)
            self._unmask_reveals.clear()
            self._unmask_request = None
        return taken

    # ------------------------------------------------------------------
    # Transport dispatch and bounded reads
    # ------------------------------------------------------------------

    async def dispatch(self, path: str, request: web.Request) -> web.StreamResponse:
        """Route the logical endpoint path to its handler (HEAD falls back to GET)."""
        handler = self._routes.get((request.method, path))
        if handler is None and request.method == "HEAD":
            handler = self._routes.get(("GET", path))
        if handler is None:
            if any(p == path for _, p in self._routes):
                return _error(f"method {request.method} not allowed on {path}", 405)
            return _error(f"no endpoint {path}", 404)
        return await handler(request)

    async def _read_body(self, request: web.Request) -> bytes:
        try:
            return await read_body_bounded(request, self.read_timeout_s)
        except asyncio.TimeoutError:
            self._m_read_timeouts.inc()
            raise web.HTTPRequestTimeout(
                text=json.dumps({"status": "error", "message": (
                    f"request body not received within {self.read_timeout_s:g}s")}),
                content_type="application/json",
            ) from None

    async def _offload(self, fn: Callable[..., Any], *args: Any) -> Any:
        """One CPU-bound submit stage off the event loop: on the ingest pipeline's
        bounded pool when there is one, else ``asyncio.to_thread``."""
        if self._ingest_pipeline is not None:
            return await self._ingest_pipeline.run_decode(fn, *args)
        return await asyncio.to_thread(fn, *args)

    def _decode_span(self, trace: TraceContext | None, client_id: str,
                     encoding: str) -> Any:
        """A ``submit-decode`` span around the offloaded decode when a tracer is
        wired, tagged with the submit's trace id; no tracer -> a no-op context."""
        if self._tracer is None:
            return nullcontext()
        attrs: dict[str, Any] = {"client": client_id, "encoding": encoding}
        if trace is not None:
            attrs["trace"] = trace.trace_id
        return self._tracer.span("submit-decode", **attrs)

    def _reject_update(self, reason: str, kind: str = "plain") -> None:
        self._m_updates.inc(kind=kind, result=reason)

    def _submit_fingerprint(self, headers: Mapping[str, str]) -> str:
        """What a duplicate must match beyond its idempotency key: on a signing server
        the sha256 of the signature header (a retry re-sends it, a prober guessing the
        key cannot), else nothing."""
        if not self.require_signatures:
            return ""
        return hashlib.sha256(headers.get(HEADER_SIGNATURE, "").encode()).hexdigest()

    def _duplicate_submit(self, client_id: str, submit_id: str | None,
                          fingerprint: str) -> bool:
        return (submit_id is not None
                and (submit_id, fingerprint) in self._seen_submits.get(client_id, ()))

    def _record_submit_locked(self, client_id: str, submit_id: str | None,
                              fingerprint: str) -> None:
        if submit_id is not None:
            self._seen_submits.setdefault(
                client_id, deque(maxlen=SUBMIT_KEY_WINDOW)).append((submit_id, fingerprint))

    def _duplicate_response(self, client_id: str, kind: str = "plain") -> web.StreamResponse:
        self._m_updates.inc(kind=kind, result="duplicate")
        self._log.info("duplicate submit from %s folded at most once", client_id)
        return web.json_response({
            "status": "success",
            "message": "duplicate submit (already accepted; folded at most once)",
            "update_id": client_id,
            "duplicate": True,
        })

    def _round_acceptable(self, round_number: int) -> bool:
        """Sync mode: exactly the current round.  Async mode: a version that was
        published and is still in the window."""
        if round_number == self._round:
            return True
        return self.staleness_window > 0 and round_number in self._version_params

    def _round_rejection_message(self, round_number: int) -> str:
        if self.staleness_window > 0:
            return (f"update for round {round_number} is outside the staleness window "
                    f"[{self._round - self.staleness_window}, {self._round}]")
        return f"update for round {round_number}, server is on {self._round}"

    def _stale(self, round_number: int) -> web.Response:
        return _error(self._round_rejection_message(round_number), 400)

    # ------------------------------------------------------------------
    # Handlers
    # ------------------------------------------------------------------

    async def _handle_get_model(self, request: web.Request) -> web.StreamResponse:
        if not self._training_active:
            return web.Response(status=200, headers={
                HEADER_STATUS: "terminated", HEADER_ROUND: str(self._round)})
        if self._params_bytes is None:
            return _error("no model published", 503)
        self._m_bytes_tx.inc(len(self._params_bytes), endpoint="model")
        return web.Response(
            body=self._params_bytes, content_type="application/octet-stream",
            headers={HEADER_STATUS: "training", HEADER_ROUND: str(self._round)},
        )

    def _ingest_full(self) -> web.Response:
        self._m_429.inc(endpoint="update")
        self._reject_update("ingest_full")
        return _error(f"ingest buffer full ({self.ingest.capacity} slots); retry after "
                      "backoff", 429, **{"Retry-After": "0.25"})

    async def _handle_submit_update(self, request: web.Request) -> web.StreamResponse:
        client_id = request.headers.get(HEADER_CLIENT)
        round_header = request.headers.get(HEADER_ROUND)
        if not client_id or round_header is None:
            self._reject_update("missing_headers")
            return _error("missing client/round headers", 400)
        try:
            round_number = int(round_header)
        except ValueError:
            self._reject_update("bad_round_header")
            return _error(f"bad round: {round_header!r}", 400)
        try:
            metrics: dict[str, Any] = json.loads(request.headers.get(HEADER_METRICS, "{}"))
        except json.JSONDecodeError:
            self._reject_update("bad_metrics_header")
            return _error("bad metrics header", 400)
        if self._params is None:
            self._reject_update("no_model")
            return _error("no model published", 503)
        masked = request.headers.get(HEADER_SECAGG) == "masked"
        # Idempotent-submit dedupe first: a retry of an accepted submit may arrive
        # after the round advanced, and a 400 would make a topk8 client fold a delta
        # the server already has.  The authoritative re-check runs under the lock.
        submit_id = request.headers.get(HEADER_SUBMIT)
        fingerprint = self._submit_fingerprint(request.headers)
        if self._duplicate_submit(client_id, submit_id, fingerprint):
            return self._duplicate_response(client_id, "masked" if masked else "plain")
        if not self._round_acceptable(round_number):
            self._reject_update("stale_round", kind="masked" if masked else "plain")
            return self._stale(round_number)
        encoding = request.headers.get(HEADER_ENCODING, "npz")
        if masked:
            if encoding != "npz":
                self._reject_update("bad_encoding", kind="masked")
                return _error(f"encoding {encoding!r} cannot combine with SecAgg masked "
                              "payloads", 400)
            return await self._handle_masked_update(request, client_id, round_number,
                                                    metrics, submit_id, fingerprint)
        # A full ingest buffer sheds the submit before its body is read; a client
        # whose slot would only be replaced (latest wins) is not shed.
        if (self._ingest_pipeline is not None
                and self._ingest_pipeline.fill >= self.ingest.capacity
                and not self._ingest_pipeline.buffer.has_client(client_id)):
            return self._ingest_full()
        # A malformed or absent trace header is an untraced submit, never a rejection.
        trace = parse_trace(request.headers.get(HEADER_TRACE))
        body = await self._read_body(request)
        self._m_bytes_rx.inc(len(body), endpoint="update")
        if encoding not in ("npz", ENCODING_Q8_DELTA, ENCODING_TOPK8):
            self._reject_update("bad_encoding")
            return _error(f"unknown encoding {encoding!r}", 400)
        # The (round, base) pair is snapshotted under the lock before the decode
        # thread starts: a publish during the decode must not hand the signature check
        # a reconstruction against params the client never fetched.
        async with self._lock:
            if not self._round_acceptable(round_number):
                self._reject_update("stale_round")
                return self._stale(round_number)
            base = (self._version_params.get(round_number) if self.staleness_window > 0
                    else self._params)
            base_flat = (self._ingest_pipeline.base_flat(round_number)
                         if self._ingest_pipeline is not None else None)
        if base is None:
            self._reject_update("stale_round")
            return self._stale(round_number)

        def decode() -> Params:
            # Compressed deltas reconstruct base + delta in the codec's numpy float32
            # arithmetic: what the client signed.
            if encoding == ENCODING_TOPK8:
                return reconstruct_topk8(base, body)
            if encoding == ENCODING_Q8_DELTA:
                return reconstruct_q8(base, body)
            return decode_params(body, like=base)

        try:
            with self._decode_span(trace, client_id, encoding):
                params = await self._offload(decode)
        except Exception as e:
            self._reject_update("bad_payload")
            return _error(f"bad payload: {e}", 400)
        if self.require_signatures:
            verdict = await self._offload(self._verify_update_signature, client_id,
                                          round_number, dict(request.headers), params)
            if verdict is not None:
                self._reject_update("bad_signature")
                return verdict
        if self._ingest_pipeline is not None:
            return await self._ingest_buffer_update(client_id, round_number, metrics,
                                                    submit_id, fingerprint, params, base_flat)
        async with self._lock:
            if self._duplicate_submit(client_id, submit_id, fingerprint):
                return self._duplicate_response(client_id)
            # In async mode the window may have moved during the decode.
            if not self._round_acceptable(round_number):
                self._reject_update("stale_round")
                return self._stale(round_number)
            self._updates[client_id] = ModelUpdate(
                client_id=client_id, round_number=round_number, params=params,
                metrics=metrics, timestamp=get_current_time().isoformat(),
            )
            self._record_submit_locked(client_id, submit_id, fingerprint)
            accepted = len(self._updates)
        self._m_updates.inc(kind="plain", result="accepted")
        self._log.info("update from %s (round %d, %d buffered)", client_id, round_number,
                       accepted)
        return web.json_response(
            {"status": "success", "message": "update accepted", "update_id": client_id})

    async def _ingest_buffer_update(
        self, client_id: str, round_number: int, metrics: dict[str, Any],
        submit_id: str | None, fingerprint: str, params: Params, base_flat: Any,
    ) -> web.StreamResponse:
        """The ingest tail of an admitted plain submit: flatten the decoded params into
        a delta against the snapshotted base (on the pool) and offer it to the buffer
        under the lock.  A full buffer is a 429 + Retry-After with the idempotency key
        not recorded, so a retry lands later."""
        if base_flat is None:
            self._reject_update("stale_round")
            return self._stale(round_number)
        from nanofed_tpu_torch.ingest import flatten_params

        flat_delta = await self._offload(lambda: flatten_params(params) - base_flat)
        async with self._lock:
            if self._duplicate_submit(client_id, submit_id, fingerprint):
                return self._duplicate_response(client_id)
            if not self._round_acceptable(round_number):
                self._reject_update("stale_round")
                return self._stale(round_number)
            slot = self._ingest_pipeline.offer(flat_delta, client_id=client_id,
                                               round_number=round_number, metrics=metrics)
            if slot is not None:
                self._record_submit_locked(client_id, submit_id, fingerprint)
                buffered = self._ingest_pipeline.fill
        if slot is None:
            return self._ingest_full()
        self._m_updates.inc(kind="plain", result="accepted")
        self._log.info("ingested update from %s (round %d, slot %d, %d buffered)",
                       client_id, round_number, slot, buffered)
        return web.json_response(
            {"status": "success", "message": "update accepted", "update_id": client_id})

    def _verify_update_signature(self, client_id: str, round_number: int,
                                 headers: Mapping[str, str],
                                 params: Params) -> web.Response | None:
        """The 403 for a missing, unregistered or invalid update signature, or None.
        The signature covers the client id, the round, the verbatim metrics header and
        the params the server will aggregate (for a compressed submit, its
        reconstruction)."""
        from nanofed_tpu_torch.security.signing import verify_update_signature

        pem = self.client_keys.get(client_id)
        if pem is None:
            return _error(f"unknown client {client_id!r}", 403)
        signature = _signature(headers)
        if not signature or not verify_update_signature(
                params, client_id, round_number, headers.get(HEADER_METRICS, "{}"),
                signature, pem):
            self._log.warning("invalid signature from %s", client_id)
            return _error("invalid signature", 403)
        return None

    async def _check_signature(self, request: web.Request, client_id: str,
                               verify: Callable[..., bool], *verify_args: Any
                               ) -> web.Response | None:
        """The 403 for a secure-aggregation body whose signature does not verify, or
        None; ``verify``'s trailing arguments are ``(signature, pem)``."""
        pem = self.client_keys.get(client_id)
        if pem is None:
            return _error(f"unknown client {client_id!r}", 403)
        signature = _signature(request.headers)
        if not signature or not await self._offload(verify, *verify_args, signature, pem):
            self._log.warning("invalid signature from %s on %s", client_id, request.path)
            return _error("invalid signature", 403)
        return None

    async def _handle_masked_update(
        self, request: web.Request, client_id: str, round_number: int,
        metrics: dict[str, Any], submit_id: str | None, fingerprint: str,
    ) -> web.StreamResponse:
        """Buffer a pairwise-masked uint32 vector.  Masked payloads look like uniform
        noise, so the only content check is structural: enrollment, dtype and length
        (the published model's parameter count); with ``require_signatures`` the
        verbatim body must also carry a valid signature."""
        if client_id not in self._secagg_roster:
            self._reject_update("not_enrolled", kind="masked")
            return _error(f"{client_id!r} not enrolled", 403)
        if client_id in self._secagg_evicted:
            self._reject_update("evicted", kind="masked")
            return _error(f"{client_id!r} was evicted from this cohort", 403)
        body = await self._read_body(request)
        self._m_bytes_rx.inc(len(body), endpoint="update")
        if self.require_signatures:
            from nanofed_tpu_torch.security.signing import verify_masked_signature

            verdict = await self._check_signature(
                request, client_id, verify_masked_signature, body, client_id, round_number,
                request.headers.get(HEADER_METRICS, "{}"))
            if verdict is not None:
                self._reject_update("bad_signature", kind="masked")
                return verdict
        expected_size = self._param_count

        def decode_masked() -> np.ndarray:
            with np.load(io.BytesIO(body)) as z:
                vec = z["masked"]
            if vec.dtype != np.uint32 or vec.shape != (expected_size,):
                raise ValueError(f"expected uint32[{expected_size}], got {vec.dtype}{vec.shape}")
            return vec

        try:
            vec = await self._offload(decode_masked)
        except Exception as e:
            self._reject_update("bad_payload", kind="masked")
            return _error(f"bad masked payload: {e}", 400)
        async with self._lock:
            if self._duplicate_submit(client_id, submit_id, fingerprint):
                return self._duplicate_response(client_id, "masked")
            if round_number != self._round:
                self._reject_update("stale_round", kind="masked")
                return _error(f"update for round {round_number}, server is on {self._round}",
                              400)
            self._masked_updates[client_id] = (vec, metrics)
            self._record_submit_locked(client_id, submit_id, fingerprint)
            accepted = len(self._masked_updates)
        self._m_updates.inc(kind="masked", result="accepted")
        self._log.info("masked update from %s (round %d, %d buffered)", client_id,
                       round_number, accepted)
        return web.json_response({"status": "success", "message": "masked update accepted",
                                  "update_id": client_id})

    async def _handle_secagg_register(self, request: web.Request) -> web.StreamResponse:
        """Enroll one client: X25519 public key, sample count and mask backend.  An
        identical re-registration is a 200 (safe retry); a changed key or count for
        an enrolled id, or a backend other than the cohort's, is a 409."""
        client_id = request.headers.get(HEADER_CLIENT)
        if not client_id:
            return _error("missing client header", 400)
        if self._secagg_expected is None:
            return _error("secure aggregation not open", 403)
        raw = await self._read_body(request)
        try:
            body = json.loads(raw)
            public_key = base64.b64decode(body["public_key"])
            num_samples = float(body["num_samples"])
            backend = str(body.get("backend", "host"))
            if len(public_key) != 32:
                raise ValueError("bad key length")
            if not (math.isfinite(num_samples) and num_samples > 0):
                raise ValueError("sample count must be finite and positive")
            check_backend(backend)
        except Exception as e:
            return _error(f"bad registration: {e}", 400)
        if self.require_signatures:
            # The signature binds this cohort's session nonce (no replay into a later
            # cohort) and the mask backend (no splice).
            from nanofed_tpu_torch.security.signing import verify_enrollment_signature

            verdict = await self._check_signature(
                request, client_id,
                lambda *a: verify_enrollment_signature(*a, backend=backend),
                client_id, public_key, num_samples, self._secagg_session)
            if verdict is not None:
                return verdict
        async with self._lock:
            if self._secagg_backend is not None and backend != self._secagg_backend:
                return _error(
                    f"mask backend {backend!r} conflicts with this cohort's negotiated "
                    f"backend {self._secagg_backend!r}: a cohort masks with one backend "
                    "(the host and cuda quantizations round differently); re-enroll with "
                    "the cohort backend", 409)
            existing = self._secagg_roster.get(client_id)
            if existing is not None:
                if (existing["public_key"] == public_key
                        and existing["num_samples"] == num_samples):
                    return web.json_response({"status": "success",
                                              "message": "already enrolled"})
                return _error("already enrolled with a different key/count", 409)
            if self._secagg_closed:
                return _error("cohort closed", 403)
            cap = self._secagg_max if self._secagg_window else self._secagg_expected
            if cap is not None and len(self._secagg_roster) >= cap:
                return _error("cohort is full", 403)
            if self._secagg_backend is None:
                self._secagg_backend = backend
            self._secagg_roster[client_id] = {"public_key": public_key,
                                              "num_samples": num_samples}
            if (self._secagg_window and self._secagg_max is not None
                    and len(self._secagg_roster) >= self._secagg_max):
                self._close_secagg_locked()  # cap reached: freeze implicitly
        self._log.info("secagg enrollment: %s (%d/%d, backend=%s)", client_id,
                       len(self._secagg_roster), self._secagg_expected, backend)
        return web.json_response({"status": "success", "message": "enrolled"})

    async def _handle_secagg_roster(self, request: web.Request) -> web.StreamResponse:
        """The cohort roster every client needs before masking: canonical order, all
        public keys and each client's NORMALIZED FedAvg weight (clients pre-scale by
        it, so the masked modular sum IS the weighted mean)."""
        if self._secagg_expected is None:
            return _error("secure aggregation not open", 403)
        complete = self.secagg_roster_complete()
        payload: dict[str, Any] = {
            "status": "success",
            "complete": complete,
            "expected": self._secagg_expected,
            "enrolled": len(self._secagg_roster),
            "session": self._secagg_session,
            "backend": self.secagg_backend(),
        }
        if complete:
            order = self.secagg_client_order()
            total = sum(self._secagg_roster[c]["num_samples"] for c in order)
            payload.update(
                client_order=order,
                public_keys={c: base64.b64encode(self._secagg_roster[c]["public_key"]).decode()
                             for c in order},
                weights={c: self._secagg_roster[c]["num_samples"] / total for c in order},
            )
            if self._secagg_threshold is not None:
                payload["threshold"] = self._secagg_threshold
        return web.json_response(payload)

    async def _handle_secagg_shares_post(self, request: web.Request) -> web.StreamResponse:
        """Deposit one active client's ROUND secrets: ``{"epk": b64, "bh": b64,
        "blobs": {recipient: sealed_b64}}`` covering the active cohort exactly."""
        client_id = request.headers.get(HEADER_CLIENT)
        round_header = request.headers.get(HEADER_ROUND, "")
        if not client_id:
            return _error("missing client header", 400)
        if not self.secagg_roster_complete():
            return _error("roster incomplete: shares seal to the final cohort", 403)
        active = self.secagg_active_order()
        if client_id not in active:
            return _error(f"{client_id!r} not in the active cohort", 403)
        if round_header != str(self._round):
            return _error(f"shares for round {round_header!r}, server is on {self._round}",
                          400)
        body = await self._read_body(request)
        if self.require_signatures:
            from nanofed_tpu_torch.security.signing import verify_secagg_body_signature

            verdict = await self._check_signature(
                request, client_id, verify_secagg_body_signature, "shares", body, client_id,
                f"{self._secagg_session}:{self._round}")
            if verdict is not None:
                return verdict
        try:
            payload = json.loads(body)
            epk = base64.b64decode(payload["epk"])
            bh = base64.b64decode(payload.get("bh", ""))
            blobs = payload["blobs"]
            if len(epk) != 32:
                raise ValueError("bad ephemeral key length")
            if bh and len(bh) != 32:
                raise ValueError("bad self-seed commitment length")
            if set(blobs) != set(active):
                raise ValueError(f"blobs must cover the active cohort exactly "
                                 f"(got {len(blobs)}, expected {len(active)})")
            if not all(isinstance(v, str) for v in blobs.values()):
                raise ValueError("each blob must be a base64 string")
        except Exception as e:
            return _error(f"bad share deposit: {e}", 400)
        async with self._lock:
            # The round may have advanced while the body was read.
            if round_header != str(self._round):
                return _error(f"shares for round {round_header!r}, server moved to "
                              f"{self._round}", 409)
            existing = self._round_share_senders.get(client_id)
            if existing is not None:
                if existing == blobs and self._round_share_epks.get(client_id) == epk:
                    return web.json_response({"status": "success",
                                              "message": "already deposited"})
                return _error("shares already deposited with different content", 409)
            self._round_share_senders[client_id] = dict(blobs)
            self._round_share_epks[client_id] = epk
            if bh:
                self._round_share_bhs[client_id] = bh
            for recipient, blob in blobs.items():
                self._round_share_blobs.setdefault(recipient, {})[client_id] = blob
        self._log.info("secagg round-%s shares deposited by %s (%d/%d)", round_header,
                       client_id, len(self._round_share_senders), len(active))
        return web.json_response({"status": "success", "message": "shares deposited"})

    async def _handle_secagg_shares_get(self, request: web.Request) -> web.StreamResponse:
        """This round's share exchange: the active participants, and once every one of
        them has deposited, everyone's ephemeral key and this client's inbox."""
        client_id = request.headers.get(HEADER_CLIENT)
        if not client_id:
            return _error("missing client header", 400)
        if client_id not in self._secagg_roster:
            return _error(f"{client_id!r} not enrolled", 403)
        active = self.secagg_active_order()
        complete = self.secagg_shares_complete()
        payload: dict[str, Any] = {
            "status": "success",
            "round": self._round,
            "participants": active,
            "complete": complete,
            "deposited": len(self._round_share_senders),
            "expected": len(active),
        }
        round_threshold = self.secagg_threshold()
        if round_threshold is not None:
            payload["threshold"] = round_threshold
        if complete:
            payload["epks"] = {c: base64.b64encode(k).decode()
                               for c, k in self._round_share_epks.items()}
            payload["inbox"] = dict(self._round_share_blobs.get(client_id, {}))
        return web.json_response(payload)

    async def _handle_unmask_get(self, request: web.Request) -> web.StreamResponse:
        """``{"status": "none"}`` or the active unmask request."""
        if self._unmask_request is None:
            return web.json_response({"status": "none"})
        return web.json_response({"status": "pending", **self._unmask_request})

    async def _handle_unmask_post(self, request: web.Request) -> web.StreamResponse:
        """Buffer one survivor's reveals (Shamir shares of dropped clients' mask keys
        and of survivors' self-mask seeds)."""
        client_id = request.headers.get(HEADER_CLIENT)
        round_header = request.headers.get(HEADER_ROUND, "")
        if not client_id:
            return _error("missing client header", 400)
        snapshot = self._unmask_request
        if snapshot is None:
            return _error("no unmask round active", 403)
        if client_id not in snapshot["survivors"]:
            return _error(f"{client_id!r} is not a survivor of this round", 403)
        try:
            if int(round_header) != snapshot["round"]:
                raise ValueError
        except ValueError:
            return _error(f"reveal for round {round_header!r}, unmask round is "
                          f"{snapshot['round']}", 400)
        body = await self._read_body(request)
        if self.require_signatures:
            from nanofed_tpu_torch.security.signing import verify_secagg_body_signature

            # Bound to the cohort's session nonce and the round: a reveal captured
            # from an earlier cohort on this server does not verify.
            verdict = await self._check_signature(
                request, client_id, verify_secagg_body_signature, "unmask", body, client_id,
                f"{self._secagg_session}:{snapshot['round']}")
            if verdict is not None:
                return verdict
        try:
            reveals = json.loads(body)
            if not isinstance(reveals.get("sk"), dict) or not isinstance(reveals.get("b"), dict):
                raise ValueError("reveals must carry 'sk' and 'b' share maps")
        except Exception as e:
            return _error(f"bad reveals: {e}", 400)
        async with self._lock:
            active = self._unmask_request
            if (active is None or int(round_header) != active["round"]
                    or client_id not in active["survivors"]):
                return _error("unmask round changed while processing this reveal", 409)
            self._unmask_reveals[client_id] = reveals
            count, expected = len(self._unmask_reveals), len(active["survivors"])
        self._log.info("unmask reveals from %s (%d/%d survivors)", client_id, count, expected)
        return web.json_response({"status": "success", "message": "reveals accepted"})

    async def _handle_status(self, request: web.Request) -> web.StreamResponse:
        return web.json_response({
            "status": "success",
            "round": self._round,
            "num_updates": len(self._updates),
            "training_active": self._training_active,
        })

    async def _handle_test(self, request: web.Request) -> web.StreamResponse:
        return web.json_response({"status": "success", "message": "server is running"})

    async def _handle_metrics(self, request: web.Request) -> web.StreamResponse:
        """Prometheus text exposition of the attached registry: the whole process's
        instruments, so one scrape sees the coordinators' round and phase metrics
        beside the wire counters."""
        text = self.metrics_registry.render_prometheus()
        return web.Response(
            body=text.encode("utf-8"),
            headers={"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    @property
    def _app(self) -> web.Application:
        return self.transport.app

    async def start(self) -> None:
        await self.transport.start()

    async def stop(self) -> None:
        await self.transport.stop()
        if self._ingest_pipeline is not None:
            self._ingest_pipeline.close()
