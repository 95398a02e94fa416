"""HTTP federation server, the network mode (counterpart of
``nanofed_tpu/communication/http_server.py``).

``GET /model`` serves the current global params (npz, ``communication.codec``),
``POST /update`` buffers client updates for the current round (stale rounds are a
400), ``GET /status`` reports the round, and the secure-aggregation endpoints run the
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

This slice serves the synchronous rounds.  The server options of later slices raise
``NotImplementedError`` naming the slice (:data:`LATER_SLICE_OPTIONS`), and a
``q8-delta``/``topk8-delta`` submission is refused with 400.  ``aiohttp`` is needed to
build a server, not to import this module.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import math
import secrets
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np

from nanofed_tpu_torch.communication.codec import decode_params, encode_params
from nanofed_tpu_torch.communication.transport import (
    HTTPTransport,
    read_body_bounded,
    require_aiohttp,
    web,
)
from nanofed_tpu_torch.core.types import ModelUpdate, Params
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
HEADER_SECAGG = "X-NanoFed-SecAgg"  # "masked" flags a pairwise-masked uint32 payload
HEADER_ENCODING = "X-NanoFed-Encoding"  # absent/"npz" = full params
HEADER_SUBMIT = "X-NanoFed-Submit"  # idempotency key: one per LOGICAL submit

#: Server options of later slices, with the JAX defaults (accepted).  Any other value
#: raises NotImplementedError naming the slice.
LATER_SLICE_OPTIONS: dict[str, tuple[Any, str]] = {
    "ingest": (None, "the ingest pipeline (network-ingest slice)"),
    "staleness_window": (0, "async/FedBuff federation (network-ingest slice)"),
    "require_signatures": (False, "update signatures (security/signing slice)"),
    "client_keys": (None, "update signatures (security/signing slice)"),
    "chaos": (None, "chaos hooks (faults slice, queue A item 17)"),
    "registry": (None, "/metrics and tracing (observability slice, queue A item 19)"),
    "tracer": (None, "/metrics and tracing (observability slice, queue A item 19)"),
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
        read_timeout_s: float = 30.0,
        **later_slice_options: Any,
    ) -> None:
        """``read_timeout_s`` bounds how long a request body may take to arrive (a
        stalled read is answered 408)."""
        refuse_later_slice_options("HTTPServer", later_slice_options, LATER_SLICE_OPTIONS)
        require_aiohttp()
        if read_timeout_s <= 0:
            raise ValueError("read_timeout_s must be > 0")
        self.host = host
        self.port = port
        self.endpoints = endpoints or ServerEndpoints()
        self.read_timeout_s = read_timeout_s
        self._log = Logger()
        self._lock = asyncio.Lock()
        self._seen_submits: dict[str, deque[str]] = {}
        self._updates: dict[str, ModelUpdate] = {}
        self._params: Params | None = None
        self._params_bytes: bytes | None = None
        self._param_count = 0
        self._round = 0
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
        }
        self.transport = HTTPTransport(host=host, port=port,
                                       max_request_size=max_request_size)
        self.transport.add_session(self)

    # ------------------------------------------------------------------
    # Round-engine API
    # ------------------------------------------------------------------

    async def publish_model(self, params: Params, round_number: int) -> None:
        """Set the global params served to clients and advance the round.  Buffered
        plain and masked updates and the round's share state are dropped: a
        straggler's masks are bound to the OLD round and would not cancel."""
        payload = encode_params(params)
        async with self._lock:
            self._params = params
            self._params_bytes = payload
            self._param_count = sum(int(leaf.numel()) for leaf in params.values())
            self._round = round_number
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
        """Lock-free hint; the engine re-checks through :meth:`drain_updates`."""
        return len(self._updates)

    async def drain_updates(self) -> list[ModelUpdate]:
        """Atomically take the buffered updates for aggregation."""
        async with self._lock:
            updates = list(self._updates.values())
            self._updates.clear()
        return updates

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
            self.evictions += len(ids - self._secagg_evicted)
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
            raise web.HTTPRequestTimeout(
                text=json.dumps({"status": "error", "message": (
                    f"request body not received within {self.read_timeout_s:g}s")}),
                content_type="application/json",
            ) from None

    def _duplicate_submit(self, client_id: str, submit_id: str | None) -> bool:
        return submit_id is not None and submit_id in self._seen_submits.get(client_id, ())

    def _record_submit_locked(self, client_id: str, submit_id: str | None) -> None:
        if submit_id is not None:
            self._seen_submits.setdefault(
                client_id, deque(maxlen=SUBMIT_KEY_WINDOW)).append(submit_id)

    def _duplicate_response(self, client_id: str) -> web.StreamResponse:
        self._log.info("duplicate submit from %s folded at most once", client_id)
        return web.json_response({
            "status": "success",
            "message": "duplicate submit (already accepted; folded at most once)",
            "update_id": client_id,
            "duplicate": True,
        })

    def _stale(self, round_number: int) -> web.Response:
        return _error(f"update for round {round_number}, server is on {self._round}", 400)

    # ------------------------------------------------------------------
    # Handlers
    # ------------------------------------------------------------------

    async def _handle_get_model(self, request: web.Request) -> web.StreamResponse:
        if not self._training_active:
            return web.Response(status=200, headers={
                HEADER_STATUS: "terminated", HEADER_ROUND: str(self._round)})
        if self._params_bytes is None:
            return _error("no model published", 503)
        return web.Response(
            body=self._params_bytes, content_type="application/octet-stream",
            headers={HEADER_STATUS: "training", HEADER_ROUND: str(self._round)},
        )

    async def _handle_submit_update(self, request: web.Request) -> web.StreamResponse:
        client_id = request.headers.get(HEADER_CLIENT)
        round_header = request.headers.get(HEADER_ROUND)
        if not client_id or round_header is None:
            return _error("missing client/round headers", 400)
        try:
            round_number = int(round_header)
        except ValueError:
            return _error(f"bad round: {round_header!r}", 400)
        try:
            metrics: dict[str, Any] = json.loads(request.headers.get(HEADER_METRICS, "{}"))
        except json.JSONDecodeError:
            return _error("bad metrics header", 400)
        if self._params is None:
            return _error("no model published", 503)
        masked = request.headers.get(HEADER_SECAGG) == "masked"
        # Idempotent-submit dedupe first: a retry of an accepted submit may arrive
        # after the round advanced.  The authoritative re-check runs under the lock.
        submit_id = request.headers.get(HEADER_SUBMIT)
        if self._duplicate_submit(client_id, submit_id):
            return self._duplicate_response(client_id)
        if round_number != self._round:
            return self._stale(round_number)
        encoding = request.headers.get(HEADER_ENCODING, "npz")
        if encoding != "npz":
            return _error(
                f"encoding {encoding!r} is not accepted by this slice of "
                "nanofed_tpu_torch (q8/topk8 submissions come with the network-ingest "
                "slice); submit npz", 400)
        if masked:
            return await self._handle_masked_update(request, client_id, round_number,
                                                    metrics, submit_id)
        body = await self._read_body(request)
        async with self._lock:
            if round_number != self._round:
                return self._stale(round_number)
            base = self._params
        try:
            params = await asyncio.to_thread(decode_params, body, base)
        except Exception as e:
            return _error(f"bad payload: {e}", 400)
        async with self._lock:
            if self._duplicate_submit(client_id, submit_id):
                return self._duplicate_response(client_id)
            if round_number != self._round:
                return self._stale(round_number)
            self._updates[client_id] = ModelUpdate(
                client_id=client_id, round_number=round_number, params=params,
                metrics=metrics, timestamp=get_current_time().isoformat(),
            )
            self._record_submit_locked(client_id, submit_id)
            accepted = len(self._updates)
        self._log.info("update from %s (round %d, %d buffered)", client_id, round_number,
                       accepted)
        return web.json_response(
            {"status": "success", "message": "update accepted", "update_id": client_id})

    async def _handle_masked_update(
        self, request: web.Request, client_id: str, round_number: int,
        metrics: dict[str, Any], submit_id: str | None,
    ) -> web.StreamResponse:
        """Buffer a pairwise-masked uint32 vector.  Masked payloads look like uniform
        noise, so the only content check is structural: enrollment, dtype and length
        (the published model's parameter count)."""
        if client_id not in self._secagg_roster:
            return _error(f"{client_id!r} not enrolled", 403)
        if client_id in self._secagg_evicted:
            return _error(f"{client_id!r} was evicted from this cohort", 403)
        body = await self._read_body(request)
        expected_size = self._param_count

        def decode_masked() -> np.ndarray:
            with np.load(io.BytesIO(body)) as z:
                vec = z["masked"]
            if vec.dtype != np.uint32 or vec.shape != (expected_size,):
                raise ValueError(f"expected uint32[{expected_size}], got {vec.dtype}{vec.shape}")
            return vec

        try:
            vec = await asyncio.to_thread(decode_masked)
        except Exception as e:
            return _error(f"bad masked payload: {e}", 400)
        async with self._lock:
            if self._duplicate_submit(client_id, submit_id):
                return self._duplicate_response(client_id)
            if round_number != self._round:
                return self._stale(round_number)
            self._masked_updates[client_id] = (vec, metrics)
            self._record_submit_locked(client_id, submit_id)
            accepted = len(self._masked_updates)
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
