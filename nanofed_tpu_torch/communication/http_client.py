"""HTTP federation client, the network mode (counterpart of
``nanofed_tpu/communication/http_client.py``).

An async context manager that fetches the global model, submits local updates (npz),
runs the client half of secure aggregation (enrollment, roster, the dropout-tolerant
share exchange, unmask reveals, masked submissions) and polls server status.  The wire
protocol is the JAX package's, so this client federates against either package's
server.

``update_encoding="q8-delta"`` or ``"topk8-delta"`` submits the round's delta against
the fetched global, compressed by the codec in the JAX package's numpy float32
arithmetic, so both packages send the same bytes for the same delta and seed; topk8
keeps the un-sent tail for error feedback.  ``security_manager`` signs every update
(over what the server will reconstruct) and every secure-aggregation body.  Every
submit carries the ``X-NanoFed-Trace`` header that ``observability.new_trace`` derives
from (client id, round, submit sequence), byte-equal to the JAX client's, so retries of
one logical submit ride one trace.  Client wire metrics go to ``registry`` (default:
the process-wide one) under the JAX package's families.  Fault-injection hooks
(``wire_filter``) come with a later item; setting one raises ``NotImplementedError``
naming it.  ``aiohttp`` is needed to open a client, not to import this module.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
from dataclasses import dataclass
from typing import Any

import numpy as np

import torch

from nanofed_tpu_torch.communication.codec import (
    ENCODING_Q8_DELTA,
    ENCODING_TOPK8,
    decode_delta_topk8,
    decode_params,
    encode_delta_q8,
    encode_delta_topk8,
    encode_params,
    reconstruct_q8,
)
from nanofed_tpu_torch.communication.http_server import (
    HEADER_CLIENT,
    HEADER_ENCODING,
    HEADER_METRICS,
    HEADER_ROUND,
    HEADER_SECAGG,
    HEADER_SIGNATURE,
    HEADER_STATUS,
    HEADER_SUBMIT,
    HEADER_TRACE,
    refuse_later_slice_options,
)
from nanofed_tpu_torch.communication.retry import (
    RETRYABLE_STATUSES,
    RetryPolicy,
    parse_retry_after,
)
from nanofed_tpu_torch.communication.transport import require_aiohttp
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry
from nanofed_tpu_torch.observability.tracing import new_trace
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger

def _np32(leaf: Any) -> np.ndarray:
    """A leaf as host float32 numpy (the arithmetic of the compressed paths)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().to(torch.float32).numpy()
    return np.asarray(leaf, np.float32)


def _tensors(arrays: dict[str, np.ndarray]) -> Params:
    return {name: torch.from_numpy(np.asarray(a)) for name, a in arrays.items()}


#: Client options of later slices, with the JAX defaults (accepted).
LATER_SLICE_OPTIONS: dict[str, tuple[Any, str]] = {
    "wire_filter": (None, "fault injection (faults slice, queue A item 17)"),
}


@dataclass(frozen=True)
class ClientEndpoints:
    model: str = "/model"
    update: str = "/update"
    status: str = "/status"
    secagg_register: str = "/secagg/register"
    secagg_roster: str = "/secagg/roster"
    secagg_shares: str = "/secagg/shares"
    secagg_unmask: str = "/secagg/unmask"


@dataclass(frozen=True)
class SecAggRoster:
    """The completed cohort roster a client needs to mask its update: canonical client
    order (the mask sign convention), everyone's X25519 public key, the cohort's mask
    backend, and the server-computed NORMALIZED FedAvg weights (so the masked modular
    sum IS the weighted mean).  ``threshold`` is the cohort-derived Shamir threshold of
    a window enrollment, None on exact-cohort rosters."""

    client_order: list[str]
    public_keys: dict[str, bytes]
    weights: dict[str, float]
    backend: str = "host"
    threshold: int | None = None

    def index_of(self, client_id: str) -> int:
        return self.client_order.index(client_id)

    def ordered_keys(self) -> list[bytes]:
        return [self.public_keys[c] for c in self.client_order]


class HTTPClient:
    """One federated client's connection to the server::

        async with HTTPClient(url, "client_1") as client:
            params, rnd, active = await client.fetch_global_model(template)
            ...train...
            await client.submit_update(params, metrics)
    """

    def __init__(
        self,
        server_url: str,
        client_id: str,
        endpoints: ClientEndpoints | None = None,
        timeout_s: float = 300.0,
        security_manager: Any | None = None,
        update_encoding: str = "npz",
        topk_fraction: float = 0.05,
        retry: RetryPolicy | None = None,
        clock: Clock | None = None,
        registry: MetricsRegistry | None = None,
        **later_slice_options: Any,
    ) -> None:
        """``security_manager`` (a ``security.signing.SecurityManager``) signs every
        update and secure-aggregation body; pair it with a server built with
        ``require_signatures=True`` and this client's public key.
        ``update_encoding`` is ``"npz"`` (full params), ``"q8-delta"`` or
        ``"topk8-delta"`` (the top ``topk_fraction`` of each leaf, with error
        feedback); the compressed ones need the round's global fetched through this
        client, the delta's base.  ``retry`` makes model fetches and update submits
        survive transient failures (connection errors, 429 with its ``Retry-After``
        as a floor, 502/503/504) with exponential backoff and jitter; every logical
        submit carries an idempotency key, so the server folds a retried submit at
        most once.  ``clock`` injects the time source for backoff sleeps and poll
        deadlines.  ``registry`` receives the client's wire metrics."""
        refuse_later_slice_options("HTTPClient", later_slice_options, LATER_SLICE_OPTIONS)
        if update_encoding not in ("npz", ENCODING_Q8_DELTA, ENCODING_TOPK8):
            raise NanoFedError(f"unknown update_encoding {update_encoding!r} (choose 'npz', "
                               f"'{ENCODING_Q8_DELTA}', or '{ENCODING_TOPK8}')")
        if not 0.0 < topk_fraction <= 1.0:
            raise NanoFedError("topk_fraction must be in (0, 1]")
        require_aiohttp()
        import aiohttp

        self.server_url = server_url.rstrip("/")
        self.client_id = client_id
        self.endpoints = endpoints or ClientEndpoints()
        self.security_manager = security_manager
        self.update_encoding = update_encoding
        self.topk_fraction = topk_fraction
        self.retry = retry
        self._clock = clock or SYSTEM_CLOCK
        self._retry_rng = retry.rng_for(client_id) if retry is not None else None
        self._timeout = aiohttp.ClientTimeout(total=timeout_s)
        self._session: Any = None
        self._log = Logger()
        self.current_round = 0
        self._submit_seq = 0  # idempotency-key counter (one per LOGICAL submit)
        self._last_update_post: tuple[str, bytes, dict[str, str]] | None = None
        self._secagg_session = ""  # cohort session nonce, cached from the roster
        self._last_global: Params | None = None  # the compressed delta's base
        self._residual: dict[str, np.ndarray] | None = None  # topk8 error feedback
        # After a rejected topk8 submit the whole delta is folded into _residual;
        # _pending_base is the local params that fold covered, so a retry measures only
        # the training since (zero for an identical retry) instead of counting the
        # round's delta twice.
        self._pending_base: Params | None = None
        # Client-side wire metrics, the JAX package's families.
        reg = registry or get_registry()
        self._m_bytes_tx = reg.counter(
            "nanofed_client_bytes_sent_total",
            "Request body bytes sent by HTTP clients, by endpoint",
            labels=("endpoint",),
        )
        self._m_bytes_rx = reg.counter(
            "nanofed_client_bytes_received_total",
            "Response body bytes fetched by HTTP clients, by endpoint",
            labels=("endpoint",),
        )
        self._m_submissions = reg.counter(
            "nanofed_client_submissions_total",
            "Update submissions by result (accepted / rejected)",
            labels=("result",),
        )
        self._m_codec_ratio = reg.gauge(
            "nanofed_client_codec_ratio",
            "Last update's wire bytes / raw float32 bytes, by encoding",
            labels=("encoding",),
        )
        self._m_retries = reg.counter(
            "nanofed_client_retries_total",
            "Request retries by endpoint and failure reason",
            labels=("endpoint", "reason"),
        )

    @property
    def secagg_session(self) -> str:
        """The cohort session nonce (set by :meth:`fetch_secagg_roster`), which share
        blobs' associated data binds to."""
        return self._secagg_session

    async def __aenter__(self) -> "HTTPClient":
        import aiohttp

        self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self

    async def __aexit__(self, *exc: Any) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    def _require_session(self) -> Any:
        if self._session is None:
            raise NanoFedError("HTTPClient must be used as an async context manager")
        return self._session

    @staticmethod
    async def _error_message(resp: Any) -> str:
        try:
            return str((await resp.json()).get("message"))
        except Exception:  # framework error pages (413, 500) are text, not JSON
            return (await resp.text())[:200]

    async def _request_with_retries(
        self, method: str, url: str, *, data: bytes | None = None,
        headers: dict[str, str] | None = None, endpoint: str = "",
    ) -> tuple[int, dict[str, str], bytes | None, str | None]:
        """One LOGICAL request under the retry policy (a single request without one).
        Returns ``(status, response_headers, body, error_message)``; a connection
        failure is status -1.  The same bytes and headers ride every attempt."""
        import aiohttp

        session = self._require_session()
        policy = self.retry
        deadline = (self._clock.time() + policy.budget_s
                    if policy is not None and policy.budget_s is not None else None)
        attempt = 1
        while True:
            retry_after: float | None = None
            try:
                async with session.request(method, url, data=data, headers=headers) as resp:
                    status = resp.status
                    if status == 200:
                        return status, dict(resp.headers), await resp.read(), None
                    retry_after = parse_retry_after(resp.headers.get("Retry-After"))
                    message = await self._error_message(resp)
                retryable, reason = status in RETRYABLE_STATUSES, f"http_{status}"
            except (aiohttp.ClientConnectionError, asyncio.TimeoutError) as e:
                status, message = -1, f"{type(e).__name__}: {e}"
                retryable, reason = True, type(e).__name__
            if policy is None or not retryable or attempt >= policy.max_attempts:
                return status, {}, None, message
            delay = policy.backoff_s(attempt, self._retry_rng, retry_after)
            if deadline is not None and self._clock.time() + delay > deadline:
                return status, {}, None, f"{message} (retry budget exhausted)"
            self._m_retries.inc(endpoint=endpoint, reason=reason)
            self._log.warning("%s %s failed (%s); retry %d/%d in %.3fs", method, endpoint,
                              reason, attempt, policy.max_attempts - 1, delay)
            await self._clock.sleep(delay)
            attempt += 1

    async def _post(self, url: str, body: bytes, headers: dict[str, str], what: str) -> bool:
        session = self._require_session()
        async with session.post(url, data=body, headers=headers) as resp:
            if resp.status != 200:
                self._log.warning("%s rejected (HTTP %d): %s", what, resp.status,
                                  await self._error_message(resp))
                return False
        return True

    async def _get_json(self, url: str, what: str,
                        headers: dict[str, str] | None = None) -> dict[str, Any]:
        session = self._require_session()
        async with session.get(url, headers=headers) as resp:
            if resp.status != 200:
                raise NanoFedError(f"{what}: HTTP {resp.status}")
            return await resp.json()

    async def fetch_global_model(
        self, like: Params | None = None
    ) -> tuple[Params | None, int, bool]:
        """GET the current global model: ``(params, round_number, training_active)``,
        params None once the server has terminated training.  Params are CPU tensors
        (validated against ``like`` when given)."""
        url = self.server_url + self.endpoints.model
        status, resp_headers, payload, message = await self._request_with_retries(
            "GET", url, endpoint="model")
        if status != 200 or payload is None:
            raise NanoFedError(f"fetch_global_model: HTTP {status} ({message})")
        round_number = int(resp_headers.get(HEADER_ROUND, "0"))
        self.current_round = round_number
        if resp_headers.get(HEADER_STATUS) == "terminated":
            return None, round_number, False
        self._m_bytes_rx.inc(len(payload), endpoint="model")
        params = decode_params(payload, like=like)
        if self.update_encoding != "npz":
            # The delta's base; a fresh base resets the retry bookkeeping (a rejected
            # submit's mass is already in _residual, which rides the next delta).
            self._last_global = params
            self._pending_base = None
        return params, round_number, True

    def _submit_headers(self, metrics: dict[str, Any]) -> dict[str, str]:
        self._submit_seq += 1
        return {
            HEADER_CLIENT: self.client_id,
            HEADER_ROUND: str(self.current_round),
            HEADER_METRICS: json.dumps(metrics),
            HEADER_SUBMIT: f"{self.client_id}:{self.current_round}:{self._submit_seq}",
            # Derived from the idempotency key's identity: retries of this logical
            # submit ride one trace.
            HEADER_TRACE: new_trace(
                self.client_id, self.current_round, self._submit_seq).header(),
        }

    def _encode_delta(self, params: Params) -> tuple[bytes, Params, Any, Any]:
        """``(body, signed_params, delta, staged_residual)`` of a compressed submit, in
        the JAX client's numpy float32 arithmetic.  ``signed_params`` is what the
        server will reconstruct; topk8's ``staged_residual`` (the un-sent tail) is
        committed only once the server accepts."""
        if self._last_global is None:
            raise NanoFedError(
                f"{self.update_encoding} encoding needs the round's global model as its "
                "base: call fetch_global_model on this client before submit_update")
        base = self._pending_base if self._pending_base is not None else self._last_global
        delta = {name: _np32(p) - _np32(base[name]) for name, p in params.items()}
        if self.update_encoding == ENCODING_Q8_DELTA:
            body = encode_delta_q8(_tensors(delta))
            return body, reconstruct_q8(self._last_global, body), delta, None
        if self._residual is not None:
            delta = {name: d + self._residual[name] for name, d in delta.items()}
        body = encode_delta_topk8(_tensors(delta), self.topk_fraction)
        sent = {name: _np32(s) for name, s in
                decode_delta_topk8(body, like=self._last_global).items()}
        staged = {name: d - sent[name] for name, d in delta.items()}
        signed = _tensors({name: _np32(g) + sent[name]
                           for name, g in self._last_global.items()})
        return body, signed, delta, staged

    async def submit_update(self, params: Params, metrics: dict[str, Any]) -> bool:
        """POST local training results for the current round: one LOGICAL submit with
        a fresh idempotency key, retried under the ``retry`` policy.  The body is the
        npz params or the compressed delta; with a ``security_manager`` the signature
        covers what the server will aggregate.  A rejected topk8 submit folds its
        whole delta into the error-feedback residual."""
        self._require_session()
        url = self.server_url + self.endpoints.update
        headers = self._submit_headers(metrics)
        delta = staged = None
        if self.update_encoding == "npz":
            body, signed = encode_params(params), params
        else:
            body, signed, delta, staged = self._encode_delta(params)
            headers[HEADER_ENCODING] = self.update_encoding
        raw_bytes = sum(
            (p.numel() if torch.is_tensor(p) else np.size(p)) * 4 for p in params.values())
        if raw_bytes:
            self._m_codec_ratio.set(len(body) / raw_bytes, encoding=self.update_encoding)
        if self.security_manager is not None:
            signature = self.security_manager.sign_update(
                signed, self.client_id, self.current_round, headers[HEADER_METRICS])
            headers[HEADER_SIGNATURE] = base64.b64encode(signature).decode()
        self._m_bytes_tx.inc(len(body), endpoint="update")
        self._last_update_post = (url, body, dict(headers))
        status, _, _, message = await self._request_with_retries(
            "POST", url, data=body, headers=headers, endpoint="update")
        if status != 200:
            self._log.warning("update rejected (HTTP %d): %s", status, message)
            self._m_submissions.inc(result="rejected")
            if self.update_encoding == ENCODING_TOPK8:
                # Nothing was applied server-side: the whole combined delta rides the
                # next submit, measured from these params on.
                self._residual, self._pending_base = delta, params
            return False
        if staged is not None:
            self._residual, self._pending_base = staged, None
        self._m_submissions.inc(result="accepted")
        return True

    async def resend_last_update(self) -> bool:
        """Re-POST the exact bytes and headers (the same idempotency key) of the last
        ``submit_update``: the duplicate a retry after a lost ACK makes.  The server
        folds it at most once; the error-feedback state is untouched."""
        if self._last_update_post is None:
            raise NanoFedError("no update has been submitted yet")
        url, body, headers = self._last_update_post
        status, _, _, message = await self._request_with_retries(
            "POST", url, data=body, headers=headers, endpoint="update")
        if status != 200:
            self._log.warning("duplicate update rejected (HTTP %d): %s", status, message)
            return False
        return True

    # ------------------------------------------------------------------
    # Secure aggregation (pairwise masking over the wire)
    # ------------------------------------------------------------------

    async def register_secagg(
        self, public_key: bytes, num_samples: float, backend: str = "host"
    ) -> bool:
        """Enroll in the secure-aggregation cohort with this client's X25519 public
        key, its FedAvg sample count and its mask ``backend`` (``host`` or ``cuda``;
        the server pins the first enrollment's backend and refuses a mixed cohort)."""
        body = json.dumps({"public_key": base64.b64encode(public_key).decode(),
                           "num_samples": num_samples, "backend": backend}).encode()
        headers = {HEADER_CLIENT: self.client_id, "Content-Type": "application/json"}
        if self.security_manager is not None:
            # Signed over the cohort's session nonce, which the roster endpoint gives.
            try:
                session = (await self._get_json(
                    self.server_url + self.endpoints.secagg_roster, "secagg session fetch"
                )).get("session", "")
            except NanoFedError as e:
                self._log.warning("%s", e)
                return False
            signature = self.security_manager.sign_enrollment(
                self.client_id, public_key, num_samples, session, backend)
            headers[HEADER_SIGNATURE] = base64.b64encode(signature).decode()
        return await self._post(self.server_url + self.endpoints.secagg_register, body,
                                headers, "secagg registration")

    async def fetch_secagg_roster(
        self, poll_interval_s: float = 0.05, timeout_s: float = 30.0
    ) -> SecAggRoster:
        """Poll the roster endpoint until the cohort is complete."""
        url = self.server_url + self.endpoints.secagg_roster
        deadline = self._clock.time() + timeout_s
        while True:
            payload = await self._get_json(url, "fetch_secagg_roster")
            self._secagg_session = str(payload.get("session", ""))
            if payload.get("complete"):
                raw_t = payload.get("threshold")
                return SecAggRoster(
                    client_order=list(payload["client_order"]),
                    public_keys={c: base64.b64decode(k)
                                 for c, k in payload["public_keys"].items()},
                    weights={c: float(w) for c, w in payload["weights"].items()},
                    backend=str(payload.get("backend", "host")),
                    threshold=int(raw_t) if raw_t is not None else None,
                )
            if self._clock.time() > deadline:
                raise NanoFedError(
                    f"secagg roster incomplete after {timeout_s}s "
                    f"({payload.get('enrolled')}/{payload.get('expected')})")
            await self._clock.sleep(poll_interval_s)

    async def fetch_secagg_participants(self) -> list[str]:
        """This round's ACTIVE cohort (enrolled minus evicted): what the per-round
        shares must cover."""
        participants, _ = await self.fetch_secagg_round_info()
        return participants

    async def fetch_secagg_round_info(self) -> tuple[list[str], int | None]:
        """This round's ACTIVE cohort and the server-announced Shamir threshold (None
        on exact-cohort servers: use the shared config)."""
        payload = await self._get_json(self.server_url + self.endpoints.secagg_shares,
                                       "fetch_secagg_round_info",
                                       headers={HEADER_CLIENT: self.client_id})
        raw_t = payload.get("threshold")
        return list(payload["participants"]), (int(raw_t) if raw_t is not None else None)

    async def deposit_secagg_shares(
        self, round_number: int, ephemeral_public_key: bytes, blobs: dict[str, str],
        self_seed_commitment: bytes | None = None,
    ) -> bool:
        """Deposit this client's ROUND secrets (dropout-tolerant mode, start of each
        round): the fresh ephemeral mask public key, the sealed Shamir share blobs
        covering the active cohort (``security.secure_agg.make_dropout_shares``) and
        the sha256 commitment to the self-mask seed."""
        payload: dict[str, Any] = {"epk": base64.b64encode(ephemeral_public_key).decode(),
                                   "blobs": blobs}
        if self_seed_commitment is not None:
            payload["bh"] = base64.b64encode(self_seed_commitment).decode()
        body = json.dumps(payload).encode()
        headers = self._signed_body_headers("shares", body, round_number)
        return await self._post(self.server_url + self.endpoints.secagg_shares, body,
                                headers, "share deposit")

    async def fetch_secagg_inbox(
        self, round_number: int | None = None,
        poll_interval_s: float = 0.05, timeout_s: float = 30.0,
    ) -> tuple[dict[str, bytes], dict[str, str]]:
        """Poll the round's share exchange until every active member has deposited;
        returns ``(ephemeral_public_keys, inbox)``.  ``round_number`` pins the wait to
        the round this client deposited for: if the server moves on mid-poll, the
        wait ends with an error."""
        url = self.server_url + self.endpoints.secagg_shares
        deadline = self._clock.time() + timeout_s
        while True:
            payload = await self._get_json(url, "fetch_secagg_inbox",
                                           headers={HEADER_CLIENT: self.client_id})
            if round_number is not None and payload.get("round") != round_number:
                raise NanoFedError(f"share exchange moved to round {payload.get('round')} "
                                   f"while waiting on round {round_number}")
            if payload.get("complete"):
                epks = {c: base64.b64decode(k) for c, k in payload["epks"].items()}
                return epks, dict(payload["inbox"])
            if self._clock.time() > deadline:
                raise NanoFedError(
                    f"share deposits incomplete after {timeout_s}s "
                    f"({payload.get('deposited')}/{payload.get('expected')})")
            await self._clock.sleep(poll_interval_s)

    def _signed_body_headers(self, kind: str, body: bytes, round_number: int
                             ) -> dict[str, str]:
        """Headers of a share deposit or unmask reveal, signed (with a
        ``security_manager``) over the body, the cohort session and the round."""
        headers = {HEADER_CLIENT: self.client_id, HEADER_ROUND: str(round_number),
                   "Content-Type": "application/json"}
        if self.security_manager is not None:
            signature = self.security_manager.sign_secagg_body(
                kind, body, self.client_id, f"{self._secagg_session}:{round_number}")
            headers[HEADER_SIGNATURE] = base64.b64encode(signature).decode()
        return headers

    async def poll_unmask_request(self) -> dict[str, Any] | None:
        """One poll of the unmask endpoint: the active request (round, dropped,
        survivors) or None."""
        payload = await self._get_json(self.server_url + self.endpoints.secagg_unmask,
                                       "poll_unmask_request")
        return payload if payload.get("status") == "pending" else None

    async def submit_unmask_reveals(self, round_number: int, reveals: dict[str, Any]) -> bool:
        """POST this survivor's unmask reveals (``secure_agg.build_unmask_reveals``,
        which refuses to reveal both secrets of one client)."""
        body = json.dumps(reveals).encode()
        headers = self._signed_body_headers("unmask", body, round_number)
        return await self._post(self.server_url + self.endpoints.secagg_unmask, body,
                                headers, "unmask reveals")

    async def submit_masked_update(self, masked: np.ndarray, metrics: dict[str, Any]) -> bool:
        """POST a pairwise-masked uint32 vector (``secure_agg.mask_update``) for the
        current round, as a compressed npz holding one ``masked`` array."""
        buf = io.BytesIO()
        np.savez_compressed(buf, masked=np.asarray(masked, np.uint32))
        body = buf.getvalue()
        headers = self._submit_headers(metrics)
        headers[HEADER_SECAGG] = "masked"
        if self.security_manager is not None:
            signature = self.security_manager.sign_masked_update(
                body, self.client_id, self.current_round, headers[HEADER_METRICS])
            headers[HEADER_SIGNATURE] = base64.b64encode(signature).decode()
        return await self._post(self.server_url + self.endpoints.update, body, headers,
                                "masked update")

    async def check_server_status(self) -> dict[str, Any]:
        """GET /status: round, buffered updates, whether training is active."""
        return await self._get_json(self.server_url + self.endpoints.status,
                                    "check_server_status")

    async def wait_for_completion(self, poll_interval_s: float = 1.0) -> None:
        """Poll the status until the server stops training."""
        while True:
            status = await self.check_server_status()
            if not status.get("training_active", False):
                return
            await self._clock.sleep(poll_interval_s)
