"""HTTP transport layer: routing, tenant resolution and lifecycle (counterpart of
``nanofed_tpu/communication/transport.py``).

This module owns what about the wire is not per-session state: the aiohttp
application, the catch-all route table, tenant resolution and the bounded body read.
:class:`~nanofed_tpu_torch.communication.http_server.HTTPServer` is one session behind
it.  Tenant identity travels as a path prefix (``/t/<tenant>/update``) or as the
``X-NanoFed-Tenant`` header; an unknown tenant is a 404.  A single-tenant server owns
a private transport and mounts itself as the default session, so unprefixed requests
route to it.  (Several tenants on one transport are the service slice's.)  Unknown
tenants are counted in ``nanofed_unknown_tenant_total`` on the transport's registry.

``aiohttp`` is imported when this module is, but a missing ``aiohttp`` only raises
when a transport is built, so ``import nanofed_tpu_torch`` works without it.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Protocol

try:
    from aiohttp import web

    _AIOHTTP_ERROR: str | None = None
except ImportError as _e:  # pragma: no cover - depends on the environment
    web = None  # type: ignore[assignment]
    _AIOHTTP_ERROR = str(_e)

from nanofed_tpu_torch.observability.registry import MetricsRegistry, get_registry
from nanofed_tpu_torch.utils.logger import Logger

__all__ = [
    "HEADER_TENANT",
    "HTTPTransport",
    "TENANT_PATH_PREFIX",
    "free_port",
    "read_body_bounded",
    "require_aiohttp",
    "tenant_base_url",
]

#: Tenant identity header (the path-prefix form is ``/t/<tenant>/...``).
HEADER_TENANT = "X-NanoFed-Tenant"

#: Path prefix for tenant-addressed requests: ``/t/<tenant>/<endpoint>``.
TENANT_PATH_PREFIX = "/t"

MAX_REQUEST_SIZE = 100 * 1024 * 1024

Handler = Callable[["web.Request"], Awaitable["web.StreamResponse"]]


def require_aiohttp() -> None:
    if _AIOHTTP_ERROR is not None:
        raise ImportError(
            "the network mode needs the 'aiohttp' package, which failed to import: "
            f"{_AIOHTTP_ERROR}"
        )


class TransportSession(Protocol):
    """What the transport needs from a session: logical-path dispatch."""

    async def dispatch(self, path: str, request: web.Request) -> web.StreamResponse: ...


async def read_body_bounded(request: web.Request, timeout_s: float) -> bytes:
    """Read a request body with a TIME bound (``client_max_size`` bounds the size):
    a peer trickling bytes must not hold a handler open past ``timeout_s``.  Raises
    ``asyncio.TimeoutError``; the caller owns the 408 answer."""
    return await asyncio.wait_for(request.read(), timeout=timeout_s)


def _json_error(message: str, status: int) -> web.Response:
    return web.json_response({"status": "error", "message": message}, status=status)


class HTTPTransport:
    """One listener multiplexing tenant sessions (plus an optional default).

    Routing is a catch-all pair, ``/t/{tenant}/{tail}`` and ``/{tail}``, resolved
    here and dispatched to the session's logical-path table, so adding a tenant is a
    dict insert, not a router mutation."""

    def __init__(
        self, host: str = "127.0.0.1", port: int = 8080,
        max_request_size: int = MAX_REQUEST_SIZE,
        registry: MetricsRegistry | None = None,
    ) -> None:
        require_aiohttp()
        self.host = host
        self.port = port
        self._log = Logger()
        self._sessions: dict[str, TransportSession] = {}
        self._default: TransportSession | None = None
        self.unknown_tenant_requests = 0
        self.metrics_registry = registry or get_registry()
        self._m_unknown_tenant = self.metrics_registry.counter(
            "nanofed_unknown_tenant_total",
            "Requests addressed to a tenant this transport does not host (404)",
        )
        self._app = web.Application(client_max_size=max_request_size)
        self._app.router.add_route(
            "*", TENANT_PATH_PREFIX + "/{tenant}/{tail:.+}", self._dispatch_tenant_path
        )
        self._app.router.add_route("*", "/{tail:.+}", self._dispatch_root_path)
        self._runner: web.AppRunner | None = None

    @property
    def app(self) -> web.Application:
        return self._app

    def add_session(self, session: TransportSession, tenant: str | None = None) -> None:
        """Mount a session: ``tenant=None`` as the default (unprefixed, headerless
        requests), a name under ``/t/<tenant>/...``.  A live name is never replaced."""
        if tenant is None:
            if self._default is not None and self._default is not session:
                raise ValueError("a default session is already mounted")
            self._default = session
            return
        if not tenant or "/" in tenant:
            raise ValueError(f"invalid tenant name {tenant!r}")
        if self._sessions.get(tenant) not in (None, session):
            raise ValueError(f"tenant {tenant!r} is already mounted")
        self._sessions[tenant] = session

    def remove_session(self, tenant: str) -> None:
        """Unmount a tenant (idempotent); later requests 404."""
        self._sessions.pop(tenant, None)

    def tenants(self) -> list[str]:
        return sorted(self._sessions)

    def _unknown(self, message: str) -> web.Response:
        self.unknown_tenant_requests += 1
        self._m_unknown_tenant.inc()
        return _json_error(message, 404)

    async def _dispatch_tenant_path(self, request: web.Request) -> web.StreamResponse:
        tenant = request.match_info["tenant"]
        session = self._sessions.get(tenant)
        if session is None:
            return self._unknown(f"unknown tenant {tenant!r}")
        return await session.dispatch("/" + request.match_info["tail"], request)

    async def _dispatch_root_path(self, request: web.Request) -> web.StreamResponse:
        tenant = request.headers.get(HEADER_TENANT)
        if tenant is not None:
            session = self._sessions.get(tenant)
            if session is None:
                return self._unknown(f"unknown tenant {tenant!r}")
        else:
            session = self._default
            if session is None:
                return self._unknown(
                    "no default session: address a tenant via "
                    f"{TENANT_PATH_PREFIX}/<tenant>/... or the {HEADER_TENANT} header"
                )
        return await session.dispatch("/" + request.match_info["tail"], request)

    async def start(self) -> None:
        self._runner = web.AppRunner(self._app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self._log.info("HTTP transport on %s:%d (%d tenant sessions%s)", self.host,
                       self.port, len(self._sessions),
                       ", default mounted" if self._default is not None else "")

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None


def tenant_base_url(base: str, tenant: str) -> str:
    """``http://host:port`` + tenant -> ``http://host:port/t/<tenant>``."""
    return base.rstrip("/") + f"{TENANT_PATH_PREFIX}/{tenant}"


def free_port() -> int:
    """An ephemeral localhost port for in-process servers."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
