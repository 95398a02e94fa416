"""Client-boundary fault injection: a scripted federation client under a plan
(counterpart of ``nanofed_tpu/faults/injector.py``).

``ChaosClient`` wraps the port's ``HTTPClient`` and consults a :class:`ChaosSchedule`
before every submit, applying the client-side fault kinds where a real flaky client
would produce them:

* ``crash``      — ``alive(round)`` turns False; the driving loop exits, which is what
  a crashed process looks like to the server (silence).
* ``delay``      — extra latency (on the injected clock) before the submit.
* ``skew``       — the submit's round header is shifted back ``int(seconds)`` rounds:
  a clock-skewed straggler, answered by the server's stale-round 400.
* ``corrupt``    — the wire body is bit-flipped after signing
  (``HTTPClient(wire_filter=...)``): the server must reject it, never aggregate it.
* ``duplicate``  — the last update is re-POSTed with the SAME idempotency key
  ``count`` extra times: the retry storm the server's dedupe folds at most once.

Training, encoding, signing and retrying stay the real client's: chaos only perturbs
the boundary.
"""

from __future__ import annotations

from typing import Any

from nanofed_tpu_torch.communication.http_client import HTTPClient
from nanofed_tpu_torch.faults.plan import ChaosSchedule
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger

__all__ = ["ChaosClient"]


def _flip_bits(body: bytes) -> bytes:
    """Deterministically corrupt a wire body (every 97th byte XOR 0xFF: enough to
    break any codec's structure, whatever the payload size)."""
    out = bytearray(body)
    for i in range(0, len(out), 97):
        out[i] ^= 0xFF
    return bytes(out)


class ChaosClient:
    """Drives one ``HTTPClient`` through a fault plan::

        chaos = ChaosClient(client, schedule, clock=clock)
        while chaos.alive(round_number):
            params, rnd, active = await client.fetch_global_model(like=template)
            ...train...
            await chaos.submit(trained, metrics, rnd)
    """

    def __init__(self, client: HTTPClient, schedule: ChaosSchedule,
                 clock: Clock | None = None) -> None:
        self.client = client
        self.schedule = schedule
        self._clock = clock or SYSTEM_CLOCK
        self._log = Logger()

    def alive(self, round_number: int) -> bool:
        """False once the plan has crashed this client (permanently)."""
        return not self.schedule.crashed(self.client.client_id, round_number)

    async def submit(self, params: Any, metrics: dict[str, Any], round_number: int) -> bool:
        """One logical submit with this round's planned faults applied."""
        events = self.schedule.client_events(self.client.client_id, round_number)
        delay = sum(e.seconds for e in events if e.kind == "delay")
        skew = next((int(e.seconds) for e in events if e.kind == "skew"), 0)
        corrupt = any(e.kind == "corrupt" for e in events)
        duplicates = sum(e.count for e in events if e.kind == "duplicate")
        if delay:
            self._log.info("chaos: %s straggling %.3fs in round %d",
                           self.client.client_id, delay, round_number)
            await self._clock.sleep(delay)
        if skew:
            # Left skewed on purpose: the client's next fetch_global_model resets
            # current_round, as a real client re-syncing does.
            self.client.current_round = round_number - skew
        previous_filter = self.client.wire_filter
        if corrupt:
            self.client.wire_filter = lambda endpoint, body: _flip_bits(body)
        try:
            ok = await self.client.submit_update(params, metrics)
        finally:
            self.client.wire_filter = previous_filter
        for _ in range(duplicates):
            # The retry storm: identical bytes, identical idempotency key.
            await self.client.resend_last_update()
        return ok
