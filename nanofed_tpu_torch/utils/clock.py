"""Injectable clocks for the async communication stack (a copy of
``nanofed_tpu/utils/clock.py``).

Every wall-clock read and every sleep in ``nanofed_tpu_torch.communication`` (round
deadlines, poll intervals, retry backoff) goes through a :class:`Clock`, so a
test — or the chaos harness — can swap in a :class:`VirtualClock` and make
timeout, straggler, and backoff behavior a pure function of the schedule
instead of host load.  On a virtual clock a "slow client" is slow by construction, not by hoping the
host is contended the right amount.

Design constraints:

* ``time()`` is MONOTONIC (the event loop's clock, not ``time.time``): round
  deadlines must never jump with NTP corrections.
* ``sleep()`` is async.  Synchronous callers that only need timestamps (the
  bench, the span tracer) keep using ``time.perf_counter`` directly — this
  module is for code whose *waiting* must be injectable.
"""

from __future__ import annotations

import asyncio
import heapq
import time as _time

__all__ = ["Clock", "SYSTEM_CLOCK", "VirtualClock"]


class Clock:
    """Real time: ``time()`` is the running event loop's monotonic clock
    (``time.monotonic`` when called off-loop, e.g. from constructors) and
    ``sleep`` is ``asyncio.sleep``."""

    def time(self) -> float:
        try:
            return asyncio.get_running_loop().time()
        except RuntimeError:
            return _time.monotonic()

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(seconds)


#: Shared default instance — stateless, so one is enough for the process.
SYSTEM_CLOCK = Clock()


class VirtualClock(Clock):
    """Deterministic virtual time for async tests and seeded chaos schedules.

    ``time()`` returns the virtual now; ``sleep(d)`` parks the caller on a
    virtual deadline.  Time advances ONLY when every task that is going to run
    has run: a lazily-started advancer task yields the event loop
    ``grace_yields`` times (letting ready callbacks and localhost socket I/O
    complete), then jumps the clock to the earliest pending deadline and wakes
    that sleeper.  Consequences:

    * A 300 s virtual timeout expires in milliseconds of real time when nothing
      is coming — and *never* expires because the host core was contended,
      since blocking host work (a jit compile, a training step) freezes the
      advancer along with everything else.
    * Sleepers wake in deadline order, so "client A is 10x slower than
      client B" is an ordering guarantee, not a scheduling hint.

    Real socket I/O still happens (aiohttp runs unmodified); it completes
    during the grace yields, i.e. in ~zero virtual time.  Spurious early wakes
    relative to in-flight I/O are possible under extreme load, which is why
    poll loops must re-check their condition — the loops in
    ``communication`` all do.
    """

    def __init__(self, start: float = 0.0, grace_yields: int = 50) -> None:
        if grace_yields < 1:
            raise ValueError("grace_yields must be >= 1")
        self._now = float(start)
        self._grace = int(grace_yields)
        self._sleepers: list[tuple[float, int, asyncio.Future]] = []
        self._seq = 0
        self._advancer: asyncio.Task | None = None

    def time(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        """Manually move the clock forward (synchronous callers / setup code).
        Does NOT wake sleepers by itself — the advancer does that on its next
        pass, in deadline order."""
        if seconds < 0:
            raise ValueError("cannot move a clock backwards")
        self._now += seconds

    async def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            # Pure yield, no deadline: matches asyncio.sleep(0) semantics.
            await asyncio.sleep(0)
            return
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        heapq.heappush(self._sleepers, (self._now + seconds, self._seq, fut))
        self._seq += 1
        self._ensure_advancer(loop)
        await fut

    def _ensure_advancer(self, loop: asyncio.AbstractEventLoop) -> None:
        if (
            self._advancer is None
            or self._advancer.done()
            or self._advancer.get_loop() is not loop
        ):
            # A fresh asyncio.run() gets a fresh advancer: tasks cannot cross
            # event loops, but a VirtualClock instance may outlive one.  The
            # advancer is never awaited — a crash in it would hang every
            # virtual sleeper silently without the logging sink (FED008).
            from nanofed_tpu_torch.utils.aio import log_task_exception

            self._advancer = loop.create_task(self._advance_loop())
            self._advancer.add_done_callback(log_task_exception)

    async def _advance_loop(self) -> None:
        while self._sleepers:
            for _ in range(self._grace):
                # Let every ready task — and localhost socket I/O — run to
                # quiescence before time moves.
                await asyncio.sleep(0)
            if not self._sleepers:
                return
            wake, _, fut = heapq.heappop(self._sleepers)
            if fut.done():
                # The sleeping task was cancelled: its deadline is dead too —
                # advancing to it would spuriously expire every LIVE deadline
                # computed from time() (round timeouts, retry budgets).
                continue
            self._now = max(self._now, wake)
            fut.set_result(None)
