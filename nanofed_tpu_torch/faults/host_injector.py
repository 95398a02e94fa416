"""Host-boundary fault injection: one multi-host WORKER under a plan (counterpart of
``nanofed_tpu/faults/host_injector.py``).

``HostChaosInjector`` is the hosts-axis sibling of ``ChaosClient``: it perturbs one
worker process's round loop where a real failing host would:

* ``host_crash``  — the process exits at once (``os._exit``: no cleanup, no
  interpreter teardown), which to every peer looks like a kernel panic or a
  preemption: sockets drop, heartbeats freeze, the collective in flight never ends.
* ``host_stall``  — the process stops making progress but STAYS ALIVE (it parks in a
  sleep loop, never dispatching, never beating), keeping its CUDA context and memory
  until the supervisor kills it: detectable only by frozen heartbeats and the peers'
  collective watchdog.
* ``dcn_degrade`` — ``seconds`` of injected latency before this host's cross-host
  exchange for ``count`` rounds: a slow but live link that must NOT trip a watchdog
  whose deadline is sized right.

The worker asks it three questions a round; the round program itself is untouched.
Pure stdlib.
"""

from __future__ import annotations

import os
import time as _time

from nanofed_tpu_torch.faults.plan import ChaosSchedule, FaultEvent

__all__ = ["HOST_CRASH_EXIT_CODE", "HostChaosInjector"]

#: The exit code an injected ``host_crash`` dies with, distinctive so a supervisor
#: tells a planned kill from a worker's own bug (both recover the same way).
HOST_CRASH_EXIT_CODE = 31


class HostChaosInjector:
    """Drives one worker process through the host faults of a plan::

        injector = HostChaosInjector(schedule, host=logical_host_id)
        for r in range(rounds):
            injector.maybe_fail(r)                  # may os._exit / park forever
            time.sleep(injector.dcn_delay_s(r))     # degraded cross-host link
            ...watchdogged dispatch...
    """

    def __init__(self, schedule: ChaosSchedule, host: int) -> None:
        self.schedule = schedule
        self.host = int(host)

    def take_fault(self, round_number: int) -> FaultEvent | None:
        """The terminal fault (``host_crash``/``host_stall``) due for this host at
        this round, consumed exactly once; None otherwise."""
        return self.schedule.take_host_fault(self.host, round_number)

    def dcn_delay_s(self, round_number: int) -> float:
        """Injected cross-host latency to apply before this round's dispatch."""
        return self.schedule.dcn_delay(self.host, round_number)

    def maybe_fail(self, round_number: int) -> None:
        """Apply the terminal fault due this round, if any: ``host_crash`` exits the
        process with :data:`HOST_CRASH_EXIT_CODE`; ``host_stall`` parks forever
        (alive, silent).  Returns normally when no fault fires."""
        event = self.take_fault(round_number)
        if event is None:
            return
        if event.kind == "host_crash":
            # No cleanup on purpose: atexit/finally handlers would make the death look
            # tidier than a real host loss.
            os._exit(HOST_CRASH_EXIT_CODE)
        # host_stall: alive but silent, forever (plain time.sleep: a stalled host's
        # time is nobody's schedule).
        while True:  # pragma: no cover - only the supervisor's kill ends this
            _time.sleep(3600)
