"""Host-failure detection for a world of ranks: heartbeats and a collective watchdog
(counterpart of ``nanofed_tpu/parallel/resilience.py``).

A rank that dies mid-round leaves every surviving rank blocked in a collective until
the process group's timeout, and a rank that is alive but frozen is invisible to a
process probe.  This module gives the world the wire tier's fault model without
touching the round programs:

* :class:`HostFailure`: the typed, recoverable error a detected host loss surfaces as
  (a ``RuntimeError``, so ``persistence.is_recoverable`` treats it as any crash);
* :class:`Heartbeat` / :class:`HostMonitor`: liveness through atomically written
  per-host heartbeat files carrying a rising sequence number.  The monitor never
  compares clocks across hosts: it tracks when it last saw each host's sequence
  advance on its own injectable ``utils.clock.Clock``, so a stall is a bounded-age
  verdict, testable on a ``VirtualClock``;
* :class:`CollectiveWatchdog`: a deadline around a cross-host call on the host side.
  :meth:`~CollectiveWatchdog.run` runs the call in a daemon thread and raises
  :class:`HostFailure` when it outlives the deadline (a hung collective cannot be
  cancelled, only orphaned: the process must then exit);
  :meth:`~CollectiveWatchdog.guard` is the same bracket for an awaitable on the
  injectable clock.

The counters are the JAX package's (:func:`resilience_metrics`) in the port's registry;
``telemetry.summarize`` digests ``host_failure`` and ``recovery`` records.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from pathlib import Path
from typing import Any, Callable, NamedTuple

from nanofed_tpu_torch.observability.registry import get_registry
from nanofed_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from nanofed_tpu_torch.utils.logger import Logger

__all__ = [
    "CollectiveWatchdog",
    "Heartbeat",
    "HostFailure",
    "HostMonitor",
    "HostState",
    "no_orphans",
    "resilience_metrics",
]


class HostFailure(RuntimeError):
    """A detected host-level failure: which host, how, when.  ``kind`` is
    ``"host_crash"`` (process gone), ``"host_stall"`` (alive, heartbeat frozen) or
    ``"collective_timeout"`` (a cross-host call outlived the watchdog's deadline; the
    observer cannot tell which peer is at fault)."""

    def __init__(self, kind: str, host: int | None = None, round_number: int | None = None,
                 detail: str = "") -> None:
        self.kind = kind
        self.host = host
        self.round_number = round_number
        self.detail = detail
        where = f"host {host}" if host is not None else "a peer host"
        at = f" in round {round_number}" if round_number is not None else ""
        super().__init__(f"{kind}: {where}{at}" + (f" — {detail}" if detail else ""))


def resilience_metrics(registry: Any | None = None) -> dict[str, Any]:
    """The host fault-tolerance instruments, declared once so the monitor, the
    watchdog and a supervisor share names: ``nanofed_host_failures_total{kind}``,
    ``nanofed_mesh_reshapes_total`` and the ``nanofed_recovery_seconds`` histogram."""
    reg = registry if registry is not None else get_registry()
    return {
        "host_failures": reg.counter(
            "nanofed_host_failures_total",
            "Detected host-level failures, by kind (host_crash/host_stall/"
            "collective_timeout)", labels=("kind",)),
        "mesh_reshapes": reg.counter(
            "nanofed_mesh_reshapes_total",
            "Mesh re-formations over a changed host set (shrink on failure, regrow on "
            "rejoin)"),
        "recovery_seconds": reg.histogram(
            "nanofed_recovery_seconds",
            "Failure detection to first completed post-recovery round (MTTR)"),
    }


class HostState(NamedTuple):
    """One host's liveness as the monitor sees it."""

    host: int
    seq: int
    round_number: int | None
    generation: int | None
    status: str
    age_s: float  # time since the monitor last saw seq advance (its clock)


class Heartbeat:
    """The worker half: ``host_<id>.hb.json``, rewritten by each :meth:`beat` with a
    rising sequence number through a temporary file and a rename (a reader never sees
    a torn write).  The payload carries round, generation and status, so a supervisor
    reads its recovery point from the file its liveness check reads."""

    def __init__(self, directory: str | Path, host: int) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host = int(host)
        self.path = self.dir / f"host_{self.host}.hb.json"
        self._seq = 0

    def beat(self, round_number: int | None = None, generation: int | None = None,
             status: str = "running") -> None:
        self._seq += 1
        payload = {
            "host": self.host, "seq": self._seq, "round": round_number,
            "generation": generation, "status": status,
            "wall_t": _time.time(),  # for a reader, never compared
        }
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(self.path)


class HostMonitor:
    """The supervisor half: reads every heartbeat file and answers which hosts stopped
    making progress, on an injectable clock.  A host is stalled once its sequence has
    not advanced for ``stall_timeout_s`` on the monitor's clock; a host with no file
    yet is missing, not stalled.  Each stall is flagged (and counted under
    ``kind="host_stall"``) once until :meth:`clear`."""

    def __init__(self, directory: str | Path, stall_timeout_s: float,
                 clock: Clock | None = None, registry: Any | None = None) -> None:
        if stall_timeout_s <= 0:
            raise ValueError("stall_timeout_s must be > 0")
        self.dir = Path(directory)
        self.stall_timeout_s = float(stall_timeout_s)
        self._clock = clock or SYSTEM_CLOCK
        self._last_advance: dict[int, tuple[int, float]] = {}  # host -> (seq, t)
        self._flagged: set[int] = set()
        self._m = resilience_metrics(registry)
        self._log = Logger()

    def poll(self) -> dict[int, HostState]:
        """Read every heartbeat file and refresh each host's age; unreadable files are
        skipped (the next beat supersedes them)."""
        now = self._clock.time()
        states: dict[int, HostState] = {}
        for path in sorted(self.dir.glob("host_*.hb.json")):
            try:
                payload = json.loads(path.read_text())
                host, seq = int(payload["host"]), int(payload["seq"])
            except (OSError, ValueError, KeyError):
                continue
            prev = self._last_advance.get(host)
            if prev is None or seq > prev[0]:
                self._last_advance[host] = (seq, now)
            seen_seq, seen_t = self._last_advance[host]
            states[host] = HostState(
                host=host, seq=seen_seq, round_number=payload.get("round"),
                generation=payload.get("generation"),
                status=str(payload.get("status", "?")), age_s=now - seen_t)
        return states

    def stalled(self) -> list[HostFailure]:
        """Hosts whose heartbeat has been frozen past the stall timeout, newly flagged
        ones only."""
        failures = []
        for host, state in self.poll().items():
            if state.age_s <= self.stall_timeout_s or host in self._flagged:
                continue
            self._flagged.add(host)
            self._m["host_failures"].inc(kind="host_stall")
            self._log.warning("host %d stalled: heartbeat frozen at seq %d for %.1fs "
                              "(timeout %.1fs)", host, state.seq, state.age_s,
                              self.stall_timeout_s)
            failures.append(HostFailure(
                "host_stall", host=host, round_number=state.round_number,
                detail=f"heartbeat frozen for {state.age_s:.1f}s"))
        return failures

    def clear(self, host: int) -> None:
        """Forget a host's verdict and age (it was reaped, or is rejoining)."""
        self._flagged.discard(host)
        self._last_advance.pop(host, None)


class CollectiveWatchdog:
    """A deadline around a cross-host call, so a dead or stalled peer surfaces as
    :class:`HostFailure` within ``deadline_s`` instead of a hang until the process
    group's timeout.  ``dcn_grace_s`` widens one call's deadline where latency was
    injected on purpose."""

    def __init__(self, deadline_s: float, clock: Clock | None = None,
                 host: int | None = None, registry: Any | None = None) -> None:
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.deadline_s = float(deadline_s)
        self.host = host
        self._clock = clock or SYSTEM_CLOCK
        self._m = resilience_metrics(registry)
        self._log = Logger()

    def _timeout(self, round_number: int | None, waited: float) -> HostFailure:
        self._m["host_failures"].inc(kind="collective_timeout")
        self._log.warning("collective watchdog tripped after %.2fs (deadline %.2fs, "
                          "round %s): a peer host is dead or stalled", waited,
                          self.deadline_s, round_number)
        return HostFailure(
            "collective_timeout", host=None, round_number=round_number,
            detail=f"cross-host dispatch exceeded {self.deadline_s:.2f}s deadline; a "
                   "peer is dead or stalled")

    def run(self, fn: Callable[..., Any], *args: Any, round_number: int | None = None,
            dcn_grace_s: float = 0.0, tick: Callable[[], None] | None = None,
            tick_interval_s: float = 0.5, **kwargs: Any) -> Any:
        """``fn(*args, **kwargs)`` with a deadline: its exceptions propagate unchanged,
        the deadline becomes :class:`HostFailure`.  ``tick`` (the caller's heartbeat)
        runs every ``tick_interval_s`` while it waits: a rank blocked on its peers is
        alive.  The call runs on a daemon thread, so a thread wedged in a collective
        never holds up the process's exit."""
        deadline = self.deadline_s + max(0.0, dcn_grace_s)
        outcome: dict[str, Any] = {}
        done = threading.Event()

        def runner() -> None:
            try:
                outcome["value"] = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — re-raised as it was
                outcome["error"] = exc
            finally:
                done.set()

        threading.Thread(target=runner, daemon=True, name="nanofed-watchdog").start()
        start = _time.monotonic()
        while True:
            # A finished call wins over an expired deadline.
            if done.is_set():
                break
            remaining = deadline - (_time.monotonic() - start)
            if remaining <= 0:
                raise self._timeout(round_number, deadline)
            wait = min(remaining, tick_interval_s) if tick is not None else remaining
            if done.wait(timeout=wait):
                break
            if tick is not None:
                tick()
        if "error" in outcome:
            raise outcome["error"]
        return outcome["value"]

    async def guard(self, awaitable: Any, round_number: int | None = None,
                    dcn_grace_s: float = 0.0) -> Any:
        """:meth:`run`'s deadline for an awaitable, on the injectable clock."""
        import asyncio

        deadline = self.deadline_s + max(0.0, dcn_grace_s)
        task = asyncio.ensure_future(awaitable)
        timer = asyncio.ensure_future(self._clock.sleep(deadline))
        done, _ = await asyncio.wait({task, timer}, return_when=asyncio.FIRST_COMPLETED)
        if task in done:
            timer.cancel()
            return task.result()
        task.cancel()
        raise self._timeout(round_number, deadline)


def no_orphans(pids: list[int]) -> list[int]:
    """The subset of ``pids`` still alive (a recovery that leaks a worker holding the
    rendezvous poisons every later run on the machine)."""
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)  # signal 0: an existence probe
        except ProcessLookupError:
            continue
        except PermissionError:
            pass  # it exists, just not ours: still an orphan
        alive.append(pid)
    return alive
