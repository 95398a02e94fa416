"""Deterministic, seeded fault plans for the federation's failure modes (counterpart of
``nanofed_tpu/faults/plan.py``, pure stdlib in both packages).

A :class:`FaultPlan` is a frozen, JSON-serializable list of fault events, either
hand-written or drawn from a seed (:meth:`FaultPlan.generate`), and a
:class:`ChaosSchedule` is its consumable runtime view: injection sites ask it "does a
fault fire HERE, for THIS client, in THIS round?" and every firing is counted in the
metrics registry (``nanofed_faults_injected_total{kind=...}``), so a chaos run's
telemetry shows which failures it survived.

:meth:`FaultPlan.generate` draws from Python's ``random.Random(seed)`` in the JAX
package's order, so both packages draw the same plan from the same arguments, and a
plan saved by either loads in the other.

Fault kinds and their injection sites:

==============  ============================================================
kind            where it fires
==============  ============================================================
``crash``       scripted client loop / simulator cohort: the client stops
                participating from ``round`` on (``ChaosSchedule.crashed``)
``delay``       client boundary: ``seconds`` of extra latency before the
                round's submit (a straggler)
``skew``        client boundary: the submit's round header is shifted back by
                ``int(seconds)`` rounds (the server's stale-round 400 path)
``corrupt``     client wire boundary: the submit body is bit-flipped in
                flight (``HTTPClient(wire_filter=...)``)
``duplicate``   client wire boundary: the last update is re-POSTed ``count``
                extra times with the SAME idempotency key (a retry storm)
``drop``        server wire boundary (``HTTPServer(chaos=...)``): the
                connection is severed BEFORE the handler runs
``ack_drop``    server wire boundary: the handler runs (the update IS
                buffered) and the connection is severed before the response
``server_kill`` the ``NetworkCoordinator`` round loop: raises
                :class:`InjectedServerCrash` after the round's publish;
                recovery is the ``persistence.state_store`` resume path
``host_crash``  host boundary (``faults.host_injector.HostChaosInjector``
                inside a multi-host worker): the worker PROCESS exits
``host_stall``  host boundary: the worker stops making progress but stays
                alive (heartbeats freeze, collectives never complete)
``dcn_degrade`` host boundary: ``seconds`` of injected latency on this
                host's cross-host exchanges for ``count`` rounds
==============  ============================================================
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Iterable

__all__ = [
    "FAULT_KINDS",
    "HOST_KINDS",
    "ChaosSchedule",
    "FaultEvent",
    "FaultPlan",
    "InjectedServerCrash",
]

FAULT_KINDS = (
    "crash", "delay", "skew", "corrupt", "duplicate", "drop", "ack_drop",
    "server_kill", "host_crash", "host_stall", "dcn_degrade",
)

#: Kinds the server-side wire middleware handles (everything else is a client-
#: boundary, host-boundary, or round-loop fault).
WIRE_KINDS = ("drop", "ack_drop", "delay")

#: Kinds targeting a whole HOST (a multi-host worker process) rather than one
#: client or the server: consumed by ``faults.host_injector`` inside the
#: worker, detected by ``parallel.resilience`` on the surviving peers.
HOST_KINDS = ("host_crash", "host_stall", "dcn_degrade")


class InjectedServerCrash(RuntimeError):
    """A ``server_kill`` fault firing in the round loop.

    Subclasses ``RuntimeError`` so ``persistence.state_store.is_recoverable``
    treats it exactly like a real crash: ``run_fault_tolerant`` (or the chaos
    harness) rebuilds the server + coordinator from the state store and the
    run resumes at the checkpointed round.
    """


@dataclass(frozen=True)
class FaultEvent:
    """One fault: ``kind`` fires against ``client`` in ``round``.

    ``seconds`` parameterizes ``delay`` (latency), ``skew`` (rounds of header
    skew, as an int), and ``dcn_degrade`` (injected cross-host latency);
    ``count`` is how many times a one-shot wire fault fires
    (``drop``/``ack_drop``), how many extra duplicates are sent, or how many
    rounds a ``dcn_degrade`` persists.  ``client`` is None for ``server_kill``
    and the host kinds; the host kinds instead carry ``host`` — the hosts-axis
    row (the logical host id a multi-host worker is launched with) the fault targets.  Simulator
    clients are ints, network clients strings — both are stored as given and
    compared as given.
    """

    kind: str
    round: int
    client: str | int | None = None
    seconds: float = 0.0
    count: int = 1
    host: int | None = None

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (choose from {FAULT_KINDS})")
        if self.round < 0:
            raise ValueError("round must be >= 0")
        if self.count < 1:
            raise ValueError("count must be >= 1")
        if self.seconds < 0:
            raise ValueError("seconds must be >= 0")
        if self.kind == "server_kill" and self.client is not None:
            raise ValueError("server_kill is not a per-client fault")
        if self.kind in HOST_KINDS:
            if self.host is None:
                raise ValueError(f"{self.kind} needs a target host")
            if self.host < 0:
                raise ValueError("host must be >= 0")
            if self.client is not None:
                raise ValueError(f"{self.kind} is not a per-client fault")
        elif self.host is not None:
            raise ValueError(f"{self.kind} does not take a host")

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"kind": self.kind, "round": self.round}
        if self.client is not None:
            d["client"] = self.client
        if self.seconds:
            d["seconds"] = self.seconds
        if self.count != 1:
            d["count"] = self.count
        if self.host is not None:
            d["host"] = self.host
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultEvent":
        return cls(
            kind=str(d["kind"]),
            round=int(d["round"]),
            client=d.get("client"),
            seconds=float(d.get("seconds", 0.0)),
            count=int(d.get("count", 1)),
            host=None if d.get("host") is None else int(d["host"]),
        )


@dataclass(frozen=True)
class FaultPlan:
    """A frozen, seeded, JSON-serializable fault schedule.

    The ``seed`` is carried even for hand-written plans so the run artifact
    records which schedule produced it; :meth:`generate` draws a plan FROM the
    seed, making "round completes despite f crashes" a reproducible claim
    rather than a lucky run.
    """

    seed: int = 0
    events: tuple[FaultEvent, ...] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))

    @classmethod
    def generate(
        cls,
        seed: int,
        clients: Iterable[str | int],
        num_rounds: int,
        *,
        crash_fraction: float = 0.0,
        straggler_fraction: float = 0.0,
        straggler_delay_s: float = 1.0,
        drop_fraction: float = 0.0,
        duplicate_fraction: float = 0.0,
        corrupt_fraction: float = 0.0,
        server_kill_round: int | None = None,
        hosts: int = 0,
        host_crash_count: int = 0,
        host_stall_count: int = 0,
        dcn_degrade_fraction: float = 0.0,
        dcn_delay_s: float = 0.5,
    ) -> "FaultPlan":
        """Draw a plan from ``seed``: each ``*_fraction`` of the client
        population is assigned that fault at a seeded round.  Crashes land in
        the first half of the run (so the survival claim covers most rounds);
        wire faults are spread uniformly.  With ``hosts`` > 0 the host-boundary
        kinds draw too: ``host_crash_count``/``host_stall_count`` hosts (never
        the same host twice — a run must keep a quorum to recover INTO) fail at
        seeded mid-run rounds, and ``dcn_degrade_fraction`` of the hosts get
        ``dcn_delay_s`` of injected cross-host latency at a seeded round.
        Deterministic: the same arguments always yield the same plan."""
        rng = random.Random(seed)
        pool = list(clients)
        events: list[FaultEvent] = []

        def pick(fraction: float) -> list[str | int]:
            k = round(fraction * len(pool))
            return rng.sample(pool, k) if k else []

        for cid in pick(crash_fraction):
            events.append(FaultEvent(
                kind="crash", round=rng.randrange(max(1, num_rounds // 2)),
                client=cid,
            ))
        for cid in pick(straggler_fraction):
            events.append(FaultEvent(
                kind="delay", round=rng.randrange(num_rounds), client=cid,
                seconds=straggler_delay_s,
            ))
        for kind, fraction in (("drop", drop_fraction),
                               ("duplicate", duplicate_fraction),
                               ("corrupt", corrupt_fraction)):
            for cid in pick(fraction):
                events.append(FaultEvent(
                    kind=kind, round=rng.randrange(num_rounds), client=cid,
                ))
        if server_kill_round is not None:
            events.append(FaultEvent(kind="server_kill", round=server_kill_round))
        if host_crash_count or host_stall_count or dcn_degrade_fraction:
            if hosts < 1:
                raise ValueError("host faults need hosts >= 1 in generate()")
            host_pool = list(range(hosts))
            n_fail = host_crash_count + host_stall_count
            if n_fail > len(host_pool):
                raise ValueError(
                    f"cannot fail {n_fail} of {hosts} hosts (each host fails "
                    "at most once per plan)"
                )
            failed = rng.sample(host_pool, n_fail)
            for i, h in enumerate(failed):
                kind = "host_crash" if i < host_crash_count else "host_stall"
                # Mid-run like client crashes: rounds [1, num_rounds/2] so the
                # recovered mesh still has most of the run left to prove itself.
                events.append(FaultEvent(
                    kind=kind, round=1 + rng.randrange(max(1, num_rounds // 2)),
                    host=h,
                ))
            n_dcn = round(dcn_degrade_fraction * hosts)
            for h in rng.sample(host_pool, n_dcn) if n_dcn else []:
                events.append(FaultEvent(
                    kind="dcn_degrade", round=rng.randrange(num_rounds),
                    host=h, seconds=dcn_delay_s,
                ))
        events.sort(key=lambda e: (e.round, e.kind, str(e.client),
                                   -1 if e.host is None else e.host))
        return cls(seed=seed, events=tuple(events))

    # -- serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "events": [e.to_dict() for e in self.events]},
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(
            seed=int(d.get("seed", 0)),
            events=tuple(FaultEvent.from_dict(e) for e in d.get("events", [])),
        )

    @classmethod
    def load(cls, path: str | Path) -> "FaultPlan":
        return cls.from_json(Path(path).read_text())

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    def with_events(self, *events: FaultEvent) -> "FaultPlan":
        return replace(self, events=(*self.events, *events))


class ChaosSchedule:
    """The consumable runtime view of a :class:`FaultPlan`.

    Injection sites query it; one-shot events (``drop``/``ack_drop``/
    ``duplicate``/``server_kill``) are CONSUMED as they fire, so a retried
    request meets the fault ``count`` times and then passes — which is exactly
    the semantics a retry policy must be proven against.  Every firing
    increments ``nanofed_faults_injected_total{kind=...}`` in the given
    registry (default: the process-wide one), so ``/metrics`` and
    ``telemetry.jsonl`` show which faults a run actually absorbed.

    Single-event-loop use only (like everything in ``communication``): no
    internal locking.
    """

    def __init__(self, plan: FaultPlan, registry: Any | None = None) -> None:
        from nanofed_tpu_torch.observability.registry import get_registry

        self.plan = plan
        self._fired: dict[int, int] = {}  # event index -> times fired
        self._m_faults = (registry or get_registry()).counter(
            "nanofed_faults_injected_total",
            "Chaos-schedule faults actually fired, by kind",
            labels=("kind",),
        )

    def _take(self, index: int, event: FaultEvent) -> bool:
        """Consume one firing of a counted event; False once exhausted."""
        fired = self._fired.get(index, 0)
        if fired >= event.count:
            return False
        self._fired[index] = fired + 1
        self._m_faults.inc(kind=event.kind)
        return True

    # -- client-boundary queries -----------------------------------------

    def crashed(self, client: str | int, round_number: int) -> bool:
        """True when the plan crashed ``client`` at or before this round
        (crashes are permanent: a crashed client never reports again)."""
        for i, e in enumerate(self.plan.events):
            if e.kind == "crash" and e.client == client and e.round <= round_number:
                if self._fired.get(i, 0) == 0:
                    self._fired[i] = 1
                    self._m_faults.inc(kind="crash")
                return True
        return False

    def client_events(self, client: str | int, round_number: int) -> list[FaultEvent]:
        """The client-boundary faults (delay/skew/corrupt/duplicate) firing for
        this client's submit this round.  Each event applies to ONE logical
        submit and is consumed on return (a ``duplicate`` event's ``count`` is
        how many duplicates that submit sends, not how many submits it
        haunts)."""
        out = []
        for i, e in enumerate(self.plan.events):
            if e.client != client or e.round != round_number:
                continue
            if e.kind not in ("delay", "skew", "corrupt", "duplicate"):
                continue
            if self._fired.get(i, 0) == 0:
                self._fired[i] = 1
                self._m_faults.inc(kind=e.kind)
                out.append(e)
        return out

    # -- server-boundary queries -----------------------------------------

    def wire_fault(
        self, client: str | None, round_header: str | None
    ) -> FaultEvent | None:
        """The wire fault (drop/ack_drop/delay-at-server) to apply to THIS
        request, or None.  One-shot kinds are consumed per firing: a dropped
        request's retry gets through once ``count`` attempts have been
        severed."""
        if client is None:
            return None
        try:
            rnd = int(round_header) if round_header is not None else None
        except ValueError:
            rnd = None
        for i, e in enumerate(self.plan.events):
            if e.kind not in WIRE_KINDS or e.client != client:
                continue
            if rnd is not None and e.round != rnd:
                continue
            if self._take(i, e):
                return e
        return None

    # -- round-loop queries ----------------------------------------------

    def take_server_kill(self, round_number: int) -> bool:
        """True exactly once when the plan kills the server in this round."""
        for i, e in enumerate(self.plan.events):
            if e.kind == "server_kill" and e.round == round_number:
                if self._take(i, e):
                    return True
        return False

    # -- host-boundary queries (faults.host_injector) ---------------------

    def take_host_fault(self, host: int, round_number: int) -> FaultEvent | None:
        """The terminal host fault (``host_crash``/``host_stall``) firing
        against ``host`` at or before this round, consumed exactly once — a
        worker that survived its scheduled round (e.g. it was down for other
        reasons) still dies at the next boundary check, matching the permanent
        semantics of client ``crash``."""
        for i, e in enumerate(self.plan.events):
            if e.kind not in ("host_crash", "host_stall"):
                continue
            if e.host != host or e.round > round_number:
                continue
            if self._take(i, e):
                return e
        return None

    def dcn_delay(self, host: int, round_number: int) -> float:
        """Injected cross-host (DCN) latency for ``host`` this round: the sum
        of the ``dcn_degrade`` events covering it.  An event with ``count`` N
        degrades N consecutive dispatches starting at its round, each firing
        consumed (and counted) separately."""
        total = 0.0
        for i, e in enumerate(self.plan.events):
            if e.kind != "dcn_degrade" or e.host != host:
                continue
            if not (e.round <= round_number < e.round + e.count):
                continue
            if self._take(i, e):
                total += e.seconds
        return total

    def counts(self) -> dict[str, int]:
        """Fired-fault totals by kind (for run records / assertions)."""
        out: dict[str, int] = {}
        for i, n in self._fired.items():
            kind = self.plan.events[i].kind
            out[kind] = out.get(kind, 0) + n
        return out
