"""The port's fault plans and injectors (``nanofed_tpu_torch.faults``) against the JAX
package's (``nanofed_tpu.faults``), on the CPU: ``FaultPlan.generate`` draws the same
JSON from the same arguments, plans load across packages both ways, the same query
sequence against both ``ChaosSchedule``s fires the same events with the same counts,
and ``ChaosClient`` and ``HostChaosInjector`` take the same boundary actions (a crash
exits with the same code, a stall parks the process).  Everything here is exact."""

import asyncio
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import nanofed_tpu.faults as jax_faults
import nanofed_tpu_torch.faults as port_faults
from nanofed_tpu.faults.injector import _flip_bits as jax_flip_bits
from nanofed_tpu.observability.registry import MetricsRegistry as JaxRegistry
from nanofed_tpu.utils.clock import VirtualClock as JaxVirtualClock
from nanofed_tpu_torch.faults.injector import _flip_bits
from nanofed_tpu_torch.observability.registry import MetricsRegistry
from nanofed_tpu_torch.utils.clock import VirtualClock

REPO = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": (jax_faults, JaxRegistry, JaxVirtualClock),
    "port": (port_faults, MetricsRegistry, VirtualClock),
}

CLIENTS_STR = [f"c{i}" for i in range(12)]
CLIENTS_INT = list(range(40))
GENERATE_CASES = [
    (0, CLIENTS_STR, 6, dict(crash_fraction=0.25)),
    (6, [f"c{i}" for i in range(8)], 3,
     dict(crash_fraction=1 / 8, straggler_fraction=1 / 8, straggler_delay_s=3.0)),
    (11, CLIENTS_STR, 5, dict(drop_fraction=0.2, duplicate_fraction=0.25,
                              corrupt_fraction=0.1, server_kill_round=2)),
    (3, CLIENTS_INT, 10, dict(crash_fraction=0.25, straggler_fraction=0.1,
                              drop_fraction=0.05)),
    (7, [], 6, dict(hosts=2, host_crash_count=1)),
    (8, [], 6, dict(hosts=4, host_stall_count=1, dcn_degrade_fraction=0.5,
                    dcn_delay_s=0.25)),
    (9, CLIENTS_STR, 8, dict(crash_fraction=0.1, hosts=3, host_crash_count=1,
                             host_stall_count=1, server_kill_round=5)),
    (12345, CLIENTS_INT, 1, dict(crash_fraction=0.5, duplicate_fraction=0.5)),
]


@pytest.mark.parametrize("seed,clients,rounds,kw", GENERATE_CASES)
def test_generate_is_json_identical_and_cross_loads(seed, clients, rounds, kw):
    want = jax_faults.FaultPlan.generate(seed, clients, rounds, **kw)
    got = port_faults.FaultPlan.generate(seed, clients, rounds, **kw)
    assert got.events, "an empty plan checks nothing"
    assert got.to_json() == want.to_json()
    # Plans saved by either package load in the other, unchanged.
    assert jax_faults.FaultPlan.from_json(got.to_json()) == want
    assert port_faults.FaultPlan.from_json(want.to_json()) == got


def test_saved_plans_load_across_packages(tmp_path):
    plan = port_faults.FaultPlan.generate(4, CLIENTS_STR, 6, crash_fraction=0.25,
                                          hosts=2, host_crash_count=1)
    plan.save(tmp_path / "port.json")
    assert jax_faults.FaultPlan.load(tmp_path / "port.json").to_json() == plan.to_json()
    jax_faults.FaultPlan.from_json(plan.to_json()).save(tmp_path / "jax.json")
    assert port_faults.FaultPlan.load(tmp_path / "jax.json") == plan


@pytest.mark.parametrize("kw", [
    dict(hosts=0, host_crash_count=1),
    dict(hosts=2, host_crash_count=2, host_stall_count=1),
])
def test_generate_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        jax_faults.FaultPlan.generate(0, [], 4, **kw)
    with pytest.raises(ValueError) as got:
        port_faults.FaultPlan.generate(0, [], 4, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [
    dict(kind="meteor", round=0),
    dict(kind="crash", round=-1, client="c0"),
    dict(kind="drop", round=0, client="c0", count=0),
    dict(kind="delay", round=0, client="c0", seconds=-1.0),
    dict(kind="server_kill", round=0, client="c0"),
    dict(kind="host_crash", round=0),
    dict(kind="host_stall", round=0, host=-1),
    dict(kind="host_crash", round=0, host=0, client="c0"),
    dict(kind="crash", round=0, client="c0", host=1),
])
def test_event_validation_matches_jax(fields):
    with pytest.raises(ValueError) as want:
        jax_faults.FaultEvent(**fields)
    with pytest.raises(ValueError) as got:
        port_faults.FaultEvent(**fields)
    assert str(got.value) == str(want.value)


def test_kind_tables_match_jax():
    assert port_faults.FAULT_KINDS == jax_faults.FAULT_KINDS
    assert port_faults.HOST_KINDS == jax_faults.HOST_KINDS
    assert port_faults.plan.WIRE_KINDS == jax_faults.plan.WIRE_KINDS
    assert (port_faults.host_injector.HOST_CRASH_EXIT_CODE
            == jax_faults.host_injector.HOST_CRASH_EXIT_CODE)
    assert issubclass(port_faults.InjectedServerCrash, RuntimeError)


EVERY_KIND = [
    dict(kind="crash", round=1, client="c0"),
    dict(kind="crash", round=0, client=3),
    dict(kind="delay", round=1, client="c1", seconds=0.25),
    dict(kind="skew", round=2, client="c1", seconds=1),
    dict(kind="corrupt", round=1, client="c1"),
    dict(kind="duplicate", round=1, client="c2", count=2),
    dict(kind="drop", round=2, client="c0", count=3),
    dict(kind="ack_drop", round=2, client="c1"),
    dict(kind="delay", round=0, client="c3", seconds=0.5),
    dict(kind="server_kill", round=3),
    dict(kind="host_crash", round=2, host=1),
    dict(kind="host_stall", round=1, host=0),
    dict(kind="dcn_degrade", round=0, host=2, seconds=0.1, count=2),
]

# One scripted sequence of every query a run makes, repeats and misses included.
QUERIES = [
    ("crashed", ("c0", 0)), ("crashed", ("c0", 1)), ("crashed", ("c0", 5)),
    ("crashed", (3, 0)), ("crashed", ("c9", 4)),
    ("client_events", ("c1", 1)), ("client_events", ("c1", 1)),
    ("client_events", ("c1", 2)), ("client_events", ("c2", 1)),
    ("wire_fault", ("c0", "2")), ("wire_fault", ("c0", "bad")), ("wire_fault", ("c0", "2")),
    ("wire_fault", ("c0", "2")), ("wire_fault", ("c1", None)), ("wire_fault", (None, "2")),
    ("wire_fault", ("c3", "0")), ("wire_fault", ("c3", "0")),
    ("take_server_kill", (2,)), ("take_server_kill", (3,)), ("take_server_kill", (3,)),
    ("take_host_fault", (1, 1)), ("take_host_fault", (1, 4)), ("take_host_fault", (1, 4)),
    ("take_host_fault", (0, 3)),
    ("dcn_delay", (2, 0)), ("dcn_delay", (2, 1)), ("dcn_delay", (2, 2)), ("dcn_delay", (2, 1)),
]


def _answer(value):
    if isinstance(value, list):
        return [_answer(v) for v in value]
    if hasattr(value, "to_dict"):
        return value.to_dict()
    return value


def _run_queries(pkg_name):
    faults, registry_cls, _ = PKGS[pkg_name]
    registry = registry_cls()
    plan = faults.FaultPlan(seed=5, events=tuple(faults.FaultEvent(**e) for e in EVERY_KIND))
    schedule = faults.ChaosSchedule(plan, registry=registry)
    answers = [_answer(getattr(schedule, q)(*a)) for q, a in QUERIES]
    text = registry.render_prometheus()
    samples = sorted(line for line in text.splitlines()
                     if line.startswith("nanofed_faults_injected_total{"))
    return answers, schedule.counts(), samples


def test_schedule_answers_the_same_queries_the_same_way():
    want_answers, want_counts, want_samples = _run_queries("jax")
    got_answers, got_counts, got_samples = _run_queries("port")
    assert got_answers == want_answers
    assert got_counts == want_counts
    assert got_samples == want_samples
    assert got_counts == {"crash": 2, "delay": 2, "skew": 1, "corrupt": 1, "duplicate": 1,
                          "drop": 3, "ack_drop": 1, "server_kill": 1, "host_crash": 1,
                          "host_stall": 1, "dcn_degrade": 2}


class StubClient:
    """The HTTPClient surface ChaosClient drives, minus the network: it records the
    round header, the wire body and the resends a real client would produce."""

    def __init__(self, client_id="c0"):
        self.client_id = client_id
        self.wire_filter = None
        self.current_round = None
        self.submits = []
        self.resends = 0

    async def submit_update(self, params, metrics):
        body = bytes(range(256)) * 3
        if self.wire_filter is not None:
            body = self.wire_filter("update", body)
        self.submits.append((params, self.current_round, body))
        return True

    async def resend_last_update(self):
        self.resends += 1
        return True


def _drive_chaos_client(pkg_name):
    faults, registry_cls, clock_cls = PKGS[pkg_name]
    schedule = faults.ChaosSchedule(faults.FaultPlan(events=(
        faults.FaultEvent(kind="crash", round=3, client="c0"),
        faults.FaultEvent(kind="delay", round=1, client="c0", seconds=5.0),
        faults.FaultEvent(kind="skew", round=1, client="c0", seconds=1),
        faults.FaultEvent(kind="corrupt", round=1, client="c0"),
        faults.FaultEvent(kind="duplicate", round=1, client="c0", count=2),
        faults.FaultEvent(kind="corrupt", round=2, client="c0"),
    )), registry=registry_cls())
    clock = clock_cls()
    stub = StubClient()
    chaos = faults.ChaosClient(stub, schedule, clock=clock)
    elapsed = []

    async def main():
        for rnd in (0, 1, 2):
            t0 = clock.time()
            assert await chaos.submit({"w": rnd}, {}, rnd)
            elapsed.append(clock.time() - t0)

    asyncio.run(main())
    alive = [chaos.alive(r) for r in range(6)]
    return stub.submits, stub.resends, stub.wire_filter, elapsed, alive, schedule.counts()


def test_chaos_client_takes_the_same_boundary_actions():
    want = _drive_chaos_client("jax")
    got = _drive_chaos_client("port")
    assert got == want
    submits, resends, wire_filter, elapsed, alive, _ = got
    # The skewed header stays until the client's next fetch (the stub never fetches).
    assert [s[1] for s in submits] == [None, 0, 0]
    assert submits[1][2] == submits[2][2] == _flip_bits(bytes(range(256)) * 3) != submits[0][2]
    assert resends == 2 and wire_filter is None and elapsed == [0.0, 5.0, 0.0]
    assert alive == [True, True, True, False, False, False]
    assert _flip_bits(b"x" * 1000) == jax_flip_bits(b"x" * 1000)


def _drive_host_injector(pkg_name):
    faults, registry_cls, _ = PKGS[pkg_name]
    schedule = faults.ChaosSchedule(faults.FaultPlan(events=(
        faults.FaultEvent(kind="host_crash", round=2, host=1),
        faults.FaultEvent(kind="dcn_degrade", round=0, host=0, seconds=0.3, count=2),
    )), registry=registry_cls())
    ours = faults.HostChaosInjector(schedule, host=0)
    theirs = faults.HostChaosInjector(schedule, host=1)
    ours.maybe_fail(0)  # a no-op for an untargeted host
    out = [ours.take_fault(5), ours.dcn_delay_s(0), ours.dcn_delay_s(1), ours.dcn_delay_s(2),
           theirs.take_fault(1), _answer(theirs.take_fault(3)), theirs.take_fault(3)]
    return out, schedule.counts()


def test_host_injector_consumes_and_delays_as_jax():
    assert _drive_host_injector("port") == _drive_host_injector("jax")


_HOST_FAULT = textwrap.dedent("""
    import sys
    from nanofed_tpu_torch.faults import ChaosSchedule, FaultEvent, FaultPlan, HostChaosInjector
    kind = sys.argv[1]
    plan = FaultPlan(events=(FaultEvent(kind=kind, round=2, host=1),))
    injector = HostChaosInjector(ChaosSchedule(plan), host=1)
    injector.maybe_fail(1)
    print("survived round 1", flush=True)
    try:
        injector.maybe_fail(2)
    finally:
        print("cleanup ran", flush=True)  # os._exit skips it; a stall never gets here
    print("survived round 2", flush=True)
""")


def test_host_crash_exits_with_its_code_and_no_cleanup():
    proc = subprocess.run([sys.executable, "-c", _HOST_FAULT, "host_crash"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == port_faults.host_injector.HOST_CRASH_EXIT_CODE == 31, proc.stderr
    assert proc.stdout.splitlines() == ["survived round 1"]


def test_host_stall_parks_the_process_alive():
    proc = subprocess.Popen([sys.executable, "-c", _HOST_FAULT, "host_stall"], cwd=REPO,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "survived round 1"
        time.sleep(1.0)
        assert proc.poll() is None  # alive and silent
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.stdout.read() == ""
