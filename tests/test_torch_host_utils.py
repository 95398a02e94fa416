"""The port's host utilities (``utils/clock.py``, ``utils/aio.py``) against the JAX
package's copies, and the network coordinator's round deadline on an injected
``VirtualClock``.

Each clock schedule runs on both packages' ``VirtualClock`` and must give the same
virtual times and wake order.
"""

import asyncio
import logging
import time

import pytest

from nanofed_tpu.utils import aio as jax_aio
from nanofed_tpu.utils import clock as jax_clock
from nanofed_tpu_torch.utils import aio, clock


async def _deadline_order(c):
    order = []

    async def sleeper(name, seconds):
        await c.sleep(seconds)
        order.append((name, c.time()))

    # Started slow-first, so the wake order must come from the deadlines.
    await asyncio.gather(sleeper("slow", 3.0), sleeper("fast", 1.0), sleeper("mid", 2.0))
    return order


async def _poll_loop(c):
    deadline, polls = c.time() + 10.0, 0
    while c.time() < deadline:
        polls += 1
        await c.sleep(0.5)
    return polls, c.time()


async def _cancelled_sleeper(c):
    long_wait = asyncio.create_task(c.sleep(300.0))
    await asyncio.sleep(0)
    long_wait.cancel()
    await asyncio.gather(long_wait, return_exceptions=True)
    await c.sleep(1.0)
    return c.time()


async def _long_timeout(c):
    await c.sleep(500.0)
    t = c.time()
    await c.sleep(0)  # a zero sleep is a yield: time does not move
    return t, c.time()


SCHEDULES = {"deadline_order": _deadline_order, "poll_loop": _poll_loop,
             "cancelled_sleeper": _cancelled_sleeper, "long_timeout": _long_timeout}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_virtual_clock_schedules_match_jax(schedule):
    """The same schedule on both packages' virtual clocks: the same virtual times and
    wake order, in well under a real second per 500 virtual seconds."""
    t0 = time.perf_counter()
    got = asyncio.run(SCHEDULES[schedule](clock.VirtualClock(start=2.0)))
    want = asyncio.run(SCHEDULES[schedule](jax_clock.VirtualClock(start=2.0)))
    assert got == want
    assert time.perf_counter() - t0 < 10.0


def test_virtual_clock_outlives_an_event_loop_and_validates_like_jax():
    for module in (clock, jax_clock):
        c = module.VirtualClock()

        async def main():
            await c.sleep(1.0)
            return c.time()

        assert asyncio.run(main()) == 1.0
        assert asyncio.run(main()) == 2.0  # a fresh loop gets a fresh advancer
        c.advance(2.5)
        assert c.time() == 4.5
        with pytest.raises(ValueError):
            c.advance(-1.0)
        with pytest.raises(ValueError):
            module.VirtualClock(grace_yields=0)
    assert isinstance(clock.SYSTEM_CLOCK, clock.Clock)


@pytest.mark.parametrize("module", [aio, jax_aio], ids=["port", "jax"])
def test_spawned_task_crash_is_logged_not_lost(module, caplog):
    async def crash():
        raise RuntimeError("boom")

    async def ok():
        return 7

    async def main():
        bad = module.spawn_logged(crash(), name="crasher")
        good = module.spawn_logged(ok(), name="fine")
        await asyncio.gather(bad, good, return_exceptions=True)
        return good.result()

    with caplog.at_level(logging.ERROR, logger="nanofed.aio"):
        assert asyncio.run(main()) == 7
    crashed = [r for r in caplog.records if "crasher" in r.getMessage()]
    assert len(crashed) == 1 and "boom" in crashed[0].getMessage()
    assert not [r for r in caplog.records if "fine" in r.getMessage()]


def test_round_deadline_runs_on_an_injected_virtual_clock():
    """A no-dropout secure round with one enrolled client that never submits, under a
    300-second round timeout on a ``VirtualClock``: the round FAILS once 300 virtual
    seconds have passed, in a few real seconds, and the params are untouched."""
    pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")
    pytest.importorskip("cryptography", reason="secure aggregation needs the crypto dependency")
    import torch

    from nanofed_tpu_torch import communication as comm
    from nanofed_tpu_torch.communication.transport import free_port
    from nanofed_tpu_torch.core.exceptions import NanoFedError
    from nanofed_tpu_torch.security import secure_agg as sa

    init = {"w": torch.arange(6, dtype=torch.float32)}
    cfg = sa.SecureAggregationConfig(min_clients=3)
    virtual = clock.VirtualClock()

    async def client(url, cid, submit):
        key = sa.ClientKeyPair.generate()
        async with comm.HTTPClient(url, cid, timeout_s=30) as c:
            assert await c.register_secagg(key.public_bytes(), 1.0)
            if not submit:
                return
            roster = await c.fetch_secagg_roster(timeout_s=30)
            for _ in range(500):
                try:
                    params, rnd, _ = await c.fetch_global_model(like=init)
                    break
                except NanoFedError:  # round 0 is published concurrently with start-up
                    await asyncio.sleep(0.01)
            masked = sa.mask_update(params, roster.index_of(cid), key, roster.ordered_keys(),
                                    rnd, cfg, weight=roster.weights[cid], device="cpu")
            assert await c.submit_masked_update(masked, {"num_samples": 1.0})

    async def main():
        port = free_port()
        server = comm.HTTPServer(port=port)
        await server.start()
        try:
            coordinator = comm.NetworkCoordinator(
                server, init,
                comm.NetworkRoundConfig(min_clients=3, round_timeout_s=300.0,
                                        poll_interval_s=0.1),
                secure=cfg, clock=virtual, device="cpu")
            url = f"http://127.0.0.1:{port}"
            await asyncio.wait_for(asyncio.gather(
                coordinator.run(), client(url, "c0", True), client(url, "c1", True),
                client(url, "c2", False)), 60)
            return coordinator
        finally:
            await server.stop()

    t0 = time.perf_counter()
    coordinator = asyncio.run(main())
    assert coordinator.history[0]["status"] == "FAILED"
    assert virtual.time() >= 300.0
    assert time.perf_counter() - t0 < 30.0
    assert torch.equal(coordinator.params["w"], init["w"])
