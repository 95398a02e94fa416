"""Synthetic client swarm load harness (counterpart of ``nanofed_tpu/loadgen/``).

A :class:`SwarmConfig` describes a population of synthetic clients (canned,
pre-encoded delta payloads; Poisson, uniform or burst arrivals on the injectable
``utils.clock.Clock``), and :func:`run_swarm` drives tens of thousands of concurrent
submits against a live ``HTTPServer`` with the production client's retry contract
(exponential backoff with jitter, 429 ``Retry-After`` honoured, idempotency keys).
:func:`~nanofed_tpu_torch.loadgen.harness.run_loadtest` packages server, FedBuff round
engine and swarm, and records p50/p99 submit latency, rounds/s, decode-pool
utilization and 429/retry counts into a ``runs/loadtest_*.json`` artifact;
:func:`~nanofed_tpu_torch.loadgen.harness.run_loadtest_comparison` runs the per-submit
and ingest serving paths on identical traffic.
"""

from nanofed_tpu_torch.loadgen.harness import run_loadtest, run_loadtest_comparison
from nanofed_tpu_torch.loadgen.swarm import (
    SwarmConfig,
    SwarmResult,
    latency_digest,
    make_canned_payloads,
    run_swarm,
)

__all__ = [
    "SwarmConfig",
    "SwarmResult",
    "latency_digest",
    "make_canned_payloads",
    "run_loadtest",
    "run_loadtest_comparison",
    "run_swarm",
]
