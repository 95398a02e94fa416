"""Client-side retry policy: exponential backoff + jitter, Retry-After, budgets (a
copy of ``nanofed_tpu/communication/retry.py``).

Production federations are built on flaky clients and servers that shed load; the
client's half of that contract is:

* **exponential backoff with jitter** so ten thousand rejected clients do not
  re-arrive in lockstep (the retry storm that turns one overload into many);
* **honor 429 ``Retry-After``** — the server KNOWS when capacity frees up;
  the client's own schedule is only a floor under that answer;
* **a per-call budget** so retries stop burning time the round no longer has
  (wire it to a share of the round timeout);
* **idempotent submit keys** (``HTTPClient`` attaches one per logical submit)
  so a retry after a lost ACK cannot double-count — the server folds each key
  at most once, whatever the retry policy re-sends.

The policy object is pure and seedable (chaos tests need the backoff schedule
deterministic); the retry LOOP lives in ``HTTPClient`` where the aiohttp
exception taxonomy is.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

__all__ = ["RETRYABLE_STATUSES", "RetryPolicy", "parse_retry_after"]

#: HTTP statuses a retry can fix: admission-control backpressure (429) and the
#: transient-unavailability family.  4xx protocol rejections (stale round, bad
#: payload, bad signature) are FINAL — retrying them verbatim cannot succeed,
#: and the topk8 error-feedback fold must run instead.
RETRYABLE_STATUSES = frozenset({429, 502, 503, 504})


def parse_retry_after(value: str | None) -> float | None:
    """A ``Retry-After`` header as seconds, or None when absent/unparseable.
    Only the delta-seconds form is supported (what this server emits); an
    HTTP-date here would need a wall clock, which the communication stack
    deliberately never reads."""
    if value is None:
        return None
    try:
        seconds = float(value)
    except ValueError:
        return None
    return seconds if seconds >= 0 else None


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule for retryable submit/fetch failures.

    ``max_attempts`` counts every try including the first.  The delay before
    retry ``attempt`` (1-based: after the attempt-1 failure) is::

        raw   = min(max_backoff_s, base_backoff_s * multiplier ** (attempt-1))
        delay = raw * (1 - jitter_fraction * U[0,1))     # decorrelating jitter
        delay = max(delay, retry_after)                  # the server knows best

    ``budget_s`` bounds the TOTAL time a single logical call may spend
    retrying (first attempt included) — size it to the slice of the round
    timeout this client can afford.  ``seed`` makes the jitter stream
    deterministic for chaos tests; leave None in production (each client then
    jitters independently, which is the point of jitter).
    """

    max_attempts: int = 5
    base_backoff_s: float = 0.1
    max_backoff_s: float = 5.0
    multiplier: float = 2.0
    jitter_fraction: float = 0.5
    budget_s: float | None = None
    seed: int | None = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < self.base_backoff_s:
            raise ValueError("need 0 <= base_backoff_s <= max_backoff_s")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter_fraction <= 1.0:
            raise ValueError("jitter_fraction must be in [0, 1]")
        if self.budget_s is not None and self.budget_s <= 0:
            raise ValueError("budget_s must be > 0")

    def rng_for(self, client_id: str) -> random.Random:
        """The jitter stream for one client: seeded -> deterministic per
        (seed, client) so chaos runs replay exactly; unseeded -> OS entropy."""
        if self.seed is None:
            return random.Random()
        return random.Random(f"{self.seed}:{client_id}")

    def backoff_s(
        self,
        attempt: int,
        rng: random.Random,
        retry_after_s: float | None = None,
    ) -> float:
        """Seconds to wait before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        raw = min(
            self.max_backoff_s,
            self.base_backoff_s * self.multiplier ** (attempt - 1),
        )
        delay = raw * (1.0 - self.jitter_fraction * rng.random())
        if retry_after_s is not None:
            delay = max(delay, retry_after_s)
        return delay
