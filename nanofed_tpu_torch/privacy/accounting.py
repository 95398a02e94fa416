"""Privacy budget accounting (counterpart of ``nanofed_tpu/privacy/accounting.py``,
kept as a copy: it is host-side NumPy, so its values equal the JAX package's exactly).

Parity with the reference's accountant subsystem (``nanofed/privacy/accountant/``):

* ``PrivacySpent`` — frozen (ε, δ) record with validation (``accountant/base.py:8-20``).
* ``GaussianAccountant`` — per-event ε via the classic Gaussian-mechanism bound with
  sampling amplification, composed linearly (``accountant/gaussian.py:14-48``).
* ``RDPAccountant`` — Rényi DP accounting (Mironov 2017): per-event RDP over a grid of
  orders, additive composition, optimal RDP→(ε, δ) conversion
  (``accountant/rdp.py:41-115``).

``sampling_rate`` is the true subsampling probability q (for the round's central DP,
cohort / clients), supplied by the caller.  Accounting sits on the host because it is
O(events) scalar math that must persist across rounds; the round step only applies
the noise, and the Coordinator records one event per round.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np

DEFAULT_RDP_ORDERS: tuple[float, ...] = tuple(
    [1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 3.0, 3.5, 4.0, 4.5]
    + list(range(5, 64))
    + [128.0, 256.0, 512.0]
)


@dataclass(frozen=True, slots=True)
class PrivacySpent:
    """Cumulative privacy expenditure (parity: ``PrivacySpent``,
    ``nanofed/privacy/accountant/base.py:8-20``)."""

    epsilon_spent: float
    delta_spent: float

    def __post_init__(self) -> None:
        if self.epsilon_spent < 0:
            raise ValueError(f"epsilon_spent must be >= 0, got {self.epsilon_spent}")
        if not (0 <= self.delta_spent <= 1):
            raise ValueError(f"delta_spent must be in [0, 1], got {self.delta_spent}")

    def to_dict(self) -> dict[str, float]:
        return {"epsilon_spent": self.epsilon_spent, "delta_spent": self.delta_spent}

    @classmethod
    def from_dict(cls, d: dict[str, float]) -> "PrivacySpent":
        return cls(epsilon_spent=d["epsilon_spent"], delta_spent=d["delta_spent"])


class PrivacyAccountant(Protocol):
    """Structural type every accountant satisfies (parity: ``PrivacyAccountant`` Protocol,
    ``accountant/base.py:23-46``).

    ``state_dict``/``load_state_dict`` are part of the contract: the coordinator
    persists accounting history into round checkpoints so a resumed DP run reports the
    CUMULATIVE ε of the released model, not just the post-crash tail.
    """

    def add_noise_event(self, noise_multiplier: float, sampling_rate: float) -> None: ...

    def get_privacy_spent(self, delta: float) -> PrivacySpent: ...

    def state_dict(self) -> dict: ...

    def load_state_dict(self, state: dict) -> None: ...


class BasePrivacyAccountant:
    """Shared event log + budget validation (parity: ``BasePrivacyAccountant``,
    ``accountant/base.py:49-64``)."""

    def __init__(self) -> None:
        # (noise_multiplier, sampling_rate, count) — runs of identical events are collapsed
        # so 10k-step runs stay O(distinct configs), not O(steps).
        self._events: list[list[float]] = []

    @property
    def num_events(self) -> int:
        return int(sum(e[2] for e in self._events))

    def add_noise_event(
        self, noise_multiplier: float, sampling_rate: float, count: int = 1
    ) -> None:
        """Record ``count`` applications of the (σ, q) subsampled mechanism."""
        if noise_multiplier <= 0:
            raise ValueError(f"noise_multiplier must be > 0, got {noise_multiplier}")
        if not (0 < sampling_rate <= 1):
            raise ValueError(f"sampling_rate must be in (0, 1], got {sampling_rate}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if self._events and self._events[-1][:2] == [noise_multiplier, sampling_rate]:
            self._events[-1][2] += count
        else:
            self._events.append([noise_multiplier, sampling_rate, float(count)])

    def get_privacy_spent(self, delta: float) -> PrivacySpent:  # pragma: no cover - abstract
        raise NotImplementedError

    def validate_budget(self, epsilon: float, delta: float) -> bool:
        """True iff spend so far fits inside (ε, δ) (parity: ``accountant/base.py:49-53``)."""
        spent = self.get_privacy_spent(delta)
        return spent.epsilon_spent <= epsilon and spent.delta_spent <= delta

    def reset(self) -> None:
        self._events.clear()

    def state_dict(self) -> dict:
        """Serializable state for checkpoint/resume (new capability: the reference's
        accountants lose their history on restart)."""
        return {"events": [list(e) for e in self._events]}

    def load_state_dict(self, state: dict) -> None:
        self._events = [list(e) for e in state["events"]]


class GaussianAccountant(BasePrivacyAccountant):
    """Basic composition of per-event ε from the classic Gaussian-mechanism bound.

    Per event: the unamplified Gaussian cost ε₀ = √(2·ln(1.25·k/δ)) / σ (from
    σ = √(2 ln 1.25/δ)·Δ/ε, Dwork & Roth) amplified by subsampling via the EXACT bound
    ε_i = ln(1 + q·(e^{ε₀} − 1)) — valid for every q in (0, 1], reducing to ε₀ at q=1
    and to q·ε₀ only in the small-ε₀ limit.  (The naive linear form q·ε₀ over-claims
    amplification whenever ε₀ is not small; the reference uses it unconditionally,
    ``accountant/gaussian.py:33-48``.)  Each of the k events is evaluated at δ/k so that
    basic composition of k (ε_i, q·δ/k ≤ δ/k) guarantees yields a true (Σ ε_i, δ)
    guarantee at the queried δ.  (Composing at fixed per-event δ and still reporting δ —
    what the reference does — is anti-conservative in δ.)  Loose but simple;
    ``RDPAccountant`` is the tight one.
    """

    def get_privacy_spent(self, delta: float) -> PrivacySpent:
        if not (0 < delta < 1):
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        k = self.num_events
        if k == 0:
            return PrivacySpent(epsilon_spent=0.0, delta_spent=0.0)
        c = math.sqrt(2.0 * math.log(1.25 * k / delta))

        def amplified(eps0: float, q: float) -> float:
            if q >= 1.0:
                return eps0
            if eps0 > 700.0:  # expm1 overflows; use the exact large-eps0 asymptote
                return eps0 + math.log(q)
            return math.log1p(q * math.expm1(eps0))

        eps = sum(count * amplified(c / sigma, q) for sigma, q, count in self._events)
        return PrivacySpent(epsilon_spent=float(eps), delta_spent=delta)


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def sampled_gaussian_rdp(sigma: float, q: float, orders: np.ndarray) -> np.ndarray:
    """Per-order RDP of ONE Poisson-subsampled Gaussian release, exactly.

    q = 1 is the plain Gaussian mechanism: RDP(α) = α/(2σ²) at every order.  For q < 1
    the exact closed form (Mironov, Talwar & Zhang 2019, "Rényi Differential Privacy of
    the Sampled Gaussian Mechanism", Table 1 / §3.3 — the computation TF-privacy and
    Opacus ship) exists at integer α ≥ 2:

        RDP(α) = log( Σ_{k=0..α} C(α,k)·(1−q)^{α−k}·q^k·e^{(k²−k)/(2σ²)} ) / (α−1)

    Non-integer orders (and α < 2) get +inf for q < 1, which simply excludes them from
    the min in the (ε, δ) conversion — evaluating a subset of orders is always a valid
    bound.  The widely-used q²α/(2σ²) approximation is NOT applied anywhere: it is only
    valid for σ ≳ 1 and α ≪ σ²·ln(1/q), and outside that regime it under-reports spend
    (e.g. at σ=0.44, q=0.1 it claims ~50× less ε than this exact form).
    """
    if q >= 1.0:
        return orders / (2.0 * sigma * sigma)
    out = np.full(orders.shape, np.inf)
    lq, l1q = math.log(q), math.log1p(-q)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    for i, alpha in enumerate(orders):
        a = int(alpha)
        if alpha != a or a < 2:
            continue
        terms = [
            _log_binom(a, k) + k * lq + (a - k) * l1q + (k * k - k) * inv2s2
            for k in range(a + 1)
        ]
        m = max(terms)
        log_a = m + math.log(sum(math.exp(t - m) for t in terms))
        out[i] = max(0.0, log_a) / (alpha - 1.0)
    return out


class RDPAccountant(BasePrivacyAccountant):
    """Rényi-DP accounting for the subsampled Gaussian mechanism.

    Per event: the EXACT sampled-Gaussian RDP (``sampled_gaussian_rdp``) — never the
    q²α/(2σ²) small-q approximation, which the reference uses unconditionally
    (``accountant/rdp.py:41-62``) and which over-claims amplification outside its
    σ ≳ 1 validity regime.  Composition is additive in RDP; conversion uses the
    standard bound ε(δ) = min_α [ RDP(α) + ln(1/δ)/(α-1) ] (``accountant/rdp.py:90-115``).

    Client/example subsampling here is Poisson-style; the coordinator's fixed-size
    uniform cohort is accounted at q = cohort/N, the standard approximation
    (McMahan et al. 2018).
    """

    def __init__(self, orders: Sequence[float] = DEFAULT_RDP_ORDERS) -> None:
        super().__init__()
        if any(a <= 1 for a in orders):
            raise ValueError("all RDP orders must be > 1")
        self._orders = np.asarray(sorted(orders), dtype=np.float64)

    @property
    def orders(self) -> np.ndarray:
        return self._orders.copy()

    def total_rdp(self) -> np.ndarray:
        """Composed RDP(α) across all recorded events, one value per order."""
        rdp = np.zeros_like(self._orders)
        for sigma, q, count in self._events:
            rdp += count * sampled_gaussian_rdp(sigma, q, self._orders)
        return rdp

    def get_privacy_spent(self, delta: float) -> PrivacySpent:
        if not (0 < delta < 1):
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        if not self._events:
            return PrivacySpent(epsilon_spent=0.0, delta_spent=0.0)
        rdp = self.total_rdp()
        eps = rdp + math.log(1.0 / delta) / (self._orders - 1.0)
        return PrivacySpent(epsilon_spent=float(np.min(eps)), delta_spent=delta)

    def optimal_order(self, delta: float) -> float:
        """The order achieving the minimum in the RDP→DP conversion (diagnostic)."""
        rdp = self.total_rdp()
        eps = rdp + math.log(1.0 / delta) / (self._orders - 1.0)
        return float(self._orders[int(np.argmin(eps))])


def noise_multiplier_for_budget(
    epsilon: float,
    delta: float,
    sampling_rate: float,
    num_events: int,
    orders: Sequence[float] = DEFAULT_RDP_ORDERS,
) -> float:
    """Smallest σ (to 1e-3) such that ``num_events`` subsampled-Gaussian events at rate q
    stay within (ε, δ) under RDP accounting.  New capability — the reference makes users
    pick σ by hand.  Binary search over σ; monotone because RDP ∝ 1/σ².
    """
    if num_events < 1:
        raise ValueError("num_events must be >= 1")

    def spent(sigma: float) -> float:
        acc = RDPAccountant(orders)
        acc.add_noise_event(sigma, sampling_rate, count=num_events)
        return acc.get_privacy_spent(delta).epsilon_spent

    lo, hi = 1e-3, 1.0
    while spent(hi) > epsilon:
        hi *= 2.0
        if hi > 1e6:
            raise ValueError("no feasible noise multiplier below 1e6 for this budget")
    while hi - lo > 1e-3:
        mid = (lo + hi) / 2.0
        if spent(mid) > epsilon:
            lo = mid
        else:
            hi = mid
    return hi
