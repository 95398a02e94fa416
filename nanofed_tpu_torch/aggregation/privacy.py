"""Privacy-aware aggregation: central DP at the server reduce, ε-weighted local DP
(counterpart of ``nanofed_tpu/aggregation/privacy.py``).

* **central** — the round step's DP-FedAvg (McMahan et al. 2018): each client's delta
  clipped to C, a uniform mean over the K participants, one noise draw of std σ·C/K
  on the aggregate (``parallel.round_step``; accounted by
  :func:`record_central_privacy` as one event per round).  :func:`apply_central_privacy`
  is the per-update host form.
* **local** — updates arrive already privatized; the server reweights by privacy
  spent (:func:`epsilon_adjusted_weights`).
* budget and minimum-client checks before aggregation (:func:`validate_private_round`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from nanofed_tpu_torch.core.exceptions import AggregationError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.privacy.accounting import BasePrivacyAccountant, PrivacySpent
from nanofed_tpu_torch.privacy.config import PrivacyConfig, require_gaussian_accounting
from nanofed_tpu_torch.privacy.mechanisms import (
    PrivacyMechanism,
    PrivacyType,
    make_privacy_mechanism,
    privatize_stacked_updates,
)


@dataclass(frozen=True, slots=True)
class PrivacyAwareAggregationConfig:
    """Privacy parameters plus the aggregation's knobs (minimum clients, dropout
    tolerance, mechanism placement)."""

    privacy: PrivacyConfig = field(default_factory=PrivacyConfig)
    privacy_type: PrivacyType = PrivacyType.CENTRAL
    min_clients: int = 1
    dropout_tolerance: float = 0.0

    def __post_init__(self) -> None:
        if self.min_clients < 1:
            raise ValueError("min_clients must be >= 1")
        if not (0.0 <= self.dropout_tolerance <= 1.0):
            raise ValueError("dropout_tolerance must be in [0, 1]")

    @property
    def required_clients(self) -> int:
        """Participants needed this round after tolerated dropout."""
        return max(1, int(self.min_clients * (1.0 - self.dropout_tolerance)))


def validate_private_round(
    config: PrivacyAwareAggregationConfig,
    num_participants: int,
    client_privacy_spent: list[PrivacySpent | None] | None = None,
) -> None:
    """Enough clients; under local DP every participant must report its spend and
    stay inside the configured budget."""
    if num_participants < config.required_clients:
        raise AggregationError(
            f"not enough clients: {num_participants} < {config.required_clients}"
        )
    if config.privacy_type is PrivacyType.LOCAL:
        if client_privacy_spent is None or len(client_privacy_spent) != num_participants:
            raise AggregationError("local DP requires privacy_spent for every participant")
        for i, spent in enumerate(client_privacy_spent):
            if spent is None:
                raise AggregationError(f"missing privacy budget for client {i}")
            if spent.epsilon_spent > config.privacy.epsilon:
                raise AggregationError(
                    f"client {i} exceeded budget: ε={spent.epsilon_spent:.4f} > "
                    f"{config.privacy.epsilon}"
                )


def central_mechanism(
    config: PrivacyAwareAggregationConfig, num_clients: int
) -> PrivacyMechanism:
    """The server-side clip+noise mechanism for a K-client round (noise scale σ·C/K)."""
    return make_privacy_mechanism(PrivacyType.CENTRAL, config.privacy, batch_size=num_clients)


def apply_central_privacy(
    gen: torch.Generator, stacked_deltas: Params, config: PrivacyAwareAggregationConfig
) -> Params:
    """Clip+noise every client's (stacked) delta: the per-update host form.  The round
    step does NOT use it (its DP-FedAvg draws noise once, on the aggregate)."""
    num_clients = next(iter(stacked_deltas.values())).shape[0]
    mech = central_mechanism(config, num_clients)
    return privatize_stacked_updates(gen, stacked_deltas, mech)


def record_central_privacy(
    accountant: BasePrivacyAccountant,
    config: PrivacyAwareAggregationConfig,
    num_rounds: int = 1,
    sampling_rate: float = 1.0,
) -> None:
    """Account ``num_rounds`` rounds of the round step's central-DP reduce: ONE
    Gaussian release per round (sensitivity C/K, noise std σ·C/K, so the effective
    multiplier is σ whatever the cohort), subsampled at ``sampling_rate`` = cohort / N.
    Amplification holds only while the sampling is secret: the Coordinator draws DP
    cohorts and device randomness from OS entropy."""
    require_gaussian_accounting(config.privacy)
    accountant.add_noise_event(
        config.privacy.noise_multiplier, sampling_rate, count=num_rounds
    )


def epsilon_adjusted_weights(
    weights: torch.Tensor, epsilons: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """Local-DP reweighting: sample-count weights scaled by normalised ε spent (more ε
    spent, less noise, more weight), renormalised to sum to 1; all-zero inputs give
    zeros."""
    w = weights / torch.clamp(weights.sum(), min=eps)
    adj = epsilons / torch.clamp(epsilons.sum(), min=eps)
    combined = w * adj
    return combined / torch.clamp(combined.sum(), min=eps)
