"""Central and local DP mechanisms over whole model updates (counterpart of
``nanofed_tpu/privacy/mechanisms.py``).

Clip an update to a global-norm bound, then add calibrated noise; a central variant
(applied server-side to each client's update) and a local one (client-side, batch
size pinned to 1).  Mechanisms return the noised update, and the caller feeds the
accountant (``record``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.privacy.accounting import BasePrivacyAccountant
from nanofed_tpu_torch.privacy.config import PrivacyConfig, require_gaussian_accounting
from nanofed_tpu_torch.privacy.noise import get_noise_generator, tree_add_noise
from nanofed_tpu_torch.utils.trees import (
    ravel_stacked,
    tree_clip_by_global_norm,
    unravel_stacked,
)


class PrivacyType(enum.Enum):
    """Where the mechanism runs."""

    CENTRAL = "central"
    LOCAL = "local"


@dataclass(frozen=True, slots=True)
class PrivacyMechanism:
    """A configured clip+noise mechanism; ``batch_size`` B enters the noise scale as
    σ·C/B, and the local variant pins B=1."""

    config: PrivacyConfig
    privacy_type: PrivacyType = PrivacyType.CENTRAL
    batch_size: int = 1

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.privacy_type is PrivacyType.LOCAL and self.batch_size != 1:
            raise ValueError("local DP uses batch_size=1 (each update is one user's data)")

    @property
    def noise_scale(self) -> float:
        return self.config.noise_multiplier * self.config.max_gradient_norm / self.batch_size

    def privatize(self, gen: torch.Generator, update: Params) -> Params:
        """Clip ``update`` to global norm C, then add noise of scale σ·C/B."""
        clipped, _ = tree_clip_by_global_norm(update, self.config.max_gradient_norm)
        noise = get_noise_generator(self.config.noise_type)
        return tree_add_noise(gen, clipped, self.noise_scale, noise)

    def record(
        self, accountant: BasePrivacyAccountant, sampling_rate: float = 1.0, count: int = 1
    ) -> None:
        """Feed ``count`` privatize calls into ``accountant``."""
        require_gaussian_accounting(self.config)
        accountant.add_noise_event(self.config.noise_multiplier, sampling_rate, count=count)


def make_privacy_mechanism(
    privacy_type: PrivacyType | str, config: PrivacyConfig, batch_size: int = 1
) -> PrivacyMechanism:
    """Factory: the local variant always has batch size 1."""
    ptype = PrivacyType(privacy_type) if not isinstance(privacy_type, PrivacyType) else privacy_type
    if ptype is PrivacyType.LOCAL:
        return PrivacyMechanism(config=config, privacy_type=ptype, batch_size=1)
    return PrivacyMechanism(config=config, privacy_type=ptype, batch_size=batch_size)


def privatize_stacked_updates(
    gen: torch.Generator, stacked_params: Params, mechanism: PrivacyMechanism
) -> Params:
    """``privatize`` every client of a stacked update (leaves ``[C, ...]``) at once:
    each row clipped to C by its own global norm, then one ``[C, P]`` noise draw."""
    flat = ravel_stacked(stacked_params)
    c, p = flat.shape
    clip = mechanism.config.max_gradient_norm
    norms = torch.linalg.vector_norm(flat, dim=1)
    flat = flat * torch.clamp(clip / (norms + 1e-12), max=1.0)[:, None]
    noise = get_noise_generator(mechanism.config.noise_type)
    flat = flat + noise.sample(gen, (c, p), mechanism.noise_scale)
    return unravel_stacked(flat, {name: leaf[0] for name, leaf in stacked_params.items()})
