"""Privacy configuration with validated bounds (counterpart of
``nanofed_tpu/privacy/config.py``: the same bounds, fields and errors).

ε ∈ [0.01, 10], δ ∈ [1e-10, 0.1], positive clipping norm and noise multiplier,
Gaussian or Laplacian noise.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from nanofed_tpu_torch.core.exceptions import PrivacyError

MIN_EPSILON = 0.01
MAX_EPSILON = 10.0
MIN_DELTA = 1e-10
MAX_DELTA = 0.1


class NoiseType(enum.Enum):
    """Noise distribution for DP mechanisms."""

    GAUSSIAN = "gaussian"
    LAPLACIAN = "laplacian"


@dataclass(frozen=True, slots=True)
class PrivacyConfig:
    """Differential-privacy budget and mechanism parameters.

    ``epsilon``/``delta`` are the *target budget* the accountant validates against;
    ``max_gradient_norm`` is the clipping bound C; ``noise_multiplier`` is σ (noise std is
    σ·C).
    """

    epsilon: float = 1.0
    delta: float = 1e-5
    max_gradient_norm: float = 1.0
    noise_multiplier: float = 1.0
    noise_type: NoiseType = NoiseType.GAUSSIAN

    def __post_init__(self) -> None:
        if not (MIN_EPSILON <= self.epsilon <= MAX_EPSILON):
            raise ValueError(
                f"epsilon must be in [{MIN_EPSILON}, {MAX_EPSILON}], got {self.epsilon}"
            )
        if not (MIN_DELTA <= self.delta <= MAX_DELTA):
            raise ValueError(f"delta must be in [{MIN_DELTA}, {MAX_DELTA}], got {self.delta}")
        if self.max_gradient_norm <= 0:
            raise ValueError("max_gradient_norm must be > 0")
        if self.noise_multiplier <= 0:
            raise ValueError("noise_multiplier must be > 0")
        if not isinstance(self.noise_type, NoiseType):
            raise ValueError(f"noise_type must be a NoiseType, got {self.noise_type!r}")


def require_gaussian_accounting(privacy: PrivacyConfig) -> None:
    """Reject accounting for non-Gaussian noise: the Gaussian/RDP accountants bound
    only the Gaussian mechanism, so Laplacian events would report a meaningless
    (ε, δ)."""
    if privacy.noise_type is not NoiseType.GAUSSIAN:
        raise PrivacyError(
            f"privacy accounting supports only NoiseType.GAUSSIAN, got "
            f"{privacy.noise_type}; Laplacian noise has no accountant in this framework"
        )
