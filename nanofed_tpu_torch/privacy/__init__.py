"""Differential privacy: config, noise, accounting, mechanisms (counterpart of
``nanofed_tpu/privacy/``).  Noise is drawn from explicit ``torch.Generator``s;
accounting is host-side NumPy, a copy of the JAX package's.  Central DP at the
round's reduce lives in ``aggregation.privacy`` and ``parallel.round_step``."""

from nanofed_tpu_torch.privacy.accounting import (
    DEFAULT_RDP_ORDERS,
    BasePrivacyAccountant,
    GaussianAccountant,
    PrivacyAccountant,
    PrivacySpent,
    RDPAccountant,
    noise_multiplier_for_budget,
    sampled_gaussian_rdp,
)
from nanofed_tpu_torch.privacy.config import (
    MAX_DELTA,
    MAX_EPSILON,
    MIN_DELTA,
    MIN_EPSILON,
    NoiseType,
    PrivacyConfig,
    require_gaussian_accounting,
)
from nanofed_tpu_torch.privacy.mechanisms import (
    PrivacyMechanism,
    PrivacyType,
    make_privacy_mechanism,
    privatize_stacked_updates,
)
from nanofed_tpu_torch.privacy.noise import (
    GaussianNoiseGenerator,
    LaplacianNoiseGenerator,
    NoiseGenerator,
    get_noise_generator,
    tree_add_noise,
    tree_noise,
    validate_noise_input,
)

__all__ = [
    "DEFAULT_RDP_ORDERS",
    "MAX_DELTA",
    "MAX_EPSILON",
    "MIN_DELTA",
    "MIN_EPSILON",
    "BasePrivacyAccountant",
    "GaussianAccountant",
    "GaussianNoiseGenerator",
    "LaplacianNoiseGenerator",
    "NoiseGenerator",
    "NoiseType",
    "PrivacyAccountant",
    "PrivacyConfig",
    "PrivacyMechanism",
    "PrivacySpent",
    "PrivacyType",
    "RDPAccountant",
    "get_noise_generator",
    "make_privacy_mechanism",
    "noise_multiplier_for_budget",
    "privatize_stacked_updates",
    "require_gaussian_accounting",
    "sampled_gaussian_rdp",
    "tree_add_noise",
    "tree_noise",
    "validate_noise_input",
]
