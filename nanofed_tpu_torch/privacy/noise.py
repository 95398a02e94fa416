"""Seedable noise generators for DP mechanisms (counterpart of
``nanofed_tpu/privacy/noise.py``).

Gaussian and Laplacian noise drawn from an explicit ``torch.Generator`` (the JAX
package threads PRNG keys), with the same input validation.  A whole model update is
noised with ONE flat ``[P]`` draw in ravel order, unravelled into the leaves; the JAX
package draws one key per leaf (``fold_in(rng, i)``), so the two give other numbers
from the same seed and the parity tests inject the JAX draw.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import torch

from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.privacy.config import NoiseType
from nanofed_tpu_torch.utils.trees import tree_size, unravel


def validate_noise_input(shape: Sequence[int], scale: float | torch.Tensor) -> None:
    """Reject negative dimensions and (host-side) negative scales."""
    if any(int(d) < 0 for d in shape):
        raise ValueError(f"noise shape must be non-negative, got {tuple(shape)}")
    if isinstance(scale, (int, float)) and scale < 0:
        raise ValueError(f"noise scale must be >= 0, got {scale}")


class NoiseGenerator(Protocol):
    """Structural type of a noise source."""

    def standard(self, gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        """Unit-scale noise of ``shape`` on ``gen``'s device."""
        ...

    def sample(
        self, gen: torch.Generator, shape: Sequence[int], scale: float | torch.Tensor
    ) -> torch.Tensor:
        """Noise of ``shape`` with standard deviation / scale ``scale``."""
        ...


class _ScaledNoise:
    """``sample`` is ``scale`` times the subclass's unit-scale ``standard`` draw."""

    def standard(self, gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        raise NotImplementedError

    def sample(
        self, gen: torch.Generator, shape: Sequence[int], scale: float | torch.Tensor
    ) -> torch.Tensor:
        validate_noise_input(shape, scale)
        return scale * self.standard(gen, shape)


class GaussianNoiseGenerator(_ScaledNoise):
    """N(0, scale²) noise."""

    def standard(self, gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        validate_noise_input(shape, 1.0)
        return torch.randn(tuple(shape), generator=gen, device=gen.device)


class LaplacianNoiseGenerator(_ScaledNoise):
    """Laplace(0, scale) noise, as the difference of two unit exponential draws
    (each finite: ``exponential_`` never returns inf)."""

    def standard(self, gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        validate_noise_input(shape, 1.0)
        e = torch.empty((2, *shape), device=gen.device).exponential_(generator=gen)
        return e[0] - e[1]


def get_noise_generator(noise_type: NoiseType | str) -> NoiseGenerator:
    """Factory keyed on ``NoiseType`` (or its string value)."""
    key = NoiseType(noise_type) if not isinstance(noise_type, NoiseType) else noise_type
    if key is NoiseType.GAUSSIAN:
        return GaussianNoiseGenerator()
    return LaplacianNoiseGenerator()


def tree_noise(
    gen: torch.Generator,
    tree: Params,
    scale: float | torch.Tensor,
    generator: NoiseGenerator | None = None,
) -> Params:
    """Independent noise shaped like every leaf of ``tree`` (std/scale ``scale``):
    one flat ``[P]`` draw in ravel order, unravelled."""
    noise = (generator or GaussianNoiseGenerator()).sample(gen, (tree_size(tree),), scale)
    return unravel(noise, tree)


def tree_add_noise(
    gen: torch.Generator,
    tree: Params,
    scale: float | torch.Tensor,
    generator: NoiseGenerator | None = None,
) -> Params:
    """``tree + noise`` in one call."""
    noise = tree_noise(gen, tree, scale, generator)
    return {name: leaf + noise[name] for name, leaf in tree.items()}
