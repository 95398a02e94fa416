"""DP-SGD local training, per-example clipping (counterpart of
``nanofed_tpu/trainer/private.py``).

Each real example's gradient comes from ``torch.func.vmap(torch.func.grad_and_value)``
of a one-example loss over the batch, inside the local fit's vmap over clients: a
two-level vmap.  Each per-example gradient is clipped to the global norm C by
``min(1, C / max(||g_i||, 1e-12))``, padded examples get coefficient 0, and the
clipped sum plus N(0, (σC)²) noise (Laplace of scale σC under
``NoiseType.LAPLACIAN``) is divided by ``max(count, 1)``.  Under a compute dtype the
params and inputs are cast inside the one-example loss, so the per-example gradients
are float32 masters' gradients, as in the JAX package.

The noise is a counter-based function of the client's key for the step
(``trainer.local.grad_keys``, the fit's ``keys``): coordinate ``j`` of the draw hashes
``(key, j)`` with ``nn.mix32`` to uniforms, then Box-Muller (Gaussian) or the inverse
CDF (Laplace).  A ``torch.Generator`` cannot run under vmap; a hash can, and it makes
a client's noise a function of its own key, epoch and step only, whatever chunk or
cohort slot it trains in, with the same integer bits on the CPU and the card (the
float transforms may differ in the last bits).  A uniform has 24 bits, so a Gaussian
coordinate stays within 5.9σ.  As in the JAX package, the keys come from the run's
seed (``Coordinator``: ``client_keys`` of the round seed); this module adds no entropy.

Accounting is on the host: a fit's noise events are steps × epochs, recorded with
:func:`record_local_fit` after the fit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from nanofed_tpu_torch.models.base import ApplyFn, Model
from nanofed_tpu_torch.nn import mix32
from nanofed_tpu_torch.privacy.accounting import BasePrivacyAccountant, PrivacySpent
from nanofed_tpu_torch.privacy.config import (
    NoiseType,
    PrivacyConfig,
    require_gaussian_accounting,
)
from nanofed_tpu_torch.trainer.config import TrainingConfig, torch_dtype
from nanofed_tpu_torch.trainer.local import GradFn, StepStats, make_local_fit
from nanofed_tpu_torch.utils.trees import unravel

# Uniforms in (0, 1) from the top 24 bits of a 32-bit hash.
_U24 = 2.0 ** -24


def _uniforms(key: torch.Tensor, n: int) -> torch.Tensor:
    """``[n]`` float32 uniforms in (0, 1): coordinate ``j`` is a hash of ``key + mix32(j)``."""
    bits = mix32(mix32(torch.arange(n, dtype=torch.int32, device=key.device)) + key)
    return (((bits >> 8) & 0xFFFFFF).float() + 0.5) * _U24


def counter_noise(key: torch.Tensor, n: int,
                  noise_type: NoiseType = NoiseType.GAUSSIAN) -> torch.Tensor:
    """A unit-scale ``[n]`` float32 draw that is a function of the int32 ``key`` alone:
    standard Gaussian (Box-Muller on pairs of uniforms) or standard Laplace.  Runs
    under ``torch.func.vmap`` over keys."""
    if NoiseType(noise_type) is NoiseType.LAPLACIAN:
        u = _uniforms(key, n) - 0.5
        return -torch.sign(u) * torch.log1p(-2.0 * u.abs())
    half = -(-n // 2)
    u = _uniforms(key, 2 * half)
    radius = torch.sqrt(-2.0 * torch.log(u[:half]))
    angle = (2.0 * math.pi) * u[half:]
    return torch.cat([radius * torch.cos(angle), radius * torch.sin(angle)])[:n]


def per_example_grads(apply_fn: ApplyFn, compute_dtype: str | None = None):
    """``fn(params, xb, yb, dropout) -> (grads, nll, logp)``: every example's gradient
    of its own NLL (leaves ``[B, ...]``), its loss ``[B]`` and log-probabilities
    ``[B, classes]``; ``dropout`` holds the batch's keep-masks (row ``i`` is example
    ``i``'s)."""
    cdt = torch_dtype(compute_dtype) if compute_dtype is not None else None

    def example_loss(params, x, y, dropout):
        if cdt is not None:  # mixed precision; the gradients flow back to the fp32 masters
            params = {name: p.to(cdt) for name, p in params.items()}
            if x.is_floating_point():
                x = x.to(cdt)
        masks = tuple(m[None] for m in dropout) or None
        logp = apply_fn(params, x[None], dropout=masks)[0].float()
        nll = -logp.gather(0, y[None])[0]
        return nll, logp

    grads = torch.func.vmap(torch.func.grad_and_value(example_loss, has_aux=True),
                            in_dims=(None, 0, 0, 0))

    def fn(params, xb, yb, dropout):
        g, (nll, logp) = grads(params, xb, yb, dropout)
        return g, nll, logp

    return fn


def clip_coefficients(grads, mb: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``[B]``: ``min(1, C / max(||g_i||, 1e-12))`` for each example's gradient over
    every leaf, times the sample mask (padding gets 0)."""
    sq = torch.stack([g.reshape(g.shape[0], -1).square().sum(1) for g in grads.values()]).sum(0)
    return torch.clamp(max_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0) * mb


def make_dp_grad_fn(
    apply_fn: ApplyFn,
    privacy: PrivacyConfig,
    compute_dtype: str | None = None,
    noise_fn: Callable[[torch.Tensor, int], torch.Tensor] | None = None,
) -> GradFn:
    """Per-example clip + noise gradient for ``make_local_fit``: the direction is
    ``(Σ clip(g_i) + N(0, (σC)² I)) / max(count, 1)``.  ``noise_fn(key, P)`` gives the
    unit-scale ``[P]`` draw in ravel order (default :func:`counter_noise` of the
    config's noise type; the parity tests inject the JAX package's draw)."""
    clip, sigma = privacy.max_gradient_norm, privacy.noise_multiplier
    noise_fn = noise_fn or (lambda key, n: counter_noise(key, n, privacy.noise_type))
    example_grads = per_example_grads(apply_fn, compute_dtype)

    def grad_fn(params, xb, yb, mb, dropout, key=None):
        if key is None:
            raise ValueError("DP-SGD noise needs the clients' keys: pass keys to the fit")
        grads, nll, logp = example_grads(params, xb, yb, dropout)
        coef = clip_coefficients(grads, mb, clip)
        clipped = {name: torch.tensordot(coef.to(g.dtype), g, dims=1)
                   for name, g in grads.items()}
        size = sum(leaf.numel() for leaf in clipped.values())
        noise = unravel(noise_fn(key, size) * (sigma * clip), clipped)
        count = mb.sum()
        denom = torch.clamp(count, min=1.0)
        noisy_mean = {name: (s + noise[name]) / denom for name, s in clipped.items()}
        correct = ((logp.argmax(-1) == yb).float() * mb).sum()
        return noisy_mean, StepStats(loss_sum=(nll * mb).sum(), correct=correct, count=count)

    grad_fn.needs_key = True
    return grad_fn


def make_private_local_fit(
    model: Model, config: TrainingConfig, privacy: PrivacyConfig, optimizer=None,
) -> Callable:
    """DP-SGD variant of ``make_local_fit``: the same signature and semantics (a
    drop-in ``local_fit=`` for ``build_round_step`` and ``Coordinator``), every step
    privatized.  The fit needs the clients' keys."""
    return make_local_fit(
        model,
        # The dtype is baked into the DP grad fn; clear it on the config so
        # make_local_fit's custom-grad_fn guard does not trip.
        dataclasses.replace(config, compute_dtype=None),
        grad_fn=make_dp_grad_fn(model.apply, privacy, compute_dtype=config.compute_dtype),
        optimizer=optimizer,
    )


def local_fit_noise_events(config: TrainingConfig, data_capacity: int) -> int:
    """Noise events of one private local fit (static: steps × epochs)."""
    steps = data_capacity // config.batch_size
    if config.max_batches is not None:
        steps = min(steps, config.max_batches)
    return steps * config.local_epochs


def record_local_fit(
    accountant: BasePrivacyAccountant,
    privacy: PrivacyConfig,
    config: TrainingConfig,
    data_capacity: int,
    num_samples: int,
) -> None:
    """Feed one client's local fit into ``accountant`` at the subsampling rate
    q = batch_size / num_samples (clamped to 1)."""
    require_gaussian_accounting(privacy)
    q = min(1.0, config.batch_size / max(num_samples, 1))
    accountant.add_noise_event(
        privacy.noise_multiplier, q, count=local_fit_noise_events(config, data_capacity)
    )


def get_privacy_spent(accountant: BasePrivacyAccountant, privacy: PrivacyConfig) -> PrivacySpent:
    """Spend at the config's δ."""
    return accountant.get_privacy_spent(privacy.delta)


def validate_privacy_budget(accountant: BasePrivacyAccountant, privacy: PrivacyConfig) -> bool:
    """True iff the spend fits the configured (ε, δ) budget."""
    return accountant.validate_budget(privacy.epsilon, privacy.delta)


__all__ = [
    "NoiseType",
    "PrivacyConfig",
    "clip_coefficients",
    "counter_noise",
    "get_privacy_spent",
    "local_fit_noise_events",
    "make_dp_grad_fn",
    "make_private_local_fit",
    "per_example_grads",
    "record_local_fit",
    "validate_privacy_budget",
]
