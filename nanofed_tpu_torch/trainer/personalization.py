"""Personalized evaluation: fine-tune the global model per client and test it on the
client's own held-out samples (counterpart of ``nanofed_tpu/trainer/personalization.py``).

Fine-tuning is ``make_local_fit``, the rounds' own fit, over every client at once, and
each client's test split is scored batch by batch, so the evaluation holds activations
of ``[C, bsz, ...]``, never ``[C, N, ...]``.  Nothing about the global model changes.

``split_client_data`` moves samples between two masks with the JAX package's numpy
stream (``default_rng(seed)``, one permutation per client), so both packages split a
population into the same train and test samples.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nanofed_tpu_torch.core.types import ClientData, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import (
    GradFn,
    client_keys,
    draw_permutations,
    make_local_fit,
)


def split_client_data(
    data: ClientData, test_fraction: float = 0.2, seed: int = 0
) -> tuple[ClientData, ClientData]:
    """Split each client's real samples into disjoint train and test subsets.

    Returns ``(train, test)`` with the input's ``[C, N, ...]`` shapes: the split moves
    samples between the two masks (a sample is real on exactly one side).  Each client
    keeps at least one sample on each side; a client with a single real sample keeps
    it on the train side.  The masks come back as the input's kind (a numpy array, or
    a tensor on the input's device)."""
    if not 0.0 < test_fraction < 1.0:
        raise ValueError(f"test_fraction must be in (0, 1), got {test_fraction}")
    is_tensor = torch.is_tensor(data.mask)
    mask = data.mask.detach().cpu().numpy() if is_tensor else np.asarray(data.mask)
    if mask.ndim != 2:
        raise ValueError("split_client_data expects stacked [C, N] client data")
    rng = np.random.default_rng(seed)
    train_mask = np.zeros_like(mask)
    test_mask = np.zeros_like(mask)
    for c in range(mask.shape[0]):
        real = np.where(mask[c] > 0)[0]
        if len(real) == 0:
            continue  # padding client: empty on both sides
        n_test = int(np.floor(test_fraction * len(real)))
        if len(real) >= 2:
            n_test = min(max(n_test, 1), len(real) - 1)
        else:
            n_test = 0
        chosen = rng.permutation(real)
        test_idx, train_idx = chosen[:n_test], chosen[n_test:]
        train_mask[c, train_idx] = 1.0
        test_mask[c, test_idx] = 1.0

    def like_input(m: np.ndarray):
        return torch.from_numpy(m).to(data.mask.device) if is_tensor else m

    return data._replace(mask=like_input(train_mask)), data._replace(mask=like_input(test_mask))


def make_personalized_evaluator(
    model: Model, training: TrainingConfig, grad_fn: GradFn | None = None,
) -> Callable[..., dict[str, torch.Tensor]]:
    """Build ``evaluate(global_params, train, test, perms=None, keys=None, seed=0)``
    over ``[C]`` clients on the data's device: fine-tune the global model on every
    client's train split (``make_local_fit`` with ``training``) and report, per
    client and weighted by test samples:

    - ``global_accuracy``: the global model on each client's test split;
    - ``personal_accuracy``: the fine-tuned model on the same split;

    with ``personalization_gain`` and the per-client ``*_per_client`` and
    ``test_counts`` tensors, the JAX package's keys.  ``perms`` (``[C, E, N]``) and
    ``keys`` default to draws from ``seed``.  Clients with an empty test mask weigh 0."""
    fit = make_local_fit(model, training, grad_fn=grad_fn)
    bsz = training.batch_size
    stacked_apply = torch.func.vmap(model.apply)

    @torch.no_grad()
    def eval_on(params: Params, test: ClientData, stacked: bool):
        c, n = test.y.shape
        correct = torch.zeros(c, device=test.y.device)
        count = torch.zeros(c, device=test.y.device)
        for start in range(0, n, bsz):
            x, y = test.x[:, start:start + bsz], test.y[:, start:start + bsz]
            m = test.mask[:, start:start + bsz]
            if stacked:
                logp = stacked_apply(params, x)
            else:
                logp = model.apply(params, x.reshape(-1, *x.shape[2:])).view(*y.shape, -1)
            correct += ((logp.argmax(-1) == y).float() * m).sum(1)
            count += m.sum(1)
        return correct / torch.clamp(count, min=1.0), count

    def evaluate(
        global_params: Params,
        train: ClientData,
        test: ClientData,
        perms: torch.Tensor | None = None,
        keys: torch.Tensor | None = None,
        seed: int = 0,
    ) -> dict[str, torch.Tensor]:
        c, n = train.y.shape
        device = train.y.device
        if perms is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            perms = draw_permutations(gen, c, training.local_epochs, n)
        if keys is None:
            keys = client_keys(seed, c, device)
        g_acc, counts = eval_on(global_params, test, stacked=False)
        tuned = fit(global_params, train, perms, keys).params
        p_acc, _ = eval_on(tuned, test, stacked=True)
        w = counts / torch.clamp(counts.sum(), min=1.0)
        return {
            "global_accuracy_per_client": g_acc,
            "personal_accuracy_per_client": p_acc,
            "test_counts": counts,
            "global_accuracy": (g_acc * w).sum(),
            "personal_accuracy": (p_acc * w).sum(),
            "personalization_gain": ((p_acc - g_acc) * w).sum(),
        }

    return evaluate


__all__ = ["make_personalized_evaluator", "split_client_data"]
