"""Client-side local training over a batch of clients (counterpart of
``nanofed_tpu/trainer/local.py``).

The JAX package writes one client's fit as a pure function and ``vmap``s it.  Here
the client dimension is written out: a Python loop over epochs and steps, where each
step computes every client's gradient at once with ``torch.func.vmap`` of one
client's ``grad``, and the optimizer update is elementwise over the stacked
``[k, ...]`` params.

Randomness is explicit and lives outside the vmapped function, and it belongs to
the client, as the JAX package's per-client keys do: each client's epoch permutations
arrive as a ``[k, E, N]`` index tensor (:func:`draw_permutations`, or injected — the
parity tests pass the JAX fit's own permutations), and each client's dropout
keep-masks are a counter-based hash of its own key (:func:`client_keys`), the epoch,
the step, the layer and the position (``nn.keep_mask``).  So a client trains the same
model whichever chunk or cohort slot it runs in, and the masks are the same bits on
the CPU and on the card.

Padding discipline is the JAX package's: masked samples contribute nothing to the
loss, the gradient or the metrics, and a batch that is all padding leaves a client's
params and optimizer state untouched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params
from nanofed_tpu_torch.models.base import ApplyFn, Model
from nanofed_tpu_torch.nn import keep_mask, mix32
from nanofed_tpu_torch.trainer.config import TrainingConfig, torch_dtype


class StepStats(NamedTuple):
    """Per-batch masked sums (not means), so summing across steps stays exact."""

    loss_sum: torch.Tensor
    correct: torch.Tensor
    count: torch.Tensor


class LocalFitResult(NamedTuple):
    params: Params  # stacked [k, ...]
    metrics: ClientMetrics  # [k], of the final local epoch (what a client reports)
    epoch_loss: torch.Tensor  # [k, E]
    epoch_accuracy: torch.Tensor  # [k, E]
    batch_loss: torch.Tensor  # [k, E, S] per-step mean loss (zeros unless collected)


# grad_fn(params, xb, yb, mb, dropout) -> (grads, StepStats), for ONE client.
GradFn = Callable[..., tuple[Params, StepStats]]


def make_grad_fn(apply_fn: ApplyFn, compute_dtype: str | None = None) -> GradFn:
    """Masked mean NLL gradient of one client's batch.

    ``compute_dtype`` casts params and float inputs inside the differentiated
    function, so gradients flow back to the float32 masters; the loss and metric
    reductions stay float32.
    """
    cdt = torch_dtype(compute_dtype) if compute_dtype is not None else None

    def loss_fn(params, xb, yb, mb, dropout):
        if cdt is not None:
            params = {name: p.to(cdt) for name, p in params.items()}
            if xb.is_floating_point():
                xb = xb.to(cdt)
        logp = apply_fn(params, xb, dropout=dropout).float()
        nll = -logp.gather(-1, yb[:, None])[:, 0]
        count = mb.sum()
        loss = (nll * mb).sum() / torch.clamp(count, min=1.0)
        correct = ((logp.argmax(-1) == yb).float() * mb).sum()
        return loss, (correct, count)

    grad_and_value = torch.func.grad_and_value(loss_fn, has_aux=True)

    def grad_fn(params, xb, yb, mb, dropout):
        grads, (loss, (correct, count)) = grad_and_value(params, xb, yb, mb, dropout)
        return grads, StepStats(loss_sum=loss * count, correct=correct, count=count)

    return grad_fn


@dataclass(frozen=True)
class SGD:
    """optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` on dicts of
    tensors: ``g + wd * p``, then the momentum trace ``t = g + momentum * t``, then
    ``-lr * t``.  (Not ``torch.optim.SGD``, whose weight decay and dampening
    conventions differ.)"""

    learning_rate: float
    momentum: float = 0.0
    weight_decay: float = 0.0

    def init(self, params: Params) -> Params:
        if not self.momentum:
            return {}
        return {name: torch.zeros_like(p) for name, p in params.items()}

    def update(self, grads: Params, state: Params, params: Params) -> tuple[Params, Params]:
        updates, new_state = {}, {}
        for name, g in grads.items():
            if self.weight_decay > 0:
                g = g + self.weight_decay * params[name]
            if self.momentum:
                g = g + self.momentum * state[name]
                new_state[name] = g
            updates[name] = g * (-self.learning_rate)
        return updates, new_state


def make_optimizer(config: TrainingConfig) -> SGD:
    return SGD(config.learning_rate, momentum=config.momentum, weight_decay=config.weight_decay)


def draw_permutations(
    gen: torch.Generator, num_clients: int, epochs: int, n: int
) -> torch.Tensor:
    """``[num_clients, epochs, n]`` independent uniform permutations of ``range(n)``
    on ``gen``'s device."""
    u = torch.rand((num_clients, epochs, n), generator=gen, device=gen.device)
    return u.argsort(dim=-1)


def client_keys(seed: int, num_clients: int, device: torch.device | str) -> torch.Tensor:
    """``[num_clients]`` int32 dropout keys on ``device``: client ``c``'s key is a hash
    of ``(seed, c)`` alone.  Gather them by client id, as the permutations are."""
    lo, hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    words = torch.tensor([lo, hi], dtype=torch.int64).to(torch.int32)  # wraps to int32
    base = int(mix32(mix32(words[:1]) + words[1:]))
    ids = torch.arange(num_clients, dtype=torch.int32, device=device)
    return mix32(ids + base)


def _dropout_row_keys(keys: torch.Tensor, epochs: int, steps: int, layers: int) -> torch.Tensor:
    """``[E, S, L, k]`` int32: one key per (epoch, step, dropout layer, client)."""
    salt = mix32(torch.arange(epochs, dtype=torch.int32))[:, None] + torch.arange(
        steps, dtype=torch.int32)
    salt = mix32(salt)[:, :, None] + torch.arange(layers, dtype=torch.int32)
    return mix32(mix32(salt).to(keys.device)[..., None] + keys)


def _where_rows(keep: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(keep.view(-1, *([1] * (a.ndim - 1))), a, b)


def make_local_fit(
    model: Model, config: TrainingConfig, grad_fn: GradFn | None = None
) -> Callable[..., LocalFitResult]:
    """Build ``local_fit(global_params, data, perms, keys=None, lr_scale=1.0)``.

    ``global_params`` is one param dict; ``data`` is ``ClientData`` tensors
    ``[k, N, ...]``; ``perms`` is ``[k, E, N]``; ``keys`` is the clients' ``[k]``
    int32 dropout keys (:func:`client_keys`; required when ``model.dropout`` is not
    empty).  ``grad_fn`` replaces the default masked-NLL gradient of one client
    (:func:`make_grad_fn`).  FedProx adds
    ``mu * (w - w_global)`` to each gradient; ``lr_scale`` multiplies every update
    (the lr-schedule hook; FedProx and weight decay scale with it).
    """
    grad_fn = grad_fn or make_grad_fn(model.apply, compute_dtype=config.compute_dtype)
    batched_grad = torch.func.vmap(grad_fn)
    tx = make_optimizer(config)
    bsz = config.batch_size
    epochs = config.local_epochs

    def local_fit(
        global_params: Params,
        data: ClientData,
        perms: torch.Tensor,
        keys: torch.Tensor | None = None,
        lr_scale: float = 1.0,
    ) -> LocalFitResult:
        k, n = data.y.shape
        if n % bsz != 0:
            raise ValueError(
                f"data capacity {n} must be a multiple of batch_size {bsz} "
                "(use data.batching.pack_clients with the same batch_size)"
            )
        if tuple(perms.shape) != (k, epochs, n):
            raise ValueError(f"perms must be {(k, epochs, n)}, got {tuple(perms.shape)}")
        if model.dropout and (
            keys is None or tuple(keys.shape) != (k,) or keys.dtype != torch.int32
        ):
            raise ValueError(f"{model.name} trains with dropout: pass keys, [{k}] int32")
        steps = n // bsz
        if config.max_batches is not None:
            steps = min(steps, config.max_batches)
        if model.dropout:
            row_keys = _dropout_row_keys(keys, epochs, steps, len(model.dropout))
            position_keys = [
                mix32(torch.arange(bsz * math.prod(shape), dtype=torch.int32,
                                   device=keys.device))
                for shape, _ in model.dropout
            ]

        params = {name: p.expand(k, *p.shape).clone() for name, p in global_params.items()}
        state = tx.init(params)
        rows = torch.arange(k, device=data.y.device)[:, None]
        e_loss, e_acc, b_loss = [], [], []
        for e in range(epochs):
            step_stats = []
            for s in range(steps):
                idx = perms[:, e, s * bsz : (s + 1) * bsz]
                xb, yb, mb = data.x[rows, idx], data.y[rows, idx], data.mask[rows, idx]
                dropout = tuple(
                    keep_mask(row_keys[e, s, layer], position_keys[layer], (bsz, *shape), rate)
                    for layer, (shape, rate) in enumerate(model.dropout)
                )
                grads, stats = batched_grad(params, xb, yb, mb, dropout)
                if config.prox_mu > 0:
                    grads = {
                        name: g + (params[name] - global_params[name]) * config.prox_mu
                        for name, g in grads.items()
                    }
                updates, new_state = tx.update(grads, state, params)
                nonempty = stats.count > 0
                params = {
                    name: _where_rows(nonempty, p + updates[name] * lr_scale, p)
                    for name, p in params.items()
                }
                state = {
                    name: _where_rows(nonempty, t, state[name]) for name, t in new_state.items()
                }
                step_stats.append(stats)
            loss_sum = torch.stack([st.loss_sum for st in step_stats], 1)  # [k, S]
            correct = torch.stack([st.correct for st in step_stats], 1)
            count = torch.stack([st.count for st in step_stats], 1)
            total = torch.clamp(count.sum(1), min=1.0)
            e_loss.append(loss_sum.sum(1) / total)
            e_acc.append(correct.sum(1) / total)
            b_loss.append(
                loss_sum / torch.clamp(count, min=1.0)
                if config.collect_batch_metrics
                else torch.zeros_like(loss_sum)
            )
        metrics = ClientMetrics(loss=e_loss[-1], accuracy=e_acc[-1], samples=data.mask.sum(1))
        return LocalFitResult(
            params=params,
            metrics=metrics,
            epoch_loss=torch.stack(e_loss, 1),
            epoch_accuracy=torch.stack(e_acc, 1),
            batch_loss=torch.stack(b_loss, 1),
        )

    return local_fit


def make_evaluator(
    model: Model, batch_size: int = 256
) -> Callable[[Params, ClientData], dict[str, torch.Tensor]]:
    """Full-dataset masked loss/accuracy over fixed-size batches of ``data``
    (``ClientData`` tensors ``[N, ...]``), without dropout."""

    @torch.no_grad()
    def evaluate(params: Params, data: ClientData) -> dict[str, torch.Tensor]:
        dev = data.y.device
        loss_sum = torch.zeros((), device=dev)
        correct = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        for start in range(0, data.y.shape[0], batch_size):
            x = data.x[start : start + batch_size]
            y = data.y[start : start + batch_size]
            m = data.mask[start : start + batch_size]
            logp = model.apply(params, x)
            nll = -logp.gather(-1, y[:, None])[:, 0]
            loss_sum += (nll * m).sum()
            correct += ((logp.argmax(-1) == y).float() * m).sum()
            count += m.sum()
        count = torch.clamp(count, min=1.0)
        return {"loss": loss_sum / count, "accuracy": correct / count}

    return evaluate
