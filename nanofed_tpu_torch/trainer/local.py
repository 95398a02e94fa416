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
the CPU and on the card.  A gradient function also gets the client's own key for the
step (:data:`GradFn`): the same hash on another lane than the dropout layers', so a
gradient's own randomness (DP-SGD's noise, ``trainer.private``) is client-stable too.

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


# grad_fn(params, xb, yb, mb, dropout, key) -> (grads, StepStats), for ONE client:
# ``dropout`` the batch's keep-masks, ``key`` the client's int32 key for this (epoch,
# step), or None when the fit was given no keys.  A grad fn that needs the key sets
# ``grad_fn.needs_key = True``, and the fit then requires keys.
GradFn = Callable[..., tuple[Params, StepStats]]

# The lane of the per-step key a grad fn gets; the dropout layers take lanes 0, 1, ...
GRAD_KEY_LANE = 0x6E6F6973


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

    def grad_fn(params, xb, yb, mb, dropout, key=None):
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
    gen: torch.Generator, num_clients: int, epochs: int, n: int,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``[num_clients, epochs, n]`` independent uniform permutations of ``range(n)``
    on ``gen``'s device (or ``device="meta"``: a shape, with a host generator)."""
    u = torch.rand((num_clients, epochs, n), generator=gen, device=device or gen.device)
    return u.argsort(dim=-1)


def client_keys(seed: int, num_clients: int, device: torch.device | str) -> torch.Tensor:
    """``[num_clients]`` int32 dropout keys on ``device``: client ``c``'s key is a hash
    of ``(seed, c)`` alone.  Gather them by client id, as the permutations are."""
    lo, hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    words = torch.tensor([lo, hi], dtype=torch.int64).to(torch.int32)  # wraps to int32
    # fedlint: disable=FED001 (a host tensor of two seed words, made just above: the cast reads no device value)
    base = int(mix32(mix32(words[:1]) + words[1:]))
    ids = torch.arange(num_clients, dtype=torch.int32, device=device)
    return mix32(ids + base)


def _row_keys(keys: torch.Tensor, epochs: int, steps: int, lanes: range) -> torch.Tensor:
    """``[E, S, L, k]`` int32: one key per (epoch, step, lane, client).  The dropout
    layers are lanes ``0 .. L-1``; a grad fn's key is lane :data:`GRAD_KEY_LANE`.
    The salts are made on the keys' device, so a fit copies nothing from the host."""
    dev = keys.device
    salt = mix32(torch.arange(epochs, dtype=torch.int32, device=dev))[:, None] + torch.arange(
        steps, dtype=torch.int32, device=dev)
    lane = torch.arange(lanes.start, lanes.stop, dtype=torch.int32, device=dev)
    salt = mix32(salt)[:, :, None] + lane
    return mix32(mix32(salt)[..., None] + keys)


def grad_keys(keys: torch.Tensor, epochs: int, steps: int) -> torch.Tensor:
    """``[E, S, k]`` int32: the key a grad fn gets for each (epoch, step, client)."""
    return _row_keys(keys, epochs, steps, range(GRAD_KEY_LANE, GRAD_KEY_LANE + 1))[:, :, 0]


class _Batch(NamedTuple):
    """One step's batch of every client: ``[k, bsz, ...]`` data, the dropout
    keep-masks and the clients' ``[k]`` grad-fn keys (None without keys)."""

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    dropout: tuple
    key: torch.Tensor | None


def _epoch_batches(model: Model, config: TrainingConfig, data: ClientData,
                   perms: torch.Tensor, keys: torch.Tensor | None, needs_key: bool):
    """Check a fit's inputs and return ``batches``: ``batches(e)`` yields epoch ``e``'s
    steps in order.  The discipline every fit shares: capacity a multiple of
    the batch, ``max_batches`` clamps the steps, epoch ``e``'s step ``s`` reads
    ``perms[:, e, s*bsz:(s+1)*bsz]``."""
    bsz, epochs = config.batch_size, config.local_epochs
    k, n = data.y.shape
    if n % bsz != 0:
        raise ValueError(
            f"data capacity {n} must be a multiple of batch_size {bsz} "
            "(use data.batching.pack_clients with the same batch_size)"
        )
    if tuple(perms.shape) != (k, epochs, n):
        raise ValueError(f"perms must be {(k, epochs, n)}, got {tuple(perms.shape)}")
    if (model.dropout or needs_key) and (
        keys is None or tuple(keys.shape) != (k,) or keys.dtype != torch.int32
    ):
        what = "dropout" if model.dropout else "a gradient that needs the clients' keys"
        raise ValueError(f"{model.name} trains with {what}: pass keys, [{k}] int32")
    steps = n // bsz
    if config.max_batches is not None:
        steps = min(steps, config.max_batches)
    if model.dropout:
        row_keys = _row_keys(keys, epochs, steps, range(len(model.dropout)))
        position_keys = [
            mix32(torch.arange(bsz * math.prod(shape), dtype=torch.int32, device=keys.device))
            for shape, _ in model.dropout
        ]
    step_keys = grad_keys(keys, epochs, steps) if keys is not None else None
    rows = torch.arange(k, device=data.y.device)[:, None]

    def batches(e: int):
        for s in range(steps):
            idx = perms[:, e, s * bsz : (s + 1) * bsz]
            dropout = tuple(
                keep_mask(row_keys[e, s, layer], position_keys[layer], (bsz, *shape), rate)
                for layer, (shape, rate) in enumerate(model.dropout)
            )
            yield _Batch(data.x[rows, idx], data.y[rows, idx], data.mask[rows, idx], dropout,
                         None if step_keys is None else step_keys[e, s])

    return batches


def _batched_grad(grad_fn: GradFn) -> Callable[[Params, _Batch], tuple[Params, StepStats]]:
    """``grad_fn`` over the ``[k]`` clients of a batch (``torch.func.vmap``); without
    keys the grad fn gets None, which vmap takes only as an unbatched argument."""
    with_key = torch.func.vmap(grad_fn)
    without_key = torch.func.vmap(grad_fn, in_dims=(0, 0, 0, 0, 0, None))

    def call(params: Params, b: _Batch) -> tuple[Params, StepStats]:
        fn = without_key if b.key is None else with_key
        return fn(params, b.x, b.y, b.mask, b.dropout, b.key)

    return call


def _epoch_metrics(step_stats: list[StepStats], collect_batch: bool):
    """An epoch's ``[k]`` loss and accuracy and its ``[k, S]`` per-step loss (zeros
    unless ``collect_batch``), from the steps' masked sums."""
    loss_sum = torch.stack([st.loss_sum for st in step_stats], 1)  # [k, S]
    correct = torch.stack([st.correct for st in step_stats], 1)
    count = torch.stack([st.count for st in step_stats], 1)
    total = torch.clamp(count.sum(1), min=1.0)
    b_loss = (loss_sum / torch.clamp(count, min=1.0) if collect_batch
              else torch.zeros_like(loss_sum))
    return loss_sum.sum(1) / total, correct.sum(1) / total, b_loss


def _where_rows(keep: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(keep.view(-1, *([1] * (a.ndim - 1))), a, b)


def make_local_fit(
    model: Model,
    config: TrainingConfig,
    grad_fn: GradFn | None = None,
    optimizer: SGD | None = None,
) -> Callable[..., LocalFitResult]:
    """Build ``local_fit(global_params, data, perms, keys=None, lr_scale=1.0)``.

    ``global_params`` is one param dict; ``data`` is ``ClientData`` tensors
    ``[k, N, ...]``; ``perms`` is ``[k, E, N]``; ``keys`` is the clients' ``[k]``
    int32 keys (:func:`client_keys`; required when ``model.dropout`` is not empty or
    the grad fn sets ``needs_key``).  ``grad_fn`` replaces the default masked-NLL
    gradient of one client (:func:`make_grad_fn`); it owns its casts, so
    ``config.compute_dtype`` must then be unset.  ``optimizer`` replaces
    :func:`make_optimizer`'s (an object with ``init(params)`` and
    ``update(grads, state, params)``, as :class:`SGD`).  FedProx adds
    ``mu * (w - w_global)`` to each gradient; ``lr_scale`` multiplies every update
    (the lr-schedule hook; FedProx and weight decay scale with it).
    """
    if grad_fn is not None and config.compute_dtype is not None:
        # A custom grad_fn owns its own casts; silently ignoring the config would let a
        # user believe bf16 is active when it is not.
        raise ValueError(
            "compute_dtype is set but a custom grad_fn was supplied; bake the dtype "
            "into the grad_fn (e.g. make_dp_grad_fn(..., compute_dtype=...)) and leave "
            "TrainingConfig.compute_dtype unset"
        )
    needs_key = bool(getattr(grad_fn, "needs_key", False))
    grad_fn = grad_fn or make_grad_fn(model.apply, compute_dtype=config.compute_dtype)
    batched_grad = _batched_grad(grad_fn)
    tx = optimizer or make_optimizer(config)

    def local_fit(
        global_params: Params,
        data: ClientData,
        perms: torch.Tensor,
        keys: torch.Tensor | None = None,
        lr_scale: float = 1.0,
    ) -> LocalFitResult:
        k = data.y.shape[0]
        batches = _epoch_batches(model, config, data, perms, keys, needs_key)
        params = {name: p.expand(k, *p.shape).clone() for name, p in global_params.items()}
        state = tx.init(params)
        e_loss, e_acc, b_loss = [], [], []
        for e in range(config.local_epochs):
            step_stats = []
            for b in batches(e):
                grads, stats = batched_grad(params, b)
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
            loss, acc, batch_loss = _epoch_metrics(step_stats, config.collect_batch_metrics)
            e_loss.append(loss)
            e_acc.append(acc)
            b_loss.append(batch_loss)
        metrics = ClientMetrics(loss=e_loss[-1], accuracy=e_acc[-1], samples=data.mask.sum(1))
        return LocalFitResult(
            params=params,
            metrics=metrics,
            epoch_loss=torch.stack(e_loss, 1),
            epoch_accuracy=torch.stack(e_acc, 1),
            batch_loss=torch.stack(b_loss, 1),
        )

    # A custom local_fit may not honour lr_scale; the round builders and the
    # Coordinator check this marker before they schedule one.
    local_fit.supports_lr_scale = True
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
