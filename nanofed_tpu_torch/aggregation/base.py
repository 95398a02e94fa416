"""Server strategies (counterpart of ``nanofed_tpu/aggregation/base.py``).

A strategy is a server optimizer applied to the NEGATIVE aggregated client delta,
``new_global = global + server_tx(-mean_k(params_k - global))``: with SGD(1.0) this is
exactly FedAvg, and the others are FedAvgM / FedAdam / FedYogi (Reddi et al. 2021).
The transforms follow optax's semantics (momentum trace, bias correction, eps outside
the square root, Yogi's sign update and 1e-6 initial accumulators), not
``torch.optim``'s, and act on flat ``[P]`` vectors in ravel order.

A learning rate is a float or a schedule, a callable ``count -> lr`` stepped once
per round: the server state persists across rounds, so the count is the number of
server updates so far.  A schedule keeps its count in the state as
``schedule_count`` (optax's ``ScaleByScheduleState``, which the JAX package's
checkpoints carry), so a resumed run continues it.

The counters (``schedule_count``, Adam's ``count``) are 0-d int64 tensors on the
params' device, from ``init`` on: a round the device gates leaves them where they
were, and no round reads them back.  Only the checkpoint format turns them into ints
(``utils.trees.to_numpy_server_state``).

The schedule contract: a schedule is called with that 0-d int64 tensor, as an optax
schedule is traced with the count inside the JAX round, and returns a float or a 0-d
float tensor on the same device.  It computes with torch ops: ``float()``, ``int()``,
``.item()`` or an ``if`` on the count reads the device back every round, and
``Coordinator(strict=True)`` refuses such a read at construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from nanofed_tpu_torch.core.exceptions import AggregationError
from nanofed_tpu_torch.core.types import ClientUpdates, Params

State = dict[str, Any]
LearningRate = float | Callable[[torch.Tensor], float | torch.Tensor]


@dataclass(frozen=True)
class AggregationResult:
    """The new global params plus round bookkeeping and weighted-mean client
    metrics."""

    params: Params
    round_number: int
    num_clients: int
    metrics: dict[str, Any] = field(default_factory=dict)


def _counter(like: torch.Tensor) -> torch.Tensor:
    """A 0-d int64 zero on ``like``'s device (filled there: no copy from the host)."""
    return torch.zeros((), dtype=torch.int64, device=like.device)


def _schedule_init(learning_rate: LearningRate, flat: torch.Tensor) -> State:
    return {"schedule_count": _counter(flat)} if callable(learning_rate) else {}


def _scaled(
    step: torch.Tensor, learning_rate: LearningRate, state: State
) -> tuple[torch.Tensor, State]:
    """optax ``scale_by_learning_rate``: ``-lr * step``, the schedule read at the
    current count, which then advances."""
    if not callable(learning_rate):
        return step * (-learning_rate), {}
    count = state["schedule_count"]
    lr = learning_rate(count)
    lr = lr if torch.is_tensor(lr) else float(lr)
    return step * (-lr), {"schedule_count": count + 1}


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in float64 on the count's device."""
    return 1 - torch.pow(decay, count.double())


@dataclass(frozen=True)
class ServerSGD:
    """optax ``sgd(lr, momentum)``: ``t = g + momentum * t``; update ``-lr * t``."""

    learning_rate: LearningRate
    momentum: float | None = None

    def init(self, flat: torch.Tensor) -> State:
        trace = {"trace": torch.zeros_like(flat)} if self.momentum else {}
        return {**trace, **_schedule_init(self.learning_rate, flat)}

    def update(self, grad: torch.Tensor, state: State) -> tuple[torch.Tensor, State]:
        trace = {}
        if self.momentum:
            grad = grad + self.momentum * state["trace"]
            trace = {"trace": grad}
        step, schedule = _scaled(grad, self.learning_rate, state)
        return step, {**trace, **schedule}


@dataclass(frozen=True)
class ServerAdam:
    """optax ``adam`` (``yogi=False``) or ``yogi`` (``yogi=True``): first moment
    ``(1-b1) g + b1 mu``; second moment ``(1-b2) g^2 + b2 nu`` (Adam) or
    ``nu - (1-b2) sign(nu - g^2) g^2`` (Yogi); both bias-corrected by the step
    count; update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    learning_rate: LearningRate
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3
    yogi: bool = False

    def init(self, flat: torch.Tensor) -> State:
        init = 1e-6 if self.yogi else 0.0  # optax's initial_accumulator_value
        return {"count": _counter(flat), "mu": torch.full_like(flat, init),
                "nu": torch.full_like(flat, init), **_schedule_init(self.learning_rate, flat)}

    def update(self, grad: torch.Tensor, state: State) -> tuple[torch.Tensor, State]:
        mu = (1 - self.b1) * grad + self.b1 * state["mu"]
        g2 = grad * grad
        if self.yogi:
            nu = state["nu"] - (1 - self.b2) * torch.sign(state["nu"] - g2) * g2
        else:
            nu = (1 - self.b2) * g2 + self.b2 * state["nu"]
        count = state["count"] + 1
        mu_hat = mu / _bias_correction(self.b1, count)
        nu_hat = nu / _bias_correction(self.b2, count)
        step, schedule = _scaled(mu_hat / (torch.sqrt(nu_hat) + self.eps),
                                 self.learning_rate, state)
        return step, {"count": count, "mu": mu, "nu": nu, **schedule}


@dataclass(frozen=True)
class Strategy:
    """A named server-side update rule; ``server_tx`` consumes the negative
    aggregated delta."""

    name: str
    server_tx: ServerSGD | ServerAdam


def fedavg_strategy() -> Strategy:
    """Exact FedAvg: apply the aggregated delta verbatim."""
    return Strategy(name="fedavg", server_tx=ServerSGD(1.0))


def fedavgm_strategy(learning_rate: LearningRate = 1.0, momentum: float = 0.9) -> Strategy:
    """FedAvg with server momentum (Hsu et al. 2019).  ``learning_rate`` may be a
    schedule ``count -> lr``, stepped once per round."""
    return Strategy(name="fedavgm", server_tx=ServerSGD(learning_rate, momentum=momentum))


def fedadam_strategy(
    learning_rate: LearningRate = 1e-2, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3
) -> Strategy:
    """FedAdam (Reddi et al. 2021)."""
    return Strategy(name="fedadam", server_tx=ServerAdam(learning_rate, b1, b2, eps))


def fedyogi_strategy(
    learning_rate: LearningRate = 1e-2, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3
) -> Strategy:
    """FedYogi (Reddi et al. 2021)."""
    return Strategy(name="fedyogi", server_tx=ServerAdam(learning_rate, b1, b2, eps, yogi=True))


def validate_updates(updates: ClientUpdates, global_params: Params) -> None:
    """Structural validation before aggregation: the stacked client params carry the
    global model's leaves, each ``[C, *leaf.shape]``.  Statistical checks live in
    ``security.validation``."""
    if list(updates.params) != list(global_params):
        raise AggregationError(
            f"update tree structure mismatch: {list(updates.params)} != {list(global_params)}"
        )
    c = updates.weights.shape[0]
    for g, u in zip(global_params.values(), updates.params.values()):
        if tuple(u.shape) != (c, *g.shape):
            raise AggregationError(
                f"update leaf shape {tuple(u.shape)} incompatible with global "
                f"{tuple(g.shape)} and client count {c}"
            )
