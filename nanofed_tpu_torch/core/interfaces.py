"""Structural typing contracts (counterpart of ``nanofed_tpu/core/interfaces.py``),
over torch types.

Models are ``(init, apply)`` pure-function pairs over flat param dicts and trainers
are ``local_fit`` functions over stacked clients, so the Protocols describe those
callables, plus the host-side services (model store, coordinator, transport server)
that remain objects.  ``LocalFitFn`` is the contract of ``build_round_step(local_fit=)``
and ``Coordinator(local_fit=)``.
"""

from __future__ import annotations

from typing import Any, Iterator, Protocol, Sequence, runtime_checkable

import torch

from nanofed_tpu_torch.core.types import ClientData, ClientUpdates, ModelVersion, Params


@runtime_checkable
class ModelProtocol(Protocol):
    """A model as a pure init/apply pair: ``init(generator) -> params``,
    ``apply(params, x, *, dropout=None) -> log-probabilities``."""

    name: str

    def init(self, gen: torch.Generator) -> Params: ...

    def apply(
        self, params: Params, x: torch.Tensor, *, dropout: Sequence[torch.Tensor] | None = None
    ) -> torch.Tensor: ...


class LocalFitFn(Protocol):
    """Client-side local training over ``[k]`` stacked clients
    (``trainer.local.make_local_fit``'s signature): ``data`` tensors ``[k, N, ...]``,
    permutations ``[k, E, N]``, the clients' ``[k]`` int32 keys and the round's
    ``lr_scale``.  Returns a ``LocalFitResult`` (``params`` leaves ``[k, ...]`` and
    ``[k]`` metrics).  A fit that honours ``lr_scale`` sets ``supports_lr_scale``."""

    def __call__(
        self,
        global_params: Params,
        data: ClientData,
        perms: torch.Tensor,
        keys: torch.Tensor | None = None,
        lr_scale: float = 1.0,
    ) -> Any: ...


class AggregatorProtocol(Protocol):
    """Server-side combination of client results into the new global model."""

    def __call__(self, global_params: Params, updates: ClientUpdates) -> Params: ...


class ModelManagerProtocol(Protocol):
    """Versioned persistence of the global model."""

    def save_model(self, params: Params, metadata: dict[str, Any] | None = None) -> ModelVersion: ...

    def load_model(self, version_id: str | None = None) -> tuple[Params, ModelVersion]: ...

    def list_versions(self) -> list[ModelVersion]: ...


class CoordinatorProtocol(Protocol):
    """The round engine."""

    def run(self) -> Iterator[Any]: ...


class ServerProtocol(Protocol):
    """Optional transport front-end."""

    async def start(self) -> None: ...

    async def stop(self) -> None: ...
