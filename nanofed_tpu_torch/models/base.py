"""Model record and registry (counterpart of ``nanofed_tpu/models/base.py``).

A model is a named pure pair: ``init(generator) -> params`` draws a flat param dict
(``/``-path names, ravel order) on the generator's device, and
``apply(params, x, *, dropout=None) -> log-probs`` is the forward pass.  ``dropout``
holds one boolean keep-mask per entry of ``Model.dropout`` (the per-example shape and
rate of each dropout layer, in order), or None for evaluation.  The caller draws the
masks (``trainer.local``), so the randomness stays outside the batched function.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from nanofed_tpu_torch.core.types import Params

InitFn = Callable[[torch.Generator], Params]
ApplyFn = Callable[..., torch.Tensor]


@dataclass(frozen=True)
class Model:
    name: str
    init: InitFn
    apply: ApplyFn
    input_shape: tuple[int, ...] = field(default=())
    num_classes: int = 0
    # ((per-example activation shape, rate), ...) for each dropout layer of apply.
    # Empty means the model trains without dropout (dataclasses.replace(model,
    # dropout=()) turns it off, as the parity tests do).
    dropout: tuple[tuple[tuple[int, ...], float], ...] = ()
    # Token-stream models (the causal transformer LM): ``x`` is integer token ids of
    # shape ``input_shape == (seq_len,)`` and ``num_classes`` is the vocabulary.  The
    # runner picks token-stream data by it, and no cast touches the ids.
    token_stream: bool = False


_REGISTRY: dict[str, Callable[..., Model]] = {}


def register_model(name: str) -> Callable[[Callable[..., Model]], Callable[..., Model]]:
    """Decorator registering a model factory under ``name``."""

    def deco(factory: Callable[..., Model]) -> Callable[..., Model]:
        _REGISTRY[name] = factory
        return factory

    return deco


def get_model(name: str, **kwargs) -> Model:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(_REGISTRY)

