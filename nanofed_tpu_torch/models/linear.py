"""Small linear and MLP models (counterpart of ``nanofed_tpu/models/linear.py``), for
tests and the network examples.  Param names and layouts are the JAX package's
(``fc/kernel`` ``[in, out]``, ...), so its weights carry over with
``utils.trees.from_numpy_params``."""

from __future__ import annotations

from typing import Sequence

import torch

from nanofed_tpu_torch import nn
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.models.base import Model, register_model
from nanofed_tpu_torch.utils.trees import flatten_with_names


def _inputs(x: torch.Tensor) -> torch.Tensor:
    return nn.flatten(x) if x.ndim > 2 else x


@register_model("linear")
def linear(in_features: int = 10, num_classes: int = 2) -> Model:
    def init(gen: torch.Generator) -> Params:
        return flatten_with_names({"fc": nn.dense_init(gen, in_features, num_classes)})

    def apply(params: Params, x: torch.Tensor, *,
              dropout: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        layer = {"kernel": params["fc/kernel"], "bias": params["fc/bias"]}
        return nn.log_softmax(nn.dense(layer, _inputs(x)))

    return Model(name="linear", init=init, apply=apply, input_shape=(in_features,),
                 num_classes=num_classes)


@register_model("mlp")
def mlp(in_features: int = 784, hidden: int = 128, num_classes: int = 10) -> Model:
    def init(gen: torch.Generator) -> Params:
        return flatten_with_names({
            "fc1": nn.dense_init(gen, in_features, hidden),
            "fc2": nn.dense_init(gen, hidden, num_classes),
        })

    def apply(params: Params, x: torch.Tensor, *,
              dropout: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        fc1 = {"kernel": params["fc1/kernel"], "bias": params["fc1/bias"]}
        fc2 = {"kernel": params["fc2/kernel"], "bias": params["fc2/bias"]}
        return nn.log_softmax(nn.dense(fc2, nn.relu(nn.dense(fc1, _inputs(x)))))

    return Model(name="mlp", init=init, apply=apply, input_shape=(in_features,),
                 num_classes=num_classes)


@register_model("digits_mlp")
def digits_mlp(hidden: int = 64) -> Model:
    """The MLP for 8x8 digit images (the JAX package's offline real-data benchmark)."""
    m = mlp(in_features=64, hidden=hidden, num_classes=10)
    return Model(name="digits_mlp", init=m.init, apply=m.apply, input_shape=(8, 8, 1),
                 num_classes=10)
