"""The MNIST CNN (counterpart of ``nanofed_tpu/models/mnist.py``).

conv(1->32, 3x3) -> relu -> conv(32->64, 3x3) -> relu -> maxpool(2) -> dropout(.25)
-> flatten(9216) -> fc(9216->128) -> relu -> dropout(.5) -> fc(128->10) -> log_softmax;
1,199,882 params.  Activations stay NHWC up to the flatten, so ``fc1``'s 9216 rows
are in (H, W, C) order exactly as in the JAX package and its weights carry over.
"""

from __future__ import annotations

from typing import Sequence

import torch

from nanofed_tpu_torch import nn
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.models.base import Model, register_model
from nanofed_tpu_torch.utils.trees import flatten_with_names

INPUT_SHAPE = (28, 28, 1)
NUM_CLASSES = 10
DROPOUT = (((12, 12, 64), 0.25), ((128,), 0.5))


def init(gen: torch.Generator) -> Params:
    layers = {
        "conv1": nn.conv2d_init(gen, 1, 32, 3),
        "conv2": nn.conv2d_init(gen, 32, 64, 3),
        "fc1": nn.dense_init(gen, 9216, 128),
        "fc2": nn.dense_init(gen, 128, NUM_CLASSES),
    }
    return flatten_with_names(layers)


def apply(
    params: Params, x: torch.Tensor, *, dropout: Sequence[torch.Tensor] | None = None
) -> torch.Tensor:
    """Forward pass on ``x`` [N, 28, 28, 1]; returns [N, 10] log-probabilities."""
    keep1, keep2 = dropout if dropout else (None, None)
    layer = lambda name: {"kernel": params[f"{name}/kernel"], "bias": params[f"{name}/bias"]}
    x = nn.relu(nn.conv2d(layer("conv1"), x))  # [N, 26, 26, 32]
    x = nn.relu(nn.conv2d(layer("conv2"), x))  # [N, 24, 24, 64]
    x = nn.max_pool(x, 2)  # [N, 12, 12, 64]
    x = nn.dropout(x, keep1, DROPOUT[0][1])
    x = nn.flatten(x)  # [N, 9216] in (H, W, C) order
    x = nn.relu(nn.dense(layer("fc1"), x))
    x = nn.dropout(x, keep2, DROPOUT[1][1])
    x = nn.dense(layer("fc2"), x)
    return nn.log_softmax(x)


@register_model("mnist_cnn")
def mnist_cnn() -> Model:
    return Model(
        name="mnist_cnn", init=init, apply=apply, input_shape=INPUT_SHAPE,
        num_classes=NUM_CLASSES, dropout=DROPOUT,
    )
