"""CIFAR ResNets with GroupNorm (counterpart of ``nanofed_tpu/models/resnet.py``), for
the ``fedprox_cifar10`` and ``cross_silo`` benchmark configurations.

ResNet-8 is the CIFAR ResNet-(6n+2) family with n=1 (stages 16/32/64, one basic block
each, 77,850 params at 10 classes); ResNet-18 the 4-stage, 2-block layout with a 3x3
stem (11,218,340 params at 100 classes).  GroupNorm takes BatchNorm's place, as in
the JAX package: batch statistics would be mutable state, biased under non-IID
clients.  The ResNets have no dropout.

Params are one flat dict in ravel order (``fc``, ``gn_stem``, ``s0b0`` ... ``s3b1``,
``stem``; inside a block ``conv1``, ``conv2``, ``gn1``, ``gn2``, ``proj``), so a
``[P]`` vector means the same coordinates as the JAX package's.  Each stage after the
first opens with a 3x3 stride-2 convolution under XLA's SAME padding (0 before, 1
after on an even size: :func:`nn.same_padding`).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from nanofed_tpu_torch import nn
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.models.base import Model, register_model
from nanofed_tpu_torch.utils.trees import flatten_with_names, unflatten_names


def _block_init(gen: torch.Generator, cin: int, cout: int) -> dict[str, Params]:
    p = {
        "conv1": nn.conv2d_init(gen, cin, cout, 3, use_bias=False),
        "gn1": nn.group_norm_init(cout, device=gen.device),
        "conv2": nn.conv2d_init(gen, cout, cout, 3, use_bias=False),
        "gn2": nn.group_norm_init(cout, device=gen.device),
    }
    if cin != cout:
        p["proj"] = nn.conv2d_init(gen, cin, cout, 1, use_bias=False)
    return p


def _block_apply(p: dict[str, Params], x: torch.Tensor, stride: int) -> torch.Tensor:
    out = nn.conv2d(p["conv1"], x, stride=stride, padding="SAME")
    out = nn.relu(nn.group_norm(p["gn1"], out))
    out = nn.conv2d(p["conv2"], out, stride=1, padding="SAME")
    out = nn.group_norm(p["gn2"], out)
    if "proj" in p:
        x = nn.conv2d(p["proj"], x, stride=stride, padding="SAME")
    return nn.relu(out + x)


def _resnet(
    name: str,
    stage_channels: Sequence[int],
    blocks_per_stage: int,
    num_classes: int,
    stem_channels: int,
) -> Model:
    def init(gen: torch.Generator) -> Params:
        layers: dict[str, Any] = {
            "stem": nn.conv2d_init(gen, 3, stem_channels, 3, use_bias=False),
            "gn_stem": nn.group_norm_init(stem_channels, device=gen.device),
        }
        cin = stem_channels
        for si, cout in enumerate(stage_channels):
            for bi in range(blocks_per_stage):
                layers[f"s{si}b{bi}"] = _block_init(gen, cin, cout)
                cin = cout
        layers["fc"] = nn.dense_init(gen, cin, num_classes)
        return flatten_with_names(layers)

    def apply(params: Params, x: torch.Tensor, *,
              dropout: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        p = unflatten_names(params)
        x = nn.conv2d(p["stem"], x, padding="SAME")
        x = nn.relu(nn.group_norm(p["gn_stem"], x))
        for si in range(len(stage_channels)):
            for bi in range(blocks_per_stage):
                stride = 2 if (si > 0 and bi == 0) else 1
                x = _block_apply(p[f"s{si}b{bi}"], x, stride)
        x = nn.global_avg_pool(x)
        return nn.log_softmax(nn.dense(p["fc"], x))

    return Model(name=name, init=init, apply=apply, input_shape=(32, 32, 3),
                 num_classes=num_classes)


@register_model("resnet8")
def resnet8(num_classes: int = 10) -> Model:
    """ResNet-8 for CIFAR-10 (the FedProx benchmark configuration)."""
    return _resnet("resnet8", (16, 32, 64), 1, num_classes, stem_channels=16)


@register_model("resnet18")
def resnet18(num_classes: int = 100) -> Model:
    """ResNet-18 for CIFAR-100 (the cross-silo benchmark configuration)."""
    return _resnet("resnet18", (64, 128, 256, 512), 2, num_classes, stem_channels=64)
