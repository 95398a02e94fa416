from nanofed_tpu_torch.models import linear, mnist, resnet, transformer  # noqa: F401  (register)
from nanofed_tpu_torch.models.base import Model, get_model, list_models, register_model
from nanofed_tpu_torch.models.mnist import mnist_cnn
from nanofed_tpu_torch.models.resnet import resnet8, resnet18
from nanofed_tpu_torch.models.transformer import (
    flagship,
    stack_blocks,
    transformer_lm,
    transformer_lm_scan,
    unstack_blocks,
)

__all__ = [
    "Model", "flagship", "get_model", "list_models", "mnist_cnn", "register_model",
    "resnet8", "resnet18", "stack_blocks", "transformer_lm", "transformer_lm_scan",
    "unstack_blocks",
]
