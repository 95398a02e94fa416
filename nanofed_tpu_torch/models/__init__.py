from nanofed_tpu_torch.models import linear, mnist, resnet, transformer  # noqa: F401  (register)
from nanofed_tpu_torch.models.base import Model, get_model, list_models, register_model
from nanofed_tpu_torch.models.resnet import resnet8, resnet18
from nanofed_tpu_torch.models.transformer import flagship, transformer_lm, transformer_lm_scan

__all__ = [
    "Model", "flagship", "get_model", "list_models", "register_model", "resnet8", "resnet18",
    "transformer_lm", "transformer_lm_scan",
]
