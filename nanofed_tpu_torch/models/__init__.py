from nanofed_tpu_torch.models import linear, mnist, resnet  # noqa: F401  (register the models)
from nanofed_tpu_torch.models.base import Model, get_model, list_models, register_model
from nanofed_tpu_torch.models.resnet import resnet8, resnet18

__all__ = ["Model", "get_model", "list_models", "register_model", "resnet8", "resnet18"]
