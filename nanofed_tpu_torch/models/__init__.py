from nanofed_tpu_torch.models import linear, mnist  # noqa: F401  (register the models)
from nanofed_tpu_torch.models.base import Model, get_model, register_model

__all__ = ["Model", "get_model", "register_model"]
