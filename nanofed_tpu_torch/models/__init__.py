from nanofed_tpu_torch.models import mnist  # noqa: F401  (registers mnist_cnn)
from nanofed_tpu_torch.models.base import Model, get_model, register_model

__all__ = ["Model", "get_model", "register_model"]
