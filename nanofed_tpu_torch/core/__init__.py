from nanofed_tpu_torch.core.device import resolve_device
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params

__all__ = [
    "ClientData",
    "ClientMetrics",
    "NanoFedError",
    "Params",
    "resolve_device",
]
