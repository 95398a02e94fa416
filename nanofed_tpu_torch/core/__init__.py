from nanofed_tpu_torch.core.device import resolve_device
from nanofed_tpu_torch.core.exceptions import AggregationError, NanoFedError, PrivacyError
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, Params

__all__ = [
    "AggregationError",
    "ClientData",
    "ClientMetrics",
    "NanoFedError",
    "Params",
    "PrivacyError",
    "resolve_device",
]
