from nanofed_tpu_torch.core.device import resolve_device
from nanofed_tpu_torch.core.exceptions import (
    AggregationError,
    CheckpointError,
    CommunicationError,
    NanoFedError,
    PrivacyError,
    SecurityError,
)
from nanofed_tpu_torch.core.types import (
    ClientData,
    ClientMetrics,
    ClientUpdates,
    ModelUpdate,
    Params,
)

__all__ = [
    "AggregationError",
    "CheckpointError",
    "ClientData",
    "ClientMetrics",
    "ClientUpdates",
    "CommunicationError",
    "ModelUpdate",
    "NanoFedError",
    "Params",
    "PrivacyError",
    "SecurityError",
    "resolve_device",
]
