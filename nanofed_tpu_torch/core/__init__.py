from nanofed_tpu_torch.core.device import resolve_device
from nanofed_tpu_torch.core.exceptions import (
    AggregationError,
    CheckpointError,
    CommunicationError,
    ModelManagerError,
    NanoFedError,
    PrivacyError,
    SecurityError,
)
from nanofed_tpu_torch.core.types import (
    ClientData,
    ClientMetrics,
    ClientUpdates,
    ModelUpdate,
    ModelVersion,
    Params,
)

__all__ = [
    "AggregationError",
    "CheckpointError",
    "ClientData",
    "ClientMetrics",
    "ClientUpdates",
    "CommunicationError",
    "ModelManagerError",
    "ModelUpdate",
    "ModelVersion",
    "NanoFedError",
    "Params",
    "PrivacyError",
    "SecurityError",
    "resolve_device",
]
