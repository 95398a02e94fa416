from nanofed_tpu_torch.core.device import resolve_device
from nanofed_tpu_torch.core.exceptions import (
    AggregationError,
    CheckpointError,
    CommunicationError,
    ModelManagerError,
    NanoFedError,
    PrivacyError,
    SecurityError,
    TrainingError,
    ValidationError,
)
from nanofed_tpu_torch.core.interfaces import (
    AggregatorProtocol,
    CoordinatorProtocol,
    LocalFitFn,
    ModelManagerProtocol,
    ModelProtocol,
    ServerProtocol,
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
    "AggregatorProtocol",
    "CheckpointError",
    "ClientData",
    "ClientMetrics",
    "ClientUpdates",
    "CommunicationError",
    "CoordinatorProtocol",
    "LocalFitFn",
    "ModelManagerError",
    "ModelManagerProtocol",
    "ModelProtocol",
    "ModelUpdate",
    "ModelVersion",
    "NanoFedError",
    "Params",
    "PrivacyError",
    "SecurityError",
    "ServerProtocol",
    "TrainingError",
    "ValidationError",
    "resolve_device",
]
