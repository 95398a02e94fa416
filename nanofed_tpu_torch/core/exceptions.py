"""Exception hierarchy (counterpart of ``nanofed_tpu/core/exceptions.py``)."""

from __future__ import annotations


class NanoFedError(Exception):
    """Base error for the framework."""


class AggregationError(NanoFedError):
    """Raised when aggregating client updates fails validation or math."""


class ModelManagerError(NanoFedError):
    """Raised on model versioning/persistence failures."""


class TrainingError(NanoFedError):
    """Raised when local training cannot proceed (bad shapes, empty data)."""


class PrivacyError(NanoFedError):
    """Raised on privacy budget violations or invalid privacy configuration."""


class ValidationError(NanoFedError):
    """Raised when a client update fails integrity/sanity validation."""


class SecurityError(NanoFedError):
    """Raised on signing/verification or secure-aggregation failures."""


class CommunicationError(NanoFedError):
    """Raised by the optional HTTP transport layer."""


class CheckpointError(NanoFedError):
    """Raised on round-state checkpoint save/restore failures (and by the codec's
    structural checks, which share the checkpoint layout)."""
