"""Exception hierarchy (counterpart of ``nanofed_tpu/core/exceptions.py``; the
classes the port raises so far)."""

from __future__ import annotations


class NanoFedError(Exception):
    """Base error for the framework."""


class AggregationError(NanoFedError):
    """Raised when aggregating client updates fails validation or math."""


class PrivacyError(NanoFedError):
    """Raised on privacy budget violations or invalid privacy configuration."""


class SecurityError(NanoFedError):
    """Raised on signing/verification or secure-aggregation failures."""


class CommunicationError(NanoFedError):
    """Raised by the optional HTTP transport layer."""


class CheckpointError(NanoFedError):
    """Raised on round-state checkpoint save/restore failures (and by the codec's
    structural checks, which share the checkpoint layout)."""
