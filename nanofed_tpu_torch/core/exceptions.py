"""Exception hierarchy (counterpart of ``nanofed_tpu/core/exceptions.py``; the
classes the port raises so far)."""

from __future__ import annotations


class NanoFedError(Exception):
    """Base error for the framework."""


class AggregationError(NanoFedError):
    """Raised when aggregating client updates fails validation or math."""


class PrivacyError(NanoFedError):
    """Raised on privacy budget violations or invalid privacy configuration."""
