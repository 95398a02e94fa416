"""Exception hierarchy (counterpart of ``nanofed_tpu/core/exceptions.py``; the
classes this slice raises)."""

from __future__ import annotations


class NanoFedError(Exception):
    """Base error for the framework."""

