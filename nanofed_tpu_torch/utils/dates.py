"""UTC time helper (a copy of ``nanofed_tpu/utils/dates.py``)."""

from __future__ import annotations

from datetime import datetime, timezone


def get_current_time() -> datetime:
    """Timezone-aware UTC now."""
    return datetime.now(timezone.utc)
