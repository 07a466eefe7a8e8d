"""Wall-clock bucketing helpers (behavior parity:
reference stdlib/utils/bucketing.py)."""

from __future__ import annotations

import datetime


def truncate_to_minutes(time: datetime.datetime) -> datetime.datetime:
    """Floor a timestamp to its minute: the seconds and microseconds are
    zeroed, everything else (including tzinfo) is kept."""
    return time.replace(second=0, microsecond=0)
