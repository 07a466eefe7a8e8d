"""Internal subscription hooks with raw (key, row_dict, time, diff) signature."""

from __future__ import annotations

from typing import Callable

from .internals.parse_graph import G
from .internals.table import Table


def subscribe_raw(
    table: Table,
    on_change: Callable,
    on_time_end: Callable | None = None,
    on_end: Callable | None = None,
) -> None:
    G.add_subscription(
        {
            "table": table,
            "on_change": on_change,
            "on_time_end": on_time_end,
            "on_end": on_end,
        }
    )
