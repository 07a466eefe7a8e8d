"""pw.io.subscribe (reference python/pathway/io/_subscribe.py)."""

from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable

from ..internals.parse_graph import G
from ..internals.table import Table


@runtime_checkable
class OnChangeCallback(Protocol):
    """Signature expected by ``pw.io.subscribe``'s ``on_change``."""

    def __call__(
        self, key: Any, row: dict, time: int, is_addition: bool
    ) -> Any: ...


@runtime_checkable
class OnFinishCallback(Protocol):
    """Signature expected by ``pw.io.subscribe``'s ``on_end``."""

    def __call__(self) -> Any: ...


def subscribe(
    table: Table,
    on_change: Callable | None = None,
    on_end: Callable | None = None,
    on_time_end: Callable | None = None,
    *,
    name: str | None = None,
    sort_by=None,
) -> None:
    """Register callbacks fired on every change of the table:

        on_change(key, row: dict, time: int, is_addition: bool)
    """

    def change_adapter(key, row, time, diff):
        if on_change is not None:
            on_change(key=key, row=row, time=time, is_addition=diff > 0)

    G.add_subscription(
        {
            "table": table,
            "on_change": change_adapter if on_change else None,
            "on_time_end": on_time_end,
            "on_end": on_end,
        }
    )
