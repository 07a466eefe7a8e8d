"""pw.stdlib.stateful (reference stdlib/stateful/deduplicate.py)."""

from __future__ import annotations

from typing import Any, Callable

from ...internals.expression import ColumnExpression
from ...internals.table import Table


def deduplicate(
    table: Table,
    *,
    col: ColumnExpression,
    instance: ColumnExpression | None = None,
    acceptor: Callable[[Any, Any], bool],
    name: str | None = None,
) -> Table:
    """Keep the previously accepted row per instance unless acceptor(new,
    old) accepts the new value (reference stateful/deduplicate.py →
    Graph::deduplicate)."""
    return table.deduplicate(value=col, instance=instance, acceptor=acceptor, name=name)


__all__ = ["deduplicate"]
