"""pw.stdlib.ordered (reference stdlib/ordered/diff.py)."""

from __future__ import annotations

from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table
from ...internals.thisclass import this


def diff(
    table: Table,
    timestamp: ColumnExpression,
    *values: ColumnReference,
    instance: ColumnExpression | None = None,
) -> Table:
    """Compute deltas of `values` vs the previous row in `timestamp`
    order (reference Table.diff). Uses sort + prev pointers."""
    sorted_t = table.sort(timestamp, instance=instance)
    from ...internals.table import _resolve_this

    kwargs = {}
    for v in values:
        v = _resolve_this(v, table)
        name = f"diff_{v._name}" if len(values) > 1 else f"diff_{v._name}"
        prev_val = table.ix(sorted_t.prev, optional=True)[v._name]
        kwargs[name] = v - prev_val
    return table.select(**kwargs)


__all__ = ["diff"]
