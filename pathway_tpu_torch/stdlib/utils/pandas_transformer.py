"""pandas_transformer (reference stdlib/utils/pandas_transformer.py):
run a pandas function over whole tables (batch escape hatch)."""

from __future__ import annotations

import functools
from typing import Any, Callable

from ...internals.schema import Schema
from ...internals.table import Table


def pandas_transformer(output_schema: type[Schema], output_universe: Any = None):
    """Decorator: the wrapped function receives pandas DataFrames (one per
    table argument) and returns a DataFrame matching output_schema.

    Executed eagerly at build time on the captured input tables —
    suitable for static/batch pipelines (as in the reference's tests)."""

    def decorator(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*tables: Table) -> Table:
            from ...debug import table_from_pandas, table_to_pandas

            dfs = [table_to_pandas(t, include_id=False) for t in tables]
            out = fn(*dfs)
            return table_from_pandas(out, schema=output_schema)

        return wrapper

    return decorator
