"""Column helpers (reference stdlib/utils/col.py)."""

from __future__ import annotations

from typing import Any

from ...internals import dtype as dt
from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table


def unpack_col(
    column: ColumnExpression,
    *unpacked_columns: str | ColumnReference,
    schema: Any = None,
) -> Table:
    """Unpack a tuple column into separate columns."""
    table = _table_of(column)
    if schema is not None:
        names = list(schema.column_names())
        dtypes = schema.dtypes()
    else:
        names = [
            c._name if isinstance(c, ColumnReference) else str(c)
            for c in unpacked_columns
        ]
        dtypes = {n: dt.ANY for n in names}
        base = column._dtype
        if isinstance(base, dt.Tuple) and base.args is not Ellipsis:
            for i, n in enumerate(names):
                if i < len(base.args):
                    dtypes[n] = base.args[i]
    kwargs = {n: column[i] for i, n in enumerate(names)}
    from ...internals.expression import DeclareTypeExpression

    kwargs = {n: DeclareTypeExpression(dtypes[n], e) for n, e in kwargs.items()}
    return table.select(**kwargs)


def _table_of(expr: ColumnExpression) -> Table:
    found: list[Table] = []

    def visit(e):
        if isinstance(e, ColumnReference) and isinstance(e._table, Table):
            found.append(e._table)

    from ...internals.graph_runner import walk_expression

    walk_expression(expr, visit)
    if not found:
        raise ValueError("cannot determine source table of expression")
    return found[0]


def groupby_reduce_majority(column: ColumnReference, majority_of: ColumnReference):
    table = column._table
    counted = table.groupby(column, majority_of).reduce(
        column, majority_of, _pw_count=_count_reducer()
    )
    from ... import reducers as red
    from ...internals.thisclass import this

    return counted.groupby(counted[column._name]).reduce(
        counted[column._name],
        majority=red.argmax(counted._pw_count),
    )


def _count_reducer():
    from ... import reducers as red

    return red.count()


def flatten_column(
    column: ColumnReference,
    origin_id: str | ColumnReference | None = "origin_id",
) -> Table:
    """Deprecated: use ``pw.Table.flatten`` (reference col.py:16).
    Flattens ``column``, spreading the table's other columns, with the
    source row's id stored under ``origin_id``."""
    import warnings

    warnings.warn(
        "flatten_column is deprecated, use pw.Table.flatten instead",
        DeprecationWarning,
    )
    name = origin_id._name if isinstance(origin_id, ColumnReference) else origin_id
    return column._table.flatten(column, origin_id=name)


def unpack_col_dict(column: ColumnExpression, schema: Any) -> Table:
    """Extract typed columns out of a JSON-object column by schema
    (reference col.py:143): each schema field becomes a column; missing
    fields yield None (declare them Optional)."""
    from ... import apply_with_type
    from ...engine.value import Json

    table = _table_of(column)
    dtypes = schema.dtypes()

    def getter(field, target):
        conv = dt.unoptionalize(target)

        def get(j, _f=field, _c=conv):
            v = j.value if isinstance(j, Json) else j
            if not isinstance(v, dict):
                # non-object JSON cell (list/str/number): no fields to
                # extract — degrade like a missing field, don't crash
                return None
            v = v.get(_f)
            if isinstance(v, Json):
                v = v.value
            if v is None:
                return None
            if _c is dt.FLOAT:
                return float(v)
            if _c is dt.INT and not isinstance(v, bool):
                return int(v)
            return v

        return get

    return table.select(
        **{
            n: apply_with_type(getter(n, d), d, column)
            for n, d in dtypes.items()
        }
    )


def multiapply_all_rows(
    *cols: ColumnReference,
    fun: Any,
    result_col_names: list,
) -> Table:
    """Apply ``fun`` to entire columns at once (all rows gathered to one
    accumulator), producing ``len(result_col_names)`` output columns
    re-keyed to the original rows (reference col.py:211). Meant for
    small tables / infrequent whole-table transforms."""
    import pathway_tpu_torch as pw

    assert cols, "multiapply_all_rows needs at least one column"
    table = cols[0]._table
    names = [
        c._name if isinstance(c, ColumnReference) else str(c)
        for c in result_col_names
    ]

    packed = table.select(_pw_row=pw.make_tuple(table.id, *cols))
    gathered = packed.reduce(rows=pw.reducers.sorted_tuple(packed._pw_row))

    def compute(rows):
        ids = [r[0] for r in rows]
        ins = [list(col) for col in zip(*(r[1:] for r in rows))]
        outs = fun(*ins)
        return tuple((i, *vals) for i, vals in zip(ids, zip(*outs)))

    expanded = gathered.select(out=pw.apply(compute, pw.this.rows))
    flat = expanded.flatten(pw.this.out)
    keyed = flat.with_id(
        pw.declare_type(dt.POINTER, flat.out[0])
    )
    return keyed.select(
        **{n: pw.this.out[i + 1] for i, n in enumerate(names)}
    )


def apply_all_rows(
    *cols: ColumnReference,
    fun: Any,
    result_col_name: str,
) -> Table:
    """Single-output form of :func:`multiapply_all_rows` (reference
    col.py:168)."""
    return multiapply_all_rows(
        *cols,
        fun=lambda *ins: (fun(*ins),),
        result_col_names=[result_col_name],
    )
