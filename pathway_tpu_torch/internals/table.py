"""User-facing Table DSL.

Rebuild of upstream Pathway's python/pathway/internals/table.py (2,675 LoC:
select :382, filter :490, groupby :942, reduce :1025, ix :1164, concat
:1334, update_rows :1524, flatten :2089, sort :2157) plus groupbys.py and
joins.py. Tables are lazy: each operation appends a logical operator to
the global parse graph; pw.run()/debug helpers compile it onto the engine
(internals/graph_runner.py)."""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Mapping

from . import dtype as dt
from .expression import (
    ColumnExpression,
    ColumnReference,
    ConstColumnExpression,
    IxExpression,
    PointerExpression,
    ReducerExpression,
    smart_wrap,
)
from .schema import ColumnDefinition, Schema, SchemaMetaclass, schema_builder
from .thisclass import ThisMetaclass, left as left_cls, right as right_cls, this as this_cls
from .trace import trace_user_frame
from .universe import Universe, universe_solver

_table_ids = itertools.count()


class Column:
    __slots__ = ("dtype", "append_only")

    def __init__(self, dtype: dt.DType, append_only: bool = False):
        self.dtype = dtype
        self.append_only = append_only


class LogicalOp:
    """A node of the logical parse graph (reference internals/operator.py)."""

    __slots__ = ("kind", "inputs", "params", "output", "trace")

    def __init__(self, kind: str, inputs: list["Table"], params: dict):
        self.kind = kind
        self.inputs = inputs
        self.params = params
        self.output: "Table | None" = None
        # the user's call site that built this operator (reference
        # internals/trace.py) — surfaced in engine errors + error logs
        from .trace import user_frame

        self.trace = user_frame()


class Table:
    def __init__(
        self,
        columns: Mapping[str, Column],
        universe: Universe,
        op: LogicalOp,
        name: str | None = None,
    ):
        self._columns = dict(columns)
        self._universe = universe
        self._op = op
        op.output = self
        self._id = next(_table_ids)
        self._name = name or f"table_{self._id}"
        # rows of this table are only ever added, never deleted (the
        # universe-level half of the append-only property; the per-value
        # half lives on Column.append_only). Construction sites that can
        # prove it set this after building the table; everything else
        # stays conservatively False.
        self._universe_append_only = False
        from .parse_graph import G

        G.register(self)

    # ---- column access ----

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        columns = self.__dict__.get("_columns")
        if columns is not None and name in columns:
            return ColumnReference(self, name)
        if name.startswith("_"):
            raise AttributeError(name)
        raise AttributeError(
            f"Table has no column {name!r}; columns: {list(columns or ())}"
        )

    def __getitem__(self, arg):
        if isinstance(arg, (list, tuple)):
            return [self[a] for a in arg]
        if isinstance(arg, ColumnReference):
            return ColumnReference(self, arg._name)
        return ColumnReference(self, arg)

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    @property
    def schema(self) -> type[Schema]:
        return schema_builder(
            {n: ColumnDefinition(dtype=c.dtype) for n, c in self._columns.items()},
            name=f"{self._name}_schema",
        )

    @property
    def is_append_only(self) -> bool:
        """True when the whole table's update stream is insert-only: no
        row deletions (universe level) and no value changes (every
        column). Sinks and the engine's epoch consolidation skip
        retraction bookkeeping for such tables (reference analogue:
        internals/column_properties.py append_only tracking)."""
        return self._universe_append_only and all(
            c.append_only for c in self._columns.values()
        )

    def column_names(self) -> list[str]:
        return list(self._columns.keys())

    def keys(self) -> list[str]:
        return list(self._columns.keys())

    def typehints(self) -> dict[str, Any]:
        return {n: c.dtype.to_python_type() for n, c in self._columns.items()}

    def __repr__(self):
        cols = ", ".join(f"{n}: {c.dtype}" for n, c in self._columns.items())
        return f"<pw.Table {self._name}({cols})>"

    # ---- core relational ops ----

    @trace_user_frame
    def select(self, *args: ColumnReference, **kwargs: Any) -> "Table":
        exprs = _named_exprs(self, args, kwargs)
        ao = self._universe_append_only
        cols = {
            n: Column(e._dtype, append_only=ao and _expr_append_only(e))
            for n, e in exprs.items()
        }
        op = LogicalOp("select", [self], {"exprs": exprs})
        out = Table(cols, self._universe, op, name=f"{self._name}.select")
        out._universe_append_only = ao
        return out

    @trace_user_frame
    def with_columns(self, *args: ColumnReference, **kwargs: Any) -> "Table":
        exprs = _named_exprs(self, args, kwargs)
        all_exprs: dict[str, ColumnExpression] = {
            n: ColumnReference(self, n) for n in self._columns
        }
        all_exprs.update(exprs)
        ao = self._universe_append_only
        cols = {
            n: Column(e._dtype, append_only=ao and _expr_append_only(e))
            for n, e in all_exprs.items()
        }
        op = LogicalOp("select", [self], {"exprs": all_exprs})
        out = Table(cols, self._universe, op, name=f"{self._name}.with_columns")
        out._universe_append_only = ao
        return out

    def __add__(self, other: "Table") -> "Table":
        """Concatenate columns of two same-universe tables (reference
        table.py `Table.__add__`); columns of `other` take precedence."""
        if not isinstance(other, Table):
            return NotImplemented
        if not universe_solver.query_are_equal(self._universe, other._universe):
            raise ValueError(
                "Table.__add__ requires tables with the same universe; "
                "use .with_universe_of() or a join for unrelated tables"
            )
        exprs: dict[str, ColumnExpression] = {
            n: ColumnReference(self, n) for n in self._columns
        }
        exprs.update({n: ColumnReference(other, n) for n in other._columns})
        ao = self._universe_append_only and other._universe_append_only
        cols = {
            n: Column(e._dtype, append_only=ao and _expr_append_only(e))
            for n, e in exprs.items()
        }
        op = LogicalOp("concat_columns", [self, other], {"exprs": exprs})
        out = Table(cols, self._universe, op, name=f"{self._name}+")
        out._universe_append_only = ao
        return out

    @trace_user_frame
    def filter(self, filter_expression: ColumnExpression) -> "Table":
        expr = _resolve_this(smart_wrap(filter_expression), self)
        # an append-only predicate over append-only rows never flips, so
        # no filtered-in row is ever retracted
        ao = self._universe_append_only and _expr_append_only(expr)
        cols = {
            n: Column(c.dtype, append_only=ao and c.append_only)
            for n, c in self._columns.items()
        }
        op = LogicalOp("filter", [self], {"expr": expr})
        out = Table(cols, self._universe.subset(), op, name=f"{self._name}.filter")
        out._universe_append_only = ao
        return out

    def split(self, split_expression: ColumnExpression) -> tuple["Table", "Table"]:
        pos = self.filter(split_expression)
        from .expression import ColumnUnaryOpExpression

        neg = self.filter(ColumnUnaryOpExpression("~", split_expression))
        return pos, neg

    def copy(self) -> "Table":
        return self.select(*[ColumnReference(self, n) for n in self._columns])

    # ---- groupby / reduce ----

    @trace_user_frame
    def groupby(
        self,
        *args: ColumnReference,
        id: ColumnReference | None = None,
        sort_by: ColumnExpression | None = None,
        instance: ColumnReference | None = None,
        **kwargs,
    ) -> "GroupedTable":
        grouping = [_resolve_this(a, self) for a in args]
        if instance is not None:
            grouping.append(_resolve_this(instance, self))
        return GroupedTable(
            self,
            grouping,
            sort_by=_resolve_this(sort_by, self) if sort_by is not None else None,
            id_from=id,
        )

    @trace_user_frame
    def reduce(self, *args: ColumnReference, **kwargs: Any) -> "Table":
        return GroupedTable(self, [], sort_by=None, id_from=None).reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: ColumnExpression | None = None,
        instance: ColumnExpression | None = None,
        acceptor: Callable[[Any, Any], bool] | None = None,
        persistent_id: str | None = None,
        name: str | None = None,
    ) -> "Table":
        value = _resolve_this(value, self) if value is not None else None
        instance = _resolve_this(instance, self) if instance is not None else None
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp(
            "deduplicate",
            [self],
            {"value": value, "instance": instance, "acceptor": acceptor},
        )
        return Table(cols, Universe(), op, name=f"{self._name}.deduplicate")

    # ---- joins ----

    @trace_user_frame
    def join(
        self,
        other: "Table",
        *on: ColumnExpression,
        id: ColumnReference | None = None,
        how: "JoinMode | str" = "inner",
        left_instance: ColumnReference | None = None,
        right_instance: ColumnReference | None = None,
    ) -> "JoinResult":
        how = getattr(how, "value", how)
        on = list(on)
        if left_instance is not None and right_instance is not None:
            on.append(left_instance == right_instance)
        return JoinResult(self, other, on, how=str(how), id_from=id)

    def join_inner(self, other, *on, **kw) -> "JoinResult":
        return self.join(other, *on, how="inner", **kw)

    def join_left(self, other, *on, **kw) -> "JoinResult":
        return self.join(other, *on, how="left", **kw)

    def join_right(self, other, *on, **kw) -> "JoinResult":
        return self.join(other, *on, how="right", **kw)

    def join_outer(self, other, *on, **kw) -> "JoinResult":
        return self.join(other, *on, how="outer", **kw)

    # ---- set-like ops ----

    @trace_user_frame
    def concat(self, *others: "Table") -> "Table":
        tables = [self, *others]
        cols = _common_columns(tables)
        op = LogicalOp("concat", tables, {})
        out = Table(cols, Universe(), op, name=f"{self._name}.concat")
        out._universe_append_only = all(t._universe_append_only for t in tables)
        return out

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *others]
        cols = _common_columns(tables)
        op = LogicalOp("concat_reindex", tables, {})
        out = Table(cols, Universe(), op, name=f"{self._name}.concat_reindex")
        out._universe_append_only = all(t._universe_append_only for t in tables)
        return out

    def update_rows(self, other: "Table") -> "Table":
        cols = {}
        for n, c in self._columns.items():
            oc = other._columns.get(n)
            cols[n] = Column(dt.lub(c.dtype, oc.dtype) if oc else c.dtype)
        op = LogicalOp("update_rows", [self, other], {})
        u = Universe()
        universe_solver.register_subset(self._universe, u)
        universe_solver.register_subset(other._universe, u)
        return Table(cols, u, op, name=f"{self._name}.update_rows")

    def update_cells(self, other: "Table") -> "Table":
        cols = {}
        for n, c in self._columns.items():
            oc = other._columns.get(n)
            cols[n] = Column(dt.lub(c.dtype, oc.dtype) if oc else c.dtype)
        op = LogicalOp("update_cells", [self, other], {})
        return Table(cols, self._universe, op, name=f"{self._name}.update_cells")

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def intersect(self, *others: "Table") -> "Table":
        # an intersection row appears once every input has it and — with
        # all inputs append-only — is never taken back
        ao = self._universe_append_only and all(
            t._universe_append_only for t in others
        )
        cols = {
            n: Column(c.dtype, append_only=ao and c.append_only)
            for n, c in self._columns.items()
        }
        op = LogicalOp("intersect", [self, *others], {})
        out = Table(cols, self._universe.subset(), op, name=f"{self._name}.intersect")
        out._universe_append_only = ao
        return out

    def difference(self, other: "Table") -> "Table":
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp("difference", [self, other], {})
        return Table(cols, self._universe.subset(), op, name=f"{self._name}.difference")

    def restrict(self, other: "Table") -> "Table":
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp("intersect", [self, other], {})
        return Table(cols, other._universe, op, name=f"{self._name}.restrict")

    def having(self, *indexers: ColumnReference) -> "Table":
        result = self
        for indexer in indexers:
            tmp = indexer._table.select(_pw_key=indexer)
            keys_tab = tmp.with_id(tmp["_pw_key"])
            result = result.intersect(keys_tab)
        return result

    def with_universe_of(self, other: "Table") -> "Table":
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp("with_universe_of", [self, other], {})
        return Table(cols, other._universe, op, name=f"{self._name}.with_universe_of")

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column: ColumnReference,
        value_column: ColumnReference,
        upper_column: ColumnReference,
    ) -> "Table":
        """Attach column ``apx_value`` carrying threshold_table's value
        column, updated only when it leaves the previous [lower, upper]
        band (reference Table._gradual_broadcast internals/table.py:631,
        engine operators/gradual_broadcast.rs R15)."""
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        from . import dtype as dt

        cols["apx_value"] = Column(dt.ANY)
        op = LogicalOp(
            "gradual_broadcast",
            [self, threshold_table],
            {
                "lower": lower_column._name,
                "value": value_column._name,
                "upper": upper_column._name,
            },
        )
        return Table(cols, self._universe, op, name=f"{self._name}.gradual_broadcast")

    # ---- schema / column manipulation ----

    def rename(self, names_mapping: Mapping | None = None, **kwargs) -> "Table":
        if names_mapping is not None:
            mapping = {
                (k._name if isinstance(k, ColumnReference) else k): (
                    v._name if isinstance(v, ColumnReference) else v
                )
                for k, v in names_mapping.items()
            }
            return self.rename_by_dict(mapping)
        return self.rename_columns(**kwargs)

    def rename_columns(self, **kwargs) -> "Table":
        # new_name=old_column
        mapping = {
            (v._name if isinstance(v, ColumnReference) else v): k
            for k, v in kwargs.items()
        }
        return self.rename_by_dict(mapping)

    def rename_by_dict(self, names_mapping: Mapping[str, str]) -> "Table":
        exprs = {}
        for n in self._columns:
            new = names_mapping.get(n, n)
            exprs[new] = ColumnReference(self, n)
        return self.select(**exprs)

    def without(self, *columns) -> "Table":
        names = {c._name if isinstance(c, ColumnReference) else c for c in columns}
        return self.select(
            **{n: ColumnReference(self, n) for n in self._columns if n not in names}
        )

    def cast_to_types(self, **kwargs) -> "Table":
        from .expression import CastExpression

        exprs: dict[str, ColumnExpression] = {
            n: ColumnReference(self, n) for n in self._columns
        }
        for n, t in kwargs.items():
            exprs[n] = CastExpression(t, ColumnReference(self, n))
        return self.select(**exprs)

    def update_types(self, **kwargs) -> "Table":
        from .expression import DeclareTypeExpression

        exprs: dict[str, ColumnExpression] = {
            n: ColumnReference(self, n) for n in self._columns
        }
        for n, t in kwargs.items():
            exprs[n] = DeclareTypeExpression(t, ColumnReference(self, n))
        return self.select(**exprs)

    def update_id_type(self, id_type, *, id_append_only: bool | None = None) -> "Table":
        """Declare the type of ``self.id`` (reference table.py:2003). The
        engine keys rows by 128-bit pointers regardless, so this is a
        schema-level declaration: it validates the type is a Pointer and
        re-registers the table with the declared id dtype."""
        wrapped = dt.wrap(id_type)
        if not isinstance(wrapped, dt.Pointer):
            raise TypeError(
                f"update_id_type() expects a Pointer type, got {wrapped!r}"
            )
        out = self.copy()
        out._id_dtype = wrapped
        if id_append_only is not None:
            out._id_append_only = id_append_only
        return out

    @property
    def slice(self) -> "TableSlice":
        """A manipulable collection of references to this table's columns
        (reference table.py:468 / table_slice.py)."""
        from .table_slice import TableSlice

        return TableSlice(
            {n: ColumnReference(self, n) for n in self._columns}, self
        )

    def with_prefix(self, prefix: str) -> "Table":
        """Rename all columns by prepending ``prefix`` (reference
        table.py:1850)."""
        return self.rename_by_dict({n: prefix + n for n in self._columns})

    def with_suffix(self, suffix: str) -> "Table":
        """Rename all columns by appending ``suffix`` (reference
        table.py:1872)."""
        return self.rename_by_dict({n: n + suffix for n in self._columns})

    def remove_errors(self) -> "Table":
        """Filter out rows in which any column holds the ERROR value
        (reference table.py:2491). Use with
        ``pw.run(terminate_on_error=False)``."""
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp("remove_errors", [self], {})
        return Table(
            cols, self._universe.subset(), op, name=f"{self._name}.remove_errors"
        )

    def live(self):
        """An interactively updating view of this table (reference
        table.py:2565; experimental there too)."""
        from .interactive import LiveTable

        return LiveTable.from_table(self)

    # ---- re-keying ----

    def with_id(self, new_index: ColumnReference) -> "Table":
        expr = _resolve_this(new_index, self)
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp("reindex", [self], {"expr": expr})
        return Table(cols, Universe(), op, name=f"{self._name}.with_id")

    def with_id_from(self, *args, instance: ColumnExpression | None = None) -> "Table":
        exprs = [_resolve_this(smart_wrap(a), self) for a in args]
        if instance is not None:
            exprs.append(_resolve_this(smart_wrap(instance), self))
        ptr = PointerExpression(self, *exprs)
        cols = {n: Column(c.dtype) for n, c in self._columns.items()}
        op = LogicalOp("reindex", [self], {"expr": _resolve_this(ptr, self)})
        return Table(cols, Universe(), op, name=f"{self._name}.with_id_from")

    def pointer_from(self, *args, optional: bool = False, instance=None) -> PointerExpression:
        return PointerExpression(
            self,
            *[_resolve_this(smart_wrap(a), self) for a in args],
            optional=optional,
            instance=instance,
        )

    # ---- flatten / sort / misc ----

    @trace_user_frame
    def flatten(self, to_flatten: ColumnReference, *, origin_id: str | None = None) -> "Table":
        ref = _resolve_this(to_flatten, self)
        assert isinstance(ref, ColumnReference)
        cols = {}
        for n, c in self._columns.items():
            if n == ref._name:
                base = c.dtype
                if isinstance(base, dt.List):
                    cols[n] = Column(base.wrapped)
                elif isinstance(base, dt.Tuple):
                    cols[n] = Column(dt.ANY)
                elif base is dt.STR:
                    cols[n] = Column(dt.STR)
                elif isinstance(base, dt.Array):
                    cols[n] = Column(base.strip_dimension())
                else:
                    cols[n] = Column(dt.ANY)
            else:
                cols[n] = Column(c.dtype)
        if origin_id is not None:
            cols[origin_id] = Column(dt.POINTER)
        op = LogicalOp(
            "flatten", [self], {"column": ref._name, "origin_id": origin_id}
        )
        return Table(cols, Universe(), op, name=f"{self._name}.flatten")

    @trace_user_frame
    def sort(
        self,
        key: ColumnExpression,
        instance: ColumnExpression | None = None,
    ) -> "Table":
        key = _resolve_this(smart_wrap(key), self)
        instance = _resolve_this(smart_wrap(instance), self) if instance is not None else None
        cols = {
            "prev": Column(dt.Optional(dt.POINTER)),
            "next": Column(dt.Optional(dt.POINTER)),
        }
        op = LogicalOp("sort", [self], {"key": key, "instance": instance})
        return Table(cols, self._universe, op, name=f"{self._name}.sort")

    def diff(self, timestamp: ColumnExpression, *values: ColumnReference, instance=None) -> "Table":
        from ..stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values, instance=instance)

    def ix(self, expression: ColumnExpression, *, optional: bool = False, context=None) -> "IxAppliedTable":
        return IxAppliedTable(self, expression, optional)

    def ix_ref(self, *args, optional: bool = False, instance=None, context=None) -> "IxAppliedTable":
        ptr = PointerExpression(self, *args, optional=optional, instance=instance)
        return IxAppliedTable(self, ptr, optional)

    def await_futures(self) -> "Table":
        return self.copy()

    def interpolate(self, timestamp, *values, mode=None):
        from ..stdlib.statistical import interpolate as _interp

        return _interp(self, timestamp, *values, mode=mode)

    # ---- temporal sugar (stdlib.temporal) ----

    @trace_user_frame
    def windowby(self, time_expr, *, window, behavior=None, instance=None, **kwargs):
        from ..stdlib.temporal import windowby as _windowby

        return _windowby(self, time_expr, window=window, behavior=behavior, instance=instance, **kwargs)

    def asof_join(self, other, self_time, other_time, *on, **kw):
        from ..stdlib.temporal import asof_join as _asof

        return _asof(self, other, self_time, other_time, *on, **kw)

    def asof_now_join(self, other, *on, **kw):
        from ..stdlib.temporal import asof_now_join as _asof_now

        return _asof_now(self, other, *on, **kw)

    def interval_join(self, other, self_time, other_time, interval, *on, **kw):
        from ..stdlib.temporal import interval_join as _ij

        return _ij(self, other, self_time, other_time, interval, *on, **kw)

    def window_join(self, other, self_time, other_time, window, *on, **kw):
        from ..stdlib.temporal import window_join as _wj

        return _wj(self, other, self_time, other_time, window, *on, **kw)

    # ---- static constructors ----

    @classmethod
    def empty(cls, **kwargs) -> "Table":
        cols = {n: Column(dt.wrap(t)) for n, t in kwargs.items()}
        op = LogicalOp("static", [], {"rows": []})
        return Table(cols, Universe(), op, name="empty")

    @classmethod
    def from_columns(cls, *args, **kwargs) -> "Table":
        raise NotImplementedError("use pw.debug.table_from_pandas")

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        universe_solver.register_as_equal(self._universe, other._universe)
        return self

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        universe_solver.register_subset(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        universe_solver.register_as_equal(self._universe, other._universe)
        return self

    def _ipython_display_(self):  # pragma: no cover
        from ..debug import compute_and_print

        compute_and_print(self)


class JoinMode:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class GroupedTable:
    """Result of Table.groupby (reference internals/groupbys.py)."""

    def __init__(
        self,
        table: Table,
        grouping: list[ColumnExpression],
        sort_by: ColumnExpression | None,
        id_from: ColumnReference | None,
    ):
        self._table = table
        self._grouping = grouping
        self._sort_by = sort_by
        self._id_from = id_from

    def reduce(self, *args: ColumnReference, **kwargs: Any) -> Table:
        exprs = _named_exprs(self._table, args, kwargs)
        cols = {n: Column(e._dtype) for n, e in exprs.items()}
        op = LogicalOp(
            "groupby_reduce",
            [self._table],
            {
                "grouping": self._grouping,
                "exprs": exprs,
                "sort_by": self._sort_by,
                "id_from": self._id_from,
            },
        )
        return Table(cols, Universe(), op, name=f"{self._table._name}.reduce")


class JoinResult:
    """Result of Table.join before .select (reference internals/joins.py)."""

    def __init__(
        self,
        left: Table,
        right: Table,
        on: list[ColumnExpression],
        how: str,
        id_from: ColumnReference | None,
    ):
        self._left = left
        self._right = right
        # pw.left/pw.right sentinels in the on-conditions resolve to the
        # join sides right away (lowering sees only concrete tables)
        self._on = [_resolve_join_this(c, self) for c in on]
        self._how = how
        self._id_from = id_from
        self._filters: list[ColumnExpression] = []

    def filter(self, expr: ColumnExpression) -> "JoinResult":
        out = JoinResult(self._left, self._right, self._on, self._how, self._id_from)
        out._filters = [*self._filters, expr]
        return out

    def select(self, *args: ColumnReference, **kwargs: Any) -> Table:
        exprs: dict[str, ColumnExpression] = {}
        for a in args:
            a = _resolve_join_this(a, self)
            if isinstance(a, list):
                for x in a:
                    exprs[x._name] = x
            else:
                if not isinstance(a, ColumnReference):
                    raise ValueError("positional select args must be column refs")
                exprs[a._name] = a
        for n, e in kwargs.items():
            exprs[n] = _resolve_join_this(smart_wrap(e), self)

        # outer hows null-extend a side: columns read purely from that
        # side become Optional (reference joins.py output typing)
        null_left = self._how in ("right", "outer")
        null_right = self._how in ("left", "outer")

        def out_dtype(e: ColumnExpression) -> dt.DType:
            d = e._dtype
            if isinstance(e, ColumnReference):
                if (e._table is self._right and null_right) or (
                    e._table is self._left and null_left
                ):
                    if not isinstance(d, dt.Optional) and d is not dt.ANY:
                        return dt.Optional(d)
            return d

        cols = {n: Column(out_dtype(e)) for n, e in exprs.items()}
        op = LogicalOp(
            "join_select",
            [self._left, self._right],
            {
                "on": self._on,
                "how": self._how,
                "id_from": self._id_from,
                "exprs": exprs,
                "filters": [_resolve_join_this(f, self) for f in self._filters],
            },
        )
        return Table(
            cols, Universe(), op, name=f"{self._left._name}_join_{self._right._name}"
        )

    def reduce(self, *args, **kwargs) -> Table:
        full = self.select(
            *[ColumnReference(self._left, n) for n in self._left._columns],
            **{
                n: ColumnReference(self._right, n)
                for n in self._right._columns
                if n not in self._left._columns
            },
        )
        return full.reduce(*args, **kwargs)


class IxAppliedTable:
    """`other.ix(keys)` proxy: attribute access yields IxExpressions
    evaluated via an engine-level lookup join."""

    def __init__(self, table: Table, keys_expr: ColumnExpression, optional: bool):
        self._ix_target = table
        self._keys_expr = keys_expr
        self._optional = optional

    def __getattr__(self, name: str) -> IxExpression:
        if name.startswith("__") or name in ("_ix_target", "_keys_expr", "_optional"):
            raise AttributeError(name)
        return IxExpression(self._ix_target, self._keys_expr, name, self._optional)

    def __getitem__(self, name: str) -> IxExpression:
        return IxExpression(self._ix_target, self._keys_expr, name, self._optional)

    @property
    def id(self) -> ColumnExpression:
        return self._keys_expr


class _DeferredIx:
    """pw.this.ix(...) — resolved when the context table is known."""

    def __init__(self, this_sentinel, expr, optional):
        self._sentinel = this_sentinel
        self._expr = expr
        self._optional = optional

    def __getattr__(self, name):
        if name.startswith("__") or name in ("_sentinel", "_expr", "_args", "_optional", "_instance"):
            raise AttributeError(name)
        return _DeferredIxCol(self, name)


class _DeferredIxRef:
    def __init__(self, this_sentinel, args, optional, instance):
        self._sentinel = this_sentinel
        self._args = args
        self._optional = optional
        self._instance = instance

    def __getattr__(self, name):
        if name.startswith("__") or name in ("_sentinel", "_expr", "_args", "_optional", "_instance"):
            raise AttributeError(name)
        return _DeferredIxCol(self, name)


class _DeferredIxCol(ColumnExpression):
    def __init__(self, parent, name):
        super().__init__()
        self._parent = parent
        self._col_name = name
        self._dtype = dt.ANY


# ---- desugaring helpers (reference internals/desugaring.py) ----


def _resolve_this(expr, table: Table):
    """Replace pw.this references by the context table."""
    if expr is None:
        return None
    if isinstance(expr, list):
        return [_resolve_this(e, table) for e in expr]
    if not isinstance(expr, ColumnExpression):
        return smart_wrap(expr)
    return _rewrite(expr, lambda t: table if isinstance(t, ThisMetaclass) else t)


def _resolve_join_this(expr, join: JoinResult):
    def map_table(t):
        if t is left_cls:
            return join._left
        if t is right_cls:
            return join._right
        if isinstance(t, ThisMetaclass):  # pw.this in join select: prefer left
            return join._left
        return t

    if not isinstance(expr, ColumnExpression):
        expr = smart_wrap(expr)
    if isinstance(expr, list):
        return [_rewrite(e, map_table) for e in expr]
    return _rewrite(expr, map_table)


def _rewrite(expr: ColumnExpression, map_table: Callable):
    """Rebuild an expression tree with tables remapped."""
    import copy as _copy

    if isinstance(expr, ColumnReference):
        new_table = map_table(expr._table)
        if new_table is not expr._table:
            return ColumnReference(new_table, expr._name)
        return expr
    if isinstance(expr, IxExpression):
        new_keys = _rewrite(expr._keys_expr, map_table)
        new_target = map_table(expr._ix_table)
        if new_keys is not expr._keys_expr or new_target is not expr._ix_table:
            return IxExpression(new_target, new_keys, expr._name, expr._optional)
        return expr
    if isinstance(expr, _DeferredIxCol):
        parent = expr._parent
        target = map_table(parent._sentinel)
        if isinstance(target, ThisMetaclass):
            return expr
        if isinstance(parent, _DeferredIx):
            keys = _rewrite(smart_wrap(parent._expr), map_table)
            return IxExpression(target, keys, expr._col_name, parent._optional)
        else:
            args = [_rewrite(smart_wrap(a), map_table) for a in parent._args]
            ptr = PointerExpression(target, *args, optional=parent._optional, instance=parent._instance)
            return IxExpression(target, ptr, expr._col_name, parent._optional)
    # generic: shallow-copy and rewrite child links
    deps = expr._deps
    if not deps:
        return expr
    new = _copy.copy(expr)
    changed = False
    for attr in ("_left", "_right", "_expr", "_if", "_then", "_else", "_val",
                 "_index", "_default", "_replacement", "_keys_expr"):
        if hasattr(new, attr):
            child = getattr(new, attr)
            if isinstance(child, ColumnExpression):
                nc = _rewrite(child, map_table)
                if nc is not child:
                    setattr(new, attr, nc)
                    changed = True
    for attr in ("_args",):
        if hasattr(new, attr):
            children = getattr(new, attr)
            if isinstance(children, list):
                ncs = [
                    _rewrite(c, map_table) if isinstance(c, ColumnExpression) else c
                    for c in children
                ]
                if any(a is not b for a, b in zip(ncs, children)):
                    setattr(new, attr, ncs)
                    changed = True
    if hasattr(new, "_kwargs") and isinstance(new._kwargs, dict):
        nk = {}
        kchanged = False
        for k, v in new._kwargs.items():
            if isinstance(v, ColumnExpression):
                nv = _rewrite(v, map_table)
                kchanged = kchanged or nv is not v
                nk[k] = nv
            else:
                nk[k] = v
        if kchanged:
            new._kwargs = nk
            changed = True
    if changed:
        new._refresh_dtype()
    return new if changed else expr


def _expr_append_only(e: ColumnExpression) -> bool:
    """Is the value stream produced by this expression insert-only?

    Holds when every column it reads is append-only (so no operand is
    ever retracted) and the computation is deterministic (a
    non-deterministic UDF re-run on replay could change history).
    Constants are trivially append-only."""
    from .expression import ApplyExpression, ColumnReference, IxExpression

    if isinstance(e, IxExpression):
        # ix lowers to a join against another table whose later updates
        # retract and re-emit the looked-up value; _deps only carries the
        # key expression, so answer for the hidden table conservatively
        return False
    if isinstance(e, ColumnReference):
        tab = e._table
        if not isinstance(tab, Table):
            return False  # unresolved pw.this — resolver re-checks later
        if e._name == "id":
            return tab._universe_append_only
        col = tab._columns.get(e._name)
        return col.append_only if col is not None else False
    if isinstance(e, ApplyExpression) and not e._deterministic:
        return False
    return all(_expr_append_only(d) for d in e._deps)


def _named_exprs(table: Table, args, kwargs) -> dict[str, ColumnExpression]:
    from .thisclass import _WithoutSpec

    exprs: dict[str, ColumnExpression] = {}
    for a in args:
        if isinstance(a, _WithoutSpec):
            skip = set(a.columns)
            for n in table._columns:
                if n not in skip:
                    exprs[n] = ColumnReference(table, n)
            continue
        if isinstance(a, ThisMetaclass) or a is this_cls:
            for n in table._columns:
                exprs[n] = ColumnReference(table, n)
            continue
        a = _resolve_this(a, table)
        if isinstance(a, list):
            for x in a:
                exprs[x._name] = x
            continue
        if not isinstance(a, ColumnReference):
            raise ValueError(
                "positional arguments to select() must be column references"
            )
        exprs[a._name] = a
    for n, e in kwargs.items():
        exprs[n] = _resolve_this(smart_wrap(e), table)
    return exprs


def _common_columns(tables: list[Table]) -> dict[str, Column]:
    names = list(tables[0]._columns.keys())
    for t in tables[1:]:
        if set(t._columns.keys()) != set(names):
            raise ValueError(
                f"concat: mismatched columns {names} vs {list(t._columns)}"
            )
    cols = {}
    for n in names:
        d = tables[0]._columns[n].dtype
        ao = tables[0]._columns[n].append_only
        for t in tables[1:]:
            d = dt.lub(d, t._columns[n].dtype)
            ao = ao and t._columns[n].append_only
        cols[n] = Column(d, append_only=ao)
    return cols
