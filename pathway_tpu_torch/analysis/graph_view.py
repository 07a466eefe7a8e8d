"""Read-only indexed view of a parse graph for the analyzer.

Walks the ``LogicalOp`` DAG the Table DSL registered in
``internals/parse_graph.G`` and precomputes the indexes every rule
needs: consumers per table, reachability from outputs, source
classification (streaming connector vs bounded static), and mitigation
lookups (temporal behaviors / window grouping) for the unbounded-state
rule.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

from ..internals.expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    IxExpression,
    PointerExpression,
)
from ..internals.parse_graph import G, ParseGraph
from ..internals.table import LogicalOp, Table

#: op kinds that forward every input column by name to the output
PASSTHROUGH_KINDS = frozenset(
    {
        "filter",
        "concat",
        "concat_reindex",
        "update_rows",
        "update_cells",
        "intersect",
        "difference",
        "with_universe_of",
        "reindex",
        "remove_errors",
        "temporal_behavior",
        "deduplicate",
        "flatten",
        "sort",
        "gradual_broadcast",
    }
)

#: op kinds producing rows from outside the graph
SOURCE_KINDS = frozenset({"static", "connector", "error_log"})

#: op kinds that hold per-group / per-key state at runtime
STATEFUL_KINDS = frozenset({"groupby_reduce", "join_select", "deduplicate"})


def iter_param_exprs(params: dict) -> Iterator[tuple[str, ColumnExpression]]:
    """Yield every ColumnExpression reachable in an op's params dict,
    looking through nested lists/tuples/dicts (e.g. ``exprs`` maps,
    ``on`` condition lists, behavior thresholds)."""

    def walk(key: str, value: Any) -> Iterator[tuple[str, ColumnExpression]]:
        if isinstance(value, ColumnExpression):
            yield key, value
        elif isinstance(value, dict):
            for k, v in value.items():
                yield from walk(f"{key}.{k}", v)
        elif isinstance(value, (list, tuple)):
            for v in value:
                yield from walk(key, v)

    for key, value in params.items():
        if key == "build":  # connector/sink builder closures, not exprs
            continue
        yield from walk(key, value)


def walk_expr(expr: ColumnExpression, visit: Callable[[ColumnExpression], None]) -> None:
    visit(expr)
    for dep in expr._deps:
        if isinstance(dep, ColumnExpression):
            walk_expr(dep, visit)


def expr_refs(expr: ColumnExpression) -> list[ColumnReference]:
    refs: list[ColumnReference] = []
    walk_expr(expr, lambda e: refs.append(e) if isinstance(e, ColumnReference) else None)
    return refs


def expr_applies(expr: ColumnExpression) -> list[ApplyExpression]:
    """All ApplyExpression nodes (incl. async/batched subclasses)."""
    out: list[ApplyExpression] = []
    walk_expr(expr, lambda e: out.append(e) if isinstance(e, ApplyExpression) else None)
    return out


def _extra_input_tables(op: LogicalOp) -> set[Table]:
    """Tables referenced by an op's expressions beyond op.inputs (cross
    references like ``other.ix(...)`` / PointerExpression targets)."""
    extra: set[Table] = set()

    def visit(e: ColumnExpression) -> None:
        if isinstance(e, ColumnReference) and isinstance(e._table, Table):
            extra.add(e._table)
        elif isinstance(e, IxExpression):
            target = getattr(e, "_ix_target", None) or getattr(e, "_table", None)
            if isinstance(target, Table):
                extra.add(target)
        elif isinstance(e, PointerExpression):
            target = getattr(e, "_table", None)
            if isinstance(target, Table):
                extra.add(target)

    for _, expr in iter_param_exprs(op.params):
        walk_expr(expr, visit)
    return extra


class GraphView:
    """Indexes over one parse graph, built once per analyze() call."""

    def __init__(self, graph: ParseGraph | None = None):
        self.graph = graph if graph is not None else G
        self.tables: list[Table] = list(self.graph.tables)
        self.output_tables: list[Table] = [t for t, _sink in self.graph.outputs]
        for spec in self.graph.subscriptions:
            t = spec.get("table")
            if t is not None:
                self.output_tables.append(t)
        # consumers: table id -> ops that read it (as input or via a
        # cross-table expression reference)
        self.consumers: dict[int, list[LogicalOp]] = {}
        self._op_inputs: dict[int, set[Table]] = {}
        for t in self.tables:
            op = t._op
            ins = set(op.inputs) | _extra_input_tables(op)
            self._op_inputs[t._id] = ins
            for src in ins:
                self.consumers.setdefault(src._id, []).append(op)
        self._streaming_cache: dict[int, bool] = {}

    # ---- structure ----

    def op_inputs(self, op: LogicalOp) -> set[Table]:
        out = op.output
        if out is not None and out._id in self._op_inputs:
            return self._op_inputs[out._id]
        return set(op.inputs) | _extra_input_tables(op)

    def ancestors(self, table: Table) -> Iterator[Table]:
        """All transitive input tables of ``table`` (table excluded)."""
        seen: set[int] = set()
        stack = list(self.op_inputs(table._op))
        while stack:
            t = stack.pop()
            if t._id in seen:
                continue
            seen.add(t._id)
            yield t
            stack.extend(self.op_inputs(t._op))

    def reachable_from_outputs(self) -> set[int]:
        """Table ids that feed some output/subscription (incl. the
        output tables themselves). Empty graph outputs -> empty set."""
        live: set[int] = set()
        stack = list(self.output_tables)
        while stack:
            t = stack.pop()
            if t._id in live:
                continue
            live.add(t._id)
            stack.extend(self.op_inputs(t._op))
        return live

    # ---- source / boundedness classification ----

    def is_streaming(self, table: Table) -> bool:
        """True when rows of ``table`` derive from an unbounded streaming
        source (a ``connector`` op). Static tables and pure derivations
        of static tables are bounded."""
        tid = table._id
        cached = self._streaming_cache.get(tid)
        if cached is not None:
            return cached
        # cycle guard (iterate_output loops): assume bounded while open
        self._streaming_cache[tid] = False
        kind = table._op.kind
        if kind == "connector":
            result = True
        elif kind in ("static", "error_log"):
            result = False
        else:
            result = any(self.is_streaming(t) for t in self.op_inputs(table._op))
        self._streaming_cache[tid] = result
        return result

    def streaming_paths_mitigated(self, op: LogicalOp) -> bool:
        """True when every streaming path into ``op`` passes a temporal
        behavior that bounds state (cutoff/freeze threshold)."""

        def path_ok(table: Table, seen: set[int]) -> bool:
            if table._id in seen:
                return True
            seen.add(table._id)
            if not self.is_streaming(table):
                return True
            o = table._op
            if o.kind == "temporal_behavior" and (
                "cutoff_threshold" in o.params or "freeze_threshold" in o.params
            ):
                return True
            if o.kind == "connector":
                return False
            ins = self.op_inputs(o)
            if not ins:
                return False
            return all(path_ok(t, seen) for t in ins)

        return all(path_ok(t, set()) for t in self.op_inputs(op))


def grouping_is_windowed(op: LogicalOp) -> bool:
    """True for groupby_reduce ops produced by ``windowby(...).reduce``:
    the grouping includes the ``_pw_window`` column, so state is scoped
    to windows rather than the whole stream history."""
    grouping = op.params.get("grouping") or []
    for g in grouping:
        for ref in expr_refs(g):
            if ref._name in ("_pw_window", "_pw_window_start", "_pw_window_end"):
                return True
    return False


def join_is_windowed(op: LogicalOp) -> bool:
    on = op.params.get("on") or []
    for cond in on:
        for ref in expr_refs(cond):
            if ref._name in ("_pw_window", "_pw_window_start", "_pw_window_end"):
                return True
    return False
