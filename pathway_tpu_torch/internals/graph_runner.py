"""GraphRunner: compiles the logical parse graph onto the engine.

Rebuild of upstream Pathway's python/pathway/internals/graph_runner/
(GraphRunner __init__.py:36, storage_graph.py, operator_handler.py,
expression_evaluator.py). Lowers each logical operator (table.py
LogicalOp) to engine nodes (engine/dataflow.py) and compiles
ColumnExpressions to row evaluators."""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable

import numpy as np

from ..engine import dataflow as df
from ..engine import reducers as engine_reducers
from ..engine.value import ERROR, Error, Json, Pointer, ref_scalar, sequential_key
from . import dtype as dt
from . import expression as expr_mod
from .expression import (
    ApplyExpression,
    AsyncApplyExpression,
    CastExpression,
    CoalesceExpression,
    ColumnBinaryOpExpression,
    ColumnExpression,
    ColumnReference,
    ColumnUnaryOpExpression,
    ConstColumnExpression,
    ConvertExpression,
    DeclareTypeExpression,
    FillErrorExpression,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    IxExpression,
    MakeTupleExpression,
    MethodCallExpression,
    PointerExpression,
    ReducerExpression,
    RequireExpression,
    SequenceGetExpression,
    UnwrapExpression,
)
from . import vector_eval
from .parse_graph import G
from .table import LogicalOp, Table


class SlotRef(ColumnExpression):
    """Internal: reference to a precomputed slot in the engine row."""

    def __init__(self, idx: int, dtype: dt.DType = dt.ANY):
        super().__init__()
        self._idx = idx
        self._dtype = dtype


class KeyRef(ColumnExpression):
    """Internal: the engine key of the current row."""

    def __init__(self):
        super().__init__()
        self._dtype = dt.POINTER


def map_expression(expr: ColumnExpression, fn: Callable) -> ColumnExpression:
    """Bottom-up rewrite; fn(node) returns a replacement or None."""
    replaced = fn(expr)
    if replaced is not None:
        return replaced
    new = _copy.copy(expr)
    changed = False
    for attr in (
        "_left", "_right", "_expr", "_if", "_then", "_else", "_val",
        "_index", "_default", "_replacement", "_keys_expr",
    ):
        if hasattr(new, attr):
            child = getattr(new, attr)
            if isinstance(child, ColumnExpression):
                nc = map_expression(child, fn)
                if nc is not child:
                    setattr(new, attr, nc)
                    changed = True
    if hasattr(new, "_args") and isinstance(new._args, list):
        ncs = [
            map_expression(c, fn) if isinstance(c, ColumnExpression) else c
            for c in new._args
        ]
        if any(a is not b for a, b in zip(ncs, new._args)):
            new._args = ncs
            changed = True
    if hasattr(new, "_kwargs") and isinstance(new._kwargs, dict):
        nk = {}
        kchanged = False
        for k, v in new._kwargs.items():
            if isinstance(v, ColumnExpression):
                nv = map_expression(v, fn)
                kchanged = kchanged or nv is not v
                nk[k] = nv
            else:
                nk[k] = v
        if kchanged:
            new._kwargs = nk
            changed = True
    return new if changed else expr


def walk_expression(expr: ColumnExpression, visit: Callable) -> None:
    visit(expr)
    for dep in expr._deps:
        walk_expression(dep, visit)


class Layout:
    """Maps (table_id, column_name) -> row slot for compiled evaluation."""

    def __init__(self):
        self.slots: dict[tuple[int, str], int] = {}
        self.id_slots: dict[int, int] = {}  # table_id -> slot holding its key ptr
        self.self_tables: set[int] = set()  # tables whose id == engine key
        self.width = 0

    def add_table(self, table: Table, self_keyed: bool = True) -> None:
        for name in table._columns:
            self.slots[(table._id, name)] = self.width
            self.width += 1
        if self_keyed:
            self.self_tables.add(table._id)

    def add_slot(self, key: tuple[int, str] | None = None) -> int:
        idx = self.width
        if key is not None:
            self.slots[key] = idx
        self.width += 1
        return idx


class Lowered:
    """A lowered table: engine node + row layout (column order)."""

    def __init__(self, node: df.Node, names: list[str]):
        self.node = node
        self.names = names  # engine row order == these names

    def index(self, name: str) -> int:
        return self.names.index(name)


_REDUCERS = {
    "count": lambda **kw: engine_reducers.CountReducer(),
    "sum": lambda **kw: engine_reducers.SumReducer(),
    "min": lambda **kw: engine_reducers.MinReducer(),
    "max": lambda **kw: engine_reducers.MaxReducer(),
    "argmin": lambda **kw: engine_reducers.ArgMinReducer(),
    "argmax": lambda **kw: engine_reducers.ArgMaxReducer(),
    "avg": lambda **kw: engine_reducers.AvgReducer(),
    "unique": lambda **kw: engine_reducers.UniqueReducer(),
    "any": lambda **kw: engine_reducers.AnyReducer(),
    "sorted_tuple": lambda **kw: engine_reducers.SortedTupleReducer(kw.get("skip_nones", False)),
    "tuple": lambda **kw: engine_reducers.TupleReducer(kw.get("skip_nones", False)),
    "ndarray": lambda **kw: engine_reducers.NdarrayReducer(kw.get("skip_nones", False)),
    "earliest": lambda **kw: engine_reducers.EarliestReducer(),
    "latest": lambda **kw: engine_reducers.LatestReducer(),
}


class GraphRunner:
    """One-shot compiler + executor (reference GraphRunner._run
    graph_runner/__init__.py:129 → engine run)."""

    def __init__(self, *, debug: bool = False, n_workers: int = 1):
        self.engine = df.EngineGraph(n_workers=n_workers)
        self.lowered: dict[int, Lowered] = {}
        self.debug = debug
        # multi-worker (PATHWAY_THREADS>1): replica runners lower the
        # SAME graph in the same order, so node ids line up across
        # shards and emit-time routing can address peers by id
        # (parallel/sharded.py ShardCluster)
        self._replicas: list["GraphRunner"] = (
            [GraphRunner(debug=debug) for _ in range(n_workers - 1)]
            if n_workers > 1
            else []
        )
        self._cluster = None

    # ---------- public API ----------

    def capture(self, table: Table) -> tuple[df.CaptureNode, list[str]]:
        for r in self._replicas:
            r.capture(table)  # routed to shard 0; replica's stays empty
        low = self.lower(table)
        cap = df.CaptureNode(self.engine)
        cap.append_only = table.is_append_only
        cap.connect(low.node)
        self.engine.captures.append(cap)
        return cap, low.names

    def subscribe(
        self,
        table: Table,
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
    ) -> df.OutputNode:
        for r in self._replicas:
            r.subscribe(table)  # callbacks fire on shard 0 only
        low = self.lower(table)
        names = low.names

        def change_adapter(key, row, time, diff):
            if on_change is not None:
                on_change(Pointer(key), dict(zip(names, row)), time, diff)

        out = df.OutputNode(
            self.engine,
            on_change=change_adapter if on_change else None,
            on_time_end=on_time_end,
            on_end=on_end,
        )
        out.append_only = table.is_append_only
        out.connect(low.node)
        self.engine.outputs.append(out)
        return out

    def _cluster_engines(self) -> list[df.EngineGraph]:
        return [self.engine] + [r.engine for r in self._replicas]

    def run(self, monitoring_callback=None) -> None:
        if self._replicas:
            from ..parallel.sharded import ShardCluster

            self._cluster = ShardCluster(self._cluster_engines())
            self._cluster.run(monitoring_callback)
        else:
            self.engine.run(monitoring_callback)

    # ---------- lowering ----------

    def lower(self, table: Table) -> Lowered:
        if table._id in self.lowered:
            return self.lowered[table._id]
        op = table._op
        handler = getattr(self, f"_lower_{op.kind}", None)
        if handler is None:
            raise NotImplementedError(f"no lowering for operator kind {op.kind!r}")
        low = handler(table, op)
        # engine errors point at the user's build-time call site
        # (reference internals/trace.py trace frames)
        if getattr(low.node, "user_frame", None) is None:
            low.node.user_frame = getattr(op, "trace", None)
        self.lowered[table._id] = low
        return low

    # -- sources --

    def _lower_gradual_broadcast(self, table: Table, op: LogicalOp) -> Lowered:
        base = self.lower(op.inputs[0])
        thr = self.lower(op.inputs[1])
        node = df.GradualBroadcastNode(
            self.engine,
            thr.index(op.params["lower"]),
            thr.index(op.params["value"]),
            thr.index(op.params["upper"]),
        )
        node.connect(base.node, 0)
        node.connect(thr.node, 1)
        return Lowered(node, base.names + ["apx_value"])

    def _lower_error_log(self, table: Table, op: LogicalOp) -> Lowered:
        """Error-log table (reference Graph::error_log graph.rs:983):
        a session source fed by the engine's report_row_error."""
        node = df.SessionSourceNode(self.engine)
        node.is_error_log = True
        self.engine.error_sessions.append(node.session)
        return Lowered(node, list(table._columns.keys()))

    def _lower_dead_letter(self, table: Table, op: LogicalOp) -> Lowered:
        """Dead-letter (`.failed`) table: a session source fed by the
        engine's report_dead_letter for one operator's dl_id. Shares
        the error-log source treatment (is_error_log) so it is excluded
        from EOF/persistence accounting and drained at end of run."""
        node = df.SessionSourceNode(self.engine)
        node.is_error_log = True
        self.engine.dead_letter_sessions.setdefault(op.params["dl_id"], []).append(
            node.session
        )
        return Lowered(node, list(table._columns.keys()))

    def _lower_static(self, table: Table, op: LogicalOp) -> Lowered:
        rows = op.params["rows"]  # list of (key, row_tuple, time, diff)
        by_time: dict[int, list] = {}
        for key, row, time, diff in rows:
            by_time.setdefault(time, []).append((key, row, diff))
        node = df.StaticSourceNode(self.engine, sorted(by_time.items()))
        return Lowered(node, list(table._columns.keys()))

    def _lower_connector(self, table: Table, op: LogicalOp) -> Lowered:
        build = op.params["build"]
        node = build(self.engine, self)
        return Lowered(node, list(table._columns.keys()))

    # -- row-wise --

    def _zip_context(self, base: Table, exprs: list[ColumnExpression]) -> tuple[df.Node, Layout]:
        """Build the evaluation context for expressions over `base`:
        zip same-universe referenced tables, pre-join ix targets."""
        tables: dict[int, Table] = {base._id: base}

        def visit(e):
            if isinstance(e, ColumnReference) and isinstance(e._table, Table):
                tables.setdefault(e._table._id, e._table)

        for e in exprs:
            walk_expression(e, visit)
        others = [t for tid, t in tables.items() if tid != base._id]

        layout = Layout()
        layout.add_table(base)
        base_low = self.lower(base)
        node: df.Node = base_low.node
        if others:
            zip_node = _ZipNode(self.engine, 1 + len(others))
            zip_node.connect(node, 0)
            for i, t in enumerate(others):
                layout.add_table(t)
                zip_node.connect(self.lower(t).node, i + 1)
            node = zip_node

        # pre-join ix targets (ones whose keys are computable here; ix with
        # reducer-valued keys attach after the groupby instead)
        node, layout = self._attach_ix_all(node, layout, exprs, skip_reducer_keys=True)
        return node, layout

    def _attach_ix_all(self, node, layout, exprs, skip_reducer_keys=False):
        ix_triples: list[IxExpression] = []

        def visit_ix(e):
            if isinstance(e, IxExpression) and not any(x is e for x in ix_triples):
                ix_triples.append(e)

        for e in exprs:
            walk_expression(e, visit_ix)
        for ix in ix_triples:
            if id(self) in getattr(ix, "_pw_ix_slots", {}):
                continue
            if skip_reducer_keys and _contains_reducer(ix._keys_expr):
                continue
            node, layout = self._attach_ix(node, layout, ix)
        return node, layout

    def _attach_ix(self, node: df.Node, layout: Layout, ix: IxExpression):
        target: Table = ix._ix_table
        tgt_low = self.lower(target)
        # 1. append pointer column
        keys_fn = self.compile(ix._keys_expr, layout)
        width = layout.width
        passthrough = [_slot_getter(i) for i in range(width)]
        append = df.ExprMapNode(
            self.engine, passthrough + [keys_fn], name="IxKey"
        )
        append.connect(node)
        ptr_idx = layout.add_slot()
        # 2. left join with target on ptr
        tgt_names = tgt_low.names

        def left_jk(key, row):
            v = row[ptr_idx]
            return ("__none__", key) if v is None else int(v)

        join = df.JoinNode(
            self.engine,
            left_jk_fn=left_jk,
            right_jk_fn=lambda key, row: int(key),
            left_width=layout.width,
            right_width=len(tgt_names),
            how="left",
            id_fn=lambda lk, rk: lk,
        )
        join.connect(append, 0)
        join.connect(tgt_low.node, 1)
        # project away the (lk, rk) trailer appended by JoinNode but keep
        # the target columns; record slots for this ix expression
        slots = {}
        for name in tgt_names:
            slots[name] = layout.add_slot((target._id * -1 - 1, f"__ix_{id(ix)}_{name}"))
        # the join row is: left(width incl ptr) + right(len) + (lkptr, rkptr)
        proj = df.ExprMapNode(
            self.engine,
            [_slot_getter(i) for i in range(layout.width)],
            name="IxProj",
        )
        proj.connect(join)
        if not hasattr(ix, "_pw_ix_slots"):
            ix._pw_ix_slots = {}
        ix._pw_ix_slots[id(self)] = slots
        return proj, layout

    def _lower_select(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        exprs: dict[str, ColumnExpression] = op.params["exprs"]
        node, layout = self._zip_context(base, list(exprs.values()))
        node = self._apply_exprs(node, layout, list(exprs.values()))
        return Lowered(node, list(exprs.keys()))

    # Table.__add__: select over the zipped pair of same-universe tables
    _lower_concat_columns = _lower_select

    def _apply_exprs(self, node, layout, out_exprs: list[ColumnExpression]) -> df.Node:
        """Attach pending ix joins, chain AsyncApplyNodes for async
        sub-expressions, then a final ExprMap for the sync projection."""
        node, layout = self._attach_ix_all(node, layout, out_exprs)
        async_exprs: list[AsyncApplyExpression] = []

        def collect(e):
            if isinstance(e, AsyncApplyExpression):
                async_exprs.append(e)

        for e in out_exprs:
            walk_expression(e, collect)
        async_slots: dict[int, int] = {}
        for ae in reversed(async_exprs):  # innermost first (post-order-ish)
            if id(ae) in async_slots:
                continue
            arg_fns = [self.compile(a, layout) for a in ae._args]
            kw_fns = {k: self.compile(v, layout) for k, v in ae._kwargs.items()}
            fn = ae._fn
            width = layout.width

            from .udfs import _DynamicBatcher

            if isinstance(fn, _DynamicBatcher) and not kw_fns:
                # columnar fast path: a bare batch-executor UDF gets ONE
                # call per epoch chunk instead of per-row coroutines
                # (BatchApplyNode) — the verdict-r3 streaming hot path
                def row_args(key, row, _afns=arg_fns):
                    return tuple(f(key, row) for f in _afns)

                anode = df.BatchApplyNode(
                    self.engine, fn.batch_fn, row_args, fn.max_batch_size
                )
            else:

                async def async_fn(key, row, _fn=fn, _afns=arg_fns, _kfns=kw_fns):
                    args = [f(key, row) for f in _afns]
                    kwargs = {k: f(key, row) for k, f in _kfns.items()}
                    return await _fn(*args, **kwargs)

                anode = df.AsyncApplyNode(self.engine, async_fn)
            # row-failure policy riding on the expression (udf(on_error=...)
            # / AsyncTransformer): copy onto the engine node
            anode.on_error = getattr(ae, "_pw_on_error", "raise")
            anode.dead_letter_id = getattr(ae, "_pw_dead_letter_id", None)
            anode.on_end_callback = getattr(ae, "_pw_on_end", None)
            anode.connect(node)
            node = anode
            async_slots[id(ae)] = layout.add_slot()

        def substitute(e):
            if isinstance(e, AsyncApplyExpression) and id(e) in async_slots:
                return SlotRef(async_slots[id(e)], e._dtype)
            return None

        final_exprs = [map_expression(e, substitute) for e in out_exprs]
        deterministic = True

        def check_det(e):
            nonlocal deterministic
            if isinstance(e, ApplyExpression) and not e._deterministic:
                deterministic = False

        for e in final_exprs:
            walk_expression(e, check_det)
        fns = [self.compile(e, layout) for e in final_exprs]
        # columnar fast path (SURVEY §7): vectorized numpy kernels over
        # the delta batch, per-row closures as exact-semantics fallback
        batch = (
            vector_eval.try_compile_batch(final_exprs, layout, fns)
            if deterministic
            else None
        )
        out = df.ExprMapNode(
            self.engine,
            fns,
            deterministic=deterministic,
            batch_eval=batch,
            name="Select",
        )
        out.connect(node)
        return out

    def _lower_external_index(self, table: Table, op: LogicalOp) -> Lowered:
        """use_external_index_as_of_now (reference dataflow.rs:2224 /
        operators/external_index.rs): port 0 = data table diffs feed the
        index (device KNN / BM25), port 1 = queries, answered asof-now.
        Matched data values are pulled in-operator from the node's data
        row mirror — no separate repack join."""
        query_table, data_table = op.inputs
        p = op.params
        index = p["index_factory"]()

        # data side: payload + metadata expressions over the data table
        data_exprs = [p["data_payload"]] + ([p["data_metadata"]] if p.get("data_metadata") is not None else [])
        dnode, dlayout = self._zip_context(data_table, data_exprs)
        payload_fn = self.compile(p["data_payload"], dlayout)
        meta_fn = (
            self.compile(p["data_metadata"], dlayout)
            if p.get("data_metadata") is not None
            else None
        )

        def data_fn(key, row):
            return payload_fn(key, row), (meta_fn(key, row) if meta_fn else None)

        # query side: payload, k, filter expressions
        query_exprs = [p["query_payload"], p["query_k"]]
        if p.get("query_filter") is not None:
            query_exprs.append(p["query_filter"])
        qnode, qlayout = self._zip_context(query_table, query_exprs)
        qpayload_fn = self.compile(p["query_payload"], qlayout)
        k_fn = self.compile(p["query_k"], qlayout)
        flt_fn = (
            self.compile(p["query_filter"], qlayout)
            if p.get("query_filter") is not None
            else None
        )

        def query_fn(key, row):
            return (
                qpayload_fn(key, row),
                k_fn(key, row),
                flt_fn(key, row) if flt_fn else None,
            )

        # project query context down to the query table's own columns
        qnames = list(query_table._columns.keys())
        data_names = p.get("data_cols") or []
        data_slots = [dlayout.slots[(data_table._id, n)] for n in data_names]

        from ..engine.value import Pointer

        def result_fn(matches, data_rows):
            reply = tuple((Pointer(k), s) for k, s in matches)
            scores = tuple(s for _, s in matches)
            cols = []
            for slot in data_slots:
                vals = []
                for k, _ in matches:
                    drow = data_rows.get(k)
                    vals.append(drow[slot] if drow is not None else None)
                cols.append(tuple(vals))
            return (reply, scores, *cols)

        from ..utils.jmespath_lite import compile_filter

        qslots = [qlayout.slots[(query_table._id, n)] for n in qnames]

        def query_proj(key, row):
            return tuple(row[i] for i in qslots)

        node = df.ExternalIndexNode(
            self.engine,
            index,
            data_fn=data_fn,
            query_fn=query_fn,
            result_fn=result_fn,
            filter_compiler=compile_filter,
            query_proj=query_proj,
            data_embed=p.get("data_embed"),
            query_embed=p.get("query_embed"),
            asof_now=p.get("asof_now", True),
        )
        node.connect(dnode, 0)
        node.connect(qnode, 1)
        out_names = qnames + ["_pw_index_reply", "_pw_index_reply_score"] + [
            f"_pw_data_{n}" for n in data_names
        ]
        return Lowered(node, out_names)

    def _lower_remove_errors(self, table: Table, op: LogicalOp) -> Lowered:
        """Drop rows holding ERROR in any column (reference
        table.py:2491 remove_errors / column.py FilterOutValueContext)."""
        base = self.lower(op.inputs[0])
        fnode = df.FilterNode(
            self.engine,
            lambda key, row: not any(v is ERROR for v in row),
            name="RemoveErrors",
        )
        fnode.connect(base.node)
        return Lowered(fnode, base.names)

    def _lower_filter(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        pred_expr = op.params["expr"]
        node, layout = self._zip_context(base, [pred_expr])
        pred = self.compile(pred_expr, layout)
        fnode = df.FilterNode(
            self.engine,
            pred,
            batch_pred=vector_eval.try_compile_batch_pred(pred_expr, layout),
        )
        fnode.connect(node)
        # project back to base's columns; the context layout usually IS
        # the base's columns (no zip/ix slots) — skip the identity node
        base_names = list(base._columns.keys())
        slots = [layout.slots[(base._id, n)] for n in base_names]
        if slots == list(range(layout.width)):
            return Lowered(fnode, list(table._columns.keys()))
        proj_fns = [_slot_getter(i) for i in slots]
        proj = df.ExprMapNode(
            self.engine,
            proj_fns,
            batch_eval=vector_eval.make_projection_batch(slots),
            name="FilterProj",
        )
        proj.connect(fnode)
        return Lowered(proj, list(table._columns.keys()))

    # -- groupby/reduce --

    def _lower_groupby_reduce(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        grouping: list[ColumnExpression] = op.params["grouping"]
        out_exprs: dict[str, ColumnExpression] = op.params["exprs"]
        sort_by = op.params.get("sort_by")

        all_exprs = list(grouping) + list(out_exprs.values())
        if sort_by is not None:
            all_exprs.append(sort_by)
        node, layout = self._zip_context(base, all_exprs)

        group_fns = [self.compile(g, layout) for g in grouping]
        sort_fn = self.compile(sort_by, layout) if sort_by is not None else None

        grouping_names = {
            g._name: i for i, g in enumerate(grouping) if isinstance(g, ColumnReference)
        }

        specs: list[tuple[Any, Callable]] = []
        slot_of: dict[int, int] = {}
        # columnar fast path (parallel to specs): builder(cols, keys) ->
        # per-row args tuples, or None when the spec can't vectorize
        vec_builders: list[Callable | None] = []

        def make_args_fn(fns: list[Callable]):
            return lambda key, row: tuple(f(key, row) for f in fns)

        def _vec_of(exprs_list) -> list[Callable] | None:
            try:
                return [vector_eval.compile_vec(a, layout) for a in exprs_list]
            except vector_eval.NotVectorized:
                return None

        def _vec_tuple_builder(vfs: list[Callable]) -> Callable:
            def build(cols, keys):
                lists = [vector_eval._to_list(vf(cols), cols.n) for vf in vfs]
                return list(zip(*lists)) if lists else [()] * cols.n

            build._vec_fns = vfs  # columnar form for semigroup folding
            return build

        def _vec_key_payload_builder(cmp_vf: Callable) -> Callable:
            def build(cols, keys):
                cmps = vector_eval._to_list(cmp_vf(cols), cols.n)
                return list(zip(cmps, (Pointer(k) for k in keys)))

            return build

        def _vec_keysort_builder(val_vf: Callable) -> Callable:
            def build(cols, keys):
                vals = vector_eval._to_list(val_vf(cols), cols.n)
                return list(zip(keys, vals))

            return build

        def assign_slot(e) -> ColumnExpression | None:
            if isinstance(e, ReducerExpression):
                if id(e) in slot_of:
                    return SlotRef(slot_of[id(e)], e._dtype)
                name = e._reducer_name
                if name in ("stateful", "stateful_many", "stateful_single"):
                    red = self._make_stateful_reducer(e)
                elif name in _REDUCERS:
                    red = _REDUCERS[name](**e._kwargs)
                else:
                    raise NotImplementedError(f"reducer {name}")
                arg_fns = [self.compile(a, layout) for a in e._args]
                if name in ("argmin", "argmax"):
                    cmp_fn = arg_fns[0]
                    if len(arg_fns) > 1:
                        payload_fn = arg_fns[1]
                        args_fn = lambda key, row, c=cmp_fn, p=payload_fn: (c(key, row), p(key, row))
                        vfs = _vec_of(list(e._args[:2]))
                        vec_builders.append(_vec_tuple_builder(vfs) if vfs else None)
                    else:
                        payload_fn = lambda key, row: Pointer(key)
                        args_fn = lambda key, row, c=cmp_fn, p=payload_fn: (c(key, row), p(key, row))
                        vfs = _vec_of([e._args[0]])
                        vec_builders.append(
                            _vec_key_payload_builder(vfs[0]) if vfs else None
                        )
                elif name in ("tuple", "ndarray"):
                    val_fn = arg_fns[0]
                    if sort_fn is not None:
                        sfn = sort_fn
                        vfs = _vec_of([sort_by, e._args[0]])
                        vec_builders.append(_vec_tuple_builder(vfs) if vfs else None)
                    else:
                        sfn = lambda key, row: key
                        vfs = _vec_of([e._args[0]])
                        vec_builders.append(
                            _vec_keysort_builder(vfs[0]) if vfs else None
                        )
                    args_fn = lambda key, row, v=val_fn, s=sfn: (s(key, row), v(key, row))
                elif name == "count":
                    args_fn = lambda key, row: ()
                    count_builder = lambda cols, keys: [()] * cols.n
                    count_builder._vec_fns = []
                    vec_builders.append(count_builder)
                else:
                    args_fn = make_args_fn(arg_fns)
                    vfs = _vec_of(list(e._args))
                    vec_builders.append(_vec_tuple_builder(vfs) if vfs else None)
                idx = len(specs)
                specs.append((red, args_fn))
                slot_of[id(e)] = idx
                return SlotRef(idx, e._dtype)
            if isinstance(e, ColumnReference) and isinstance(e._table, Table):
                if e._name == "id":
                    return KeyRef()
                if e._name in grouping_names:
                    gi = grouping_names[e._name]
                    ck = ("gcol", gi)
                    for si, (red, af) in enumerate(specs):
                        if getattr(red, "_gcol", None) == gi:
                            return SlotRef(si, e._dtype)
                    red = engine_reducers.GroupColReducer()
                    red._gcol = gi
                    fn = group_fns[gi]
                    specs.append((red, lambda key, row, f=fn: (f(key, row),)))
                    gvf = _vec_of([grouping[gi]])
                    vec_builders.append(_vec_tuple_builder(gvf) if gvf else None)
                    return SlotRef(len(specs) - 1, e._dtype)
                raise ValueError(
                    f"column {e._name!r} used in reduce() is not a grouping column; "
                    f"wrap it in a reducer"
                )
            return None

        final_exprs = [map_expression(e, assign_slot) for e in out_exprs.values()]

        def group_key_fn(key, row):
            return int(ref_scalar(*[f(key, row) for f in group_fns]))

        batch_prep = None
        group_vfs = _vec_of(list(grouping))
        if group_vfs and all(b is not None for b in vec_builders):
            from ..engine.value import ref_scalar_columns

            def batch_prep(keys, rows, cache=None, _g=group_vfs, _b=list(vec_builders)):
                cols = vector_eval.Cols(rows, cache)
                try:
                    garrs = [
                        np.asarray(vector_eval._as_array(f(cols), cols.n))
                        for f in _g
                    ]
                    gks = ref_scalar_columns(garrs)
                    if gks is None:
                        return None  # e.g. string group keys: per-row path
                    # columnar args per spec, for semigroup fold_batch
                    spec_cols = []
                    for b in _b:
                        vfs = getattr(b, "_vec_fns", None)
                        if vfs is None:
                            spec_cols = None
                            break
                        spec_cols.append(
                            tuple(
                                np.asarray(
                                    vector_eval._as_array(vf(cols), cols.n)
                                )
                                for vf in vfs
                            )
                        )
                except vector_eval.NotVectorized:
                    return None
                except Exception:
                    return None  # error rows etc: per-row path reports

                def make_args_rows(_b=_b, cols=cols, keys=keys):
                    args_cols = [b(cols, keys) for b in _b]
                    return (
                        list(zip(*args_cols)) if args_cols else [()] * cols.n
                    )

                return gks.tolist(), spec_cols, make_args_rows

        gnode = df.GroupByNode(self.engine, group_key_fn, specs, batch_prep=batch_prep)
        gnode.connect(node)

        post_layout = Layout()
        post_layout.width = len(specs)
        out = self._apply_exprs(gnode, post_layout, final_exprs)
        return Lowered(out, list(out_exprs.keys()))

    def _make_stateful_reducer(self, e: ReducerExpression):
        fn = e._kwargs.get("fn")
        from ..reducers import BaseCustomAccumulator

        if isinstance(fn, type) and issubclass(fn, BaseCustomAccumulator):
            cls = fn

            def combine(values):
                acc = None
                for v in values:
                    row = v if isinstance(v, tuple) else (v,)
                    cur = cls.from_row(list(row))
                    if acc is None:
                        acc = cur
                    else:
                        acc.update(cur)
                return None if acc is None else acc.compute_result()

            return engine_reducers.StatefulReducer(combine)
        if e._reducer_name == "stateful_single":
            f = fn

            def combine_single(values):
                state = None
                for v in values:
                    row = v if isinstance(v, tuple) else (v,)
                    state = f(state, *row)
                return state

            return engine_reducers.StatefulReducer(combine_single)

        def combine_many(values):
            rows = [(1, (v if isinstance(v, tuple) else (v,))) for v in values]
            return fn(None, rows)

        return engine_reducers.StatefulReducer(combine_many)

    # -- joins --

    def _lower_join_select(self, table: Table, op: LogicalOp) -> Lowered:
        left, right = op.inputs
        on: list[ColumnExpression] = op.params["on"]
        how: str = op.params["how"]
        id_from = op.params.get("id_from")
        out_exprs: dict[str, ColumnExpression] = op.params["exprs"]
        filters: list[ColumnExpression] = op.params.get("filters", [])

        left_conds, right_conds = [], []
        for cond in on:
            if not (
                isinstance(cond, ColumnBinaryOpExpression) and cond._op == "=="
            ):
                raise ValueError("join conditions must be equalities")
            lref, rref = cond._left, cond._right
            if _refs_table(rref, left) and _refs_table(lref, right):
                lref, rref = rref, lref
            left_conds.append(lref)
            right_conds.append(rref)

        # context exprs that belong to each side
        def side_exprs(side_table, conds):
            return conds

        lnode, llayout = self._zip_context(left, left_conds)
        rnode, rlayout = self._zip_context(right, right_conds)
        l_fns = [self.compile(c, llayout) for c in left_conds]
        r_fns = [self.compile(c, rlayout) for c in right_conds]

        def left_jk(key, row):
            return tuple(f(key, row) for f in l_fns)

        def right_jk(key, row):
            return tuple(f(key, row) for f in r_fns)

        if id_from is not None and isinstance(id_from, ColumnReference):
            src = id_from._table
            from .thisclass import left as left_cls, right as right_cls

            if src is left or src is left_cls:
                id_fn = lambda lk, rk: lk if lk is not None else ref_scalar(None, Pointer(rk))
            elif src is right or src is right_cls:
                id_fn = lambda lk, rk: rk if rk is not None else ref_scalar(Pointer(lk), None)
            else:
                id_fn = None
        else:
            id_fn = None

        node_cls = df.JoinNode
        if how.startswith("asof_now_"):
            node_cls = df.AsofNowJoinNode
            how = how[len("asof_now_"):]
        join = node_cls(
            self.engine,
            left_jk_fn=left_jk,
            right_jk_fn=right_jk,
            left_width=llayout.width,
            right_width=rlayout.width,
            how=how,
            id_fn=id_fn,
        )
        join.connect(lnode, 0)
        join.connect(rnode, 1)

        # join row layout: left cols + right cols + (lk ptr, rk ptr)
        jlayout = Layout()
        jlayout.width = llayout.width + rlayout.width + 2
        for (tid, name), idx in llayout.slots.items():
            jlayout.slots[(tid, name)] = idx
        for (tid, name), idx in rlayout.slots.items():
            jlayout.slots[(tid, name)] = idx + llayout.width
        jlayout.id_slots[left._id] = llayout.width + rlayout.width
        jlayout.id_slots[right._id] = llayout.width + rlayout.width + 1
        for tid in llayout.self_tables:
            jlayout.id_slots.setdefault(tid, llayout.width + rlayout.width)
        for tid in rlayout.self_tables:
            jlayout.id_slots.setdefault(tid, llayout.width + rlayout.width + 1)

        node: df.Node = join
        for f in filters:
            pred = self.compile(f, jlayout)
            fnode = df.FilterNode(self.engine, pred)
            fnode.connect(node)
            node = fnode

        node = self._apply_exprs_with_layout(node, jlayout, list(out_exprs.values()))
        return Lowered(node, list(out_exprs.keys()))

    def _apply_exprs_with_layout(self, node, layout, out_exprs):
        return self._apply_exprs(node, layout, out_exprs)

    # -- set ops --

    def _lower_concat(self, table: Table, op: LogicalOp) -> Lowered:
        names = list(table._columns.keys())
        cnode = df.ConcatNode(self.engine, len(op.inputs))
        for i, t in enumerate(op.inputs):
            low = self.lower(t)
            proj = self._project(low, names)
            cnode.connect(proj, i)
        return Lowered(cnode, names)

    def _lower_concat_reindex(self, table: Table, op: LogicalOp) -> Lowered:
        names = list(table._columns.keys())
        cnode = df.ConcatNode(self.engine, len(op.inputs), check_disjoint=False)
        for i, t in enumerate(op.inputs):
            low = self.lower(t)
            proj = self._project(low, names)
            re = df.ReindexNode(
                self.engine, lambda k, r, _i=i: int(ref_scalar(Pointer(k), _i))
            )
            re.connect(proj)
            cnode.connect(re, i)
        return Lowered(cnode, names)

    def _project(self, low: Lowered, names: list[str]) -> df.Node:
        if low.names == names:
            return low.node
        idxs = [low.index(n) for n in names]
        proj = df.ExprMapNode(self.engine, [_slot_getter(i) for i in idxs], name="Project")
        proj.connect(low.node)
        return proj

    def _lower_update_rows(self, table: Table, op: LogicalOp) -> Lowered:
        names = list(table._columns.keys())
        l, r = (self.lower(t) for t in op.inputs)
        node = df.UpdateRowsNode(self.engine)
        node.connect(self._project(l, names), 0)
        node.connect(self._project(r, names), 1)
        return Lowered(node, names)

    def _lower_update_cells(self, table: Table, op: LogicalOp) -> Lowered:
        base, other = op.inputs
        names = list(table._columns.keys())
        l = self.lower(base)
        r = self.lower(other)
        col_map = []
        for ri, n in enumerate(r.names):
            if n in l.names:
                col_map.append((l.index(n), ri))
        node = df.UpdateCellsNode(self.engine, col_map)
        node.connect(self._project(l, names), 0)
        node.connect(r.node, 1)
        return Lowered(node, names)

    def _lower_intersect(self, table: Table, op: LogicalOp) -> Lowered:
        lows = [self.lower(t) for t in op.inputs]
        node = df.IntersectNode(self.engine, len(lows))
        for i, low in enumerate(lows):
            node.connect(low.node, i)
        return Lowered(node, lows[0].names)

    def _lower_difference(self, table: Table, op: LogicalOp) -> Lowered:
        l, r = (self.lower(t) for t in op.inputs)
        node = df.SubtractNode(self.engine)
        node.connect(l.node, 0)
        node.connect(r.node, 1)
        return Lowered(node, l.names)

    def _lower_with_universe_of(self, table: Table, op: LogicalOp) -> Lowered:
        low = self.lower(op.inputs[0])
        return Lowered(low.node, low.names)

    # -- re-keying --

    def _lower_reindex(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        key_expr = op.params["expr"]
        node, layout = self._zip_context(base, [key_expr])
        key_fn = self.compile(key_expr, layout)
        base_names = list(base._columns.keys())
        proj_fns = [_slot_getter(layout.slots[(base._id, n)]) for n in base_names]
        proj = df.ExprMapNode(self.engine, proj_fns + [key_fn], name="ReindexPrep")
        proj.connect(node)
        kidx = len(base_names)

        renode = df.ReindexNode(self.engine, lambda k, r: int(r[kidx]))
        renode.connect(proj)
        final = df.ExprMapNode(
            self.engine, [_slot_getter(i) for i in range(len(base_names))], name="ReindexProj"
        )
        final.connect(renode)
        return Lowered(final, base_names)

    # -- flatten / sort / dedup --

    def _lower_flatten(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        low = self.lower(base)
        col = low.index(op.params["column"])
        origin_id = op.params.get("origin_id")
        node: df.Node = low.node
        names = list(low.names)
        if origin_id is not None:
            append = df.ExprMapNode(
                self.engine,
                [_slot_getter(i) for i in range(len(names))]
                + [lambda k, r: Pointer(k)],
                name="FlattenOrigin",
            )
            append.connect(node)
            node = append
            names = names + [origin_id]
        fnode = df.FlattenNode(self.engine, col)
        fnode.connect(node)
        return Lowered(fnode, names)

    def _lower_sort(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        key_expr = op.params["key"]
        inst_expr = op.params.get("instance")
        exprs = [key_expr] + ([inst_expr] if inst_expr is not None else [])
        node, layout = self._zip_context(base, exprs)
        key_fn = self.compile(key_expr, layout)
        inst_fn = (
            self.compile(inst_expr, layout) if inst_expr is not None else (lambda k, r: 0)
        )
        snode = df.SortNode(self.engine, key_fn, inst_fn)
        snode.connect(node)
        return Lowered(snode, ["prev", "next"])

    def _lower_deduplicate(self, table: Table, op: LogicalOp) -> Lowered:
        base = op.inputs[0]
        value = op.params.get("value")
        instance = op.params.get("instance")
        acceptor = op.params.get("acceptor") or (lambda new, old: old is None or new != old)
        exprs = [e for e in (value, instance) if e is not None]
        node, layout = self._zip_context(base, exprs)
        val_fn = self.compile(value, layout) if value is not None else (lambda k, r: r)
        inst_fn = (
            self.compile(instance, layout) if instance is not None else (lambda k, r: 0)
        )

        def wrapped_acceptor(new_row, old_row):
            if old_row is None:
                return True
            return acceptor(new_row[-1], old_row[-1])

        # append value as trailer column for the acceptor
        base_names = list(base._columns.keys())
        width = layout.width
        append = df.ExprMapNode(
            self.engine,
            [_slot_getter(layout.slots[(base._id, n)]) for n in base_names] + [val_fn],
            name="DedupPrep",
        )
        append.connect(node)
        dnode = df.DeduplicateNode(self.engine, lambda k, r: inst_fn(k, r), wrapped_acceptor)
        dnode.connect(append)
        proj = df.ExprMapNode(
            self.engine, [_slot_getter(i) for i in range(len(base_names))], name="DedupProj"
        )
        proj.connect(dnode)
        return Lowered(proj, base_names)

    def _lower_temporal_behavior(self, table: Table, op: LogicalOp) -> Lowered:
        """Lower buffer/forget/freeze chains (Graph::buffer/forget/freeze,
        reference operators/time_column.rs) driven by an event-time column."""
        base = op.inputs[0]
        time_expr = op.params["time_expr"]
        exprs = [time_expr] + [
            e for e in (op.params.get("delay_threshold"), op.params.get("cutoff_threshold"))
            if e is not None
        ]
        node, layout = self._zip_context(base, exprs)
        time_fn = self.compile(time_expr, layout)
        base_names = list(base._columns.keys())
        proj_idx = [layout.slots[(base._id, n)] for n in base_names]

        # forget/freeze FIRST, buffer last: their event-time watermark
        # must advance from the raw arrival stream — behind a buffer
        # they would only see released rows, so a late arrival could
        # slip past a freeze whose watermark lags (reference
        # time_column.rs applies ignore_late/freeze on the input side)
        if op.params.get("cutoff_threshold") is not None:
            thr_fn = self.compile(op.params["cutoff_threshold"], layout)
            f = df.ForgetNode(self.engine, thr_fn, time_fn)
            f.connect(node)
            node = f
        if op.params.get("freeze_threshold") is not None:
            thr_fn = self.compile(op.params["freeze_threshold"], layout)
            fr = df.FreezeNode(self.engine, thr_fn, time_fn)
            fr.connect(node)
            node = fr
        if op.params.get("delay_threshold") is not None:
            thr_fn = self.compile(op.params["delay_threshold"], layout)
            b = df.BufferNode(
                self.engine, thr_fn, time_fn,
                flush_on_end=op.params.get("flush_on_end", True),
            )
            b.connect(node)
            node = b
        proj = df.ExprMapNode(
            self.engine, [_slot_getter(i) for i in proj_idx], name="BehaviorProj"
        )
        proj.connect(node)
        return Lowered(proj, base_names)

    # ---------- expression compiler ----------

    def compile(self, expr: ColumnExpression, layout: Layout) -> Callable:
        """Compile an expression to fn(key, row) -> value. The closure
        carries ``_reads`` — the row slots it depends on — so the engine
        can tell a propagated ERROR operand from a fresh failure."""
        fn = self.compile_inner(expr, layout)
        try:
            fn._reads = self._reads_of(expr, layout)
        except (AttributeError, TypeError):
            pass  # builtins / bound methods: engine falls back to whole-row
        return fn

    def _reads_of(self, e: ColumnExpression, layout: Layout) -> frozenset:
        """Row slots an expression reads (same resolution rules as
        compile_inner, minus error paths)."""
        reads: set[int] = set()

        def visit(x):
            if isinstance(x, SlotRef):
                reads.add(x._idx)
            elif isinstance(x, IxExpression):
                slots = getattr(x, "_pw_ix_slots", {}).get(id(self))
                if slots and x._name in slots:
                    reads.add(slots[x._name])
            elif isinstance(x, ColumnReference) and isinstance(x._table, Table):
                if x._name == "id":
                    if x._table._id in layout.id_slots:
                        reads.add(layout.id_slots[x._table._id])
                else:
                    key = (x._table._id, x._name)
                    if key in layout.slots:
                        reads.add(layout.slots[key])

        walk_expression(e, visit)
        return frozenset(reads)

    def compile_inner(self, e: ColumnExpression, layout: Layout) -> Callable:
        if isinstance(e, SlotRef):
            return _slot_getter(e._idx)
        if isinstance(e, KeyRef):
            return lambda k, r: Pointer(k)
        if isinstance(e, ConstColumnExpression):
            v = e._val
            return lambda k, r: v
        if isinstance(e, IxExpression):
            slots = getattr(e, "_pw_ix_slots", {}).get(id(self))
            if slots is None:
                raise RuntimeError("ix expression was not attached to this context")
            idx = slots[e._name]
            return _slot_getter(idx)
        if isinstance(e, ColumnReference):
            t = e._table
            if not isinstance(t, Table):
                raise RuntimeError(f"unresolved this-reference {e._repr_inner()}")
            if e._name == "id":
                if t._id in layout.id_slots:
                    return _slot_getter(layout.id_slots[t._id])
                if t._id in layout.self_tables or not layout.slots:
                    return lambda k, r: Pointer(k)
                return lambda k, r: Pointer(k)
            key = (t._id, e._name)
            if key not in layout.slots:
                raise RuntimeError(
                    f"column {e._repr_inner()} not available in this context; "
                    f"tables must share the universe (use join/ix otherwise)"
                )
            return _slot_getter(layout.slots[key])
        if isinstance(e, ColumnBinaryOpExpression):
            lf = self.compile_inner(e._left, layout)
            rf = self.compile_inner(e._right, layout)
            op = _BINOPS[e._op]
            if e._op in ("&", "|"):
                is_or = e._op == "|"

                def bool_fn(k, r):  # Kleene three-valued logic for None
                    a = lf(k, r)
                    b = rf(k, r)
                    if isinstance(a, Error) or isinstance(b, Error):
                        return ERROR
                    if a is None or b is None:
                        if is_or and (a is True or b is True):
                            return True
                        if not is_or and (a is False or b is False):
                            return False
                        return None
                    return op(a, b)

                return bool_fn
            none_prop = e._op not in ("==", "!=")

            def bin_fn(k, r):
                a = lf(k, r)
                b = rf(k, r)
                if isinstance(a, Error) or isinstance(b, Error):
                    return ERROR
                if none_prop and (a is None or b is None):
                    return None
                return op(a, b)

            return bin_fn
        if isinstance(e, ColumnUnaryOpExpression):
            f = self.compile_inner(e._expr, layout)
            if e._op == "-":
                return lambda k, r: None if (v := f(k, r)) is None else -v
            return lambda k, r: None if (v := f(k, r)) is None else (not v if isinstance(v, bool) else ~v)
        if isinstance(e, AsyncApplyExpression):
            raise RuntimeError("async apply must be lowered via AsyncApplyNode")
        if isinstance(e, ApplyExpression):
            arg_fns = [self.compile_inner(a, layout) for a in e._args]
            kw_fns = {k: self.compile_inner(v, layout) for k, v in e._kwargs.items()}
            fn = e._fn
            prop = e._propagate_none

            def apply_fn(k, r):
                args = [f(k, r) for f in arg_fns]
                if prop and any(a is None for a in args):
                    return None
                kwargs = {kk: f(k, r) for kk, f in kw_fns.items()}
                return fn(*args, **kwargs)

            return apply_fn
        if isinstance(e, CastExpression):
            f = self.compile_inner(e._expr, layout)
            caster = _make_caster(e._target)
            return lambda k, r: None if (v := f(k, r)) is None else caster(v)
        if isinstance(e, ConvertExpression):
            f = self.compile_inner(e._expr, layout)
            conv = _make_converter(e._target)
            unwrap_flag = e._unwrap
            default = e._default

            def conv_fn(k, r):
                v = f(k, r)
                out = conv(v)
                if out is None:
                    if unwrap_flag:
                        raise ValueError(f"cannot convert {v!r}")
                    return default
                return out

            return conv_fn
        if isinstance(e, DeclareTypeExpression):
            return self.compile_inner(e._expr, layout)
        if isinstance(e, UnwrapExpression):
            f = self.compile_inner(e._expr, layout)

            def unwrap_fn(k, r):
                v = f(k, r)
                if v is None:
                    raise ValueError("unwrap() got None")
                return v

            return unwrap_fn
        if isinstance(e, FillErrorExpression):
            f = self.compile_inner(e._expr, layout)
            g = self.compile_inner(e._replacement, layout)

            def fill_fn(k, r):
                try:
                    v = f(k, r)
                except Exception:
                    return g(k, r)
                if isinstance(v, Error):
                    return g(k, r)
                return v

            return fill_fn
        if isinstance(e, IfElseExpression):
            cf = self.compile_inner(e._if, layout)
            tf = self.compile_inner(e._then, layout)
            ef = self.compile_inner(e._else, layout)

            def ifelse_fn(k, r):
                c = cf(k, r)
                if c is None:
                    return None
                return tf(k, r) if c else ef(k, r)

            return ifelse_fn
        if isinstance(e, CoalesceExpression):
            fns = [self.compile_inner(a, layout) for a in e._args]

            def coalesce_fn(k, r):
                for f in fns:
                    v = f(k, r)
                    if v is not None:
                        return v
                return None

            return coalesce_fn
        if isinstance(e, RequireExpression):
            vf = self.compile_inner(e._val, layout)
            fns = [self.compile_inner(a, layout) for a in e._args]

            def require_fn(k, r):
                for f in fns:
                    if f(k, r) is None:
                        return None
                return vf(k, r)

            return require_fn
        if isinstance(e, IsNotNoneExpression):
            f = self.compile_inner(e._expr, layout)
            return lambda k, r: f(k, r) is not None
        if isinstance(e, IsNoneExpression):
            f = self.compile_inner(e._expr, layout)
            return lambda k, r: f(k, r) is None
        if isinstance(e, MakeTupleExpression):
            fns = [self.compile_inner(a, layout) for a in e._args]
            return lambda k, r: tuple(f(k, r) for f in fns)
        if isinstance(e, SequenceGetExpression):
            f = self.compile_inner(e._expr, layout)
            idxf = self.compile_inner(e._index, layout)
            dff = self.compile_inner(e._default, layout)
            checked = e._check_if_exists

            def get_fn(k, r):
                obj = f(k, r)
                idx = idxf(k, r)
                if obj is None:
                    return dff(k, r) if checked else None
                try:
                    if isinstance(obj, Json):
                        if checked:
                            return obj.get(idx, dff(k, r))
                        return obj[idx]
                    return obj[idx]
                except (IndexError, KeyError, TypeError):
                    if checked:
                        return dff(k, r)
                    raise

            return get_fn
        if isinstance(e, MethodCallExpression):
            fns = [self.compile_inner(a, layout) for a in e._args]
            fn = e._fn
            prop = e._propagate_none

            def method_fn(k, r):
                args = [f(k, r) for f in fns]
                if prop and args and args[0] is None:
                    return None
                return fn(*args)

            return method_fn
        if isinstance(e, PointerExpression):
            fns = [self.compile_inner(a, layout) for a in e._args]
            optional = e._optional

            def ptr_fn(k, r):
                vals = [f(k, r) for f in fns]
                if optional and any(v is None for v in vals):
                    return None
                return ref_scalar(*vals)

            return ptr_fn
        if isinstance(e, ReducerExpression):
            raise RuntimeError("reducers are only valid inside reduce()")
        raise NotImplementedError(f"cannot compile {type(e).__name__}")


class _ZipNode(df._KeyedStateNode):
    """Zip same-universe tables into one row (the analog of the
    reference's per-universe storage layout, storage_graph.py:217)."""

    def __init__(self, graph, n_inputs):
        super().__init__(graph, n_inputs, "Zip")

    def compute_key(self, key):
        parts = []
        for port in range(self.n_inputs):
            row = self.state[port].get(key)
            if row is None:
                return None
            parts.append(row)
        out = ()
        for p in parts:
            out = out + p
        return out


def _slot_getter(i: int) -> Callable:
    return lambda k, r: r[i]


def _contains_reducer(e: ColumnExpression) -> bool:
    found = False

    def visit(x):
        nonlocal found
        if isinstance(x, ReducerExpression):
            found = True

    walk_expression(e, visit)
    return found


def _refs_table(e: ColumnExpression, table: Table) -> bool:
    found = False

    def visit(x):
        nonlocal found
        if isinstance(x, ColumnReference) and x._table is table:
            found = True

    walk_expression(e, visit)
    return found


def _make_caster(target: dt.DType):
    t = dt.unoptionalize(target)
    if t is dt.INT:
        return lambda v: int(v)
    if t is dt.FLOAT:
        return lambda v: float(v)
    if t is dt.STR:
        return lambda v: str(v)
    if t is dt.BOOL:
        return lambda v: bool(v)
    if t is dt.BYTES:
        return lambda v: bytes(v)
    return lambda v: v


def _make_converter(target: dt.DType):
    t = dt.unoptionalize(target)

    def conv(v):
        if v is None:
            return None
        if isinstance(v, Json):
            if t is dt.INT:
                return v.as_int()
            if t is dt.FLOAT:
                return v.as_float()
            if t is dt.STR:
                return v.as_str()
            if t is dt.BOOL:
                return v.as_bool()
            return v.value
        try:
            if t is dt.INT:
                return int(v) if not isinstance(v, bool) else None
            if t is dt.FLOAT:
                return float(v)
            if t is dt.STR:
                return v if isinstance(v, str) else None
            if t is dt.BOOL:
                return v if isinstance(v, bool) else None
        except (ValueError, TypeError):
            return None
        return v

    return conv


import datetime as _dtm
import operator as _op


def _div(a, b):
    if isinstance(a, _dtm.timedelta) and isinstance(b, _dtm.timedelta):
        return a / b
    return a / b


_BINOPS: dict[str, Callable] = {
    "+": _op.add,
    "-": _op.sub,
    "*": _op.mul,
    "/": _div,
    "//": _op.floordiv,
    "%": _op.mod,
    "**": _op.pow,
    "@": _op.matmul,
    "==": lambda a, b: df.rows_equal((a,), (b,)),
    "!=": lambda a, b: not df.rows_equal((a,), (b,)),
    "<": _op.lt,
    "<=": _op.le,
    ">": _op.gt,
    ">=": _op.ge,
    "&": lambda a, b: (a and b) if isinstance(a, bool) else a & b,
    "|": lambda a, b: (a or b) if isinstance(a, bool) else a | b,
    "^": _op.xor,
}
