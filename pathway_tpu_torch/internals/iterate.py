"""pw.iterate — fixed-point iteration.

Rebuild of the reference's iterate (Graph::iterate src/engine/graph.rs,
python internals/operator.py IterateOperator). Implementation: per
epoch, the engine maintains the input tables' state; the body executes
as a batch fixpoint (rebuild + rerun a fresh inner graph per iteration)
and each returned table's fixpoint is diffed against the previous
epoch's output. Semantics match for deterministic bodies; incremental
nested timestamps are not needed for totally-ordered times.

Multi-table form (as the reference's louvain uses it): every keyword
table is visible to ``func``; the tables it RETURNS (dict keys /
dataclass fields) iterate until they all converge, the rest stay
constant within the epoch. A single returned Table comes back as a
Table; multiple come back as a namespace with one Table per name.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable

from ..engine import dataflow as df
from ..engine.value import rows_equal
from .table import Column, LogicalOp, Table
from .universe import Universe


class _IterateHubNode(df.Node):
    """Holds every input table's current state; per epoch, recompute the
    batch fixpoint and emit per-output diffs tagged with the output
    index ((key, (idx, row), diff) — unpacked by _IterateSelectNode)."""

    _snap_attrs = ("states", "pending", "emitted")

    def route_owner(self, key, row, port, n_shards):
        # the fixpoint body sees the whole input state: pin to shard 0
        # (per-key sharding would split connected components)
        return 0

    def __init__(
        self,
        graph,
        body: Callable,  # ({name: {key: row}}) -> {out_name: {key: row}}
        in_names: list[str],
        out_names: list[str],
        limit: int | None,
    ):
        self.n_inputs = len(in_names)
        super().__init__(graph, "Iterate")
        self.body = body
        self.in_names = in_names
        self.out_names = out_names
        self.limit = limit
        self.states: dict[str, dict[int, tuple]] = {n: {} for n in in_names}
        self.pending: dict[tuple, list] = {}  # out-of-order versions: df.apply_keyed
        self.emitted: dict[str, dict[int, tuple]] = {n: {} for n in out_names}

    def process(self, time):
        any_updates = False
        for port, name in enumerate(self.in_names):
            updates = self.take(port)
            if not updates:
                continue
            any_updates = True
            st = self.states[name]
            for key, row, diff in updates:
                df.apply_keyed(st, self.pending, (name, key), key, row, diff)
        if not any_updates:
            return
        new_outs = self._fixpoint({n: dict(st) for n, st in self.states.items()})
        out = []
        for idx, name in enumerate(self.out_names):
            new_out = new_outs[name]
            emitted = self.emitted[name]
            for key, row in emitted.items():
                nrow = new_out.get(key)
                if nrow is None or not rows_equal(row, nrow):
                    out.append((key, (idx, row), -1))
            for key, nrow in new_out.items():
                orow = emitted.get(key)
                if orow is None or not rows_equal(orow, nrow):
                    out.append((key, (idx, nrow), 1))
            self.emitted[name] = new_out
        self.emit(out, time)

    def _fixpoint(self, states: dict[str, dict[int, tuple]]) -> dict[str, dict[int, tuple]]:
        current = {n: states[n] for n in self.out_names}
        iteration = 0
        while True:
            iteration += 1
            nxt = self.body({**states, **current})
            if all(_same_table(current[n], nxt[n]) for n in self.out_names):
                return nxt
            current = nxt
            if self.limit is not None and iteration >= self.limit:
                return current


class _IterateSelectNode(df.Node):
    """Untag one output of the iterate hub."""

    def __init__(self, graph, idx: int):
        super().__init__(graph, f"IterateOut{idx}")
        self.idx = idx

    def process(self, time):
        idx = self.idx
        out = [
            (key, tagged[1], diff)
            for key, tagged, diff in self.take()
            if tagged[0] == idx
        ]
        self.emit(out, time)


def _same_table(a: dict[int, tuple], b: dict[int, tuple]) -> bool:
    if len(a) != len(b):
        return False
    for k, row in a.items():
        other = b.get(k)
        if other is None or not rows_equal(row, other):
            return False
    return True


def _result_tables(result: Any) -> dict[str, Table]:
    """Normalize func's return value to {name: Table}."""
    if isinstance(result, Table):
        return {"__single__": result}
    if isinstance(result, dict):
        out = {k: v for k, v in result.items() if isinstance(v, Table)}
        if not out:
            raise TypeError("pw.iterate body returned no tables")
        return out
    fields = {
        k: v for k, v in vars(result).items() if isinstance(v, Table)
    }
    if not fields:
        raise TypeError(f"pw.iterate body returned {type(result).__name__} with no tables")
    return fields


def iterate(
    func: Callable,
    iteration_limit: int | None = None,
    **kwargs: Table,
) -> Any:
    """pw.iterate(func, **tables): repeatedly apply func until every
    table it returns stops changing. Tables passed but not returned are
    constants within the epoch (the reference's louvain passes V/WE
    this way). All tables the body reads must arrive via ``kwargs``."""
    if not kwargs:
        raise ValueError("pw.iterate needs at least one table argument")
    in_names = list(kwargs.keys())
    in_tables = [kwargs[n] for n in in_names]

    # probe once on the OUTER tables to learn output names/columns (the
    # registered logical ops are tree-shaken away)
    probe_out = _result_tables(func(**kwargs))
    out_names = list(probe_out.keys())
    single = out_names == ["__single__"]
    if single and len(in_names) > 1:
        # with several tables a bare return is ambiguous (kwargs order
        # would silently pick the iterated one) — require named returns
        raise ValueError(
            "pw.iterate with multiple tables needs the body to return a "
            "dict (or dataclass) naming the iterated table(s), e.g. "
            "dict(state=...)"
        )
    for n in out_names:
        if not single and n not in kwargs:
            raise ValueError(
                f"pw.iterate body returned table {n!r} that is not among "
                f"its arguments {in_names}"
            )
        in_name = in_names[0] if single else n
        got = sorted(probe_out[n]._columns.keys())
        want = sorted(kwargs[in_name]._columns.keys())
        if got != want:
            raise ValueError(
                f"pw.iterate body returned table {in_name!r} with columns "
                f"{got}, but the iterated input has {want} — the returned "
                f"table feeds back as next iteration's input, so column "
                f"names must match"
            )

    input_col_names = {n: list(t._columns.keys()) for n, t in kwargs.items()}

    def body(states: dict[str, dict[int, tuple]]) -> dict[str, dict[int, tuple]]:
        from .graph_runner import GraphRunner

        inner_tables = {}
        for name, outer in zip(in_names, in_tables):
            records = [(k, r, 0, 1) for k, r in states[name].items()]
            cols = {n: Column(c.dtype) for n, c in outer._columns.items()}
            op = LogicalOp("static", [], {"rows": records})
            inner_tables[name] = Table(
                cols, Universe(), op, name=f"iterate_{name}"
            )
        result = _result_tables(func(**inner_tables))
        runner = GraphRunner()
        caps = {name: runner.capture(t) for name, t in result.items()}
        runner.run()
        out: dict[str, dict[int, tuple]] = {}
        for name, (cap, out_cols) in caps.items():
            # rows feed back as the NEXT iteration's input: reorder them
            # from the body-output column order into the input table's
            # order (else a reordering select would silently swap values)
            want = input_col_names.get(name if name != "__single__" else in_names[0])
            if want is not None and out_cols != want:
                if sorted(out_cols) != sorted(want):
                    raise ValueError(
                        f"pw.iterate body returned table {name!r} with "
                        f"columns {out_cols}, but the iterated input has "
                        f"{want} — names must match"
                    )
                idx = [out_cols.index(n) for n in want]
                out[name] = {
                    k: tuple(r[i] for i in idx) for k, r in cap.state.items()
                }
            else:
                out[name] = dict(cap.state)
        return out

    if single:
        # a bare returned Table iterates the FIRST keyword table
        raw_body = body

        def hub_body(states):
            return {in_names[0]: raw_body(states)["__single__"]}

        hub_out_names = [in_names[0]]
        probe_out = {in_names[0]: probe_out["__single__"]}
    else:
        hub_out_names = out_names
        hub_body = body

    op = LogicalOp(
        "iterate",
        in_tables,
        {
            "body": hub_body,
            "in_names": in_names,
            "out_names": hub_out_names,
            "limit": iteration_limit,
        },
    )
    out_tables: dict[str, Table] = {}
    for idx, name in enumerate(hub_out_names):
        probe_table = probe_out[name]  # single case was re-keyed above
        # rows circulate in the INPUT table's column order (see body's
        # reorder), so the output table declares that order too
        cols = {
            n: Column(probe_table._columns[n].dtype)
            for n in input_col_names[name]
        }
        sub = LogicalOp("iterate_output", [], {"parent": op, "index": idx})
        out_tables[name] = Table(cols, Universe(), sub, name=f"iterate:{name}")
    if single:
        return out_tables[in_names[0]]
    return SimpleNamespace(**out_tables)


def iterate_universe(func: Callable, **kwargs) -> Any:
    return iterate(func, **kwargs)
