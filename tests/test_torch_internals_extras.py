"""The port's ``internals`` extras against the JAX package's, on the CPU.

``pw.iterate``, row transformers (``pw.transformer`` / ``ClassArg`` and
the attribute decorators), ``pw.sql``, ``export_table`` /
``import_table``, ``pw.load_yaml``, ``LiveTable`` / ``Table.live`` and
``pw.universes``. Every case builds the same pipeline with
``pathway_tpu`` and with ``pathway_tpu_torch`` (``build(pw)`` takes
either package as ``pw``) and asserts exact equality of the final tables
and of the update streams (key, row, time, diff), at 1 and 4 engine
workers; where the reference's own test states the values, the port's
result is held to them as well. The cases mirror the reference's
``tests/test_iterate_breadth.py``, ``test_row_transformer.py``,
``test_sql.py``, ``test_sql_breadth.py``, the export / import and
``load_yaml`` cases of ``test_aux_subsystems.py``, the ``LiveTable`` case
of ``test_connectors_extra.py`` and the iterate fixpoint of
``test_sharded_ops_matrix.py``. Each package has its own global parse
graph; both are cleared around every case."""

from __future__ import annotations

import math
import pickle

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner

RUNNERS = {jpw: JRunner, tpw: TRunner}


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _norm(v):
    """A value comparable across the packages: each has its own ``Pointer``."""
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


def _run(pw, build, n_workers=1):
    """(final state {key: row}, update stream sorted by (time, key, diff), column names)."""
    table = build(pw)
    runner = RUNNERS[pw](n_workers=n_workers)
    cap, names = runner.capture(table)
    runner.run()
    pw.clear_graph()
    stream = sorted(((int(k), _norm(tuple(r)), int(t), int(d)) for k, r, t, d in cap.stream),
                    key=lambda e: (e[2], e[0], e[3], repr(e[1])))
    return {int(k): _norm(tuple(r)) for k, r in cap.state.items()}, stream, list(names)


def _rows(state):
    return sorted(state.values(), key=repr)


# ---- pw.iterate (reference tests/test_iterate_breadth.py) ----


def _collatz(pw):
    def step(t):
        return t.select(
            n=pw.if_else(pw.this.n == 1, 1, pw.if_else(pw.this.n % 2 == 0, pw.this.n // 2, 3 * pw.this.n + 1)),
            steps=pw.if_else(pw.this.n == 1, pw.this.steps, pw.this.steps + 1),
        )

    t = pw.debug.table_from_markdown("""
      | n  | steps
    1 | 6  | 0
    2 | 27 | 0
    3 | 1  | 0
    """)
    return pw.iterate(step, t=t)


def _components(pw):
    def step(labels, edges):
        joined = edges.join(labels, edges.dst == labels.id_val).select(src=edges.src, lbl=labels.lbl)
        best = joined.groupby(pw.this.src).reduce(src=pw.this.src, m=pw.reducers.min(pw.this.lbl))
        m = best.ix_ref(pw.this.id_val, optional=True).m
        cand = pw.coalesce(m, pw.this.lbl)
        return dict(labels=labels.select(id_val=pw.this.id_val, lbl=pw.if_else(cand < pw.this.lbl, cand, pw.this.lbl)))

    labels = pw.debug.table_from_markdown("""
      | id_val | lbl
    1 | 1      | 1
    2 | 2      | 2
    3 | 3      | 3
    4 | 4      | 4
    """)
    edges = pw.debug.table_from_markdown("""
      | src | dst
    7 | 2   | 1
    8 | 3   | 2
    9 | 1   | 2
    """)
    return pw.iterate(step, labels=labels, edges=edges).labels


def _iteration_limit(pw):
    t = pw.debug.table_from_markdown("""
      | n
    1 | 1
    """)
    return pw.iterate(lambda t: t.select(n=pw.this.n * 2), iteration_limit=3, t=t)


def _iterate_streamed(pw):
    t = pw.debug.table_from_markdown("""
      | n | __time__ | __diff__
    1 | 1 | 2        | 1
    2 | 3 | 4        | 1
    1 | 1 | 6        | -1
    """)
    return pw.iterate(lambda t: t.select(n=pw.if_else(pw.this.n < 10, pw.this.n + 1, pw.this.n)), t=t)


def _bellman_ford(pw):
    """The iterate fixpoint of the reference's sharded matrix: its
    ``stdlib.graphs.bellman_ford`` body, written out over ``pw.iterate``."""
    verts = pw.debug.table_from_markdown("""
      | name | is_source
    1 | a    | True
    2 | b    | False
    3 | c    | False
    4 | d    | False
    5 | e    | False
    """).with_id_from(pw.this.name)
    raw = pw.debug.table_from_markdown("""
      | u | v | dist
    1 | a | b | 1.0
    2 | b | c | 2.0
    3 | a | c | 10.0
    4 | c | d | 1.0
    """)
    edges = raw.select(u=verts.pointer_from(raw.u), v=verts.pointer_from(raw.v), dist=raw.dist)
    init = verts.select(dist_from_source=pw.if_else(verts.is_source, 0.0, math.inf))

    def step(state):
        relaxed = edges.select(v=edges.v, dist=state.ix(edges.u).dist_from_source + edges.dist)
        best = relaxed.groupby(relaxed.v).reduce(v=relaxed.v, dist=pw.reducers.min(relaxed.dist)).with_id_from(
            pw.this.v)
        return state.select(dist_from_source=pw.apply_with_type(
            min, float, state.dist_from_source, pw.coalesce(best.ix_ref(state.id, optional=True).dist, math.inf)))

    return pw.iterate(step, iteration_limit=50, state=init)


# ---- row transformers (reference tests/test_row_transformer.py) ----


def _linked_list(pw):
    from importlib import import_module

    internals = import_module(pw.__name__ + ".internals.table")
    universe = import_module(pw.__name__ + ".internals.universe")
    dtype = import_module(pw.__name__ + ".internals.dtype")

    @pw.transformer
    class compute_lengths:
        class linked_list(pw.ClassArg):
            next = pw.input_attribute()

            @pw.output_attribute
            def len(self) -> int:
                if self.next is None:
                    return 0
                return 1 + self.transformer.linked_list[self.next].len

    keys = [int(pw.ref_scalar("node", i)) for i in range(4)]
    recs = [(k, (pw.Pointer(keys[i + 1]) if i + 1 < len(keys) else None,), 0, 1) for i, k in enumerate(keys)]
    chain = internals.Table({"next": internals.Column(dtype.ANY)}, universe.Universe(),
                            internals.LogicalOp("static", [], {"rows": recs}), name="linked_list")
    return compute_lengths(linked_list=chain).linked_list


def _two_tables(pw):
    @pw.transformer
    class deref:
        class targets(pw.ClassArg):
            val = pw.input_attribute()

        class refs(pw.ClassArg):
            target = pw.input_attribute()

            @pw.output_attribute
            def resolved(self) -> int:
                return self.transformer.targets[self.target].val * 2

    base = pw.debug.table_from_markdown("""
      | val
    1 | 10
    2 | 20
    """).with_id_from(pw.this.val)
    refs = pw.debug.table_from_markdown("""
      | to
    5 | 10
    6 | 20
    7 | 10
    """)
    refs = refs.select(target=base.pointer_from(refs.to))
    return deref(targets=base, refs=refs).refs


def _computed_attribute(pw):
    @pw.transformer
    class t:
        class rows(pw.ClassArg):
            x = pw.input_attribute()

            @pw.attribute
            def doubled(self):
                return self.x * 2

            @pw.output_attribute
            def out(self) -> int:
                return self.doubled + 1

            @pw.output_attribute
            def self_id(self):
                return self.id

    tab = pw.debug.table_from_markdown("""
      | x
    1 | 1
    2 | 5
    """)
    return t(rows=tab).rows


def _transformer_incremental(pw):
    @pw.transformer
    class double:
        class rows(pw.ClassArg):
            x = pw.input_attribute()

            @pw.output_attribute
            def y(self) -> int:
                return self.x * 10

    tab = pw.debug.table_from_markdown("""
      | x | __time__ | __diff__
    1 | 1 | 0        | 1
    2 | 2 | 0        | 1
    1 | 1 | 2        | -1
    3 | 4 | 4        | 1
    """)
    return double(rows=tab).rows


def _method_column(pw):
    @pw.transformer
    class foo_transformer:
        class table(pw.ClassArg):
            a = pw.input_attribute()

            @pw.output_attribute
            def b(self) -> int:
                return self.a * 10

            @pw.method
            def c(self, arg) -> int:
                return (self.a + self.b) * arg

    t = pw.debug.table_from_markdown("""
      | a
    1 | 1
    2 | 2
    3 | 3
    """)
    mt = foo_transformer(table=t).table
    return mt.select(ret=mt.c(10))


def _method_from_attribute(pw):
    @pw.transformer
    class foo_transformer:
        class table(pw.ClassArg):
            a = pw.input_attribute()

            @pw.output_attribute
            def b(self) -> int:
                return self.a + self.c(self.a)

            @pw.method
            def c(self, arg) -> int:
                return self.a * arg

    t = pw.debug.table_from_markdown("""
      | a
    1 | 1
    """)
    mt = foo_transformer(table=t).table
    return mt.select(ret=mt.b)


def _method_streams(pw):
    @pw.transformer
    class foo_transformer:
        class table(pw.ClassArg):
            a = pw.input_attribute()

            @pw.method
            def scaled(self, k) -> int:
                return self.a * k

    t = pw.debug.table_from_markdown("""
      | a | __time__ | __diff__
    1 | 1 | 2        | 1
    2 | 5 | 4        | 1
    """)
    mt = foo_transformer(table=t).table
    return mt.select(ret=mt.scaled(3))


def _method_invalidates(pw):
    @pw.transformer
    class foo_transformer:
        class table(pw.ClassArg):
            a = pw.input_attribute()

            @pw.method
            def plus_peer_sum(self, k) -> int:
                total = 0
                for key in list(self.transformer.table._ctx.states["table"]):
                    total += self.transformer.table[pw.Pointer(key)].a
                return total * k

    t = pw.debug.table_from_markdown("""
      | a | __time__ | __diff__
    1 | 1 | 2        | 1
    2 | 4 | 4        | 1
    """)
    mt = foo_transformer(table=t).table
    return mt.select(ret=mt.plus_peer_sum(10))


# ---- pw.sql (reference tests/test_sql.py, test_sql_breadth.py) ----

SALES = """
  | city   | amount
1 | paris  | 10
2 | paris  | 30
3 | berlin | 5
4 | tokyo  | 20
"""

POP = """
  | city   | pop
1 | paris  | 2
2 | berlin | 4
"""

SALES2 = """
  | region | item | qty | price
1 | north  | pen  | 10  | 1.5
2 | north  | pad  | 3   | 4.0
3 | south  | pen  | 7   | 1.5
4 | south  | ink  | 2   | 9.0
5 | east   | pen  | 1   | 1.5
"""

COEF = """
  | region | factor
7 | north  | 2
8 | south  | 3
"""

ONE_V = """
  | v
1 | 1
2 | 2
"""

TWO_V = """
  | v
8 | 2
9 | 3
"""

KV_A = """
  | x | v
1 | k | 100
"""

KV_B = """
  | x | v
1 | k | 999
"""

STREAM_G = """
  | g | v | __time__ | __diff__
1 | a | 1 | 2        | 1
2 | a | 2 | 4        | 1
2 | a | 2 | 6        | -1
"""

# name -> (query, {table name: markdown}, the reference's stated rows, sorted by repr, or None)
SQL_CASES = {
    "select_where": ("SELECT city, amount FROM sales WHERE amount > 9", {"sales": SALES},
                     [("paris", 10), ("paris", 30), ("tokyo", 20)]),
    "group_by": ("SELECT city, SUM(amount) AS total, COUNT(*) AS n FROM sales GROUP BY city", {"sales": SALES},
                 [("berlin", 5, 1), ("paris", 40, 2), ("tokyo", 20, 1)]),
    "expressions_aliases": ("SELECT city, amount * 2 AS double_amount FROM sales WHERE city = 'paris'",
                            {"sales": SALES}, [("paris", 20), ("paris", 60)]),
    "join": ("SELECT s.city, s.amount, p.pop FROM sales s JOIN pop p ON s.city = p.city",
             {"sales": SALES, "pop": POP}, [("berlin", 5, 4), ("paris", 10, 2), ("paris", 30, 2)]),
    "join_group_having": ("SELECT s.city, SUM(s.amount) AS total FROM sales s JOIN pop p "
                          "ON s.city = p.city GROUP BY s.city HAVING SUM(s.amount) > 10",
                          {"sales": SALES, "pop": POP}, [("paris", 40)]),
    "join_colliding_names": ("SELECT a.v AS av, b.v AS bv FROM a JOIN b ON a.x = b.x", {"a": KV_A, "b": KV_B},
                             [(100, 999)]),
    "having": ("SELECT city, SUM(amount) AS total FROM sales GROUP BY city HAVING SUM(amount) > 10",
               {"sales": SALES}, [("paris", 40), ("tokyo", 20)]),
    "arithmetic_projection": ("SELECT item, qty * price AS revenue FROM t WHERE qty > 2", {"t": SALES2},
                              [("pad", 12.0), ("pen", 10.5), ("pen", 15.0)]),
    "where_and_or_not": ("SELECT item FROM t WHERE (region = 'north' OR region = 'south') AND NOT item = 'ink'",
                         {"t": SALES2}, [("pad",), ("pen",), ("pen",)]),
    "multiple_aggregates": ("SELECT region, COUNT(*) AS n, SUM(qty) AS total, MIN(price) AS lo, MAX(price) AS hi, "
                            "AVG(qty) AS mean FROM t GROUP BY region", {"t": SALES2},
                            [("east", 1, 1, 1.5, 1.5, 1.0), ("north", 2, 13, 1.5, 4.0, 6.5),
                             ("south", 2, 9, 1.5, 9.0, 4.5)]),
    "having_aggregate": ("SELECT region, SUM(qty) AS total FROM t GROUP BY region HAVING SUM(qty) > 5",
                         {"t": SALES2}, [("north", 13), ("south", 9)]),
    "join_aliases": ("SELECT s.item, s.qty * c.factor AS adj FROM sales s JOIN coef c ON s.region = c.region",
                     {"sales": SALES2, "coef": COEF}, [("ink", 6), ("pad", 6), ("pen", 20), ("pen", 21)]),
    "union_all": ("SELECT v FROM a UNION ALL SELECT v FROM b", {"a": ONE_V, "b": TWO_V}, None),
    "comparison_operators": ("SELECT item FROM t WHERE price >= 1.5 AND price <= 4.0 AND item <> 'pad'",
                             {"t": SALES2}, [("pen",), ("pen",), ("pen",)]),
    "streamed_input": ("SELECT g, SUM(v) AS s FROM t GROUP BY g", {"t": STREAM_G}, [("a", 1)]),
    "union_distinct": ("SELECT v FROM a UNION SELECT v FROM b", {"a": ONE_V, "b": TWO_V}, [(1,), (2,), (3,)]),
    "intersect": ("SELECT v FROM a INTERSECT SELECT v FROM b", {"a": ONE_V, "b": TWO_V}, [(2,)]),
}


def _sql_case(query, tables):
    def build(pw):
        return pw.sql(query, **{n: pw.debug.table_from_markdown(md) for n, md in tables.items()})

    return build


CASES = {
    "iterate_collatz": _collatz,
    "iterate_components": _components,
    "iterate_limit": _iteration_limit,
    "iterate_streamed": _iterate_streamed,
    "iterate_bellman_ford": _bellman_ford,
    "transformer_linked_list": _linked_list,
    "transformer_two_tables": _two_tables,
    "transformer_computed_attribute": _computed_attribute,
    "transformer_incremental": _transformer_incremental,
    "method_column": _method_column,
    "method_from_attribute": _method_from_attribute,
    "method_streams": _method_streams,
    "method_invalidates": _method_invalidates,
    **{f"sql_{name}": _sql_case(q, tabs) for name, (q, tabs, _) in SQL_CASES.items()},
}

CHECKS = {
    "iterate_collatz": lambda s: all(r[0] == 1 for r in s.values()) and sorted(r[1] for r in s.values()) == [0, 8, 111],
    "iterate_components": lambda s: sorted(s.values()) == [(1, 1), (2, 1), (3, 1), (4, 4)],
    "iterate_limit": lambda s: list(s.values()) == [(8,)],
    "iterate_streamed": lambda s: sorted(s.values()) == [(10,)],
    "iterate_bellman_ford": lambda s: sorted(r[0] for r in s.values()) == [0.0, 1.0, 3.0, 4.0, math.inf],
    "transformer_linked_list": lambda s: sorted(r[0] for r in s.values()) == [0, 1, 2, 3],
    "transformer_two_tables": lambda s: sorted(r[0] for r in s.values()) == [20, 20, 40],
    "transformer_computed_attribute": lambda s: sorted(r[0] for r in s.values()) == [3, 11]
    and all(r[1] == ("ptr", k) for k, r in s.items()),
    "transformer_incremental": lambda s: sorted(r[0] for r in s.values()) == [20, 40],
    "method_column": lambda s: sorted(s.values()) == [(110,), (220,), (330,)],
    "method_from_attribute": lambda s: list(s.values()) == [(2,)],
    "method_streams": lambda s: sorted(s.values()) == [(3,), (15,)],
    "method_invalidates": lambda s: sorted(s.values()) == [(50,), (50,)],
    **{f"sql_{name}": (lambda s, want=want: _rows(s) == sorted(want, key=repr))
       for name, (_, _, want) in SQL_CASES.items() if want is not None},
}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_internals_case_equals_reference(case, n_workers):
    want = _run(jpw, CASES[case], n_workers)
    got = _run(tpw, CASES[case], n_workers)
    assert got == want
    assert got[0], "the pipeline produced no rows"
    if case in CHECKS:
        assert CHECKS[case](got[0]), got


@pytest.mark.parametrize("case", ["iterate_bellman_ford", "iterate_components", "transformer_incremental"])
def test_four_workers_equal_one(case):
    """The iterate hub and the transformer node pin their state to one
    shard: a 4-worker run gives the 1-worker fixpoint."""
    one, four = _run(tpw, CASES[case], 1), _run(tpw, CASES[case], 4)
    assert four[0] == one[0] and sorted(four[1]) == sorted(one[1])


def test_sql_equals_the_table_api():
    """The reference's DSL-equivalence case: a GROUP BY query and the same
    ``groupby().reduce()`` give the same rows."""
    def via(pw, use_sql):
        t = pw.debug.table_from_markdown(SALES2)
        if use_sql:
            return pw.sql("SELECT region, SUM(qty) AS total FROM t GROUP BY region", t=t)
        return t.groupby(pw.this.region).reduce(pw.this.region, total=pw.reducers.sum(pw.this.qty))

    out = {(pw, use_sql): _rows(_run(pw, lambda pw: via(pw, use_sql))[0]) for pw in (jpw, tpw) for use_sql in (0, 1)}
    assert len({tuple(v) for v in out.values()}) == 1


@pytest.mark.parametrize("failure", ["iterate_mismatched_columns", "transformer_cycle", "sql_unknown_column"])
def test_failures_equal_the_reference(failure):
    """The same inputs fail alike: a body that renames the iterated
    column, an attribute cycle (routed through the engine's error
    handling) and an unknown SQL column."""
    def build(pw):
        if failure == "iterate_mismatched_columns":
            t = pw.debug.table_from_markdown("""
              | n
            1 | 1
            """)
            return pw.iterate(lambda t: t.select(other=pw.this.n), t=t)
        if failure == "transformer_cycle":
            @pw.transformer
            class cyc:
                class rows(pw.ClassArg):
                    x = pw.input_attribute()

                    @pw.output_attribute
                    def a(self):
                        return self.b

                    @pw.output_attribute
                    def b(self):
                        return self.a

            return cyc(rows=pw.debug.table_from_markdown("""
              | x
            1 | 1
            """)).rows
        return pw.sql("SELECT nosuch FROM t", t=pw.debug.table_from_markdown(SALES2))

    kinds = {}
    for pw in (jpw, tpw):
        with pytest.raises(Exception) as info:
            _run(pw, build)
        pw.clear_graph()
        kinds[pw] = (type(info.value).__name__, "column" in str(info.value))
    assert kinds[tpw] == kinds[jpw]
    if failure == "transformer_cycle":
        assert kinds[tpw][0] == "EngineError"
    if failure == "iterate_mismatched_columns":
        assert kinds[tpw] == ("ValueError", True)


def test_method_cells_pickle_and_snapshot_like_the_reference():
    """A pickled method cell re-binds to the live transformer node, and the
    node's own snapshot stores markers that its restore turns back into
    callable cells."""
    from pathway_tpu_torch.internals.row_transformer import BoundMethod, _MethodAttribute, _RowTransformerNode

    assert isinstance(tpw.method(lambda self: 1), _MethodAttribute)

    @tpw.transformer
    class rebind_transformer:
        class table(tpw.ClassArg):
            a = tpw.input_attribute()

            @tpw.method
            def c(self, arg) -> int:
                return self.a * arg

    t = tpw.debug.table_from_markdown("""
      | a
    1 | 7
    """)
    mt = rebind_transformer(table=t).table
    runner = TRunner()
    cap, names = runner.capture(mt)
    runner.run()
    (row,) = cap.state.values()
    cell = row[names.index("c")]
    assert cell(10) == 70
    restored = pickle.loads(pickle.dumps(cell))
    assert restored._node is None and restored(10) == 70
    node = next(n for n in runner.engine.nodes if isinstance(n, _RowTransformerNode))
    state = node.snapshot_state()
    assert not any(isinstance(v, BoundMethod) for r in state["emitted"].values() for v in r)
    node.emitted = {}
    node.restore_state(state)
    cells = [v for r in node.emitted.values() for v in r if isinstance(v, BoundMethod)]
    assert cells and cells[0](1) == 7


# ---- export / import, load_yaml, LiveTable, universes ----


def test_export_import_roundtrip_equals_reference():
    out = {}
    for pw in (jpw, tpw):
        t = pw.debug.table_from_markdown("""
          | word | n
        1 | a    | 1
        2 | b    | 2
        3 | a    | 4
        """)
        exported = pw.export_table(t.groupby(pw.this.word).reduce(word=pw.this.word, n=pw.reducers.sum(pw.this.n)))
        pw.clear_graph()
        imp = pw.import_table(exported)
        out[pw] = (sorted(exported.rows.values()), _run(pw, lambda pw: imp.select(word=pw.this.word, n2=pw.this.n * 2)))
    assert out[tpw] == out[jpw]
    assert out[tpw][0] == [("a", 5), ("b", 2)] and _rows(out[tpw][1][0]) == [("a", 10), ("b", 4)]
    assert isinstance(exported, tpw.ExportedTable)


@pytest.mark.parametrize("n_workers", [1, 4])
def test_export_import_with_history_equals_reference(n_workers):
    out = {}
    for pw in (jpw, tpw):
        t = pw.debug.table_from_markdown("""
          | v | __time__ | __diff__
        1 | 1 | 0        | 1
        1 | 1 | 2        | -1
        2 | 5 | 2        | 1
        """)
        exported = pw.export_table(t)
        pw.clear_graph()
        imp = pw.import_table(exported, with_history=True)
        out[pw] = _run(pw, lambda pw: imp, n_workers)
    assert out[tpw] == out[jpw]
    assert list(out[tpw][0].values()) == [(5,)] and len(out[tpw][1]) == 3


def test_load_yaml_equals_reference(tmp_path):
    cfg = tmp_path / "pipeline.yaml"
    cfg.write_text("""
$run_name: demo
splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  max_tokens: 100
name: $run_name
nested:
  k: 5
  items: [$run_name, 2]
""")
    loaded = {pw: pw.load_yaml(open(cfg)) for pw in (jpw, tpw)}
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    assert isinstance(loaded[tpw]["splitter"], TokenCountSplitter)
    assert type(loaded[jpw]["splitter"]).__name__ == "TokenCountSplitter"
    for pw in (jpw, tpw):
        loaded[pw].pop("splitter")
    assert loaded[tpw] == loaded[jpw] == {"name": "demo", "nested": {"k": 5, "items": ["demo", 2]}}
    for pw in (jpw, tpw):
        with pytest.raises(KeyError):
            pw.load_yaml("a: $undefined_variable_of_the_test")


def test_live_table_equals_reference():
    """``LiveTable.from_table`` and ``Table.live`` keep the table's current
    rows through retractions, as the reference's does."""
    out = {}
    for pw in (jpw, tpw):
        md = """
          | a | __time__ | __diff__
        1 | 1 | 0        | 1
        2 | 2 | 0        | 1
        1 | 1 | 2        | -1
        3 | 5 | 4        | 1
        """
        live = pw.LiveTable.from_table(pw.debug.table_from_markdown(md))
        live2 = pw.debug.table_from_markdown(md).live()
        pw.run()
        pw.clear_graph()
        out[pw] = (len(live), sorted(live.to_pandas()["a"].tolist()), sorted(live2.to_pandas()["a"].tolist()))
    assert out[tpw] == out[jpw] == (2, [2, 5], [2, 5])
    assert isinstance(live, tpw.LiveTable)


def test_universe_promises_equal_reference():
    """``pw.universes`` promises let a filtered table's columns be added to
    a table of the same keys, in both packages alike."""
    def build(pw):
        t = pw.debug.table_from_markdown("""
          | a | b
        1 | 1 | 10
        2 | 2 | 20
        3 | 3 | 30
        """)
        f = t.filter(pw.this.a >= 2)
        g = t.filter(pw.this.b >= 20).select(c=pw.this.b + 1)
        pw.universes.promise_are_equal(f, g)
        pw.universes.promise_is_subset_of(f, t)
        pw.universes.promise_are_pairwise_disjoint(t.filter(pw.this.a == 1), f)
        return f.select(pw.this.a, c=g.c)

    assert _run(tpw, build) == _run(jpw, build)
    assert _rows(_run(tpw, build)[0]) == [(2, 21), (3, 31)]
    assert tpw.universes.__all__ == jpw.universes.__all__
