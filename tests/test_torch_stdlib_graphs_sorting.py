"""The port's graphs, sorting and stateful stdlib against the JAX package's, on the CPU.

Every case builds the same pipeline with ``pathway_tpu`` and with
``pathway_tpu_torch`` (``build(pw)`` takes either package as ``pw``) and
asserts exact equality of the final tables and of the update streams
(key, row, time, diff), at 1 and 4 engine workers; where the reference's
own test states the values, the port's result is held to them as well.
The cases mirror the reference's ``tests/test_louvain.py``,
``test_graphs_stats.py`` (``pagerank``, ``bellman_ford``,
``stateful.deduplicate``), ``test_sorting_index.py``, and the sorting and
graph cases of ``test_sharded_ops_matrix.py`` and
``test_sharded_streaming_equality.py``. The engines are host Python in
both packages, so nothing is held by a tolerance. Each package has its
own global parse graph; both are cleared around every case."""

from __future__ import annotations

import math

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


def _run(pw, build, n_workers):
    """(final state {key: row}, update stream sorted by (time, key, diff), column names)."""
    table = build(pw)
    runner = RUNNERS[pw](n_workers=n_workers)
    cap, names = runner.capture(table)
    runner.run()
    pw.clear_graph()
    stream = sorted(((int(k), _norm(tuple(r)), int(t), int(d)) for k, r, t, d in cap.stream),
                    key=lambda e: (e[2], e[0], e[3], repr(e[1])))
    return {int(k): _norm(tuple(r)) for k, r in cap.state.items()}, stream, list(names)


# ---- Louvain (reference tests/test_louvain.py) ----

TRIANGLES = [(0, 1, 1.0), (1, 2, 1.0), (0, 2, 1.0), (3, 4, 1.0), (4, 5, 1.0), (3, 5, 1.0), (2, 3, 1.0)]
WEIGHTED = [(0, 1, 10.0), (2, 3, 10.0), (1, 2, 1.0)]


def _weighted_graph(pw, undirected_edges, n):
    class VS(pw.Schema):
        v: int
        total_weight: float

    class ES(pw.Schema):
        u_: int
        v_: int
        weight: float

    total = 2.0 * sum(w for _u, _v, w in undirected_edges)
    verts = pw.debug.table_from_rows(schema=VS, rows=[(i, total) for i in range(n)]).with_id_from(pw.this.v)
    doubled = list(undirected_edges) + [(v, u, w) for u, v, w in undirected_edges]
    e = pw.debug.table_from_rows(schema=ES, rows=doubled)
    we = e.select(u=e.pointer_from(pw.this.u_), v=e.pointer_from(pw.this.v_), weight=pw.this.weight)
    return pw.stdlib.graphs.WeightedGraph.from_vertices_and_weighted_edges(
        verts.select(total_weight=pw.this.total_weight), we)


def _louvain(edges, n):
    def build(pw):
        from_pkg = pw.stdlib.graphs.louvain_communities
        return from_pkg.louvain_communities(_weighted_graph(pw, edges, n), levels=2)

    return build


def _community_sizes(state, names):
    members: dict = {}
    for vkey, row in state.items():
        members.setdefault(row[names.index("c")], set()).add(vkey)
    return sorted(len(m) for m in members.values())


# ---- pagerank, bellman_ford, deduplicate (reference tests/test_graphs_stats.py) ----


def _pagerank_star(pw):
    edges = pw.debug.table_from_markdown("""
      | u   | v
    1 | a   | hub
    2 | b   | hub
    3 | c   | hub
    4 | hub | a
    """)
    return pw.stdlib.graphs.pagerank(edges.select(u=edges.u, v=edges.v), steps=10)


def _bellman_ford(pw):
    verts = pw.debug.table_from_markdown("""
      | name        | is_source
    1 | s           | True
    2 | a           | False
    3 | b           | False
    4 | unreachable | False
    """)
    keyed = verts.with_id_from(pw.this.name)
    e0 = pw.debug.table_from_markdown("""
      | u | v | dist
    1 | s | a | 1.0
    2 | a | b | 2.0
    3 | s | b | 10.0
    """)
    edges = e0.select(u=keyed.pointer_from(e0.u), v=keyed.pointer_from(e0.v), dist=e0.dist)
    res = pw.stdlib.graphs.bellman_ford(keyed, edges)
    return keyed.select(name=pw.this.name, dist=res.restrict(keyed).dist_from_source)


def _bellman_ford_sharded(pw):
    """The bellman_ford case of the reference's ``test_sharded_ops_matrix.py``."""
    verts = pw.debug.table_from_markdown("""
      | name | is_source
    1 | a    | True
    2 | b    | False
    3 | c    | False
    4 | d    | False
    """).with_id_from(pw.this.name)
    e = pw.debug.table_from_markdown("""
      | u | v | dist
    1 | a | b | 1.0
    2 | b | c | 2.0
    3 | a | c | 10.0
    4 | c | d | 1.0
    """)
    edges = e.select(u=verts.pointer_from(e.u), v=verts.pointer_from(e.v), dist=e.dist)
    return pw.stdlib.graphs.bellman_ford(verts, edges)


def _deduplicate(pw):
    t = pw.debug.table_from_markdown("""
      | v  | __time__
    1 | 1  | 0
    2 | 1  | 2
    3 | 5  | 4
    4 | 4  | 6
    5 | 10 | 8
    """)
    return pw.stdlib.stateful.deduplicate(t, col=pw.this.v, acceptor=lambda new, old: new >= old + 2)


def _deduplicate_instance(pw):
    t = pw.debug.table_from_markdown("""
      | g | v  | __time__
    1 | a | 1  | 2
    2 | b | 7  | 2
    3 | a | 2  | 4
    4 | b | 3  | 4
    5 | a | 9  | 6
    """)
    return pw.stdlib.stateful.deduplicate(t, col=pw.this.v, instance=pw.this.g,
                                          acceptor=lambda new, old: new != old and new > 1)


# ---- sorting (reference tests/test_sorting_index.py, the sharded matrices) ----


def _sorted_index_structure(pw):
    nodes = pw.debug.table_from_markdown("""
      | key
    1 | 5
    2 | 1
    3 | 9
    4 | 3
    5 | 7
    """)
    index = pw.indexing.build_sorted_index(nodes)["index"]
    return index.select(key=pw.this.key, left=pw.this.left, right=pw.this.right, parent=pw.this.parent)


def _sorted_index_oracle(pw):
    nodes = pw.debug.table_from_markdown("""
      | key | instance
    1 | 5   | 0
    2 | 1   | 0
    3 | 9   | 1
    """)
    return pw.indexing.build_sorted_index(nodes, instance=nodes.instance)["oracle"]


def _sort_from_index_instances(pw):
    nodes = pw.debug.table_from_markdown("""
      | key | instance
    1 | 5   | 0
    2 | 1   | 0
    3 | 9   | 1
    4 | 3   | 0
    5 | 7   | 1
    """)
    pn = pw.indexing.sort_from_index(pw.indexing.build_sorted_index(nodes, instance=nodes.instance)["index"])
    return nodes.select(key=pw.this.key, inst=pw.this.instance) + pn


def _sorted_index_retraction(pw):
    nodes = pw.debug.table_from_markdown("""
      | key | __time__ | __diff__
    1 | 5   | 2        | 1
    2 | 1   | 2        | 1
    3 | 9   | 4        | 1
    1 | 5   | 6        | -1
    4 | 2   | 6        | 1
    """)
    pn = pw.indexing.sort_from_index(pw.indexing.build_sorted_index(nodes)["index"])
    return nodes.select(key=pw.this.key) + pn


def _prev_next_values(pw):
    tbl = pw.debug.table_from_markdown("""
      | value | pos
    1 | 10    | 1
    2 |       | 2
    3 |       | 3
    4 | 40    | 4
    """).select(value=pw.if_else(pw.this.value == 0, None, pw.this.value), pos=pw.this.pos)
    pn = pw.indexing.sort_from_index(pw.indexing.build_sorted_index(tbl.select(key=pw.this.pos))["index"])
    ordered = tbl.select(pw.this.value) + pn
    return ordered.select(v=pw.this.value) + pw.indexing.retrieve_prev_next_values(ordered)


EVENTS = """
  | k | t  | v
1 | a | 2  | 10
2 | a | 6  | 20
3 | b | 4  | 30
4 | b | 12 | 40
5 | a | 14 | 50
6 | c | 8  | 60
"""

STREAM = """
  | g | v | __time__ | __diff__
1 | a | 1 | 2        | 1
2 | b | 2 | 2        | 1
3 | a | 3 | 4        | 1
4 | c | 4 | 4        | 1
2 | b | 2 | 6        | -1
5 | a | 5 | 6        | 1
3 | a | 3 | 8        | -1
"""


def _sort_prev_next(pw):
    return pw.debug.table_from_markdown(EVENTS).sort(key=pw.this.t, instance=pw.this.k)


def _flatten_then_count(pw):
    t = pw.debug.table_from_markdown("""
      | k | parts
    1 | a | 3
    2 | b | 2
    """)
    expanded = t.select(k=pw.this.k, pieces=pw.apply_with_type(lambda n: tuple(range(n)), tuple, pw.this.parts))
    return expanded.flatten(pw.this.pieces).groupby(pw.this.k).reduce(k=pw.this.k, n=pw.reducers.count())


def _streamed_sorting_index(pw):
    nodes = pw.debug.table_from_markdown(STREAM).select(key=pw.this.v)
    pn = pw.indexing.sort_from_index(pw.indexing.build_sorted_index(nodes)["index"])
    return nodes.select(pw.this.key) + pn


CASES = {
    "louvain_two_triangles": _louvain(TRIANGLES, 6),
    "louvain_weighted": _louvain(WEIGHTED, 4),
    "pagerank_star": _pagerank_star,
    "bellman_ford": _bellman_ford,
    "bellman_ford_sharded": _bellman_ford_sharded,
    "deduplicate": _deduplicate,
    "deduplicate_instance": _deduplicate_instance,
    "sorted_index_structure": _sorted_index_structure,
    "sorted_index_oracle": _sorted_index_oracle,
    "sort_from_index_instances": _sort_from_index_instances,
    "sorted_index_retraction": _sorted_index_retraction,
    "prev_next_values": _prev_next_values,
    "sort_prev_next": _sort_prev_next,
    "flatten_then_count": _flatten_then_count,
    "streamed_sorting_index": _streamed_sorting_index,
}


def _chain(state, names, key_col, next_col, head):
    out, cur = [], head
    while cur is not None:
        out.append(state[cur][names.index(key_col)])
        nxt = state[cur][names.index(next_col)]
        cur = None if nxt is None else nxt[1]
    return out


def _heads(state, names, prev_col, where=lambda row: True):
    return [k for k, row in state.items() if row[names.index(prev_col)] is None and where(row)]


def _bst(state, names):
    key_of = {k: row[names.index("key")] for k, row in state.items()}
    ok = sum(row[names.index("parent")] is None for row in state.values()) == 1
    for k, row in state.items():
        left, right = row[names.index("left")], row[names.index("right")]
        ok &= left is None or key_of[left[1]] < key_of[k]
        ok &= right is None or key_of[right[1]] > key_of[k]
    return ok


def _prev_next_ok(state, names):
    vi, pi, ni = names.index("v"), names.index("prev_value"), names.index("next_value")
    for k, row in state.items():
        if row[vi] is not None:
            if row[pi] != ("ptr", k) or row[ni] != ("ptr", k):
                return False
        elif state[row[pi][1]][vi] != 10 or state[row[ni][1]][vi] != 40:
            return False
    return True


def _by_name(state, names):
    return {row[names.index("name")]: row[names.index("dist")] for row in state.values()}


# what the reference's own tests state, held on the port's result: check(state, stream, names)
CHECKS = {
    "louvain_two_triangles": lambda s, st, n: _community_sizes(s, n) == [3, 3],
    "louvain_weighted": lambda s, st, n: _community_sizes(s, n) == [2, 2],
    "pagerank_star": lambda s, st, n: len(s) == 4 and max(r[0] for r in s.values()) > min(r[0] for r in s.values()),
    "bellman_ford": lambda s, st, n: {k: v for k, v in _by_name(s, n).items() if k != "unreachable"}
    == {"s": 0.0, "a": 1.0, "b": 3.0} and math.isinf(_by_name(s, n)["unreachable"]),
    "bellman_ford_sharded": lambda s, st, n: sorted(r[0] for r in s.values()) == [0.0, 1.0, 3.0, 4.0],
    "deduplicate": lambda s, st, n: [r[0] for r in s.values()] == [10],
    "sorted_index_structure": lambda s, st, n: len(s) == 5 and _bst(s, n),
    "sort_from_index_instances": lambda s, st, n: [
        _chain(s, n, "key", "next", h) for inst in (0, 1)
        for h in _heads(s, n, "prev", lambda row: row[n.index("inst")] == inst)] == [[1, 3, 5], [7, 9]],
    "sorted_index_retraction": lambda s, st, n: _chain(s, n, "key", "next", _heads(s, n, "prev")[0]) == [1, 2, 9],
    "prev_next_values": lambda s, st, n: _prev_next_ok(s, n),
    "flatten_then_count": lambda s, st, n: sorted(s.values()) == [("a", 3), ("b", 2)],
}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphs_sorting_case_equals_reference(case, n_workers):
    want = _run(jpw, CASES[case], n_workers)
    got = _run(tpw, CASES[case], n_workers)
    assert got == want
    assert got[1], "the pipeline produced no update"
    if case in CHECKS:
        assert CHECKS[case](*got), got


@pytest.mark.parametrize("case", ["louvain_two_triangles", "sort_prev_next", "streamed_sorting_index",
                                  "deduplicate_instance"])
def test_four_workers_equal_one(case):
    """The reference's ``PATHWAY_THREADS`` matrix on the port alone."""
    one, four = _run(tpw, CASES[case], 1), _run(tpw, CASES[case], 4)
    assert four[0] == one[0]


@pytest.mark.parametrize("edges,n,expected", [(TRIANGLES, 6, 12.0 / 14.0 - 2 * (7.0 / 14.0) ** 2)])
def test_exact_modularity_equals_reference(edges, n, expected):
    """``exact_modularity`` of a two-level Louvain clustering runs its own
    engine and returns a float: equal in both packages, and the value the
    reference's test states (two triangles: 12 of 14 internal weight)."""
    got = {}
    for pw in (jpw, tpw):
        graph = _weighted_graph(pw, edges, n)
        clustering = pw.stdlib.graphs.louvain_communities.louvain_communities(graph, levels=2).select(
            c=pw.this.c, total_weight=14.0)
        got[pw] = pw.stdlib.graphs.exact_modularity(graph, clustering)
        pw.clear_graph()
    assert got[tpw] == got[jpw]
    assert got[tpw] == pytest.approx(expected, abs=1e-9)


def test_public_names_of_graphs_stateful_and_sorting():
    """``pw.stdlib.graphs`` and ``pw.indexing``'s sorting names are the
    reference's, of the same kinds; the schemas carry the same columns."""
    assert tpw.stdlib.graphs.__all__ == jpw.stdlib.graphs.__all__
    for name in jpw.stdlib.graphs.__all__:
        assert callable(getattr(tpw.stdlib.graphs, name)) == callable(getattr(jpw.stdlib.graphs, name)), name
    for schema in ("Edge", "Weight", "Clustering", "Vertex", "Cluster"):
        assert (getattr(tpw.stdlib.graphs, schema).column_names()
                == getattr(jpw.stdlib.graphs, schema).column_names()), schema
    assert set(tpw.indexing.SortedIndex.__annotations__) == set(jpw.indexing.SortedIndex.__annotations__) == {
        "index", "oracle"}
    assert tpw.graphs is tpw.stdlib.graphs and tpw.stateful is tpw.stdlib.stateful
    assert [f.name for f in __import__("dataclasses").fields(tpw.stdlib.graphs.WeightedGraph)] == ["V", "E", "WE"]
