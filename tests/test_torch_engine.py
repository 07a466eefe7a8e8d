"""The port's dataflow engine against the JAX package's, on the CPU.

Every case builds the same pipeline with ``pathway_tpu`` and with
``pathway_tpu_torch`` (``build(pw)`` takes either package as ``pw``) and
asserts exact equality of the final tables and of the update streams
(key, row, time, diff), at 1 and 4 engine workers. A connector thread
commits while the engine runs, so where its rows split into epochs is a
matter of timing: for such a case the stream is compared net of its
epochs (the consolidated changes). The engines are host Python in both
packages, so nothing is held by a tolerance here.
Each package has its own global parse graph; both are cleared around
every case."""

from __future__ import annotations

import numpy as np
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


PETS = """
  | owner | pet | age | weight
1 | Alice | dog | 2   | 10.5
2 | Bob   | cat | 3   | 4.0
3 | Carol | dog | 5   | 20.25
4 | Dan   | fish| 1   | 0.5
5 | Eve   | cat | 7   | 5.5
"""

OWNERS = """
  | owner | city
1 | Alice | Oslo
2 | Bob   | Rome
3 | Carol | Oslo
6 | Frank | Lima
"""

STREAM = """
  | word  | n | __time__ | __diff__
1 | apple | 1 | 2        | 1
2 | pear  | 2 | 2        | 1
3 | apple | 3 | 4        | 1
1 | apple | 1 | 6        | -1
4 | plum  | 5 | 6        | 1
2 | pear  | 2 | 8        | -1
"""


def _select_filter(pw):
    t = pw.debug.table_from_markdown(PETS)
    return t.filter(pw.this.age >= 3).select(pw.this.owner, older=pw.this.age + 1, heavy=pw.this.weight > 5.0)


def _groupby_reduce(pw):
    t = pw.debug.table_from_markdown(PETS)
    return t.groupby(pw.this.pet).reduce(
        pw.this.pet,
        n=pw.reducers.count(),
        total=pw.reducers.sum(pw.this.age),
        heaviest=pw.reducers.max(pw.this.weight),
        names=pw.reducers.sorted_tuple(pw.this.owner),
    )


def _join(pw):
    pets = pw.debug.table_from_markdown(PETS)
    owners = pw.debug.table_from_markdown(OWNERS)
    return pets.join(owners, pw.left.owner == pw.right.owner).select(
        pw.left.owner, pw.left.pet, pw.right.city
    )


def _left_join(pw):
    pets = pw.debug.table_from_markdown(PETS)
    owners = pw.debug.table_from_markdown(OWNERS)
    return pets.join_left(owners, pw.left.owner == pw.right.owner).select(
        pw.left.owner, city=pw.coalesce(pw.right.city, "none")
    )


def _time_diff_stream(pw):
    t = pw.debug.table_from_markdown(STREAM)
    return t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.n))


def _apply_and_if_else(pw):
    t = pw.debug.table_from_markdown(PETS)
    return t.select(
        label=pw.apply(lambda o, a: f"{o.lower()}:{a}", pw.this.owner, pw.this.age),
        size=pw.if_else(pw.this.weight > 5.0, "big", "small"),
    )


def _python_read(pw):
    class Source(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(12):
                self.next(doc_id=i, text=f"doc {i % 5}", score=float(i) / 3)
                if i % 4 == 3:
                    self.commit()

    class Schema(pw.Schema):
        doc_id: int
        text: str
        score: float

    docs = pw.io.python.read(Source(), schema=Schema, autocommit_duration_ms=None)
    return docs.groupby(pw.this.text).reduce(pw.this.text, n=pw.reducers.count(), best=pw.reducers.max(pw.this.score))


STREAMING = {"python_read_commits"}  # epoch boundaries depend on thread timing

CASES = {
    "select_filter": _select_filter,
    "groupby_reduce": _groupby_reduce,
    "join": _join,
    "left_join": _left_join,
    "time_diff_stream": _time_diff_stream,
    "apply_if_else": _apply_and_if_else,
    "python_read_commits": _python_read,
}


def _net(events):
    """(key, row) -> summed diff, zeros dropped: a stream net of its epochs."""
    net = {}
    for key, row, _, diff in events:
        net[(key, row)] = net.get((key, row), 0) + diff
    return {kr: d for kr, d in net.items() if d}


def _run(pw, build, n_workers, streaming=False):
    """(final state {key: row}, update stream sorted by (time, key, diff) --
    net of its epochs when ``streaming`` --, column names)."""
    table = build(pw)
    runner = RUNNERS[pw](n_workers=n_workers)
    cap, names = runner.capture(table)
    runner.run()
    pw.clear_graph()
    stream = sorted(((int(k), tuple(r), int(t), int(d)) for k, r, t, d in cap.stream), key=lambda e: (e[2], e[0], e[3]))
    return {int(k): tuple(r) for k, r in cap.state.items()}, _net(stream) if streaming else stream, names


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_equals_reference(case, n_workers):
    want = _run(jpw, CASES[case], n_workers, case in STREAMING)
    got = _run(tpw, CASES[case], n_workers, case in STREAMING)
    assert got == want
    assert got[0], "the pipeline produced no rows"


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_workers_equal_one(case):
    streaming = case in STREAMING
    assert _run(tpw, CASES[case], 4, streaming)[:2] == _run(tpw, CASES[case], 1, streaming)[:2]


def test_time_diff_stream_has_retractions():
    _, stream, _ = _run(tpw, _time_diff_stream, 1)
    assert {d for *_, d in stream} == {1, -1}
    assert [t for _, _, t, _ in stream] == sorted(t for _, _, t, _ in stream)


@pytest.mark.parametrize("case", ["groupby_reduce", "time_diff_stream"])
def test_printed_update_streams_equal(case, capsys):
    """``compute_and_print_update_stream`` prints the same text."""
    out = {}
    for pw in (jpw, tpw):
        pw.debug.compute_and_print_update_stream(CASES[case](pw))
        out[pw] = capsys.readouterr().out
        pw.clear_graph()
    assert out[tpw] == out[jpw] and "__diff__" in out[tpw]


def test_pw_run_with_subscribe_equals_reference():
    """``pw.io.subscribe`` + ``pw.run`` deliver the same changes (net of
    their epochs: the connector thread decides those) and end on the same
    five groups."""
    seen = {}
    for pw in (jpw, tpw):
        events = []
        pw.io.subscribe(
            _python_read(pw),
            lambda key, row, time, is_addition, events=events: events.append(
                (int(key), tuple(sorted(row.items())), time, 1 if is_addition else -1)
            ),
        )
        pw.run()
        pw.clear_graph()
        seen[pw] = _net(events)
    assert seen[tpw] == seen[jpw] and len(seen[tpw]) == 5


def test_table_from_rows_and_to_dicts_equal():
    rows = [(i, f"t{i}", float(np.float32(i) / 7)) for i in range(9)]
    out = {}
    for pw in (jpw, tpw):
        schema = pw.schema_from_types(k=int, s=str, x=float)
        t = pw.debug.table_from_rows(schema=schema, rows=rows)
        keys, cols = pw.debug.table_to_dicts(t.select(pw.this.k, y=pw.this.x * 2))
        out[pw] = ([int(k) for k in keys], {c: {int(k): v for k, v in d.items()} for c, d in cols.items()})
        pw.clear_graph()
    assert out[tpw] == out[jpw]
