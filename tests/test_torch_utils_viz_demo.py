"""The port's ``pw.stdlib.utils``, ``viz``, ``demo`` and demo programs against the JAX package's, on the CPU.

Every table case builds the same pipeline with ``pathway_tpu`` and with
``pathway_tpu_torch`` (``build(pw)``) and asserts exact equality of the
final tables and of the update streams at 1 and 4 engine workers; where
the reference's own test states the values, the port's result is held to
them too. Sources paced by the wall clock (``pw.demo``'s streams) and
``AsyncTransformer``'s results (their epoch is the one in which the
coroutine finished) are held without the update's time: (key, row, diff).
The cases mirror the reference's ``tests/test_api_parity_r5.py``
(bucketing, ``argmax_rows`` / ``argmin_rows``, ``unpack_col``,
``flatten_column``, the all-rows applies), ``test_aux_subsystems.py`` and
``test_resilience.py`` (``AsyncTransformer``, ``Table.show`` /
``Table.plot``) and ``test_debug_demo_breadth.py`` (``pw.demo``). Each
program of ``pathway_tpu_torch/debug/demos`` runs as a user runs it, in a
subprocess, and must exit 0. The engines are host Python in both
packages, so nothing is held by a tolerance."""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import warnings

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner

RUNNERS = {jpw: JRunner, tpw: TRunner}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _norm(v):
    """A value comparable across the packages: each has its own ``Pointer`` and ``Json``."""
    name = type(v).__name__
    if name == "Pointer":
        return ("ptr", int(v))
    if name == "Json":
        return ("json", repr(v.value))
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    return v


def _run(pw, build, n_workers, timeless=False):
    """(final state {key: row}, update stream, column names); the stream's
    entries are (key, row, time, diff), or (key, row, diff) when ``timeless``."""
    table = build(pw)
    runner = RUNNERS[pw](n_workers=n_workers)
    cap, names = runner.capture(table)
    runner.run()
    pw.clear_graph()
    if timeless:
        stream = sorted(((int(k), _norm(tuple(r)), int(d)) for k, r, _t, d in cap.stream), key=repr)
    else:
        stream = sorted(((int(k), _norm(tuple(r)), int(t), int(d)) for k, r, t, d in cap.stream),
                        key=lambda e: (e[2], e[0], e[3], repr(e[1])))
    return {int(k): _norm(tuple(r)) for k, r in cap.state.items()}, stream, list(names)


# ---- stdlib.utils (reference tests/test_api_parity_r5.py) ----

GROUPS = """
  | g | v
1 | a | 5
2 | a | 9
3 | b | 2
"""

STREAMED_GROUPS = """
  | g | v | __time__ | __diff__
1 | a | 5 | 2        | 1
2 | a | 9 | 2        | 1
3 | b | 2 | 4        | 1
2 | a | 9 | 6        | -1
4 | b | 7 | 6        | 1
"""


def _argmax_rows(pw):
    t = pw.debug.table_from_markdown(GROUPS)
    return pw.stdlib.utils.argmax_rows(t, t.g, what=t.v)


def _argmin_rows(pw):
    t = pw.debug.table_from_markdown(GROUPS)
    return pw.stdlib.utils.argmin_rows(t, t.g, what=t.v)


def _argmax_rows_streamed(pw):
    t = pw.debug.table_from_markdown(STREAMED_GROUPS)
    return pw.stdlib.utils.argmax_rows(t, t.g, what=t.v)


def _unpack_col(pw):
    t = pw.debug.table_from_markdown("""
      | a | b
    1 | 1 | x
    2 | 2 | y
    """)
    packed = t.select(pair=pw.make_tuple(pw.this.a, pw.this.b))
    return pw.unpack_col(packed.pair, "num", "name")


def _unpack_col_schema(pw):
    class S(pw.Schema):
        num: int
        name: str

    t = pw.debug.table_from_markdown("""
      | a | b
    1 | 1 | x
    2 | 2 | y
    """)
    return pw.stdlib.utils.col.unpack_col(t.select(pair=pw.make_tuple(pw.this.a, pw.this.b)).pair, schema=S)


def _unpack_col_dict(pw):
    class DS(pw.Schema):
        field_a: int
        field_b: str | None
        field_c: bool
        field_d: float | None

    t = pw.debug.table_from_rows(schema=pw.schema_from_types(data=pw.Json), rows=[
        ({"field_a": 13, "field_b": "foo", "field_c": False},),
        ({"field_a": 17, "field_c": True, "field_d": 3.4},)])
    return pw.stdlib.utils.col.unpack_col_dict(t.data, schema=DS)


def _unpack_col_dict_non_objects(pw):
    class DS(pw.Schema):
        field_a: int | None

    t = pw.debug.table_from_rows(schema=pw.schema_from_types(data=pw.Json),
                                 rows=[({"field_a": 1},), ([1, 2],), ("plain",)])
    return pw.stdlib.utils.col.unpack_col_dict(t.data, schema=DS)


def _flatten_column(pw):
    t = pw.debug.table_from_markdown("""
      | pet | age
    1 | Dog | 2
    """)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pw.stdlib.utils.col.flatten_column(t.pet)


def _groupby_reduce_majority(pw):
    t = pw.debug.table_from_markdown("""
      | g | label
    1 | a | x
    2 | a | y
    3 | a | x
    4 | b | z
    """)
    return pw.stdlib.utils.col.groupby_reduce_majority(t.g, t.label)


def _multiapply_all_rows(pw):
    t = pw.debug.table_from_markdown("""
      | colA | colB
    1 | 1    | 10
    2 | 2    | 20
    3 | 3    | 30
    """)

    def add_total_sum(c1, c2):
        s = sum(c1) + sum(c2)
        return [x + s for x in c1], [x + s for x in c2]

    r = pw.stdlib.utils.col.multiapply_all_rows(t.colA, t.colB, fun=add_total_sum, result_col_names=["res1", "res2"])
    return t.select(a=t.colA, r1=r.restrict(t).res1, r2=r.restrict(t).res2)


def _apply_all_rows(pw):
    t = pw.debug.table_from_markdown("""
      | v | __time__
    1 | 5 | 2
    2 | 7 | 2
    3 | 3 | 4
    """)
    return pw.stdlib.utils.col.apply_all_rows(t.v, fun=lambda vs: [x - min(vs) for x in vs], result_col_name="rel")


def _pandas_transformer(pw):
    class Out(pw.Schema):
        total: int

    @pw.pandas_transformer(output_schema=Out)
    def totals(df):
        return df.groupby("g", as_index=False)["v"].sum().rename(columns={"v": "total"})[["total"]]

    return totals(pw.debug.table_from_markdown(GROUPS))


def _subscribe_raw_source(pw):
    return pw.debug.table_from_markdown(STREAMED_GROUPS)


CASES = {
    "argmax_rows": _argmax_rows,
    "argmin_rows": _argmin_rows,
    "argmax_rows_streamed": _argmax_rows_streamed,
    "unpack_col": _unpack_col,
    "unpack_col_schema": _unpack_col_schema,
    "unpack_col_dict": _unpack_col_dict,
    "unpack_col_dict_non_objects": _unpack_col_dict_non_objects,
    "flatten_column": _flatten_column,
    "groupby_reduce_majority": _groupby_reduce_majority,
    "multiapply_all_rows": _multiapply_all_rows,
    "apply_all_rows": _apply_all_rows,
    "pandas_transformer": _pandas_transformer,
}

CHECKS = {
    "argmax_rows": lambda s: sorted(s.values()) == [("a", 9), ("b", 2)],
    "argmin_rows": lambda s: sorted(s.values()) == [("a", 5), ("b", 2)],
    "argmax_rows_streamed": lambda s: sorted(s.values()) == [("a", 5), ("b", 7)],
    "unpack_col": lambda s: sorted(s.values()) == [(1, "x"), (2, "y")],
    "unpack_col_schema": lambda s: sorted(s.values()) == [(1, "x"), (2, "y")],
    "unpack_col_dict": lambda s: sorted(s.values()) == [(13, "foo", False, None), (17, None, True, 3.4)],
    "unpack_col_dict_non_objects": lambda s: sorted(s.values(), key=str) == [(1,), (None,), (None,)],
    "flatten_column": lambda s: len(s) == 3 and {v[0] for v in s.values()} == {"D", "o", "g"},
    "multiapply_all_rows": lambda s: sorted(s.values()) == [(1, 67, 76), (2, 68, 86), (3, 69, 96)],
    "apply_all_rows": lambda s: sorted(s.values()) == [(0,), (2,), (4,)],
    "pandas_transformer": lambda s: sorted(s.values()) == [(2,), (14,)],
}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_utils_case_equals_reference(case, n_workers):
    want = _run(jpw, CASES[case], n_workers)
    got = _run(tpw, CASES[case], n_workers)
    assert got == want
    assert got[1], "the pipeline produced no update"
    if case in CHECKS:
        assert CHECKS[case](got[0]), got


def test_truncate_to_minutes_and_public_names():
    """``bucketing.truncate_to_minutes`` and the names of ``pw.stdlib`` and
    ``pw.stdlib.utils``, as the reference's."""
    t = datetime.datetime(2026, 7, 31, 12, 34, 56, 789)
    assert tpw.stdlib.utils.bucketing.truncate_to_minutes(t) == jpw.stdlib.utils.bucketing.truncate_to_minutes(t) \
        == datetime.datetime(2026, 7, 31, 12, 34)
    assert tpw.stdlib.__all__ == jpw.stdlib.__all__
    for mod in ("utils", "utils.col", "utils.filtering", "stateful", "viz"):
        jmod, tmod = jpw.stdlib, tpw.stdlib
        for part in mod.split("."):
            jmod, tmod = getattr(jmod, part), getattr(tmod, part)
        jnames = {n for n, v in vars(jmod).items() if not n.startswith("_") and callable(v)}
        assert {n for n, v in vars(tmod).items() if not n.startswith("_") and callable(v)} >= jnames, mod
    assert tpw.utils is tpw.stdlib.utils and tpw.viz is tpw.stdlib.viz
    assert tpw.unpack_col is tpw.stdlib.utils.col.unpack_col and tpw.AsyncTransformer.__name__ == "AsyncTransformer"


@pytest.mark.parametrize("n_workers", [1, 4])
def test_subscribe_raw_sees_the_reference_changes(n_workers, monkeypatch):
    """``_graph_hooks.subscribe_raw``'s raw (key, row, time, diff) callbacks
    and its time-end and end callbacks under ``pw.run``, as the reference's."""
    monkeypatch.setenv("PATHWAY_THREADS", str(n_workers))
    from pathway_tpu import _graph_hooks as jhooks
    from pathway_tpu_torch import _graph_hooks as thooks

    got = {}
    for pw, hooks in ((jpw, jhooks), (tpw, thooks)):
        seen = {"changes": [], "ends": 0, "times": []}
        table = _subscribe_raw_source(pw)
        hooks.subscribe_raw(table, lambda key, row, time, diff, seen=seen: seen["changes"].append(
            (int(key), _norm(tuple(row.values()) if isinstance(row, dict) else tuple(row)), time, diff)),
            on_time_end=lambda time, seen=seen: seen["times"].append(time),
            on_end=lambda seen=seen: seen.__setitem__("ends", seen["ends"] + 1))
        pw.run(monitoring_level="none")
        pw.clear_graph()
        got[pw] = (sorted(seen["changes"], key=repr), sorted(set(seen["times"])), seen["ends"])
    assert got[tpw] == got[jpw]
    assert len(got[tpw][0]) == 5 and got[tpw][2] == 1


# ---- AsyncTransformer (reference tests/test_aux_subsystems.py, test_resilience.py) ----


def _upper(pw):
    class Out(pw.Schema):
        data: str

    class Upper(pw.AsyncTransformer, output_schema=Out):
        async def invoke(self, data: str) -> dict:
            return {"data": data.upper()}

    t = pw.debug.table_from_markdown("""
      | data
    1 | cat
    2 | dog
    """)
    return Upper(input_table=t).successful


@pytest.mark.parametrize("n_workers", [1, 4])
def test_async_transformer_equals_reference(n_workers):
    want = _run(jpw, _upper, n_workers, timeless=True)
    got = _run(tpw, _upper, n_workers, timeless=True)
    assert got == want and sorted(r[0] for r in got[0].values()) == ["CAT", "DOG"]


def _failing_transformer(pw, events):
    from importlib import import_module

    RetryPolicy = import_module(f"{pw.__name__}.resilience").RetryPolicy

    class OutSchema(pw.Schema):
        ret: int

    class MyT(pw.AsyncTransformer, output_schema=OutSchema):
        def open(self):
            events.append("open")

        def close(self):
            events.append("close")

        async def invoke(self, x) -> dict:
            events.append(f"invoke:{x}")
            if x == 2:
                raise RuntimeError("nope")
            return {"ret": x + 100}

    t = pw.debug.table_from_markdown("""
      | x
    1 | 1
    2 | 2
    3 | 3
    """)
    return MyT(input_table=t, retry_strategy=RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=1,
                                                         sleep=lambda _s: None))


@pytest.mark.parametrize("n_workers", [1, 4])
def test_async_transformer_failed_table_and_lifecycle_equal_reference(n_workers):
    """Retries, the dead-letter ``failed`` table and ``open`` / ``close``
    once each (the reference's ``test_async_transformer_failed_table_and_lifecycle``)."""
    got = {}
    for pw in (jpw, tpw):
        events: list = []
        mt = _failing_transformer(pw, events)
        runner = RUNNERS[pw](n_workers=n_workers)
        good, _ = runner.capture(mt.successful)
        failed, fnames = runner.capture(mt.failed)
        runner.run()
        pw.clear_graph()
        rows = [dict(zip(fnames, r)) for r in failed.state.values()]
        got[pw] = (sorted(r[0] for r in good.state.values()),
                   [(r["message"], _norm(r["args"])) for r in rows], sorted(events), events[0], events[-1])
    assert got[tpw] == got[jpw]
    good, failed, events, first, last = got[tpw]
    assert good == [101, 103] and failed == [("RuntimeError: nope", ("json", "[2]"))]
    assert (first, last) == ("open", "close") and events.count("open") == events.count("close") == 1
    assert events.count("invoke:2") == 2


def test_async_transformer_on_error_raise_and_bad_option_equal_reference():
    """``on_error="raise"`` ends the run with the invoke's error, and an
    unknown ``on_error`` is refused at construction, in both packages."""
    for pw in (jpw, tpw):
        class OutSchema(pw.Schema):
            ret: int

        class MyT(pw.AsyncTransformer, output_schema=OutSchema):
            async def invoke(self, x) -> dict:
                if x == 2:
                    raise RuntimeError("nope")
                return {"ret": x}

        t = pw.debug.table_from_markdown("""
          | x
        1 | 1
        2 | 2
        """)
        with pytest.raises(ValueError, match="on_error"):
            MyT(input_table=t, on_error="explode")
        pw.io.subscribe(MyT(input_table=t, on_error="raise").successful, on_change=lambda **kw: None)
        with pytest.raises(Exception, match="nope"):
            pw.run(monitoring_level="none")
        pw.clear_graph()


# ---- pw.demo (reference tests/test_debug_demo_breadth.py) ----


def _range_stream(pw):
    return pw.demo.range_stream(nb_rows=5, input_rate=1000.0)


def _custom_stream(pw):
    class S(pw.Schema):
        n: int
        sq: int

    return pw.demo.generate_custom_stream({"n": lambda i: i, "sq": lambda i: i * i}, schema=S, nb_rows=4,
                                          input_rate=1000.0)


def _noisy_x(pw):
    t = pw.demo.noisy_linear_stream(nb_rows=6, input_rate=1000.0)
    return t.select(x=pw.this.x, near=pw.apply(lambda x, y: abs(y - x) <= 1.0, pw.this.x, pw.this.y))


def _replay_csv(path):
    def build(pw):
        class S(pw.Schema):
            a: int
            b: str

        return pw.demo.replay_csv(path, schema=S, input_rate=10000.0)

    return build


def _replay_csv_with_time(path):
    def build(pw):
        class S(pw.Schema):
            t: int
            b: str

        return pw.demo.replay_csv_with_time(path, schema=S, time_column="t", unit="ms", speedup=100.0)

    return build


DEMO_CHECKS = {
    "range_stream": lambda s: sorted(v[0] for v in s.values()) == [0, 1, 2, 3, 4],
    "custom_stream": lambda s: sorted(s.values()) == [(0, 0), (1, 1), (2, 4), (3, 9)],
    "noisy_x": lambda s: sorted(s.values()) == [(float(i), True) for i in range(6)],
    "replay_csv": lambda s: sorted(s.values()) == [(1, "x"), (2, "y"), (3, "z")],
    "replay_csv_with_time": lambda s: sorted(s.values()) == [(0, "x"), (5, "y"), (10, "z")],
}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(DEMO_CHECKS))
def test_demo_stream_equals_reference(case, n_workers, tmp_path):
    (tmp_path / "in.csv").write_text("a,b\n1,x\n2,y\n3,z\n")
    (tmp_path / "timed.csv").write_text("t,b\n0,x\n5,y\n10,z\n")
    build = {"range_stream": _range_stream, "custom_stream": _custom_stream, "noisy_x": _noisy_x,
             "replay_csv": _replay_csv(str(tmp_path / "in.csv")),
             "replay_csv_with_time": _replay_csv_with_time(str(tmp_path / "timed.csv"))}[case]
    want = _run(jpw, build, n_workers, timeless=True)
    got = _run(tpw, build, n_workers, timeless=True)
    assert got == want
    assert DEMO_CHECKS[case](got[0]), got


def test_demo_programs_run_and_exit_zero():
    """Every program under ``pathway_tpu_torch/debug/demos`` runs as a user
    runs it (``python -m``, its ``__main__`` calls ``pw.run``) and exits 0;
    ``demo_programs`` lists the same programs as the reference's."""
    from pathway_tpu.debug.demos import demo_programs as jprograms
    from pathway_tpu_torch.debug.demos import demo_programs

    names = [os.path.basename(p) for p in demo_programs()]
    assert names == [os.path.basename(p) for p in jprograms()] == ["rag_chunks.py", "windowed_stats.py",
                                                                    "word_counts.py"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = {n: subprocess.Popen([sys.executable, "-m", f"pathway_tpu_torch.debug.demos.{n[:-3]}"], cwd=REPO,
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for n in names}
    for n, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, (n, err[-3000:])


# ---- viz (reference tests/test_aux_subsystems.py) ----


def test_table_show_renders_like_the_reference():
    """``Table.show`` of a bounded table renders the same HTML and text in
    both packages (the reference's ``test_table_show_and_plot_views``)."""
    got = {}
    for pw in (jpw, tpw):
        t = pw.debug.table_from_markdown("""
          | a | b
        1 | 1 | x
        2 | 2 | y
        """)
        view = t.select(a=pw.this.a * 2, b=pw.this.b).show()
        got[pw] = (view._repr_html_(), repr(view), view._header_cols(), view.streaming)
        pw.clear_graph()
    assert got[tpw] == got[jpw]
    html_, _text, cols, streaming = got[tpw]
    assert "<table" in html_ and "<th>a</th>" in html_ and "4" in html_ and "id" in cols and not streaming


def test_table_plot_renders_a_png_like_the_reference():
    """``Table.plot`` drives a plotting callable over the snapshot (a
    DataFrame: no bokeh here, nor on the card's machine) and inlines the
    figure as a PNG."""
    got = {}
    for pw in (jpw, tpw):
        seen = []

        def plot_fn(df, seen=seen):
            import matplotlib

            matplotlib.use("Agg")
            seen.append(sorted(map(tuple, df[["a", "sq"]].values.tolist())))
            return df.plot(x="a", y="sq")

        t = pw.debug.table_from_markdown("""
          | a
        1 | 1
        2 | 3
        """)
        html_ = t.select(a=pw.this.a, sq=pw.this.a * pw.this.a).plot(plot_fn)._repr_html_()
        got[pw] = (html_.startswith("<img src='data:image/png"), seen)
        pw.clear_graph()
    assert got[tpw] == got[jpw] == (True, [[(1, 1), (3, 9)]])


def test_table_show_of_a_stream_fills_while_the_run_goes():
    """A streaming table's view subscribes and holds the rows after
    ``pw.run`` (the reference's ``test_table_show_streaming_updates_live``)."""
    got = {}
    for pw in (jpw, tpw):
        class S(pw.Schema):
            v: int

        t = pw.demo.generate_custom_stream({"v": lambda i: i + 1}, schema=S, nb_rows=2, autocommit_duration_ms=50,
                                           input_rate=1000)
        view = t.show()
        pw.run(monitoring_level="none")
        got[pw] = (view.streaming, sorted(view.rows.values()), sorted((r, d) for _k, r, _t, d in view.changes))
        pw.clear_graph()
    assert got[tpw] == got[jpw] == (True, [(1,), (2,)], [((1,), 1), ((2,), 1)])
