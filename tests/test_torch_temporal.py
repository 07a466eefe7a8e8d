"""The port's temporal, ordered and statistical stdlib against the JAX package's, on the CPU.

Every case builds the same pipeline with ``pathway_tpu`` and with
``pathway_tpu_torch`` (``build(pw)`` takes either package as ``pw``) and
asserts exact equality of the final tables and of the update streams
(key, row, time, diff), at 1 and 4 engine workers; where the reference's
own test states the values, the port's result is held to them as well.
The cases mirror the reference's ``tests/test_temporal.py``,
``test_temporal_streams.py``, the temporal cases of
``test_sharded_ops_matrix.py`` and ``test_sharded.py``, and the
``interpolate`` / ``diff`` cases of ``test_graphs_stats.py``. The engines
are host Python in both packages, so nothing is held by a tolerance.
Each package has its own global parse graph; both are cleared around
every case. A clock (``utc_now``) runs only with
``PATHWAY_TPU_CLOCK_MAX_TICKS`` set, so its thread ends with its ticks."""

from __future__ import annotations

import datetime

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


def _cols(state, names, *cols):
    idx = [names.index(c) for c in cols]
    return sorted((tuple(row[i] for i in idx) for row in state.values()), key=repr)


def _events(stream, names, *cols):
    """The stream's (row projected on ``cols``, time, diff), sorted."""
    idx = [names.index(c) for c in cols]
    return sorted(((tuple(r[i] for i in idx), t, d) for _, r, t, d in stream), key=repr)


# ---- windows (reference tests/test_temporal.py) ----


def _tumbling_batch(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v
    1 | 1  | 10
    2 | 2  | 20
    3 | 5  | 30
    4 | 6  | 40
    5 | 9  | 50
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v), n=pw.reducers.count())


def _tumbling_streamed(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__
    1 | 1 | 10 | 0
    2 | 5 | 30 | 2
    3 | 2 | 20 | 4
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _sliding_batch(pw):
    t = pw.debug.table_from_markdown("""
      | t | v
    1 | 1 | 1
    2 | 3 | 1
    3 | 5 | 1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.sliding(hop=2, duration=4)).reduce(
        start=pw.this._pw_window_start, n=pw.reducers.count())


def _session_max_gap(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v
    1 | 1  | 1
    2 | 2  | 1
    3 | 10 | 1
    4 | 11 | 1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.session(max_gap=3)).reduce(n=pw.reducers.count())


def _session_predicate(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v
    1 | 1  | 1
    2 | 3  | 2
    3 | 10 | 4
    """)
    return t.windowby(pw.this.t, window=pw.temporal.session(predicate=lambda a, b: b - a < 4)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, total=pw.reducers.sum(pw.this.v))


def _instance_keying(pw):
    t = pw.debug.table_from_markdown("""
      | u | t | v
    1 | a | 1 | 1
    2 | a | 2 | 2
    3 | b | 1 | 5
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4), instance=pw.this.u).reduce(
        u=pw.this._pw_instance, total=pw.reducers.sum(pw.this.v))


def _sliding_ratio_origin(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v
    1 | 3  | 1
    2 | 7  | 2
    3 | 12 | 4
    """)
    return t.windowby(pw.this.t, window=pw.temporal.sliding(hop=3, ratio=2, origin=1)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, total=pw.reducers.sum(pw.this.v))


def _datetime_tumbling(pw):
    base = datetime.datetime(2024, 5, 1, 12, 0, tzinfo=datetime.timezone.utc)
    rows = [(base + datetime.timedelta(seconds=s), v) for s, v in ((5, 1), (50, 2), (70, 4), (185, 8))]
    t = pw.debug.table_from_rows(schema=pw.schema_from_types(at=datetime.datetime, v=int), rows=rows)
    return t.windowby(pw.this.at, window=pw.temporal.tumbling(duration=datetime.timedelta(minutes=1))).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _cutoff_behavior(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v  | __time__
    1 | 1  | 10 | 0
    2 | 9  | 20 | 2
    3 | 2  | 99 | 4
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4),
                      behavior=pw.temporal.common_behavior(cutoff=2)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _exactly_once(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__
    1 | 1 | 10 | 0
    2 | 2 | 20 | 2
    3 | 9 | 30 | 4
    4 | 13| 40 | 6
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4),
                      behavior=pw.temporal.exactly_once_behavior()).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


# ---- temporal joins (reference tests/test_temporal.py) ----

LEFT2 = """
  | t | a
1 | 1 | l1
2 | 5 | l2
"""


def _interval_inner(pw):
    left = pw.debug.table_from_markdown(LEFT2)
    right = pw.debug.table_from_markdown("""
      | t | b
    1 | 2 | r1
    2 | 9 | r2
    """)
    return left.interval_join(right, left.t, right.t, pw.temporal.interval(-2, 2)).select(a=left.a, b=right.b)


def _interval_left(pw):
    left = pw.debug.table_from_markdown(LEFT2)
    right = pw.debug.table_from_markdown("""
      | t | b
    1 | 2 | r1
    """)
    return pw.temporal.interval_join_left(left, right, left.t, right.t, pw.temporal.interval(-2, 2)).select(
        a=left.a, b=right.b)


def _interval_right_outer(pw):
    left = pw.debug.table_from_markdown(LEFT2)
    right = pw.debug.table_from_markdown("""
      | t  | b
    1 | 2  | r1
    2 | 20 | r2
    """)
    rj = pw.temporal.interval_join_right(left, right, left.t, right.t, pw.temporal.interval(-2, 2)).select(
        a=left.a, b=right.b)
    oj = pw.temporal.interval_join_outer(left, right, left.t, right.t, pw.temporal.interval(-2, 2)).select(
        a=left.a, b=right.b)
    return rj.concat_reindex(oj)


def _interval_on(pw):
    left = pw.debug.table_from_markdown("""
      | t | k | a
    1 | 1 | x | l1
    2 | 1 | y | l2
    """)
    right = pw.debug.table_from_markdown("""
      | t | k | b
    1 | 2 | x | r1
    """)
    return left.interval_join(right, left.t, right.t, pw.temporal.interval(-2, 2), left.k == right.k).select(
        a=left.a, b=right.b)


def _asof(pw):
    trades = pw.debug.table_from_markdown("""
      | t  | price
    1 | 2  | 100
    2 | 7  | 101
    """)
    quotes = pw.debug.table_from_markdown("""
      | t  | bid
    1 | 1  | 99
    2 | 6  | 100
    3 | 10 | 102
    """)
    return trades.asof_join(quotes, trades.t, quotes.t).select(price=trades.price, bid=quotes.bid)


def _asof_directions(pw):
    trades = pw.debug.table_from_markdown("""
      | t  | price
    1 | 2  | 100
    2 | 7  | 101
    3 | 0  | 102
    """)
    quotes = pw.debug.table_from_markdown("""
      | t  | bid
    1 | 1  | 99
    2 | 6  | 100
    3 | 10 | 103
    """)
    fwd = pw.temporal.asof_join_left(trades, quotes, trades.t, quotes.t,
                                     direction=pw.temporal.Direction.FORWARD).select(
        d=0, price=trades.price, bid=quotes.bid)
    near = pw.temporal.asof_join_outer(trades, quotes, trades.t, quotes.t,
                                       direction=pw.temporal.Direction.NEAREST).select(
        d=1, price=trades.price, bid=quotes.bid)
    back = pw.temporal.asof_join_right(trades, quotes, trades.t, quotes.t).select(
        d=2, price=trades.price, bid=quotes.bid)
    return fwd.concat_reindex(near, back)


def _window_join(pw):
    left = pw.debug.table_from_markdown(LEFT2)
    right = pw.debug.table_from_markdown("""
      | t | b
    1 | 2 | r1
    2 | 6 | r2
    3 | 9 | r3
    """)
    return pw.temporal.window_join(left, right, left.t, right.t, pw.temporal.tumbling(duration=4)).select(
        a=left.a, b=right.b)


def _window_join_outer(pw):
    left = pw.debug.table_from_markdown(LEFT2)
    right = pw.debug.table_from_markdown("""
      | t  | b
    1 | 2  | r1
    3 | 13 | r3
    """)
    lj = pw.temporal.window_join_left(left, right, left.t, right.t, pw.temporal.tumbling(duration=4)).select(
        a=left.a, b=right.b)
    oj = pw.temporal.window_join_outer(left, right, left.t, right.t, pw.temporal.tumbling(duration=4)).select(
        a=left.a, b=right.b)
    return lj.concat_reindex(oj)


def _asof_now(pw):
    queries = pw.debug.table_from_markdown("""
      | q  | __time__
    1 | q1 | 2
    2 | q2 | 6
    """)
    state = pw.debug.table_from_markdown("""
      | v  | __time__ | __diff__
    1 | s1 | 0        | 1
    1 | s1 | 4        | -1
    2 | s2 | 4        | 1
    """)
    return pw.temporal.asof_now_join(queries, state).select(q=queries.q, v=state.v)


def _asof_now_replacement(pw):
    queries = pw.debug.table_from_markdown("""
      | q   | __time__ | __diff__
    1 | q1  | 0        | 1
    1 | q1b | 2        | 1
    1 | q1  | 2        | -1
    """)
    state = pw.debug.table_from_markdown("""
      | v
    1 | s1
    """)
    return pw.temporal.asof_now_join(queries, state).select(q=queries.q, v=state.v)


# ---- under scripted streams (reference tests/test_temporal_streams.py) ----


def _tumbling_across_epochs(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__ | __diff__
    1 | 1 | 10 | 2        | 1
    2 | 2 | 20 | 4        | 1
    3 | 5 | 30 | 6        | 1
    2 | 2 | 20 | 8        | -1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v), n=pw.reducers.count())


def _tumbling_revisions(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__ | __diff__
    1 | 1 | 10 | 2        | 1
    2 | 2 | 20 | 4        | 1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _sliding_membership(pw):
    t = pw.debug.table_from_markdown("""
      | t | v | __time__ | __diff__
    1 | 3 | 1 | 2        | 1
    1 | 3 | 1 | 4        | -1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.sliding(hop=2, duration=4)).reduce(
        start=pw.this._pw_window_start, n=pw.reducers.count())


def _session_late_bridge(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v | __time__ | __diff__
    1 | 1  | 1 | 2        | 1
    2 | 10 | 2 | 2        | 1
    3 | 5  | 4 | 4        | 1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.session(max_gap=5)).reduce(
        n=pw.reducers.count(), total=pw.reducers.sum(pw.this.v))


def _session_split(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v | __time__ | __diff__
    1 | 1  | 1 | 2        | 1
    2 | 5  | 2 | 2        | 1
    3 | 9  | 4 | 2        | 1
    2 | 5  | 2 | 4        | -1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.session(max_gap=5)).reduce(n=pw.reducers.count())


def _intervals_over(pw):
    t = pw.debug.table_from_markdown("""
      | t | v | __time__ | __diff__
    1 | 1 | 1 | 2        | 1
    2 | 3 | 2 | 2        | 1
    3 | 7 | 4 | 4        | 1
    """)
    probes = pw.debug.table_from_markdown("""
      | at | __time__ | __diff__
    7 | 4  | 2        | 1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.intervals_over(at=probes.at, lower_bound=-3, upper_bound=0)).reduce(
        at=pw.this._pw_window_end, total=pw.reducers.sum(pw.this.v))


def _delay_behavior(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__
    1 | 1 | 10 | 0
    2 | 2 | 20 | 2
    3 | 9 | 30 | 4
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4),
                      behavior=pw.temporal.common_behavior(delay=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _keep_results_false(pw):
    t = pw.debug.table_from_markdown("""
      | t  | v  | __time__
    1 | 1  | 10 | 0
    2 | 9  | 20 | 2
    3 | 20 | 30 | 4
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4),
                      behavior=pw.temporal.common_behavior(cutoff=2, keep_results=False)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _interval_boundary(pw):
    left = pw.debug.table_from_markdown("""
      | t | __time__ | __diff__
    1 | 5 | 2        | 1
    """)
    right = pw.debug.table_from_markdown("""
      | t | v | __time__ | __diff__
    7 | 3 | 1 | 2        | 1
    8 | 7 | 2 | 2        | 1
    9 | 2 | 3 | 2        | 1
    """)
    return left.interval_join(right, left.t, right.t, pw.temporal.interval(-2, 2)).select(lt=left.t, rv=right.v)


def _interval_late_right(pw):
    left = pw.debug.table_from_markdown("""
      | t | __time__ | __diff__
    1 | 5 | 2        | 1
    """)
    right = pw.debug.table_from_markdown("""
      | t | v | __time__ | __diff__
    7 | 4 | 1 | 6        | 1
    """)
    return pw.temporal.interval_join_left(left, right, left.t, right.t, pw.temporal.interval(-1, 1)).select(
        lt=left.t, rv=right.v)


def _asof_retraction(pw):
    left = pw.debug.table_from_markdown("""
      | t | __time__ | __diff__
    1 | 5 | 2        | 1
    """)
    right = pw.debug.table_from_markdown("""
      | t | v | __time__ | __diff__
    7 | 3 | 1 | 2        | 1
    8 | 4 | 2 | 4        | 1
    8 | 4 | 2 | 6        | -1
    """)
    return left.asof_join(right, left.t, right.t).select(lt=left.t, rv=right.v)


def _window_join_streamed(pw):
    left = pw.debug.table_from_markdown("""
      | t | a | __time__ | __diff__
    1 | 1 | x | 2        | 1
    """)
    right = pw.debug.table_from_markdown("""
      | t | b | __time__ | __diff__
    7 | 2 | y | 4        | 1
    8 | 6 | z | 4        | 1
    """)
    return left.window_join(right, left.t, right.t, pw.temporal.tumbling(duration=4)).select(a=left.a, b=right.b)


def _window_moves_on_update(pw):
    """A row whose time moves (a change stream's update) leaves its old
    window and lands in its new one, in one epoch."""
    t = pw.debug.table_from_markdown("""
      | t   | c | __time__ | __diff__
    1 | 10  | a | 2        | 1
    2 | 70  | b | 2        | 1
    3 | 75  | a | 2        | 1
    1 | 10  | a | 4        | -1
    1 | 130 | b | 4        | 1
    3 | 75  | a | 6        | -1
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=60)).reduce(
        start=pw.this._pw_window_start, n=pw.reducers.count())


# ---- sharded equivalence (reference test_sharded_ops_matrix.py, test_sharded.py) ----

EVENTS = """
  | k | t  | v
1 | a | 2  | 10
2 | a | 6  | 20
3 | b | 4  | 30
4 | b | 12 | 40
5 | a | 14 | 50
6 | c | 8  | 60
"""

PROBES = """
  | k | t
1 | a | 5
2 | a | 13
3 | b | 9
4 | c | 3
"""


def _matrix_asof(pw):
    left, right = pw.debug.table_from_markdown(PROBES), pw.debug.table_from_markdown(EVENTS)
    return left.asof_join(right, left.t, right.t, left.k == right.k, how="left").select(
        k=left.k, probe_t=left.t, v=right.v)


def _matrix_interval(pw):
    left, right = pw.debug.table_from_markdown(PROBES), pw.debug.table_from_markdown(EVENTS)
    return left.interval_join(right, left.t, right.t, pw.temporal.interval(-4, 4), left.k == right.k).select(
        k=left.k, lt=left.t, rt=right.t, v=right.v)


def _matrix_window_join(pw):
    left, right = pw.debug.table_from_markdown(PROBES), pw.debug.table_from_markdown(EVENTS)
    return left.window_join(right, left.t, right.t, pw.temporal.tumbling(duration=8), left.k == right.k).select(
        k=left.k, lt=left.t, rt=right.t)


def _matrix_session(pw):
    t = pw.debug.table_from_markdown(EVENTS)
    return t.windowby(t.t, window=pw.temporal.session(max_gap=5), instance=t.k).reduce(
        k=pw.this._pw_instance, cnt=pw.reducers.count(), total=pw.reducers.sum(pw.this.v))


def _matrix_streamed_interval(pw):
    left = pw.debug.table_from_markdown("""
      | k | t | __time__
    1 | a | 4 | 2
    2 | a | 9 | 4
    3 | b | 6 | 6
    """)
    right = pw.debug.table_from_markdown("""
      | k | t | v  | __time__
    1 | a | 5 | 10 | 4
    2 | a | 8 | 20 | 6
    3 | b | 7 | 30 | 2
    """)
    return left.interval_join(right, left.t, right.t, pw.temporal.interval(-2, 2), left.k == right.k).select(
        k=left.k, lt=left.t, rt=right.t, v=right.v)


def _sharded_windowby_streamed(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__
    1 | 1 | 10 | 0
    2 | 5 | 30 | 2
    3 | 2 | 20 | 4
    4 | 9 | 40 | 6
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


def _sharded_delay(pw):
    t = pw.debug.table_from_markdown("""
      | t | v  | __time__
    1 | 1 | 10 | 0
    2 | 2 | 20 | 0
    3 | 3 | 30 | 0
    4 | 9 | 40 | 2
    """)
    return t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=4),
                      behavior=pw.temporal.common_behavior(delay=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v))


# ---- ordered and statistical (reference test_graphs_stats.py) ----


def _interpolate(pw):
    t = pw.debug.table_from_markdown("""
      | t | v
    1 | 0 | 0.0
    2 | 2 |
    3 | 4 | 4.0
    """)
    return pw.stdlib.statistical.interpolate(t, pw.this.t, pw.this.v)


def _interpolate_two_gap(pw):
    """A gap of two rows: each missing value sees only its direct
    neighbours (one of them missing too), so it takes the known one
    rather than the line through both ends (the reference's one-row gaps)."""
    t = pw.debug.table_from_markdown("""
      | t | v   | w
    1 | 0 | 0.0 | 1.0
    2 | 1 |     | 2.0
    3 | 2 |     |
    4 | 3 | 6.0 | 4.0
    """)
    return t.interpolate(pw.this.t, pw.this.v, pw.this.w)


def _diff(pw):
    t = pw.debug.table_from_markdown("""
      | t | v
    1 | 1 | 10
    2 | 2 | 15
    3 | 3 | 21
    """)
    return pw.stdlib.ordered.diff(t, pw.this.t, pw.this.v)


def _diff_instance_streamed(pw):
    t = pw.debug.table_from_markdown("""
      | g | t | v  | __time__
    1 | a | 1 | 10 | 2
    2 | b | 1 | 3  | 2
    3 | a | 3 | 17 | 4
    4 | a | 2 | 12 | 6
    5 | b | 5 | 9  | 6
    """)
    return t.diff(pw.this.t, pw.this.v, instance=pw.this.g)


CASES = {
    "tumbling_batch": _tumbling_batch,
    "tumbling_streamed": _tumbling_streamed,
    "sliding_batch": _sliding_batch,
    "sliding_ratio_origin": _sliding_ratio_origin,
    "session_max_gap": _session_max_gap,
    "session_predicate": _session_predicate,
    "instance_keying": _instance_keying,
    "datetime_tumbling": _datetime_tumbling,
    "cutoff_behavior": _cutoff_behavior,
    "exactly_once": _exactly_once,
    "interval_inner": _interval_inner,
    "interval_left": _interval_left,
    "interval_right_outer": _interval_right_outer,
    "interval_on": _interval_on,
    "asof": _asof,
    "asof_directions": _asof_directions,
    "window_join": _window_join,
    "window_join_outer": _window_join_outer,
    "asof_now": _asof_now,
    "asof_now_replacement": _asof_now_replacement,
    "tumbling_across_epochs": _tumbling_across_epochs,
    "tumbling_revisions": _tumbling_revisions,
    "sliding_membership": _sliding_membership,
    "session_late_bridge": _session_late_bridge,
    "session_split": _session_split,
    "intervals_over": _intervals_over,
    "delay_behavior": _delay_behavior,
    "keep_results_false": _keep_results_false,
    "interval_boundary": _interval_boundary,
    "interval_late_right": _interval_late_right,
    "asof_retraction": _asof_retraction,
    "window_join_streamed": _window_join_streamed,
    "window_moves_on_update": _window_moves_on_update,
    "matrix_asof": _matrix_asof,
    "matrix_interval": _matrix_interval,
    "matrix_window_join": _matrix_window_join,
    "matrix_session": _matrix_session,
    "matrix_streamed_interval": _matrix_streamed_interval,
    "sharded_windowby_streamed": _sharded_windowby_streamed,
    "sharded_delay": _sharded_delay,
    "interpolate": _interpolate,
    "interpolate_two_gap": _interpolate_two_gap,
    "diff": _diff,
    "diff_instance_streamed": _diff_instance_streamed,
}


def _w0(stream, names):
    si = names.index("start")
    return [(r[names.index("total")], d) for _, r, _, d in stream if r[si] == 0]


# what the reference's own tests state, held on the port's result:
# check(state, stream, names)
CHECKS = {
    "tumbling_batch": lambda s, st, n: _cols(s, n, "start", "total", "n") == [(0, 30, 2), (4, 70, 2), (8, 50, 1)],
    "tumbling_streamed": lambda s, st, n: _cols(s, n, "start", "total") == [(0, 30), (4, 30)]
    and {(10, 1), (10, -1), (30, 1)} <= set(_w0(st, n)),
    "sliding_batch": lambda s, st, n: _cols(s, n, "start", "n") == [(-2, 1), (0, 2), (2, 2), (4, 1)],
    "session_max_gap": lambda s, st, n: _cols(s, n, "n") == [(2,), (2,)],
    "instance_keying": lambda s, st, n: _cols(s, n, "u", "total") == [("a", 3), ("b", 5)],
    "cutoff_behavior": lambda s, st, n: dict(_cols(s, n, "start", "total"))[0] == 10
    and dict(_cols(s, n, "start", "total"))[8] == 20,
    "exactly_once": lambda s, st, n: _w0(st, n) == [(30, 1)],
    "interval_inner": lambda s, st, n: _cols(s, n, "a", "b") == [("l1", "r1")],
    "interval_left": lambda s, st, n: _cols(s, n, "a", "b") == [("l1", "r1"), ("l2", None)],
    "interval_on": lambda s, st, n: _cols(s, n, "a", "b") == [("l1", "r1")],
    "asof": lambda s, st, n: _cols(s, n, "price", "bid") == [(100, 99), (101, 100)],
    "window_join": lambda s, st, n: _cols(s, n, "a", "b") == [("l1", "r1"), ("l2", "r2")],
    "asof_now": lambda s, st, n: _cols(s, n, "q", "v") == [("q1", "s1"), ("q2", "s2")],
    "asof_now_replacement": lambda s, st, n: _cols(s, n, "q", "v") == [("q1b", "s1")],
    "tumbling_across_epochs": lambda s, st, n: _cols(s, n, "start", "total", "n") == [(0, 10, 1), (4, 30, 1)],
    "tumbling_revisions": lambda s, st, n: _events(st, n, "start", "total")
    == sorted([((0, 10), 2, 1), ((0, 10), 4, -1), ((0, 30), 4, 1)], key=repr),
    "sliding_membership": lambda s, st, n: _events(st, n, "start", "n")
    == sorted([((0, 1), 2, 1), ((2, 1), 2, 1), ((0, 1), 4, -1), ((2, 1), 4, -1)], key=repr),
    "session_late_bridge": lambda s, st, n: _cols(s, n, "n", "total") == [(3, 7)],
    "session_split": lambda s, st, n: _cols(s, n, "n") == [(1,), (1,)],
    "intervals_over": lambda s, st, n: _cols(s, n, "at", "total") == [(4, 3)],
    "delay_behavior": lambda s, st, n: dict(_cols(s, n, "start", "total")).get(0) == 30,
    "keep_results_false": lambda s, st, n: 0 not in [a for a, _ in _cols(s, n, "start", "total")]
    and 20 in [a for a, _ in _cols(s, n, "start", "total")],
    "interval_boundary": lambda s, st, n: sorted(s.values()) == [(5, 1), (5, 2)],
    "interval_late_right": lambda s, st, n: _events(st, n, "lt", "rv")
    == sorted([((5, None), 2, 1), ((5, None), 6, -1), ((5, 1), 6, 1)], key=repr),
    "asof_retraction": lambda s, st, n: sorted(s.values()) == [(5, 1)],
    "window_join_streamed": lambda s, st, n: sorted(s.values()) == [("x", "y")],
    "window_moves_on_update": lambda s, st, n: dict(_cols(s, n, "start", "n")) == {60: 1, 120: 1},
    "interpolate": lambda s, st, n: sorted(s.values()) == [(0, 0.0), (2, 2.0), (4, 4.0)],
    "interpolate_two_gap": lambda s, st, n: sorted(s.values()) == [(0, 0.0, 1.0), (1, 0.0, 2.0), (2, 6.0, 3.0),
                                                                   (3, 6.0, 4.0)],
    "diff": lambda s, st, n: sorted((r[0] for r in s.values()), key=lambda v: (v is None, repr(v))) == [5, 6, None],
}


# the reference's engine loses rows of these at 4 workers: a key's new
# version and the retraction of its old one come from different shards,
# and its keyed-state and join nodes applied whichever arrived first as
# the last word. The port's nodes keep such a key's versions until they
# consolidate (``engine.dataflow.apply_keyed``), so at 4 workers the port
# is held to the reference's 1-worker result.
REFERENCE_SHARDING_FAULTS = {"asof", "asof_retraction"}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_temporal_case_equals_reference(case, n_workers):
    ref_workers = 1 if case in REFERENCE_SHARDING_FAULTS else n_workers
    want = _run(jpw, CASES[case], ref_workers)
    got = _run(tpw, CASES[case], n_workers)
    assert got == want
    assert got[1], "the pipeline produced no update"
    if case in CHECKS:
        assert CHECKS[case](*got), got


@pytest.mark.parametrize("case", ["asof", "asof_retraction", "matrix_session", "sharded_delay",
                                  "window_moves_on_update"])
def test_four_workers_equal_one(case):
    one, four = _run(tpw, CASES[case], 1), _run(tpw, CASES[case], 4)
    assert four[0] == one[0] and sorted(four[1]) == sorted(one[1])


def test_asof_now_join_rejects_outer():
    for pw in (jpw, tpw):
        left = pw.debug.table_from_markdown("""
          | a
        1 | x
        """)
        right = pw.debug.table_from_markdown("""
          | b
        1 | y
        """)
        with pytest.raises(ValueError):
            _run(pw, lambda pw: pw.temporal.asof_now_join(left, right, how="outer").select(a=left.a, b=right.b), 1)
        pw.clear_graph()


def test_public_names_of_the_temporal_stdlib():
    """``pw.temporal`` (and ``pw.window``) export the reference's names, of the
    same kinds; the result-type aliases and ``Interval`` behave alike."""
    assert tpw.window is tpw.temporal and tpw.stdlib.temporal is tpw.temporal
    assert tpw.temporal.__all__ == jpw.temporal.__all__
    for name in jpw.temporal.__all__:
        assert callable(getattr(tpw.temporal, name)) == callable(getattr(jpw.temporal, name)), name
    assert tpw.temporal.IntervalJoinResult is tpw.temporal.WindowJoinResult
    assert tpw.temporal.AsofNowJoinResult is tpw.JoinResult
    iv = tpw.temporal.Interval(-1, 1)
    assert (iv.lower_bound, iv.upper_bound) == (-1, 1)
    assert [m.name for m in tpw.stdlib.statistical.InterpolateMode] == [
        m.name for m in jpw.stdlib.statistical.InterpolateMode]
    assert tpw.stdlib.ordered.__all__ == jpw.stdlib.ordered.__all__
    assert tpw.stdlib.statistical.__all__ == jpw.stdlib.statistical.__all__


def test_window_assignment_equals_reference():
    """The windows' own assignment of a time (and of a session's sorted
    times), over ints, floats and datetimes, with and without an origin."""
    base = datetime.datetime(2024, 1, 1, 0, 0, 30, tzinfo=datetime.timezone.utc)
    minute = datetime.timedelta(minutes=1)
    for make, times in (
        (lambda m: m.tumbling(duration=4), [0, 3, 4, -5, 17]),
        (lambda m: m.sliding(hop=2, duration=5, origin=1), [0, 1, 6, 11]),
        (lambda m: m.sliding(hop=0.5, ratio=3), [0.25, 1.0, 2.75]),
        (lambda m: m.tumbling(duration=minute), [base, base + 3 * minute]),
    ):
        for t in times:
            assert make(tpw.temporal).assign(t) == make(jpw.temporal).assign(t), t
    times = [1, 2, 6, 7, 20]
    for make in (lambda m: m.session(max_gap=3), lambda m: m.session(predicate=lambda a, b: b - a < 2)):
        assert make(tpw.temporal).merge(times) == make(jpw.temporal).merge(times)
    for pw in (jpw, tpw):
        with pytest.raises(ValueError):
            pw.temporal.session()


def test_utc_now_shares_one_clock_per_rate_and_graph():
    """One clock per refresh rate and per program; a cleared graph gets a fresh one."""
    from pathway_tpu_torch.internals.parse_graph import G

    rate = datetime.timedelta(seconds=5)
    a, b = tpw.temporal.utc_now(refresh_rate=rate), tpw.temporal.utc_now(refresh_rate=rate)
    c = tpw.temporal.utc_now(refresh_rate=datetime.timedelta(seconds=9))
    assert a is b and a is not c
    tpw.clear_graph()
    d = tpw.temporal.utc_now(refresh_rate=rate)
    assert d is not a and d in G.tables


def test_utc_now_ticks(monkeypatch):
    """The clock's thread ticks ``PATHWAY_TPU_CLOCK_MAX_TICKS`` times and
    ends; both packages deliver that many increasing UTC timestamps."""
    monkeypatch.setenv("PATHWAY_TPU_CLOCK_MAX_TICKS", "3")
    got = {}
    for pw in (jpw, tpw):
        received = []
        clock = pw.temporal.utc_now(refresh_rate=datetime.timedelta(milliseconds=20))
        pw.io.subscribe(clock, on_change=lambda key, row, time, is_addition, received=received: received.append(
            row["timestamp_utc"]))
        pw.run()
        pw.clear_graph()
        got[pw] = received
    for received in got.values():
        assert len(received) == 3 and all(ts.tzinfo is not None for ts in received) and sorted(received) == received


def _silent_subject(pw):
    """A connector subject of either package that sends nothing."""
    class Silent(pw.io.python.ConnectorSubject):
        def run(self):
            pass

    return Silent()


def test_inactivity_detection_builds_and_flags_a_silent_stream(monkeypatch):
    """``inactivity_detection`` builds with and without ``instance`` with the
    reference's columns; run over events stamped just after the pipeline
    was built and then silent, with a clock of three ticks, both packages
    flag each instance's last event and see no resumption."""
    monkeypatch.setenv("PATHWAY_TPU_CLOCK_MAX_TICKS", "3")
    out = {}
    for pw in (jpw, tpw):
        schema = pw.schema_from_types(t=datetime.datetime, sensor=str)
        events = pw.io.python.read(_silent_subject(pw), schema=schema)
        inact, resumed = pw.temporal.inactivity_detection(
            events.t, allowed_inactivity_period=datetime.timedelta(seconds=2), instance=events.sensor)
        assert "inactive_t" in inact.column_names() and "instance" in inact.column_names()
        assert "resumed_t" in resumed.column_names()
        inact2, resumed2 = pw.temporal.inactivity_detection(events.t, allowed_inactivity_period=datetime.timedelta(2))
        assert "instance" not in inact2.column_names() and "instance" not in resumed2.column_names()
        pw.clear_graph()

        soon = datetime.datetime.now(datetime.timezone.utc) + datetime.timedelta(milliseconds=300)
        rows = [(soon, "a"), (soon - datetime.timedelta(milliseconds=1), "a"), (soon, "b")]
        events = pw.debug.table_from_rows(schema=schema, rows=rows)
        inact, resumed = pw.temporal.inactivity_detection(
            events.t, allowed_inactivity_period=datetime.timedelta(milliseconds=10),
            refresh_rate=datetime.timedelta(milliseconds=250), instance=events.sensor)
        alerts, back = [], []
        pw.io.subscribe(inact, on_change=lambda key, row, time, is_addition, soon=soon: alerts.append(
            (row["instance"], row["inactive_t"] - soon, is_addition)))
        pw.io.subscribe(resumed, on_change=lambda key, row, time, is_addition: back.append(row))
        pw.run()
        pw.clear_graph()
        out[pw] = (sorted(alerts), back)
    assert out[tpw] == out[jpw]
    assert out[tpw] == ([("a", datetime.timedelta(0), True), ("b", datetime.timedelta(0), True)], [])


# ---- event-time windows and SQL over a Debezium change stream (chip_smoke.py's kafka_path, in miniature) ----


def _cdc_views(pw, monkeypatch, phases):
    """``pw.io.debezium.read`` over the script's ``confluent_kafka`` stand-in
    (an idle poll returns after 50 ms) -> a one-minute tumbling window and a
    SQL view, phase by phase -> (live rows, window multiset, category multiset)."""
    import collections
    import importlib
    import os
    import sys
    import threading

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import KafkaStandIn

    broker = KafkaStandIn()
    poll = broker.module.Consumer.poll
    monkeypatch.setattr(broker.module.Consumer, "poll", lambda self, timeout=None: poll(self, min(timeout, 0.05)))
    monkeypatch.setitem(sys.modules, "confluent_kafka", broker.module)
    broker.create_topic("pg.public.docs", 4)

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        category: str
        updated_at: int

    docs = pw.io.debezium.read({"bootstrap.servers": "localhost:9092", "group.id": "cdc",
                                "auto.offset.reset": "earliest"}, "pg.public.docs", schema=DocSchema,
                               db_type="postgres", autocommit_duration_ms=None)
    per_window = docs.windowby(pw.this.updated_at, window=pw.temporal.tumbling(duration=60)).reduce(
        start=pw.this._pw_window_start, n=pw.reducers.count())
    per_category = pw.sql("SELECT category, COUNT(*) AS n FROM docs GROUP BY category", docs=docs)
    cv = threading.Condition()
    state = {"rows": {}, "windows": collections.Counter(), "categories": collections.Counter()}

    def on_doc(key, row, time, is_addition):
        with cv:
            if is_addition:
                state["rows"][int(key)] = (row["doc_id"], row["category"], row["updated_at"])
            else:
                state["rows"].pop(int(key), None)
            cv.notify_all()

    def counter_of(name, label):
        def on_change(key, row, time, is_addition):
            with cv:
                state[name][(int(key), row[label], row["n"])] += 1 if is_addition else -1

        return on_change

    pw.io.subscribe(docs, on_doc)
    pw.io.subscribe(per_window, counter_of("windows", "start"))
    pw.io.subscribe(per_category, counter_of("categories", "category"))
    runner_cls = importlib.import_module(f"{pw.__name__}.internals.graph_runner").GraphRunner
    runners, real_init = [], runner_cls.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    monkeypatch.setattr(runner_cls, "__init__", recording_init)
    errors = []

    def run():
        try:
            pw.run(monitoring_level="none")
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    for records, live_after in phases:
        broker.produce_many("pg.public.docs", records)
        with cv:
            assert cv.wait_for(lambda: sorted(state["rows"].values()) == live_after or errors, timeout=60), errors
    runners[-1].engine.stop()
    broker.shutdown()
    th.join(timeout=60)
    pw.clear_graph()
    assert not th.is_alive() and not errors, errors
    return state


def test_windows_and_sql_over_a_debezium_stream_equal_reference(monkeypatch):
    """A snapshot, updates that move rows into later windows, and deletes:
    both packages' window and SQL view end equal, and equal to a plain
    count of the live rows (each row's ``updated_at`` from its event's
    commit time)."""
    import collections
    import os
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import debezium_envelope

    rng = np.random.default_rng(21)
    n, labels = 48, [f"category-{j:02d}" for j in range(4)]
    category = [labels[j] for j in rng.integers(0, len(labels), n)]
    version, lsn = {}, iter(range(1 << 20))

    def event(op, i, text):
        at = next(lsn)
        ts_ms = 1_699_999_980_000 + at * 20_000  # three commits a minute
        after = None if text is None else {"doc_id": i, "text": text, "category": category[i],
                                           "updated_at": ts_ms // 1000}
        before, version[i] = version.get(i), after
        return debezium_envelope(op, i, before, after, at, ts_ms=ts_ms)

    def live():
        return sorted((r["doc_id"], r["category"], r["updated_at"]) for r in version.values() if r is not None)

    phases = []
    phases.append(([event("r", i, f"doc {i}") for i in range(n)], live()))
    phases.append(([event("u", int(i), f"doc {i} again") for i in rng.choice(n, 12, replace=False)], live()))
    phases.append(([event("d", int(i), None) for i in rng.choice(n, 6, replace=False)], live()))
    views = {}
    for pw in (jpw, tpw):
        state = _cdc_views(pw, monkeypatch, phases)
        views[pw] = {name: sorted(k for k, c in state[name].items() if c) for name in ("windows", "categories")}
        assert all(c in (0, 1) for name in ("windows", "categories") for c in state[name].values())
    assert views[tpw] == views[jpw]
    rows = phases[-1][1]
    want_w = collections.Counter(at // 60 * 60 for _i, _c, at in rows)
    want_c = collections.Counter(c for _i, c, _at in rows)
    assert {s: k for _key, s, k in views[tpw]["windows"]} == dict(want_w) and len(views[tpw]["windows"]) == len(want_w)
    assert {c: k for _key, c, k in views[tpw]["categories"]} == dict(want_c)
