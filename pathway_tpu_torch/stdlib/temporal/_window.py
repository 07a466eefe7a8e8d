"""Windows (reference stdlib/temporal/_window.py: _SessionWindow :70,
_SlidingWindow :260 (tumbling = hop==duration), _IntervalsOverWindow :515,
windowby :865)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ...internals import dtype as dt
from ...internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
    smart_wrap,
)
from ...internals.table import LogicalOp, Table, Column, _resolve_this, _rewrite
from ...internals.thisclass import ThisMetaclass
from ...internals.universe import Universe
from .temporal_behavior import Behavior, CommonBehavior, ExactlyOnceBehavior


class Window:
    pass


@dataclass
class _SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any = None

    def assign(self, t):
        """All (start, end) windows containing t."""
        import datetime

        origin = self.origin
        if origin is None:
            if isinstance(t, datetime.datetime):
                # a fixed epoch: datetime windows align to midnight
                # 1970-01-01 in the value's own timezone (reference
                # windows accept datetime time columns with timedelta
                # durations and no explicit origin)
                origin = datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo)
            else:
                origin = t * 0  # zero of the right type (int/float)
        out = []
        # first window whose end > t: start > t - duration
        import math

        k = (t - origin - self.duration) / self.hop
        try:
            k0 = math.floor(k) + 1
        except TypeError:  # timedelta division yields float already
            k0 = math.floor(k) + 1
        start = origin + k0 * self.hop
        while start <= t:
            out.append((start, start + self.duration))
            start = start + self.hop
        return tuple(out)


@dataclass
class _TumblingWindow(_SlidingWindow):
    pass


@dataclass
class _SessionWindow(Window):
    predicate: Callable | None = None
    max_gap: Any = None

    def merge(self, times: list) -> list[tuple]:
        """Given sorted event times, return (start, end) per time."""
        if not times:
            return []
        bounds = []
        cur_start = times[0]
        prev = times[0]
        spans = []
        for t in times[1:]:
            together = (
                self.predicate(prev, t)
                if self.predicate is not None
                else (t - prev) <= self.max_gap
            )
            if not together:
                spans.append((cur_start, prev))
                cur_start = t
            prev = t
        spans.append((cur_start, prev))
        # map each time to its span
        out = []
        si = 0
        for t in times:
            while si < len(spans) and t > spans[si][1]:
                si += 1
            out.append(spans[si])
        return out


@dataclass
class _IntervalsOverWindow(Window):
    at: ColumnReference
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def tumbling(duration, origin=None) -> Window:
    return _TumblingWindow(hop=duration, duration=duration, origin=origin)


def sliding(hop, duration=None, ratio: int | None = None, origin=None) -> Window:
    if duration is None:
        assert ratio is not None
        duration = hop * ratio
    return _SlidingWindow(hop=hop, duration=duration, origin=origin)


def session(*, predicate: Callable | None = None, max_gap=None) -> Window:
    if (predicate is None) == (max_gap is None):
        raise ValueError("session() requires exactly one of predicate / max_gap")
    return _SessionWindow(predicate=predicate, max_gap=max_gap)


def intervals_over(*, at: ColumnReference, lower_bound, upper_bound, is_outer: bool = True) -> Window:
    return _IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class WindowGroupedTable:
    """Result of windowby, supports .reduce (reference WindowGroupedTable)."""

    def __init__(self, flat: Table, source: Table, grouping_names: list[str]):
        self._flat = flat
        self._source = source
        self._grouping_names = grouping_names

    def reduce(self, *args, **kwargs) -> Table:
        flat = self._flat
        source = self._source

        def remap(tab):
            if isinstance(tab, ThisMetaclass) or tab is source:
                return flat
            return tab

        new_args = []
        for a in args:
            if isinstance(a, ColumnReference):
                new_args.append(_rewrite(a, remap))
            else:
                new_args.append(a)
        new_kwargs = {}
        for n, e in kwargs.items():
            e = smart_wrap(e)
            new_kwargs[n] = _rewrite(e, remap)
        grouped = flat.groupby(*[flat[n] for n in self._grouping_names])
        return grouped.reduce(*new_args, **new_kwargs)


def windowby(
    table: Table,
    time_expr: ColumnExpression,
    *,
    window: Window,
    behavior: Behavior | None = None,
    instance: ColumnExpression | None = None,
    origin=None,
) -> WindowGroupedTable:
    import pathway_tpu_torch as pw

    time_expr = _resolve_this(smart_wrap(time_expr), table)
    instance_expr = (
        _resolve_this(smart_wrap(instance), table) if instance is not None else None
    )

    if isinstance(window, _SlidingWindow):
        win = window
        if origin is not None:
            win = _SlidingWindow(window.hop, window.duration, origin)

        def assign(t):
            return win.assign(t)

        t2 = table.with_columns(
            _pw_time=time_expr,
            _pw_instance=instance_expr if instance_expr is not None else 0,
        )
        t3 = t2.with_columns(
            _pw_windows=pw.apply_with_type(assign, dt.ANY_TUPLE, t2._pw_time)
        )
        t4 = t3.flatten(t3._pw_windows)
        t5 = t4.with_columns(
            _pw_window_start=t4._pw_windows[0],
            _pw_window_end=t4._pw_windows[1],
            _pw_window=pw.make_tuple(
                t4._pw_instance, t4._pw_windows[0], t4._pw_windows[1]
            ),
        ).without("_pw_windows")
    elif isinstance(window, _SessionWindow):
        win = window
        t2 = table.with_columns(
            _pw_time=time_expr,
            _pw_instance=instance_expr if instance_expr is not None else 0,
            _pw_key=pw.this.id,
        )
        sessions = t2.groupby(t2._pw_instance).reduce(
            _pw_instance=t2._pw_instance,
            _pw_pairs=pw.reducers.sorted_tuple(
                pw.make_tuple(t2._pw_time, t2._pw_key)
            ),
        )

        def assign_sessions(pairs):
            times = [p[0] for p in pairs]
            spans = win.merge(list(times))
            return tuple(
                (p[1], s[0], s[1]) for p, s in zip(pairs, spans)
            )

        flat = sessions.select(
            _pw_instance=sessions._pw_instance,
            _pw_assign=pw.apply_with_type(
                assign_sessions, dt.ANY_TUPLE, sessions._pw_pairs
            ),
        ).flatten(pw.this._pw_assign)
        keyed = flat.select(
            _pw_instance=flat._pw_instance,
            _pw_window_start=flat._pw_assign[1],
            _pw_window_end=flat._pw_assign[2],
            _pw_window=pw.make_tuple(
                flat._pw_instance, flat._pw_assign[1], flat._pw_assign[2]
            ),
            _pw_orig=flat._pw_assign[0],
        ).with_id(pw.this._pw_orig)
        t5 = t2.with_columns(
            _pw_window_start=keyed.ix(pw.this.id)._pw_window_start,
            _pw_window_end=keyed.ix(pw.this.id)._pw_window_end,
            _pw_window=keyed.ix(pw.this.id)._pw_window,
        )
    elif isinstance(window, _IntervalsOverWindow):
        at_ref = window.at
        at_table = at_ref._table
        lb, ub = window.lower_bound, window.upper_bound
        at_t = at_table.select(
            _pw_at=at_ref,
            _pw_at_instance=0 if instance_expr is None else instance_expr,
        )
        d_t = table.with_columns(
            _pw_time=time_expr,
            _pw_instance=instance_expr if instance_expr is not None else 0,
        )
        pairs = at_t.join(
            d_t,
            at_t._pw_at_instance == d_t._pw_instance,
            how="left" if window.is_outer else "inner",
        )
        sel_kwargs = {n: d_t[n] for n in table._columns}
        t5 = pairs.select(
            _pw_time=d_t._pw_time,
            _pw_instance=at_t._pw_at_instance,
            _pw_window_start=at_t._pw_at + lb,
            _pw_window_end=at_t._pw_at + ub,
            _pw_window=pw.make_tuple(at_t._pw_at_instance, at_t._pw_at),
            **sel_kwargs,
        )
        t5 = t5.filter(
            pw.this._pw_time.is_none()
            | ((pw.this._pw_time >= pw.this._pw_window_start)
               & (pw.this._pw_time <= pw.this._pw_window_end))
        )
    else:
        raise TypeError(f"unsupported window {window!r}")

    if behavior is not None:
        t5 = _apply_behavior(t5, behavior)

    return WindowGroupedTable(
        t5,
        table,
        ["_pw_window", "_pw_window_start", "_pw_window_end", "_pw_instance"],
    )


def _apply_behavior(t5: Table, behavior: Behavior) -> Table:
    params: dict[str, Any] = {"time_expr": t5._pw_time}
    if isinstance(behavior, CommonBehavior):
        if behavior.delay is not None:
            params["delay_threshold"] = t5._pw_window_start + behavior.delay
        if behavior.cutoff is not None:
            if behavior.keep_results:
                params["freeze_threshold"] = t5._pw_window_end + behavior.cutoff
            else:
                params["cutoff_threshold"] = t5._pw_window_end + behavior.cutoff
    elif isinstance(behavior, ExactlyOnceBehavior):
        # reference temporal_behavior.py:79: delay AND cutoff at
        # window_end + shift — the window emits once when it closes and
        # then FREEZES (late arrivals must not revise the emitted
        # result; without the freeze this was at-least-once)
        shift = behavior.shift
        end = t5._pw_window_end
        threshold = end + shift if shift is not None else end
        params["delay_threshold"] = threshold
        params["freeze_threshold"] = threshold
        params["flush_on_end"] = True
    cols = {n: Column(c.dtype) for n, c in t5._columns.items()}
    op = LogicalOp("temporal_behavior", [t5], params)
    return Table(cols, t5._universe, op, name=f"{t5._name}.behavior")
