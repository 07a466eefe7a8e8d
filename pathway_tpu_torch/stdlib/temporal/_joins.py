"""Temporal joins (reference stdlib/temporal/: _asof_join.py,
_asof_now_join.py, _interval_join.py, _window_join.py)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

from ...internals.expression import ColumnExpression, ColumnReference, smart_wrap
from ...internals.table import Table, JoinResult, _rewrite
from ...internals.thisclass import ThisMetaclass, left as left_cls, right as right_cls
from ._window import Window, _SlidingWindow


class Direction(enum.Enum):
    BACKWARD = enum.auto()
    FORWARD = enum.auto()
    NEAREST = enum.auto()


@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    return Interval(lower_bound, upper_bound)


class _TemporalJoinResult:
    """select()-able result of a temporal join. Wraps an inner JoinResult
    plus a time filter applied before projection. User expressions may
    reference the ORIGINAL tables; they are remapped onto the prepped
    (time-column-augmented) join sides. For left/right/outer joins the
    time condition belongs to the JOIN, not a post-filter: rows whose
    every pair fails the interval come back null-extended (reference
    _interval_join.py outer semantics)."""

    def __init__(
        self,
        join_result: JoinResult,
        extra_filter: ColumnExpression | None,
        lmap: Table | None = None,
        rmap: Table | None = None,
        lorig: Table | None = None,
        rorig: Table | None = None,
        how: str = "inner",
    ):
        self._maps = (lmap, rmap, lorig, rorig)
        self._how = how
        self._jr = join_result if extra_filter is None else join_result.filter(extra_filter)

    def _remap(self, expr):
        lmap, rmap, lorig, rorig = self._maps
        if lmap is None:
            return expr
        return _remap_on(smart_wrap(expr), lmap, rmap, lorig, rorig)

    def _null_extended(self, keep_side: Table, drop_side: Table, exprs: dict) -> Table:
        """Rows of keep_side with no surviving pair, with drop_side
        references replaced by None in the projection."""
        from ...internals.expression import ConstColumnExpression
        from ...internals.graph_runner import map_expression
        from ...internals.thisclass import this

        matched = self._jr.select(_pw_oid=keep_side.id)
        mk = matched.groupby(this._pw_oid).reduce(_pw_oid=this._pw_oid)
        mkeyed = mk.with_id(mk._pw_oid)
        unmatched = keep_side.difference(mkeyed)

        def nullify(e):
            if isinstance(e, ColumnReference) and e._table is drop_side:
                return ConstColumnExpression(None)
            return None

        nulled = {
            name: map_expression(_rewrite(e, lambda t: unmatched if t is keep_side else t), nullify)
            for name, e in exprs.items()
        }
        return unmatched.select(**nulled)

    def select(self, *args, **kwargs) -> Table:
        exprs: dict = {}
        for a in args:
            ra = self._remap(a)
            if not isinstance(ra, ColumnReference):
                raise TypeError("positional select args must be column references")
            exprs[ra._name] = ra
        for k, v in kwargs.items():
            exprs[k] = self._remap(v)
        matched = self._jr.select(**exprs)
        if self._how == "inner":
            return matched
        lmap, rmap, _lo, _ro = self._maps
        parts = [matched]
        if self._how in ("left", "outer"):
            parts.append(self._null_extended(lmap, rmap, exprs))
        if self._how in ("right", "outer"):
            parts.append(self._null_extended(rmap, lmap, exprs))
        return parts[0].concat_reindex(*parts[1:])

    def filter(self, expr):
        out = object.__new__(_TemporalJoinResult)
        out._maps = self._maps
        out._how = self._how
        out._jr = self._jr.filter(self._remap(expr))
        return out


def _prep_side(table: Table, time_expr, on_exprs_side):
    import pathway_tpu_torch as pw

    time_expr = _resolve(table, time_expr)
    return table.with_columns(_pw_t=time_expr)


def _resolve(table: Table, expr):
    from ...internals.table import _resolve_this

    return _resolve_this(smart_wrap(expr), table)


def _remap_on(cond, lmap: Table, rmap: Table, lorig: Table, rorig: Table):
    def map_table(t):
        if t is lorig or t is left_cls:
            return lmap
        if t is rorig or t is right_cls:
            return rmap
        if isinstance(t, ThisMetaclass):
            return lmap
        return t

    return _rewrite(cond, map_table)


def _apply_side_behavior(t: Table, behavior):
    """Apply a temporal behavior to one prepped join side: thresholds
    are relative to the side's own event time ``_pw_t`` (reference
    _interval_join.py behavior compilation -> forget/buffer on inputs)."""
    from ...internals.table import Column, LogicalOp, Table as _Table
    from .temporal_behavior import CommonBehavior

    if not isinstance(behavior, CommonBehavior):
        raise NotImplementedError(
            "temporal joins support common_behavior(delay=, cutoff=)"
        )
    params: dict = {"time_expr": t._pw_t}
    if behavior.delay is not None:
        params["delay_threshold"] = t._pw_t + behavior.delay
    if behavior.cutoff is not None:
        key = "freeze_threshold" if behavior.keep_results else "cutoff_threshold"
        params[key] = t._pw_t + behavior.cutoff
    if len(params) == 1:
        return t
    cols = {n: Column(c.dtype) for n, c in t._columns.items()}
    op = LogicalOp("temporal_behavior", [t], params)
    return _Table(cols, t._universe.subset(), op, name=f"{t._name}.join_behavior")


def _apply_window_side_behavior(t: Table, behavior):
    """Behavior for a window-join side AFTER window assignment: delay
    holds a (row, window) pair until watermark >= window_start + delay;
    cutoff drops/freezes it once watermark >= window_end + cutoff."""
    import pathway_tpu_torch as pw
    from ...internals import dtype as dt
    from ...internals.table import Column, LogicalOp, Table as _Table
    from .temporal_behavior import CommonBehavior

    if not isinstance(behavior, CommonBehavior):
        raise NotImplementedError(
            "window_join supports common_behavior(delay=, cutoff=)"
        )
    start = pw.apply_with_type(lambda w: w[0], dt.ANY, t._pw_wins)
    end = pw.apply_with_type(lambda w: w[1], dt.ANY, t._pw_wins)
    params: dict = {"time_expr": t._pw_t}
    if behavior.delay is not None:
        params["delay_threshold"] = start + behavior.delay
    if behavior.cutoff is not None:
        key = "freeze_threshold" if behavior.keep_results else "cutoff_threshold"
        params[key] = end + behavior.cutoff
    if len(params) == 1:
        return t
    cols = {n: Column(c.dtype) for n, c in t._columns.items()}
    op = LogicalOp("temporal_behavior", [t], params)
    return _Table(cols, t._universe.subset(), op, name=f"{t._name}.winjoin_behavior")


def interval_join(
    self: Table,
    other: Table,
    self_time: ColumnExpression,
    other_time: ColumnExpression,
    interval: Interval,
    *on: ColumnExpression,
    behavior=None,
    how: str = "inner",
) -> _TemporalJoinResult:
    """Join rows whose times satisfy
    other_time ∈ [self_time + lower, self_time + upper]
    (reference _interval_join.py)."""
    import pathway_tpu_torch as pw

    l = _prep_side(self, self_time, on)
    r = _prep_side(other, other_time, on)
    if behavior is not None:
        l = _apply_side_behavior(l, behavior)
        r = _apply_side_behavior(r, behavior)
    conds = [_remap_on(c, l, r, self, other) for c in on]
    if not conds:
        conds = [l.select(_pw_one=1)._pw_one == r.select(_pw_one=1)._pw_one]
        # cross join via constant key: build on zipped tables
        l = l.with_columns(_pw_one=1)
        r = r.with_columns(_pw_one=1)
        conds = [l._pw_one == r._pw_one]
    # the interval condition is part of the join: match on the inner
    # pairs and null-extend unmatched rows at select time (outer hows)
    jr = l.join(r, *conds, how="inner")
    filt = (r._pw_t >= l._pw_t + interval.lower_bound) & (
        r._pw_t <= l._pw_t + interval.upper_bound
    )
    return _TemporalJoinResult(jr, filt, lmap=l, rmap=r, lorig=self, rorig=other, how=how)


def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="inner", **kw)


def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="left", **kw)


def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="right", **kw)


def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
    return interval_join(self, other, self_time, other_time, interval, *on, how="outer", **kw)


def window_join(
    self: Table,
    other: Table,
    self_time: ColumnExpression,
    other_time: ColumnExpression,
    window: Window,
    *on: ColumnExpression,
    how: str = "inner",
    behavior=None,
) -> _TemporalJoinResult:
    """Join rows landing in the same window (reference _window_join.py).
    ``behavior``: common behavior applied to both sides, thresholds
    relative to each side's event time."""
    import pathway_tpu_torch as pw
    from ...internals import dtype as dt

    assert isinstance(window, _SlidingWindow), "window_join supports tumbling/sliding"

    def assign(t):
        return window.assign(t)

    l = _prep_side(self, self_time, on)
    r = _prep_side(other, other_time, on)
    l = l.with_columns(
        _pw_wins=pw.apply_with_type(assign, dt.ANY_TUPLE, pw.this._pw_t)
    ).flatten(pw.this._pw_wins)
    r = r.with_columns(
        _pw_wins=pw.apply_with_type(assign, dt.ANY_TUPLE, pw.this._pw_t)
    ).flatten(pw.this._pw_wins)
    if behavior is not None:
        # per-WINDOW thresholds, applied after window assignment: a row
        # is late for a window only once the watermark passes that
        # window's end + cutoff (CommonBehavior's documented contract;
        # one row belongs to several sliding windows, so a per-row
        # pre-filter could not express this)
        l = _apply_window_side_behavior(l, behavior)
        r = _apply_window_side_behavior(r, behavior)
    conds = [l._pw_wins == r._pw_wins] + [_remap_on(c, l, r, self, other) for c in on]
    jr = l.join(r, *conds, how=how)
    return _TemporalJoinResult(jr, None, lmap=l, rmap=r, lorig=self, rorig=other)


def window_join_inner(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how="inner", **kw)


def window_join_left(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how="left", **kw)


def window_join_right(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how="right", **kw)


def window_join_outer(self, other, self_time, other_time, window, *on, **kw):
    return window_join(self, other, self_time, other_time, window, *on, how="outer", **kw)


class _AsofJoinResult:
    """select()-able asof join result (reference _asof_join.py)."""

    def __init__(
        self, left: Table, right: Table, pairs: Table, how: str, lorig: Table | None = None
    ):
        # ``left`` is the PREPPED side (shares pairs' universe — with a
        # behavior, rows past the cutoff are already excluded from it);
        # ``lorig`` is the user's table, whose refs remap onto ``left``
        self._left = left
        self._right = right
        self._pairs = pairs  # keyed by left id: columns _pw_rkey
        self._how = how
        self._lorig = lorig if lorig is not None else left

    def select(self, *args, **kwargs) -> Table:
        import pathway_tpu_torch as pw

        left, right, pairs = self._left, self._right, self._pairs

        lorig = self._lorig

        def map_expr(e):
            def map_table(t):
                return t

            # left refs -> direct columns (pairs shares left universe);
            # right refs -> ix through _pw_rkey
            from ...internals.expression import IxExpression

            def rewrite(x):
                if isinstance(x, ColumnReference):
                    t = x._table
                    if t is right or t is right_cls:
                        if x._name == "id":
                            return pairs._pw_rkey
                        return IxExpression(right, pairs._pw_rkey, x._name, True)
                    if t is left_cls or isinstance(t, ThisMetaclass) or t is lorig:
                        return ColumnReference(left, x._name) if x._name != "id" else left.id
                return None

            from ...internals.graph_runner import map_expression

            return map_expression(e, rewrite)

        out_kwargs = {}
        for a in args:
            if isinstance(a, ColumnReference):
                out_kwargs[a._name] = map_expr(a)
        for n, e in kwargs.items():
            out_kwargs[n] = map_expr(smart_wrap(e))
        result = left.select(**{})  # placeholder to share universe
        sel = left.select(**out_kwargs) if out_kwargs else left.select()
        if self._how == "inner":
            matched = pairs.filter(pairs._pw_rkey.is_not_none())
            sel = sel.intersect(matched)
        return sel

    # keep parity helpers
    def filter(self, expr):
        raise NotImplementedError("filter on asof join result: apply on .select output")


def asof_join(
    self: Table,
    other: Table,
    self_time: ColumnExpression,
    other_time: ColumnExpression,
    *on: ColumnExpression,
    how: str = "inner",
    direction: Direction = Direction.BACKWARD,
    defaults: dict | None = None,
    behavior=None,
) -> _AsofJoinResult:
    """For each left row, match the closest right row by time (reference
    _asof_join.py). BACKWARD: latest right with t_r <= t_l."""
    import pathway_tpu_torch as pw

    l = self.with_columns(_pw_t=_resolve(self, self_time), _pw_lkey=pw.this.id)
    r = other.with_columns(_pw_t=_resolve(other, other_time), _pw_rkey=pw.this.id)
    if behavior is not None:
        l = _apply_side_behavior(l, behavior)
        r = _apply_side_behavior(r, behavior)
    conds = [_remap_on(c, l, r, self, other) for c in on]
    if not conds:
        l = l.with_columns(_pw_one=1)
        r = r.with_columns(_pw_one=1)
        conds = [l._pw_one == r._pw_one]
    jr = l.join(r, *conds, how="inner")
    if direction == Direction.BACKWARD:
        jr = jr.filter(r._pw_t <= l._pw_t)
        score = r._pw_t
        pick = pw.reducers.argmax
    elif direction == Direction.FORWARD:
        jr = jr.filter(r._pw_t >= l._pw_t)
        score = r._pw_t
        pick = pw.reducers.argmin
    else:  # NEAREST

        def absdiff(a, b):
            d = a - b
            return -d if d < (a - a) else d

        score = pw.apply_with_type(lambda a, b: abs(a - b), float, l._pw_t, r._pw_t)
        pick = pw.reducers.argmin
    cand = jr.select(_pw_lkey=l._pw_lkey, _pw_rkey=r._pw_rkey, _pw_score=score)
    best = cand.groupby(cand._pw_lkey).reduce(
        _pw_lkey=cand._pw_lkey,
        _pw_best=pick(cand._pw_score),
    )
    best_keyed = best.with_id(best._pw_lkey)
    chosen = best_keyed.select(
        _pw_rkey=cand.ix(pw.this._pw_best, optional=True)._pw_rkey
    )
    pairs = l.select(
        _pw_rkey=chosen.ix(pw.this.id, optional=True)._pw_rkey,
    )
    return _AsofJoinResult(l, other, pairs, how, lorig=self)


def asof_join_left(self, other, self_time, other_time, *on, **kw):
    kw["how"] = "left"
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_join_right(self, other, self_time, other_time, *on, **kw):
    kw["how"] = "right"
    return asof_join(other, self, other_time, self_time, *on, **kw)


def asof_join_outer(self, other, self_time, other_time, *on, **kw):
    kw["how"] = "left"
    return asof_join(self, other, self_time, other_time, *on, **kw)


def asof_now_join(
    self: Table,
    other: Table,
    *on: ColumnExpression,
    how: str = "inner",
    id=None,
) -> JoinResult:
    """Join each (streaming) left row against the right table as of the
    row's processing time; results are not updated retroactively
    (reference _asof_now_join.py; engine AsofNowJoinNode)."""
    return self.join(other, *on, how=f"asof_now_{how}", id=id)


def asof_now_join_inner(self, other, *on, **kw):
    return asof_now_join(self, other, *on, how="inner", **kw)


def asof_now_join_left(self, other, *on, **kw):
    return asof_now_join(self, other, *on, how="left", **kw)
