"""`.num` expression namespace.

Rebuild of upstream Pathway's python/pathway/internals/expressions/numerical.py."""

from __future__ import annotations

import math

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression


def _m(name, fn, ret, args, propagate_none=True):
    return MethodCallExpression(f"num.{name}", fn, ret, args, propagate_none)


class NumericalNamespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def abs(self):
        base = dt.unoptionalize(self._expr._dtype)
        ret = base if base in (dt.INT, dt.FLOAT, dt.DURATION) else dt.FLOAT
        return _m("abs", abs, ret, [self._expr])

    def round(self, decimals=0):
        base = dt.unoptionalize(self._expr._dtype)
        ret = dt.INT if base is dt.INT else dt.FLOAT
        return _m("round", lambda v, d: round(v, d) if d else float(round(v)) if isinstance(v, float) else round(v), ret, [self._expr, decimals])

    def floor(self):
        return _m("floor", math.floor, dt.INT, [self._expr])

    def ceil(self):
        return _m("ceil", math.ceil, dt.INT, [self._expr])

    def sqrt(self):
        return _m("sqrt", math.sqrt, dt.FLOAT, [self._expr])

    def log(self, base=math.e):
        return _m("log", lambda v, b: math.log(v, b), dt.FLOAT, [self._expr, base])

    def log2(self):
        return _m("log2", math.log2, dt.FLOAT, [self._expr])

    def log10(self):
        return _m("log10", math.log10, dt.FLOAT, [self._expr])

    def exp(self):
        return _m("exp", math.exp, dt.FLOAT, [self._expr])

    def sin(self):
        return _m("sin", math.sin, dt.FLOAT, [self._expr])

    def cos(self):
        return _m("cos", math.cos, dt.FLOAT, [self._expr])

    def tan(self):
        return _m("tan", math.tan, dt.FLOAT, [self._expr])

    def fill_na(self, default_value):
        import numpy as _np

        def fn(v, d):
            if v is None:
                return d
            if isinstance(v, float) and math.isnan(v):
                return d
            return v

        base = dt.unoptionalize(self._expr._dtype)
        return MethodCallExpression(
            "num.fill_na", fn, dt.lub(base, dt.dtype_from_type(type(default_value))),
            [self._expr, default_value], propagate_none=False,
        )
