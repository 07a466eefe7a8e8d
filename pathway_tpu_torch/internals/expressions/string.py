"""`.str` expression namespace.

Rebuild of upstream Pathway's python/pathway/internals/expressions/string.py."""

from __future__ import annotations

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression


def _m(name, fn, ret, args):
    return MethodCallExpression(f"str.{name}", fn, ret, args)


class StringNamespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def lower(self):
        return _m("lower", lambda s: s.lower(), dt.STR, [self._expr])

    def upper(self):
        return _m("upper", lambda s: s.upper(), dt.STR, [self._expr])

    def reversed(self):
        return _m("reversed", lambda s: s[::-1], dt.STR, [self._expr])

    def len(self):
        return _m("len", len, dt.INT, [self._expr])

    def strip(self, chars=None):
        return _m("strip", lambda s, c: s.strip(c), dt.STR, [self._expr, chars])

    def lstrip(self, chars=None):
        return _m("lstrip", lambda s, c: s.lstrip(c), dt.STR, [self._expr, chars])

    def rstrip(self, chars=None):
        return _m("rstrip", lambda s, c: s.rstrip(c), dt.STR, [self._expr, chars])

    def startswith(self, prefix):
        return _m("startswith", lambda s, p: s.startswith(p), dt.BOOL, [self._expr, prefix])

    def endswith(self, suffix):
        return _m("endswith", lambda s, p: s.endswith(p), dt.BOOL, [self._expr, suffix])

    def count(self, sub, start=None, end=None):
        return _m(
            "count",
            lambda s, x, a, b: s.count(x, a if a is not None else 0, b if b is not None else len(s)),
            dt.INT,
            [self._expr, sub, start, end],
        )

    def find(self, sub, start=None, end=None):
        return _m(
            "find",
            lambda s, x, a, b: s.find(x, a if a is not None else 0, b if b is not None else len(s)),
            dt.INT,
            [self._expr, sub, start, end],
        )

    def rfind(self, sub, start=None, end=None):
        return _m(
            "rfind",
            lambda s, x, a, b: s.rfind(x, a if a is not None else 0, b if b is not None else len(s)),
            dt.INT,
            [self._expr, sub, start, end],
        )

    def replace(self, old, new, count=-1):
        return _m(
            "replace",
            lambda s, o, n, c: s.replace(o, n, c),
            dt.STR,
            [self._expr, old, new, count],
        )

    def split(self, sep=None, maxsplit=-1):
        return _m(
            "split",
            lambda s, sp, m: tuple(s.split(sp, m)),
            dt.List(dt.STR),
            [self._expr, sep, maxsplit],
        )

    def title(self):
        return _m("title", lambda s: s.title(), dt.STR, [self._expr])

    def capitalize(self):
        return _m("capitalize", lambda s: s.capitalize(), dt.STR, [self._expr])

    def casefold(self):
        return _m("casefold", lambda s: s.casefold(), dt.STR, [self._expr])

    def swapcase(self):
        return _m("swapcase", lambda s: s.swapcase(), dt.STR, [self._expr])

    def ljust(self, width, fillchar=" "):
        return _m("ljust", lambda s, w, f: s.ljust(w, f), dt.STR, [self._expr, width, fillchar])

    def rjust(self, width, fillchar=" "):
        return _m("rjust", lambda s, w, f: s.rjust(w, f), dt.STR, [self._expr, width, fillchar])

    def zfill(self, width):
        return _m("zfill", lambda s, w: s.zfill(w), dt.STR, [self._expr, width])

    def removeprefix(self, prefix):
        return _m("removeprefix", lambda s, p: s.removeprefix(p), dt.STR, [self._expr, prefix])

    def removesuffix(self, suffix):
        return _m("removesuffix", lambda s, p: s.removesuffix(p), dt.STR, [self._expr, suffix])

    def slice(self, start, end):
        return _m("slice", lambda s, a, b: s[a:b], dt.STR, [self._expr, start, end])

    def parse_int(self, optional: bool = False):
        fn = (lambda s: _try(int, s)) if optional else int
        return _m("parse_int", fn, dt.Optional(dt.INT) if optional else dt.INT, [self._expr])

    def parse_float(self, optional: bool = False):
        fn = (lambda s: _try(float, s)) if optional else float
        return _m("parse_float", fn, dt.Optional(dt.FLOAT) if optional else dt.FLOAT, [self._expr])

    def parse_bool(self, true_values=("on", "true", "yes", "1"), false_values=("off", "false", "no", "0"), optional: bool = False):
        def fn(s):
            low = s.strip().lower()
            if low in true_values:
                return True
            if low in false_values:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return _m("parse_bool", fn, dt.Optional(dt.BOOL) if optional else dt.BOOL, [self._expr])

    def to_bytes(self, encoding: str = "utf-8"):
        return _m("to_bytes", lambda s, e: s.encode(e), dt.BYTES, [self._expr, encoding])

    def to_string(self):
        # bytes decode as utf-8 (the inverse of to_bytes), everything
        # else stringifies
        def fn(s):
            if isinstance(s, str):
                return s
            if isinstance(s, bytes):
                return s.decode("utf-8", errors="replace")
            return str(s)

        return _m("to_string", fn, dt.STR, [self._expr])


def _try(fn, s):
    try:
        return fn(s)
    except (ValueError, TypeError):
        return None
