"""`.dt` expression namespace: datetime/duration methods.

Rebuild of upstream Pathway's python/pathway/internals/expressions/date_time.py
(engine side: src/engine/time.rs — trait DateTime :16, strftime/strptime,
rounding :86-100)."""

from __future__ import annotations

import datetime as _dtm
import math

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression

try:
    from zoneinfo import ZoneInfo
except ImportError:  # pragma: no cover
    ZoneInfo = None  # type: ignore


def _m(name, fn, ret, args):
    return MethodCallExpression(f"dt.{name}", fn, ret, args)


import re as _re

# chrono tokens (reference time.rs strftime/strptime via chrono) that
# python's strptime lacks, mapped to equivalents
_CHRONO_ALIASES = {
    "%F": "%Y-%m-%d",
    "%T": "%H:%M:%S",
    "%R": "%H:%M",
    "%D": "%m/%d/%y",
    "%e": "%d",
    "%k": "%H",
}


_ESC = "\x00"  # stand-in for %% so token replacement skips escapes


def _convert_fmt(fmt: str) -> str:
    # chrono "%.f" means ".<fraction>" (dot included); "%3f/%6f/%9f" are
    # fixed-width fractions — python only has %f. "%%"-escaped literals
    # must not be rewritten.
    fmt = fmt.replace("%%", _ESC)
    fmt = fmt.replace("%.f", ".%f")
    fmt = fmt.replace("%:z", "%z")  # python's %z accepts the colon form
    fmt = _re.sub(r"%[369]f", "%f", fmt)
    for tok, repl in _CHRONO_ALIASES.items():
        fmt = fmt.replace(tok, repl)
    return fmt.replace(_ESC, "%%")


def _trim_fraction(s: str) -> str:
    # python %f takes at most 6 digits; chrono accepts up to 9
    # (nanoseconds) — truncate the sub-microsecond tail
    return _re.sub(r"(\.\d{6})\d+", r"\1", s)


def _make_strftime(fmt: str):
    """Compile a chrono-compatible strftime (fixed-width %3f/%6f/%9f
    fractions, alias tokens) ONCE per expression — only the fraction
    digits vary per row."""
    fmt = fmt.replace("%%", _ESC).replace("%.f", ".%f").replace("%:z", "%z")
    for tok, repl in _CHRONO_ALIASES.items():
        fmt = fmt.replace(tok, repl)
    fmt = fmt.replace(_ESC, "%%")
    has_frac = _re.search(r"%[369]f", fmt) is not None

    def fn(d, _fmt_arg=None):
        f = fmt
        if has_frac:
            micro = d.microsecond
            f = f.replace("%3f", f"{micro // 1000:03d}")
            f = f.replace("%6f", f"{micro:06d}")
            f = f.replace("%9f", f"{micro * 1000:09d}")
        return d.strftime(f)

    return fn


class DateTimeNamespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    # --- field accessors ---
    def year(self):
        return _m("year", lambda d: d.year, dt.INT, [self._expr])

    def month(self):
        return _m("month", lambda d: d.month, dt.INT, [self._expr])

    def day(self):
        return _m("day", lambda d: d.day, dt.INT, [self._expr])

    def hour(self):
        return _m("hour", lambda d: d.hour, dt.INT, [self._expr])

    def minute(self):
        return _m("minute", lambda d: d.minute, dt.INT, [self._expr])

    def second(self):
        return _m("second", lambda d: d.second, dt.INT, [self._expr])

    def millisecond(self):
        return _m("millisecond", lambda d: d.microsecond // 1000, dt.INT, [self._expr])

    def microsecond(self):
        return _m("microsecond", lambda d: d.microsecond, dt.INT, [self._expr])

    def nanosecond(self):
        return _m("nanosecond", lambda d: d.microsecond * 1000, dt.INT, [self._expr])

    def weekday(self):
        return _m("weekday", lambda d: d.weekday(), dt.INT, [self._expr])

    # --- parsing/formatting ---
    def strptime(self, fmt: str, contains_timezone: bool | None = None):
        # format conversion hoisted to construction: the per-row path is
        # one strptime (plus a fraction trim when %f is present)
        f2 = _convert_fmt(fmt)
        has_frac = "%f" in f2

        def fn(s, _f=None):
            if has_frac:
                s = _trim_fraction(s)
            return _dtm.datetime.strptime(s, f2)

        has_tz = contains_timezone if contains_timezone is not None else ("%z" in fmt or "%Z" in fmt or "%:z" in fmt)
        ret = dt.DATE_TIME_UTC if has_tz else dt.DATE_TIME_NAIVE
        return _m("strptime", fn, ret, [self._expr, fmt])

    def strftime(self, fmt: str):
        return _m("strftime", _make_strftime(fmt), dt.STR, [self._expr, fmt])

    def to_naive_in_timezone(self, timezone: str):
        def fn(d, tz):
            return d.astimezone(ZoneInfo(tz)).replace(tzinfo=None)

        return _m("to_naive_in_timezone", fn, dt.DATE_TIME_NAIVE, [self._expr, timezone])

    def to_utc(self, from_timezone: str):
        def fn(d, tz):
            return d.replace(tzinfo=ZoneInfo(tz)).astimezone(_dtm.timezone.utc)

        return _m("to_utc", fn, dt.DATE_TIME_UTC, [self._expr, from_timezone])

    def timestamp(self, unit: str | None = None):
        """Epoch offset as float in ``unit`` ('s'/'ms'/'us'/'ns'); with
        unit=None (deprecated, like the reference) an int in ns."""

        def _epoch_ns(d) -> int:
            if d.tzinfo is None:
                epoch = _dtm.datetime(1970, 1, 1)
            else:
                epoch = _dtm.datetime(1970, 1, 1, tzinfo=_dtm.timezone.utc)
            delta = d - epoch
            return (delta.days * 86_400 + delta.seconds) * 1_000_000_000 + (
                delta.microseconds * 1000
            )

        if unit is None:
            import warnings

            warnings.warn(
                "timestamp() without `unit` is deprecated; it defaults "
                "to nanoseconds",
                DeprecationWarning,
                stacklevel=2,
            )
            return _m("timestamp", _epoch_ns, dt.INT, [self._expr])
        div = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}[unit]
        return _m(
            "timestamp", lambda d: _epoch_ns(d) / div, dt.FLOAT, [self._expr]
        )

    def utc_from_timestamp(self, unit: str = "s"):
        div = {"s": 1, "ms": 1e3, "us": 1e6, "ns": 1e9}[unit]

        def fn(v):
            return _dtm.datetime.fromtimestamp(v / div, tz=_dtm.timezone.utc)

        return _m("utc_from_timestamp", fn, dt.DATE_TIME_UTC, [self._expr])

    def from_timestamp(self, unit: str = "s"):
        div = {"s": 1, "ms": 1e3, "us": 1e6, "ns": 1e9}[unit]

        def fn(v):
            return _dtm.datetime.utcfromtimestamp(v / div)

        return _m("from_timestamp", fn, dt.DATE_TIME_NAIVE, [self._expr])

    # --- timezone-aware arithmetic (reference date_time.py :840-:975;
    # defined by composition exactly as the reference does) ---
    def add_duration_in_timezone(self, duration, timezone: str):
        """Add wall-clock duration within a timezone (DST-aware): e.g.
        01:23 + 2h across a spring-forward gap lands on 04:23."""
        return (self.to_utc(timezone) + duration).dt.to_naive_in_timezone(timezone)

    def subtract_duration_in_timezone(self, duration, timezone: str):
        return (self.to_utc(timezone) - duration).dt.to_naive_in_timezone(timezone)

    def subtract_date_time_in_timezone(self, other, timezone: str):
        """Duration between two naive datetimes interpreted in a
        timezone (accounts for DST shifts between them)."""
        from ..expression import smart_wrap

        other = smart_wrap(other)
        return self.to_utc(timezone) - DateTimeNamespace(other).to_utc(timezone)

    # --- rounding (time.rs:86-100) ---
    def round(self, duration):
        return _m("round", _round_dt, self._expr._dtype, [self._expr, duration])

    def floor(self, duration):
        return _m("floor", _floor_dt, self._expr._dtype, [self._expr, duration])

    # --- duration accessors ---
    def nanoseconds(self):
        return _m("nanoseconds", lambda d: int(d.total_seconds() * 1e9), dt.INT, [self._expr])

    def microseconds(self):
        return _m("microseconds", lambda d: int(d.total_seconds() * 1e6), dt.INT, [self._expr])

    def milliseconds(self):
        return _m("milliseconds", lambda d: int(d.total_seconds() * 1e3), dt.INT, [self._expr])

    def seconds(self):
        return _m("seconds", lambda d: int(d.total_seconds()), dt.INT, [self._expr])

    def minutes(self):
        return _m("minutes", lambda d: int(d.total_seconds() // 60), dt.INT, [self._expr])

    def hours(self):
        return _m("hours", lambda d: int(d.total_seconds() // 3600), dt.INT, [self._expr])

    def days(self):
        return _m("days", lambda d: d.days, dt.INT, [self._expr])

    def weeks(self):
        return _m("weeks", lambda d: d.days // 7, dt.INT, [self._expr])


def _floor_dt(d, duration):
    if isinstance(d, _dtm.datetime):
        if d.tzinfo is None:
            epoch = _dtm.datetime(1970, 1, 1)
        else:
            epoch = _dtm.datetime(1970, 1, 1, tzinfo=_dtm.timezone.utc)
        delta = d - epoch
        n = delta // duration
        return epoch + n * duration
    raise TypeError(f"dt.floor: unsupported {type(d)}")


def _round_dt(d, duration):
    if isinstance(d, _dtm.datetime):
        lo = _floor_dt(d, duration)
        hi = lo + duration
        return hi if (d - lo) >= (hi - d) else lo
    raise TypeError(f"dt.round: unsupported {type(d)}")
