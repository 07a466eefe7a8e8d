"""pw.reducers namespace.

Rebuild of upstream Pathway's python/pathway/reducers (engine side
src/engine/reduce.rs:22-38)."""

from __future__ import annotations

from typing import Any, Callable

from .internals import dtype as dt
from .internals.expression import ColumnExpression, ReducerExpression


def count(*args) -> ReducerExpression:
    return ReducerExpression("count")


def sum(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("sum", expr)


def min(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("min", expr)


def max(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("max", expr)


def argmin(expr) -> ReducerExpression:
    return ReducerExpression("argmin", expr)


def argmax(expr) -> ReducerExpression:
    return ReducerExpression("argmax", expr)


def avg(expr) -> ReducerExpression:
    return ReducerExpression("avg", expr)


def unique(expr) -> ReducerExpression:
    return ReducerExpression("unique", expr)


def any(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("any", expr)


def sorted_tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("sorted_tuple", expr, skip_nones=skip_nones)


def tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("tuple", expr, skip_nones=skip_nones)


def ndarray(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("ndarray", expr, skip_nones=skip_nones)


def earliest(expr) -> ReducerExpression:
    return ReducerExpression("earliest", expr)


def latest(expr) -> ReducerExpression:
    return ReducerExpression("latest", expr)


def udf_reducer(reducer_cls):
    """Custom reducer from a BaseCustomAccumulator subclass."""

    def make(*args) -> ReducerExpression:
        return ReducerExpression("stateful", *args, fn=reducer_cls)

    return make


def stateful_many(combine_many: Callable) -> Callable:
    def make(*args) -> ReducerExpression:
        return ReducerExpression("stateful_many", *args, fn=combine_many)

    return make


def stateful_single(combine_single: Callable) -> Callable:
    def make(*args) -> ReducerExpression:
        return ReducerExpression("stateful_single", *args, fn=combine_single)

    return make


class BaseCustomAccumulator:
    """Base for pw.reducers.udf_reducer accumulators (reference
    custom_reducers.py). Subclasses implement from_row, update, compute_result,
    optionally retract/neutral."""

    @classmethod
    def from_row(cls, row):
        raise NotImplementedError

    def update(self, other) -> None:
        raise NotImplementedError

    def compute_result(self):
        raise NotImplementedError
