"""Column expression tree.

Rebuild of upstream Pathway's python/pathway/internals/expression.py (1,179
LoC ColumnExpression hierarchy). Pure data + eager type inference; the
graph runner compiles these to vectorized/rowwise evaluators
(internals/graph_runner.py), the TPU analog of the reference's engine
expression trees (src/engine/expression.rs)."""

from __future__ import annotations

import datetime
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping

import numpy as np

from . import dtype as dt

if TYPE_CHECKING:
    from .table import Table


class ColumnExpression:
    _dtype: dt.DType

    def __init__(self):
        self._dtype = dt.ANY

    # --- arithmetic ---
    def __add__(self, other):
        return ColumnBinaryOpExpression("+", self, other)

    def __radd__(self, other):
        return ColumnBinaryOpExpression("+", other, self)

    def __sub__(self, other):
        return ColumnBinaryOpExpression("-", self, other)

    def __rsub__(self, other):
        return ColumnBinaryOpExpression("-", other, self)

    def __mul__(self, other):
        return ColumnBinaryOpExpression("*", self, other)

    def __rmul__(self, other):
        return ColumnBinaryOpExpression("*", other, self)

    def __truediv__(self, other):
        return ColumnBinaryOpExpression("/", self, other)

    def __rtruediv__(self, other):
        return ColumnBinaryOpExpression("/", other, self)

    def __floordiv__(self, other):
        return ColumnBinaryOpExpression("//", self, other)

    def __rfloordiv__(self, other):
        return ColumnBinaryOpExpression("//", other, self)

    def __mod__(self, other):
        return ColumnBinaryOpExpression("%", self, other)

    def __rmod__(self, other):
        return ColumnBinaryOpExpression("%", other, self)

    def __pow__(self, other):
        return ColumnBinaryOpExpression("**", self, other)

    def __rpow__(self, other):
        return ColumnBinaryOpExpression("**", other, self)

    def __matmul__(self, other):
        return ColumnBinaryOpExpression("@", self, other)

    def __rmatmul__(self, other):
        return ColumnBinaryOpExpression("@", other, self)

    def __neg__(self):
        return ColumnUnaryOpExpression("-", self)

    def __invert__(self):
        return ColumnUnaryOpExpression("~", self)

    def __abs__(self):
        return MethodCallExpression("abs", abs, None, [self])

    # --- comparisons (return expressions, hence explicit __hash__) ---
    def __eq__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression("==", self, other)

    def __ne__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression("!=", self, other)

    def __lt__(self, other):
        return ColumnBinaryOpExpression("<", self, other)

    def __le__(self, other):
        return ColumnBinaryOpExpression("<=", self, other)

    def __gt__(self, other):
        return ColumnBinaryOpExpression(">", self, other)

    def __ge__(self, other):
        return ColumnBinaryOpExpression(">=", self, other)

    def __hash__(self):
        return id(self)

    # --- boolean ---
    def __and__(self, other):
        return ColumnBinaryOpExpression("&", self, other)

    def __rand__(self, other):
        return ColumnBinaryOpExpression("&", other, self)

    def __or__(self, other):
        return ColumnBinaryOpExpression("|", self, other)

    def __ror__(self, other):
        return ColumnBinaryOpExpression("|", other, self)

    def __xor__(self, other):
        return ColumnBinaryOpExpression("^", self, other)

    def __rxor__(self, other):
        return ColumnBinaryOpExpression("^", other, self)

    def __bool__(self):
        raise TypeError(
            "ColumnExpression cannot be used in boolean context; "
            "use & | ~ instead of and/or/not"
        )

    # --- containers ---
    def __getitem__(self, index):
        return SequenceGetExpression(self, index, check_if_exists=False)

    def get(self, index, default=None):
        return SequenceGetExpression(self, index, default=default, check_if_exists=True)

    # --- misc API ---
    def is_none(self):
        return IsNoneExpression(self)

    def is_not_none(self):
        return IsNotNoneExpression(self)

    def to_string(self):
        return MethodCallExpression(
            "to_string", _to_string, dt.STR, [self]
        )

    def as_int(self, unwrap: bool = False):
        return ConvertExpression(dt.INT, self, unwrap=unwrap)

    def as_float(self, unwrap: bool = False):
        return ConvertExpression(dt.FLOAT, self, unwrap=unwrap)

    def as_str(self, unwrap: bool = False):
        return ConvertExpression(dt.STR, self, unwrap=unwrap)

    def as_bool(self, unwrap: bool = False):
        return ConvertExpression(dt.BOOL, self, unwrap=unwrap)

    def fill_error(self, replacement):
        return FillErrorExpression(self, replacement)

    # namespaces
    @property
    def dt(self):
        from .expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from .expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from .expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    @property
    def _deps(self) -> list["ColumnExpression"]:
        return []

    def _refresh_dtype(self) -> None:
        """Recompute _dtype from (possibly rewritten) children — called
        after pw.this references resolve to real table columns, so type
        inference sees the concrete operand types."""

    def _repr_inner(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return f"<{self._repr_inner()}>"


def smart_wrap(value: Any) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ConstColumnExpression(value)


class ConstColumnExpression(ColumnExpression):
    def __init__(self, value: Any):
        super().__init__()
        self._val = value
        self._dtype = dt.dtype_from_type(type(value)) if value is not None else dt.NONE
        if isinstance(value, tuple):
            self._dtype = dt.Tuple(*[dt.dtype_from_type(type(v)) for v in value])
        if isinstance(value, np.ndarray):
            kind = value.dtype.kind
            self._dtype = dt.Array(value.ndim, {"i": dt.INT, "f": dt.FLOAT}.get(kind, dt.ANY))

    def _repr_inner(self):
        return f"Const({self._val!r})"


class ColumnReference(ColumnExpression):
    """Reference to table.column_name (or table.id when name == 'id')."""

    def __init__(self, table: Any, name: str):
        super().__init__()
        self._table = table
        self._name = name
        self._dtype = self._infer_dtype()

    def _infer_dtype(self) -> dt.DType:
        from .thisclass import ThisMetaclass

        if isinstance(self._table, ThisMetaclass) or self._table is None:
            return dt.ANY
        if self._name == "id":
            return dt.POINTER
        col = self._table._columns.get(self._name)
        return col.dtype if col is not None else dt.ANY

    @property
    def table(self):
        return self._table

    @property
    def name(self):
        return self._name

    def __call__(self, *args):
        """Call a column of callables per row (pw.method columns:
        ``table.select(r=table.c(10))``, reference MethodColumn)."""
        name = self._name

        def call_cell(f, *a):
            if callable(f):
                return f(*a)
            if f is None:
                return None  # missing method cell (e.g. outer join)
            raise TypeError(
                f"column {name!r} holds {type(f).__name__}, not a "
                "callable — only pw.method columns can be called"
            )

        # method cells read the transformer's CURRENT state, so the map
        # is non-deterministic: the engine must replay memoized outputs
        # on retraction instead of recomputing against newer state
        return ApplyExpression(
            call_cell, None, (self,) + args, {}, deterministic=False
        )

    def _column_with_expression_cls(self, cls, *args, **kwargs):
        return cls(self, *args, **kwargs)

    def _repr_inner(self):
        return f"{getattr(self._table, '_name', '?')}.{self._name}"


_ARITH_OPS = {"+", "-", "*", "/", "//", "%", "**", "@"}
_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}
_BOOL_OPS = {"&", "|", "^"}

# concrete simple types whose values have a total order the engine can use
_ORDERABLE = {
    dt.INT,
    dt.FLOAT,
    dt.BOOL,
    dt.STR,
    dt.BYTES,
    dt.DATE_TIME_NAIVE,
    dt.DATE_TIME_UTC,
    dt.DURATION,
    dt.POINTER,
}


def _binary_rule(op: str, l: dt.DType, r: dt.DType) -> dt.DType | None:
    """Typing rule table for binary operators. Returns the result dtype,
    or None when no rule covers the operand pair — the caller decides
    whether that is a build-time error (both operands concrete) or a
    deferred-to-runtime ANY (reference analogue: type_interpreter.py
    _eval_binary_op + operator mapping tables)."""
    lo, ro = dt.unoptionalize(l), dt.unoptionalize(r)
    opt = dt.is_optional(l) or dt.is_optional(r)

    def w(t: dt.DType) -> dt.DType:
        return dt.Optional(t) if opt else t

    if op in _CMP_OPS:
        if lo is dt.ANY or ro is dt.ANY:
            return dt.BOOL
        eq_only = op in ("==", "!=")
        if lo == ro:
            if eq_only or lo in _ORDERABLE or isinstance(lo, (dt.Tuple, dt.List)):
                return dt.BOOL
            return None
        if {lo, ro} <= {dt.INT, dt.FLOAT}:
            return dt.BOOL
        if eq_only and (l is dt.NONE or r is dt.NONE):
            return dt.BOOL
        if isinstance(lo, dt.Tuple) and isinstance(ro, dt.Tuple):
            return dt.BOOL
        if isinstance(lo, dt.Array) or isinstance(ro, dt.Array):
            return dt.BOOL
        return None
    if op in _BOOL_OPS:
        if lo is dt.BOOL and ro is dt.BOOL:
            return w(dt.BOOL)
        if lo is dt.INT and ro is dt.INT:
            return w(dt.INT)
        if lo is dt.ANY or ro is dt.ANY:
            return w(dt.ANY)
        return None
    if op in _ARITH_OPS:
        if op == "@":
            if isinstance(lo, dt.Array) or isinstance(ro, dt.Array):
                return w(dt.ANY_ARRAY)
            if lo is dt.ANY or ro is dt.ANY:
                return w(dt.ANY)
            return None
        if lo is dt.INT and ro is dt.INT:
            return w(dt.FLOAT if op == "/" else dt.INT)
        if lo in (dt.INT, dt.FLOAT) and ro in (dt.INT, dt.FLOAT):
            return w(dt.FLOAT)
        if op == "+" and lo is dt.STR and ro is dt.STR:
            return w(dt.STR)
        if op == "+" and lo is dt.BYTES and ro is dt.BYTES:
            return w(dt.BYTES)
        if op == "*" and {lo, ro} <= {dt.STR, dt.INT} and lo != ro:
            return w(dt.STR)
        if op == "+" and isinstance(lo, dt.Tuple) and isinstance(ro, dt.Tuple):
            return w(dt.ANY_TUPLE)
        # datetime arithmetic
        if op == "-" and lo in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC) and ro == lo:
            return w(dt.DURATION)
        if op in ("+", "-") and lo in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC) and ro is dt.DURATION:
            return w(lo)
        if op == "+" and lo is dt.DURATION and ro in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
            return w(ro)
        if lo is dt.DURATION and ro is dt.DURATION:
            if op == "/":
                return w(dt.FLOAT)
            return w(dt.DURATION)
        if lo is dt.DURATION and ro in (dt.INT, dt.FLOAT):
            return w(dt.DURATION)
        if ro is dt.DURATION and lo in (dt.INT, dt.FLOAT) and op == "*":
            return w(dt.DURATION)
        if isinstance(lo, dt.Array) or isinstance(ro, dt.Array):
            return w(dt.ANY_ARRAY)
        if lo is dt.ANY or ro is dt.ANY:
            return w(dt.ANY)
        return None
    return dt.ANY


def _binary_result_type(op: str, l: dt.DType, r: dt.DType) -> dt.DType:
    res = _binary_rule(op, l, r)
    if res is not None:
        return res
    if dt.is_concrete(l) and dt.is_concrete(r):
        raise TypeError(
            f"operator {op!r} is not defined for column types {l} and {r}; "
            "cast an operand with pw.cast, or compute the value in Python "
            "with pw.apply"
        )
    return dt.BOOL if op in _CMP_OPS else dt.ANY


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, op: str, left: Any, right: Any):
        super().__init__()
        self._op = op
        self._left = smart_wrap(left)
        self._right = smart_wrap(right)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = _binary_result_type(
            self._op, self._left._dtype, self._right._dtype
        )

    @property
    def _deps(self):
        return [self._left, self._right]

    def _repr_inner(self):
        return f"({self._left._repr_inner()} {self._op} {self._right._repr_inner()})"


class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, op: str, expr: Any):
        super().__init__()
        self._op = op
        self._expr = smart_wrap(expr)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        t = self._expr._dtype
        to = dt.unoptionalize(t)
        opt = dt.is_optional(t) and t is not dt.ANY
        if self._op == "~":
            if to in (dt.BOOL, dt.INT):
                self._dtype = dt.Optional(to) if opt else to
                return
        elif self._op == "-":
            if to in (dt.INT, dt.FLOAT, dt.DURATION) or isinstance(to, dt.Array):
                self._dtype = t
                return
        if dt.is_concrete(t):
            raise TypeError(
                f"unary operator {self._op!r} is not defined for column "
                f"type {t}; cast with pw.cast or use pw.apply"
            )
        self._dtype = t

    @property
    def _deps(self):
        return [self._expr]


class ApplyExpression(ColumnExpression):
    """pw.apply / pw.apply_with_type — python UDF over row values
    (reference Expression::Apply, graph.rs:465 BatchWrapper)."""

    def __init__(
        self,
        fn: Callable,
        return_type: Any,
        args: tuple,
        kwargs: Mapping[str, Any],
        *,
        propagate_none: bool = False,
        deterministic: bool = True,
        max_batch_size: int | None = None,
    ):
        super().__init__()
        self._fn = fn
        self._args = [smart_wrap(a) for a in args]
        self._kwargs = {k: smart_wrap(v) for k, v in kwargs.items()}
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._max_batch_size = max_batch_size
        self._dtype = dt.wrap(return_type) if return_type is not None else dt.ANY

    @property
    def _deps(self):
        return [*self._args, *self._kwargs.values()]


class AsyncApplyExpression(ApplyExpression):
    """pw.apply_async — async UDF batched per epoch
    (Graph::async_apply_table graph.rs:744)."""


class FullyAsyncApplyExpression(AsyncApplyExpression):
    """pw.apply_fully_async — results arrive in later epochs; round-1
    implementation completes within the epoch (same totals, eager
    latency)."""


class CastExpression(ColumnExpression):
    def __init__(self, target: Any, expr: Any):
        super().__init__()
        self._target = dt.wrap(target)
        self._expr = smart_wrap(expr)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = self._target
        if dt.is_optional(self._expr._dtype) and not isinstance(
            self._target, dt.Optional
        ):
            self._dtype = dt.Optional(self._target)

    @property
    def _deps(self):
        return [self._expr]


class ConvertExpression(ColumnExpression):
    """Json → typed value conversion (.as_int() etc.)."""

    def __init__(self, target: dt.DType, expr: Any, *, unwrap: bool = False, default=None):
        super().__init__()
        self._target = target
        self._expr = smart_wrap(expr)
        self._unwrap = unwrap
        self._default = default
        self._dtype = target if unwrap else dt.Optional(target)

    @property
    def _deps(self):
        return [self._expr]


class DeclareTypeExpression(ColumnExpression):
    """pw.declare_type — type assertion, valid only along the subtype
    axis (narrowing or widening); a cross-type reinterpretation is
    rejected at build time — that is pw.cast's job."""

    def __init__(self, target: Any, expr: Any):
        super().__init__()
        self._expr = smart_wrap(expr)
        self._dtype = dt.wrap(target)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        src = self._expr._dtype
        if (
            dt.is_concrete(src)
            and dt.is_concrete(self._dtype)
            and not (
                self._dtype.is_subclass_of(src) or src.is_subclass_of(self._dtype)
            )
        ):
            raise TypeError(
                f"pw.declare_type can only narrow or widen a column's type; "
                f"{src} -> {self._dtype} changes it outright — use pw.cast "
                "for a value conversion"
            )

    @property
    def _deps(self):
        return [self._expr]


class UnwrapExpression(ColumnExpression):
    """pw.unwrap — strip Optional, error on None."""

    def __init__(self, expr: Any):
        super().__init__()
        self._expr = smart_wrap(expr)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = dt.unoptionalize(self._expr._dtype)

    @property
    def _deps(self):
        return [self._expr]


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr: Any, replacement: Any):
        super().__init__()
        self._expr = smart_wrap(expr)
        self._replacement = smart_wrap(replacement)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = dt.lub(self._expr._dtype, self._replacement._dtype)
        if (
            self._dtype is dt.ANY
            and dt.is_concrete(self._expr._dtype)
            and dt.is_concrete(self._replacement._dtype)
        ):
            raise TypeError(
                f"pw.fill_error replacement type {self._replacement._dtype} "
                f"does not unify with the column type {self._expr._dtype}"
            )

    @property
    def _deps(self):
        return [self._expr, self._replacement]


class IfElseExpression(ColumnExpression):
    def __init__(self, if_: Any, then: Any, else_: Any):
        super().__init__()
        self._if = smart_wrap(if_)
        self._then = smart_wrap(then)
        self._else = smart_wrap(else_)
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        cond = self._if._dtype
        if dt.unoptionalize(cond) is not dt.BOOL and dt.is_concrete(cond):
            raise TypeError(
                f"pw.if_else condition must be a bool column, got {cond}"
            )
        then_t, else_t = self._then._dtype, self._else._dtype
        self._dtype = dt.lub(then_t, else_t)
        if (
            self._dtype is dt.ANY
            and dt.is_concrete(then_t)
            and dt.is_concrete(else_t)
        ):
            raise TypeError(
                f"pw.if_else branches have no common type: {then_t} vs "
                f"{else_t}; cast one branch with pw.cast"
            )

    @property
    def _deps(self):
        return [self._if, self._then, self._else]


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args: Any):
        super().__init__()
        self._args = [smart_wrap(a) for a in args]
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        result = self._args[-1]._dtype
        for a in reversed(self._args[:-1]):
            result = dt.lub(dt.unoptionalize(a._dtype), result)
        if result is dt.ANY and all(dt.is_concrete(a._dtype) for a in self._args):
            raise TypeError(
                "pw.coalesce arguments have no common type: "
                f"{[str(a._dtype) for a in self._args]}; cast them with "
                "pw.cast first"
            )
        non_opt = any(not dt.is_optional(a._dtype) for a in self._args)
        self._dtype = dt.unoptionalize(result) if non_opt else result

    @property
    def _deps(self):
        return list(self._args)


class RequireExpression(ColumnExpression):
    """pw.require(val, *deps) — None if any dep is None."""

    def __init__(self, val: Any, *args: Any):
        super().__init__()
        self._val = smart_wrap(val)
        self._args = [smart_wrap(a) for a in args]
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = dt.Optional(self._val._dtype)

    @property
    def _deps(self):
        return [self._val, *self._args]


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr: Any):
        super().__init__()
        self._expr = smart_wrap(expr)
        self._dtype = dt.BOOL

    @property
    def _deps(self):
        return [self._expr]


class IsNotNoneExpression(IsNoneExpression):
    pass


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args: Any):
        super().__init__()
        self._args = [smart_wrap(a) for a in args]
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = dt.Tuple(*[a._dtype for a in self._args])

    @property
    def _deps(self):
        return list(self._args)


class SequenceGetExpression(ColumnExpression):
    def __init__(self, expr: Any, index: Any, default: Any = None, *, check_if_exists: bool):
        super().__init__()
        self._expr = smart_wrap(expr)
        self._index = smart_wrap(index)
        self._default = smart_wrap(default)
        self._check_if_exists = check_if_exists
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        base = self._expr._dtype
        idx_t = dt.unoptionalize(self._index._dtype)
        if (
            idx_t is not dt.INT
            and dt.is_concrete(self._index._dtype)
            and isinstance(dt.unoptionalize(base), (dt.Tuple, dt.List, dt.Array))
        ):
            # JSON bases take str keys too; sequences are int-indexed only
            raise TypeError(
                f"sequence index must be an int column, got {self._index._dtype}"
            )
        check_if_exists = self._check_if_exists
        if isinstance(base, dt.Tuple) and base.args is not Ellipsis and isinstance(self._index, ConstColumnExpression) and isinstance(self._index._val, int) and -len(base.args) <= self._index._val < len(base.args):
            self._dtype = base.args[self._index._val]
        elif isinstance(base, dt.List):
            self._dtype = dt.Optional(base.wrapped) if check_if_exists else base.wrapped
        elif isinstance(base, dt.Array):
            self._dtype = base.strip_dimension()
        elif base is dt.JSON:
            self._dtype = dt.JSON
        elif base is dt.STR:
            self._dtype = dt.STR
        else:
            self._dtype = dt.ANY

    @property
    def _deps(self):
        return [self._expr, self._index, self._default]


class MethodCallExpression(ColumnExpression):
    """Namespace method call (.dt/.str/.num …): evaluates fn(*args)."""

    def __init__(self, name: str, fn: Callable, return_type: Any, args: Iterable[Any], propagate_none: bool = True):
        super().__init__()
        self._method_name = name
        self._fn = fn
        self._args = [smart_wrap(a) for a in args]
        self._propagate_none = propagate_none
        self._return_type = return_type
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        if self._return_type is None:
            self._dtype = dt.ANY
            return
        self._dtype = dt.wrap(self._return_type)
        if self._propagate_none and any(
            dt.is_optional(a._dtype) and a._dtype is not dt.ANY
            for a in self._args
        ):
            self._dtype = dt.Optional(self._dtype)

    @property
    def _deps(self):
        return list(self._args)

    def _repr_inner(self):
        return f"{self._method_name}({', '.join(a._repr_inner() for a in self._args)})"


class ReducerExpression(ColumnExpression):
    """Aggregation inside .reduce() / windowby (reference
    ReducerExpression; engine reducers in engine/reducers.py)."""

    def __init__(self, name: str, *args: Any, return_dtype: dt.DType | None = None, **kwargs: Any):
        super().__init__()
        self._reducer_name = name
        self._args = [smart_wrap(a) for a in args]
        self._kwargs = kwargs
        self._return_dtype = return_dtype
        self._refresh_dtype()

    def _refresh_dtype(self) -> None:
        self._dtype = self._return_dtype or self._infer()

    def _infer(self) -> dt.DType:
        name = self._reducer_name
        if name == "count":
            return dt.INT
        arg_t = self._args[0]._dtype if self._args else dt.ANY
        if name in ("sum", "min", "max", "unique", "any", "earliest", "latest"):
            return arg_t
        if name == "avg":
            return dt.FLOAT
        if name in ("argmin", "argmax"):
            return dt.POINTER
        if name in ("sorted_tuple", "tuple"):
            return dt.List(arg_t)
        if name == "ndarray":
            return dt.ANY_ARRAY
        return dt.ANY

    @property
    def _deps(self):
        return list(self._args)


class PointerExpression(ColumnExpression):
    """table.pointer_from(*args) — derive a key (ref_scalar)."""

    def __init__(self, table: Any, *args: Any, optional: bool = False, instance: Any = None):
        super().__init__()
        self._table = table
        self._args = [smart_wrap(a) for a in args]
        if instance is not None:
            self._args.append(smart_wrap(instance))
        self._optional = optional
        self._dtype = dt.Optional(dt.POINTER) if optional else dt.POINTER

    @property
    def _deps(self):
        return list(self._args)


class IxExpression(ColumnExpression):
    """table.ix(keys_expression)[column] — lookup by pointer."""

    def __init__(self, table: Any, keys_expr: ColumnExpression, name: str, optional: bool = False):
        super().__init__()
        self._ix_table = table
        self._keys_expr = keys_expr
        self._name = name
        self._optional = optional
        col = table._columns.get(name)
        base = col.dtype if col is not None else dt.ANY
        self._dtype = dt.Optional(base) if optional else base

    @property
    def _deps(self):
        return [self._keys_expr]


def _to_string(v) -> str:
    if v is None:
        return "None"
    if isinstance(v, bytes):
        # the inverse of .str.to_bytes() — consistent with
        # StringNamespace.to_string (divergence from the reference,
        # whose engine renders bytes in Rust Debug form)
        return v.decode("utf-8", errors="replace")
    return str(v)


# ---- public constructors (exported on the pw namespace) ----


def apply(fn: Callable, *args, **kwargs) -> ApplyExpression:
    import typing as _t

    hints = {}
    try:
        hints = _t.get_type_hints(fn)
    except Exception:
        pass
    ret = hints.get("return")
    return ApplyExpression(fn, ret, args, kwargs)


def apply_with_type(fn: Callable, result_type: Any, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fn, result_type, args, kwargs)


def apply_async(fn: Callable, *args, **kwargs) -> AsyncApplyExpression:
    import typing as _t

    hints = {}
    try:
        hints = _t.get_type_hints(fn)
    except Exception:
        pass
    return AsyncApplyExpression(fn, hints.get("return"), args, kwargs)


def apply_fully_async(fn: Callable, *args, **kwargs) -> FullyAsyncApplyExpression:
    return FullyAsyncApplyExpression(fn, None, args, kwargs)


def if_else(if_: Any, then: Any, else_: Any) -> IfElseExpression:
    return IfElseExpression(if_, then, else_)


def coalesce(*args: Any) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val: Any, *args: Any) -> RequireExpression:
    return RequireExpression(val, *args)


def make_tuple(*args: Any) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def cast(target, expr) -> CastExpression:
    return CastExpression(target, expr)


def declare_type(target, expr) -> DeclareTypeExpression:
    return DeclareTypeExpression(target, expr)


def unwrap(expr) -> UnwrapExpression:
    return UnwrapExpression(expr)


def fill_error(expr, replacement) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)
