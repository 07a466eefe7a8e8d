"""Columnar vectorized expression evaluation.

The reference evaluates compiled expression enums row by row inside the
Rust engine's hot loop (upstream Pathway's src/engine/expression.rs:489).
This rebuild instead batches each epoch's delta rows into
numpy columns and evaluates arithmetic / comparison / boolean / ifelse
expression trees with vectorized kernels — the columnar plan SURVEY §7
calls for — keeping the per-row compiled closure as an exact-semantics
fallback for UDFs, Json access, pointers, and any batch whose columns
are not cleanly typed.

Semantics contract (vs the per-row path in graph_runner.compile_inner):

- A column containing None, ERROR, Json, tuples, or mixed object types
  materializes as an object (or >1-D) ndarray → ``NotVectorized`` → the
  engine re-evaluates the batch per row. Null propagation, Kleene
  logic, and error routing therefore never take the vectorized path.
- Division / floordiv / mod with any zero divisor in the batch falls
  back, so ZeroDivisionError is raised (and reported) per row.
- int64 arithmetic wraps like the reference's Rust i64 (the per-row
  Python path has bignums; streams that overflow i64 are out of
  contract, as they are for the reference engine).
- Pure slot projections bypass numpy entirely: plain list indexing is
  faster and preserves object identity (bool vs int, Json, …).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..engine.value import Pointer
from . import dtype as dt
from .expression import (
    ApplyExpression,
    CastExpression,
    CoalesceExpression,
    ColumnBinaryOpExpression,
    ColumnExpression,
    ColumnReference,
    ColumnUnaryOpExpression,
    ConstColumnExpression,
    DeclareTypeExpression,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    UnwrapExpression,
)


class NotVectorized(Exception):
    """Control signal: this expression/batch must use the per-row path."""


_INT_TYPES = frozenset((int, np.int64, np.int32))
_FLOAT_TYPES = frozenset((float, np.float64, np.float32))
_BOOL_TYPES = frozenset((bool, np.bool_))
_STR_TYPES = frozenset((str,))


class Cols:
    """Lazy columnar view over a delta batch's row tuples.

    A column materializes only when its exact python types are
    homogeneous (all-int, all-float, all-bool, or all-str — checked with
    a C-speed ``set(map(type, …))`` scan), so the vectorized path can
    never silently coerce: Pointers and big ints stay exact, bool never
    aliases int (``values_equal`` keeps them distinct), None/Error/Json
    columns always take the per-row path."""

    __slots__ = ("rows", "n", "_cache")

    def __init__(self, rows: list[tuple], cache: dict | None = None):
        self.rows = rows
        self.n = len(rows)
        self._cache: dict[int, np.ndarray] = dict(cache) if cache else {}

    def col(self, i: int) -> np.ndarray:
        arr = self._cache.get(i)
        if arr is None:
            items = [r[i] for r in self.rows]
            tset = set(map(type, items))
            try:
                if tset <= _INT_TYPES:
                    # raises OverflowError past int64 → per-row path
                    arr = np.asarray(items, np.int64)
                elif tset <= _FLOAT_TYPES:
                    arr = np.asarray(items, np.float64)
                elif tset <= _BOOL_TYPES:
                    arr = np.asarray(items, bool)
                elif tset <= _STR_TYPES:
                    if any(s.endswith("\x00") for s in items):
                        # numpy '<U' storage drops trailing NULs, which
                        # would make comparisons diverge from per-row
                        raise NotVectorized
                    arr = np.asarray(items)
                else:
                    raise NotVectorized
            except (OverflowError, TypeError, ValueError):
                raise NotVectorized from None
            if arr.ndim != 1:
                raise NotVectorized
            self._cache[i] = arr
        return arr


def _as_array(v, n: int) -> np.ndarray:
    a = np.asarray(v)
    if a.ndim == 0:
        a = np.broadcast_to(a, (n,))
    return a


_NUMERIC = frozenset("biuf")


def _vec_binop(op: str, lf: Callable, rf: Callable) -> Callable:
    if op in ("+", "-", "*"):
        ufunc = {"+": np.add, "-": np.subtract, "*": np.multiply}[op]

        def arith(cols):
            a, b = lf(cols), rf(cols)
            if np.asarray(a).dtype.kind not in _NUMERIC or (
                np.asarray(b).dtype.kind not in _NUMERIC
            ):
                raise NotVectorized  # str + str etc: per-row
            return ufunc(a, b)

        return arith
    if op in ("/", "//", "%"):
        ufunc = {"/": np.true_divide, "//": np.floor_divide, "%": np.mod}[op]

        def div(cols):
            a, b = lf(cols), rf(cols)
            bb = np.asarray(b)
            if bb.dtype.kind not in _NUMERIC or np.asarray(a).dtype.kind not in _NUMERIC:
                raise NotVectorized
            if np.any(bb == 0):
                raise NotVectorized  # per-row raises ZeroDivisionError
            return ufunc(a, b)

        return div
    if op in ("==", "!=", "<", "<=", ">", ">="):
        ufunc = {
            "==": np.equal,
            "!=": np.not_equal,
            "<": np.less,
            "<=": np.less_equal,
            ">": np.greater,
            ">=": np.greater_equal,
        }[op]

        equality = op in ("==", "!=")

        def cmp(cols):
            a, b = lf(cols), rf(cols)
            ka, kb = np.asarray(a).dtype.kind, np.asarray(b).dtype.kind
            # numeric↔numeric or str↔str only; mixed kinds raise per-row
            if (ka in _NUMERIC) != (kb in _NUMERIC):
                raise NotVectorized
            # values_equal treats bool as distinct from int/float, but
            # np.equal(True, 1) is True — keep those batches per-row
            if equality and (ka == "b") != (kb == "b"):
                raise NotVectorized
            return ufunc(a, b)

        return cmp
    if op in ("&", "|", "^"):
        ufunc = {"&": np.bitwise_and, "|": np.bitwise_or, "^": np.bitwise_xor}[op]

        def bitop(cols):
            a, b = lf(cols), rf(cols)
            if np.asarray(a).dtype.kind not in "bui" or (
                np.asarray(b).dtype.kind not in "bui"
            ):
                raise NotVectorized
            return ufunc(a, b)

        return bitop
    raise NotVectorized  # **, @: per-row


def compile_vec(e: ColumnExpression, layout) -> Callable:
    """Compile to fn(cols: Cols) -> ndarray | scalar.

    Raises NotVectorized (compile time) for unsupported expression
    nodes; the returned fn raises NotVectorized (run time) when the
    batch's columns are not cleanly typed.
    """
    from .graph_runner import SlotRef  # local import: avoid cycle

    if isinstance(e, SlotRef):
        i = e._idx
        return lambda cols: cols.col(i)
    if isinstance(e, ConstColumnExpression):
        v = e._val
        if not isinstance(v, (bool, int, float, str)) or isinstance(v, Pointer):
            raise NotVectorized
        if isinstance(v, int) and not isinstance(v, bool) and abs(v) >= 2**63:
            raise NotVectorized  # would promote int64 columns to float64
        return lambda cols: v
    if isinstance(e, ColumnReference):
        t = e._table
        if t is None or e._name == "id":
            raise NotVectorized  # pointers stay per-row
        key = (t._id, e._name)
        if key not in layout.slots:
            raise NotVectorized
        i = layout.slots[key]
        return lambda cols: cols.col(i)
    if isinstance(e, ColumnBinaryOpExpression):
        lf = compile_vec(e._left, layout)
        rf = compile_vec(e._right, layout)
        return _vec_binop(e._op, lf, rf)
    if isinstance(e, ColumnUnaryOpExpression):
        f = compile_vec(e._expr, layout)
        if e._op == "-":

            def neg(cols):
                v = f(cols)
                if np.asarray(v).dtype.kind not in "if":
                    raise NotVectorized
                return np.negative(v)

            return neg

        def inv(cols):
            v = f(cols)
            if np.asarray(v).dtype.kind not in "bui":
                raise NotVectorized
            return np.invert(v)  # on bools == logical not, as per-row

        return inv
    if isinstance(e, IfElseExpression):
        cf = compile_vec(e._if, layout)
        tf = compile_vec(e._then, layout)
        ef = compile_vec(e._else, layout)

        def ifelse(cols):
            c = np.asarray(cf(cols))
            if c.dtype.kind != "b":
                raise NotVectorized
            t = _as_array(tf(cols), cols.n)
            el = _as_array(ef(cols), cols.n)
            if t.dtype != el.dtype:
                # per-row preserves each branch's type; np.where upcasts
                raise NotVectorized
            return np.where(c, t, el)

        return ifelse
    if isinstance(e, (IsNoneExpression, IsNotNoneExpression)):
        f = compile_vec(e._expr, layout)
        # NB: IsNotNoneExpression subclasses IsNoneExpression
        const = isinstance(e, IsNotNoneExpression)

        def isnone(cols):
            f(cols)  # typed column ⇒ no Nones (object dtype falls back)
            return np.full(cols.n, const)

        return isnone
    if isinstance(e, CoalesceExpression):
        # a typed first operand contains no Nones ⇒ coalesce == first;
        # Nones in it ⇒ object dtype ⇒ runtime fallback
        return compile_vec(e._args[0], layout)
    if isinstance(e, (DeclareTypeExpression, UnwrapExpression)):
        # typed column ⇒ no Nones ⇒ unwrap is the identity
        return compile_vec(e._expr, layout)
    if isinstance(e, CastExpression):
        f = compile_vec(e._expr, layout)
        target = e._target
        if target == dt.INT:

            def to_int(cols):
                v = np.asarray(f(cols))
                if v.dtype.kind == "f" and not np.isfinite(v).all():
                    raise NotVectorized  # int(nan/inf) raises per-row
                if v.dtype.kind not in _NUMERIC:
                    raise NotVectorized
                return v.astype(np.int64)  # trunc-toward-zero == int()

            return to_int
        if target == dt.FLOAT:

            def to_float(cols):
                v = np.asarray(f(cols))
                if v.dtype.kind not in _NUMERIC:
                    raise NotVectorized
                return v.astype(np.float64)

            return to_float
        if target == dt.BOOL:

            def to_bool(cols):
                v = np.asarray(f(cols))
                if v.dtype.kind not in _NUMERIC:
                    raise NotVectorized
                return v.astype(bool)

            return to_bool
        raise NotVectorized
    raise NotVectorized


def _to_list(v, n: int) -> list:
    if np.ndim(v) == 0:
        x = v.item() if isinstance(v, np.generic) else v
        return [x] * n
    return v.tolist()


def try_compile_batch(
    exprs: list[ColumnExpression],
    layout,
    row_fns: list[Callable],
) -> Callable | None:
    """Build a batch evaluator for an ExprMap's output expressions.

    Per-expression granularity: vectorizable expressions run columnar,
    bare slot projections run as list indexing, the rest run their
    per-row closure inside the batch loop. Returns None only when NO
    expression benefits (all per-row) — then the node's own per-row
    path is strictly better (it has per-row error routing).

    The returned callable follows the engine contract: (keys, rows) ->
    list of output row tuples, or None to request per-row evaluation
    (un-typed batch, error rows, …).
    """
    from .graph_runner import SlotRef

    specs: list[tuple[str, Any]] = []
    n_vec = 0
    for e, rf in zip(exprs, row_fns):
        if isinstance(e, SlotRef):
            specs.append(("slot", e._idx))
            continue
        if isinstance(e, ColumnReference):
            t = e._table
            if t is not None and e._name != "id":
                key = (getattr(t, "_id", None), e._name)
                if key in layout.slots:
                    specs.append(("slot", layout.slots[key]))
                    continue
        try:
            vf = compile_vec(e, layout)
        except NotVectorized:
            specs.append(("row", rf))
            continue
        specs.append(("vec", vf))
        n_vec += 1
    if n_vec == 0:
        return None

    import operator

    getters = {
        j: operator.itemgetter(f) for j, (kind, f) in enumerate(specs) if kind == "slot"
    }

    def batch_eval(keys: list, rows: list[tuple], cache: dict | None = None):
        """-> (rows_out, out_col_cache) or None (fall back to per-row)."""
        n = len(rows)
        cols = Cols(rows, cache)
        outs: list[list] = []
        out_cache: dict[int, np.ndarray] = {}
        try:
            for j, (kind, f) in enumerate(specs):
                if kind == "slot":
                    outs.append(list(map(getters[j], rows)))
                    arr = cols._cache.get(f)
                    if arr is not None:
                        out_cache[j] = arr
                elif kind == "vec":
                    try:
                        v = f(cols)
                        if isinstance(v, np.ndarray):
                            out_cache[j] = v
                        outs.append(_to_list(v, n))
                    except NotVectorized:
                        return None  # batch not cleanly typed: per-row
                else:
                    outs.append([f(k, r) for k, r in zip(keys, rows)])
        except Exception:
            # any failure (incl. UDF errors in "row" specs) → per-row
            # path, which has exact error routing
            return None
        return list(zip(*outs)), out_cache

    return batch_eval


def make_projection_batch(idxs: list[int]) -> Callable:
    """Batch evaluator for a pure slot projection (e.g. filter's
    project-back-to-base): C-speed itemgetter map instead of per-row
    closure calls; preserves object identity exactly. Follows the
    ExprMapNode batch contract: (keys, rows, cache) -> (rows_out,
    out_col_cache)."""
    import operator

    if len(idxs) == 1:
        get1 = operator.itemgetter(idxs[0])

        def proj1(keys: list, rows: list[tuple], cache: dict | None = None):
            out_cache = (
                {0: cache[idxs[0]]} if cache and idxs[0] in cache else {}
            )
            return [(v,) for v in map(get1, rows)], out_cache

        return proj1
    get = operator.itemgetter(*idxs)

    def proj(keys: list, rows: list[tuple], cache: dict | None = None):
        out_cache = {}
        if cache:
            out_cache = {
                j: cache[i] for j, i in enumerate(idxs) if i in cache
            }
        return list(map(get, rows)), out_cache

    return proj


def try_compile_batch_pred(expr: ColumnExpression, layout) -> Callable | None:
    """Vectorized filter predicate: (keys, rows, cache) -> bool ndarray
    mask | None."""
    try:
        vf = compile_vec(expr, layout)
    except NotVectorized:
        return None

    def batch_pred(keys: list, rows: list[tuple], cache: dict | None = None):
        cols = Cols(rows, cache)
        try:
            mask = _as_array(vf(cols), cols.n)
        except NotVectorized:
            return None
        except Exception:
            return None
        if mask.dtype.kind != "b":
            return None  # per-row applies `keep is True` to raw values
        return mask

    return batch_pred
