"""Data type lattice for pathway_tpu tables.

A rebuild of the reference's type system
(upstream Pathway's python/pathway/internals/dtype.py, src/engine/value.rs:507).
Types map onto columnar storage: numeric types live in numpy/JAX arrays
(device-resident for hot paths), everything else in host object columns.
"""

from __future__ import annotations

import datetime
import typing
from abc import ABC, abstractmethod
from typing import Any

import numpy as np


class DType(ABC):
    """Base of all pathway_tpu dtypes."""

    @abstractmethod
    def __repr__(self) -> str: ...

    def __str__(self) -> str:
        return self.__repr__()

    @property
    def np_dtype(self) -> np.dtype:
        """Numpy dtype used for columnar storage of this type."""
        return np.dtype(object)

    @property
    def is_device_friendly(self) -> bool:
        """True if columns of this type can live on TPU as dense arrays."""
        return False

    def is_subclass_of(self, other: "DType") -> bool:
        if other is ANY or self == other:
            return True
        if isinstance(other, Optional):
            if self is NONE:
                return True
            return self.is_subclass_of(other.wrapped)
        if self is INT and other is FLOAT:
            return True
        if isinstance(self, Pointer) and isinstance(other, Pointer):
            return True
        if isinstance(self, Tuple) and isinstance(other, Tuple):
            if other.args is Ellipsis:
                return True
            if self.args is Ellipsis or len(self.args) != len(other.args):
                return False
            return all(a.is_subclass_of(b) for a, b in zip(self.args, other.args))
        if isinstance(self, List) and isinstance(other, List):
            return self.wrapped.is_subclass_of(other.wrapped)
        if isinstance(self, Array) and isinstance(other, Array):
            return True
        if isinstance(self, Callable) and isinstance(other, Callable):
            return True
        return False

    def to_python_type(self) -> Any:
        return object

    def equivalent_to(self, other: "DType") -> bool:
        return self == other


class _SimpleDType(DType):
    _instances: dict[str, "_SimpleDType"] = {}

    def __new__(cls, name: str):
        if name not in cls._instances:
            inst = super().__new__(cls)
            inst._name = name
            cls._instances[name] = inst
        return cls._instances[name]

    def __repr__(self) -> str:
        return self._name

    def __reduce__(self):
        return (_SimpleDType, (self._name,))

    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES.get(self._name, np.dtype(object))

    @property
    def is_device_friendly(self) -> bool:
        return self._name in ("INT", "FLOAT", "BOOL")

    def to_python_type(self) -> Any:
        return _PY_TYPES.get(self._name, object)


_NP_DTYPES = {
    "INT": np.dtype(np.int64),
    "FLOAT": np.dtype(np.float64),
    "BOOL": np.dtype(np.bool_),
    "POINTER": np.dtype(np.uint64),
}

NONE = _SimpleDType("NONE")
BOOL = _SimpleDType("BOOL")
INT = _SimpleDType("INT")
FLOAT = _SimpleDType("FLOAT")
STR = _SimpleDType("STR")
BYTES = _SimpleDType("BYTES")
DATE_TIME_NAIVE = _SimpleDType("DATE_TIME_NAIVE")
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC")
DURATION = _SimpleDType("DURATION")
JSON = _SimpleDType("JSON")
ANY = _SimpleDType("ANY")
ERROR = _SimpleDType("ERROR")
PY_OBJECT_WRAPPER = _SimpleDType("PY_OBJECT_WRAPPER")

_PY_TYPES = {
    "BOOL": bool,
    "INT": int,
    "FLOAT": float,
    "STR": str,
    "BYTES": bytes,
    "NONE": type(None),
}


class Pointer(DType):
    """Reference to a row of a table (128-bit key in the reference
    value.rs:41; 64-bit hashed key here, stored as uint64)."""

    def __init__(self, *args: Any):
        self.args = args  # optional target schema types (informational)

    def __repr__(self) -> str:
        return "POINTER"

    def __eq__(self, other):
        return isinstance(other, Pointer)

    def __hash__(self):
        return hash("POINTER")

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.uint64)

    @property
    def is_device_friendly(self) -> bool:
        return True


POINTER = Pointer()


class Optional(DType):
    def __new__(cls, wrapped: DType):
        wrapped = wrap(wrapped)
        if isinstance(wrapped, Optional) or wrapped in (NONE, ANY):
            return wrapped
        inst = super().__new__(cls)
        inst.wrapped = wrapped
        return inst

    def __repr__(self) -> str:
        return f"Optional({self.wrapped!r})"

    def __eq__(self, other):
        return isinstance(other, Optional) and other.wrapped == self.wrapped

    def __hash__(self):
        return hash(("Optional", self.wrapped))

    @property
    def np_dtype(self) -> np.dtype:
        # Optional numeric columns keep dense storage with NaN/sentinel via
        # a validity mask at the engine level; host storage stays object.
        if self.wrapped is FLOAT:
            return np.dtype(np.float64)
        return np.dtype(object)


class Tuple(DType):
    def __init__(self, *args):
        if len(args) == 1 and args[0] is Ellipsis:
            self.args: Any = Ellipsis
        else:
            self.args = tuple(wrap(a) for a in args)

    def __repr__(self) -> str:
        if self.args is Ellipsis:
            return "Tuple(...)"
        return f"Tuple({', '.join(map(repr, self.args))})"

    def __eq__(self, other):
        return isinstance(other, Tuple) and other.args == self.args

    def __hash__(self):
        return hash(("Tuple", self.args if self.args is Ellipsis else tuple(self.args)))


ANY_TUPLE = Tuple(Ellipsis)


class List(DType):
    def __init__(self, wrapped: DType):
        self.wrapped = wrap(wrapped)

    def __repr__(self) -> str:
        return f"List({self.wrapped!r})"

    def __eq__(self, other):
        return isinstance(other, List) and other.wrapped == self.wrapped

    def __hash__(self):
        return hash(("List", self.wrapped))


class Array(DType):
    """N-dimensional numeric array column (value.rs IntArray/FloatArray).

    On the TPU path these become stacked device arrays when shapes agree
    (the embedding-column fast path)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = FLOAT):
        self.n_dim = n_dim
        self.wrapped = wrap(wrapped) if wrapped is not None else FLOAT

    def __repr__(self) -> str:
        return f"Array({self.n_dim}, {self.wrapped!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Array)
            and other.n_dim == self.n_dim
            and other.wrapped == self.wrapped
        )

    def __hash__(self):
        return hash(("Array", self.n_dim, self.wrapped))

    def strip_dimension(self) -> DType:
        if self.n_dim is None:
            return Array(None, self.wrapped)
        if self.n_dim == 1:
            return self.wrapped
        return Array(self.n_dim - 1, self.wrapped)


class Callable(DType):
    def __init__(self, arg_types=Ellipsis, return_type: DType = ANY):
        self.arg_types = arg_types
        self.return_type = wrap(return_type)

    def __repr__(self) -> str:
        return f"Callable(..., {self.return_type!r})"

    def __eq__(self, other):
        return isinstance(other, Callable) and other.return_type == self.return_type

    def __hash__(self):
        return hash(("Callable", self.return_type))


class Future(DType):
    """Result of an async UDF not yet awaited (reference dtype.py Future)."""

    def __new__(cls, wrapped: DType):
        wrapped = wrap(wrapped)
        if isinstance(wrapped, Future):
            return wrapped
        inst = super().__new__(cls)
        inst.wrapped = wrapped
        return inst

    def __repr__(self) -> str:
        return f"Future({self.wrapped!r})"

    def __eq__(self, other):
        return isinstance(other, Future) and other.wrapped == self.wrapped

    def __hash__(self):
        return hash(("Future", self.wrapped))


def wrap(input_type: Any) -> DType:
    """Convert a python type annotation to a DType."""
    if isinstance(input_type, DType):
        return input_type
    return dtype_from_type(input_type)


ANY_ARRAY = Array(None, ANY)
INT_ARRAY = Array(None, INT)
FLOAT_ARRAY = Array(None, FLOAT)


def dtype_from_type(t: Any) -> DType:
    import json as _json

    if t is None or t is type(None):
        return NONE
    if isinstance(t, DType):
        return t
    if t is bool:
        return BOOL
    if t is int:
        return INT
    if t is float:
        return FLOAT
    if t is str:
        return STR
    if t is bytes:
        return BYTES
    if t is datetime.datetime:
        return DATE_TIME_NAIVE
    if t is datetime.timedelta:
        return DURATION
    if t is np.ndarray:
        return ANY_ARRAY
    if t is Any or t is typing.Any:
        return ANY
    if t is dict or t is list:
        return JSON

    import types as _types

    origin = typing.get_origin(t)
    args = typing.get_args(t)
    if origin is typing.Union or origin is getattr(_types, "UnionType", None):
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == len(args):
            return ANY
        if len(non_none) == 1:
            return Optional(dtype_from_type(non_none[0]))
        return ANY
    if origin is tuple:
        if len(args) == 2 and args[1] is Ellipsis:
            return List(dtype_from_type(args[0]))
        return Tuple(*[dtype_from_type(a) for a in args])
    if origin is list:
        if args:
            return List(dtype_from_type(args[0]))
        return ANY_TUPLE
    if origin is np.ndarray:
        # np.ndarray[dims, np.dtype[x]]
        try:
            dim_arg, dt_arg = args
            n_dim = None
            dt = FLOAT
            dt_args = typing.get_args(dt_arg)
            if dt_args:
                kind = np.dtype(dt_args[0]).kind
                dt = {"i": INT, "f": FLOAT, "b": BOOL}.get(kind, ANY)
            return Array(n_dim, dt)
        except Exception:
            return ANY_ARRAY
    if origin is typing.Callable or origin is getattr(__import__("collections.abc", fromlist=["abc"]), "Callable", None):
        if args:
            return Callable(args[0], dtype_from_type(args[1]))
        return Callable()

    # pathway Json marker classes, Pointer annotations etc.
    name = getattr(t, "__name__", None)
    if name == "Json":
        return JSON
    if name == "Pointer" or (isinstance(t, type) and issubclass_safe(t, _PointerMarker)):
        return POINTER
    if isinstance(t, type):
        return PY_OBJECT_WRAPPER
    return ANY


class _PointerMarker:
    pass


def issubclass_safe(t, base) -> bool:
    try:
        return issubclass(t, base)
    except TypeError:
        return False


def unoptionalize(t: DType) -> DType:
    return t.wrapped if isinstance(t, Optional) else t


def is_concrete(t: DType) -> bool:
    """True when t pins a definite runtime type — no ANY reachable inside.

    Build-time strictness hinges on this: operators over concrete operand
    types must match a typing rule or the pipeline is rejected at
    construction, while anything that can still be ANY (schema-less
    sources, untyped UDF results, unresolved pw.this) stays lenient and
    defers to runtime evaluation."""
    if t is ANY or t is ERROR:
        return False
    if isinstance(t, (Optional, List, Future)):
        return is_concrete(t.wrapped)
    if isinstance(t, Tuple):
        return t.args is not Ellipsis and all(is_concrete(a) for a in t.args)
    if isinstance(t, Array):
        return t.wrapped is not ANY
    if isinstance(t, Callable):
        return False
    return True


def is_optional(t: DType) -> bool:
    return isinstance(t, Optional) or t is NONE or t is ANY


def lub(a: DType, b: DType) -> DType:
    """Least upper bound of two dtypes (type unification for e.g. if_else,
    concat, coalesce)."""
    if a == b:
        return a
    if a is ERROR:
        return b
    if b is ERROR:
        return a
    if a is NONE:
        return Optional(b)
    if b is NONE:
        return Optional(a)
    if isinstance(a, Optional) or isinstance(b, Optional):
        inner = lub(unoptionalize(a), unoptionalize(b))
        return Optional(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if a.is_subclass_of(b):
        return b
    if b.is_subclass_of(a):
        return a
    if isinstance(a, Tuple) and isinstance(b, Tuple):
        if a.args is Ellipsis or b.args is Ellipsis or len(a.args) != len(b.args):
            return ANY_TUPLE
        return Tuple(*[lub(x, y) for x, y in zip(a.args, b.args)])
    return ANY


def types_lca(a: DType, b: DType) -> DType:
    return lub(a, b)


def coerce_value(value: Any, t: DType) -> Any:
    """Coerce a python value to the canonical runtime representation of t."""
    if value is None:
        return None
    t = unoptionalize(t)
    if t is FLOAT and isinstance(value, (int, np.integer)):
        return float(value)
    if t is INT and isinstance(value, np.integer):
        return int(value)
    if t is BOOL and isinstance(value, np.bool_):
        return bool(value)
    return value
