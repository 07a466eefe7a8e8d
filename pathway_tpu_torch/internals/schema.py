"""Schema system: typed table descriptions.

Rebuild of upstream Pathway's python/pathway/internals/schema.py (Schema
metaclass :~100+, column_definition, schema_from_types/pandas/dict)."""

from __future__ import annotations

import re

import typing
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

import numpy as np

from . import dtype as dt


@dataclass
class ColumnDefinition:
    dtype: dt.DType = dt.ANY
    primary_key: bool = False
    default_value: Any = ...
    name: str | None = None
    append_only: bool | None = None
    description: str | None = None
    example: Any = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not ...


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = ...,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
    description: str | None = None,
    example: Any = None,
) -> Any:
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=default_value,
        name=name,
        append_only=append_only,
        description=description,
        example=example,
    )


class SchemaProperties:
    def __init__(self, append_only: bool = False):
        self.append_only = append_only


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]
    __properties__: SchemaProperties

    def __new__(mcs, name, bases, namespace, append_only: bool = False, **kwargs):
        cls = super().__new__(mcs, name, bases, namespace)
        columns: dict[str, ColumnDefinition] = {}
        for base in reversed(bases):
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        annotations = namespace.get("__annotations__", {})
        hints: dict[str, Any] = {}
        for cname, ann in annotations.items():
            if cname.startswith("__"):
                continue
            hints[cname] = ann
        for cname, ann in hints.items():
            try:
                dtype = dt.wrap(ann) if not isinstance(ann, str) else _dtype_from_str(ann)
            except Exception:
                dtype = dt.ANY
            definition = namespace.get(cname)
            if isinstance(definition, ColumnDefinition):
                definition.dtype = dtype if definition.dtype is dt.ANY else definition.dtype
                out_name = definition.name or cname
                columns[out_name] = definition
            else:
                columns[cname] = ColumnDefinition(dtype=dtype)
        # columns declared only via column_definition without annotation
        for cname, val in namespace.items():
            if isinstance(val, ColumnDefinition) and (val.name or cname) not in columns:
                columns[val.name or cname] = val
        cls.__columns__ = columns
        cls.__properties__ = SchemaProperties(append_only=append_only)
        return cls

    def columns(cls) -> dict[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def keys(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.to_python_type() for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def primary_key_columns(cls) -> list[str] | None:
        pks = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pks or None

    def default_values(cls) -> dict[str, Any]:
        return {
            n: c.default_value for n, c in cls.__columns__.items() if c.has_default_value
        }

    def __getitem__(cls, name: str) -> ColumnDefinition:
        return cls.__columns__[name]

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        cols.update(other.__columns__)
        return schema_builder(cols, name=f"{cls.__name__}|{other.__name__}")

    def with_types(cls, **kwargs) -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        for n, t in kwargs.items():
            if n not in cols:
                raise ValueError(f"Schema has no column {n!r}")
            old = cols[n]
            cols[n] = ColumnDefinition(
                dtype=dt.wrap(t),
                primary_key=old.primary_key,
                default_value=old.default_value,
                name=old.name,
            )
        return schema_builder(cols, name=cls.__name__)

    def without(cls, *names) -> "SchemaMetaclass":
        names = {getattr(n, "_name", n) for n in names}
        cols = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_builder(cols, name=cls.__name__)

    def update_properties(cls, **kwargs) -> "SchemaMetaclass":
        out = schema_builder(dict(cls.__columns__), name=cls.__name__)
        for k, v in kwargs.items():
            setattr(out.__properties__, k, v)
        return out

    def universe_properties(cls):
        return cls.__properties__

    def as_dict(cls) -> dict[str, dt.DType]:
        return cls.dtypes()

    def __repr__(cls):
        cols = ", ".join(f"{n}: {c.dtype}" for n, c in cls.__columns__.items())
        return f"<Schema {cls.__name__}({cols})>"


def _dtype_from_str(ann: str) -> dt.DType:
    simple = {
        "int": dt.INT,
        "float": dt.FLOAT,
        "str": dt.STR,
        "bool": dt.BOOL,
        "bytes": dt.BYTES,
        "Any": dt.ANY,
        "any": dt.ANY,
    }
    ann = ann.strip()
    # PEP 604 / typing.Optional in string annotations (from __future__
    # import annotations): "int | None", "Optional[int]"
    if "|" in ann:
        parts = [p.strip() for p in ann.split("|")]
        non_none = [p for p in parts if p != "None"]
        if len(non_none) == 1 and len(parts) == 2 and non_none[0] in simple:
            return dt.Optional(simple[non_none[0]])
        return dt.ANY
    m = re.fullmatch(r"(?:typing\.)?Optional\[(\w+)\]", ann)
    if m and m.group(1) in simple:
        return dt.Optional(simple[m.group(1)])
    # Pointer annotations in any spelling ("Pointer", "pw.Pointer",
    # "_dt.Pointer", "Pointer[Any]") — postponed evaluation turns them
    # into strings before the metaclass sees them
    if re.fullmatch(r"(?:[\w.]+\.)?Pointer(?:\[.*\])?", ann):
        return dt.POINTER
    return simple.get(ann, dt.ANY)


def schema_is_append_only(schema: "SchemaMetaclass") -> bool:
    """One predicate for both halves of the append-only contract: the
    connector wire protocol (plain inserts instead of upserts) and the
    engine's no-retraction fast path key off the SAME answer, so a
    schema can never emit upserts into a node that refuses them.
    Declared via ``class S(pw.Schema, append_only=True)`` or by marking
    every column ``column_definition(append_only=True)``."""
    if bool(schema.__properties__.append_only):
        return True
    defs = schema.columns()
    return bool(defs) and all(d.append_only is True for d in defs.values())


class Schema(metaclass=SchemaMetaclass):
    """Base schema class. Subclass with annotations:

        class InputSchema(pw.Schema):
            name: str
            age: int = pw.column_definition(primary_key=True)
    """


def schema_builder(
    columns: Mapping[str, ColumnDefinition],
    *,
    name: str | None = None,
    properties: SchemaProperties | None = None,
) -> type[Schema]:
    cls = SchemaMetaclass(
        name or "CustomSchema",
        (Schema,),
        {"__annotations__": {}, **dict(columns)},
    )
    cols: dict[str, ColumnDefinition] = {}
    for n, c in columns.items():
        if not isinstance(c, ColumnDefinition):
            c = ColumnDefinition(dtype=dt.wrap(c))
        cols[n] = c
    cls.__columns__ = cols
    if properties is not None:
        cls.__properties__ = properties
    return cls


def schema_from_types(_name: str | None = None, **kwargs) -> type[Schema]:
    return schema_builder(
        {n: ColumnDefinition(dtype=dt.wrap(t)) for n, t in kwargs.items()},
        name=_name or "schema_from_types",
    )


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str | None = None
) -> type[Schema]:
    cols = {}
    for n, spec in columns.items():
        if isinstance(spec, dict):
            cols[n] = ColumnDefinition(
                dtype=dt.wrap(spec.get("dtype", dt.ANY)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", ...),
            )
        else:
            cols[n] = ColumnDefinition(dtype=dt.wrap(spec))
    return schema_builder(cols, name=name)


def schema_from_pandas(
    df, *, id_from: list[str] | None = None, name: str | None = None
) -> type[Schema]:
    import pandas as pd

    kind_map = {"i": dt.INT, "f": dt.FLOAT, "b": dt.BOOL, "O": dt.ANY, "u": dt.INT, "M": dt.DATE_TIME_NAIVE}
    cols = {}
    for cname in df.columns:
        kind = df[cname].dtype.kind
        dtype = kind_map.get(kind, dt.ANY)
        if kind == "O" and len(df) and all(isinstance(v, str) for v in df[cname]):
            dtype = dt.STR
        cols[str(cname)] = ColumnDefinition(
            dtype=dtype, primary_key=bool(id_from and cname in id_from)
        )
    return schema_builder(cols, name=name or "schema_from_pandas")


def schema_from_csv(path: str, *, name: str | None = None, **kwargs) -> type[Schema]:
    import pandas as pd

    df = pd.read_csv(
        path,
        nrows=100,
        **{k: v for k, v in kwargs.items() if k in ("sep", "quotechar", "comment", "escapechar")},
    )
    return schema_from_pandas(df, name=name or "schema_from_csv")
