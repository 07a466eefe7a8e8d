"""pw.this / pw.left / pw.right sentinels.

Rebuild of upstream Pathway's python/pathway/internals/thisclass.py. These
resolve to concrete tables during desugaring (desugaring.py)."""

from __future__ import annotations

from .expression import ColumnReference


_EXPR_INTERNALS = frozenset(
    {
        "_name", "_table", "_dtype", "_idx", "_args", "_kwargs", "_expr",
        "_val", "_left", "_right", "_fn", "_repr_inner", "_id", "_op",
        "_columns", "_universe", "_keys_expr", "_ix_table", "_optional",
    }
)


class ThisMetaclass(type):
    def __getattr__(cls, name: str) -> ColumnReference:
        # ColumnExpression-internal attribute probes (e.g. repr reading
        # `_name`, compilers reading `_table`) must NOT produce column
        # references — intercepting them turns error formatting into
        # infinite recursion. Real underscore COLUMNS (_metadata,
        # _pw_window_start, …) stay addressable.
        if name.startswith("__") or name in _EXPR_INTERNALS:
            raise AttributeError(name)
        return ColumnReference(cls, name)

    def __iter__(cls):
        # `*pw.this` has no column list until desugaring; without this
        # guard, star-unpacking falls back to __getitem__ with growing
        # integer indexes and spins forever
        raise TypeError(
            "pw.this cannot be unpacked: list the columns explicitly "
            "(e.g. t.groupby(*[t[c] for c in t.column_names()]))"
        )

    def __getitem__(cls, name):
        if isinstance(name, (list, tuple)):
            return [ColumnReference(cls, n if isinstance(n, str) else n._name) for n in name]
        if isinstance(name, ColumnReference):
            return ColumnReference(cls, name._name)
        return ColumnReference(cls, name)

    @property
    def id(cls) -> ColumnReference:
        return ColumnReference(cls, "id")

    def ix(cls, expression, *, optional: bool = False, context=None):
        from .table import _DeferredIx

        return _DeferredIx(cls, expression, optional)

    def ix_ref(cls, *args, optional: bool = False, instance=None):
        from .table import _DeferredIxRef

        return _DeferredIxRef(cls, args, optional, instance)

    def without(cls, *columns):
        return _this_without(cls, columns)

    def __repr__(cls):
        return f"<{cls.__name__}>"


class this(metaclass=ThisMetaclass):
    """The context table: `t.select(y=pw.this.x)`."""


class left(metaclass=ThisMetaclass):
    """Left side of a join in `.select()` after `.join()`."""


class right(metaclass=ThisMetaclass):
    """Right side of a join."""


class _WithoutSpec:
    def __init__(self, base, columns):
        self.base = base
        self.columns = [c._name if isinstance(c, ColumnReference) else c for c in columns]


def _this_without(cls, columns):
    return _WithoutSpec(cls, columns)
