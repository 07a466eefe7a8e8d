"""Column-slice views over tables.

``table.slice`` hands back an ordered view of (a subset of) the table's
columns that can be trimmed (:meth:`TableSlice.without`), relabelled
(:meth:`TableSlice.rename` / ``with_prefix`` / ``with_suffix``), indexed
by name or reference, and re-anchored through ``ix``/``ix_ref``.
Iterating a slice yields its column references, so a slice splats
straight into ``select``/``with_columns`` the way the table itself does.

Parity surface: reference ``python/pathway/internals/table_slice.py``
(TableSlice, :16-153).  The implementation here is this repo's own.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator, Mapping

from .expression import ColumnReference
from .thisclass import ThisMetaclass, this

if TYPE_CHECKING:  # pragma: no cover
    from .table import Table


class TableSlice:
    """An ordered, immutable view of some of a table's columns.

    >>> import pathway_tpu as pw
    >>> trades = pw.debug.table_from_markdown('''
    ... ticker | qty | price
    ... ACME   | 5   | 98.2
    ... INIT   | 2   | 11.5
    ... ''')
    >>> trades.slice.without("qty").with_prefix("t_")
    TableSlice({'t_ticker': <table>.ticker, 't_price': <table>.price})
    """

    __slots__ = ("_columns", "_source")

    def __init__(self, mapping: Mapping[str, ColumnReference], table: "Table"):
        self._columns: dict[str, ColumnReference] = dict(mapping)
        self._source = table

    def _derive(self, columns: Mapping[str, ColumnReference]) -> "TableSlice":
        return TableSlice(columns, self._source)

    # -- mapping-ish surface -------------------------------------------------

    def keys(self):
        return self._columns.keys()

    def __iter__(self) -> Iterator[ColumnReference]:
        return iter(self._columns.values())

    def __repr__(self) -> str:
        body = ", ".join(f"{k!r}: <table>.{v._name}" for k, v in self._columns.items())
        return "TableSlice({" + body + "})"

    def __getitem__(self, arg):
        if isinstance(arg, (ColumnReference, str)):
            return self._columns[self._resolve(arg)]
        # any other iterable selects a sub-slice
        return self._derive({self._resolve(k): self[k] for k in arg})

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        from .table import Table

        if name != "id" and hasattr(Table, name):
            raise ValueError(
                f"{name!r} is a Table method name and attribute access on a slice"
                f" would shadow it; fetch the column with [{name!r}] instead."
            )
        try:
            return self._columns[name]
        except KeyError:
            raise AttributeError(
                f"column {name!r} not found; this slice holds {list(self.keys())}"
            ) from None

    # -- column manipulation -------------------------------------------------

    def without(self, *cols) -> "TableSlice":
        dropped = {self._resolve(c) for c in cols}
        for name in dropped:
            if name not in self._columns:
                raise KeyError(f"cannot drop {name!r}: not a column of this slice")
        return self._derive(
            {k: v for k, v in self._columns.items() if k not in dropped}
        )

    def rename(self, rename_dict: Mapping) -> "TableSlice":
        relabel = {
            self._resolve(old): self._resolve(new) for old, new in rename_dict.items()
        }
        missing = [old for old in relabel if old not in self._columns]
        if missing:
            raise KeyError(f"cannot rename {missing[0]!r}: not a column of this slice")
        # renamed columns move to the end, in rename_dict order
        kept = {k: v for k, v in self._columns.items() if k not in relabel}
        kept.update((new, self._columns[old]) for old, new in relabel.items())
        return self._derive(kept)

    def _relabelled(self, transform) -> "TableSlice":
        return self.rename({name: transform(name) for name in self._columns})

    def with_prefix(self, prefix: str) -> "TableSlice":
        return self._relabelled(lambda n: prefix + n)

    def with_suffix(self, suffix: str) -> "TableSlice":
        return self._relabelled(lambda n: n + suffix)

    # -- re-anchoring --------------------------------------------------------

    def _reanchored(self, routed) -> "TableSlice":
        return self._derive(
            {name: routed[ref._name] for name, ref in self._columns.items()}
        )

    def ix(self, expression, *, optional: bool = False, context=None) -> "TableSlice":
        return self._reanchored(
            self._source.ix(expression, optional=optional, context=context)
        )

    def ix_ref(self, *args, optional: bool = False, context=None) -> "TableSlice":
        return self._reanchored(
            self._source.ix_ref(*args, optional=optional, context=context)
        )

    @property
    def slice(self) -> "TableSlice":
        return self

    # -- helpers -------------------------------------------------------------

    def _resolve(self, arg) -> str:
        """Turn a column designator (string, ``pw.this.x``, or a reference
        into the source table) into a plain column name."""
        if isinstance(arg, str):
            return arg
        if not isinstance(arg, ColumnReference):
            raise TypeError(f"cannot use {arg!r} to address a slice column")
        owner = arg._table
        if isinstance(owner, ThisMetaclass):
            if owner is not this:
                raise ValueError(
                    f"only this.{arg._name} (or a plain string) works as a column"
                    " reference here; left/right do not address a slice."
                )
        elif owner is not self._source:
            raise ValueError(
                "a TableSlice only accepts references into the table of which"
                " the slice was created."
            )
        return arg._name
