"""pw.io.null: the port's copy of the reference's ``io/null.py`` (upstream
Pathway's NullWriter, data_storage.rs:1395)."""

from __future__ import annotations

from ..internals.table import Table
from ._connector import add_output_sink


def write(table: Table, **kwargs) -> None:
    add_output_sink(table, lambda *a: None, name="null.write")
