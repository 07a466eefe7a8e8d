"""pw.io.csv: the port's copy of the reference's ``io/csv.py`` (upstream
Pathway's python/pathway/io/csv)."""

from __future__ import annotations

from ..internals.schema import Schema
from ..internals.table import Table
from . import fs as _fs


def read(
    path: str,
    *,
    schema: type[Schema] | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "csv",
    **kwargs,
) -> Table:
    """Read CSV files under ``path`` into a table (reference io/csv
    read :25).

    The first line of each file is the header; columns map to the
    schema by name and values are coerced to the declared types.

    Args:
        path: a file, or a directory scanned recursively.
        schema: column names/types. When omitted, the schema is
            INFERRED by probing the first file's initial rows (types
            from pandas dtypes) — convenient for exploration, explicit
            schemas for production.
        mode: ``"streaming"`` watches for file additions, modifications
            and deletions (rows of a deleted file are retracted);
            ``"static"`` reads a snapshot and closes.
        with_metadata: add a ``_metadata`` JSON column (path, size,
            modification time, ...).
        autocommit_duration_ms: epoch granularity of commits.
        csv_settings: (kwarg) a :class:`pw.io.CsvParserSettings` fixing
            the dialect — delimiter, quote/escape characters, comment
            character. Drives both parsing and schema inference.
        persistent_id: (kwarg) enable checkpoint/recovery for this
            source.
    """
    if schema is None:
        import os

        from ..internals.schema import schema_from_csv

        probe = path
        if not os.path.isfile(probe):
            files = _fs._list_files(path)
            if not files:
                raise ValueError(f"csv.read: no files found at {path!r} to infer schema; pass schema=")
            probe = files[0]
        settings = kwargs.get("csv_settings")
        dialect = (
            {
                "sep": settings.delimiter,
                "quotechar": settings.quote,
                "comment": settings.comment_character,
                "escapechar": settings.escape,
            }
            if settings is not None
            else {}
        )
        schema = schema_from_csv(
            probe, **{k: v for k, v in dialect.items() if v is not None}
        )
    return _fs.read(
        path,
        format="csv",
        schema=schema,
        mode=mode,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )


def write(table: Table, filename: str, **kwargs) -> None:
    """Stream the table's changes to ``filename`` as CSV (reference
    io/csv write :136): header first, then one row per change carrying
    the columns plus ``time``/``diff`` — retractions appear as
    ``diff=-1`` rows, so the file is a replayable changelog."""
    _fs.write(table, filename, format="csv", name="csv.write", **kwargs)
