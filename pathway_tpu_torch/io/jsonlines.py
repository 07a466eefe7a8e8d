"""pw.io.jsonlines: the port's copy of the reference's ``io/jsonlines.py``
(upstream Pathway's python/pathway/io/jsonlines)."""

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
    name: str = "jsonlines",
    **kwargs,
) -> Table:
    """Read a file or directory of `JSON Lines <https://jsonlines.org>`_
    files into a table (reference io/jsonlines read :22).

    Each line is one JSON object; top-level fields map to schema columns
    by name. Missing fields take the column's ``default_value`` when one
    is declared, otherwise the row is routed to the error log.

    Args:
        path: a file, or a directory scanned recursively.
        schema: required — column names and types of the payload.
        mode: ``"streaming"`` keeps watching for new/changed/deleted
            files and emits upserts/retractions; ``"static"`` reads a
            snapshot and closes the source.
        with_metadata: add a ``_metadata`` JSON column (path, size,
            mtime, seen_at, owner) per row.
        autocommit_duration_ms: epoch granularity — how often buffered
            rows are committed to the engine as one atomic batch.
        persistent_id: (kwarg) names the source; checkpoint/recovery
            comes with ROADMAP Queue A item 6.

    Schemas declared ``append_only=True`` skip upsert bookkeeping
    engine-side; a typical pattern::

        class Event(pw.Schema, append_only=True):
            user: str
            amount: int

        events = pw.io.jsonlines.read("./logs", schema=Event)
    """
    if schema is None:
        raise ValueError("jsonlines.read requires schema=")
    return _fs.read(
        path,
        format="jsonlines",
        schema=schema,
        mode=mode,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )


def write(table: Table, filename: str, **kwargs) -> None:
    """Stream the table's changes to ``filename`` as JSON Lines
    (reference io/jsonlines write :105): one object per change with the
    row's columns plus ``time`` (epoch) and ``diff`` (+1 insert / -1
    retraction), flushed at every epoch close — the on-disk file is a
    faithful changelog, not just a final state."""
    _fs.write(table, filename, format="jsonlines", name="jsonlines.write", **kwargs)
