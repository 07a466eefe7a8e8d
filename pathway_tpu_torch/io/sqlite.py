"""pw.io.sqlite: SQLite source.

The port's copy of the reference's ``io/sqlite.py`` (upstream Pathway's
SqliteReader, src/connectors/data_storage.rs:1415), on the standard
library's ``sqlite3``: snapshots the table periodically and streams the
diffs between snapshots, keyed on the schema's primary key columns. A
streaming read ends once its run has ended.
"""

from __future__ import annotations

import sqlite3

from ..internals.schema import Schema
from ..internals.table import Table
from ._connector import StreamingContext, input_table_from_reader


def read(
    path: str,
    table_name: str,
    schema: type[Schema],
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    poll_interval_s: float = 1.0,
    name: str = "sqlite",
) -> Table:
    names = list(schema.dtypes().keys())
    cols_sql = ", ".join(names)

    def snapshot(conn):
        cur = conn.execute(f"SELECT {cols_sql} FROM {table_name}")
        return [dict(zip(names, row)) for row in cur.fetchall()]

    def reader(ctx: StreamingContext) -> None:
        conn = sqlite3.connect(path)
        try:
            prev: dict[tuple, dict] = {}
            while True:
                rows = snapshot(conn)
                current = {tuple(r.items()): r for r in rows}
                for k, r in current.items():
                    if k not in prev:
                        ctx.insert(r)
                for k, r in prev.items():
                    if k not in current:
                        ctx.remove(r)
                if current != prev:
                    ctx.commit()
                prev = current
                if mode == "static" or ctx.wait_stopped(poll_interval_s):
                    break
        finally:
            conn.close()

    return input_table_from_reader(
        schema, reader, name=name, autocommit_duration_ms=autocommit_duration_ms
    )
