"""pw.io.postgres: PostgreSQL sinks.

The port's copy of the reference's ``io/postgres.py`` (upstream Pathway's
src/connectors/data_storage.rs PsqlWriter :1080 and
python/pathway/io/postgres/__init__.py write :18, write_snapshot :113):
``write`` streams every update as an INSERT with time/diff columns
(PsqlUpdatesFormatter), ``write_snapshot`` maintains a keyed snapshot
with upserts/deletes (PsqlSnapshotFormatter). The client is injectable
(``_connection_factory``) so the full format/write/commit loop is unit
tested with a fake; psycopg2 is only required for real databases.
"""

from __future__ import annotations

from typing import Callable

from ..internals.table import Table
from ._connector import add_output_sink
from ._formats import PsqlSnapshotFormatter, PsqlUpdatesFormatter


def _connection_string_from_settings(settings: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in settings.items())


def _default_connection_factory(settings: dict):
    try:
        import psycopg2  # type: ignore
    except ImportError as e:
        raise ImportError(
            "pw.io.postgres requires the 'psycopg2' package to be installed"
        ) from e
    return psycopg2.connect(_connection_string_from_settings(settings))


class _PsqlSink:
    """Shared machinery: connect lazily at build time, execute formatted
    statements, commit in batches of ``max_batch_size`` (the reference
    PsqlWriter's transaction batching)."""

    def __init__(self, settings, formatter, max_batch_size, connection_factory):
        self.settings = settings
        self.formatter = formatter
        self.max_batch_size = max_batch_size
        self.connection_factory = connection_factory or _default_connection_factory
        self.conn = None
        self.pending = 0

    def on_build(self, runner) -> None:
        self.conn = self.connection_factory(self.settings)

    def on_change(self, key, row: dict, time: int, diff: int) -> None:
        sql, params = self.formatter.format(row, time, diff)
        cur = self.conn.cursor()
        try:
            cur.execute(sql, params)
        finally:
            cur.close()
        self.pending += 1
        # default: one transaction per epoch (see on_time_end);
        # max_batch_size bounds a single transaction within an epoch
        if self.max_batch_size is not None and self.pending >= self.max_batch_size:
            self.conn.commit()
            self.pending = 0

    def on_time_end(self, time: int) -> None:
        if self.pending:
            self.conn.commit()
            self.pending = 0

    def on_end(self) -> None:
        if self.conn is not None:
            try:
                self.conn.commit()
            finally:
                self.conn.close()


def _attach(table: Table, sink: _PsqlSink, name: str) -> None:
    add_output_sink(
        table,
        sink.on_change,
        on_end=sink.on_end,
        name=name,
        on_build=sink.on_build,
        on_time_end=sink.on_time_end,
    )


def write(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    max_batch_size: int | None = None,
    *,
    _connection_factory: Callable | None = None,
) -> None:
    """Write the table's stream of updates into a Postgres table that
    has the value columns plus integer ``time`` and ``diff``."""
    fmt = PsqlUpdatesFormatter(table_name, table.column_names())
    _attach(
        table,
        _PsqlSink(postgres_settings, fmt, max_batch_size, _connection_factory),
        "postgres.write",
    )


def write_snapshot(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    max_batch_size: int | None = None,
    *,
    _connection_factory: Callable | None = None,
) -> None:
    """Maintain a snapshot of the table keyed by ``primary_key``."""
    fmt = PsqlSnapshotFormatter(table_name, primary_key, table.column_names())
    _attach(
        table,
        _PsqlSink(postgres_settings, fmt, max_batch_size, _connection_factory),
        "postgres.write_snapshot",
    )


def read(*args, **kwargs):
    raise NotImplementedError(
        "postgres is a sink in pathway (the reference has no Psql reader); "
        "ingest change streams via pw.io.debezium.read"
    )
