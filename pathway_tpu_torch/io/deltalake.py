"""pw.io.deltalake — Delta Lake source and sink.

The port's copy of the reference's ``io/deltalake.py`` (upstream
Pathway's src/connectors/data_storage.rs DeltaTableReader :1924,
DeltaTableWriter :1621; python/pathway/io/deltalake/__init__.py read :38,
write :170): reads poll the table's version and stream row
additions (keyed by row content per version); writes append each change
batch with time/diff columns. The table handles are injectable
(``_table`` — an object with version()/to_pylist();
``_writer`` — a callable(rows_list)) so the loops unit-test without
the `deltalake` package. A streaming read ends with its run (or after
one poll under ``PATHWAY_TPU_FS_ONESHOT``).
"""

from __future__ import annotations

import os
from typing import Any, Callable

from ..internals.schema import Schema
from ..internals.table import Table
from ._connector import StreamingContext, add_output_sink, input_table_from_reader
from ._formats import jsonable_value


class _DeltaTableHandle:
    """Adapter over deltalake.DeltaTable."""

    def __init__(self, uri: str, storage_options: dict | None):
        try:
            from deltalake import DeltaTable  # type: ignore
        except ImportError as e:
            raise ImportError(
                "pw.io.deltalake requires the 'deltalake' package"
            ) from e
        self._dt = DeltaTable(uri, storage_options=storage_options or None)

    def version(self) -> int:
        self._dt.update_incremental()
        return self._dt.version()

    def to_pylist(self) -> list[dict]:
        return self._dt.to_pyarrow_table().to_pylist()


def read(
    uri: str,
    *,
    schema: type[Schema],
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    s3_connection_settings: Any = None,
    storage_options: dict | None = None,
    name: str = "deltalake",
    persistent_id: str | None = None,
    _table: Any = None,
    poll_interval_s: float = 1.0,
    **kwargs,
) -> Table:
    """Stream a Delta table: each observed version upserts the full row
    set (rows keyed by content hash), so deletions/updates between
    versions retract correctly — the polling equivalent of the
    reference's change-data reads."""
    names = schema.column_names()

    def get_table():
        return _table if _table is not None else _DeltaTableHandle(uri, storage_options)

    def snapshot_rows(handle) -> dict[tuple, dict]:
        out: dict[tuple, dict] = {}
        for i, rec in enumerate(handle.to_pylist()):
            row = {n: rec.get(n) for n in names}
            key = tuple(jsonable_value(row[n]) for n in names)
            # repeated identical rows get distinct keys (multiset)
            k = (key, 0)
            while k in out:
                k = (key, k[1] + 1)
            out[k] = row
        return out

    def reader(ctx: StreamingContext) -> None:
        handle = get_table()
        last_version: int | None = None
        known: dict[tuple, dict] = {}
        while True:
            v = handle.version()
            if last_version is None or v != last_version:
                current = snapshot_rows(handle)
                for k, row in current.items():
                    if k not in known:
                        ctx.upsert_keyed(("delta", *map(str, k)), row)
                for k in list(known):
                    if k not in current:
                        ctx.upsert_keyed(("delta", *map(str, k)), None)
                known = current
                last_version = v
                ctx.commit()
            if mode == "static" or os.environ.get("PATHWAY_TPU_FS_ONESHOT") or ctx.wait_stopped(poll_interval_s):
                return

    return input_table_from_reader(
        schema,
        reader,
        name=f"{name}:{uri}",
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
    )


def write(
    table: Table,
    uri: str,
    *,
    storage_options: dict | None = None,
    min_commit_frequency: int | None = 60_000,
    _writer: Callable | None = None,
    **kwargs,
) -> None:
    """Append the change stream (rows + time/diff columns) to a Delta
    table, batched per epoch."""
    import time as _wall

    names = table.column_names()
    state: dict = {"batch": [], "last_flush": _wall.monotonic()}

    def default_writer(rows: list[dict]) -> None:
        try:
            import pyarrow as pa  # type: ignore
            from deltalake import write_deltalake  # type: ignore
        except ImportError as e:
            raise ImportError(
                "pw.io.deltalake requires the 'deltalake' and 'pyarrow' packages"
            ) from e
        write_deltalake(
            uri,
            pa.Table.from_pylist(rows),
            mode="append",
            storage_options=storage_options or None,
        )

    writer = _writer or default_writer

    def on_change(key, row, time, diff):
        rec = {n: jsonable_value(row[n]) for n in names}
        rec["time"] = int(time)
        rec["diff"] = int(diff)
        state["batch"].append(rec)

    def on_time_end(time):
        # batch across epochs until min_commit_frequency elapses (small
        # Delta commits are expensive); time=None forces the final flush
        if not state["batch"]:
            return
        if time is not None and min_commit_frequency is not None:
            if (_wall.monotonic() - state["last_flush"]) * 1000.0 < min_commit_frequency:
                return
        writer(state["batch"])
        state["batch"] = []
        state["last_flush"] = _wall.monotonic()

    def build(runner, t):
        out = runner.subscribe(
            t, on_change=on_change, on_time_end=on_time_end, on_end=lambda: on_time_end(None)
        )
        return out

    from ..internals.parse_graph import G

    G.add_output(table, {"build": build, "name": "deltalake.write"})
