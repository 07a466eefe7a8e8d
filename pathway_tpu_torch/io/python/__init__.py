"""Custom python connectors (pw.io.python).

Rebuild of upstream Pathway's python/pathway/io/python/__init__.py
(ConnectorSubject :49; engine side PythonReader data_storage.rs:843)."""

from __future__ import annotations

import json
import threading
import time
from typing import Any

from ...internals.schema import Schema
from ...internals.table import Table
from .._connector import StreamingContext, input_table_from_reader


class ConnectorSubject:
    """Subclass and implement run(); call next()/next_json()/next_str()/
    next_bytes() to emit rows, commit() to flush an epoch.

    Set ``supports_offsets = True`` (class attribute) when run() honors
    ``self.offsets`` to resume from reader bookmarks — then recovery
    replays the persisted log and the subject resumes where it left
    off (exactly-once across restarts). Subjects that do NOT opt in
    get record-reset semantics: on recovery the stale log is discarded
    and the subject re-produces its input from scratch — no duplicates,
    but sinks see the re-produced rows again (replay without re-running
    only exists under speedrun mode, PATHWAY_REPLAY_MODE)."""

    _ctx: StreamingContext | None
    #: opt-in: the subject reads self.offsets and resumes — safe to re-run
    #: run() after recovery without duplicating rows
    supports_offsets: bool = False

    def __init__(self, datasource_name: str = "python"):
        self._ctx = None
        self._name = datasource_name

    # --- user API ---

    def next(self, **kwargs) -> None:
        assert self._ctx is not None
        self._ctx.insert(kwargs)

    def next_with_offset(self, offset_key, offset_value, **kwargs) -> None:
        """Emit a row and advance a reader bookmark in one atomic step —
        use this (not next() + set_offset()) when resuming from offsets,
        so a concurrent commit can never persist the row without its
        bookmark or vice versa."""
        assert self._ctx is not None
        self._ctx.insert(kwargs, offsets={offset_key: offset_value})

    def next_batch(self, **columns) -> None:
        """Columnar bulk emit (an addition over the reference): every kwarg is a
        list, one entry per row — thousands of rows append under a
        single lock acquisition instead of per-row next() calls."""
        assert self._ctx is not None
        self._ctx.insert_batch(columns)

    def next_json(self, message: dict | str) -> None:
        if isinstance(message, str):
            message = json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, key, values: dict) -> None:
        assert self._ctx is not None
        self._ctx.remove(values)

    def remove(self, **kwargs) -> None:
        assert self._ctx is not None
        self._ctx.remove(kwargs)

    def commit(self) -> None:
        assert self._ctx is not None
        self._ctx.commit()

    @property
    def offsets(self) -> dict:
        """Recovered reader bookmarks (persistence); empty on fresh runs."""
        assert self._ctx is not None
        return self._ctx.offsets

    def set_offset(self, key, value) -> None:
        assert self._ctx is not None
        self._ctx.set_offset(key, value)

    def close(self) -> None:
        pass

    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    @property
    def _with_metadata(self) -> bool:
        return False


def read(
    subject: ConnectorSubject,
    *,
    schema: type[Schema],
    autocommit_duration_ms: int | None = 1500,
    name: str = "python",
    persistent_id: str | None = None,
    supports_offsets: bool | None = None,
    **kwargs,
) -> Table:
    """Read from a custom ConnectorSubject.

    MIGRATION (round 2): subjects used to be treated as offset-aware by
    default; now a subject must opt in (``supports_offsets = True``
    class attribute, or the explicit keyword here) before recovery will
    replay its persisted log. Offset-unaware subjects get record-mode
    reset semantics instead — the log restarts rather than doubling the
    re-produced input. Subjects that resume via ``self.offsets`` MUST
    set the flag or recovery re-reads from scratch."""
    def reader(ctx: StreamingContext) -> None:
        subject._ctx = ctx
        stop = threading.Event()
        committer = None
        if autocommit_duration_ms:
            def autocommit():
                while not stop.is_set():
                    time.sleep(autocommit_duration_ms / 1000.0)
                    ctx.commit()

            committer = threading.Thread(target=autocommit, daemon=True)
            committer.start()
        try:
            subject.run()
        finally:
            stop.set()
            subject.on_stop()
            ctx.commit()

    if supports_offsets is None:
        supports_offsets = bool(getattr(subject, "supports_offsets", False))
    return input_table_from_reader(
        schema,
        reader,
        name=name,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        supports_offsets=supports_offsets,
    )


def write(table: Table, observer: Any) -> None:
    """pw.io.python.write: route changes to a ConnectorObserver."""
    from .._connector import add_output_sink

    def on_change(key, row, time_, diff):
        observer.on_change(key=key, row=row, time=time_, is_addition=diff > 0)

    def on_end():
        if hasattr(observer, "on_end"):
            observer.on_end()

    add_output_sink(table, on_change, on_end=on_end, name="python.write")


class ConnectorObserver:
    """Base class for pw.io.python.write observers."""

    def on_change(self, key, row: dict, time: int, is_addition: bool) -> None:
        raise NotImplementedError

    def on_time_end(self, time: int) -> None:
        pass

    def on_end(self) -> None:
        pass
