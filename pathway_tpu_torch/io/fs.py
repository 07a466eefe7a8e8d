"""Filesystem connector (pw.io.fs).

The port's copy of the reference's ``io/fs.py`` (upstream Pathway's
python/pathway/io/fs and the engine-side posix scanner,
src/connectors/posix_like.rs:279, scanner/filesystem.rs). Formats:
plaintext, plaintext_by_file, csv, json/jsonlines, binary; modes: static
(read once) and streaming (directory watching with additions,
modifications and deletions). A streaming scan returns when the engine's
run ends.
"""

from __future__ import annotations

import csv as _csv
import fnmatch
import glob as _glob
import json
import os
import time
from typing import Any

from ..engine.value import Json
from ..internals import dtype as dt
from ..internals.schema import ColumnDefinition, Schema, schema_builder
from ..internals.table import Table
from ._connector import StreamingContext, input_table_from_reader, static_table_from_rows
from ._formats import csv_reader_source

_POLL_INTERVAL_S = 0.2


def _plaintext_schema(with_metadata: bool) -> type[Schema]:
    cols: dict[str, Any] = {"data": ColumnDefinition(dtype=dt.STR)}
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    return schema_builder(cols, name="PlaintextSchema")


def _binary_schema(with_metadata: bool) -> type[Schema]:
    cols: dict[str, Any] = {"data": ColumnDefinition(dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    return schema_builder(cols, name="BinarySchema")


def _list_files(path: str, object_pattern: str = "*") -> list[str]:
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in files if fnmatch.fnmatch(f, object_pattern))
        return sorted(out)
    return sorted(_glob.glob(path))


def _metadata(fpath: str) -> Json:
    try:
        st = os.stat(fpath)
        return Json(
            {
                "path": os.path.abspath(fpath),
                "size": st.st_size,
                "modified_at": int(st.st_mtime),
                "created_at": int(st.st_ctime),
                "seen_at": int(time.time()),
                "owner": str(st.st_uid),
            }
        )
    except OSError:
        return Json({"path": fpath})


def _with_meta(row: dict, fpath: str, with_metadata: bool) -> dict:
    if with_metadata:
        row["_metadata"] = _metadata(fpath)
    return row


def _rows_for_file(fpath: str, format: str, with_metadata: bool, **kwargs):
    """Yield dict rows for one file."""
    if format == "plaintext_by_file":
        with open(fpath, "r", errors="replace") as f:
            yield _with_meta({"data": f.read().rstrip("\n")}, fpath, with_metadata)
    elif format == "plaintext":
        with open(fpath, "r", errors="replace") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield _with_meta({"data": line}, fpath, with_metadata)
    elif format == "binary":
        with open(fpath, "rb") as f:
            yield _with_meta({"data": f.read()}, fpath, with_metadata)
    elif format == "csv":
        with open(fpath, "r", newline="", errors="replace") as f:
            src, dialect = csv_reader_source(f, kwargs.get("csv_settings"), kwargs)
            for rec in _csv.DictReader(src, **dialect):
                # strict field count (the reference's DsvParser errors on
                # mismatched rows): DictReader marks short rows with None
                # values and long rows under the None restkey
                if rec.get(None) is not None or any(v is None for v in rec.values()):
                    raise ValueError(f"csv row field count mismatch in {fpath!r}: {rec}")
                yield _with_meta(dict(rec), fpath, with_metadata)
    elif format in ("json", "jsonlines"):
        with open(fpath, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield _with_meta(dict(json.loads(line)), fpath, with_metadata)
    else:
        raise ValueError(f"unsupported format {format!r}")


def read(
    path: str,
    *,
    format: str = "plaintext",
    schema: type[Schema] | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    object_pattern: str = "*",
    autocommit_duration_ms: int | None = 1500,
    name: str = "fs",
    persistent_id: str | None = None,
    retry_policy: Any = None,
    **kwargs,
) -> Table:
    """Read files under ``path`` into a table (the reference's
    ``pw.io.fs.read``). ``mode="static"`` reads a snapshot;
    ``"streaming"`` polls the directory, upserting rows keyed
    ``(path, index)`` and retracting the rows of modified and deleted
    files, one commit per scan that found a change. ``retry_policy``
    comes with ROADMAP Queue A item 6 and raises."""
    if retry_policy is not None:
        raise NotImplementedError("fs.read(retry_policy=...) needs ROADMAP Queue A item 6 (persistence and recovery)")
    if schema is None:
        schema = _binary_schema(with_metadata) if format == "binary" else _plaintext_schema(with_metadata)
    elif with_metadata and "_metadata" not in schema.column_names():
        cols = dict(schema.columns())
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
        schema = schema_builder(cols, name=schema.__name__)

    if mode == "static":
        if not os.path.exists(path) and not _list_files(path, object_pattern):
            # a static read of a nonexistent path is a configuration error,
            # not an empty table; streaming mode may await its creation
            raise FileNotFoundError(f"fs.read: path does not exist: {path!r}")
        rows: list[dict] = []
        for fpath in _list_files(path, object_pattern):
            rows.extend(_rows_for_file(fpath, format, with_metadata, **kwargs))
        return static_table_from_rows(schema, rows, name=f"fs:{path}")

    # streaming: rows are keyed (path, index), so changes are plain upserts
    # and the scanner's bookmark is {path: (mtime, n_rows)}, kept as the
    # connector's offsets
    def reader(ctx: StreamingContext) -> None:
        known: dict[str, tuple[float, int]] = {
            p: tuple(v) for p, v in ctx.offsets.items() if isinstance(p, str) and p != "__seq__"
        }
        while True:
            current = _list_files(path, object_pattern)
            changed = False
            for fpath in current:
                try:
                    mtime = os.stat(fpath).st_mtime
                except OSError:
                    continue
                old = known.get(fpath)
                if old is not None and old[0] == mtime:
                    continue
                old_n = old[1] if old is not None else 0
                rows = list(_rows_for_file(fpath, format, with_metadata, **kwargs))
                for i, row in enumerate(rows):
                    ctx.upsert_keyed((fpath, i), row)
                for i in range(len(rows), old_n):
                    ctx.upsert_keyed((fpath, i), None)
                known[fpath] = (mtime, len(rows))
                ctx.set_offset(fpath, known[fpath])
                changed = True
            present = set(current)
            for fpath in [p for p in known if p not in present]:
                _mtime, old_n = known.pop(fpath)
                for i in range(old_n):
                    ctx.upsert_keyed((fpath, i), None)
                ctx.set_offset(fpath, None)
                changed = True
            if changed:
                ctx.commit()
            if os.environ.get("PATHWAY_TPU_FS_ONESHOT") or ctx.wait_stopped(_POLL_INTERVAL_S):
                return

    return input_table_from_reader(
        schema,
        reader,
        name=f"fs:{path}",
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        supports_offsets=True,  # the scanner resumes from {path: (mtime, n)}
    )


def write(table: Table, filename: str, *, format: str = "csv", name: str = "fs.write", **kwargs) -> None:
    """Write table changes to a file: csv with time/diff columns (the
    reference's FileWriter, data_storage.rs:649) or JSON lines."""
    from ._connector import add_output_sink

    names = table.column_names()
    if format not in ("csv", "json", "jsonlines"):
        raise ValueError(f"unsupported format {format!r}")
    state: dict = {}

    def on_build(runner):
        # opened at build time, on the process that delivers changes
        f = open(filename, "w", newline="")
        state["f"] = f
        if format == "csv":
            writer = _csv.writer(f)
            writer.writerow(names + ["time", "diff"])
            state["writer"] = writer

    if format == "csv":

        def on_change(key, row, time_, diff):
            state["writer"].writerow([row[n] for n in names] + [time_, diff])
            state["f"].flush()

    else:

        def on_change(key, row, time_, diff):
            rec = {n: _jsonable(row[n]) for n in names}
            rec["time"] = time_
            rec["diff"] = diff
            state["f"].write(json.dumps(rec) + "\n")
            state["f"].flush()

    def on_end():
        if "f" in state:
            state["f"].close()

    add_output_sink(table, on_change, on_end=on_end, name=name, on_build=on_build)


def _jsonable(v):
    import numpy as np

    if isinstance(v, Json):
        return _jsonable(v.value)
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v
