"""pw.debug: markdown fixtures, compute_and_print, pandas bridges.

Rebuild of upstream Pathway's python/pathway/debug/__init__.py (716 LoC):
table_from_markdown with the virtual __time__/__diff__ columns used by the
streaming test harness (see reference stdlib/ml/index.py:145-172 docstring),
compute_and_print, compute_and_print_update_stream, table_to_pandas."""

from __future__ import annotations

import ast
from typing import Any, Iterable

import numpy as np

from ..internals import dtype as dt
from ..internals.graph_runner import GraphRunner
from ..internals.schema import Schema, SchemaMetaclass, schema_from_types
from ..internals.table import Column, LogicalOp, Table
from ..internals.universe import Universe
from ..engine.value import Pointer, ref_scalar

_SPECIAL = ("__time__", "__diff__")


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok in ("", "None"):
        return None
    if tok == "True" or tok == "true":
        return True
    if tok == "False" or tok == "false":
        return False
    try:
        return ast.literal_eval(tok)
    except (ValueError, SyntaxError):
        return tok


def _infer_dtype(values: list[Any]) -> dt.DType:
    non_null = [v for v in values if v is not None]
    if not non_null:
        return dt.ANY
    tset = {type(v) for v in non_null}
    if tset <= {int}:
        return dt.INT if len(non_null) == len(values) else dt.Optional(dt.INT)
    if tset <= {int, float}:
        return dt.FLOAT if len(non_null) == len(values) else dt.Optional(dt.FLOAT)
    if tset <= {bool}:
        return dt.BOOL if len(non_null) == len(values) else dt.Optional(dt.BOOL)
    if tset <= {str}:
        return dt.STR if len(non_null) == len(values) else dt.Optional(dt.STR)
    if tset <= {tuple}:
        return dt.ANY_TUPLE
    return dt.ANY


def table_from_markdown(
    table_def: str,
    *,
    id_from: list[str] | None = None,
    schema: type[Schema] | None = None,
    _stream: bool = False,
) -> Table:
    """Parse a markdown/ascii table:

        t = pw.debug.table_from_markdown('''
            | colA | colB | __time__ | __diff__
          1 | 1    | foo  | 2        | 1
          2 | 2    | bar  | 4        | 1
        ''')

    The first (unnamed) column, when present, is the row id. __time__ and
    __diff__ script the update stream."""
    lines = [ln for ln in table_def.strip().splitlines() if ln.strip()]
    header = [h.strip() for h in lines[0].split("|")]
    has_id_col = header[0] == ""
    names = [h for h in header if h != ""]
    rows_raw: list[tuple[str | None, list[Any]]] = []
    for ln in lines[1:]:
        if set(ln.strip()) <= {"-", "|", " ", "="}:
            continue
        parts = [p for p in ln.split("|")]
        if has_id_col:
            rid = parts[0].strip() or None
            vals = [_parse_value(p) for p in parts[1 : 1 + len(names)]]
        else:
            rid = None
            vals = [_parse_value(p) for p in parts[1 : 1 + len(names)] if True]
            if len(parts) == len(names):  # no leading pipe
                vals = [_parse_value(p) for p in parts[: len(names)]]
        while len(vals) < len(names):
            vals.append(None)
        rows_raw.append((rid, vals))

    data_names = [n for n in names if n not in _SPECIAL]
    time_idx = names.index("__time__") if "__time__" in names else None
    diff_idx = names.index("__diff__") if "__diff__" in names else None
    shard_idx = names.index("__shard__") if "__shard__" in names else None

    records = []
    for i, (rid, vals) in enumerate(rows_raw):
        data = [v for n, v in zip(names, vals) if n not in _SPECIAL and n != "__shard__"]
        time = vals[time_idx] if time_idx is not None else 0
        diff = vals[diff_idx] if diff_idx is not None else 1
        if time is None:
            time = 0
        if diff is None:
            diff = 1
        records.append((rid, i, tuple(data), int(time), int(diff)))

    # column dtypes
    if schema is not None:
        dtypes = schema.dtypes()
        data_names = [n for n in data_names if n != "__shard__"]
        cols = {n: Column(dtypes.get(n, dt.ANY)) for n in data_names}
        pk = schema.primary_key_columns()
    else:
        data_names = [n for n in data_names if n != "__shard__"]
        cols = {}
        for j, n in enumerate(data_names):
            cols[n] = Column(_infer_dtype([rec[2][j] for rec in records]))
        pk = id_from

    # coerce ints to float where column is FLOAT
    coerced_records = []
    for rid, i, data, time, diff in records:
        vals = []
        for j, n in enumerate(data_names):
            v = data[j]
            if cols[n].dtype in (dt.FLOAT, dt.Optional(dt.FLOAT)) and isinstance(v, int):
                v = float(v)
            vals.append(v)
        coerced_records.append((rid, i, tuple(vals), time, diff))

    rows = []
    key_cache: dict[Any, int] = {}
    for rid, i, data, time, diff in coerced_records:
        if pk:
            kvals = [data[data_names.index(n)] for n in pk]
            key = ref_scalar(*kvals)
        elif rid is not None:
            key = key_cache.setdefault(rid, int(ref_scalar("__md__", rid)))
        else:
            key = int(ref_scalar("__mdrow__", i))
        rows.append((int(key), data, time, diff))

    op = LogicalOp("static", [], {"rows": rows})
    out = Table(cols, Universe(), op, name="markdown")
    _mark_static_append_only(out, rows)
    return out


def _mark_static_append_only(table: Table, records) -> None:
    """A static source is append-only when it is pure distinct-key
    inserts — no diff=-1 rows, no same-key re-inserts (upserts)."""
    keys = [r[0] for r in records]
    if all(r[-1] == 1 for r in records) and len(set(keys)) == len(keys):
        table._universe_append_only = True
        for c in table._columns.values():
            c.append_only = True


# alias used by the reference
parse_to_table = table_from_markdown


def table_from_rows(
    schema: type[Schema],
    rows: Iterable[tuple],
    *,
    is_stream: bool = False,
) -> Table:
    """rows: tuples of column values; when is_stream, trailing (time, diff)."""
    from ..io._connector import coerce_to_schema

    dtypes = schema.dtypes()
    names = list(dtypes.keys())
    pk = schema.primary_key_columns()
    records = []
    for i, row in enumerate(rows):
        row = tuple(row)
        if is_stream:
            data, time, diff = row[: len(names)], row[len(names)], row[len(names) + 1] if len(row) > len(names) + 1 else 1
        else:
            data, time, diff = row[: len(names)], 0, 1
        # schema-driven coercion, same contract as the connector path
        data = coerce_to_schema(dict(zip(names, data)), dtypes)
        if pk:
            key = ref_scalar(*[data[names.index(n)] for n in pk])
        else:
            key = ref_scalar("__row__", i)
        records.append((int(key), tuple(data), int(time), int(diff)))
    cols = {n: Column(t) for n, t in dtypes.items()}
    op = LogicalOp("static", [], {"rows": records})
    out = Table(cols, Universe(), op, name="from_rows")
    _mark_static_append_only(out, records)
    return out


def table_from_pandas(
    df,
    *,
    id_from: list[str] | None = None,
    schema: type[Schema] | None = None,
    unsafe_trusted_ids: bool = False,
) -> Table:
    from ..internals.schema import schema_from_pandas

    if schema is None:
        schema = schema_from_pandas(df, id_from=id_from)
    dtypes = schema.dtypes()
    names = [n for n in dtypes.keys()]
    records = []
    for i, (idx, row) in enumerate(df.iterrows()):
        data = []
        for n in names:
            v = row[n]
            if isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            elif isinstance(v, np.bool_):
                v = bool(v)
            data.append(v)
        if unsafe_trusted_ids:
            # keys taken verbatim from the frame index — the round-trip
            # partner of table_to_pandas(include_id=True); "unsafe"
            # because nothing checks they are distinct or well-formed
            key = int(idx) & 0xFFFFFFFFFFFFFFFF
        elif id_from:
            key = ref_scalar(*[data[names.index(n)] for n in id_from])
        else:
            key = ref_scalar("__pd__", i)
        records.append((int(key), tuple(data), 0, 1))
    cols = {n: Column(t) for n, t in dtypes.items()}
    op = LogicalOp("static", [], {"rows": records})
    out = Table(cols, Universe(), op, name="from_pandas")
    _mark_static_append_only(out, records)
    return out


def _run_capture(table: Table, terminate_on_error: bool = True):
    runner = GraphRunner(debug=True)
    runner.engine.terminate_on_error = terminate_on_error
    cap, names = runner.capture(table)
    runner.run()
    return cap, names


def table_to_dicts(table: Table):
    cap, names = _run_capture(table)
    keys = sorted(cap.state.keys())
    columns = {n: {k: cap.state[k][i] for k in keys} for i, n in enumerate(names)}
    return keys, columns


def table_to_pandas(table: Table, include_id: bool = True):
    import pandas as pd

    cap, names = _run_capture(table)
    keys = sorted(cap.state.keys())
    data = {n: [cap.state[k][i] for k in keys] for i, n in enumerate(names)}
    if include_id:
        return pd.DataFrame(data, index=[Pointer(k) for k in keys])
    return pd.DataFrame(data)


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return f"{v:.1f}"
    return repr(v) if isinstance(v, str) else str(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    terminate_on_error: bool = True,
) -> None:
    cap, names = _run_capture(table, terminate_on_error=terminate_on_error)
    keys = sorted(cap.state.keys())
    if n_rows is not None:
        keys = keys[:n_rows]
    rows = []
    for k in keys:
        vals = [_fmt(v) for v in cap.state[k]]
        rid = f"^{k:X}"
        if short_pointers:
            rid = rid[:8] + "..." if len(rid) > 8 else rid
        rows.append(([rid] if include_id else []) + vals)
    headers = ([""] if include_id else []) + names
    widths = [
        max(len(headers[c]), *(len(r[c]) for r in rows)) if rows else len(headers[c])
        for c in range(len(headers))
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip())
    for r in rows:
        print(" | ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip())


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    terminate_on_error: bool = True,
) -> None:
    cap, names = _run_capture(table, terminate_on_error=terminate_on_error)
    stream = sorted(cap.stream, key=lambda e: (e[2], e[0], e[3]))
    if n_rows is not None:
        stream = stream[:n_rows]
    headers = ([""] if include_id else []) + names + ["__time__", "__diff__"]
    rows = []
    for key, row, time, diff in stream:
        rid = f"^{key:X}"
        if short_pointers:
            rid = rid[:8] + "..." if len(rid) > 8 else rid
        rows.append(
            ([rid] if include_id else [])
            + [_fmt(v) for v in row]
            + [str(time), str(diff)]
        )
    widths = [
        max(len(headers[c]), *(len(r[c]) for r in rows)) if rows else len(headers[c])
        for c in range(len(headers))
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip())
    for r in rows:
        print(" | ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip())


def table_to_stream(table: Table):
    """Return the raw update stream [(key, row, time, diff), ...]."""
    cap, names = _run_capture(table)
    return cap.stream, names


def table_from_parquet(
    path,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: type[Schema] | None = None,
) -> Table:
    """Parquet file -> table via pandas (reference debug/__init__.py
    table_from_parquet :464). ``unsafe_trusted_ids`` takes row keys
    verbatim from the frame's integer index (the round-trip partner of
    ``table_to_pandas(include_id=True)``)."""
    import pandas as pd

    return table_from_pandas(
        pd.read_parquet(path),
        id_from=id_from,
        schema=schema,
        unsafe_trusted_ids=unsafe_trusted_ids,
    )


def table_to_parquet(table: Table, filename) -> None:
    """Run the table to completion and write its final state to a
    Parquet file (reference debug/__init__.py table_to_parquet :481)."""
    df = table_to_pandas(table, include_id=False)
    df.to_parquet(filename)


class StreamGenerator:
    """Scripted multi-batch input streams for tests (reference
    debug/__init__.py StreamGenerator :496).

    The reference writes persistence snapshot events per worker and
    replays them; this engine's scripted static sources already carry
    (key, row, time, diff) directly, so batches lower straight onto
    that — the worker ids in the by-workers form are accepted for API
    parity but routing is by key shard here, exactly as for any other
    source."""

    def _table_from_dict(
        self,
        batches: dict[int, dict[int, list[tuple[int, Any, list[Any]]]]],
        schema: type[Schema],
    ) -> Table:
        """``{timestamp: {worker: [(diff, key, values), ...]}}`` -> table.

        Timestamps must be positive; odd ones are doubled (engine times
        are even, with a warning), matching the reference's contract."""
        import warnings

        if any(t < 0 for t in batches):
            raise ValueError("negative timestamp cannot be used")
        if any(t == 0 for t in batches):
            warnings.warn(
                "rows with timestamp 0 are backfill-only and skip output connectors"
            )
        if any(t % 2 for t in batches):
            warnings.warn("timestamps are required to be even; doubling them")
            batches = {2 * t: b for t, b in batches.items()}

        dtypes = schema.dtypes()
        names = list(dtypes)
        rows = []
        for t in sorted(batches):
            for worker in sorted(batches[t]):
                for diff, key, values in batches[t][worker]:
                    if diff not in (1, -1):
                        raise ValueError("only diffs of 1 and -1 are supported")
                    rows.append((int(key), tuple(values), int(t), int(diff)))
        cols = {n: Column(dtypes[n]) for n in names}
        op = LogicalOp("static", [], {"rows": rows})
        return Table(cols, Universe(), op, name="stream_generator")

    def table_from_list_of_batches_by_workers(
        self,
        batches: list[dict[int, list[dict[str, Any]]]],
        schema: type[Schema],
    ) -> Table:
        """Each batch maps worker id -> rows (dicts of column values);
        batches become successive engine epochs."""
        import itertools

        counter = itertools.count()
        names = list(schema.dtypes())
        formatted: dict[int, dict[int, list[tuple[int, Any, list[Any]]]]] = {}
        t = 2
        for batch in batches:
            formatted[t] = {
                worker: [
                    (1, int(ref_scalar(next(counter))), [row[n] for n in names])
                    for row in rows
                ]
                for worker, rows in batch.items()
            }
            t += 2
        return self._table_from_dict(formatted, schema)

    def table_from_list_of_batches(
        self,
        batches: list[list[dict[str, Any]]],
        schema: type[Schema],
    ) -> Table:
        """Each batch is a list of row dicts; one engine epoch per batch."""
        return self.table_from_list_of_batches_by_workers(
            [{0: batch} for batch in batches], schema
        )

    def table_from_pandas(
        self,
        df,
        id_from: list[str] | None = None,
        schema: type[Schema] | None = None,
    ) -> Table:
        """DataFrame with optional ``_time``/``_worker``/``_diff``
        columns -> scripted stream (reference StreamGenerator
        table_from_pandas)."""
        from ..internals.schema import schema_from_pandas

        special = [c for c in ("_time", "_worker", "_diff") if c in df.columns]
        plain = df.drop(columns=special)
        if schema is None:
            schema = schema_from_pandas(plain, id_from=id_from)
        names = list(schema.dtypes())
        import itertools

        counter = itertools.count()
        # a _diff=-1 row retracts the latest prior insert with EQUAL
        # values — the engine cancels by (key, row), so the retraction
        # must reuse that insert's key
        live: dict[tuple, list[int]] = {}
        formatted: dict[int, dict[int, list[tuple[int, Any, list[Any]]]]] = {}
        # per-COLUMN extraction: iterrows() upcasts each row to a common
        # dtype (an int column next to a float one comes back float64);
        # .tolist() converts per column, preserving declared types
        col_vals = {n: df[n].tolist() for n in names}
        times = df["_time"].tolist() if "_time" in df.columns else [2] * len(df)
        workers = df["_worker"].tolist() if "_worker" in df.columns else [0] * len(df)
        diffs = df["_diff"].tolist() if "_diff" in df.columns else [1] * len(df)
        for i in range(len(df)):
            t = int(times[i])
            worker = int(workers[i])
            diff = int(diffs[i])
            values = [col_vals[n][i] for n in names]
            sig = tuple(values)
            if diff == 1:
                key = int(ref_scalar(next(counter)))
                live.setdefault(sig, []).append(key)
            else:
                stack = live.get(sig)
                if not stack:
                    raise ValueError(
                        f"_diff=-1 row {sig!r} has no matching prior insert"
                    )
                key = stack.pop()
            formatted.setdefault(t, {}).setdefault(worker, []).append(
                (diff, key, values)
            )
        return self._table_from_dict(formatted, schema)
