"""Connector runtime glue: build input tables fed by reader threads.

Rebuild of the reference's connector driver (upstream Pathway's src/connectors/
mod.rs:427-560 Connector::run: reader thread → entry queue → per-epoch
poller with commit ticks) on top of engine InputSessions."""

from __future__ import annotations

import json
import threading
import time as _time
from typing import Any, Callable, Iterable

from ..engine import dataflow as df
from ..engine.value import Json, ref_scalar
from ..internals import dtype as dt
from ..internals.schema import Schema
from ..internals.table import Column, LogicalOp, Table
from ..internals.universe import Universe
from ..internals.parse_graph import G


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: cheap, deterministic, uniform bits — auto
    keys only need uniqueness + shard spread, not content hashing (the
    full ref_scalar serialize+blake per row was ~30% of source-ingest
    CPU on the streaming bench)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def make_key(
    names: list[str], pk: list[str] | None, values: dict, seq: list[int], salt=None
) -> int:
    if pk:
        return int(ref_scalar(*[values.get(n) for n in pk]))
    seq[0] += 1
    if salt is not None:
        # partitioned sources generate keys on several processes at
        # once: the per-process salt keeps the auto key spaces disjoint
        return _mix64(_mix64(int(salt) + 1) ^ seq[0])
    return _mix64(seq[0])


def coerce_to_schema(values: dict, dtypes: dict[str, dt.DType]) -> tuple:
    out = []
    for n, t in dtypes.items():
        v = values.get(n)
        tu = dt.unoptionalize(t)
        if v is not None:
            try:
                if tu is dt.INT and not isinstance(v, bool):
                    v = int(v)
                elif tu is dt.FLOAT:
                    v = float(v)
                elif tu is dt.STR and not isinstance(v, str):
                    v = str(v)
                elif tu is dt.JSON and not isinstance(v, Json):
                    v = Json(v)
                elif tu is dt.BYTES and isinstance(v, str):
                    v = v.encode()
            except (ValueError, TypeError):
                pass
        out.append(v)
    return tuple(out)


class StreamingContext:
    """Handed to reader threads: typed insert/remove + commit.

    ``process_id``/``n_processes`` identify this reader's slice of a
    multi-process cluster: partition-aware readers (kafka partitions,
    nats queue groups, pubsub subscriptions) read only their share on
    their owning process — the reference's ``parallel_readers`` mode
    (upstream Pathway's src/engine/graph.rs:943-950) — instead of funneling
    everything through process 0."""

    def __init__(self, session: df.InputSession, schema: type[Schema], stopped: threading.Event):
        self.session = session
        self.dtypes = schema.dtypes()
        self.names = list(self.dtypes.keys())
        self.pk = schema.primary_key_columns()
        # append-only declaration: primary-keyed rows skip the upsert
        # protocol (each key arrives exactly once, there is no old value
        # to replace), matching the engine's no-retraction fast path
        from ..internals.schema import schema_is_append_only

        self.append_only = schema_is_append_only(schema)
        import os

        self.process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
        self.n_processes = int(os.environ.get("PATHWAY_PROCESSES", "1") or 1)
        # lazy: offsets are restored from the persistence log after
        # construction but before reader threads start
        self._seq: list[int] | None = None
        self._deletions: dict[int, tuple] = {}
        self._stopped = stopped  # the engine's: set when its run ends

    def wait_stopped(self, timeout: float | None = None) -> bool:
        """Block until the engine's run ends, or ``timeout`` seconds pass;
        True once it has ended. Readers that serve until the run ends (the
        REST endpoint, the streaming file scanner) wait here and return."""
        return self._stopped.wait(timeout)

    @property
    def offsets(self) -> dict:
        """Reader bookmarks restored from the persistence log (empty on a
        fresh run). Readers use these to skip already-ingested input."""
        return self.session.get_offsets()

    def set_offset(self, key, value) -> None:
        """Record a reader bookmark; snapshotted atomically with the next
        commit (reference connectors/offset.rs semantics)."""
        self.session.set_offset(key, value)

    def _seq_counter(self) -> list[int]:
        if self._seq is None:
            self._seq = [int(self.session.get_offsets().get("__seq__", 0))]
        return self._seq

    def insert(self, values: dict, offsets: dict | None = None) -> None:
        seq = self._seq_counter()
        key = make_key(self.names, self.pk, values, seq, getattr(self, "_key_salt", None))
        row = coerce_to_schema(values, self.dtypes)
        # the seq bookmark (and any caller offsets) lands in the same
        # locked append as the row: a concurrent autocommit tick must not
        # commit the row with pre-row offsets (double-read on recovery)
        off = {"__seq__": seq[0], **(offsets or {})}
        if self.pk and not self.append_only:
            self.session.upsert(key, row, offsets=off)
            self._deletions[key] = row
        else:
            self.session.insert(key, row, offsets=off)
            self._deletions[key] = row

    def insert_batch(self, columns: dict[str, list]) -> None:
        """Columnar bulk insert (an addition over the reference): all rows of a
        batch append under ONE lock acquisition with vectorized key
        derivation — the per-row ``insert`` path costs ~30µs/row in
        dict/lock overhead, which dominates high-rate sources."""
        names = list(self.dtypes.keys())
        cols = []
        n = None
        for name in names:
            col = list(columns.get(name, ()))
            if n is None:
                n = len(col)
            elif col and len(col) != n:
                raise ValueError("insert_batch columns must share one length")
            cols.append(col if col else [None] * (n or 0))
        if not n:
            return
        if self.pk:
            rows = list(zip(*cols))
            for name_vals in rows:
                self.insert(dict(zip(names, name_vals)))
            return
        seq = self._seq_counter()
        salt = getattr(self, "_key_salt", None)
        base = _mix64(int(salt) + 1) if salt is not None else 0
        dtypes = self.dtypes
        coerced = []
        for name, col in zip(names, cols):
            t = dt.unoptionalize(dtypes[name])
            if t is dt.INT:
                coerced.append([v if v is None or isinstance(v, bool) else int(v) for v in col])
            elif t is dt.FLOAT:
                coerced.append([v if v is None else float(v) for v in col])
            elif t is dt.JSON:
                coerced.append([v if v is None or isinstance(v, Json) else Json(v) for v in col])
            else:
                coerced.append(col)
        rows = list(zip(*coerced))
        start = seq[0]
        seq[0] += n
        keys = [_mix64(base ^ (start + i + 1)) for i in range(n)]
        with self.session._lock:
            pend = self.session._pending
            for key, row in zip(keys, rows):
                pend.append((key, row, 1))
            self.session._offsets["__seq__"] = seq[0]

    def remove(self, values: dict) -> None:
        key = make_key(
            self.names, self.pk, values, self._seq_counter(), getattr(self, "_key_salt", None)
        )
        if self.pk:
            self.session.upsert(key, None)
        else:
            row = coerce_to_schema(values, self.dtypes)
            self.session.remove(key, row)

    def upsert_keyed(
        self, key_parts: tuple, values: dict | None, offsets: dict | None = None
    ) -> None:
        """Upsert at an explicit key derived from ``key_parts`` (None
        values = delete). Lets readers speak a snapshot protocol with
        stable keys, e.g. (path, line_no) for file scanners."""
        key = int(ref_scalar(*key_parts))
        if values is None:
            self.session.upsert(key, None, offsets=offsets)
        else:
            self.session.upsert(key, coerce_to_schema(values, self.dtypes), offsets=offsets)

    def commit(self) -> None:
        self.session.commit()

    def close(self) -> None:
        self.session.close()


def input_table_from_reader(
    schema: type[Schema],
    reader: Callable[[StreamingContext], None],
    *,
    name: str = "connector",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    supports_offsets: bool = False,
    parallel_readers: bool = False,
    retry_policy: Any = None,
) -> Table:
    """Create an input Table whose rows are produced by `reader(ctx)`
    running on a named thread (reference reader threads mod.rs:447).
    With ``persistent_id`` set and a persistence config on the run, the
    source's committed batches are logged for checkpoint/recovery.

    ``parallel_readers``: the reader is partition-aware (it honors
    ``ctx.process_id``/``ctx.n_processes``) — in a multi-process run
    EVERY process starts its own reader thread and feeds its local
    shard, the reference's partitioned-source mode
    (upstream Pathway's src/engine/graph.rs:943-950); otherwise the source
    reads on process 0 only and rows are forwarded by key shard.

    ``retry_policy``: a :class:`~pathway_tpu_torch.resilience.RetryPolicy`
    — transient reader exceptions re-run ``reader(ctx)`` with backoff
    instead of failing the run; rows already committed before the
    failure are not re-read (readers resume from ``ctx.offsets``).
    Attempt counts land in ``resilience.RETRY_METRICS`` under scope
    ``connector:<name>`` and show up on ``/metrics``. Each attempt first
    passes the ``connector.<name>`` chaos site."""
    dtypes = schema.dtypes()
    # schema-declared append-only: the engine trusts the declaration
    # (like the reference's SessionType::Native sources) and skips
    # retraction bookkeeping
    from ..internals.schema import schema_is_append_only

    defs = schema.columns()
    schema_ao = schema_is_append_only(schema)

    def build(engine: df.EngineGraph, runner) -> df.Node:
        node = df.SessionSourceNode(engine)
        node.persistent_id = persistent_id
        node.supports_offsets = supports_offsets
        node.parallel_readers = parallel_readers
        node.append_only = schema_ao
        ctx = StreamingContext(node.session, schema, engine.stopped)
        if parallel_readers and ctx.n_processes > 1:
            # each process logs its partition slice under its own
            # persistence namespace (EnginePersistence proc-<pid>/) and
            # recovers it on restart — reference per-worker storage,
            # src/persistence/tracker.rs:49
            ctx._key_salt = ctx.process_id

        from ..resilience import chaos

        def attempt():
            # scripted transient failures for the retry tests
            chaos.inject(f"connector.{name}")
            reader(ctx)

        def run():
            try:
                if retry_policy is not None:
                    retry_policy.execute(attempt, scope=f"connector:{name}")
                else:
                    attempt()
            except Exception as exc:
                # record BEFORE close(): the engine loop must see the
                # failure when it sees the closed session, or a crashed
                # reader looks like clean EOF
                engine.connector_failures.append((name, exc))
                engine.wake()
            finally:
                ctx.close()

        t = threading.Thread(target=run, name=f"pathway_tpu:connector-{name}", daemon=True)
        t.pathway_parallel_reader = parallel_readers
        engine.connector_threads.append(t)
        return node

    cols = {
        n: Column(
            t,
            append_only=schema_ao
            or (n in defs and defs[n].append_only is True),
        )
        for n, t in dtypes.items()
    }
    # the commit cadence rides on the op so jax-free analysis (PWL024:
    # freshness SLO tighter than the autocommit floor) can read it
    op = LogicalOp(
        "connector",
        [],
        {"build": build, "autocommit_duration_ms": autocommit_duration_ms},
    )
    out = Table(cols, Universe(), op, name=name)
    out._universe_append_only = schema_ao
    return out


def static_table_from_rows(
    schema: type[Schema],
    dict_rows: Iterable[dict],
    *,
    name: str = "static_connector",
) -> Table:
    dtypes = schema.dtypes()
    names = list(dtypes.keys())
    pk = schema.primary_key_columns()
    seq = [0]
    records = []
    for values in dict_rows:
        key = make_key(names, pk, values, seq)
        records.append((key, coerce_to_schema(values, dtypes), 0, 1))
    cols = {n: Column(t) for n, t in dtypes.items()}
    op = LogicalOp("static", [], {"rows": records})
    out = Table(cols, Universe(), op, name=name)
    # static snapshots are pure distinct-key inserts unless primary-key
    # collisions make later rows upserts of earlier ones
    keys = [r[0] for r in records]
    if len(set(keys)) == len(keys):
        out._universe_append_only = True
        for c in out._columns.values():
            c.append_only = True
    return out


def add_output_sink(
    table: Table,
    write_fn: Callable,
    on_end: Callable | None = None,
    name: str = "output",
    on_build: Callable | None = None,
    on_time_end: Callable | None = None,
) -> None:
    """Register a sink: write_fn(key, row_dict, time, diff) per change;
    ``on_time_end(time)`` fires once per closed epoch (transaction
    boundaries belong there). ``on_build(runner)`` runs at graph-build
    time on the process that will actually deliver changes — resource
    acquisition (opening output files, connecting clients) belongs
    there, NOT at registration time, so worker processes of a
    multi-process run never touch the sink's target."""

    def build(runner, t):
        if on_build is not None and not getattr(runner, "suppress_callbacks", False):
            on_build(runner)
        runner.subscribe(
            t, on_change=write_fn, on_time_end=on_time_end, on_end=on_end
        )

    G.add_output(table, {"build": build, "name": name})
