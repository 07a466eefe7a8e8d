"""Incremental dataflow engine.

A rebuild of the reference's Rust engine
(upstream Pathway's src/engine/dataflow.rs — DataflowGraphInner :4277,
run_with_new_dataflow_graph :5506) WITHOUT timely/differential: Pathway
only ever uses totally-ordered u64 timestamps (src/engine/timestamp.rs:20),
so the general Naiad progress protocol collapses to bulk-synchronous
epochs. Each epoch:

    feed source deltas at time t  →  one topological pass over the DAG
    →  frontier advances to t, time-based operators release/forget
    →  consolidated output deltas fire subscribers.

This design is deliberately SPMD-friendly: an epoch's per-operator delta
batches are columnar-izable and the same loop runs per shard with an
all-to-all on re-keying operators (see pathway_tpu.parallel). Data model:
updates are (key: uint64, row: tuple, diff: ±1); tables are keyed (one row
per key), which lets every stateful operator keep `dict jk -> dict key ->
row` state instead of general multiset arrangements.

The observability planes hook in as the reference's engine does: input
sessions stamp the freshness plane's arrival, commit and drain marks; the
epoch loop stamps its epoch transitions there, records ``epoch.begin`` /
``epoch.advance`` in the flight recorder and reports each epoch's wall
time to ``epoch_observers`` (the serving batcher's dispatch slots); and
operators that work on request rows (expression maps, batch UDFs, index
queries) bind those rows' request traces (``tracing.ROW_TRACES``) while
they work, so a request's trace follows its row into the epoch thread.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time as _wall
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from .reducers import Reducer
from .value import (
    ERROR,
    Error,
    Pointer,
    ref_scalar,
    rows_equal,
    shard_of,
    values_equal,
)

from .. import native as _native
from ..freshness.plane import FRESHNESS
from ..internals import flight_recorder
from ..tracing.context import ROW_TRACES

# Update = (key: int, row: tuple, diff: int)
Update = tuple

INF_TIME = float("inf")


def dumps_host(obj) -> bytes:
    """Pickle an operator snapshot with host data only: every torch tensor
    inside is written as a numpy array (bf16 as f32, which numpy lacks). A
    pickled CUDA tensor would reload onto the card it came from, and fail
    to load on a host without one. The pickler meets only the objects the
    C pickler does not handle itself (no plain str, int, tuple, list or
    dict), so a snapshot of text rows costs what ``pickle.dumps`` does."""
    import io
    import pickle

    torch = sys.modules.get("torch")

    class HostPickler(pickle.Pickler):
        def reducer_override(self, o):
            if torch is not None and isinstance(o, torch.Tensor):
                t = o.detach()
                if t.dtype == torch.bfloat16:
                    t = t.float()
                return t.cpu().numpy().__reduce__()
            return NotImplemented

    buf = io.BytesIO()
    HostPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


class EngineError(Exception):
    """Fatal failure inside an engine operator.

    Carries the operator's identity — ``node_name``/``node_id`` and the
    build-time user ``trace`` (an ``internals.trace.Frame``) — so a
    runtime failure cites the same source location the static verifier
    (``pathway_tpu.analysis``) uses for its diagnostics."""

    def __init__(self, message, *, node=None, trace=None):
        super().__init__(message)
        self.node_name = getattr(node, "name", None)
        self.node_id = getattr(node, "id", None)
        self.trace = trace if trace is not None else getattr(node, "user_frame", None)


def consolidate(updates: list[Update]) -> list[Update]:
    """Merge updates per (key, row): sum diffs, drop zeros. Preserves
    retract-before-insert ordering per key. Large batches go through the
    C++ kernel (native/pathway_native.cc pn_consolidate)."""
    # streaming fast path: batches of fresh inserts have all-distinct
    # keys and nothing to merge — an int-set membership probe per row
    # beats serializing every row for byte-grouping (~30% of epoch CPU
    # on the 8-shard streaming bench)
    keys = set()
    distinct = True
    for key, _row, diff in updates:
        if diff != 1 or key in keys:
            distinct = False
            break
        keys.add(key)
    if distinct:
        return updates
    if len(updates) >= 64:
        out = _native.consolidate_native(updates)
        if out is not None:
            return out
    by_key: dict[int, list[list]] = {}
    order: list[int] = []
    for key, row, diff in updates:
        if key not in by_key:
            by_key[key] = []
            order.append(key)
        bucket = by_key[key]
        for ent in bucket:
            if rows_equal(ent[0], row):
                ent[1] += diff
                break
        else:
            bucket.append([row, diff])
    out: list[Update] = []
    for key in order:
        ents = [e for e in by_key[key] if e[1] != 0]
        ents.sort(key=lambda e: e[1])  # retractions first
        for row, diff in ents:
            if diff > 0:
                out.extend((key, row, 1) for _ in range(diff))
            else:
                out.extend((key, row, -1) for _ in range(-diff))
    return out


def shard_of_value(value, n: int) -> int:
    """Shard for an arbitrary grouping/instance/join value. Always via
    the canonical key hash (ref_scalar) so values that compare equal
    (2 vs 2.0) route to the same shard, exactly like dict-keyed state
    treats them in a single-worker run."""
    return shard_of(int(ref_scalar(value)), n)


def apply_keyed(store: dict, pending: dict, pkey, key: int, row: tuple, diff: int) -> None:
    """Apply one update to ``store`` (key -> its one current row). In a run
    of several workers a row's new version and the retraction of its old
    one may come from different shards, so the insertion can arrive
    first: such a key keeps the multiset of its versions in
    ``pending[pkey]`` until it consolidates to one row (or none) again,
    and ``store`` meanwhile holds a version of positive count."""
    if pkey not in pending:
        old = store.get(key)
        if diff > 0 and old is None:
            store[key] = row
            return
        if diff < 0 and old is not None and rows_equal(old, row):
            del store[key]
            return
        pending[pkey] = [] if old is None else [[old, 1]]
    bag = pending[pkey]
    for entry in bag:
        if rows_equal(entry[0], row):
            entry[1] += diff
            break
    else:
        bag.append([row, diff])
    bag[:] = [e for e in bag if e[1]]
    live = [e[0] for e in bag if e[1] > 0]
    if live:
        store[key] = live[-1]
    else:
        store.pop(key, None)
    if not bag or (len(bag) == 1 and bag[0][1] == 1):
        del pending[pkey]


BROADCAST = -1


class UpdateBatch(list):
    """A delta batch (list of (key, row, diff)) carrying the columnar
    arrays already materialized by the producing node (col_cache: row
    slot -> ndarray, row-aligned), so consumers skip re-extracting them
    from the row tuples. Node.emit passes it through by reference when
    the consumer's queue is empty; treat as read-only."""

    __slots__ = ("col_cache",)

    def __init__(self, *args):
        super().__init__(*args)
        self.col_cache: dict[int, Any] = {}


def _error_operand(fn: Callable, row: tuple) -> bool:
    """True when an expression's failure traces to an ERROR operand: the
    compiled closure carries ``_reads`` (the slots it depends on,
    graph_runner.compile); without it, fall back to the whole row."""
    reads = getattr(fn, "_reads", None)
    if reads is None:
        return any(isinstance(v, Error) for v in row)
    return any(isinstance(row[i], Error) for i in reads if i < len(row))


class OperatorStats:
    """Per-operator probe counters (reference graph.rs:523 OperatorStats)."""

    __slots__ = ("rows_in", "rows_out", "epochs", "name")

    def __init__(self, name: str):
        self.name = name
        self.rows_in = 0
        self.rows_out = 0
        self.epochs = 0


class Node:
    """Base dataflow operator."""

    n_inputs = 1

    # statically proven insert-only stream (logical-plan analysis of
    # schema append_only declarations propagated through operators):
    # consolidation and retraction bookkeeping can be skipped
    append_only = False

    # attribute names forming the node's recoverable state (operator
    # snapshots, upstream src/persistence/operator_snapshot.rs); empty
    # for stateless operators
    _snap_attrs: tuple = ()

    def snapshot_state(self):
        if not self._snap_attrs:
            return None
        return {a: getattr(self, a) for a in self._snap_attrs}

    def restore_state(self, state) -> None:
        for a, v in state.items():
            setattr(self, a, v)

    def snapshot_signature(self):
        """Structural identity for snapshot compatibility. Restoring
        state into a CHANGED program silently corrupts results, so nodes
        expose their distinguishing configuration here; subclasses add
        what the generic name cannot see (reducer kinds, join shape).
        User expressions cannot be fingerprinted — same-program across
        restarts remains the documented persistence contract (as in
        upstream Pathway) — but common edits are caught."""
        return (self.name, tuple(sorted((c.id, p) for c, p in self.consumers)))

    def __init__(self, graph: "EngineGraph", name: str = ""):
        self.graph = graph
        self.id = len(graph.nodes)
        self.name = name or type(self).__name__
        self.consumers: list[tuple["Node", int]] = []
        self.queues: list[list[Update]] = [[] for _ in range(self.n_inputs)]
        self.stats = OperatorStats(self.name)
        graph.nodes.append(self)

    def connect(self, upstream: "Node", port: int = 0) -> "Node":
        upstream.consumers.append((self, port))
        return self

    def route_owner(self, key: int, row: tuple, port: int, n_shards: int):
        """Which worker shard must process this update (multi-worker
        runs): None = wherever it was produced (stateless/key-preserving
        operators), BROADCAST = every shard, else a shard id. Stateful
        operators override with their keying rule — the exchange
        boundary of the reference's timely workers (shard.rs)."""
        return None

    def emit(self, updates: list[Update], time) -> None:
        if not updates:
            return
        self.stats.rows_out += len(updates)
        cluster = self.graph.cluster
        for node, port in self.consumers:
            if cluster is not None:
                local = cluster.route(self.graph, node, port, updates)
            else:
                local = updates
            if local:
                q = node.queues[port]
                if not q and isinstance(local, UpdateBatch):
                    # keep the columnar batch (and its col_cache) intact
                    # for the consumer; safe to share read-only
                    node.queues[port] = local
                else:
                    q.extend(local)
                self.graph._dirty.add(node.id)

    def take(self, port: int = 0) -> list[Update]:
        q = self.queues[port]
        if q:
            self.queues[port] = []
            self.stats.rows_in += len(q)
        return q

    def process(self, time) -> None:
        raise NotImplementedError

    def on_frontier(self, frontier) -> None:
        """Frontier advanced: time-based operators release/forget here."""

    def on_end(self) -> None:
        """All inputs finished."""


class StaticSourceNode(Node):
    """Bounded source with scripted (time, updates) batches — used for
    static tables and the __time__/__diff__ test harness."""

    n_inputs = 0

    def __init__(self, graph, batches: list[tuple[int, list[Update]]]):
        super().__init__(graph)
        self.batches = sorted(batches, key=lambda b: b[0])
        self.pos = 0
        graph.static_sources.append(self)

    def next_time(self):
        if self.pos < len(self.batches):
            return self.batches[self.pos][0]
        return None

    def feed(self, time) -> None:
        while self.pos < len(self.batches) and self.batches[self.pos][0] == time:
            self.emit(self.batches[self.pos][1], time)
            self.pos += 1

    def process(self, time):
        pass


class InputSession:
    """Thread-safe feed from connector reader threads into the engine
    (reference: InputSession / connectors/adaptors.rs:176)."""

    def __init__(self, node: "SessionSourceNode"):
        self.node = node
        self._lock = threading.Lock()
        self._pending: list[Update] = []
        self._committed: list[list[Update]] = []
        self._closed = False
        # reader-position bookmarks, snapshotted per commit so the offsets
        # drained with a batch never run ahead of its data (reference
        # connectors/offset.rs + SnapshotEvent::AdvanceTime)
        self._offsets: dict = {}
        self._committed_offsets: dict | None = None

    def set_offset(self, key, value) -> None:
        with self._lock:
            if value is None:
                self._offsets.pop(key, None)
            else:
                self._offsets[key] = value

    def get_offsets(self) -> dict:
        with self._lock:
            return dict(self._offsets)

    def restore_offsets(self, offsets: dict) -> None:
        with self._lock:
            self._offsets = dict(offsets)

    def insert(self, key: int, row: tuple, offsets: dict | None = None) -> None:
        with self._lock:
            self._pending.append((key, row, 1))
            if offsets:
                self._offsets.update(offsets)
        FRESHNESS.note_arrival(id(self))

    def remove(self, key: int, row: tuple) -> None:
        with self._lock:
            self._pending.append((key, row, -1))
        FRESHNESS.note_arrival(id(self))

    def upsert(self, key: int, row: tuple | None, offsets: dict | None = None) -> None:
        """Replace the current row at key (None row = delete). ``offsets``
        update atomically with the row: a concurrent commit() must never
        snapshot offsets that run ahead of (or behind) the data in the
        batch, or recovery double-reads/skips input."""
        with self._lock:
            self._pending.append((key, row, 2))  # marker; resolved at feed
            if offsets:
                self._offsets.update(offsets)
        FRESHNESS.note_arrival(id(self))

    def commit(self) -> None:
        with self._lock:
            if self._pending:
                self._committed.append(self._pending)
                self._pending = []
            self._committed_offsets = dict(self._offsets)
        FRESHNESS.note_commit(id(self))
        self.node.graph.wake()

    def pending(self) -> bool:
        """Committed batches waiting to be drained (the multi-process
        coordinator polls worker-side partitioned sources with this)."""
        with self._lock:
            return bool(self._committed)

    def close(self) -> None:
        with self._lock:
            if self._pending:
                self._committed.append(self._pending)
                self._pending = []
            self._committed_offsets = dict(self._offsets)
            self._closed = True
        FRESHNESS.note_commit(id(self))
        self.node.graph.wake()

    def drain(self) -> list[Update] | None:
        with self._lock:
            if not self._committed:
                return None
            batches = self._committed
            self._committed = []
            self.node.last_offsets = self._committed_offsets
        FRESHNESS.note_drain(id(self))
        return [u for b in batches for u in b]

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed and not self._committed


class SessionSourceNode(Node):
    """Streaming source fed by an InputSession. Resolves upsert markers
    against its keyed state so connectors can speak either diff or
    snapshot protocols."""

    n_inputs = 0
    _snap_attrs = ("state", "_ao_seen")

    def __init__(self, graph):
        super().__init__(graph)
        self.session = InputSession(self)
        self.state: dict[int, tuple] = {}
        self.persistent_id: str | None = None
        # readers that honor ctx.offsets can resume without re-reading;
        # offset-unaware sources need different record/replay handling
        self.supports_offsets = False
        # error-log feeds are engine-internal: they never block run
        # termination and are not recorded by persistence
        self.is_error_log = False
        self.last_offsets: dict | None = None
        # append-only fast path: keys already ingested, deduping scanner
        # re-emissions without storing row values. Allocated lazily on
        # the FIRST upsert-protocol marker (diff=2): scanners speak that
        # protocol from their first batch, while seq-keyed sources
        # (python/kafka — every key provably fresh) never do and so pay
        # zero state, matching the reference's insert-only sessions.
        self._ao_seen: set[int] | None = None
        # recovery: finalized batches to replay, in time order
        self.replay_batches: list[tuple[int, list[Update]]] = []
        graph.session_sources.append(self)

    def next_replay_time(self):
        return self.replay_batches[0][0] if self.replay_batches else None

    def feed_replay(self, time) -> None:
        while self.replay_batches and self.replay_batches[0][0] == time:
            _, ups = self.replay_batches.pop(0)
            self._apply_replay(ups, time)

    def flush_replay(self, time) -> bool:
        """Emit ALL remaining recovered batches at ``time`` (one
        dedicated replay round instead of per-logged-epoch feeding)."""
        fed = False
        while self.replay_batches:
            _, ups = self.replay_batches.pop(0)
            self._apply_replay(ups, time)
            fed = True
        return fed

    def _apply_replay(self, ups, time) -> None:
        if self.append_only:
            # scanner sources dedupe across restarts via their reader
            # offsets; the seen-set only needs refreshing when one was
            # already in play (restored from an operator snapshot)
            if self._ao_seen is not None:
                self._ao_seen.update(k for k, _r, d in ups if d > 0)
        else:
            for key, row, diff in ups:
                if diff > 0:
                    self.state[key] = row
                else:
                    self.state.pop(key, None)
        self.emit(list(ups), time)

    def feed_batch(self, raw: list[Update], time) -> list[Update]:
        resolved = self.resolve_batch(raw)
        self.emit(resolved, time)
        return resolved

    def resolve_batch(self, raw: list[Update]) -> list[Update]:
        """Resolve connector wire protocol (upsert markers, append-only
        dedupe) against this source's keyed state WITHOUT emitting —
        the overlapped epoch pipeline (engine/pipeline.py) resolves and
        durably logs epoch N+1 while epoch N still executes, then the
        executor emits the resolved batch at its turn. Resolution order
        defines the state sequence, so only the single stager thread
        (or the strict loop) may call this."""
        if self.append_only:
            # declared insert-only: upsert resolution can never trigger,
            # so the old-VALUE dict is skipped; only a key SET remains
            # (~10-20x lighter than storing rows) because scanner
            # connectors re-emit every (path, i) key of a modified file
            # via the upsert wire protocol (diff=2) — an already-seen
            # key is an idempotent re-emission to drop, a fresh key is
            # an insert. A deletion (diff<=0, or a marker without a
            # row) is a broken declaration, not data: fail loudly (the
            # reference errors on deletions into append-only inputs
            # too). A re-emitted key with CHANGED row content would be
            # an in-place update — undetectable without storing values;
            # the declaration is trusted, as at every other fast path.
            out: list[Update] = []
            for key, row, diff in raw:
                if diff == 1:
                    # plain-insert protocol: keys are fresh by the
                    # connector's construction; dedupe only once the
                    # scanner protocol has appeared on this source
                    if self._ao_seen is not None:
                        self._ao_seen.add(key)
                    out.append((key, row, 1))
                elif diff == 2 and row is not None:
                    if self._ao_seen is None:
                        self._ao_seen = set()
                    if key not in self._ao_seen:
                        self._ao_seen.add(key)
                        out.append((key, row, 1))
                else:
                    raise EngineError(
                        f"source {self.name!r} is declared append_only "
                        "but produced a retraction",
                        node=self,
                    )
            return out
        out: list[Update] = []
        for key, row, diff in raw:
            if diff == 2:  # upsert marker
                old = self.state.get(key)
                if old is not None:
                    out.append((key, old, -1))
                if row is not None:
                    out.append((key, row, 1))
                    self.state[key] = row
                elif key in self.state:
                    del self.state[key]
            else:
                out.append((key, row, diff))
                if diff > 0:
                    self.state[key] = row
                else:
                    self.state.pop(key, None)
        return consolidate(out)

    def process(self, time):
        pass


class ExprMapNode(Node):
    """expression_table (dataflow.rs:1246 MapWrapped): map each row through
    compiled expressions. Vectorized evaluators receive the whole delta
    batch; per-row fallback otherwise. Non-deterministic expressions
    (UDFs) store emitted rows so retractions replay exactly."""

    def __init__(
        self,
        graph,
        exprs: Sequence[Callable],
        deterministic: bool = True,
        batch_eval: Callable | None = None,
        name: str = "ExprMap",
    ):
        super().__init__(graph, name)
        self.exprs = list(exprs)
        self.deterministic = deterministic
        self.batch_eval = batch_eval  # (keys, rows) -> list of out rows
        self.memo: dict[int, tuple] = {}
        if not deterministic:
            self._snap_attrs = ("memo",)

    def snapshot_signature(self):
        return (super().snapshot_signature(), len(self.exprs), self.deterministic)

    def process(self, time):
        updates = self.take()
        if not updates:
            return
        batch_failed = False
        if (
            self.batch_eval is not None
            and self.deterministic
            and not any(d <= 0 for _, _, d in updates)
        ):
            # all-inserts batch (the streaming-ingest common case): one
            # vectorized evaluation, zero per-row bookkeeping; the
            # materialized columns ride along for downstream consumers
            keys = [k for k, _, _ in updates]
            try:
                with ROW_TRACES.bind(keys):
                    result = self.batch_eval(
                        keys,
                        [r for _, r, _ in updates],
                        getattr(updates, "col_cache", None),
                    )
            except Exception:
                if self.graph.terminate_on_error:
                    raise
                result = None
            if result is not None:
                rows_out, out_cache = result
                batch = UpdateBatch(zip(keys, rows_out, itertools.repeat(1)))
                batch.col_cache = out_cache
                self.emit(batch, time)
                return
            batch_failed = True  # don't re-scan the same batch below
        out: list[Update] = []
        inserts = [(k, r) for k, r, d in updates if d > 0]
        retracts = [(k, r) for k, r, d in updates if d < 0]
        # retractions first: replay memo or recompute
        for key, row in retracts:
            if not self.deterministic and key in self.memo:
                out.append((key, self.memo.pop(key), -1))
            else:
                # recomputing to retract must not re-report the failure:
                # the insert already logged it once
                out.append((key, self._eval_row(key, row, time, report=False), -1))
        if inserts:
            rows_out = None
            if self.batch_eval is not None and not batch_failed:
                try:
                    # None = "batch not cleanly typed / has error rows":
                    # re-evaluate per row, which has exact null/error
                    # routing semantics
                    with ROW_TRACES.bind([k for k, _ in inserts]):
                        result = self.batch_eval(
                            [k for k, _ in inserts], [r for _, r in inserts]
                        )
                    rows_out = result[0] if result is not None else None
                except Exception:
                    if self.graph.terminate_on_error:
                        raise
                    rows_out = None
            if rows_out is None:
                rows_out = [self._eval_row(k, r, time) for k, r in inserts]
            for (key, _), orow in zip(inserts, rows_out):
                if not self.deterministic:
                    self.memo[key] = orow
                out.append((key, orow, 1))
        self.emit(out, time)

    def _eval_row(self, key, row, time, report: bool = True):
        with ROW_TRACES.bind((key,)):
            return self._eval_row_exprs(key, row, report)

    def _eval_row_exprs(self, key, row, report: bool):
        out = []
        for e in self.exprs:
            try:
                out.append(e(key, row))
            except Exception as exc:
                # an ERROR among the slots THIS expression reads means a
                # propagated upstream failure — stay silent; anything
                # else is a fresh failure and gets reported (abort, or
                # log + ERROR cell — graph.rs error routing)
                if not report or _error_operand(e, row):
                    out.append(ERROR)
                else:
                    out.append(self.graph.report_row_error(self, exc))
        return tuple(out)


class FilterNode(Node):
    def __init__(
        self,
        graph,
        pred: Callable,
        name: str = "Filter",
        batch_pred: Callable | None = None,
    ):
        super().__init__(graph, name)
        self.pred = pred
        self.batch_pred = batch_pred  # (keys, rows) -> list[bool] | None

    def process(self, time):
        updates = self.take()
        if not updates:
            return
        if self.batch_pred is not None:
            cache = getattr(updates, "col_cache", None)
            mask = self.batch_pred(
                [k for k, _, _ in updates], [r for _, r, _ in updates], cache
            )
            if mask is not None:
                out = UpdateBatch(
                    itertools.compress(updates, mask.tolist())
                )
                if cache:
                    # slice the cached columns through the same mask so
                    # they stay row-aligned for downstream consumers
                    out.col_cache = {
                        i: a[mask]
                        for i, a in cache.items()
                        if isinstance(a, np.ndarray)
                    }
                self.emit(out, time)
                return
        out = []
        for key, row, diff in updates:
            try:
                keep = self.pred(key, row)
            except Exception as exc:
                # retraction re-evaluation must not re-report (the insert
                # already did); ERROR operands silently fail the filter
                if diff < 0 or _error_operand(self.pred, row):
                    keep = False
                else:
                    self.graph.report_row_error(self, exc)
                    keep = False
            if keep is True:
                out.append((key, row, diff))
        self.emit(out, time)


class ConcatNode(Node):
    """concat_tables (universes must be pairwise disjoint — checked)."""

    def __init__(self, graph, n_inputs: int, check_disjoint: bool = True):
        self.n_inputs = n_inputs
        super().__init__(graph, "Concat")
        self.owners: dict[int, int] = {}
        self.check = check_disjoint
        self._snap_attrs = ("owners",)

    def route_owner(self, key, row, port, n_shards):
        return shard_of(key, n_shards)

    def process(self, time):
        out = []
        for port in range(self.n_inputs):
            for key, row, diff in self.take(port):
                if self.check:
                    owner = self.owners.get(key)
                    if diff < 0:
                        if owner == port:
                            del self.owners[key]
                    elif owner is None:
                        self.owners[key] = port
                    elif owner != port:
                        raise EngineError(
                            f"concat: duplicate key {Pointer(key)} from inputs {owner} and {port}",
                            node=self,
                        )
                out.append((key, row, diff))
        self.emit(out, time)


class ReindexNode(Node):
    """reindex_table / with_id_from: re-key rows with key_fn(key, row)."""

    def __init__(self, graph, key_fn: Callable, name: str = "Reindex"):
        super().__init__(graph, name)
        self.key_fn = key_fn

    def process(self, time):
        out = [(self.key_fn(k, r), r, d) for k, r, d in self.take()]
        self.emit(out, time)


class FlattenNode(Node):
    """flatten_table (graph.rs flatten): expand an iterable column; new
    keys ref_scalar(key, i) — deterministic so retractions re-expand."""

    def __init__(self, graph, col: int):
        super().__init__(graph, "Flatten")
        self.col = col

    def process(self, time):
        out = []
        for key, row, diff in self.take():
            v = row[self.col]
            if v is None:
                continue
            if isinstance(v, (str, bytes)):
                items = list(v)
            elif isinstance(v, np.ndarray):
                items = list(v)
            else:
                try:
                    items = list(v)
                except TypeError:
                    raise EngineError(
                        f"flatten: value {v!r} is not iterable", node=self
                    )
            for i, item in enumerate(items):
                nk = ref_scalar(Pointer(key), i)
                out.append((nk, row[: self.col] + (item,) + row[self.col + 1 :], diff))
        self.emit(out, time)


class KeysOnlyNode(Node):
    """Project a table to its key set (row = ())."""

    def __init__(self, graph):
        super().__init__(graph, "Keys")

    def process(self, time):
        self.emit([(k, (), d) for k, _, d in self.take()], time)


class _KeyedStateNode(Node):
    """Helper base: maintains `self.state[port]: dict key -> row` and the
    last emitted output per key, recomputing affected keys per epoch."""

    def __init__(self, graph, n_inputs: int, name: str):
        self.n_inputs = n_inputs
        super().__init__(graph, name)
        self.state: list[dict[int, tuple]] = [dict() for _ in range(n_inputs)]
        self.pending: dict[tuple, list] = {}  # out-of-order versions per (port, key): apply_keyed
        self.emitted: dict[int, tuple] = {}
        self._snap_attrs = ("state", "pending", "emitted")

    def route_owner(self, key, row, port, n_shards):
        return shard_of(key, n_shards)

    def process(self, time):
        affected: set[int] = set()
        for port in range(self.n_inputs):
            for key, row, diff in self.take(port):
                affected.add(key)
                apply_keyed(self.state[port], self.pending, (port, key), key, row, diff)
        out = []
        for key in affected:
            new_row = self.compute_key(key)
            old_row = self.emitted.get(key)
            if old_row is not None and (new_row is None or not rows_equal(old_row, new_row)):
                out.append((key, old_row, -1))
                del self.emitted[key]
            if new_row is not None and (old_row is None or not rows_equal(old_row, new_row)):
                out.append((key, new_row, 1))
                self.emitted[key] = new_row
        self.emit(out, time)

    def compute_key(self, key: int) -> tuple | None:
        raise NotImplementedError


class UpdateRowsNode(_KeyedStateNode):
    """update_rows_table (graph.rs update_rows_table): right overrides left."""

    def __init__(self, graph):
        super().__init__(graph, 2, "UpdateRows")

    def compute_key(self, key):
        r = self.state[1].get(key)
        return r if r is not None else self.state[0].get(key)


class UpdateCellsNode(_KeyedStateNode):
    """update_cells_table: right overrides selected columns of left.
    col_map: list of (left_col_index, right_col_index)."""

    def __init__(self, graph, col_map: list[tuple[int, int]]):
        super().__init__(graph, 2, "UpdateCells")
        self.col_map = col_map

    def compute_key(self, key):
        l = self.state[0].get(key)
        if l is None:
            return None
        r = self.state[1].get(key)
        if r is None:
            return l
        row = list(l)
        for li, ri in self.col_map:
            row[li] = r[ri]
        return tuple(row)


class IntersectNode(_KeyedStateNode):
    """intersect_tables: left rows restricted to keys present in all other
    inputs."""

    def __init__(self, graph, n_inputs: int):
        super().__init__(graph, n_inputs, "Intersect")

    def compute_key(self, key):
        for port in range(1, self.n_inputs):
            if key not in self.state[port]:
                return None
        return self.state[0].get(key)


class SubtractNode(_KeyedStateNode):
    """subtract_table: left keys minus right keys."""

    def __init__(self, graph):
        super().__init__(graph, 2, "Subtract")

    def compute_key(self, key):
        if key in self.state[1]:
            return None
        return self.state[0].get(key)


class HavingNode(IntersectNode):
    pass


class GroupByNode(Node):
    """group_by_table (dataflow.rs:2991): re-key by grouping values, apply
    reducers. Semigroup reducers update O(1); general reducers recompute
    per touched group from its keyed state (reduce.rs:40-61 two-tier
    strategy)."""

    def __init__(
        self,
        graph,
        group_key_fn: Callable,  # (key, row) -> group key (int)
        reducer_specs: list[tuple[Reducer, Callable]],  # (reducer, args_fn(key,row)->tuple)
        batch_prep: Callable | None = None,
        # (keys, rows) -> (gks, spec_cols | None, make_args_rows) | None
    ):
        super().__init__(graph, "GroupBy")
        self.group_key_fn = group_key_fn
        self.specs = reducer_specs
        # columnar fast path: group keys + reducer args for a whole delta
        # batch at once (vectorized exprs + batched ref_scalar); returns
        # None for batches it cannot type cleanly
        self.batch_prep = batch_prep
        self._needs_time = [getattr(r, "needs_time", False) for r, _ in reducer_specs]
        self.all_semigroup = all(r.is_semigroup for r, _ in reducer_specs)
        # LIGHT state: when every reducer is a semigroup AND the args are
        # vectorizable (hence deterministic), retractions recompute their
        # args instead of replaying stored ones, so per-group state is
        # just the member-key set — no per-key args are kept. HEAVY
        # state keeps gk -> key -> per-reducer args for general reducers.
        self._light = batch_prep is not None and self.all_semigroup
        self._can_fold = (
            self._light
            and all(hasattr(r, "fold_batch") for r, _ in reducer_specs)
            and not any(self._needs_time)
        )
        self.groups: dict[int, Any] = {}  # gk -> key set (light) | key->args dict
        self.sg_state: dict[int, list[Any]] = {}
        self.emitted: dict[int, tuple] = {}
        self._snap_attrs = ("groups", "sg_state", "emitted")

    def snapshot_signature(self):
        return (
            super().snapshot_signature(),
            tuple(type(r).__name__ for r, _fns in self.specs),
            self._light,
        )

    def route_owner(self, key, row, port, n_shards):
        # exchange on the GROUP key: all rows of a group reduce on one
        # shard (reference group_by_table ShardPolicy, dataflow.rs:2991)
        return shard_of(self.group_key_fn(key, row), n_shards)

    def process(self, time):
        updates = self.take()
        if not updates:
            return
        prepped = None
        if self.batch_prep is not None:
            prepped = self.batch_prep(
                [k for k, _, _ in updates],
                [r for _, r, _ in updates],
                getattr(updates, "col_cache", None),
            )
        if prepped is not None and self._can_fold and prepped[1] is not None:
            self._process_folded(updates, prepped[0], prepped[1], time)
            return
        affected: set[int] = set()
        any_time = any(self._needs_time)
        args_rows = None
        if prepped is not None:
            gks = prepped[0]
            try:
                args_rows = prepped[2]()
            except Exception:
                args_rows = None  # untyped arg columns: per-row path
        light = self._light
        for i, (key, row, diff) in enumerate(updates):
            if args_rows is not None:
                gk = gks[i]
                args_list = args_rows[i]
                if any_time:
                    args_list = [
                        ((time,) + a) if nt else a
                        for nt, a in zip(self._needs_time, args_list)
                    ]
            else:
                gk = self.group_key_fn(key, row)
                args_list = [
                    ((time,) + tuple(args_fn(key, row)) if getattr(red, "needs_time", False) else tuple(args_fn(key, row)))
                    for red, args_fn in self.specs
                ]
            affected.add(gk)
            grp = self.groups.get(gk)
            if grp is None:
                grp = self.groups[gk] = set() if light else {}
                self.sg_state[gk] = [r.init_state() if r.is_semigroup else None for r, _ in self.specs]
            if light:
                # deterministic args: retracts recompute instead of replay
                if diff > 0:
                    grp.add(key)
                else:
                    grp.discard(key)
                    if not grp:
                        del self.groups[gk]
            elif diff > 0:
                grp[key] = args_list
            else:
                stored = grp.pop(key, None)
                if stored is not None:
                    args_list = stored  # replay stored args for exact retract
                if not grp:
                    del self.groups[gk]
            sg = self.sg_state.get(gk)
            if sg is not None:
                for si, (red, _) in enumerate(self.specs):
                    if red.is_semigroup:
                        sg[si] = red.add(sg[si], args_list[si], diff)
                if gk not in self.groups:
                    del self.sg_state[gk]
        self._emit_affected(affected, time)

    def _process_folded(self, updates, gks, spec_cols, time):
        """Whole-batch columnar aggregation: group rows with np.unique,
        fold each semigroup reducer over the batch (reduce.rs semigroup
        path, vectorized), update member-key sets per group slice."""
        n = len(updates)
        gk_arr = np.asarray(gks, dtype=np.uint64)
        uniq, inv = np.unique(gk_arr, return_inverse=True)
        ug = [int(u) for u in uniq]
        groups = self.groups
        sg_state = self.sg_state
        for g in ug:
            if g not in groups:
                groups[g] = set()
                sg_state[g] = [r.init_state() for r, _ in self.specs]
        all_inserts = not any(d <= 0 for _, _, d in updates)
        # diffs=None means "all +1" for the reducer folds
        diffs = (
            None
            if all_inserts
            else np.fromiter((d for _, _, d in updates), np.int64, n)
        )
        order = np.argsort(inv, kind="stable")
        sorted_inv = inv[order]
        bounds = np.searchsorted(sorted_inv, np.arange(len(ug) + 1))
        if all_inserts:
            try:
                karr = np.fromiter((k for k, _, _ in updates), np.uint64, n)
            except (OverflowError, TypeError, ValueError):
                karr = None
            if karr is not None:
                for j, g in enumerate(ug):
                    groups[g].update(
                        karr[order[bounds[j] : bounds[j + 1]]].tolist()
                    )
            else:
                for (key, _, _), gk in zip(updates, gks):
                    groups[gk].add(key)
        else:
            for (key, _, diff), gk in zip(updates, gks):
                if diff > 0:
                    groups[gk].add(key)
                else:
                    groups[gk].discard(key)
        for si, (red, _) in enumerate(self.specs):
            states = [sg_state[g][si] for g in ug]
            red.fold_batch(states, spec_cols[si], inv, diffs)
            for j, g in enumerate(ug):
                sg_state[g][si] = states[j]
        for g in ug:
            if not groups[g]:
                del groups[g]
                del sg_state[g]
        self._emit_affected(ug, time)

    def _emit_affected(self, affected, time):
        out = []
        for gk in affected:
            grp = self.groups.get(gk)
            if grp:
                if self._light:
                    new_row = tuple(
                        red.extract(self.sg_state[gk][i])
                        for i, (red, _) in enumerate(self.specs)
                    )
                else:
                    new_row = tuple(
                        red.extract(self.sg_state[gk][i])
                        if red.is_semigroup
                        else red.compute([argv[i] for argv in grp.values()])
                        for i, (red, _) in enumerate(self.specs)
                    )
            else:
                new_row = None
            old_row = self.emitted.get(gk)
            if old_row is not None and (new_row is None or not rows_equal(old_row, new_row)):
                out.append((gk, old_row, -1))
                del self.emitted[gk]
            if new_row is not None and (old_row is None or not rows_equal(old_row, new_row)):
                out.append((gk, new_row, 1))
                self.emitted[gk] = new_row
        self.emit(out, time)


class DeduplicateNode(Node):
    """Graph::deduplicate (stateful_reduce.rs): per instance keep the
    previously accepted row; `acceptor(new_row, old_row) -> bool` decides
    replacement. Input expected append-only (as in the reference)."""

    def __init__(self, graph, instance_fn: Callable, acceptor: Callable):
        super().__init__(graph, "Deduplicate")
        self.instance_fn = instance_fn
        self.acceptor = acceptor
        self.accepted: dict[Any, tuple[int, tuple]] = {}
        self._snap_attrs = ("accepted",)

    def route_owner(self, key, row, port, n_shards):
        return shard_of_value(self.instance_fn(key, row), n_shards)

    def process(self, time):
        out = []
        for key, row, diff in self.take():
            if diff <= 0:
                continue
            inst = self.instance_fn(key, row)
            old = self.accepted.get(inst)
            if old is None:
                ok = self.acceptor(row, None)
            else:
                ok = self.acceptor(row, old[1])
            if ok:
                ik = inst if isinstance(inst, (int, np.integer)) else ref_scalar(inst)
                if old is not None:
                    out.append((ik, old[1], -1))
                self.accepted[inst] = (key, row)
                out.append((ik, row, 1))
        self.emit(out, time)


class JoinNode(Node):
    """join_tables. Output row = left_row + right_row + (left_key|None,
    right_key|None); unmatched sides padded with None (left/right/outer).
    Per touched join-key, old-vs-new output diffing keeps all four join
    types in one code path."""

    n_inputs = 2

    def __init__(
        self,
        graph,
        left_jk_fn: Callable,   # (key, row) -> hashable join key
        right_jk_fn: Callable,
        left_width: int,
        right_width: int,
        how: str = "inner",     # inner | left | right | outer
        id_fn: Callable | None = None,  # (lkey|None, rkey|None) -> out key
        exact_match: bool = False,  # error on unmatched left (ix strict mode)
    ):
        super().__init__(graph, "Join")
        self.left_jk_fn = left_jk_fn
        self.right_jk_fn = right_jk_fn
        self.lw = left_width
        self.rw = right_width
        self.how = how
        self.id_fn = id_fn or (lambda lk, rk: ref_scalar(
            None if lk is None else Pointer(lk), None if rk is None else Pointer(rk)
        ))
        self.exact_match = exact_match
        self.left: dict[Any, dict[int, tuple]] = {}
        self.right: dict[Any, dict[int, tuple]] = {}
        # out-of-order versions per (side, join key, row key): apply_keyed
        self.pending: dict[tuple, list] = {}
        self._snap_attrs = ("left", "right", "pending")

    def snapshot_signature(self):
        return (super().snapshot_signature(), self.how, self.lw, self.rw)

    def route_owner(self, key, row, port, n_shards):
        jk = self.left_jk_fn(key, row) if port == 0 else self.right_jk_fn(key, row)
        return shard_of_value(jk, n_shards)

    def _outputs_for(self, jk) -> dict[int, tuple]:
        out: dict[int, tuple] = {}
        lhs = self.left.get(jk, {})
        rhs = self.right.get(jk, {})
        if lhs and rhs:
            for lk, lrow in lhs.items():
                for rk, rrow in rhs.items():
                    out[self.id_fn(lk, rk)] = lrow + rrow + (Pointer(lk), Pointer(rk))
        elif lhs and self.how in ("left", "outer"):
            for lk, lrow in lhs.items():
                out[self.id_fn(lk, None)] = lrow + (None,) * self.rw + (Pointer(lk), None)
        elif rhs and self.how in ("right", "outer"):
            for rk, rrow in rhs.items():
                out[self.id_fn(None, rk)] = (None,) * self.lw + rrow + (None, Pointer(rk))
        return out

    def process(self, time):
        lups = self.take(0)
        rups = self.take(1)
        if not lups and not rups:
            return
        affected: set = set()
        staged: list[tuple[int, Any, int, tuple, int]] = []
        for key, row, diff in lups:
            jk = self.left_jk_fn(key, row)
            if jk is None:
                continue
            affected.add(jk)
            staged.append((0, jk, key, row, diff))
        for key, row, diff in rups:
            jk = self.right_jk_fn(key, row)
            if jk is None:
                continue
            affected.add(jk)
            staged.append((1, jk, key, row, diff))
        old_out: dict[Any, dict[int, tuple]] = {jk: self._outputs_for(jk) for jk in affected}
        for side, jk, key, row, diff in staged:
            idx = self.left if side == 0 else self.right
            bucket = idx.setdefault(jk, {})
            apply_keyed(bucket, self.pending, (side, jk, key), key, row, diff)
            if not bucket:
                idx.pop(jk, None)
        out: list[Update] = []
        for jk in affected:
            old = old_out[jk]
            new = self._outputs_for(jk)
            for ok, orow in old.items():
                nrow = new.get(ok)
                if nrow is None or not rows_equal(orow, nrow):
                    out.append((ok, orow, -1))
            for ok, nrow in new.items():
                orow = old.get(ok)
                if orow is None or not rows_equal(orow, nrow):
                    out.append((ok, nrow, 1))
            if self.exact_match and self.left.get(jk) and not self.right.get(jk):
                raise EngineError(
                    f"ix: key {jk!r} missing in indexed table", node=self
                )
        self.emit(out, time)


class AsofNowJoinNode(JoinNode):
    """asof_now_join: each left row matches the right side AS OF its
    arrival epoch and is never retroactively updated when the right side
    changes (reference stdlib/temporal/_asof_now_join.py; same asof-now
    semantics as use_external_index_as_of_now). Left retractions retract
    exactly what was emitted."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.how not in ("inner", "left"):
            raise ValueError(
                "asof_now_join supports how='inner'/'left' (matching the "
                "reference); right/outer would need retroactive updates"
            )
        # distinct name: a persisted JoinNode snapshot must NOT restore
        # into this node (frozen would stay empty → missed retractions)
        self.name = "AsofNowJoin"
        self.stats.name = self.name
        # left key -> (input_row, [(out_key, out_row)]): the input row
        # disambiguates which version a late retraction refers to
        self.frozen: dict[int, tuple] = {}
        self._snap_attrs = ("right", "pending", "frozen")  # left side is never stored

    def process(self, time):
        out: list[Update] = []
        # right side first: this epoch's queries see this epoch's state
        for key, row, diff in self.take(1):
            jk = self.right_jk_fn(key, row)
            if jk is None:
                continue
            bucket = self.right.setdefault(jk, {})
            apply_keyed(bucket, self.pending, (1, jk, key), key, row, diff)
            if not bucket:
                self.right.pop(jk, None)
        for key, row, diff in self.take(0):
            cur = self.frozen.get(key)
            if diff < 0:
                # only retract if this -1 refers to the version we hold:
                # a +1 replacement earlier in the batch already retracted
                # (and superseded) the old outputs
                if cur is not None and rows_equal(cur[0], row):
                    del self.frozen[key]
                    for ok, orow in cur[1]:
                        out.append((ok, orow, -1))
                continue
            # an upsert may deliver the +1 before its -1 within a batch:
            # retract whatever this key previously emitted first
            if cur is not None:
                for ok, orow in cur[1]:
                    out.append((ok, orow, -1))
            jk = self.left_jk_fn(key, row)
            matches = list(self.right.get(jk, {}).items()) if jk is not None else []
            outs: list[Update] = []
            if matches:
                for rk, rrow in matches:
                    ok = self.id_fn(key, rk)
                    outs.append((int(ok), row + rrow + (Pointer(key), Pointer(rk)), 1))
            elif self.how == "left":
                ok = self.id_fn(key, None)
                outs.append(
                    (int(ok), row + (None,) * self.rw + (Pointer(key), None), 1)
                )
            self.frozen[key] = (row, [(ok, orow) for ok, orow, _ in outs])
            out.extend(outs)
        self.emit(out, time)


class SortNode(Node):
    """sort_table → prev/next pointer columns (reference
    operators/prev_next.rs over bidirectional traces; here: per-instance
    sorted order recomputed for touched instances, diffed against last
    emitted neighbors)."""

    def __init__(self, graph, key_fn: Callable, instance_fn: Callable):
        super().__init__(graph, "Sort")
        self.key_fn = key_fn
        self.instance_fn = instance_fn
        self.rows: dict[int, tuple[Any, Any]] = {}  # key -> (instance, sort_key)
        self.instances: dict[Any, dict[int, Any]] = {}  # inst -> key -> sort_key
        self.emitted: dict[int, tuple[Any, tuple]] = {}  # key -> (inst, (prev, next))
        self._snap_attrs = ("rows", "instances", "emitted")

    def route_owner(self, key, row, port, n_shards):
        return shard_of_value(self.instance_fn(key, row), n_shards)

    def process(self, time):
        updates = self.take()
        if not updates:
            return
        touched: set = set()
        for key, row, diff in updates:
            inst = self.instance_fn(key, row)
            sk = self.key_fn(key, row)
            touched.add(inst)
            if diff > 0:
                self.rows[key] = (inst, sk)
                self.instances.setdefault(inst, {})[key] = sk
            else:
                self.rows.pop(key, None)
                b = self.instances.get(inst)
                if b is not None:
                    b.pop(key, None)
                    if not b:
                        del self.instances[inst]
        out = []
        for inst in touched:
            members = self.instances.get(inst, {})
            ordered = sorted(members.items(), key=lambda kv: (kv[1], kv[0]))
            n = len(ordered)
            new_neighbors: dict[int, tuple] = {}
            for i, (key, _) in enumerate(ordered):
                prev_k = Pointer(ordered[i - 1][0]) if i > 0 else None
                next_k = Pointer(ordered[i + 1][0]) if i < n - 1 else None
                new_neighbors[key] = (prev_k, next_k)
            # retract neighbors of keys that left this instance
            for key, (e_inst, e_nbr) in list(self.emitted.items()):
                if e_inst == inst and key not in members:
                    out.append((key, e_nbr, -1))
                    del self.emitted[key]
            for key, nbr in new_neighbors.items():
                old = self.emitted.get(key)
                if old is not None and old[1] != nbr:
                    out.append((key, old[1], -1))
                if old is None or old[1] != nbr:
                    out.append((key, nbr, 1))
                    self.emitted[key] = (inst, nbr)
        self.emit(out, time)


class BufferNode(Node):
    """Graph::buffer (operators/time_column.rs postpone_core): hold rows
    until the event-time watermark (max observed time_fn value) reaches
    threshold_fn(row). The reference compares against the time column's
    frontier; here the watermark advances at epoch boundaries."""

    def __init__(
        self,
        graph,
        threshold_fn: Callable,
        time_fn: Callable | None = None,
        flush_on_end: bool = True,
    ):
        super().__init__(graph, "Buffer")
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        self.pending: dict[int, tuple[Any, tuple]] = {}
        self.released: set[int] = set()
        self.flush_on_end = flush_on_end
        self.watermark: Any = None
        self._snap_attrs = ("pending", "released", "watermark")

    def route_owner(self, key, row, port, n_shards):
        return shard_of(key, n_shards)

    def _advance_watermark(self, key, row):
        if self.time_fn is None:
            return
        t = self.time_fn(key, row)
        if t is not None and (self.watermark is None or t > self.watermark):
            self.watermark = t

    def process(self, time):
        out = []
        for key, row, diff in self.take():
            self._advance_watermark(key, row)
            if key in self.released:
                out.append((key, row, diff))
                if diff < 0:
                    self.released.discard(key)
                continue
            if diff > 0:
                thr = self.threshold_fn(key, row)
                wm = self.watermark if self.time_fn is not None else time
                if thr is not None and (wm is None or thr > wm):
                    self.pending[key] = (thr, row)
                else:
                    self.released.add(key)
                    out.append((key, row, diff))
            else:
                if key in self.pending:
                    del self.pending[key]
                else:
                    out.append((key, row, diff))
        # release newly-eligible rows in the same epoch
        self._release(time)
        self.emit(out, time)

    def _release(self, time):
        wm = self.watermark if self.time_fn is not None else time
        out = []
        for key in list(self.pending):
            thr, row = self.pending[key]
            if wm is not None and thr <= wm:
                del self.pending[key]
                self.released.add(key)
                out.append((key, row, 1))
        if out:
            self.emit(out, time)

    def on_frontier(self, frontier):
        if frontier == INF_TIME:
            if not self.flush_on_end:
                return
            out = []
            for key in list(self.pending):
                thr, row = self.pending.pop(key)
                self.released.add(key)
                out.append((key, row, 1))
            if out:
                self.emit(out, self.graph.current_time)
        elif self.time_fn is None:
            self._release(frontier)


class ForgetNode(Node):
    """Graph::forget (time_column.rs ignore_late): retract rows once the
    watermark passes threshold_fn(row); drop late arrivals. With
    mark_forgetting_records=False, downstream state is compacted; the
    logical output (with keep_results) re-adds retracted results."""

    def __init__(
        self,
        graph,
        threshold_fn: Callable,
        time_fn: Callable | None = None,
        mark_forgetting_records: bool = False,
    ):
        super().__init__(graph, "Forget")
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        self.live: dict[int, tuple[Any, tuple]] = {}
        self.watermark: Any = None
        self._snap_attrs = ("live", "watermark")

    def route_owner(self, key, row, port, n_shards):
        return shard_of(key, n_shards)

    def process(self, time):
        out = []
        for key, row, diff in self.take():
            if self.time_fn is not None:
                t = self.time_fn(key, row)
                if t is not None and (self.watermark is None or t > self.watermark):
                    self.watermark = t
            thr = self.threshold_fn(key, row)
            wm = self.watermark if self.time_fn is not None else time
            if diff > 0:
                if thr is not None and wm is not None and thr <= wm and key not in self.live:
                    continue  # late arrival, drop
                self.live[key] = (thr, row)
                out.append((key, row, 1))
            else:
                if key in self.live:
                    del self.live[key]
                    out.append((key, row, -1))
        # forget rows that fell behind the watermark
        wm = self.watermark if self.time_fn is not None else time
        if wm is not None:
            for key in list(self.live):
                thr, row = self.live[key]
                if thr is not None and thr <= wm:
                    del self.live[key]
                    out.append((key, row, -1))
        self.emit(out, time)


class FreezeNode(Node):
    """Graph::freeze: once the watermark passes threshold, changes to the
    row are ignored."""

    _snap_attrs = ("watermark",)

    def __init__(self, graph, threshold_fn: Callable, time_fn: Callable | None = None):
        super().__init__(graph, "Freeze")
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        self.watermark: Any = None

    def process(self, time):
        out = []
        for key, row, diff in self.take():
            if self.time_fn is not None:
                t = self.time_fn(key, row)
                if t is not None and (self.watermark is None or t > self.watermark):
                    self.watermark = t
            thr = self.threshold_fn(key, row)
            wm = self.watermark if self.time_fn is not None else time
            if thr is not None and wm is not None and thr <= wm:
                continue
            out.append((key, row, diff))
        self.emit(out, time)


class GradualBroadcastNode(Node):
    """gradual_broadcast (reference R15,
    src/engine/dataflow/operators/gradual_broadcast.rs): attach an
    approximate threshold value column to every data row. The attached
    value only changes when a new threshold's value leaves the previous
    [lower, upper] band, so threshold churn does not re-emit the table."""

    n_inputs = 2  # port 0: data rows, port 1: (lower, value, upper) rows

    def __init__(self, graph, lower_i: int, value_i: int, upper_i: int):
        super().__init__(graph, "GradualBroadcast")
        self.lower_i = lower_i
        self.value_i = value_i
        self.upper_i = upper_i
        self.apx = None  # currently-attached approximate value
        self.rows: dict[int, tuple] = {}
        self.attached: dict[int, Any] = {}
        self._snap_attrs = ("apx", "rows", "attached")

    def route_owner(self, key, row, port, n_shards):
        return BROADCAST if port == 1 else None

    def process(self, time):
        out: list[Update] = []
        latest = None
        for _key, row, diff in self.take(1):
            if diff > 0:
                latest = row
        if latest is not None:
            lower, value, upper = (
                latest[self.lower_i],
                latest[self.value_i],
                latest[self.upper_i],
            )
            # rebroadcast when the ATTACHED value falls outside the NEW
            # threshold's band — checking the new value against the old
            # band instead lets a drifting threshold run away from apx
            if self.apx is None or not (lower <= self.apx <= upper):
                new_apx = value
                for k, r in self.rows.items():
                    out.append((k, r + (self.attached[k],), -1))
                    out.append((k, r + (new_apx,), 1))
                    self.attached[k] = new_apx
                self.apx = new_apx
        for key, row, diff in self.take(0):
            if diff > 0:
                self.rows[key] = row
                self.attached[key] = self.apx
                out.append((key, row + (self.apx,), 1))
            else:
                self.rows.pop(key, None)
                out.append((key, row + (self.attached.pop(key, self.apx),), -1))
        self.emit(consolidate(out), time)


class ExternalIndexNode(Node):
    """use_external_index_as_of_now / incremental index queries
    (dataflow.rs:2224, operators/external_index.rs): port 0 = index
    updates, port 1 = queries.

    asof_now=True: queries are answered against the index state as of
    arrival and never retroactively updated. asof_now=False (the
    reference's fully-incremental ``InnerIndex.query``): stored queries
    are re-answered whenever the index changes — on TPU that re-answer
    is one batched matmul+top-k over all live queries, so incremental
    correctness costs a single fused device call per epoch.

    The index object implements add(key, payload, metadata) /
    remove(key) / search_batch(payloads, k, filter_fns). Optional
    data_embed/query_embed callables batch-map raw payloads (texts) to
    vectors once per epoch — this is where jit-batched encoders plug in.
    ``result_fn(matches, data_rows)`` shapes the reply columns (matched
    data values come from the node's own data-row mirror — the repack
    join the reference does in Python, done here in-operator)."""

    n_inputs = 2

    def __init__(
        self,
        graph,
        index,
        data_fn: Callable,    # (key, row) -> (payload, metadata)
        query_fn: Callable,   # (key, row) -> (payload, k, filter_str)
        result_fn: Callable,  # (list[(key, score)], data_rows: dict) -> tuple of column values
        filter_compiler: Callable | None = None,
        query_proj: Callable | None = None,  # (key, row) -> output row prefix
        data_embed: Callable | None = None,   # list[payload] -> list[vector]
        query_embed: Callable | None = None,
        asof_now: bool = True,
        name: str = "ExternalIndex",
    ):
        super().__init__(graph, name)
        self.index = index
        self.data_fn = data_fn
        self.query_fn = query_fn
        self.result_fn = result_fn
        self.query_proj = query_proj
        self.data_embed = data_embed
        self.query_embed = query_embed
        self.asof_now = asof_now
        self.filter_compiler = filter_compiler
        self._filter_cache: dict[str, Callable | None] = {}
        self.data_rows: dict[int, tuple] = {}
        self.answered: dict[int, tuple] = {}
        # incremental mode: live query store key -> (prefix, payload, k, flt)
        self.queries: dict[int, tuple] = {}

    def route_owner(self, key, row, port, n_shards):
        return 0  # pinned: device-side sharding lives in ops/knn, not here

    # the index itself holds device arrays — snapshot the host-side row
    # mirror and rebuild the index from it on restore. Tiered indexes
    # (ops/tiered_knn.py) additionally persist their tier layout:
    # centroid table, per-key cluster assignment, and the hot-resident
    # set, so recovery restores the EXACT tier assignment.

    def snapshot_state(self):
        state = {
            "data_rows": self.data_rows,
            "answered": self.answered,
            "queries": self.queries,
        }
        tier_state = getattr(self.index, "tier_state", None)
        if tier_state is not None:
            state["index_tiers"] = tier_state()
        return state

    def restore_state(self, state) -> None:
        self.data_rows = state["data_rows"]
        self.answered = state["answered"]
        self.queries = state["queries"]
        tiers = state.get("index_tiers")
        restore_tiers = getattr(self.index, "restore_tier_state", None)
        if tiers is not None and restore_tiers is not None:
            # install BEFORE the re-add so replayed rows land in their
            # snapshotted clusters (cold), then promote the hot set
            restore_tiers(tiers)
        # re-embed and re-add through the same path as live ingest: on the
        # card the encoder (B1) and the index's device add (B2's slab)
        self._index_add([(k, *self.data_fn(k, r)) for k, r in self.data_rows.items()])
        if tiers is not None and restore_tiers is not None:
            self.index.finish_tier_restore()

    def _index_add(self, adds) -> None:
        """Embed (optionally) and insert (key, payload, metadata) triples."""
        if not adds:
            return
        payloads = [p for _, p, _ in adds]
        if self.data_embed is not None:
            payloads = self.data_embed(payloads)
        import sys

        _torch = sys.modules.get("torch")  # never import torch for pure-ETL graphs
        if (
            _torch is not None
            and isinstance(payloads, _torch.Tensor)
            and hasattr(self.index, "add_batch_device")
        ):
            # device-resident ingest: the embedder's output stays on the
            # card and is scattered straight into the index matrix — no
            # device->host->device bounce between encode and index-add
            self.index.add_batch_device(
                [k for k, _, _ in adds], payloads, [m for _, _, m in adds]
            )
            return
        items = [
            (key, payload, metadata)
            for (key, _, metadata), payload in zip(adds, payloads)
            if payload is not None
        ]
        if hasattr(self.index, "add_batch"):
            self.index.add_batch(items)
        else:
            for key, payload, metadata in items:
                self.index.add(key, payload, metadata)

    def _compile_filter(self, flt):
        if flt is None or self.filter_compiler is None:
            return None
        if flt not in self._filter_cache:
            if len(self._filter_cache) >= 4096:  # bound per-query filter churn
                self._filter_cache.clear()
            self._filter_cache[flt] = self.filter_compiler(flt)
        return self._filter_cache[flt]

    def process(self, time):
        index_changed = False
        adds: list[tuple[int, Any, Any]] = []
        for key, row, diff in self.take(0):
            if diff > 0:
                payload, metadata = self.data_fn(key, row)
                adds.append((key, payload, metadata))
                self.data_rows[key] = row
            else:
                self.index.remove(key)
                self.data_rows.pop(key, None)
                index_changed = True
        if adds:
            self._index_add(adds)
            index_changed = True

        out: list[Update] = []
        new_queries: list[tuple[int, tuple, Any, int, Any]] = []
        for key, row, diff in self.take(1):
            if diff > 0:
                payload, k, flt = self.query_fn(key, row)
                prefix = self.query_proj(key, row) if self.query_proj else row
                new_queries.append((key, prefix, payload, int(k), flt))
            else:
                self.queries.pop(key, None)
                orow = self.answered.pop(key, None)
                if orow is not None:
                    out.append((key, orow, -1))
        if new_queries and self.query_embed is not None:
            with ROW_TRACES.bind([q[0] for q in new_queries]):
                embedded = self.query_embed([q[2] for q in new_queries])
            new_queries = [
                (k, pre, emb, kk, flt)
                for (k, pre, _, kk, flt), emb in zip(new_queries, embedded)
            ]

        if self.asof_now:
            to_answer = new_queries
        else:
            for key, prefix, payload, k, flt in new_queries:
                self.queries[key] = (prefix, payload, k, flt)
            if index_changed:
                to_answer = [
                    (key, pre, pay, k, flt)
                    for key, (pre, pay, k, flt) in self.queries.items()
                ]
            else:
                to_answer = new_queries

        # batch queries by k so each group is one device top-k call
        by_k: dict[int, list[int]] = {}
        for i, (_, _, _, k, _) in enumerate(to_answer):
            by_k.setdefault(k, []).append(i)
        replies: list[Any] = [None] * len(to_answer)
        for k, idxs in by_k.items():
            payloads = [to_answer[i][2] for i in idxs]
            filter_fns = [self._compile_filter(to_answer[i][4]) for i in idxs]
            with ROW_TRACES.bind([to_answer[i][0] for i in idxs]):
                matches = self.index.search_batch(payloads, k, filter_fns)
            for i, m in zip(idxs, matches):
                replies[i] = m
        for (key, prefix, _, _, _), matches in zip(to_answer, replies):
            orow = prefix + self.result_fn(matches or [], self.data_rows)
            old = self.answered.get(key)
            if old is not None:
                if rows_equal(old, orow):
                    continue
                out.append((key, old, -1))
            self.answered[key] = orow
            out.append((key, orow, 1))
        # tiered indexes rebalance on the epoch pipeline: promotion /
        # demotion work rides the epoch boundary, never a query
        rebalance = getattr(self.index, "maybe_rebalance", None)
        if rebalance is not None and (index_changed or to_answer):
            rebalance()
        self.emit(out, time)


class OutputNode(Node):
    """output_table/subscribe_table: consolidated, time-ordered delivery
    (operators/output.rs ConsolidateForOutput)."""

    def __init__(
        self,
        graph,
        on_change: Callable | None = None,   # (key, row, time, diff)
        on_time_end: Callable | None = None,  # (time)
        on_end: Callable | None = None,
        sort_by_key: bool = True,
    ):
        super().__init__(graph, "Output")
        self.on_change = on_change
        self.on_time_end_cb = on_time_end
        self.on_end_cb = on_end
        self.sort_by_key = sort_by_key
        self._saw_data = False
        self._epoch_buf: list[Update] = []

    def route_owner(self, key, row, port, n_shards):
        return 0  # single consolidated, time-ordered sink stream

    def process(self, time):
        # buffer until the epoch closes: multi-wave sharded sweeps (and
        # back-edge re-passes) may deliver transient partial states that
        # consolidation at time_end cancels out — sinks must only see
        # the epoch's net changes (ConsolidateForOutput, operators/
        # output.rs:27)
        updates = self.take()
        if updates:
            self._epoch_buf.extend(updates)

    def time_end(self, time):
        # append-only sinks: every buffered update is a net insert by
        # construction, nothing can cancel — skip the consolidation probe
        updates = (
            self._epoch_buf if self.append_only else consolidate(self._epoch_buf)
        )
        self._epoch_buf = []
        # sinks are terminal: nothing is emitted downstream, so the
        # "net changes only" invariant holds structurally
        assert not self.consumers, "OutputNode is a terminal sink"
        if updates:
            self._saw_data = True
            if self.sort_by_key:
                updates = sorted(updates, key=lambda u: (u[0], u[2]))
            # recovered epochs rebuild state but are not re-delivered to
            # sinks (exactly-once across restarts)
            if self.on_change is not None and time > self.graph.replay_frontier:
                for key, row, diff in updates:
                    self.on_change(key, row, time, diff)
        if self.on_time_end_cb is not None and time > self.graph.replay_frontier:
            self.on_time_end_cb(time)

    def on_end(self):
        if self.on_end_cb is not None:
            self.on_end_cb()


class CaptureNode(Node):
    """Accumulates the final table state + full update stream (debug /
    CapturedStream equivalent, python_api.rs:3330)."""

    def __init__(self, graph):
        super().__init__(graph, "Capture")
        self.state: dict[int, tuple] = {}
        self.stream: list[tuple[int, tuple, int, int]] = []  # key,row,time,diff
        self._epoch_buf: list[Update] = []
        self._snap_attrs = ("state", "stream")

    def route_owner(self, key, row, port, n_shards):
        return 0

    def process(self, time):
        # buffered like OutputNode: only the epoch's NET changes belong
        # in the captured stream (transient partials from sharded sweeps
        # or back-edge re-passes cancel at consolidation)
        updates = self.take()
        if updates:
            self._epoch_buf.extend(updates)

    def time_end(self, time):
        updates = (
            self._epoch_buf if self.append_only else consolidate(self._epoch_buf)
        )
        self._epoch_buf = []
        for key, row, diff in updates:
            self.stream.append((key, row, int(time), diff))
            if diff > 0:
                self.state[key] = row
            else:
                self.state.pop(key, None)


class AsyncApplyNode(Node):
    """async_apply_table (graph.rs:744): batch-invoke async UDFs per epoch
    on the engine's asyncio loop; results join the stream at the same
    epoch (deterministic barrier — simpler than the reference's tokio
    futures, same observable semantics for bounded batches)."""

    def __init__(self, graph, async_fn: Callable, n_extra: int = 1, name: str = "AsyncApply"):
        super().__init__(graph, name)
        self.async_fn = async_fn  # async (key, row) -> value tuple appended to row
        self.memo: dict[int, tuple] = {}
        self._snap_attrs = ("memo",)
        # row-failure policy: "raise" (terminate_on_error routing),
        # "dead_letter" (row dropped from output, routed to the
        # dead_letter_id sessions), or "skip" (row silently dropped)
        self.on_error = "raise"
        self.dead_letter_id: int | None = None
        self.on_end_callback: Callable | None = None

    def process(self, time):
        updates = self.take()
        if not updates:
            return
        out = []
        pending = []
        for key, row, diff in updates:
            if diff < 0:
                # a dead-lettered/skipped row has no memo entry, so its
                # retraction is a no-op here too — consistent lifecycle
                orow = self.memo.pop(key, None)
                if orow is not None:
                    out.append((key, orow, -1))
            else:
                pending.append((key, row))
        if pending:
            results = self.graph.run_async_batch(self.async_fn, pending)
            for (key, row), res in zip(pending, results):
                if isinstance(res, BaseException):
                    if self.on_error == "dead_letter":
                        self.graph.report_dead_letter(
                            self.dead_letter_id, self, key, row, res
                        )
                        continue
                    if self.on_error == "skip":
                        continue
                    # failed UDF: abort, or ERROR value + error-log entry
                    res = self.graph.report_row_error(self, res)
                orow = row + (res,)
                self.memo[key] = orow
                out.append((key, orow, 1))
        self.emit(out, time)

    def on_end(self):
        # AsyncTransformer close() lifecycle hook: fires once, after the
        # final flush (run() calls on_end for every node at stream end)
        cb = self.on_end_callback
        if cb is not None:
            self.on_end_callback = None
            cb()


class BatchApplyNode(Node):
    """Columnar batch-UDF application: the whole epoch's rows go through
    ONE call of the user's batch function (chunked to max_batch_size) —
    no per-row coroutines/futures (the asyncio machinery costs more than
    tiny model dispatches; measured ~2s of pure event-loop overhead per
    30k rows on the CPU-mesh streaming bench). Same memo/retraction
    semantics as AsyncApplyNode."""

    def __init__(
        self,
        graph,
        batch_fn: Callable,
        row_args_fn: Callable,
        max_batch_size: int,
        name: str = "BatchApply",
    ):
        super().__init__(graph, name)
        self.batch_fn = batch_fn  # (arg_list, ...) -> list of results
        self.row_args_fn = row_args_fn  # (key, row) -> tuple of args
        self.max_batch_size = max(1, int(max_batch_size))
        self.memo: dict[int, tuple] = {}
        self._snap_attrs = ("memo",)
        # same row-failure policy surface as AsyncApplyNode
        self.on_error = "raise"
        self.dead_letter_id: int | None = None
        self.on_end_callback: Callable | None = None

    def process(self, time):
        updates = self.take()
        if not updates:
            return
        out = []
        pending = []
        for key, row, diff in updates:
            if diff < 0:
                orow = self.memo.pop(key, None)
                if orow is not None:
                    out.append((key, orow, -1))
            else:
                pending.append((key, row))
        prof = self.graph.profiler
        for lo in range(0, len(pending), self.max_batch_size):
            chunk = pending[lo : lo + self.max_batch_size]
            arg_cols = list(zip(*[self.row_args_fn(k, r) for k, r in chunk]))
            try:
                with ROW_TRACES.bind([k for k, _ in chunk]):
                    if prof is not None:
                        # batch-UDF timing: calls through a wrap_jit'd model
                        # split build vs execute themselves; a plain batch
                        # function reports the whole call as execute
                        t0 = _wall.perf_counter_ns()
                        results = self.batch_fn(*[list(c) for c in arg_cols])
                        if not getattr(self.batch_fn, "__wrapped__", None):
                            prof.record_jit(f"batch_udf/{self.name}", "execute", _wall.perf_counter_ns() - t0,
                                            len(chunk))
                    else:
                        results = self.batch_fn(*[list(c) for c in arg_cols])
                if len(results) != len(chunk):
                    raise ValueError(
                        f"batch UDF returned {len(results)} results for "
                        f"{len(chunk)} inputs"
                    )
            except Exception as exc:
                # the whole chunk failed (same contract as the dynamic
                # batcher: one exception fails every row of the batch)
                if self.on_error == "dead_letter":
                    for key, row in chunk:
                        self.graph.report_dead_letter(
                            self.dead_letter_id, self, key, row, exc
                        )
                    continue
                if self.on_error == "skip":
                    continue
                results = [self.graph.report_row_error(self, exc)] * len(chunk)
            for (key, row), res in zip(chunk, results):
                orow = row + (res,)
                self.memo[key] = orow
                out.append((key, orow, 1))
        self.emit(out, time)

    def on_end(self):
        cb = self.on_end_callback
        if cb is not None:
            self.on_end_callback = None
            cb()


class EngineGraph:
    """Builder + scheduler. The rough equivalent of the reference's
    `Graph` trait (src/engine/graph.rs:664) fused with its dataflow impl;
    one instance per worker shard."""

    def __init__(self, worker_id: int = 0, n_workers: int = 1):
        self.nodes: list[Node] = []
        self.static_sources: list[StaticSourceNode] = []
        self.session_sources: list[SessionSourceNode] = []
        self.outputs: list[OutputNode] = []
        self.captures: list[CaptureNode] = []
        self._dirty: set[int] = set()
        self.current_time = 0
        self.worker_id = worker_id
        self.n_workers = n_workers
        self._wake = threading.Event()
        self._async_loop = None
        self._stop = False
        # set when the run ends (stopped, finished or failed): readers that
        # serve until then (the REST endpoint, the streaming file scanner)
        # wait on it and return
        self.stopped = threading.Event()
        self.connector_threads: list[threading.Thread] = []
        # fatal reader-thread failures (name, exc): the run loop raises
        # instead of treating the dead session as clean EOF (reference:
        # a panicking reader thread propagates via catch_unwind,
        # dataflow.rs:5679-5694)
        self.connector_failures: list[tuple[str, BaseException]] = []
        self._threads_started = False
        # row-level error handling (reference Graph::error_log
        # graph.rs:983, terminate_on_error routing internals/errors.py):
        # True → first failure aborts the run; False → failing rows get
        # the ERROR value and an entry in the error-log sessions
        self.terminate_on_error = True
        self.error_sessions: list[InputSession] = []
        # dead-letter routing: dl_id -> sessions feeding that operator's
        # `.failed` table (on_error="dead_letter"); failures route here
        # regardless of terminate_on_error
        self.dead_letter_sessions: dict[int, list[InputSession]] = {}
        self._error_seq = 0
        # multi-worker: set by parallel.sharded.ShardCluster
        self.cluster = None
        # checkpoint/recovery (engine/persistence.py); epochs at or below
        # replay_frontier are recovered state: rebuilt, not re-emitted
        self.persistence_config = None
        self.persistence = None
        self.replay_frontier = -1
        # speedrun replay: recompute outputs purely from the recorded
        # stream, never starting readers (upstream
        # PersistenceMode::SpeedrunReplay, connectors/mod.rs:108)
        self._speedrun = False
        self._opsnap_time = -1       # operator-snapshot restore point
        self._last_opsnap_wall = 0.0
        # the run profiler (internals.profiler.RunProfiler), attached by
        # GraphRunner.attach_profiler; None = no timing
        self.profiler = None
        # overlapped host/device epoch pipeline (engine/pipeline.py):
        # depth 1 = the strict loop, depth >= 2 stages epoch N+1 (drain,
        # resolve, KIND_FEED) while epoch N executes. pipeline_stats is a
        # PipelineStats once running.
        self.pipeline_depth = 1
        self.pipeline_stats = None
        self._stage_commit_lock = None
        # epoch-completion observers (time, wall seconds of the epoch's
        # sweep): the serving batcher's query-dispatch slots
        self.epoch_observers: list[Callable[[int, float], None]] = []

    # --- builder helpers used by the graph runner ---

    def static_table(self, batches):
        return StaticSourceNode(self, batches)

    def wake(self):
        self._wake.set()

    def _notify_epoch_observers(self, time: int, wall_s: float) -> None:
        """Epoch-completion fan-out to serving-plane observers; a broken
        observer must never take the epoch loop down with it."""
        for obs in self.epoch_observers:
            try:
                obs(time, wall_s)
            except Exception:  # pragma: no cover - observer bug guard
                pass

    def report_row_error(self, origin: "Node", exc: BaseException):
        """Route a row-level failure: abort (terminate_on_error) or log
        it to the error sessions and return the ERROR value to store in
        the failing cell (reference error routing, engine/error.rs +
        internals/errors.py)."""
        user = getattr(origin, "user_frame", None)
        if self.terminate_on_error:
            if user is not None:
                from ..internals.trace import _format_frame

                where = "\n" + _format_frame(user)
            else:
                where = ""
            raise EngineError(
                f"error in operator {origin.name} (id {origin.id}): {exc!r}{where}",
                node=origin,
            ) from exc
        import traceback

        tb = traceback.extract_tb(exc.__traceback__)
        frame = tb[-1] if tb else None
        trace = (
            {"file": frame.filename, "line": frame.lineno, "function": frame.name}
            if frame
            else None
        )
        if user is not None:
            # the user's build-time call site rides along the runtime
            # frame (reference trace.py user frames in error logs)
            trace = dict(trace or {})
            trace["user_frame"] = user.as_dict()
        from .value import Json as _Json

        self._error_seq += 1
        # include the worker id: per-shard counters must not collide
        key = int(ref_scalar("__error__", self.worker_id, self._error_seq))
        row = (origin.id, f"{type(exc).__name__}: {exc}", _Json(trace) if trace else None)
        for session in self.error_sessions:
            session.insert(key, row)
            session.commit()
        return ERROR

    def report_dead_letter(
        self, dl_id: int | None, origin: "Node", key, row, exc: BaseException
    ) -> None:
        """Route a failing row to its operator's dead-letter sessions
        (the `.failed` table). Unlike report_row_error this never
        aborts: on_error="dead_letter" is an explicit per-operator
        override of terminate_on_error. Silently drops the record when
        the `.failed` table was never consumed (no sessions lowered)."""
        sessions = self.dead_letter_sessions.get(dl_id) if dl_id is not None else None
        if not sessions:
            return
        import traceback

        tb = traceback.extract_tb(exc.__traceback__)
        frame = tb[-1] if tb else None
        trace = (
            {"file": frame.filename, "line": frame.lineno, "function": frame.name}
            if frame
            else None
        )
        user = getattr(origin, "user_frame", None)
        if user is not None:
            trace = dict(trace or {})
            trace["user_frame"] = user.as_dict()
        from .value import Json as _Json

        args = [v if isinstance(v, (str, int, float, bool, type(None))) else repr(v) for v in row]
        self._error_seq += 1
        dkey = int(ref_scalar("__dead_letter__", self.worker_id, self._error_seq))
        drow = (
            _Json(args),
            origin.id,
            f"{type(exc).__name__}: {exc}",
            _Json(trace) if trace else None,
        )
        for session in sessions:
            session.insert(dkey, drow)
            session.commit()

    def run_async_batch(self, async_fn, pending):
        import asyncio

        async def traced(k, r):
            # each task runs in its own copy of the context: bind its row's
            # request trace there
            with ROW_TRACES.bind((k,)):
                return await async_fn(k, r)

        async def runner():
            return await asyncio.gather(
                *[traced(k, r) for k, r in pending], return_exceptions=True
            )

        return asyncio.run(runner())

    # --- execution ---

    def _topo_pass(self, time, end_epoch: bool = True):
        # nodes are created in dependency order, so one ordered pass covers
        # forward edges; operators that emit "later" than their position
        # (external index answering as-of-now, ix pre-joins) create
        # back-edges — keep sweeping until quiescent.
        prof = self.profiler
        if prof is None:
            while self._dirty:
                for node in self.nodes:
                    if node.id in self._dirty:
                        self._dirty.discard(node.id)
                        node.process(time)
            # time-end notifications: outputs/captures deliver the epoch's
            # consolidated changes
            for node in self.nodes:
                te = getattr(node, "time_end", None)
                if te is not None:
                    te(time)
            return
        # profiled sweep: the same control flow with each node's work
        # timed; within one worker the calls are sequential, so folding
        # re-processing into one slice per node-epoch is exact
        wid = self.worker_id
        prof.begin_epoch(wid)
        while self._dirty:
            for node in self.nodes:
                if node.id in self._dirty:
                    self._dirty.discard(node.id)
                    t0 = prof.now_ns()
                    node.process(time)
                    prof.record_process(wid, node, t0, prof.now_ns() - t0)
        for node in self.nodes:
            te = getattr(node, "time_end", None)
            if te is not None:
                t0 = prof.now_ns()
                te(time)
                prof.record_process(wid, node, t0, prof.now_ns() - t0)
        if end_epoch:
            prof.end_epoch(wid, self, time)

    def _frontier_hooks(self, frontier):
        for node in self.nodes:
            node.on_frontier(frontier)

    def _setup_persistence(self) -> None:
        from .persistence import EnginePersistence

        self.persistence = EnginePersistence(self.persistence_config)
        mode = str(
            getattr(self.persistence_config, "persistence_mode", "batch") or "batch"
        ).lower()
        self._speedrun = "speedrun" in mode
        # record/replay (CLI --record / --replay-mode): every source is
        # recorded; ids auto-assign by construction order, deterministic
        # across runs of the same program (reference cli.py:180-186)
        record_mode = "record" in mode
        if (
            getattr(self.persistence_config, "auto_persistent_ids", False)
            or record_mode
            or self._speedrun
        ):
            for i, s in enumerate(self.session_sources):
                if s.persistent_id is not None or s.is_error_log:
                    continue
                # batch-mode recovery only suits offset-aware readers: an
                # offset-unaware one would re-read everything ON TOP of
                # the replayed log, duplicating its input. Speedrun never
                # starts readers, and record mode resets such logs below.
                if self._speedrun or record_mode or s.supports_offsets:
                    s.persistent_id = f"auto_{i}"
        frontier = -1
        for s in self.session_sources:
            if s.persistent_id is None:
                continue
            if (record_mode or not self._speedrun) and not s.supports_offsets:
                # offset-unaware reader: run() re-produces all input from
                # scratch, so replaying a stale log on top would double
                # it — start the recording over (speedrun never starts
                # readers, so there replay stays safe)
                self.persistence.reset_source(s.persistent_id)
                continue
            batches, offsets, f = self.persistence.recover_source(
                s.persistent_id,
                delivered_frontier=self.persistence.delivered_frontier(),
            )
            s.replay_batches = list(batches)
            s.session.restore_offsets(offsets)
            frontier = max(frontier, f)
        # speedrun recomputes sink output from the recorded stream, so
        # replayed epochs are NOT suppressed there
        self.replay_frontier = -1 if self._speedrun else frontier
        # layer 2 — operator snapshots (operator_snapshot.rs): restore
        # the whole graph's state at the snapshot time and skip replaying
        # the input events it already covers. Only sound when EVERY real
        # source is persistent: a snapshot also contains state derived
        # from non-persistent sources, whose readers re-feed on restart
        # and would double-count on top of the restored state.
        all_persistent = all(
            s.persistent_id is not None
            for s in self.session_sources
            if not s.is_error_log
        )
        if not self._speedrun and frontier >= 0 and not all_persistent:
            import warnings

            warnings.warn(
                "only a subset of sources has a persistent_id: "
                "non-persistent sources re-feed at fresh epochs after a "
                "restart, so rows derived from them may be delivered to "
                "sinks again — exactly-once only holds when every source "
                "is persisted",
                stacklevel=2,
            )
        restored_t: int | None = None
        if not self._speedrun and frontier >= 0 and all_persistent:
            rec = self.persistence.recover_operator_snapshot(frontier)
            if rec is not None:
                import pickle

                t0, blob = rec
                data = pickle.loads(blob)
                sig_ok = len(data["sig"]) == len(self.nodes) and all(
                    nid < len(self.nodes)
                    and self.nodes[nid].snapshot_signature() == node_sig
                    for nid, node_sig in data["sig"]
                )
                # signature mismatch (program changed) → ignore snapshot,
                # fall back to full input replay
                if sig_ok:
                    # restored index contents are visible as-of the
                    # snapshot epoch: route the restore's index adds
                    # through the freshness epoch lifecycle so the
                    # per-shard watermark re-advances to the exact
                    # pre-crash epoch (wall restarts at recovery time —
                    # pre-crash arrival timestamps did not survive)
                    FRESHNESS.begin_epoch(int(t0))
                    FRESHNESS.epoch_staged(int(t0))
                    FRESHNESS.epoch_exec(int(t0))
                    for nid, st in data["states"].items():
                        self.nodes[nid].restore_state(st)
                    FRESHNESS.epoch_committed(int(t0))
                    for s in self.session_sources:
                        s.replay_batches = [
                            (tt, ups) for tt, ups in s.replay_batches if tt > t0
                        ]
                    # static sources re-produce deterministically and are
                    # already inside the restored state: fast-forward past
                    # the covered epochs (feeding them would double-count;
                    # not feeding while they queue would livelock run())
                    for st_src in self.static_sources:
                        while (
                            st_src.pos < len(st_src.batches)
                            and st_src.batches[st_src.pos][0] <= t0
                        ):
                            st_src.pos += 1
                    self._opsnap_time = t0
                    restored_t = t0
        # trimmed input logs (compact_inputs_on_snapshot) are only
        # recoverable THROUGH a compatible snapshot that covers the
        # trimmed range — every other path, INCLUDING speedrun replay
        # (which never restores snapshots), fails loudly
        self.persistence.check_compaction_covered(
            [
                s.persistent_id
                for s in self.session_sources
                if s.persistent_id is not None
            ],
            restored_t,
        )

    def _snapshot_operators(self, t) -> None:
        """Write layer-2 state. Called AFTER every ADVANCE of epoch t is
        durable — a snapshot must never cover unfinalized input."""
        # a staging ring's copies in flight finish before pickling: a slot
        # still being written would be captured half old, half new
        from . import device_ring

        device_ring.quiesce_all()
        states = {}
        for n in self.nodes:
            s = n.snapshot_state()
            if s is not None:
                states[n.id] = s
        # the signature covers EVERY node: a restored snapshot skips
        # replay, so any topology change (even a new sink) must fall
        # back to full replay or the new node would stay empty
        sig = [(n.id, n.snapshot_signature()) for n in self.nodes]
        blob = dumps_host({"sig": sig, "time": t, "states": states})
        self.persistence.save_operator_snapshot(int(t), blob)
        # opt-in: the snapshot covers all input <= t, so trim the input
        # logs to keep them bounded on long-running jobs (background
        # compaction role, reference operator_snapshot.rs:491)
        if getattr(self.persistence_config, "compact_inputs_on_snapshot", False):
            self.persistence.compact_inputs(
                [
                    s.persistent_id
                    for s in self.session_sources
                    if s.persistent_id is not None and not s.is_error_log
                ],
                int(t),
            )
        self._last_opsnap_wall = _wall.monotonic()

    def _maybe_snapshot_operators(self, t) -> None:
        if self.persistence is None or self._speedrun:
            return
        interval_ms = getattr(self.persistence_config, "snapshot_interval_ms", 0) or 0
        if interval_ms <= 0:
            return  # end-of-run snapshot only
        if (_wall.monotonic() - self._last_opsnap_wall) * 1000.0 >= interval_ms:
            self._snapshot_operators(t)

    def run(self, monitoring_callback: Callable | None = None) -> None:
        """Run to completion: replay recovered epochs, then process
        scripted batches in time order, then live sessions until all
        close or ``stop()``. ``pipeline_depth > 1`` runs the overlapped
        pipeline (engine/pipeline.py). ``stopped`` is set when the run
        ends, however it ends."""
        try:
            if self.pipeline_depth > 1:
                from .pipeline import run_pipelined

                run_pipelined(self, monitoring_callback)
            else:
                self._run(monitoring_callback)
        finally:
            self.stopped.set()

    def _run(self, monitoring_callback: Callable | None) -> None:
        if self.persistence_config is not None:
            self._setup_persistence()
        if not self._speedrun:
            for t in self.connector_threads:
                t.start()
            self._threads_started = True
        last_time = -1
        while not self._stop:
            self._raise_connector_failure()
            # next scripted time: static sources + recovery replay queues
            times = [s.next_time() for s in self.static_sources]
            replay_pending = False
            for s in self.session_sources:
                rt = s.next_replay_time()
                if rt is not None:
                    times.append(rt)
                    replay_pending = True
            times = [t for t in times if t is not None]
            scripted_t = min(times) if times else None

            session_batches = []
            if not replay_pending:
                # live epochs must land strictly past the recovered frontier
                if last_time < self.replay_frontier:
                    last_time = self.replay_frontier
                for s in self.session_sources:
                    b = s.session.drain()
                    if b:
                        session_batches.append((s, b))

            if scripted_t is None and not session_batches:
                if self._speedrun:
                    break  # recorded stream exhausted
                # error-log sessions are engine-fed and never close
                if all(
                    s.session.closed for s in self.session_sources if not s.is_error_log
                ):
                    break
                # wait for connector data
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue

            t = scripted_t if scripted_t is not None else last_time + 1
            if session_batches and scripted_t is not None:
                t = max(scripted_t, last_time + 1)
            t = max(t, last_time + 1) if t <= last_time else t
            self.current_time = t
            FRESHNESS.begin_epoch(int(t))
            _epoch_kw = {"t": int(t), "worker": self.worker_id}
            if self.cluster_generation():
                _epoch_kw["generation"] = self.cluster_generation()
            flight_recorder.record("epoch.begin", batches=len(session_batches), **_epoch_kw)
            self._frontier_hooks(t)
            for s in self.static_sources:
                s.feed(t)
            for s in self.session_sources:
                s.feed_replay(t)
            for s, b in session_batches:
                resolved = s.feed_batch(b, t)
                if self.persistence is not None and s.persistent_id is not None and resolved:
                    # feed offsets ride along durably (KIND_FEED) so a
                    # crash after the sink flush but before ADVANCE can
                    # finalize this epoch on recovery instead of
                    # re-reading and re-delivering it. At depth 1 the
                    # staging-commit point coincides with feed time, so
                    # the pipeline's chaos sites fire here too.
                    from ..resilience import chaos as _chaos

                    _chaos.inject("engine.before_stage_commit", time=int(t))
                    self.persistence.log_batch(s.persistent_id, t, resolved, s.last_offsets or {})
                    _chaos.inject("engine.after_stage_commit", time=int(t))
            FRESHNESS.epoch_staged(int(t))
            _sweep0 = _wall.perf_counter()
            FRESHNESS.epoch_exec(int(t))
            # the profiler folds the epoch after it advanced: outputs were
            # delivered inside the pass, and the fold is not the epoch's work
            self._topo_pass(t, end_epoch=False)
            FRESHNESS.epoch_committed(int(t))
            if self.epoch_observers:
                self._notify_epoch_observers(int(t), _wall.perf_counter() - _sweep0)
            if self.persistence is not None:
                if session_batches:
                    # sinks flushed this epoch's output in the topo pass;
                    # durably mark it delivered BEFORE advancing offset
                    # cursors — a crash in between must finalize (not
                    # re-deliver) the epoch on recovery
                    from ..resilience import chaos as _chaos

                    _chaos.inject("engine.after_sink_flush", time=int(t))
                    self.persistence.mark_delivered(int(t))
                for s, _b in session_batches:
                    if s.persistent_id is not None:
                        self.persistence.advance(s.persistent_id, t, s.last_offsets or {})
                if session_batches:
                    self._maybe_snapshot_operators(t)
            last_time = t
            flight_recorder.record("epoch.advance", **_epoch_kw)
            if self.profiler is not None:
                self.profiler.end_epoch(self.worker_id, self, t)
            if monitoring_callback is not None:
                monitoring_callback(self)

        if not self._stop:
            # a failure recorded as the loop exited (reader appended just
            # before closing its session) must not look like clean EOF
            self._raise_connector_failure()
        # final snapshot BEFORE the end-of-input flush: the flush assumes
        # input is over, which a restarted run cannot know
        if self._final_snapshot_due(last_time):
            self._snapshot_operators(last_time)
        self._finish_run(last_time)

    def _final_snapshot_due(self, last_time) -> bool:
        return (
            self.persistence is not None
            and not self._speedrun
            and last_time >= 0
            and last_time != self._opsnap_time  # something actually changed
            and bool(self.session_sources)
            and all(s.persistent_id is not None for s in self.session_sources if not s.is_error_log)
        )

    def _finish_run(self, last_time) -> None:
        """The end-of-input tail of both loops: flush time-based operators
        at a final epoch, deliver late errors, end every node, close the
        logs and join the readers."""
        self.current_time = last_time + 1
        self._frontier_hooks(INF_TIME)
        if self._dirty:
            self._topo_pass(self.current_time)
        # deliver errors raised during the final flush — their sessions
        # committed after the main loop stopped draining
        err_batches = []
        for s in self.session_sources:
            if s.is_error_log:
                b = s.session.drain()
                if b:
                    err_batches.append((s, b))
        if err_batches:
            self.current_time += 1
            for s, b in err_batches:
                s.feed_batch(b, self.current_time)
            self._topo_pass(self.current_time)
        for node in self.nodes:
            node.on_end()
        if self.persistence is not None:
            self.persistence.close()
        if self._threads_started:
            self.stopped.set()
            for t in self.connector_threads:
                t.join(timeout=5.0)

    def cluster_generation(self) -> int:
        """The cluster fault-domain generation this engine runs under (0
        outside a multi-process cluster, and before any partial restart).
        Monitoring stamps it on /status and epoch telemetry."""
        return int(getattr(self.cluster, "generation", 0) or 0)

    def _raise_connector_failure(self) -> None:
        if self.connector_failures:
            name, exc = self.connector_failures[0]
            flight_recorder.record("connector.failed", connector=name, error=type(exc).__name__)
            raise EngineError(f"connector {name!r} failed: {exc}") from exc

    def stop(self):
        self._stop = True
        self.wake()

    def release(self) -> None:
        """Drop every operator of this graph (after ``stop()``): with each
        node's consumers and queues cut, nothing that still holds the graph
        or one of its sources (a reader thread, a connector subject, a
        traceback) keeps the rest of the dataflow alive."""
        for node in self.nodes:
            node.consumers = []
            node.queues = []
        self.nodes = []
        self.static_sources = []
        self.session_sources = []
        self.outputs = []
        self.captures = []
        if self.persistence is not None:
            self.persistence.close()
            self.persistence = None
        self._dirty = set()
