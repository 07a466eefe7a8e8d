"""Span recording and the bounded trace store.

The port's copy of the reference's ``tracing/store.py``. Recording is
gated on one process-wide flag (``pw.run(tracing=...)`` /
``PATHWAY_TRACING``): with tracing off a :class:`span` block costs one
attribute read and records nothing, so the serving hot path stays within
its <5% overhead budget and ``/metrics`` output is byte-identical to a
build without the plane.

The :class:`TraceStore` keeps completed spans in a bounded ring (like
the flight recorder's event ring) plus **p99 exemplar retention**: when
a request's *root* span completes, the trace's wall time competes for
one of ``PATHWAY_TRACE_EXEMPLARS`` slots in the current retention
window — the slowest-N complete traces of each window survive ring
eviction, so "where did the p99 go" is answerable long after the p50
traffic that evicted the ring. Worker processes buffer finished spans
in an outbox that rides the cluster's round replies to the coordinator
(``parallel/multiprocess.py``); the coordinator's ingest deduplicates by span
id, so duplicated frames do not double spans.

At the end of a traced run the store is dumped to
``PATHWAY_TRACE_DIR`` (default ``<tmp>/pathway-traces``; read back with
:func:`load_trace_dump`), and any spans still open ride along in
flight-recorder crash dumps.

A span opened or recorded under a :class:`~.context.TraceFanout` (one
piece of work serving several requests) is recorded once into each
member's trace, with a span id of its own.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import threading
import time as _time
from collections import deque

from ..internals.flight_recorder import _env_flag, _env_int
from .context import TraceContext, TraceFanout, bind_trace, current_trace, gen_span_id, gen_trace_id

TRACE_DUMP_FORMAT_VERSION = 1

_ENABLED = _env_flag("PATHWAY_TRACING", False)


def tracing_enabled() -> bool:
    return _ENABLED


def set_tracing_enabled(on: bool) -> bool:
    """Flip the process-wide recording flag; returns the previous value
    (``pw.run`` restores it when the run ends)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def default_trace_dir() -> str:
    d = os.environ.get("PATHWAY_TRACE_DIR")
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "pathway-traces")


class Span:
    """One recorded stage of a request journey."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "stage",
        "worker",
        "start_unix",
        "start_mono",
        "duration_s",
        "attrs",
        "links",
        "boundary",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: str,
        stage: str,
        *,
        worker: int = 0,
        start_unix: float | None = None,
        start_mono: float | None = None,
        duration_s: float | None = None,
        attrs: dict | None = None,
        links: tuple = (),
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.stage = stage
        self.worker = worker
        self.start_unix = _time.time() if start_unix is None else start_unix
        self.start_mono = _time.monotonic() if start_mono is None else start_mono
        self.duration_s = duration_s
        self.attrs = attrs or {}
        self.links = tuple(links)
        #: journey boundary: finishing this span completes the trace
        #: locally even when the parent span is *remote* (an inbound
        #: ``traceparent`` makes the server's request span a child of
        #: the client's span, so it is never a local root)
        self.boundary = False

    @property
    def is_root(self) -> bool:
        return self.parent_id == ""

    def to_dict(self) -> dict:
        d = {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "stage": self.stage,
            "worker": self.worker,
            "start": round(self.start_unix, 6),
            "dur_ms": round((self.duration_s or 0.0) * 1000.0, 4),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.links:
            d["links"] = list(self.links)
        if self.boundary:
            d["boundary"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        sp = cls(
            d.get("trace", ""),
            d.get("span", ""),
            d.get("parent", ""),
            d.get("stage", "?"),
            worker=int(d.get("worker", 0)),
            start_unix=float(d.get("start", 0.0)),
            start_mono=0.0,
            duration_s=float(d.get("dur_ms", 0.0)) / 1000.0,
            attrs=d.get("attrs") or {},
            links=tuple(d.get("links") or ()),
        )
        sp.boundary = bool(d.get("boundary", False))
        return sp


class TraceStore:
    """Process-wide span ring + exemplar retention + remote ingest."""

    def __init__(
        self,
        ring_size: int | None = None,
        exemplar_slots: int | None = None,
        window_s: float | None = None,
    ):
        if ring_size is None:
            ring_size = max(64, _env_int("PATHWAY_TRACE_RING", 4096))
        if exemplar_slots is None:
            exemplar_slots = max(1, _env_int("PATHWAY_TRACE_EXEMPLARS", 10))
        if window_s is None:
            window_s = float(max(1, _env_int("PATHWAY_TRACE_WINDOW_S", 60)))
        self.exemplar_slots = exemplar_slots
        self.window_s = window_s
        self.worker = 0
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._ring: deque[Span] = deque(maxlen=ring_size)
        self._open: dict[str, Span] = {}
        # traces under assembly: trace_id -> spans finished so far
        self._by_trace: dict[str, list[Span]] = {}
        self._by_trace_cap = max(64, _env_int("PATHWAY_TRACE_INFLIGHT", 1024))
        # current retention window: min-heap of (wall_s, seq, trace_id, spans)
        self._window_start: float | None = None
        self._window_heap: list[tuple[float, int, str, list[Span]]] = []
        self._retained: deque[list[tuple[float, str, list[Span]]]] = deque(
            maxlen=max(1, _env_int("PATHWAY_TRACE_WINDOWS", 5))
        )
        # remote ingest dedup: span ids seen from worker piggybacks
        self._seen_remote: set[str] = set()
        self._seen_remote_order: deque[str] = deque(maxlen=8192)
        self._outbox: list[dict] = []
        self._outbox_enabled = False
        self.spans_total = 0
        self.traces_total = 0
        self.remote_spans_total = 0
        self.remote_dupes_total = 0

    # -- worker-side configuration (cluster piggyback) --

    def configure_worker(self, worker_id: int) -> None:
        """Mark this process as cluster worker ``worker_id``: finished
        spans are additionally queued for the coordinator piggyback."""
        with self._lock:
            self.worker = int(worker_id)
            self._outbox_enabled = True

    def drain_outbox(self, limit: int = 256) -> list[dict]:
        with self._lock:
            if not self._outbox:
                return []
            out, self._outbox = self._outbox[:limit], self._outbox[limit:]
            return out

    # -- recording --

    def begin(self, sp: Span) -> None:
        with self._lock:
            self._open[sp.span_id] = sp

    def finish(self, sp: Span) -> None:
        if sp.duration_s is None:
            sp.duration_s = max(0.0, _time.monotonic() - sp.start_mono)
        completed: list[Span] | None = None
        with self._lock:
            self._open.pop(sp.span_id, None)
            self._ring.append(sp)
            self.spans_total += 1
            if self._outbox_enabled and len(self._outbox) < 4096:
                self._outbox.append(sp.to_dict())
            bucket = self._by_trace.get(sp.trace_id)
            if bucket is None:
                if len(self._by_trace) >= self._by_trace_cap:
                    # drop the oldest half-assembled trace (shed or
                    # abandoned mid-journey); its spans stay in the ring
                    self._by_trace.pop(next(iter(self._by_trace)), None)
                bucket = self._by_trace[sp.trace_id] = []
            bucket.append(sp)
            if sp.is_root or sp.boundary:
                completed = self._by_trace.pop(sp.trace_id, [sp])
                self._retain(sp.trace_id, completed, sp.duration_s)
        from .metrics import TRACING_METRICS

        TRACING_METRICS.observe(sp.stage, sp.duration_s, sp.trace_id, worker=sp.worker)

    def _retain(self, trace_id: str, spans: list[Span], wall_s: float) -> None:
        """Exemplar retention (caller holds the lock): the slowest-N
        complete traces of each window survive ring eviction."""
        self.traces_total += 1
        now = _time.monotonic()
        if self._window_start is None:
            self._window_start = now
        elif now - self._window_start >= self.window_s:
            self._freeze_window()
            self._window_start = now
        entry = (wall_s, next(self._seq), trace_id, list(spans))
        if len(self._window_heap) < self.exemplar_slots:
            heapq.heappush(self._window_heap, entry)
        elif wall_s > self._window_heap[0][0]:
            heapq.heapreplace(self._window_heap, entry)

    def _freeze_window(self) -> None:
        if self._window_heap:
            frozen = sorted(
                ((w, tid, sp) for w, _seq, tid, sp in self._window_heap),
                reverse=True,
                key=lambda e: e[0],
            )
            self._retained.append(frozen)
        self._window_heap = []

    # -- remote ingest (coordinator side) --

    def ingest_remote(self, span_dicts: list[dict]) -> int:
        """Merge spans piggybacked from a cluster worker. Deduplicated
        by span id: the chaos harness can duplicate protocol frames
        (``cluster.send`` dup rules), and a duplicated frame must not
        double-count its spans."""
        ingested = 0
        for d in span_dicts or []:
            try:
                sid = d.get("span", "")
            except AttributeError:
                continue
            with self._lock:
                if not sid or sid in self._seen_remote:
                    self.remote_dupes_total += 1
                    continue
                if len(self._seen_remote_order) == self._seen_remote_order.maxlen:
                    self._seen_remote.discard(self._seen_remote_order[0])
                self._seen_remote_order.append(sid)
                self._seen_remote.add(sid)
                self.remote_spans_total += 1
            sp = Span.from_dict(d)
            self.finish(sp)
            ingested += 1
        return ingested

    # -- queries --

    def exemplar_traces(self) -> list[dict]:
        """All retained exemplar traces (current window + frozen
        windows), slowest first: ``{trace_id, wall_ms, spans}``."""
        with self._lock:
            entries = [(w, tid, sp) for w, _seq, tid, sp in self._window_heap]
            for window in self._retained:
                entries.extend(window)
        entries.sort(key=lambda e: e[0], reverse=True)
        out = []
        seen = set()
        for wall, tid, spans in entries:
            if tid in seen:
                continue
            seen.add(tid)
            out.append(
                {
                    "trace_id": tid,
                    "wall_ms": round(wall * 1000.0, 4),
                    "spans": [s.to_dict() for s in spans],
                }
            )
        return out

    def get_trace(self, trace_id: str) -> list[dict]:
        """Every known span of one trace (ring + exemplars + open),
        deduplicated, in start order."""
        found: dict[str, Span] = {}
        with self._lock:
            for sp in self._ring:
                if sp.trace_id == trace_id:
                    found[sp.span_id] = sp
            for sp in self._by_trace.get(trace_id, ()):
                found[sp.span_id] = sp
            entries = [(tid, sps) for _w, _s, tid, sps in self._window_heap]
            for window in self._retained:
                entries.extend((tid, sps) for _w, tid, sps in window)
            for tid, sps in entries:
                if tid == trace_id:
                    for sp in sps:
                        found[sp.span_id] = sp
            open_spans = [
                sp for sp in self._open.values() if sp.trace_id == trace_id
            ]
        out = [sp.to_dict() for sp in found.values()]
        now_mono = _time.monotonic()
        for sp in open_spans:
            d = sp.to_dict()
            d["open"] = True
            d["dur_ms"] = round((now_mono - sp.start_mono) * 1000.0, 4)
            out.append(d)
        out.sort(key=lambda d: d["start"])
        return out

    def open_spans(self) -> list[dict]:
        """Spans currently in flight — folded into flight-recorder
        dumps so a SIGKILLed worker's open request journeys survive."""
        with self._lock:
            spans = list(self._open.values())
        now_mono = _time.monotonic()
        out = []
        for sp in spans:
            d = sp.to_dict()
            d["open"] = True
            d["dur_ms"] = round(max(0.0, now_mono - sp.start_mono) * 1000.0, 4)
            out.append(d)
        return out

    def recent_spans(self, limit: int = 256) -> list[dict]:
        with self._lock:
            ring = list(self._ring)[-limit:]
        return [sp.to_dict() for sp in ring]

    def active(self) -> bool:
        with self._lock:
            return bool(self.spans_total or self._open)

    def snapshot(self) -> dict:
        with self._lock:
            exemplars = len(self._window_heap) + sum(
                len(w) for w in self._retained
            )
            return {
                "spans_total": self.spans_total,
                "traces_total": self.traces_total,
                "open_spans": len(self._open),
                "exemplars_retained": exemplars,
                "remote_spans_total": self.remote_spans_total,
                "remote_dupes_total": self.remote_dupes_total,
                "worker": self.worker,
            }

    # -- persistence (pathway trace CLI) --

    def dump(self, directory: str | None = None) -> str | None:
        """Write retained exemplars + the recent ring to
        ``trace-<stamp>-p<pid>.json``; returns the path (None when
        there is nothing to write or the write fails)."""
        if not self.active():
            return None
        try:
            directory = directory or default_trace_dir()
            os.makedirs(directory, exist_ok=True)
            stamp = _time.strftime("%Y%m%dT%H%M%S", _time.gmtime())
            pid = os.getpid()
            path = os.path.join(directory, f"trace-{stamp}-p{pid}.json")
            n = 1
            while os.path.exists(path):
                path = os.path.join(directory, f"trace-{stamp}-p{pid}-{n}.json")
                n += 1
            payload = {
                "version": TRACE_DUMP_FORMAT_VERSION,
                "pid": pid,
                "worker": self.worker,
                "created_at": _time.time(),
                "exemplars": self.exemplar_traces(),
                "recent": self.recent_spans(),
                "open": self.open_spans(),
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, default=repr)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except Exception:
            return None

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self._by_trace.clear()
            self._window_start = None
            self._window_heap = []
            self._retained.clear()
            self._seen_remote.clear()
            self._seen_remote_order.clear()
            self._outbox = []
            self._outbox_enabled = False
            self.worker = 0
            self.spans_total = 0
            self.traces_total = 0
            self.remote_spans_total = 0
            self.remote_dupes_total = 0


#: Process-wide store (one per engine process; workers piggyback to the
#: coordinator's over the authenticated cluster channel).
TRACE_STORE = TraceStore()


# -- recording helpers ----------------------------------------------------


class span:
    """``with span("stage", attr=...) as sp:`` — record one stage of
    the current request journey.

    No-op (yields None) when tracing is off or no trace context is
    bound, unless ``new_trace=True`` (the admission path: a request
    that arrived without a ``traceparent`` starts its journey here).
    While the block runs, the child context is bound so nested spans
    parent correctly — the same scoping ``bind_deadline`` gives the
    request deadline.

    ``boundary=True`` marks the process-entry span of a journey (the
    HTTP request span): finishing it completes the trace for exemplar
    retention even when an inbound ``traceparent`` made it a child of
    the *client's* span rather than a local root.
    """

    __slots__ = (
        "_stage",
        "_ctx",
        "_new_trace",
        "_boundary",
        "_links",
        "_attrs",
        "_sp",
        "_token",
    )

    def __init__(
        self,
        stage: str,
        *,
        ctx: TraceContext | None = None,
        new_trace: bool = False,
        boundary: bool = False,
        links: tuple = (),
        **attrs,
    ):
        self._stage = stage
        self._ctx = ctx
        self._new_trace = new_trace
        self._boundary = boundary
        self._links = links
        self._attrs = attrs
        self._sp: list[Span] | None = None
        self._token = None

    def __enter__(self) -> Span | None:
        if not _ENABLED:
            return None
        parent = self._ctx if self._ctx is not None else current_trace()
        if parent is None:
            if not self._new_trace:
                return None
            parents = [("", "")]
        elif isinstance(parent, TraceFanout):
            parents = [(m.trace_id, m.span_id) for m in parent.members]
        else:
            parents = [(parent.trace_id, parent.span_id)]
        spans = []
        for trace_id, parent_id in parents:
            sp = Span(
                trace_id or gen_trace_id(),
                gen_span_id(),
                parent_id,
                self._stage,
                worker=TRACE_STORE.worker,
                attrs=dict(self._attrs) if self._attrs else {},
                links=self._links,
            )
            sp.boundary = self._boundary
            TRACE_STORE.begin(sp)
            spans.append(sp)
        self._sp = spans
        bound = [TraceContext(sp.trace_id, sp.span_id) for sp in spans]
        self._token = bind_trace(bound[0] if len(bound) == 1 else TraceFanout(bound))
        self._token.__enter__()
        return spans[0]

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._sp is None:
            return
        if self._token is not None:
            self._token.__exit__()
            self._token = None
        for sp in self._sp:
            if exc is not None:
                sp.attrs["error"] = type(exc).__name__
            TRACE_STORE.finish(sp)
        self._sp = None


def record_span(
    stage: str,
    *,
    start_mono: float,
    end_mono: float,
    ctx: TraceContext | None = None,
    new_trace: bool = False,
    root_of: TraceContext | None = None,
    links: tuple = (),
    **attrs,
) -> Span | None:
    """Record an already-measured span from monotonic timestamps (the
    batcher measures queue wait / dispatch wall itself and records
    per-member spans after the fact).

    ``root_of=ctx`` closes the *root* span of ``ctx``'s trace — the
    span id is ``ctx.span_id`` (so spans recorded under ``ctx`` parent
    to it) and the parent is empty, which completes the trace and makes
    it eligible for exemplar retention. Embedded callers use this: they
    admit and submit with a trace context, then
    close the journey root once the async dispatch finishes. Under a
    :class:`~.context.TraceFanout` one span is recorded into each member's
    trace; the first is returned."""
    if not _ENABLED:
        return None
    if root_of is not None:
        parents = [(root_of.trace_id, "", root_of.span_id)]
    else:
        parent = ctx if ctx is not None else current_trace()
        if parent is None:
            if not new_trace:
                return None
            parents = [(gen_trace_id(), "", None)]
        elif isinstance(parent, TraceFanout):
            parents = [(m.trace_id, m.span_id, None) for m in parent.members]
        else:
            parents = [(parent.trace_id, parent.span_id, None)]
    now_mono = _time.monotonic()
    first = None
    for trace_id, parent_id, span_id in parents:
        sp = Span(
            trace_id,
            span_id or gen_span_id(),
            parent_id,
            stage,
            worker=TRACE_STORE.worker,
            start_unix=_time.time() - (now_mono - start_mono),
            start_mono=start_mono,
            duration_s=max(0.0, end_mono - start_mono),
            attrs=dict(attrs) if attrs else {},
            links=links,
        )
        TRACE_STORE.finish(sp)
        first = first or sp
    return first


# -- dump files: load / list (pathway trace CLI) --------------------------


def load_trace_dump(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "exemplars" not in data:
        raise ValueError(f"{path}: not a trace dump")
    return data


def list_trace_dumps(directory: str | None = None) -> list[str]:
    directory = directory or default_trace_dir()
    if not os.path.isdir(directory):
        return []
    out = [
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.startswith("trace-") and name.endswith(".json")
    ]
    return sorted(out)
