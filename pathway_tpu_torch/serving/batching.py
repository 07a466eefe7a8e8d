"""Continuous/adaptive batching of in-flight queries.

The port's copy of the reference's ``serving/batching.py``. The
:class:`AdaptiveBatcher` coalesces admitted queries into fused
dispatches:

- queries wait in a deadline-ordered pending heap for at most
  ``batch_window_ms`` (a burst coalesces into one dispatch);
- the batch size tracks observed latency: an EWMA of per-item dispatch
  time (blended with the engine's own epoch wall time through
  ``attach_engine``) sizes the next batch so one fused dispatch fits
  inside ``latency_budget_ms x query_share``;
- ``query_share`` partitions the device between the query stream and the
  ingest stream: after each dispatch the batcher yields the rest of the
  slot (``query_share=1.0`` disables the yield);
- queries whose deadline expired while queued are *dropped*, not
  dispatched;
- queries submitted with a ``tenant=`` go into per-tenant deadline heaps
  drained by weighted deficit round-robin: each tenant at its quota's
  ``weight`` under an active tenancy (weight 1 without one), the tenant-less
  heap an anonymous weight-1 participant.

``DecodeService`` (``decode/engine.py``) and ``rest_connector(serving=)``
(``io/http/_server.py``) front their engines with it. Each dispatch records
a ``serving.batch`` flight-recorder event; with tracing on, a batch span
(its own trace) links the member requests' traces and every member gets
``queue`` and ``dispatch`` spans; tenant items mirror their per-item share
of the dispatch into the chip ledger's tenant sub-accounts.

Chaos sites (``resilience/chaos.py`` rules target these):
``serving.before_dispatch`` just before a fused batch goes to the engine
(a delay there models a device that stopped keeping up) and
``serving.batch_inflight`` after the dispatch returns, while the request
futures are still pending (a raise there models a stuck batch).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from typing import Any, Callable, Optional

from ..internals import flight_recorder
from ..resilience import chaos as _chaos
from .admission import ServingConfig, _tracing_enabled
from .deadline import Deadline
from .metrics import SERVING_METRICS, ServingMetrics

__all__ = ["AdaptiveBatcher"]

#: EWMA smoothing for observed per-item dispatch latency.
_ALPHA = 0.3
#: Cap on the ingest-share yield after a dispatch, so a latency spike
#: cannot stall the query stream for seconds.
_MAX_YIELD_S = 0.25


class AdaptiveBatcher:
    """Coalesces submitted items into fused ``dispatch(list)`` calls.

    ``dispatch`` receives the items of one batch in deadline order and runs
    on the batcher's worker thread. ``on_expired`` (optional) is called
    with items dropped because their deadline passed while they were
    queued. An exception in ``dispatch`` stops the worker and is kept in
    ``error``.
    """

    def __init__(
        self,
        dispatch: Callable[[list[Any]], None],
        *,
        config: ServingConfig | None = None,
        metrics: ServingMetrics | None = None,
        on_expired: Callable[[Any], None] | None = None,
        name: str = "query",
    ):
        self.config = config or ServingConfig()
        self.metrics = metrics if metrics is not None else SERVING_METRICS
        self._dispatch = dispatch
        self._on_expired = on_expired
        self.name = name
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._heap: list[tuple] = []  # (expires_at, seq, item, enqueued_at, trace, tenant)
        # per-tenant deadline heaps (same entry shape) + deficit
        # round-robin state; empty unless submit() ever names a tenant
        self._tenant_heaps: dict[str, list] = {}
        self._deficit: dict[Any, float] = {}
        self._rr: list[str] = []  # tenant service order (first seen)
        self._wake = threading.Event()
        self._halt = False
        self._thread: Optional[threading.Thread] = None
        self._ewma_item_s = 0.0  # observed per-item dispatch latency
        self._engine_epoch_s = 0.0  # EWMA of the engine's epoch wall
        self.dispatched_total = 0
        self.dropped_expired_total = 0
        self.error: BaseException | None = None

    # -- lifecycle --

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._loop, daemon=True, name=f"pathway_tpu_torch:batcher:{self.name}")
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._halt = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    # -- producer side --

    def submit(self, item: Any, deadline: Deadline | None = None, trace=None, tenant: str | None = None) -> None:
        """Queue one item for the next fused dispatch (starts the worker on
        first use). ``trace`` (a TraceContext) defaults to the submitter's
        bound context, so the request journey follows the item onto the
        batcher thread. ``tenant`` routes the item into that tenant's
        fair-share heap; ``None`` keeps the single heap."""
        if deadline is None:
            deadline = Deadline.none()
        if trace is None and _tracing_enabled():
            from ..tracing import current_trace

            trace = current_trace()
        entry = (deadline.expires_at, next(self._seq), item, _time.monotonic(), trace, tenant)
        with self._lock:
            if tenant is None:
                heapq.heappush(self._heap, entry)
            else:
                tenant = str(tenant)
                heap = self._tenant_heaps.get(tenant)
                if heap is None:
                    heap = self._tenant_heaps[tenant] = []
                    self._rr.append(tenant)
                heapq.heappush(heap, entry)
        self.start()
        self._wake.set()

    def pending(self) -> int:
        with self._lock:
            return len(self._heap) + sum(len(h) for h in self._tenant_heaps.values())

    def next_deadline(self) -> float | None:
        """``expires_at`` of the most urgent queued item, or ``None`` when
        nothing waits (the decode engine's chunked-prefill scheduler admits
        in the same order)."""
        with self._lock:
            heads = [h[0][0] for h in self._tenant_heaps.values() if h]
            if self._heap:
                heads.append(self._heap[0][0])
            return min(heads) if heads else None

    # -- engine integration --

    def attach_engine(self, engine) -> None:
        """Register for the engine's epoch reports: after every epoch the
        engine reports its wall time, which feeds the latency EWMA that sizes
        batches and wakes the worker (an epoch boundary is a natural
        dispatch slot)."""
        observers = getattr(engine, "epoch_observers", None)
        if observers is not None and self._on_epoch not in observers:
            observers.append(self._on_epoch)

    def _on_epoch(self, time: int, wall_s: float) -> None:
        if wall_s > 0.0:
            if self._engine_epoch_s == 0.0:
                self._engine_epoch_s = wall_s
            else:
                self._engine_epoch_s = (1.0 - _ALPHA) * self._engine_epoch_s + _ALPHA * wall_s
        self._wake.set()

    # -- sizing --

    def current_batch_size(self) -> int:
        """Items per fused dispatch such that the batch fits inside the
        query stream's share of the latency budget, per the observed
        per-item EWMA. With no observations yet, the full ``batch_max``."""
        cfg = self.config
        per_item = self._ewma_item_s
        if per_item <= 0.0:
            return cfg.batch_max
        budget_s = (cfg.latency_budget_ms / 1000.0) * cfg.query_share
        return max(1, min(cfg.batch_max, int(budget_s / per_item)))

    # -- worker --

    def _take_batch(self) -> tuple[list[Any], list[float], list[Any], list[Any]]:
        """Pop up to current_batch_size() live items in deadline order;
        expired items are dropped (never dispatched). With tenant heaps
        present, items are drained by deficit round-robin. Returns the items
        with their enqueue times, traces and tenants."""
        limit = self.current_batch_size()
        now = _time.monotonic()
        taken: list[tuple] = []
        expired: list[tuple] = []
        with self._lock:
            if self._tenant_heaps:
                self._take_weighted(limit, now, taken, expired)
            else:
                while self._heap and len(taken) < limit:
                    entry = heapq.heappop(self._heap)
                    (expired if entry[0] <= now else taken).append(entry)
        for _exp, _seq, item, enq, trace, _tenant in expired:
            self.dropped_expired_total += 1
            self.metrics.record_deadline_expired()
            if trace is not None:
                # the journey of a dropped request ends in the queue: record
                # the wait it paid before expiring
                from ..tracing import record_span

                record_span("queue", start_mono=enq, end_mono=now, ctx=trace, dropped=True)
            if self._on_expired is not None:
                self._on_expired(item)
        return ([e[2] for e in taken], [e[3] for e in taken], [e[4] for e in taken], [e[5] for e in taken])

    def _take_weighted(self, limit, now, taken, expired) -> None:
        """Deficit round-robin drain across the tenant heaps (plus the
        single heap as an anonymous weight-1 participant). Each pass credits
        every backlogged tenant ``weight`` units of deficit and pops one item
        per whole unit, so over a window each tenant's share of fused-batch
        slots converges to its quota weight; expired items are dropped
        without charging deficit. Caller holds ``self._lock``."""
        from ..tenancy.config import active_tenancy

        cfg = active_tenancy()

        def weight(t) -> float:
            if t is None or cfg is None:
                return 1.0
            quota = cfg.quota_for(t)
            return max(float(quota.weight if quota is not None else 1.0), 1e-3)

        while len(taken) < limit:
            backlog: list[Any] = [t for t in self._rr if self._tenant_heaps.get(t)]
            if self._heap:
                backlog.append(None)
            if not backlog:
                break
            for t in backlog:
                heap = self._heap if t is None else self._tenant_heaps[t]
                self._deficit[t] = self._deficit.get(t, 0.0) + weight(t)
                while heap and self._deficit[t] >= 1.0 and len(taken) < limit:
                    entry = heapq.heappop(heap)
                    if entry[0] <= now:
                        expired.append(entry)
                        continue
                    self._deficit[t] -= 1.0
                    taken.append(entry)
                if not heap:
                    # classic DRR: an emptied queue forfeits its credit
                    self._deficit[t] = 0.0
                if len(taken) >= limit:
                    break

    def _loop(self) -> None:
        cfg = self.config
        window_s = max(0.0, cfg.batch_window_ms / 1000.0)
        try:
            while not self._halt:
                if not self._wake.wait(timeout=0.05):
                    continue
                self._wake.clear()
                if self._halt:
                    break
                # coalescing window: give a burst the chance to fuse into
                # one dispatch (skipped once a full batch is waiting)
                if window_s > 0.0 and self.pending() < self.current_batch_size():
                    _time.sleep(window_s)
                while not self._halt:
                    items, enqueued, traces, tenants = self._take_batch()
                    if not items:
                        break
                    now = _time.monotonic()
                    for enq in enqueued:
                        self.metrics.observe_stage("queue", now - enq)
                    _chaos.inject("serving.before_dispatch")
                    w0 = _time.monotonic()
                    # fan-in tracing: one batch span (its own trace) links
                    # the member request traces, so one fused dispatch
                    # explains N requests
                    traced = [t for t in traces if t is not None]
                    batch_trace_id = ""
                    if traced and _tracing_enabled():
                        from ..tracing import span as _trace_span
                        from ..tracing import trace_members

                        links = tuple(m.trace_id for t in traced for m in trace_members(t))
                        with _trace_span("batch", new_trace=True, links=links, size=len(items),
                                         name=self.name) as bsp:
                            self._dispatch(items)
                            # stuck-batch chaos site: the batch is in
                            # flight on the device here
                            _chaos.inject("serving.batch_inflight")
                        batch_trace_id = bsp.trace_id if bsp is not None else ""
                    else:
                        self._dispatch(items)
                        _chaos.inject("serving.batch_inflight")
                    w1 = _time.monotonic()
                    wall = w1 - w0
                    if traced:
                        from ..tracing import record_span

                        for enq, trace in zip(enqueued, traces):
                            if trace is None:
                                continue
                            # queue wait ends when the device takes the batch,
                            # so the per-stage spans tile the request's wall
                            record_span("queue", start_mono=enq, end_mono=w0, ctx=trace)
                            record_span("dispatch", start_mono=w0, end_mono=w1, ctx=trace,
                                        links=(batch_trace_id,) if batch_trace_id else (), size=len(items))
                    per_item = wall / len(items)
                    if any(t is not None for t in tenants):
                        from ..internals.chip_ledger import CHIP_LEDGER
                        from ..tenancy.metrics import TENANCY_METRICS

                        chip_on = CHIP_LEDGER.on()
                        for t in tenants:
                            if t is not None:
                                TENANCY_METRICS.add_chip_seconds(t, per_item)
                                if chip_on:
                                    # the tenant sub-account mirrors the DRR
                                    # per-item split; the plane work was
                                    # booked at its site
                                    CHIP_LEDGER.book_tenant(t, per_item)
                    if self._ewma_item_s == 0.0:
                        self._ewma_item_s = per_item
                    else:
                        self._ewma_item_s = (1.0 - _ALPHA) * self._ewma_item_s + _ALPHA * per_item
                    # the engine epoch EWMA pulls the estimate toward the
                    # observed device time
                    if self._engine_epoch_s > 0.0:
                        self._ewma_item_s = max(
                            self._ewma_item_s, min(self._engine_epoch_s / len(items), self._ewma_item_s * 4)
                        )
                    self.dispatched_total += len(items)
                    self.metrics.record_batch(len(items), self._ewma_item_s)
                    self.metrics.observe_stage("dispatch", wall)
                    flight_recorder.record("serving.batch", name=self.name, size=len(items),
                                           wall_ms=round(wall * 1000.0, 3),
                                           **({"trace": batch_trace_id} if batch_trace_id else {}))
                    # device-time partitioning: yield the ingest stream's
                    # share of the slot before the next query dispatch
                    if cfg.query_share < 1.0 and wall > 0.0:
                        _time.sleep(min(wall * (1.0 / cfg.query_share - 1.0), _MAX_YIELD_S))
        except BaseException as exc:  # surfaced through .error
            self.error = exc
            flight_recorder.record("serving.batcher_error", name=self.name, error=repr(exc))
