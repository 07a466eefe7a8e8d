"""Serving-plane metrics registry.

The port's copy of the reference's ``serving/metrics.py``: a process-wide,
thread-safe registry of admission outcomes, queue depth, batch shape and
per-stage latency. Counters are monotonic; gauges reflect the last
observation; per-stage latency histograms use fixed buckets, so a
Prometheus rendering gets cumulative ``_bucket`` / ``_sum`` / ``_count``
series. The monitoring HTTP server renders it on ``/metrics``
(``pathway_serving_*``) and ``/status`` once it has seen traffic.
"""

from __future__ import annotations

import threading

#: Histogram bucket upper bounds in seconds (request-latency scale:
#: 1 ms .. 10 s, then +Inf).
STAGE_BUCKETS: tuple[float, ...] = (
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)

#: Stage names every request can traverse:
#: ``admission`` (handler entry → admitted), ``queue`` (admitted →
#: batch dispatch), ``dispatch`` (fused engine dispatch wall), ``total``
#: (handler entry → response resolved).
STAGES = ("admission", "queue", "dispatch", "total")


class StageHistogram:
    """Fixed-bucket latency histogram (not thread-safe on its own; the
    owning :class:`ServingMetrics` serializes access)."""

    __slots__ = ("counts", "total", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(STAGE_BUCKETS) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        for i, le in enumerate(STAGE_BUCKETS):
            if seconds <= le:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += seconds
        self.count += 1

    def cumulative(self) -> list[tuple[str, int]]:
        """Prometheus-style cumulative (le, count) pairs ending at +Inf."""
        out = []
        running = 0
        for le, c in zip(STAGE_BUCKETS, self.counts):
            running += c
            out.append((f"{le:g}", running))
        running += self.counts[-1]
        out.append(("+Inf", running))
        return out


class ServingMetrics:
    """Thread-safe serving-plane accounting: admission outcomes, queue
    depth, batch shape, and per-stage latency."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.admitted_total = 0
        self.degraded_total = 0
        self.deadline_expired_total = 0
        self.shed_total: dict[str, int] = {}  # reason -> count
        self.queue_depth = 0
        self.inflight = 0
        self.batches_total = 0
        self.batched_queries_total = 0
        self.last_batch_size = 0
        self.ewma_item_s = 0.0
        self.stages: dict[str, StageHistogram] = {s: StageHistogram() for s in STAGES}

    # -- admission outcomes --

    def record_admit(self, *, degraded: bool = False) -> None:
        with self._lock:
            self.admitted_total += 1
            if degraded:
                self.degraded_total += 1

    def record_shed(self, reason: str) -> None:
        with self._lock:
            self.shed_total[reason] = self.shed_total.get(reason, 0) + 1

    def record_deadline_expired(self) -> None:
        with self._lock:
            self.deadline_expired_total += 1

    # -- gauges --

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)

    def set_inflight(self, n: int) -> None:
        with self._lock:
            self.inflight = int(n)

    # -- batching --

    def record_batch(self, size: int, ewma_item_s: float) -> None:
        with self._lock:
            self.batches_total += 1
            self.batched_queries_total += int(size)
            self.last_batch_size = int(size)
            self.ewma_item_s = float(ewma_item_s)

    # -- latency --

    def observe_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            hist = self.stages.get(stage)
            if hist is None:
                hist = self.stages[stage] = StageHistogram()
            hist.observe(seconds)

    # -- surfaces --

    @property
    def shed_sum(self) -> int:
        return sum(self.shed_total.values())

    def active(self) -> bool:
        """Anything to render? (keeps /metrics byte-identical for runs
        that never touch the serving plane)"""
        with self._lock:
            return bool(
                self.admitted_total
                or self.shed_total
                or self.deadline_expired_total
                or self.batches_total
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "admitted_total": self.admitted_total,
                "degraded_total": self.degraded_total,
                "deadline_expired_total": self.deadline_expired_total,
                "shed_total": dict(self.shed_total),
                "queue_depth": self.queue_depth,
                "inflight": self.inflight,
                "batches_total": self.batches_total,
                "batched_queries_total": self.batched_queries_total,
                "last_batch_size": self.last_batch_size,
                "ewma_item_s": self.ewma_item_s,
                "stage_latency_s": {
                    s: {"count": h.count, "sum": round(h.total, 6)}
                    for s, h in self.stages.items()
                    if h.count
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.admitted_total = 0
            self.degraded_total = 0
            self.deadline_expired_total = 0
            self.shed_total.clear()
            self.queue_depth = 0
            self.inflight = 0
            self.batches_total = 0
            self.batched_queries_total = 0
            self.last_batch_size = 0
            self.ewma_item_s = 0.0
            self.stages = {s: StageHistogram() for s in STAGES}


#: Process-wide registry.
SERVING_METRICS = ServingMetrics()
