"""Process-wide registry for the collaborative host-ingest plane.

Mirrors ``ops/index_metrics.py``: one thread-safe singleton the stage
updates from its hot paths (plain counter bumps under a lock), rendered
conditionally by ``MonitoringHttpServer._ingest_lines`` and the
dashboard — ``active()`` gates every surface so pipelines that never
configure an ingest stage keep byte-identical ``/metrics`` output.
"""

from __future__ import annotations

import threading
import time


class IngestMetrics:
    """Counters/gauges for the host ingest stage (``pathway_ingest_*``).

    ``utilization()`` is busy worker-seconds over available
    worker-seconds: the available denominator integrates the (possibly
    autoscaled) worker count over wall time, so growing the pool with
    an idle queue *lowers* utilization — the signal the autoscaler
    shrinks on.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.enqueued_total = 0
            self.dequeued_total = 0
            self.committed_total = 0
            self.retried_total = 0  # chaos-killed worker tasks re-run inline
            self.queue_depth = 0
            self.queue_high_water = 0
            self.host_workers = 0
            self.scale_up_total = 0
            self.scale_down_total = 0
            self.routed_short_total = 0
            self.routed_long_total = 0
            self.busy_s = 0.0
            # worker-seconds integral for the utilization denominator
            self._avail_s = 0.0
            self._avail_mark: float | None = None
            self._active = False

    def active(self) -> bool:
        with self._lock:
            return self._active

    # -- stage hot-path hooks --

    def set_workers(self, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._integrate(now)
            self.host_workers = int(n)
            self._active = True

    def note_enqueue(self, depth: int) -> None:
        with self._lock:
            self.enqueued_total += 1
            self.queue_depth = depth
            self.queue_high_water = max(self.queue_high_water, depth)
            self._active = True

    def note_dequeue(self, depth: int, busy_s: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._integrate(now)
            self.dequeued_total += 1
            self.queue_depth = depth
            self.busy_s += max(0.0, busy_s)

    def note_commit(self, retried: bool = False) -> None:
        with self._lock:
            self.committed_total += 1
            if retried:
                self.retried_total += 1

    def note_scale(self, direction: int) -> None:
        with self._lock:
            if direction > 0:
                self.scale_up_total += 1
            else:
                self.scale_down_total += 1

    def note_route(self, short_n: int, long_n: int) -> None:
        with self._lock:
            self.routed_short_total += int(short_n)
            self.routed_long_total += int(long_n)

    def _integrate(self, now: float) -> None:
        # caller holds self._lock
        if self._avail_mark is not None:
            self._avail_s += max(0.0, now - self._avail_mark) * self.host_workers
        self._avail_mark = now

    def utilization(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._integrate(now)
            if self._avail_s <= 0.0:
                return 0.0
            return min(1.0, self.busy_s / self._avail_s)

    def snapshot(self) -> dict:
        util = self.utilization()
        with self._lock:
            return {
                "enqueued": self.enqueued_total,
                "dequeued": self.dequeued_total,
                "committed": self.committed_total,
                "retried": self.retried_total,
                "queue_depth": self.queue_depth,
                "queue_high_water": self.queue_high_water,
                "host_workers": self.host_workers,
                "scale_up": self.scale_up_total,
                "scale_down": self.scale_down_total,
                "routed_short": self.routed_short_total,
                "routed_long": self.routed_long_total,
                "busy_s": round(self.busy_s, 6),
                "utilization": round(util, 4),
            }


INGEST_METRICS = IngestMetrics()
