"""``pathway_request_stage_seconds`` — per-stage request latency with
trace-id exemplars.

The port's copy of the reference's ``tracing/metrics.py``. Same registry
discipline as every other plane (``SERVING_METRICS``, ``INDEX_METRICS``,
...): a process-wide singleton the monitoring HTTP server renders only
when :meth:`TracingMetrics.active` — a run that never records a span
scrapes byte-identical output. Buckets reuse the serving plane's
request-latency scale. Each bucket remembers the last trace id that
landed in it, rendered as an OpenMetrics exemplar
(``... # {trace_id="..."} value timestamp``) so a dashboard's p99 bucket links
straight to ``pathway trace show <id>``.
"""

from __future__ import annotations

import threading
import time as _time

from ..serving.metrics import STAGE_BUCKETS


class _ExemplarHistogram:
    """Fixed-bucket histogram where every bucket keeps its most recent
    (trace_id, value, unix_ts) exemplar."""

    __slots__ = ("counts", "total", "count", "exemplars")

    def __init__(self) -> None:
        self.counts = [0] * (len(STAGE_BUCKETS) + 1)
        self.exemplars: list[tuple[str, float, float] | None] = [None] * (
            len(STAGE_BUCKETS) + 1
        )
        self.total = 0.0
        self.count = 0

    def observe(self, seconds: float, trace_id: str) -> None:
        seconds = max(0.0, float(seconds))
        idx = len(STAGE_BUCKETS)
        for i, le in enumerate(STAGE_BUCKETS):
            if seconds <= le:
                idx = i
                break
        self.counts[idx] += 1
        if trace_id:
            self.exemplars[idx] = (trace_id, seconds, _time.time())
        self.total += seconds
        self.count += 1

    def cumulative(self) -> list[tuple[str, int, tuple[str, float, float] | None]]:
        """(le, cumulative count, bucket exemplar) ending at +Inf."""
        out = []
        running = 0
        for i, le in enumerate(STAGE_BUCKETS):
            running += self.counts[i]
            out.append((f"{le:g}", running, self.exemplars[i]))
        running += self.counts[-1]
        out.append(("+Inf", running, self.exemplars[-1]))
        return out


class TracingMetrics:
    """Thread-safe (stage, worker) → latency histogram registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: dict[tuple[str, int], _ExemplarHistogram] = {}

    def observe(
        self, stage: str, seconds: float, trace_id: str, *, worker: int = 0
    ) -> None:
        key = (stage, int(worker))
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _ExemplarHistogram()
            hist.observe(seconds, trace_id)

    def active(self) -> bool:
        """Anything to render? (keeps /metrics byte-identical for runs
        that never record a span)"""
        with self._lock:
            return bool(self._hists)

    def series(self) -> list[dict]:
        """Render-ready rows for the monitoring server, sorted for
        stable scrape output."""
        with self._lock:
            items = sorted(self._hists.items())
            out = []
            for (stage, worker), hist in items:
                out.append(
                    {
                        "stage": stage,
                        "worker": worker,
                        "sum": hist.total,
                        "count": hist.count,
                        "buckets": hist.cumulative(),
                    }
                )
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                f"{stage}[w{worker}]": {
                    "count": h.count,
                    "sum": round(h.total, 6),
                }
                for (stage, worker), h in sorted(self._hists.items())
                if h.count
            }

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


#: Process-wide registry surfaced on ``/metrics`` and ``/status``.
TRACING_METRICS = TracingMetrics()
