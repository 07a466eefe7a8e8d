"""Index-plane metrics registry (``pathway_index_*`` series).

The port's copy of the reference's ``ops/index_metrics.py``. Mirrors
:class:`pathway_tpu_torch.serving.metrics.ServingMetrics`: a process-wide,
thread-safe registry the monitoring HTTP server renders on ``/metrics``
and ``/status``. One entry per live
:class:`~pathway_tpu_torch.ops.knn.DeviceKnnIndex` (keyed by its
``name``), holding the per-shard doc counts the hash router produced, the
per-shard capacity, and search counters; plus one process-wide histogram
of the cross-shard merge's wall time (the second phase of a sharded
search, ``knn_topk_sharded_merge`` on the cards).
"""

from __future__ import annotations

import threading

#: Merge latency buckets in seconds. The merge moves [q, n_shards*k]
#: floats — microseconds on the cards, sub-ms on the CPU — so the buckets
#: start far below the serving-stage scale.
MERGE_BUCKETS: tuple[float, ...] = (
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    1.0,
)


class MergeHistogram:
    """Fixed-bucket histogram (access serialized by IndexMetrics)."""

    __slots__ = ("counts", "total", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(MERGE_BUCKETS) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        for i, le in enumerate(MERGE_BUCKETS):
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
        for le, c in zip(MERGE_BUCKETS, self.counts):
            running += c
            out.append((f"{le:g}", running))
        running += self.counts[-1]
        out.append(("+Inf", running))
        return out


class IndexMetrics:
    """Thread-safe accounting for device-backed indexes: shard layout,
    occupancy, imbalance, and merge-collective latency."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> {"docs_shard": [int], "shard_capacity": int,
        #          "searches": int, "queries": int} plus, for tiered
        # indexes only: cold_docs_shard / hot_bytes_shard /
        # cold_bytes_shard / promotions / demotions / hot_hits /
        # cold_hits (absent keys keep flat-index output byte-identical)
        self.indexes: dict[str, dict] = {}
        self.merge = MergeHistogram()
        self.cold_fetch = MergeHistogram()

    def update_index(
        self,
        name: str,
        docs_shard: list[int],
        shard_capacity: int,
        cold_docs_shard: list[int] | None = None,
        hot_bytes_shard: list[int] | None = None,
        cold_bytes_shard: list[int] | None = None,
    ) -> None:
        with self._lock:
            entry = self.indexes.setdefault(
                name, {"searches": 0, "queries": 0}
            )
            entry["docs_shard"] = list(docs_shard)
            entry["shard_capacity"] = int(shard_capacity)
            if cold_docs_shard is not None:
                entry["cold_docs_shard"] = list(cold_docs_shard)
                entry["hot_bytes_shard"] = list(hot_bytes_shard or [])
                entry["cold_bytes_shard"] = list(cold_bytes_shard or [])

    def record_tier_events(
        self, name: str, promotions: int = 0, demotions: int = 0
    ) -> None:
        with self._lock:
            entry = self.indexes.setdefault(
                name, {"docs_shard": [], "shard_capacity": 0, "searches": 0, "queries": 0}
            )
            entry["promotions"] = entry.get("promotions", 0) + int(promotions)
            entry["demotions"] = entry.get("demotions", 0) + int(demotions)

    def record_tier_hits(self, name: str, hot_n: int, cold_n: int) -> None:
        with self._lock:
            entry = self.indexes.setdefault(
                name, {"docs_shard": [], "shard_capacity": 0, "searches": 0, "queries": 0}
            )
            entry["hot_hits"] = entry.get("hot_hits", 0) + int(hot_n)
            entry["cold_hits"] = entry.get("cold_hits", 0) + int(cold_n)

    def observe_cold_fetch(self, seconds: float) -> None:
        with self._lock:
            self.cold_fetch.observe(seconds)

    def record_search(self, name: str, n_queries: int) -> None:
        with self._lock:
            entry = self.indexes.setdefault(
                name, {"docs_shard": [], "shard_capacity": 0, "searches": 0, "queries": 0}
            )
            entry["searches"] += 1
            entry["queries"] += int(n_queries)

    def observe_merge(self, seconds: float) -> None:
        with self._lock:
            self.merge.observe(seconds)

    @staticmethod
    def imbalance(docs_shard: list[int]) -> float:
        """Shard-imbalance gauge: max/mean doc count (1.0 = perfectly
        balanced; the hash router keeps this near 1 at scale). 0 when
        the index is empty."""
        total = sum(docs_shard)
        if not docs_shard or total <= 0:
            return 0.0
        mean = total / len(docs_shard)
        return max(docs_shard) / mean

    def active(self) -> bool:
        """Anything to render? (keeps /metrics byte-identical for runs
        that never touch a device-backed index)"""
        with self._lock:
            return bool(self.indexes)

    def tiered_active(self) -> bool:
        """Any tiered accounting recorded? Gates every
        ``pathway_index_tier_*`` line so flat-index runs keep /metrics,
        /status, and the dashboard byte-identical."""
        with self._lock:
            return any(
                "cold_docs_shard" in e or "promotions" in e or "hot_hits" in e
                for e in self.indexes.values()
            )

    def snapshot(self) -> dict:
        with self._lock:
            tiered = False
            out = {}
            for name, e in self.indexes.items():
                docs = e.get("docs_shard", [])
                cold = e.get("cold_docs_shard")
                # imbalance counts BOTH tiers: a shard whose corpus is
                # merely demoted is occupied, not empty
                both = (
                    [h + c for h, c in zip(docs, cold)]
                    if cold and len(cold) == len(docs)
                    else docs
                )
                out[name] = {
                    "docs": sum(both),
                    "docs_shard": list(docs),
                    "shards": len(docs),
                    "shard_capacity": e.get("shard_capacity", 0),
                    "imbalance": round(self.imbalance(both), 4),
                    "searches": e["searches"],
                    "queries": e["queries"],
                }
                if cold is not None or "promotions" in e or "hot_hits" in e:
                    tiered = True
                    hot_hits = e.get("hot_hits", 0)
                    cold_hits = e.get("cold_hits", 0)
                    total_hits = hot_hits + cold_hits
                    out[name]["tiers"] = {
                        "hot_docs": sum(docs),
                        "cold_docs": sum(cold or []),
                        "cold_docs_shard": list(cold or []),
                        "hot_bytes": sum(e.get("hot_bytes_shard", [])),
                        "cold_bytes": sum(e.get("cold_bytes_shard", [])),
                        "hot_bytes_shard": list(e.get("hot_bytes_shard", [])),
                        "cold_bytes_shard": list(e.get("cold_bytes_shard", [])),
                        "promotions": e.get("promotions", 0),
                        "demotions": e.get("demotions", 0),
                        "hot_hit_ratio": (
                            round(hot_hits / total_hits, 4) if total_hits else 1.0
                        ),
                    }
            snap = {
                "indexes": out,
                "merge_seconds": {
                    "count": self.merge.count,
                    "sum": round(self.merge.total, 6),
                },
            }
            if tiered:
                snap["cold_fetch_seconds"] = {
                    "count": self.cold_fetch.count,
                    "sum": round(self.cold_fetch.total, 6),
                }
            return snap

    def reset(self) -> None:
        with self._lock:
            self.indexes.clear()
            self.merge = MergeHistogram()
            self.cold_fetch = MergeHistogram()


#: Process-wide registry surfaced on ``/metrics`` and ``/status``.
INDEX_METRICS = IndexMetrics()
