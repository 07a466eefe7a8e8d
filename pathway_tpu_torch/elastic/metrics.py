"""Elastic-plane counters behind one activity gate
(``pathway_elastic_*`` on /metrics, the ``elastic`` block on /status).

The port's copy of the reference's ``elastic/metrics.py``. It follows the
plane-registry discipline (ServingMetrics, TenancyMetrics, LEDGER, ...): a
process-wide singleton the reshard controller feeds,
``active()``-gated so runs that never reshard render nothing new —
their scrape output stays byte-identical.

The registry doubles as the migration-progress model: while a reshard
is in flight it tracks chunks done vs planned plus a chunk-rate EWMA,
and :meth:`migration_eta_s` turns that into the remaining-time estimate
the admission plane serves as ``Retry-After`` on shed responses
(``ClusterHealth`` consults it via the registered ETA source)."""

from __future__ import annotations

import threading
import time as _time

__all__ = ["ELASTIC_METRICS", "ElasticMetrics"]


class ElasticMetrics:
    """Thread-safe elastic reshard counters + live migration progress."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._reshards: dict[str, int] = {}  # reason -> completed count
        self._chunks = 0
        self._rows = 0
        self._cutovers = 0
        self._rollbacks = 0
        self._dedup_dropped = 0
        self._fenced_writes = 0
        self._last_mttr_s = 0.0
        self._generation = 0
        # live migration progress (None when idle)
        self._mig: dict | None = None

    # -- reshard lifecycle --

    def migration_begin(self, total_chunks: int, from_shards: int, to_shards: int) -> None:
        with self._lock:
            self._mig = {
                "total": max(1, int(total_chunks)),
                "done": 0,
                "from": int(from_shards),
                "to": int(to_shards),
                "t0": _time.monotonic(),
            }

    def record_chunk(self, rows: int) -> None:
        with self._lock:
            self._chunks += 1
            self._rows += max(0, int(rows))
            if self._mig is not None:
                self._mig["done"] += 1

    def record_cutover(self, generation: int, mttr_s: float, reason: str) -> None:
        with self._lock:
            self._cutovers += 1
            self._generation = int(generation)
            self._last_mttr_s = max(0.0, float(mttr_s))
            self._reshards[reason] = self._reshards.get(reason, 0) + 1
            self._mig = None

    def record_rollback(self) -> None:
        with self._lock:
            self._rollbacks += 1
            self._mig = None

    def record_dedup_dropped(self, n: int = 1) -> None:
        with self._lock:
            self._dedup_dropped += int(n)

    def record_fenced_write(self) -> None:
        with self._lock:
            self._fenced_writes += 1

    def set_generation(self, generation: int) -> None:
        with self._lock:
            self._generation = max(self._generation, int(generation))

    # -- progress / ETA --

    def migrating(self) -> bool:
        with self._lock:
            return self._mig is not None

    def migration_eta_s(self) -> float | None:
        """Remaining-migration estimate from the observed chunk rate
        (None when no migration is in flight). Before the first chunk
        lands there is no rate yet — assume one interval per chunk so
        early shed responses still carry a finite, decreasing hint."""
        with self._lock:
            mig = self._mig
            if mig is None:
                return None
            elapsed = _time.monotonic() - mig["t0"]
            remaining = max(0, mig["total"] - mig["done"])
            if mig["done"] > 0:
                per_chunk = elapsed / mig["done"]
            else:
                per_chunk = max(elapsed, 0.05)
            return remaining * per_chunk

    # -- rendering --

    def active(self) -> bool:
        """Anything elastic ever happened in this process? Gates every
        ``pathway_elastic_*`` line and the /status block."""
        with self._lock:
            return bool(
                self._reshards
                or self._chunks
                or self._rollbacks
                or self._dedup_dropped
                or self._fenced_writes
                or self._mig is not None
            )

    def snapshot(self) -> dict:
        with self._lock:
            mig = None
            if self._mig is not None:
                mig = {
                    "from_shards": self._mig["from"],
                    "to_shards": self._mig["to"],
                    "chunks_done": self._mig["done"],
                    "chunks_total": self._mig["total"],
                }
            return {
                "reshards": dict(self._reshards),
                "reshards_total": sum(self._reshards.values()),
                "chunks_migrated": self._chunks,
                "rows_migrated": self._rows,
                "cutovers_total": self._cutovers,
                "rollbacks_total": self._rollbacks,
                "dedup_dropped_total": self._dedup_dropped,
                "fenced_writes_total": self._fenced_writes,
                "last_mttr_s": round(self._last_mttr_s, 6),
                "generation": self._generation,
                "migration": mig,
            }

    def reset(self) -> None:
        with self._lock:
            self._reshards.clear()
            self._chunks = 0
            self._rows = 0
            self._cutovers = 0
            self._rollbacks = 0
            self._dedup_dropped = 0
            self._fenced_writes = 0
            self._last_mttr_s = 0.0
            self._generation = 0
            self._mig = None


#: Process-wide registry surfaced on /metrics and /status.
ELASTIC_METRICS = ElasticMetrics()
