"""Cluster fault domain: the shared state of worker-level recovery.

A multiprocess run (``parallel/multiprocess.py``) treats each worker
process as its own fault domain: the coordinator detects a dead, hung
or partitioned worker within a configurable lease, quiesces the
survivors at the last coordinated snapshot barrier, respawns only the
dead worker, and fences zombie writes stamped with a stale cluster
generation. This module holds the pieces every layer shares:

- :class:`ClusterMetrics` / :data:`CLUSTER_METRICS` — process-wide
  counters rendered on ``/metrics`` as ``pathway_cluster_*``.
- :class:`ClusterHealth` / :data:`CLUSTER_HEALTH` — which global
  shards are currently down; the serving plane's
  ``AdmissionController`` consults it to shed or degrade queries for a
  missing shard instead of failing the whole endpoint.
- :class:`WorkerLost` — internal signal raised by the coordinator
  protocol when a worker's lease expires or its connection dies.
- :class:`ClusterRegroup` — raised out of a run attempt to request a
  partial restart (``internals/run.py`` owns the regroup loops; the
  supervisor's full-restart budget is never charged for one).
"""

from __future__ import annotations

import threading
from typing import Any

__all__ = [
    "CLUSTER_HEALTH",
    "CLUSTER_METRICS",
    "ClusterHealth",
    "ClusterMetrics",
    "ClusterRegroup",
    "WorkerLost",
]


class WorkerLost(RuntimeError):
    """A worker's lease expired or its connection died mid-protocol.

    Raised inside ``CoordinatorCluster``'s steady-state send/recv and
    converted to :class:`ClusterRegroup` (partial restart) when the run
    has persistence, or to ``EngineError`` (full restart / failure)
    when it does not."""

    def __init__(self, pid: int, reason: str):
        super().__init__(f"worker process {pid} lost ({reason})")
        self.pid = pid
        self.reason = reason


class ClusterRegroup(RuntimeError):
    """Request a partial restart of the cluster.

    On the coordinator, carries the dead worker pids to respawn and the
    freshly bumped cluster generation (already durable). On a worker,
    signals "drop engine state and rejoin the next formation". Handled
    by the regroup loops in ``internals/run.py`` — deliberately NOT a
    subclass of anything in the supervisor's default ``restart_on`` so
    a leaked regroup is visible instead of silently consuming the
    full-restart budget."""

    def __init__(
        self,
        dead_pids: list[int] | None = None,
        generation: int = -1,
        reason: str = "regroup",
    ):
        super().__init__(
            f"cluster regroup (dead={sorted(dead_pids or [])}, "
            f"generation={generation}, reason={reason})"
        )
        self.dead_pids = sorted(dead_pids or [])
        self.generation = generation
        self.reason = reason


class ClusterMetrics:
    """Thread-safe cluster fault-domain counters (one registry per
    process, rendered on ``/metrics`` only once any of them move so
    single-process output stays byte-identical)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lease_expiries: dict[str, int] = {}  # keyed by worker pid
        self._partial_restarts: dict[str, int] = {}
        self._fenced_writes: dict[str, int] = {}
        self._barriers = 0
        self._generation = 0

    def record_lease_expired(self, pid: int | str) -> None:
        with self._lock:
            k = str(pid)
            self._lease_expiries[k] = self._lease_expiries.get(k, 0) + 1

    def record_partial_restart(self, pid: int | str) -> None:
        with self._lock:
            k = str(pid)
            self._partial_restarts[k] = self._partial_restarts.get(k, 0) + 1

    def record_fenced_write(self, pid: int | str) -> None:
        with self._lock:
            k = str(pid)
            self._fenced_writes[k] = self._fenced_writes.get(k, 0) + 1

    def record_barrier(self, generation: int | None = None) -> None:
        with self._lock:
            self._barriers += 1
            if generation is not None:
                self._generation = int(generation)

    def set_generation(self, generation: int) -> None:
        with self._lock:
            self._generation = int(generation)

    def active(self) -> bool:
        """Whether anything cluster-level ever happened in this process
        (gates /metrics rendering)."""
        with self._lock:
            return bool(
                self._lease_expiries
                or self._partial_restarts
                or self._fenced_writes
                or self._barriers
                or self._generation
            )

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "lease_expiries": dict(self._lease_expiries),
                "lease_expiries_total": sum(self._lease_expiries.values()),
                "partial_restarts": dict(self._partial_restarts),
                "partial_restarts_total": sum(self._partial_restarts.values()),
                "fenced_writes": dict(self._fenced_writes),
                "fenced_writes_total": sum(self._fenced_writes.values()),
                "barriers_total": self._barriers,
                "generation": self._generation,
            }

    def reset(self) -> None:
        with self._lock:
            self._lease_expiries.clear()
            self._partial_restarts.clear()
            self._fenced_writes.clear()
            self._barriers = 0
            self._generation = 0


#: Process-wide registry surfaced on ``/metrics`` and ``/status``.
CLUSTER_METRICS = ClusterMetrics()


class ClusterHealth:
    """Which global engine shards are currently down.

    The coordinator marks a dead worker's shard range down at detection
    time and clears the registry once the next formation completes (all
    workers present again). The serving plane reads it on the admit
    path, so the granularity is a lock-guarded set lookup."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._down: set[int] = set()
        self._down_since: float | None = None
        self._retry_after_s = 1.0
        # an explicit retry_after_s= declaration pins the constant for
        # the current outage — the caller knows better than the
        # learned previous-outage heuristic
        self._retry_after_pinned = False
        self._eta_s: float | None = None  # declared recovery ETA
        self._eta_set_at: float | None = None
        self._last_outage_s = 1.0  # learned from the previous outage
        self._eta_source: Any = None  # callable -> float | None

    def set_eta_source(self, fn, *, if_unset: bool = False) -> None:
        """Register a live recovery-ETA provider (e.g. the elastic
        plane's migration ETA). Consulted first by
        :meth:`retry_after_s`; must return seconds or None. With
        ``if_unset`` a source that is already installed wins."""
        with self._lock:
            if if_unset and self._eta_source is not None:
                return
            self._eta_source = fn

    def mark_down(
        self,
        shards,
        *,
        retry_after_s: float | None = None,
        eta_s: float | None = None,
    ) -> None:
        import time as _time

        with self._lock:
            self._down.update(int(s) for s in shards)
            if self._down_since is None:
                self._down_since = _time.monotonic()
            if retry_after_s is not None:
                self._retry_after_s = max(0.0, float(retry_after_s))
                self._retry_after_pinned = True
            if eta_s is not None:
                self._eta_s = max(0.0, float(eta_s))
                self._eta_set_at = _time.monotonic()

    def mark_all_up(self) -> None:
        import time as _time

        with self._lock:
            # remember how long this outage actually took — the next
            # one's Retry-After starts from an observed figure instead
            # of the constant
            if self._down_since is not None:
                self._last_outage_s = max(
                    0.1, _time.monotonic() - self._down_since
                )
            self._down.clear()
            self._down_since = None
            self._retry_after_pinned = False
            self._eta_s = None
            self._eta_set_at = None

    def is_down(self, shard: int) -> bool:
        with self._lock:
            return int(shard) in self._down

    def down_shards(self) -> frozenset[int]:
        with self._lock:
            return frozenset(self._down)

    def any_down(self) -> bool:
        with self._lock:
            return bool(self._down)

    def retry_after_s(self) -> float:
        """Hint for Retry-After on shed responses, proportional to how
        long recovery will actually take instead of a constant:

        1. a registered live ETA source (the elastic plane's migration
           ETA while a reshard is in flight) wins;
        2. else a declared ETA from :meth:`mark_down`, decayed by the
           time already elapsed since it was declared;
        3. else, while shards are down with no explicitly declared
           ``retry_after_s``, the duration of the *previous* outage
           minus time already waited — regroups of the same cluster
           tend to take similar time;
        4. else the legacy constant.

        Always >= 0.1 s so clients never busy-spin."""
        import time as _time

        with self._lock:
            src = self._eta_source
        if src is not None:
            try:
                eta = src()  # outside the lock: the source locks itself
            except Exception:
                eta = None
            if eta is not None:
                return max(0.1, float(eta))
        with self._lock:
            now = _time.monotonic()
            if self._eta_s is not None and self._eta_set_at is not None:
                return max(0.1, self._eta_s - (now - self._eta_set_at))
            if self._down_since is not None and not self._retry_after_pinned:
                return max(0.1, self._last_outage_s - (now - self._down_since))
            return self._retry_after_s


#: Process-wide registry; the coordinator writes, serving reads.
CLUSTER_HEALTH = ClusterHealth()
