"""Admission control and load shedding for the query path.

The port's copy of the reference's ``serving/admission.py``. The
controller sits at the front of a serving endpoint. A request is either
*admitted* (it gets a :class:`Ticket` and a slot in the bounded,
deadline-ordered ledger) or *shed* with a typed :class:`OverloadError`
mapping to an HTTP status a client can act on:

- :class:`RateLimited` (429): the endpoint's token bucket is empty;
  ``retry_after_s`` says when a token will be available.
- :class:`QueueFull` (503): the bounded queue is at capacity and the shed
  policy says reject.
- :class:`DeadlineExceeded` (503): the request cannot meet its remaining
  budget, so it is rejected early instead of queued to death.

``shed="degrade"`` turns the band between ``degrade_watermark`` and a
full queue into degraded service: the ticket is flagged and the endpoint
serves reduced work (for RAG: top-``k`` clamped to ``degrade_top_k``,
rerank skipped; for decode: ``max_new_tokens`` clamped). A full queue
still rejects.

Every decision is recorded in ``SERVING_METRICS``. The reference's
flight-recorder events, chaos site and request tracing come with ROADMAP
Queue A items 3 and 6; its shard-health gate (``shard=``) with item 5; its
per-tenant quotas with item 4, so a request that names a tenant while a
tenancy is configured raises.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
import time as _time
from dataclasses import dataclass
from typing import Optional

from .deadline import Deadline
from .metrics import SERVING_METRICS, ServingMetrics

__all__ = [
    "AdmissionController",
    "DeadlineExceeded",
    "OverloadError",
    "QueueFull",
    "RateLimited",
    "ServingConfig",
    "ShardUnavailable",
    "TenantRateLimited",
    "Ticket",
    "TokenBucket",
]

_TENANCY_ITEM = "ROADMAP Queue A item 4 (tenant quotas and weights)"
_CLUSTER_ITEM = "ROADMAP Queue A item 5 (multi-process clusters and their shard health)"


def tenancy_active() -> bool:
    """Whether a tenancy config is in effect: the port has no tenancy plane,
    so only ``PATHWAY_TENANCY`` can name one."""
    raw = os.environ.get("PATHWAY_TENANCY", "").strip().lower()
    return bool(raw) and raw not in ("0", "false", "no", "off")


class OverloadError(RuntimeError):
    """Typed overload rejection; subclasses pin the HTTP status and a
    machine-readable reason rendered into the response body."""

    status: int = 503
    reason: str = "overload"

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.trace_id: str = ""

    def to_response(self) -> dict:
        body = {"error": str(self), "reason": self.reason}
        if self.retry_after_s is not None:
            body["retry_after_ms"] = round(self.retry_after_s * 1000.0, 3)
        return body


class RateLimited(OverloadError):
    status = 429
    reason = "rate_limited"


class TenantRateLimited(RateLimited):
    """One tenant exhausted its own quota (raised by the tenancy plane,
    ROADMAP Queue A item 4)."""

    status = 429
    reason = "tenant_rate_limited"

    def __init__(self, message: str, *, retry_after_s: float | None = None, tenant: str = ""):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant

    def to_response(self) -> dict:
        body = super().to_response()
        if self.tenant:
            body["tenant"] = self.tenant
        return body


class QueueFull(OverloadError):
    status = 503
    reason = "queue_full"


class DeadlineExceeded(OverloadError):
    status = 503
    reason = "deadline_exceeded"


class ShardUnavailable(OverloadError):
    """The engine shard a query needs is down (raised by the cluster plane,
    ROADMAP Queue A item 5)."""

    status = 503
    reason = "shard_unavailable"


@dataclass
class ServingConfig:
    """Knobs of the overload-safe serving plane (one per endpoint or
    shared across an endpoint group).

    ``max_queue``: bound on concurrently admitted (in-flight) requests;
    beyond it requests are shed. ``default_deadline_ms``: server-side
    budget when the client sends no ``X-Pathway-Deadline-Ms`` header
    (None = unbounded). ``rate_limit_qps``/``rate_limit_burst``: token
    bucket at the front door (None = off). ``shed``: ``"reject"`` sheds
    with 503 at capacity; ``"degrade"`` serves reduced work once depth
    passes ``degrade_watermark`` x ``max_queue`` (and still rejects at
    capacity). ``min_service_ms``: admission rejects a request whose
    remaining budget is below this floor. ``batch_max``/
    ``batch_window_ms``/``latency_budget_ms``/``query_share``: adaptive
    batcher sizing, see :class:`~pathway_tpu_torch.serving.batching.AdaptiveBatcher`.
    """

    max_queue: int = 64
    default_deadline_ms: float | None = 5000.0
    rate_limit_qps: float | None = None
    rate_limit_burst: int = 16
    shed: str = "reject"
    degrade_top_k: int = 2
    degrade_watermark: float = 0.5
    min_service_ms: float = 0.0
    batch_max: int = 16
    batch_window_ms: float = 2.0
    latency_budget_ms: float = 100.0
    query_share: float = 0.5

    def __post_init__(self) -> None:
        if self.shed not in ("reject", "degrade"):
            raise ValueError(f"shed={self.shed!r}: expected 'reject' or 'degrade'")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not (0.0 < self.query_share <= 1.0):
            raise ValueError("query_share must be in (0, 1]")


class TokenBucket:
    """Classic token bucket: ``qps`` refill rate, ``burst`` capacity.
    Thread-safe; the clock is injectable for tests."""

    def __init__(self, qps: float, burst: int, *, clock=_time.monotonic):
        self.qps = float(qps)
        self.burst = max(1, int(burst))
        self._clock = clock
        self._tokens = float(self.burst)
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(float(self.burst), self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_acquire(self) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def retry_after(self) -> float:
        """Seconds until one token will be available."""
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.qps if self.qps > 0 else 60.0


class Ticket:
    """One admitted request's slot in the ledger."""

    __slots__ = ("deadline", "seq", "degraded", "admitted_at", "route", "trace", "tenant")

    def __init__(self, deadline: Deadline, seq: int, *, degraded: bool = False, route: str = "/", trace=None,
                 tenant: str | None = None):
        self.deadline = deadline
        self.seq = seq
        self.degraded = degraded
        self.admitted_at = _time.monotonic()
        self.route = route
        self.trace = trace
        self.tenant = tenant


class AdmissionController:
    """Bounded, deadline-ordered admission ledger + token bucket + shed
    policy for one endpoint (or endpoint group).

    ``admit`` either returns a :class:`Ticket` or raises a typed
    :class:`OverloadError`; ``release`` frees the slot when the response
    resolves. The ledger is a lazy-deletion heap keyed on deadline expiry,
    so ``next_expiry`` is O(1) amortised.
    """

    def __init__(self, config: ServingConfig | None = None, *, metrics: ServingMetrics | None = None,
                 route: str = "/"):
        self.config = config or ServingConfig()
        self.metrics = metrics if metrics is not None else SERVING_METRICS
        self.route = route
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._live: set[int] = set()
        self._heap: list[tuple[float, int]] = []  # (expires_at, seq)
        self._bucket: Optional[TokenBucket] = None
        if self.config.rate_limit_qps:
            self._bucket = TokenBucket(self.config.rate_limit_qps, self.config.rate_limit_burst)

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._live)

    def next_expiry(self) -> float | None:
        """Earliest live deadline's monotonic expiry (None when idle)."""
        with self._lock:
            while self._heap and self._heap[0][1] not in self._live:
                heapq.heappop(self._heap)
            return self._heap[0][0] if self._heap else None

    def admit(self, deadline: Deadline | None = None, *, shard: int | None = None,
              tenant: str | None = None) -> Ticket:
        """Admit or shed. Raises :class:`RateLimited` / :class:`QueueFull` /
        :class:`DeadlineExceeded`. ``tenant`` attributes the request to a
        tenant; under a configured tenancy its quotas would apply first,
        which needs the tenancy plane and raises. ``shard`` pins the request
        to an engine shard, whose health the cluster plane keeps: it
        raises."""
        cfg = self.config
        if deadline is None:
            deadline = Deadline(cfg.default_deadline_ms)
        if tenant is not None:
            tenant = str(tenant)
            self._check_tenant(tenant)
        if shard is not None:
            raise NotImplementedError(f"AdmissionController.admit(shard=...) needs {_CLUSTER_ITEM}")

        t0 = _time.monotonic()
        if self._bucket is not None and not self._bucket.try_acquire():
            retry_after = self._bucket.retry_after()
            self.metrics.record_shed("rate_limited")
            raise RateLimited(f"rate limit ({cfg.rate_limit_qps:g} qps) exceeded", retry_after_s=retry_after)

        remaining_ms = deadline.remaining_ms()
        if remaining_ms <= cfg.min_service_ms:
            self.metrics.record_shed("deadline_exceeded")
            self.metrics.record_deadline_expired()
            raise DeadlineExceeded(
                "request cannot meet its remaining budget "
                f"({remaining_ms:.0f} ms left, floor {cfg.min_service_ms:g} ms)"
            )

        with self._lock:
            depth = len(self._live)
            if depth >= cfg.max_queue:
                self.metrics.record_shed("queue_full")
                raise QueueFull(
                    f"admission queue full ({depth}/{cfg.max_queue})",
                    retry_after_s=deadline.remaining() if remaining_ms < 1e12 else None,
                )
            degraded = cfg.shed == "degrade" and depth >= cfg.degrade_watermark * cfg.max_queue
            seq = next(self._seq)
            self._live.add(seq)
            heapq.heappush(self._heap, (deadline.expires_at, seq))
            new_depth = len(self._live)

        ticket = Ticket(deadline, seq, degraded=degraded, route=self.route, tenant=tenant)
        self.metrics.record_admit(degraded=degraded)
        self.metrics.set_queue_depth(new_depth)
        self.metrics.observe_stage("admission", _time.monotonic() - t0)
        return ticket

    def _check_tenant(self, tenant: str) -> None:
        """Per-tenant quota gates, enforced before every endpoint-wide gate
        in the reference. Without a configured tenancy a tenant carries no
        quota and the request is only attributed to it."""
        if tenancy_active():
            raise NotImplementedError(f"admission for tenant {tenant!r} under PATHWAY_TENANCY needs {_TENANCY_ITEM}")

    def release(self, ticket: Ticket) -> None:
        with self._lock:
            self._live.discard(ticket.seq)
            depth = len(self._live)
        self.metrics.set_queue_depth(depth)

    def expire(self, ticket: Ticket) -> DeadlineExceeded:
        """Record a mid-pipeline budget expiry (the response wait ran out)
        and build the typed error for the HTTP surface."""
        self.metrics.record_deadline_expired()
        self.metrics.record_shed("deadline_exceeded")
        return DeadlineExceeded("deadline expired before the pipeline produced a response")
