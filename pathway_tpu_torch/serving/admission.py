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

Every decision is recorded in ``SERVING_METRICS`` and the flight recorder
(``serving.admit`` / ``serving.shed`` / ``serving.deadline_expired``); with
tracing on, an admitted request gets an ``admission`` span and a typed
rejection carries the request's trace id. A request that names a tenant
(``tenant=``, the REST reader's ``X-Pathway-Tenant`` header) under an
active tenancy (``tenancy.active_tenancy``: ``pw.run(tenancy=)``, else
``PATHWAY_TENANCY``) meets its tenant's quotas first: a QPS bucket and an
in-flight cap, each shedding a typed 429 ``tenant_rate_limited`` before
any endpoint-wide gate. The ``serving.admit`` chaos site fires before any
shed decision (a delay rule there models a burst piling up at the front
door). While an elastic reshard migrates an index (``elastic``), a
``shed="degrade"`` endpoint degrades instead of rejecting: requests keep
flowing against the old generation with the degraded flag, and a shed
that still happens (a full queue) carries the migration's remaining-time
estimate as ``Retry-After`` (the cluster-health plane's ETA source, which
the elastic plane installs). A request pinned to an engine shard
(``shard=``) whose worker process is down (the cluster fault domain marks
its shards while a partial restart is in flight) is shed as a typed 503,
or served degraded by a ``shed="degrade"`` endpoint; tenant quotas are
checked first, so a tenant at its cap always sees its 429.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from dataclasses import dataclass
from typing import Optional

from ..internals import flight_recorder
from ..resilience import chaos as _chaos
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

_tracing_store = None


def _tracing_enabled() -> bool:
    """Cheap gate for the admit hot path (caches the module lookup so the
    tracing-off cost is one global read + one attribute call)."""
    global _tracing_store
    if _tracing_store is None:
        from ..tracing import store as _ts

        _tracing_store = _ts
    return _tracing_store.tracing_enabled()


def tenancy_active() -> bool:
    """Whether a tenancy config is in effect, with ``active_tenancy``'s
    precedence (the run-scoped config, then ``PATHWAY_TENANCY``)."""
    from ..tenancy.config import active_tenancy

    return active_tenancy() is not None


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
    """One tenant exhausted *its own* quota (QPS bucket or inflight cap of
    its :class:`~pathway_tpu_torch.tenancy.TenantQuotas`): the endpoint as a
    whole is healthy, only this tenant backs off. Checked before every
    endpoint-wide gate, so a tenant at its cap always sees a 429
    ``tenant_rate_limited``, never a racy 503."""

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
    """The engine shard a query needs is down: its worker process died and
    a partial restart is in flight. ``Retry-After`` is about the cluster's
    lease."""

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
        # per-tenant fair-share state, populated only when a tenant-carrying
        # request arrives under an active tenancy
        self._tenant_buckets: dict[str, tuple[float, int, TokenBucket]] = {}
        self._tenant_inflight: dict[str, int] = {}

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
        """Admit or shed. Raises :class:`TenantRateLimited` /
        :class:`RateLimited` / :class:`QueueFull` / :class:`DeadlineExceeded`
        / :class:`ShardUnavailable`. ``tenant`` names the requesting tenant;
        under an active tenancy its quotas (QPS bucket, inflight cap) are
        enforced before any endpoint-wide gate, the shard's health
        included. ``shard`` pins the request to an engine shard: while the
        cluster fault domain has it marked down, the request is shed, or
        under ``shed="degrade"`` admitted as a degraded ticket."""
        cfg = self.config
        t_enter = _time.monotonic()
        if deadline is None:
            deadline = Deadline(cfg.default_deadline_ms)
        # request-journey tracing: the inbound traceparent (bound by the
        # HTTP surface) wins; otherwise the journey starts here, and shed
        # events and typed rejections carry the trace id too
        trace_ctx = None
        trace_extra: dict = {}
        if _tracing_enabled():
            from .. import tracing as _tracing

            trace_ctx = _tracing.ensure_trace()
            trace_extra = {"trace": trace_ctx.trace_id}
        # burst-arrival chaos site: a delay rule here simulates a thundering
        # herd piling up at the front door
        _chaos.inject("serving.admit")
        if tenant is not None:
            tenant = str(tenant)
            self._check_tenant(tenant, trace_ctx, trace_extra)
        shard_degraded = False
        if shard is not None:
            from ..resilience.cluster import CLUSTER_HEALTH

            if CLUSTER_HEALTH.is_down(shard):
                if cfg.shed == "degrade":
                    shard_degraded = True
                else:
                    self.metrics.record_shed("shard_unavailable")
                    flight_recorder.record("serving.shed", route=self.route, reason="shard_unavailable",
                                           shard=int(shard), **trace_extra)
                    raise self._traced(
                        ShardUnavailable(f"shard {shard} is down (partial restart in flight)",
                                         retry_after_s=CLUSTER_HEALTH.retry_after_s()),
                        trace_ctx,
                    )
        # elastic migration in flight: degrade, not reject: requests keep
        # flowing against the old generation (the reshard plane drops none)
        # but carry the degraded flag so later stages can cheapen, and a
        # shed (a full queue) derives Retry-After from the migration ETA
        from ..elastic.metrics import ELASTIC_METRICS

        migrating = ELASTIC_METRICS.migrating()

        t0 = _time.monotonic()
        if self._bucket is not None and not self._bucket.try_acquire():
            retry_after = self._bucket.retry_after()
            self.metrics.record_shed("rate_limited")
            flight_recorder.record("serving.shed", route=self.route, reason="rate_limited", **trace_extra)
            raise self._traced(
                RateLimited(f"rate limit ({cfg.rate_limit_qps:g} qps) exceeded", retry_after_s=retry_after),
                trace_ctx,
            )

        remaining_ms = deadline.remaining_ms()
        if remaining_ms <= cfg.min_service_ms:
            self.metrics.record_shed("deadline_exceeded")
            self.metrics.record_deadline_expired()
            flight_recorder.record("serving.deadline_expired", route=self.route,
                                   remaining_ms=round(min(remaining_ms, 1e12), 3), **trace_extra)
            raise self._traced(
                DeadlineExceeded(
                    "request cannot meet its remaining budget "
                    f"({remaining_ms:.0f} ms left, floor {cfg.min_service_ms:g} ms)"
                ),
                trace_ctx,
            )

        with self._lock:
            depth = len(self._live)
            if depth >= cfg.max_queue:
                self.metrics.record_shed("queue_full")
                flight_recorder.record("serving.shed", route=self.route, reason="queue_full", depth=depth,
                                       **trace_extra)
                if migrating:
                    from ..resilience.cluster import CLUSTER_HEALTH

                    retry_after = CLUSTER_HEALTH.retry_after_s()
                else:
                    retry_after = deadline.remaining() if remaining_ms < 1e12 else None
                raise self._traced(
                    QueueFull(f"admission queue full ({depth}/{cfg.max_queue})", retry_after_s=retry_after),
                    trace_ctx,
                )
            degraded = shard_degraded or (
                cfg.shed == "degrade" and (migrating or depth >= cfg.degrade_watermark * cfg.max_queue))
            seq = next(self._seq)
            self._live.add(seq)
            heapq.heappush(self._heap, (deadline.expires_at, seq))
            new_depth = len(self._live)
            tenant_inflight = None
            if tenant is not None:
                tenant_inflight = self._tenant_inflight.get(tenant, 0) + 1
                self._tenant_inflight[tenant] = tenant_inflight

        ticket = Ticket(deadline, seq, degraded=degraded, route=self.route, trace=trace_ctx, tenant=tenant)
        self.metrics.record_admit(degraded=degraded)
        if tenant is not None:
            from ..tenancy.metrics import TENANCY_METRICS

            TENANCY_METRICS.record_admit(tenant, degraded=degraded)
            TENANCY_METRICS.set_inflight(tenant, tenant_inflight)
        self.metrics.set_queue_depth(new_depth)
        self.metrics.observe_stage("admission", _time.monotonic() - t0)
        flight_recorder.record("serving.admit", route=self.route, depth=new_depth, degraded=degraded, **trace_extra)
        if trace_ctx is not None:
            from ..tracing import record_span

            record_span("admission", start_mono=t_enter, end_mono=_time.monotonic(), ctx=trace_ctx,
                        depth=new_depth, degraded=degraded)
        return ticket

    @staticmethod
    def _traced(exc: "OverloadError", trace_ctx) -> "OverloadError":
        if trace_ctx is not None:
            exc.trace_id = trace_ctx.trace_id
        return exc

    def _check_tenant(self, tenant: str, trace_ctx, trace_extra) -> "TenantQuotas | None":
        """Per-tenant quota gates (QPS bucket, inflight cap), enforced before
        every endpoint-wide gate. Returns the tenant's quotas (None when no
        tenancy config names this tenant: the request is still attributed
        to it, just without a quota)."""
        from ..tenancy.config import active_tenancy
        from ..tenancy.metrics import TENANCY_METRICS

        cfg = active_tenancy()
        quota = cfg.quota_for(tenant) if cfg is not None else None
        if quota is None:
            return None
        if quota.qps is not None:
            with self._lock:
                entry = self._tenant_buckets.get(tenant)
                if entry is None or entry[0] != quota.qps or entry[1] != quota.burst:
                    entry = (quota.qps, quota.burst, TokenBucket(quota.qps, quota.burst))
                    self._tenant_buckets[tenant] = entry
            bucket = entry[2]
            if not bucket.try_acquire():
                self.metrics.record_shed("tenant_rate_limited")
                TENANCY_METRICS.record_shed(tenant, "tenant_rate_limited")
                flight_recorder.record("tenant.shed", route=self.route, tenant=tenant, reason="qps", **trace_extra)
                raise self._traced(
                    TenantRateLimited(f"tenant {tenant!r} exceeded its rate quota ({quota.qps:g} qps)",
                                      retry_after_s=bucket.retry_after(), tenant=tenant),
                    trace_ctx,
                )
        if quota.max_inflight is not None:
            with self._lock:
                inflight = self._tenant_inflight.get(tenant, 0)
            if inflight >= quota.max_inflight:
                self.metrics.record_shed("tenant_rate_limited")
                TENANCY_METRICS.record_shed(tenant, "tenant_rate_limited")
                flight_recorder.record("tenant.shed", route=self.route, tenant=tenant, reason="inflight",
                                       inflight=inflight, **trace_extra)
                raise self._traced(
                    TenantRateLimited(f"tenant {tenant!r} is at its inflight cap ({inflight}/{quota.max_inflight})",
                                      tenant=tenant),
                    trace_ctx,
                )
        return quota

    def release(self, ticket: Ticket) -> None:
        tenant = ticket.tenant
        tenant_inflight = None
        with self._lock:
            self._live.discard(ticket.seq)
            depth = len(self._live)
            if tenant is not None:
                tenant_inflight = max(0, self._tenant_inflight.get(tenant, 0) - 1)
                self._tenant_inflight[tenant] = tenant_inflight
        self.metrics.set_queue_depth(depth)
        if tenant is not None:
            from ..tenancy.metrics import TENANCY_METRICS

            TENANCY_METRICS.set_inflight(tenant, tenant_inflight)

    def expire(self, ticket: Ticket) -> DeadlineExceeded:
        """Record a mid-pipeline budget expiry (the response wait ran out)
        and build the typed error for the HTTP surface."""
        self.metrics.record_deadline_expired()
        self.metrics.record_shed("deadline_exceeded")
        trace_extra = {"trace": ticket.trace.trace_id} if ticket.trace is not None else {}
        flight_recorder.record("serving.deadline_expired", route=self.route,
                               waited_ms=round((_time.monotonic() - ticket.admitted_at) * 1000.0, 3), **trace_extra)
        return self._traced(DeadlineExceeded("deadline expired before the pipeline produced a response"), ticket.trace)
