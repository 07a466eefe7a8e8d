"""Unified retry policy shared by connectors, UDF executors and xpacks.

Promoted out of ``io/http/_retry.py`` so every layer that talks to a
flaky dependency — connector reader loops, LLM xpack call sites,
``AsyncTransformer.invoke`` — turns the same knob. The policy is
exponential backoff with *seedable* jitter (pass ``seed=`` or a
``random.Random`` via ``rng=``) and an injectable ``sleep`` clock so
tests run instantly and deterministically.

Attempt history is recorded per scope (e.g. ``"connector:orders"``)
into the module-global :data:`RETRY_METRICS` registry, which the
monitoring HTTP server renders on ``/metrics`` as
``pathway_retry_attempts_total{scope=...}`` counters.
"""

from __future__ import annotations

import random
import threading
import time as _time
from typing import Any, Callable

# HTTP status codes worth a retry. ``io/http/_retry.py`` re-exports
# this tuple (rather than keeping its own copy) so the two lists
# cannot drift.
DEFAULT_RETRY_CODES: tuple[int, ...] = (429, 500, 502, 503, 504)


class RetryMetrics:
    """Thread-safe per-scope attempt accounting.

    One bucket per scope with four monotonic counters: ``attempts``
    (every call of the wrapped function), ``retries`` (attempts that
    failed but will be repeated), ``successes`` and ``failures``
    (terminal outcomes).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scopes: dict[str, dict[str, int]] = {}

    def _bucket(self, scope: str) -> dict[str, int]:
        return self._scopes.setdefault(
            scope, {"attempts": 0, "retries": 0, "successes": 0, "failures": 0}
        )

    def record_attempt(self, scope: str) -> None:
        with self._lock:
            self._bucket(scope)["attempts"] += 1

    def record_retry(self, scope: str) -> None:
        with self._lock:
            self._bucket(scope)["retries"] += 1
        # black-box visibility: retries are the early warning of a
        # degrading dependency, worth their slot in the crash ring
        from ..internals import flight_recorder

        flight_recorder.record("retry.attempt", scope=scope)

    def record_success(self, scope: str) -> None:
        with self._lock:
            self._bucket(scope)["successes"] += 1

    def record_failure(self, scope: str) -> None:
        with self._lock:
            self._bucket(scope)["failures"] += 1
        from ..internals import flight_recorder

        flight_recorder.record("retry.failure", scope=scope)

    def snapshot(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {scope: dict(counts) for scope, counts in self._scopes.items()}

    def reset(self) -> None:
        with self._lock:
            self._scopes.clear()


#: Process-wide registry surfaced on ``/metrics`` and ``/status``.
RETRY_METRICS = RetryMetrics()


class RetryPolicy:
    """Exponential backoff with seedable jitter and a bounded budget.

    Parameters mirror the historical HTTP connector policy
    (``first_delay_ms`` / ``backoff_factor`` / ``jitter_ms``) plus a
    ``max_retries`` budget used by :meth:`execute` and the async
    adapter. ``seed=`` (or an explicit ``rng=random.Random(...)``)
    makes the jitter sequence fully deterministic; ``sleep=`` injects
    the clock.

    A policy object is a *specification*; each protected call obtains a
    fresh delay schedule via :meth:`spawn`, so one policy instance can
    safely serve many concurrent connectors.
    """

    def __init__(
        self,
        first_delay_ms: int = 1000,
        backoff_factor: float = 1.5,
        jitter_ms: int = 300,
        max_retries: int = 3,
        *,
        rng: random.Random | None = None,
        seed: int | None = None,
        sleep: Callable[[float], None] = _time.sleep,
    ) -> None:
        self.first_delay_ms = first_delay_ms
        self.backoff_factor = backoff_factor
        self.jitter_ms = jitter_ms
        self.max_retries = max_retries
        if rng is None and seed is None:
            # chaos runs must be deterministic end-to-end: when a
            # PATHWAY_CHAOS plan is active, default jitter draws from a
            # seed derived from the plan + process id instead of global
            # entropy, so a replayed chaos run retries identically
            from . import chaos as _chaos

            seed = _chaos.deterministic_seed()
        self._seed = seed
        if rng is None:
            rng = random.Random(seed) if seed is not None else random  # type: ignore[assignment]
        self._rng = rng
        self._sleep = sleep
        self._delay_s = first_delay_ms / 1000.0
        self._factor = backoff_factor
        self._jitter_s = jitter_ms / 1000.0

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls()

    @classmethod
    def none(cls) -> "RetryPolicy":
        """A policy that never retries (single attempt, no delay)."""
        return cls(first_delay_ms=0, backoff_factor=1.0, jitter_ms=0, max_retries=0)

    def spawn(self) -> "RetryPolicy":
        """Fresh delay schedule with the same parameters.

        A seeded policy spawns an identically-seeded child, so two
        spawns produce the same jitter sequence — the property the
        determinism tests assert. An explicitly injected ``rng`` is
        shared (callers own its state)."""
        return RetryPolicy(
            self.first_delay_ms,
            self.backoff_factor,
            self.jitter_ms,
            self.max_retries,
            rng=None if self._seed is not None else self._rng,
            seed=self._seed,
            sleep=self._sleep,
        )

    def wait_duration_before_retry(self) -> float:
        """Current delay in seconds; advances the schedule."""
        delay = self._delay_s
        self._delay_s = self._delay_s * self._factor + self._rng.uniform(
            0.0, self._jitter_s
        )
        return delay

    def sleep_before_retry(self) -> None:
        self._sleep(self.wait_duration_before_retry())

    def execute(
        self,
        fn: Callable[..., Any],
        *args: Any,
        scope: str = "default",
        retryable: Callable[[BaseException], bool] | None = None,
        metrics: RetryMetrics | None = None,
        deadline: Any = None,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn`` under this policy; at most ``max_retries + 1``
        attempts. ``retryable(exc) -> bool`` filters which exceptions
        qualify (default: any ``Exception``). Attempt history lands in
        ``metrics`` (default :data:`RETRY_METRICS`) under ``scope``.

        ``deadline=`` (a :class:`pathway_tpu_torch.serving.Deadline` or a
        float budget in seconds) makes the policy budget-aware: a
        backoff sleep that would overrun the remaining budget is never
        taken — the last attempt's exception is raised immediately
        instead, so the caller can still shed the request inside its
        deadline rather than time out holding a queue slot."""
        if metrics is None:
            metrics = RETRY_METRICS
        from ..serving.deadline import coerce_deadline

        deadline = coerce_deadline(deadline)
        schedule = self.spawn()
        attempt = 0
        while True:
            attempt += 1
            metrics.record_attempt(scope)
            try:
                result = fn(*args, **kwargs)
            except Exception as exc:
                if (retryable is not None and not retryable(exc)) or (
                    attempt > self.max_retries
                ):
                    metrics.record_failure(scope)
                    raise
                wait = schedule.wait_duration_before_retry()
                if deadline is not None and wait >= deadline.remaining():
                    metrics.record_failure(scope)
                    raise
                metrics.record_retry(scope)
                self._sleep(wait)
            else:
                metrics.record_success(scope)
                return result

    def as_async_strategy(
        self, scope: str = "udf", deadline: Any = None
    ) -> "_AsyncPolicyAdapter":
        """Adapter with the ``AsyncRetryStrategy`` interface
        (``async invoke(fn, *args, **kwargs)``) so a shared policy can
        be handed to ``udfs.async_executor`` / ``AsyncTransformer``.
        ``deadline=`` carries the same budget-gating semantics as
        :meth:`execute`."""
        return _AsyncPolicyAdapter(self, scope, deadline=deadline)


class _AsyncPolicyAdapter:
    """Duck-typed ``udfs.AsyncRetryStrategy`` backed by a RetryPolicy."""

    def __init__(self, policy: RetryPolicy, scope: str, deadline: Any = None) -> None:
        from ..serving.deadline import coerce_deadline

        self._policy = policy
        self._scope = scope
        self._deadline = coerce_deadline(deadline)

    async def invoke(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        import asyncio

        schedule = self._policy.spawn()
        attempt = 0
        while True:
            attempt += 1
            RETRY_METRICS.record_attempt(self._scope)
            try:
                result = await fn(*args, **kwargs)
            except Exception:
                if attempt > self._policy.max_retries:
                    RETRY_METRICS.record_failure(self._scope)
                    raise
                wait = schedule.wait_duration_before_retry()
                if (
                    self._deadline is not None
                    and wait >= self._deadline.remaining()
                ):
                    RETRY_METRICS.record_failure(self._scope)
                    raise
                RETRY_METRICS.record_retry(self._scope)
                await asyncio.sleep(wait)
            else:
                RETRY_METRICS.record_success(self._scope)
                return result
