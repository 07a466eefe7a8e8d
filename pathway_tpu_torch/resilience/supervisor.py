"""Run supervisor: bounded crash-restart around the graph runner.

``pw.run(recovery=...)`` wraps each run attempt in a
:class:`Supervisor`. When a worker process dies, a connector raises, or
an engine epoch fails, the supervisor rebuilds the runner and restarts
it; the persistence layer (``engine/persistence.py``) replays the
input snapshot so the restarted run resumes from the last durable
frontier with exactly-once sink output. Restarts draw from a bounded
budget with backoff; an exhausted budget escalates to a clean
:class:`RecoveryEscalated` failure chaining the last crash.

Restart counts are recorded in :data:`SUPERVISOR_METRICS` and rendered
on ``/metrics`` as ``pathway_supervisor_restarts_total``.

Division of labor with the cluster fault domain: a *partial* restart
(one dead worker process, :class:`~.cluster.ClusterRegroup`) is handled
by the regroup loops in ``internals/run.py`` and never charges this
supervisor's budget — the survivors keep running and
``pathway_supervisor_restarts_total`` stays 0. The supervisor owns
*full* restarts: whole-run failures, including a partial-restart budget
that ran out (escalated as ``EngineError``).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable

from .retry import RetryPolicy

logger = logging.getLogger(__name__)


class RecoveryEscalated(RuntimeError):
    """Restart budget exhausted; the run failed for good.

    ``__cause__`` is the final underlying failure.
    ``flight_recorder_dump`` (when set) is the path of the black-box
    dump written at escalation time (``pathway blackbox show <path>``).
    """

    flight_recorder_dump: str | None = None


class SupervisorMetrics:
    """Thread-safe restart/escalation counters keyed by failure type."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._restarts: dict[str, int] = {}
        self._escalations = 0

    def record_restart(self, cause: str) -> None:
        with self._lock:
            self._restarts[cause] = self._restarts.get(cause, 0) + 1

    def record_escalation(self) -> None:
        with self._lock:
            self._escalations += 1

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "restarts": dict(self._restarts),
                "restarts_total": sum(self._restarts.values()),
                "escalations": self._escalations,
            }

    def reset(self) -> None:
        with self._lock:
            self._restarts.clear()
            self._escalations = 0


#: Process-wide registry surfaced on ``/metrics`` and ``/status``.
SUPERVISOR_METRICS = SupervisorMetrics()


def _default_restart_on() -> tuple[type[BaseException], ...]:
    # Lazy: resilience must stay importable without pulling the engine
    # in at module-import time (and vice versa).
    from ..engine.dataflow import EngineError
    from .chaos import ChaosInjected

    # OSError covers ConnectionError (worker socket death) and
    # TimeoutError (cluster formation); EngineError covers worker
    # tracebacks, connector failures and epoch errors re-raised by the
    # coordinator.
    return (EngineError, OSError, ChaosInjected)


class Recovery:
    """Restart budget + backoff configuration for ``pw.run(recovery=...)``.

    ``recovery=True`` coerces to the defaults below, ``recovery=N`` to a
    budget of N restarts. ``restart_on`` narrows/widens which exception
    types trigger a restart (default: ``EngineError``, ``OSError`` —
    which includes connection and timeout errors — and
    ``ChaosInjected``); anything else propagates immediately.
    """

    def __init__(
        self,
        *,
        max_restarts: int = 3,
        backoff: RetryPolicy | None = None,
        restart_on: tuple[type[BaseException], ...] | None = None,
    ) -> None:
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.max_restarts = max_restarts
        self.backoff = backoff if backoff is not None else RetryPolicy(
            first_delay_ms=100, backoff_factor=2.0, jitter_ms=0, max_retries=max_restarts
        )
        self.restart_on = restart_on

    @classmethod
    def coerce(cls, value: Any) -> "Recovery | None":
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, int):
            return cls(max_restarts=value)
        raise TypeError(
            f"recovery={value!r}: expected None, bool, int (restart budget), "
            "or a pathway_tpu_torch.resilience.Recovery"
        )


class Supervisor:
    """Runs ``attempt(is_restart)`` until success or budget exhaustion."""

    def __init__(self, recovery: Recovery, *, label: str = "pw.run") -> None:
        self.recovery = recovery
        self.label = label

    def run(self, attempt: Callable[[bool], Any]) -> Any:
        from .cluster import ClusterRegroup

        restart_on = self.recovery.restart_on
        if restart_on is None:
            restart_on = _default_restart_on()
        schedule = self.recovery.backoff.spawn()
        restarts = 0
        while True:
            try:
                return attempt(restarts > 0)
            except ClusterRegroup:
                # deliberately NOT restartable here: partial restarts
                # belong to the regroup loops in internals/run.py; a
                # regroup reaching the supervisor is a wiring bug, and
                # silently charging the full-restart budget for it
                # would mask that
                logger.error(
                    "%s: ClusterRegroup leaked to the supervisor (partial "
                    "restarts are handled by pw.run's regroup loop); "
                    "failing the run instead of restarting",
                    self.label,
                )
                raise
            except restart_on as exc:
                from ..internals import flight_recorder

                cause = type(exc).__name__
                if restarts >= self.recovery.max_restarts:
                    SUPERVISOR_METRICS.record_escalation()
                    escalated = RecoveryEscalated(
                        f"{self.label}: restart budget exhausted after "
                        f"{self.recovery.max_restarts} restart(s); "
                        f"last failure: {cause}: {exc}"
                    )
                    flight_recorder.record(
                        "supervisor.escalated", cause=cause, restarts=restarts
                    )
                    dump_path = flight_recorder.dump("recovery_escalated", exc)
                    escalated.flight_recorder_dump = dump_path
                    if dump_path:
                        logger.error(
                            "%s: flight recorder dump written to %s",
                            self.label,
                            dump_path,
                        )
                    raise escalated from exc
                restarts += 1
                SUPERVISOR_METRICS.record_restart(cause)
                flight_recorder.record(
                    "supervisor.restart",
                    cause=cause,
                    restart=restarts,
                    budget=self.recovery.max_restarts,
                )
                delay = schedule.wait_duration_before_retry()
                logger.warning(
                    "%s: attempt failed (%s: %s); restarting from last "
                    "persisted snapshot in %.2fs (restart %d/%d)",
                    self.label,
                    cause,
                    exc,
                    delay,
                    restarts,
                    self.recovery.max_restarts,
                )
                schedule._sleep(delay)
