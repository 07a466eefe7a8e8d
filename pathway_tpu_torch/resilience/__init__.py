"""Fault-tolerant runtime: crash-recovery supervisor, unified retry
policy, the shared cluster-health state, and a deterministic
fault-injection harness (the port's copy of the reference's package;
the multi-process coordinator, ``parallel/multiprocess.py``, drives the
cluster state).

- :class:`RetryPolicy` — one retry knob for connectors, UDF executors,
  LLM xpacks and ``AsyncTransformer``; seedable jitter, injectable
  clock, attempt history in :data:`RETRY_METRICS` (→ ``/metrics``).
- :class:`Recovery` / :class:`Supervisor` — ``pw.run(recovery=...)``
  restarts a crashed run from the last persisted snapshot under a
  bounded budget, escalating to :class:`RecoveryEscalated`.
- :mod:`.chaos` — scripted worker/connector
  kills at exact epochs and byte offsets, used by the crash-window
  tests to prove the exactly-once contract.

Dead-letter routing itself lives in the engine (``on_error=`` on UDFs
and ``AsyncTransformer``); this package provides the policy types.
"""

from __future__ import annotations

from . import chaos
from .chaos import ChaosInjected, ChaosPlan
from .cluster import (
    CLUSTER_HEALTH,
    CLUSTER_METRICS,
    ClusterHealth,
    ClusterMetrics,
    ClusterRegroup,
    WorkerLost,
)
from .retry import DEFAULT_RETRY_CODES, RETRY_METRICS, RetryMetrics, RetryPolicy
from .supervisor import (
    SUPERVISOR_METRICS,
    Recovery,
    RecoveryEscalated,
    Supervisor,
    SupervisorMetrics,
)

__all__ = [
    "CLUSTER_HEALTH",
    "CLUSTER_METRICS",
    "ClusterHealth",
    "ClusterMetrics",
    "ClusterRegroup",
    "DEFAULT_RETRY_CODES",
    "RETRY_METRICS",
    "RetryMetrics",
    "RetryPolicy",
    "SUPERVISOR_METRICS",
    "Recovery",
    "RecoveryEscalated",
    "Supervisor",
    "SupervisorMetrics",
    "WorkerLost",
    "ChaosInjected",
    "ChaosPlan",
    "chaos",
]
