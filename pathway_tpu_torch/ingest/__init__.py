"""Collaborative host-ingest stage: host workers prepare, the card computes.

Public surface: :class:`HostIngestStage` (bounded worker pool with an
ordered single committer), the process-wide ``configure_stage`` /
``get_stage`` / ``shutdown_stage`` wiring driven by ``pw.run`` and the
``PATHWAY_INGEST_*`` env knobs, and the ``INGEST_METRICS`` registry
backing the ``pathway_ingest_*`` Prometheus family.
"""

from .metrics import INGEST_METRICS, IngestMetrics
from .stage import (
    HostIngestStage,
    Ticket,
    configure_stage,
    get_stage,
    route_by_length,
    shutdown_stage,
)

__all__ = [
    "HostIngestStage",
    "Ticket",
    "IngestMetrics",
    "INGEST_METRICS",
    "configure_stage",
    "get_stage",
    "route_by_length",
    "shutdown_stage",
]
