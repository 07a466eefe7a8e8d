"""Event-time freshness plane: per-shard visible watermarks and
answer-level staleness bounds. See :mod:`pathway_tpu_torch.freshness.plane`."""

from .plane import (
    FRESHNESS,
    LAG_BUCKETS_S,
    PLANES,
    FreshnessConfig,
    FreshnessPlane,
    freshness_enabled,
    parse_freshness_spec,
)
from .report import render_freshness

__all__ = [
    "FRESHNESS",
    "LAG_BUCKETS_S",
    "PLANES",
    "FreshnessConfig",
    "FreshnessPlane",
    "freshness_enabled",
    "parse_freshness_spec",
    "render_freshness",
]
