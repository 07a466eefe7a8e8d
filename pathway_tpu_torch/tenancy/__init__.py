"""Multi-tenant serving plane: tenant-packed device slabs, fair-share
admission quotas, and per-tenant observability.

The port's copy of the reference's ``tenancy/``. Three legs, one plane:

- :mod:`.packed` — :class:`TenantPackedIndex`: many small indexes
  sharing one ``[capacity, dim]`` device slab with an int32
  tenant-routing column; per-tenant segment growth, query-time tenant
  masking passed to the index's top-k dispatch, wholesale cold-tenant
  demotion to a host store.
- :mod:`.config` — :class:`TenantQuotas` / :class:`TenancyConfig` and
  the ``pw.run(tenancy=)`` / ``PATHWAY_TENANCY`` spec plumbing; the
  admission controller and batcher read :func:`active_tenancy` to
  enforce per-tenant QPS buckets, inflight caps, HBM budgets, and
  weighted deficit-round-robin chip-time shares.
- :mod:`.metrics` — the activity-gated per-tenant registry behind the
  ``tenant``-labeled /metrics series, the ``/status`` tenants block,
  and the doctor's per-tenant rows, with the ``PATHWAY_METRIC_TENANTS``
  cardinality fold.
"""

from .config import (
    TENANT_HEADER,
    TenancyConfig,
    TenantQuotas,
    active_tenancy,
    parse_quota_spec,
    parse_tenancy_spec,
    set_active_tenancy,
    use_tenancy,
)
from .metrics import TENANCY_METRICS, TenancyMetrics, metric_tenants
from .packed import (
    TenantOverBudget,
    TenantPackedIndex,
    TenantView,
    reset_slabs,
    shared_slab,
)

__all__ = [
    "TENANT_HEADER",
    "TENANCY_METRICS",
    "TenancyConfig",
    "TenancyMetrics",
    "TenantOverBudget",
    "TenantPackedIndex",
    "TenantQuotas",
    "TenantView",
    "active_tenancy",
    "metric_tenants",
    "parse_quota_spec",
    "parse_tenancy_spec",
    "reset_slabs",
    "set_active_tenancy",
    "shared_slab",
    "use_tenancy",
]
