"""Per-tenant serving/index/HBM counters behind one activity gate.

The port's copy of the reference's ``tenancy/metrics.py``.

Follows the plane-registry discipline (ServingMetrics, IndexMetrics,
LEDGER, …): a process-wide singleton that the admission controller,
batcher, and packed slabs feed, ``active()``-gated so runs that never
name a tenant render nothing new on /metrics, /status, the dashboard,
or ``pathway doctor`` — their scrape output stays byte-identical.

Cardinality guard: the registry keeps *every* tenant internally (dicts
are cheap), but :meth:`snapshot` folds all tenants past the first
``PATHWAY_METRIC_TENANTS`` (default 50, first-seen order — a tenant
once named keeps its series forever, so scrape-to-scrape label sets
are stable) into one ``tenant="other"`` series. A 10k-tenant run
scrapes ~50 series, not 10k.
"""

from __future__ import annotations

import os
import threading

_DEFAULT_METRIC_TENANTS = 50

#: fold label for tenants past the cardinality cap
OTHER = "other"


def metric_tenants() -> int:
    """Max named per-tenant label series (PATHWAY_METRIC_TENANTS)."""
    raw = os.environ.get("PATHWAY_METRIC_TENANTS", "")
    if raw.strip():
        try:
            n = int(raw)
            if n >= 1:
                return n
        except ValueError:
            pass
    return _DEFAULT_METRIC_TENANTS


def _new_row() -> dict:
    return {
        "admitted": 0,
        "degraded": 0,
        "shed": {},  # reason -> count
        "inflight": 0,
        "chip_seconds": 0.0,
        "searches": 0,
        "docs": 0,
        "hbm_bytes": 0,
        "cold": False,
    }


class TenancyMetrics:
    """Thread-safe per-tenant counters; all methods are hot-path cheap
    (one dict op under a lock)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tenants: dict[str, dict] = {}  # insertion order == first seen

    def _row(self, tenant: str) -> dict:
        return self._tenants.setdefault(str(tenant), _new_row())

    # -- admission / batching --

    def record_admit(self, tenant: str, degraded: bool = False) -> None:
        with self._lock:
            row = self._row(tenant)
            row["admitted"] += 1
            if degraded:
                row["degraded"] += 1

    def record_shed(self, tenant: str, reason: str) -> None:
        with self._lock:
            shed = self._row(tenant)["shed"]
            shed[reason] = shed.get(reason, 0) + 1

    def set_inflight(self, tenant: str, n: int) -> None:
        with self._lock:
            self._row(tenant)["inflight"] = max(0, int(n))

    def add_chip_seconds(self, tenant: str, seconds: float) -> None:
        with self._lock:
            self._row(tenant)["chip_seconds"] += max(0.0, float(seconds))

    # -- index --

    def record_search(self, tenant: str, n_queries: int = 1) -> None:
        with self._lock:
            self._row(tenant)["searches"] += int(n_queries)

    def set_index(
        self, tenant: str, docs: int, hbm_bytes: int, cold: bool = False
    ) -> None:
        with self._lock:
            row = self._row(tenant)
            row["docs"] = int(docs)
            row["hbm_bytes"] = int(hbm_bytes)
            row["cold"] = bool(cold)

    def drop_tenant(self, tenant: str) -> None:
        with self._lock:
            self._tenants.pop(str(tenant), None)

    # -- rendering --

    def active(self) -> bool:
        """Any tenant ever named? Gates every tenant-labeled line."""
        with self._lock:
            return bool(self._tenants)

    def snapshot(self) -> dict:
        """Folded per-tenant view: the first ``metric_tenants()``
        tenants by name, the rest summed into ``tenant="other"``."""
        cap = metric_tenants()
        with self._lock:
            names = list(self._tenants)
            named, folded = names[:cap], names[cap:]
            out: dict[str, dict] = {}
            for t in named:
                row = self._tenants[t]
                out[t] = {**row, "shed": dict(row["shed"])}
            if folded:
                agg = _new_row()
                for t in folded:
                    row = self._tenants[t]
                    agg["admitted"] += row["admitted"]
                    agg["degraded"] += row["degraded"]
                    agg["inflight"] += row["inflight"]
                    agg["chip_seconds"] += row["chip_seconds"]
                    agg["searches"] += row["searches"]
                    agg["docs"] += row["docs"]
                    agg["hbm_bytes"] += row["hbm_bytes"]
                    for reason, n in row["shed"].items():
                        agg["shed"][reason] = agg["shed"].get(reason, 0) + n
                out[OTHER] = agg
            return {
                "tenants": out,
                "tenant_count": len(names),
                "folded": len(folded),
            }

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()


#: Process-wide registry surfaced on /metrics, /status, and doctor.
TENANCY_METRICS = TenancyMetrics()
