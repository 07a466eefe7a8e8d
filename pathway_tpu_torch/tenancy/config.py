"""Tenancy-plane configuration: per-tenant quotas + the run-scoped
active config.

The port's copy of the reference's ``tenancy/config.py``. Mirrors
ops/tiered_knn.py's spec block: ``pw.run`` writes the parsed knobs into
``G.run_context["tenancy"]``, and the active config follows the same
precedence everywhere the plane is consulted — the run-scoped config
installed by ``pw.run(tenancy=...)`` first, then the ``PATHWAY_TENANCY``
env var.

A :class:`TenantQuotas` bundles one tenant's fair-share envelope:

- ``qps``/``burst``: a per-tenant token bucket at admission (None = no
  rate cap for that tenant);
- ``max_inflight``: cap on concurrently admitted requests;
- ``hbm_bytes``: byte budget for the tenant's packed index segments,
  booked against the ``index.tenant`` ledger account;
- ``weight``: the tenant's share in the batcher's weighted
  deficit-round-robin arbitration (chip time proportional to weight);
- ``min_top_k``: floor on degraded service — ``shed="degrade"`` never
  clamps this tenant's top-k below it.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

from ..internals.ledger import parse_bytes

#: HTTP request header naming the tenant (mirrors the deadline header's
#: X-Pathway- prefix). Absent header = the untenanted legacy path.
TENANT_HEADER = "X-Pathway-Tenant"


@dataclass(frozen=True)
class TenantQuotas:
    """One tenant's fair-share envelope (see module docstring)."""

    qps: float | None = None
    burst: int = 8
    max_inflight: int | None = None
    hbm_bytes: int | None = None
    weight: float = 1.0
    min_top_k: int | None = None

    def __post_init__(self):
        if self.qps is not None and self.qps <= 0:
            raise ValueError("tenancy: qps must be positive (or None)")
        if self.burst < 1:
            raise ValueError("tenancy: burst must be >= 1")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("tenancy: max_inflight must be >= 1 (or None)")
        if self.hbm_bytes is not None and self.hbm_bytes <= 0:
            raise ValueError("tenancy: hbm_bytes must be positive (or None)")
        if self.weight <= 0:
            raise ValueError("tenancy: weight must be positive")
        if self.min_top_k is not None and self.min_top_k < 1:
            raise ValueError("tenancy: min_top_k must be >= 1 (or None)")

    def as_dict(self) -> dict:
        return {
            "qps": self.qps,
            "burst": self.burst,
            "max_inflight": self.max_inflight,
            "hbm_bytes": self.hbm_bytes,
            "weight": self.weight,
            "min_top_k": self.min_top_k,
        }


@dataclass(frozen=True)
class TenancyConfig:
    """The tenancy plane's knobs for one run.

    ``quotas`` maps tenant id -> :class:`TenantQuotas`; ``default``
    applies to tenants without an explicit entry (None = those tenants
    are unquota'd — rule PWL016 warns about that). ``demote_every``
    is the hit-decay sweep period of the packed slabs (one sweep per
    that many searches; 0 disables cold-tenant demotion);
    ``decay``/``demote_below`` shape the sweep: per-tenant hit counters
    multiply by ``decay`` each sweep and a tenant whose decayed counter
    falls below ``demote_below`` demotes wholesale to the host tier.
    """

    quotas: dict[str, TenantQuotas] = field(default_factory=dict)
    default: TenantQuotas | None = None
    demote_every: int = 0
    decay: float = 0.5
    demote_below: float = 0.5

    def __post_init__(self):
        if self.demote_every < 0:
            raise ValueError("tenancy: demote_every must be >= 0")
        if not (0.0 < self.decay <= 1.0):
            raise ValueError("tenancy: decay must be in (0, 1]")
        if self.demote_below < 0:
            raise ValueError("tenancy: demote_below must be >= 0")

    def quota_for(self, tenant: str) -> TenantQuotas | None:
        return self.quotas.get(tenant, self.default)

    def as_dict(self) -> dict:
        return {
            "quotas": {t: q.as_dict() for t, q in sorted(self.quotas.items())},
            "default": self.default.as_dict() if self.default is not None else None,
            "demote_every": self.demote_every,
            "decay": self.decay,
            "demote_below": self.demote_below,
        }


_QUOTA_KEYS = {
    "qps": "qps",
    "rate": "qps",
    "burst": "burst",
    "inflight": "max_inflight",
    "max_inflight": "max_inflight",
    "hbm": "hbm_bytes",
    "hbm_bytes": "hbm_bytes",
    "weight": "weight",
    "min_top_k": "min_top_k",
    "floor_k": "min_top_k",
}

_CFG_KEYS = {
    "demote_every": "demote_every",
    "demote": "demote_every",
    "decay": "decay",
    "demote_below": "demote_below",
}


def _coerce_quota(kw: dict[str, Any]) -> TenantQuotas:
    out: dict[str, Any] = {}
    for f, v in kw.items():
        if v is None:
            out[f] = None
        elif f == "hbm_bytes":
            out[f] = parse_bytes(v)
        elif f in ("qps", "weight"):
            out[f] = float(v)
        else:
            try:
                out[f] = int(v)
            except (TypeError, ValueError):
                raise ValueError(f"tenancy: bad value {v!r} for {f}") from None
    return TenantQuotas(**out)


def parse_quota_spec(spec: Any) -> TenantQuotas | None:
    """One tenant's quota spec: a TenantQuotas, a dict of knob names,
    or a string like ``"qps=50,burst=8,inflight=4,hbm=64M,weight=2"``."""
    if spec is None:
        return None
    if isinstance(spec, TenantQuotas):
        return spec
    if isinstance(spec, dict):
        kw: dict[str, Any] = {}
        for k, v in spec.items():
            f = _QUOTA_KEYS.get(str(k))
            if f is None:
                raise ValueError(f"tenancy: unknown quota knob {k!r}")
            kw[f] = v
        return _coerce_quota(kw)
    if isinstance(spec, str):
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"tenancy: bad quota spec part {part!r}")
            k, _, v = part.partition("=")
            f = _QUOTA_KEYS.get(k.strip())
            if f is None:
                raise ValueError(f"tenancy: unknown quota knob {k.strip()!r}")
            kw[f] = v.strip()
        return _coerce_quota(kw)
    raise ValueError(
        f"tenancy: cannot parse quota spec of type {type(spec).__name__}"
    )


def parse_tenancy_spec(spec: Any) -> TenancyConfig | None:
    """Spec parsing (mirrors parse_tier_spec): accepts None, a
    TenancyConfig, a bool, a dict (``{"quotas": {tenant: {...}},
    "default": {...}, "demote_every": 256}`` — flat quota knobs are the
    default quota), or a string like
    ``"qps=50,burst=8,inflight=4,demote_every=256"`` (quota knobs in a
    string spec set the *default* quota). Raises ValueError on
    malformed input; ``"off"``/``""`` -> None."""
    if spec is None:
        return None
    if isinstance(spec, TenancyConfig):
        return spec
    if isinstance(spec, bool):
        return TenancyConfig() if spec else None
    if isinstance(spec, dict):
        quotas = {
            str(t): parse_quota_spec(q)
            for t, q in (spec.get("quotas") or {}).items()
        }
        default = parse_quota_spec(spec.get("default"))
        cfg_kw: dict[str, Any] = {}
        flat: dict[str, Any] = {}
        for k, v in spec.items():
            if k in ("quotas", "default"):
                continue
            f = _CFG_KEYS.get(str(k))
            if f is not None:
                cfg_kw[f] = int(v) if f == "demote_every" else float(v)
                continue
            f = _QUOTA_KEYS.get(str(k))
            if f is None:
                raise ValueError(f"tenancy: unknown knob {k!r}")
            flat[f] = v
        if flat:
            if default is not None:
                raise ValueError(
                    "tenancy: give default quota knobs either flat or under "
                    "'default', not both"
                )
            default = _coerce_quota(flat)
        return TenancyConfig(quotas=quotas, default=default, **cfg_kw)
    if isinstance(spec, str):
        s = spec.strip()
        if not s or s.lower() in ("off", "none", "0", "false"):
            return None
        if s.lower() in ("on", "true", "auto"):
            return TenancyConfig()
        cfg_kw = {}
        flat = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"tenancy: bad spec part {part!r}")
            k, _, v = part.partition("=")
            k = k.strip()
            f = _CFG_KEYS.get(k)
            if f is not None:
                cfg_kw[f] = int(v) if f == "demote_every" else float(v)
                continue
            f = _QUOTA_KEYS.get(k)
            if f is None:
                raise ValueError(f"tenancy: unknown knob {k!r}")
            flat[f] = v.strip()
        default = _coerce_quota(flat) if flat else None
        return TenancyConfig(default=default, **cfg_kw)
    raise ValueError(f"tenancy: cannot parse spec of type {type(spec).__name__}")


# ---------------------------------------------------------------------------
# run-scoped active config (mirrors tiered_knn.active_tiers)

_tenancy_lock = threading.Lock()
_active_tenancy: TenancyConfig | None = None
_env_tenancy_cache: tuple[str, TenancyConfig | None] | None = None


def active_tenancy() -> TenancyConfig | None:
    """The tenancy config the serving plane and packed slabs should
    honor: the run-scoped config first, then PATHWAY_TENANCY."""
    global _env_tenancy_cache
    with _tenancy_lock:
        if _active_tenancy is not None:
            return _active_tenancy
    raw = os.environ.get("PATHWAY_TENANCY", "")
    if not raw:
        return None
    with _tenancy_lock:
        if _env_tenancy_cache is not None and _env_tenancy_cache[0] == raw:
            return _env_tenancy_cache[1]
    try:
        cfg = parse_tenancy_spec(raw)
    except ValueError:
        cfg = None
    with _tenancy_lock:
        _env_tenancy_cache = (raw, cfg)
    return cfg


def set_active_tenancy(cfg: TenancyConfig | None) -> None:
    global _active_tenancy
    with _tenancy_lock:
        _active_tenancy = cfg


@contextmanager
def use_tenancy(spec: Any):
    prev = _active_tenancy
    set_active_tenancy(parse_tenancy_spec(spec))
    try:
        yield
    finally:
        set_active_tenancy(prev)
