"""License/entitlement gating.

The port's copy of the reference's ``internals/licensing.py`` (upstream
Pathway's license.rs and its free-tier scale gate, MAX_WORKERS=8). Keys are
accepted in the reference's shapes: empty/None → default free tier;
a key body beginning with a known tier name selects it."""

from __future__ import annotations

from dataclasses import dataclass

MAX_WORKERS_FREE = 8


class LicenseError(Exception):
    pass


@dataclass(frozen=True)
class License:
    tier: str  # "default" | "enterprise"

    @classmethod
    def new(cls, key: str | None) -> "License":
        if not key or not key.strip():
            return cls("default")
        body = key.strip().lower()
        if body.startswith("enterprise"):
            return cls("enterprise")
        return cls("default")

    @property
    def telemetry_required(self) -> bool:
        return self.tier == "default"

    def check_entitlement(self, feature: str) -> None:
        """Raise when a gated feature is unavailable in this tier
        (upstream license.rs)."""
        gated = {"xpack-spatial", "enterprise-connectors", "xpack-sharepoint"}
        if feature in gated and self.tier != "enterprise":
            raise LicenseError(
                f"feature {feature!r} requires an enterprise license"
            )

    def max_workers(self) -> int | None:
        return None if self.tier == "enterprise" else MAX_WORKERS_FREE


def check_worker_count(license: License, n_workers: int) -> None:
    limit = license.max_workers()
    if limit is not None and n_workers > limit:
        raise LicenseError(
            f"{n_workers} workers requested but the free tier allows at most "
            f"{limit} (upstream config.rs MAX_WORKERS); set a license key"
        )
