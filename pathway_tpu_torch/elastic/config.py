"""Elastic-mesh configuration: reshard watermarks and the run-scoped
active config.

The port's copy of the reference's ``elastic/config.py``. It mirrors the
tenancy and tier spec blocks: :func:`parse_elastic_spec` touches no
device (a run records the parsed knobs in ``G.run_context["elastic"]``),
and the active config follows the same precedence everywhere the plane is
consulted: the run-scoped config installed by ``pw.run(elastic=...)``
first, then the ``PATHWAY_ELASTIC`` variable.

An :class:`ElasticConfig` bundles the reshard controller's envelope:

- ``shards``: a fixed target shard count (``pw.run(elastic=4)``); the
  controller reshards toward it once and then holds.
- ``auto``: ``mesh="auto"``: the controller picks shard counts from the
  watermarks alone (grow by doubling up to ``max_shards``, shrink by
  halving down to ``min_shards``).
- ``oom_warn_s``: grow when the HBM time-to-OOM forecast falls below this
  many seconds.
- ``hbm_frac``: grow when the HBM ledger's booked footprint exceeds this
  fraction of the per-device budget (``PATHWAY_HBM_BYTES``, else the
  card's memory).
- ``stranded_frac``: shrink when the chip ledger attributes more than
  this fraction of wall time to stranded (idle) chip time.
- ``chunk_rows``: migration moves index slabs in bounded chunks of at
  most this many rows, so the old generation keeps serving between
  chunks with bounded added latency.
- ``cooldown_s``: minimum seconds between controller-initiated reshards
  (manual ``pw.elastic.reshard()`` calls are never throttled).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

__all__ = [
    "ElasticConfig",
    "active_elastic",
    "parse_elastic_spec",
    "set_active_elastic",
    "use_elastic",
]


@dataclass(frozen=True)
class ElasticConfig:
    """The elastic plane's knobs for one run (see module docstring)."""

    shards: int | None = None
    auto: bool = False
    min_shards: int = 1
    max_shards: int = 8
    chunk_rows: int = 1024
    oom_warn_s: float | None = None
    hbm_frac: float | None = None
    stranded_frac: float | None = None
    cooldown_s: float = 30.0
    interval_s: float = 0.5

    def __post_init__(self):
        if self.shards is not None and self.shards < 1:
            raise ValueError("elastic: shards must be >= 1 (or None)")
        if self.min_shards < 1:
            raise ValueError("elastic: min_shards must be >= 1")
        if self.max_shards < self.min_shards:
            raise ValueError("elastic: max_shards must be >= min_shards")
        if self.chunk_rows < 1:
            raise ValueError("elastic: chunk_rows must be >= 1")
        if self.oom_warn_s is not None and self.oom_warn_s <= 0:
            raise ValueError("elastic: oom_warn_s must be positive (or None)")
        if self.hbm_frac is not None and not (0.0 < self.hbm_frac <= 1.0):
            raise ValueError("elastic: hbm_frac must be in (0, 1] (or None)")
        if self.stranded_frac is not None and not (
            0.0 < self.stranded_frac <= 1.0
        ):
            raise ValueError("elastic: stranded_frac must be in (0, 1] (or None)")
        if self.cooldown_s < 0:
            raise ValueError("elastic: cooldown_s must be >= 0")
        if self.interval_s <= 0:
            raise ValueError("elastic: interval_s must be positive")

    def watermarks_armed(self) -> bool:
        """Whether the background controller has anything to watch (a
        fixed ``shards=`` target needs no watermark loop)."""
        return bool(
            self.auto
            or self.oom_warn_s is not None
            or self.hbm_frac is not None
            or self.stranded_frac is not None
        )

    def as_dict(self) -> dict:
        return {
            "shards": self.shards,
            "auto": self.auto,
            "min_shards": self.min_shards,
            "max_shards": self.max_shards,
            "chunk_rows": self.chunk_rows,
            "oom_warn_s": self.oom_warn_s,
            "hbm_frac": self.hbm_frac,
            "stranded_frac": self.stranded_frac,
            "cooldown_s": self.cooldown_s,
            "interval_s": self.interval_s,
        }


_KEYS = {
    "shards": ("shards", int),
    "target": ("shards", int),
    "min": ("min_shards", int),
    "min_shards": ("min_shards", int),
    "max": ("max_shards", int),
    "max_shards": ("max_shards", int),
    "chunk": ("chunk_rows", int),
    "chunk_rows": ("chunk_rows", int),
    "oom_warn_s": ("oom_warn_s", float),
    "hbm_frac": ("hbm_frac", float),
    "stranded_frac": ("stranded_frac", float),
    "cooldown_s": ("cooldown_s", float),
    "cooldown": ("cooldown_s", float),
    "interval_s": ("interval_s", float),
    "interval": ("interval_s", float),
    "auto": ("auto", None),
}

_TRUE = ("1", "true", "yes", "on")


def _coerce(kw: dict[str, Any]) -> ElasticConfig:
    out: dict[str, Any] = {}
    for k, v in kw.items():
        field, conv = _KEYS[k]
        if field == "auto":
            out[field] = (
                bool(v)
                if isinstance(v, bool)
                else str(v).strip().lower() in _TRUE
            )
        else:
            try:
                out[field] = conv(v)
            except (TypeError, ValueError):
                raise ValueError(f"elastic: bad value {v!r} for {k}") from None
    return ElasticConfig(**out)


def parse_elastic_spec(spec: Any) -> ElasticConfig | None:
    """Spec parsing (mirrors parse_tenancy_spec): accepts None,
    an ElasticConfig, a bool, an int (fixed target shard count), a dict
    of knobs, or a string — ``"auto"``,
    ``"min=2,max=8,chunk=512,hbm_frac=0.85"``, ``"4"`` (target), or
    ``"off"``/``""`` -> None. Raises ValueError on malformed input."""
    if spec is None:
        return None
    if isinstance(spec, ElasticConfig):
        return spec
    if isinstance(spec, bool):
        return ElasticConfig() if spec else None
    if isinstance(spec, int):
        return ElasticConfig(shards=spec)
    if isinstance(spec, dict):
        kw: dict[str, Any] = {}
        for k, v in spec.items():
            if str(k) not in _KEYS:
                raise ValueError(f"elastic: unknown knob {k!r}")
            kw[str(k)] = v
        return _coerce(kw)
    if isinstance(spec, str):
        s = spec.strip()
        if not s or s.lower() in ("off", "none", "0", "false"):
            return None
        if s.lower() in ("on", "true"):
            return ElasticConfig()
        if s.lower() == "auto":
            return ElasticConfig(auto=True)
        if "=" not in s:
            try:
                return ElasticConfig(shards=int(s))
            except ValueError:
                raise ValueError(f"elastic: cannot parse spec {spec!r}") from None
        kw = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                if part.lower() == "auto":
                    kw["auto"] = True
                    continue
                raise ValueError(f"elastic: bad spec part {part!r}")
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in _KEYS:
                raise ValueError(f"elastic: unknown knob {k!r}")
            kw[k] = v.strip()
        return _coerce(kw)
    raise ValueError(f"elastic: cannot parse spec of type {type(spec).__name__}")


# ---------------------------------------------------------------------------
# run-scoped active config (mirrors tenancy.active_tenancy)

_lock = threading.Lock()
_active: ElasticConfig | None = None
_env_cache: tuple[str, ElasticConfig | None] | None = None


def active_elastic() -> ElasticConfig | None:
    """The elastic config the reshard controller should honour: the
    run-scoped config first, then PATHWAY_ELASTIC."""
    global _env_cache
    with _lock:
        if _active is not None:
            return _active
    raw = os.environ.get("PATHWAY_ELASTIC", "")
    if not raw:
        return None
    with _lock:
        if _env_cache is not None and _env_cache[0] == raw:
            return _env_cache[1]
    try:
        cfg = parse_elastic_spec(raw)
    except ValueError:
        cfg = None
    with _lock:
        _env_cache = (raw, cfg)
    return cfg


def set_active_elastic(cfg: ElasticConfig | None) -> None:
    global _active
    with _lock:
        _active = cfg


@contextmanager
def use_elastic(spec: Any):
    prev = _active
    set_active_elastic(parse_elastic_spec(spec))
    try:
        yield
    finally:
        set_active_elastic(prev)
