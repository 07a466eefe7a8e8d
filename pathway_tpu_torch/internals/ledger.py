"""Unified device-resource ledger + live health watchdog.

The port's copy of the reference's ``internals/ledger.py``. Two halves,
one file, because they share the footprint model:

**Footprint model** — the bytes-per-row / KV-pool arithmetic
(``decode/config.py``'s parse-time budget check reads it), and
:func:`footprint`, which combines per-plane estimates into one total.

**DeviceLedger** — a process-wide, thread-safe registry where every
subsystem holding device memory reports its live allocations under a
named account (``index.hot``, ``decode.kv``, ``weights``), keyed by owner
so many indexes coexist. Rows carry allocated bytes and optionally *used*
bytes, giving per-account fragmentation (1 − used/allocated) and a
high-water mark. Activity-gated: runs that never report an allocation
render nothing on /metrics, /status or the dashboard. ``PATHWAY_LEDGER=0``
turns accounting into a no-op.

**The budget.** :func:`default_hbm_bytes` is ``PATHWAY_HBM_BYTES`` when
set; else, once ``torch`` is imported and a card is present, card 0's
memory (``torch.cuda.get_device_properties(0).total_memory``, 80 GB on an
H100); else the reference's default (16 GiB), so CPU runs compare like
with like.

**HealthWatchdog** — a sampling thread that evaluates declarative
:class:`WatchRule` thresholds against the live metric streams:

* ``hbm_headroom`` — time-to-OOM forecast from an EWMA of the device
  memory growth rate against the budget. On a card it reads PyTorch's
  caching allocator (``torch.cuda.memory_reserved``); without one, the
  ledger's total;
* ``p99_burn`` — serving p99 (from the stage histograms) as a fraction
  of the deadline budget;
* ``shed_rate`` — shed / offered fraction from the admission counters;
* ``hot_hit_ratio`` — tiered-index hot-tier hit ratio;
* ``stranded_chip_time`` and ``freshness_slo`` from the chip ledger and
  the freshness plane.

Breach transitions are hysteretic (``breach_for`` consecutive bad
samples to escalate, ``clear_for`` good ones to recover), emit
``health.breach`` flight-recorder events, trigger a one-shot
flight-recorder dump on first critical, and fold into a machine-readable
:meth:`HealthWatchdog.verdict` — the green/yellow/red that
``RunResult.health`` carries.

Module top imports stdlib only; the live samplers import their
registries lazily.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

__all__ = [
    "parse_bytes",
    "default_hbm_bytes",
    "hot_row_bytes",
    "cold_row_bytes",
    "index_hbm_bytes",
    "kv_pool_bytes",
    "footprint",
    "DeviceLedger",
    "LEDGER",
    "WatchRule",
    "DEFAULT_RULES",
    "HealthWatchdog",
    "parse_watchdog_spec",
    "render_verdict",
]

# ---------------------------------------------------------------------------
# footprint model (moved here from ops/tiered_knn.py; re-exported there)
# ---------------------------------------------------------------------------

#: the budget without a card: the reference's default, so CPU runs compare
#: like with like
_DEFAULT_HBM_BYTES = 16 * 1024 ** 3


def parse_bytes(raw: str | int) -> int:
    """``"4G"`` / ``"512M"`` / ``"64K"`` / plain int -> bytes."""
    if isinstance(raw, int):
        return raw
    s = str(raw).strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}[s[-1].lower()]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        raise ValueError(f"index tiers: bad byte size {raw!r}") from None


def _card_bytes() -> int | None:
    """Card 0's memory when ``torch`` is imported and a card is present."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def default_hbm_bytes() -> int:
    """Per-device memory budget: ``PATHWAY_HBM_BYTES`` when set, else the
    card's memory, else 16 GiB without a card — the one knob the decode
    pool's budget check and the watchdog's headroom forecast read."""
    raw = os.environ.get("PATHWAY_HBM_BYTES", "")
    if raw:
        try:
            return parse_bytes(raw)
        except ValueError:
            pass
    card = _card_bytes()
    return card if card is not None else _DEFAULT_HBM_BYTES


def device_memory_bytes() -> int | None:
    """Bytes PyTorch's caching allocator holds on card 0 (what the
    time-to-OOM forecast reads on a card); None without one."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_reserved(0))


def hot_row_bytes(dim: int, hot_dtype: str = "f32") -> int:
    """Device bytes per hot row: rows*dim*4 + rows*5 slab math for f32;
    int8 rows carry a 4-byte scale instead."""
    if hot_dtype == "int8":
        return dim + 4 + 5
    return dim * 4 + 5


def cold_row_bytes(dim: int, cold_dtype: str = "int8") -> int:
    """Host bytes per cold row (vector payload + per-vector scale)."""
    if cold_dtype == "int8":
        return dim + 4
    return dim * 4


def index_hbm_bytes(rows: int, dim: int, hot_dtype: str = "f32") -> int:
    """Resident slab estimate for a device index: rows x per-row bytes
    (vector payload + validity byte + key overhead)."""
    return int(rows) * hot_row_bytes(int(dim), hot_dtype)


def kv_pool_bytes(
    pages: int, page_size: int, layers: int, hidden: int, dtype_bytes: int = 4
) -> int:
    """Device footprint of a K+V page pool."""
    return 2 * pages * page_size * layers * hidden * dtype_bytes


#: Nominal decoder geometry for *static* KV estimates — matches
#: ``decode/engine.DecoderConfig`` defaults; live checks use the real
#: model geometry at engine construction.
NOMINAL_DECODER_LAYERS = 4
NOMINAL_DECODER_HIDDEN = 256
NOMINAL_DECODER_VOCAB = 32000
NOMINAL_DECODER_MAX_POSITION = 512


def decoder_weights_bytes(
    layers: int,
    hidden: int,
    vocab: int = NOMINAL_DECODER_VOCAB,
    max_position: int = NOMINAL_DECODER_MAX_POSITION,
    intermediate: int | None = None,
    dtype_bytes: int = 4,
) -> int:
    """Static ``weights``-account estimate for a GPT-2-style decoder
    (tied head, learned positions — the ``decode/engine`` geometry);
    live engines book exact ``pytree_nbytes`` instead."""
    d = int(hidden)
    f = int(intermediate) if intermediate else 4 * d
    embed = vocab * d + max_position * d + 2 * d  # tok + pos + final LN
    per_layer = (
        2 * d  # ln1
        + d * 3 * d + 3 * d  # wqkv + bqkv
        + d * d + d  # wo + bo
        + 2 * d  # ln2
        + d * f + f  # w1 + b1
        + f * d + d  # w2 + b2
    )
    return (embed + layers * per_layer) * dtype_bytes


def footprint(
    *,
    index_bytes: int = 0,
    kv_bytes: int = 0,
    ring_bytes: int = 0,
    weight_bytes: int = 0,
) -> dict[str, int]:
    """Combine per-plane HBM estimates into the shared footprint model.

    The inputs are per-device resident bytes (callers apply their own
    sharding before calling). The returned dict mirrors the ledger's
    account naming so static estimates and live accounting read the same
    way.
    """
    out = {
        "index": int(index_bytes),
        "decode_kv": int(kv_bytes),
        "rings": int(ring_bytes),
        "weights": int(weight_bytes),
    }
    out["total"] = sum(out.values())
    return out


def pytree_nbytes(tree: Any) -> int:
    """Sum the bytes of an arbitrarily nested dict/list/tuple of tensors
    (a state dict) — works on device tensors and host numpy alike."""
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(x) for x in tree)
    if hasattr(tree, "items"):
        return sum(pytree_nbytes(v) for v in tree.values())
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is None and hasattr(tree, "element_size"):
        nbytes = tree.element_size() * tree.numel()
    return int(nbytes or 0)


# ---------------------------------------------------------------------------
# live ledger
# ---------------------------------------------------------------------------


def ledger_enabled() -> bool:
    """``PATHWAY_LEDGER=0`` turns live accounting into a no-op (the
    overhead A/B lever)."""
    return str(os.environ.get("PATHWAY_LEDGER", "")).strip().lower() not in (
        "0",
        "false",
        "off",
        "no",
    )


class DeviceLedger:
    """Thread-safe live HBM accounting: (account, owner) -> bytes.

    ``update`` is the only hot-path call (one dict store under a lock);
    aggregation happens at scrape time. ``used_bytes`` is optional —
    accounts that report it get a fragmentation gauge
    (1 − used/allocated); those that don't read as fully used.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (account, owner) -> [alloc_bytes, used_bytes | None]
        self._rows: dict[tuple[str, str], list] = {}
        self._high: dict[str, int] = {}  # account -> high-water bytes
        self._high_total = 0
        self._touched = False

    def update(
        self, account: str, owner: str, nbytes: int, used_bytes: int | None = None
    ) -> None:
        """Report the live allocation of ``owner`` under ``account``.
        ``nbytes <= 0`` drops the row (freed)."""
        if not ledger_enabled():
            return
        nbytes = int(nbytes)
        with self._lock:
            self._touched = True
            key = (str(account), str(owner))
            if nbytes <= 0:
                self._rows.pop(key, None)
            else:
                self._rows[key] = [
                    nbytes,
                    None if used_bytes is None else int(used_bytes),
                ]
            acct_total = sum(
                row[0] for (a, _), row in self._rows.items() if a == account
            )
            if acct_total > self._high.get(account, 0):
                self._high[account] = acct_total
            total = sum(row[0] for row in self._rows.values())
            if total > self._high_total:
                self._high_total = total

    def drop(self, account: str, owner: str) -> None:
        """Forget one owner's row (freed / torn down)."""
        with self._lock:
            self._rows.pop((str(account), str(owner)), None)

    def drop_owner(self, owner: str) -> None:
        """Forget every row held by ``owner`` across accounts."""
        with self._lock:
            for key in [k for k in self._rows if k[1] == owner]:
                del self._rows[key]

    def active(self) -> bool:
        """Anything ever reported? Gates every ``pathway_hbm_*`` line so
        runs that never touch the ledger scrape byte-identical."""
        with self._lock:
            return self._touched

    def total_bytes(self) -> int:
        with self._lock:
            return sum(row[0] for row in self._rows.values())

    def accounts(self) -> dict[str, dict]:
        """Aggregate per-account view: bytes, used, high-water,
        fragmentation, owner count."""
        with self._lock:
            out: dict[str, dict] = {}
            for (account, _owner), (nbytes, used) in self._rows.items():
                e = out.setdefault(
                    account,
                    {"bytes": 0, "used_bytes": 0, "owners": 0, "_used_known": True},
                )
                e["bytes"] += nbytes
                e["owners"] += 1
                if used is None:
                    e["used_bytes"] += nbytes
                else:
                    e["used_bytes"] += min(used, nbytes)
                    if used < nbytes:
                        e["_used_known"] = True
            for account, e in out.items():
                del e["_used_known"]
                e["high_water_bytes"] = self._high.get(account, e["bytes"])
                e["fragmentation"] = (
                    round(1.0 - e["used_bytes"] / e["bytes"], 4) if e["bytes"] else 0.0
                )
            # accounts that peaked and freed still render their high water
            for account, high in self._high.items():
                if account not in out:
                    out[account] = {
                        "bytes": 0,
                        "used_bytes": 0,
                        "owners": 0,
                        "high_water_bytes": high,
                        "fragmentation": 0.0,
                    }
            return out

    def snapshot(self) -> dict:
        accounts = self.accounts()
        with self._lock:
            return {
                "accounts": accounts,
                "total_bytes": sum(row[0] for row in self._rows.values()),
                "high_water_bytes": self._high_total,
                "budget_bytes": default_hbm_bytes(),
            }

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._high.clear()
            self._high_total = 0
            self._touched = False


#: Process-wide ledger surfaced on ``/metrics`` and ``/status``.
LEDGER = DeviceLedger()


# ---------------------------------------------------------------------------
# health watchdog
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WatchRule:
    """One declarative health threshold over a sampled metric.

    ``metric`` names a key in the (derived) sample dict; a sample where
    the key is absent/None skips the rule that round (its plane stays
    whatever the other rules say). ``higher_is_bad`` flips the
    comparison for metrics where *low* is the hazard (time-to-OOM,
    hit ratio). ``breach_for``/``clear_for`` are the hysteresis
    windows: consecutive bad samples required to escalate, consecutive
    good ones to recover.
    """

    name: str
    plane: str
    metric: str
    warn: float
    critical: float
    higher_is_bad: bool = True
    breach_for: int = 2
    clear_for: int = 2
    unit: str = ""

    def severity(self, value: float) -> str:
        if self.higher_is_bad:
            if value >= self.critical:
                return "critical"
            if value >= self.warn:
                return "warn"
        else:
            if value <= self.critical:
                return "critical"
            if value <= self.warn:
                return "warn"
        return "ok"


#: Default rule set (thresholds overridable via the watchdog spec).
DEFAULT_RULES: tuple[WatchRule, ...] = (
    WatchRule(
        "hbm_headroom", "hbm", "time_to_oom_s", warn=600.0, critical=60.0,
        higher_is_bad=False, unit="s",
    ),
    WatchRule("p99_burn", "serving", "p99_burn", warn=0.8, critical=1.0),
    WatchRule("shed_rate", "serving", "shed_rate", warn=0.05, critical=0.25),
    WatchRule(
        "hot_hit_ratio", "index", "hot_hit_ratio", warn=0.5, critical=0.2,
        higher_is_bad=False,
    ),
    WatchRule(
        "stranded_chip_time", "chip", "stranded_fraction",
        warn=0.5, critical=0.8,
    ),
    # freshness_burn = visibility-lag EWMA / freshness SLO, same shape
    # as p99_burn: 1.0 means answers are exactly as stale as promised
    WatchRule(
        "freshness_slo", "freshness", "freshness_burn", warn=0.8, critical=1.0,
    ),
)

_LEVEL_RANK = {"ok": 0, "warn": 1, "critical": 2}
_LEVEL_COLOR = {"ok": "green", "warn": "yellow", "critical": "red"}


class _RuleState:
    __slots__ = ("level", "candidate", "streak", "value")

    def __init__(self) -> None:
        self.level = "ok"
        self.candidate = "ok"
        self.streak = 0
        self.value: float | None = None


class HealthWatchdog:
    """Evaluates :class:`WatchRule` thresholds against live (or
    injected) metric samples; optionally as a background thread.

    Tests drive :meth:`evaluate_once` with synthetic sample dicts —
    no thread, no registries, no sleeps. Live runs call :meth:`start`
    which samples the process registries every ``interval_s``.
    """

    def __init__(
        self,
        rules: tuple[WatchRule, ...] = DEFAULT_RULES,
        interval_s: float = 1.0,
        sampler: Callable[[], dict] | None = None,
        budget_bytes: int | None = None,
    ) -> None:
        self.rules = tuple(rules)
        self.interval_s = max(0.01, float(interval_s))
        self._sampler = sampler
        self._budget = budget_bytes
        self._states = {r.name: _RuleState() for r in self.rules}
        self._lock = threading.Lock()
        self._ewma_rate = 0.0  # bytes/s EWMA of ledger growth
        self._last_bytes: int | None = None
        self._last_t: float | None = None
        self._fresh_rate = 0.0  # s/s EWMA of visibility-lag growth
        self._fresh_last: float | None = None
        self._fresh_t: float | None = None
        self._samples = 0
        self._breaches = 0
        self._dump_attempted = False
        self.dump_path: str | None = None
        self.dump_error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampling --

    @staticmethod
    def _p99_seconds(hist) -> float | None:
        """p99 upper-bound estimate from a cumulative stage histogram."""
        pairs = hist.cumulative()
        total = pairs[-1][1]
        if not total:
            return None
        target = 0.99 * total
        for le, running in pairs:
            if running >= target:
                if le == "+Inf":
                    return float(pairs[-2][0]) if len(pairs) > 1 else None
                return float(le)
        return None

    def _live_sample(self) -> dict:
        """Read the process registries (each gated on its activity)."""
        sample: dict[str, Any] = {"t": time.monotonic()}
        card = device_memory_bytes()
        if card is not None:
            sample["hbm_bytes"] = card
        else:
            sample["hbm_bytes"] = LEDGER.total_bytes() if LEDGER.active() else None
        try:
            from ..serving.metrics import SERVING_METRICS

            if SERVING_METRICS.active():
                snap = SERVING_METRICS.snapshot()
                offered = snap["admitted_total"] + sum(snap["shed_total"].values())
                sample["shed_rate"] = (
                    sum(snap["shed_total"].values()) / offered if offered else 0.0
                )
                p99 = self._p99_seconds(SERVING_METRICS.stages["total"])
                deadline = _deadline_budget_s()
                if p99 is not None and deadline:
                    sample["p99_s"] = p99
                    sample["deadline_s"] = deadline
        except Exception:
            pass
        try:
            from ..ops.index_metrics import INDEX_METRICS

            if INDEX_METRICS.tiered_active():
                snap = INDEX_METRICS.snapshot()
                ratios = [
                    e["tiers"]["hot_hit_ratio"]
                    for e in snap["indexes"].values()
                    if e.get("tiers") is not None
                ]
                if ratios:
                    sample["hot_hit_ratio"] = sum(ratios) / len(ratios)
        except Exception:
            pass
        try:
            from .chip_ledger import CHIP_LEDGER

            if CHIP_LEDGER.active():
                chip = CHIP_LEDGER.snapshot()
                sample["stranded_fraction"] = chip["stranded_fraction"]
                sample["chip_accounted_fraction"] = chip["accounted_fraction"]
        except Exception:
            pass
        try:
            from ..freshness.plane import FRESHNESS

            if FRESHNESS.active():
                ewma_ms = FRESHNESS.lag_ewma_ms()
                if ewma_ms is not None:
                    sample["freshness_lag_s"] = ewma_ms / 1000.0
                if FRESHNESS.slo_ms:
                    sample["freshness_slo_s"] = FRESHNESS.slo_ms / 1000.0
        except Exception:
            pass
        return sample

    def _derive(self, sample: dict) -> dict:
        """Fold raw sample fields into the metrics the rules consume."""
        out = dict(sample)
        now = sample.get("t")
        if now is None:
            now = time.monotonic()
        hbm = sample.get("hbm_bytes")
        if hbm is not None:
            hbm = int(hbm)
            if self._last_bytes is not None and self._last_t is not None:
                dt = max(1e-6, float(now) - self._last_t)
                rate = (hbm - self._last_bytes) / dt
                # EWMA over ~8 samples: smooth enough to ignore one
                # burst, fresh enough to catch a sustained ramp
                alpha = 0.25
                self._ewma_rate = alpha * rate + (1 - alpha) * self._ewma_rate
            self._last_bytes = hbm
            self._last_t = float(now)
            budget = self._budget if self._budget is not None else default_hbm_bytes()
            headroom = budget - hbm
            if headroom <= 0:
                out["time_to_oom_s"] = 0.0
            elif self._ewma_rate > 1e-9:
                out["time_to_oom_s"] = headroom / self._ewma_rate
            else:
                out["time_to_oom_s"] = None  # flat or shrinking: no forecast
            out["hbm_budget_bytes"] = budget
            out["hbm_growth_bytes_s"] = self._ewma_rate
        if "p99_burn" not in out:
            p99 = sample.get("p99_s")
            deadline = sample.get("deadline_s")
            if p99 is not None and deadline:
                out["p99_burn"] = float(p99) / float(deadline)
        if "freshness_burn" not in out:
            lag = sample.get("freshness_lag_s")
            slo = sample.get("freshness_slo_s")
            if lag is not None and slo:
                lag = float(lag)
                slo = float(slo)
                out["freshness_burn"] = lag / slo
                # lag-trend forecast, same EWMA shape as time-to-OOM:
                # how long until the smoothed lag growth eats the SLO
                if self._fresh_last is not None and self._fresh_t is not None:
                    dt = max(1e-6, float(now) - self._fresh_t)
                    rate = (lag - self._fresh_last) / dt
                    alpha = 0.25
                    self._fresh_rate = (
                        alpha * rate + (1 - alpha) * self._fresh_rate
                    )
                self._fresh_last = lag
                self._fresh_t = float(now)
                headroom = slo - lag
                if headroom <= 0:
                    out["freshness_time_to_breach_s"] = 0.0
                elif self._fresh_rate > 1e-9:
                    out["freshness_time_to_breach_s"] = headroom / self._fresh_rate
                else:
                    out["freshness_time_to_breach_s"] = None  # flat or improving
        return out

    # -- evaluation --

    def evaluate_once(self, sample: dict | None = None) -> dict:
        """One watchdog round: sample (or take the injected sample),
        derive rule metrics, advance hysteresis state, emit breach
        events, and return the current verdict."""
        if sample is None:
            sample = (self._sampler or self._live_sample)()
        derived = self._derive(sample)
        with self._lock:
            self._samples += 1
            for rule in self.rules:
                state = self._states[rule.name]
                value = derived.get(rule.metric)
                if value is None:
                    state.value = None
                    state.candidate = state.level
                    state.streak = 0
                    continue
                value = float(value)
                state.value = value
                sev = rule.severity(value)
                if sev == state.level:
                    state.candidate = state.level
                    state.streak = 0
                    continue
                if sev != state.candidate:
                    state.candidate = sev
                    state.streak = 1
                else:
                    state.streak += 1
                escalating = _LEVEL_RANK[sev] > _LEVEL_RANK[state.level]
                window = rule.breach_for if escalating else rule.clear_for
                if state.streak >= window:
                    state.level = sev
                    state.candidate = sev
                    state.streak = 0
                    if escalating:
                        self._breaches += 1
                        self._emit_breach(rule, state, derived)
                        if sev == "critical":
                            self._critical_dump(rule, state)
        return self.verdict()

    def _emit_breach(self, rule: WatchRule, state: _RuleState, derived: dict) -> None:
        try:
            from . import flight_recorder

            flight_recorder.record(
                "health.breach",
                rule=rule.name,
                plane=rule.plane,
                level=state.level,
                value=state.value,
                warn=rule.warn,
                critical=rule.critical,
            )
        except Exception:
            pass  # observability must never take the engine down

    def _critical_dump(self, rule: WatchRule, state: _RuleState) -> None:
        """One-shot flight-recorder dump on the first critical breach.
        A failing dump (chaos kill mid-write) is recorded and never
        retried — and never propagates into the evaluation loop."""
        if self._dump_attempted:
            return
        self._dump_attempted = True
        try:
            from . import flight_recorder

            self.dump_path = flight_recorder.dump(f"health.critical:{rule.name}")
        except Exception as exc:
            self.dump_error = f"{type(exc).__name__}: {exc}"

    def verdict(self) -> dict:
        """Machine-readable health verdict: overall + per-plane status
        with evidence lines (what ``pathway doctor`` renders and
        ``RunResult.health`` carries)."""
        with self._lock:
            worst = "ok"
            planes: dict[str, dict] = {}
            rules_out = []
            for rule in self.rules:
                state = self._states[rule.name]
                if _LEVEL_RANK[state.level] > _LEVEL_RANK[worst]:
                    worst = state.level
                cmp = "<=" if rule.higher_is_bad else ">="
                if state.value is None:
                    evidence = f"{rule.metric}: no signal"
                else:
                    evidence = (
                        f"{rule.metric}={state.value:g}{rule.unit} "
                        f"(ok {cmp} warn {rule.warn:g} / critical {rule.critical:g})"
                    )
                entry = {
                    "name": rule.name,
                    "plane": rule.plane,
                    "level": state.level,
                    "value": state.value,
                    "warn": rule.warn,
                    "critical": rule.critical,
                    "evidence": evidence,
                }
                rules_out.append(entry)
                plane = planes.setdefault(
                    rule.plane, {"status": "green", "evidence": []}
                )
                if _LEVEL_RANK[state.level] > _LEVEL_RANK.get(
                    {"green": "ok", "yellow": "warn", "red": "critical"}[
                        plane["status"]
                    ],
                    0,
                ):
                    plane["status"] = _LEVEL_COLOR[state.level]
                plane["evidence"].append(f"[{state.level}] {evidence}")
            return {
                "status": _LEVEL_COLOR[worst],
                "planes": planes,
                "rules": rules_out,
                "samples": self._samples,
                "breaches": self._breaches,
                "dump_path": self.dump_path,
                "dump_error": self.dump_error,
                "hbm": LEDGER.snapshot() if LEDGER.active() else None,
                "tenants": self._tenants_snapshot(),
                "chip": self._chip_snapshot(),
                "freshness": self._freshness_snapshot(),
            }

    @staticmethod
    def _chip_snapshot() -> dict | None:
        """Chip-time attribution block for the verdict (``pathway
        doctor``'s per-plane utilization rows); None unless the chip
        ledger saw a booking."""
        try:
            from .chip_ledger import CHIP_LEDGER
        except Exception:
            return None
        if not CHIP_LEDGER.active():
            return None
        return CHIP_LEDGER.snapshot()

    @staticmethod
    def _freshness_snapshot() -> dict | None:
        """Freshness-plane block for the verdict (``pathway doctor``'s
        staleness evidence rows); None unless the plane saw activity."""
        try:
            from ..freshness.plane import FRESHNESS
        except Exception:
            return None
        if not FRESHNESS.active():
            return None
        return FRESHNESS.snapshot()

    @staticmethod
    def _tenants_snapshot() -> dict | None:
        """Per-tenant block for the verdict (the doctor's tenant rows);
        None unless the tenancy plane saw activity."""
        from ..tenancy.metrics import TENANCY_METRICS

        if not TENANCY_METRICS.active():
            return None
        return TENANCY_METRICS.snapshot()

    # -- thread --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pathway-health-watchdog", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                pass  # a broken sampler must not kill the thread

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# watchdog spec (pw.run(watchdog=) / PATHWAY_WATCHDOG)
# ---------------------------------------------------------------------------

_OFF = ("off", "none", "0", "false", "no")
_ON = ("on", "true", "auto", "yes", "1", "")

#: spec keys that override a DEFAULT_RULES threshold: key -> (rule, field)
_THRESHOLD_KEYS = {
    "oom_warn_s": ("hbm_headroom", "warn"),
    "oom_critical_s": ("hbm_headroom", "critical"),
    "p99_warn": ("p99_burn", "warn"),
    "p99_critical": ("p99_burn", "critical"),
    "shed_warn": ("shed_rate", "warn"),
    "shed_critical": ("shed_rate", "critical"),
    "hit_warn": ("hot_hit_ratio", "warn"),
    "hit_critical": ("hot_hit_ratio", "critical"),
    "stranded_warn": ("stranded_chip_time", "warn"),
    "stranded_critical": ("stranded_chip_time", "critical"),
    "freshness_warn": ("freshness_slo", "warn"),
    "freshness_critical": ("freshness_slo", "critical"),
}


def parse_watchdog_spec(spec: Any) -> dict | None:
    """Coerce a ``pw.run(watchdog=)`` / ``PATHWAY_WATCHDOG`` value into
    watchdog kwargs (or ``None`` = off). Accepted forms::

        watchdog=True                      # defaults (1 s interval)
        watchdog="interval=0.1,breach_for=1,oom_critical_s=3600"
        watchdog={"interval": 0.5}
        PATHWAY_WATCHDOG=1 | off | interval=0.2

    Returns ``{"interval_s": float, "rules": tuple[WatchRule, ...]}``.
    Raises ``ValueError`` on malformed specs.
    """
    if spec is None or spec is False:
        return None
    if spec is True:
        return {"interval_s": 1.0, "rules": DEFAULT_RULES}
    kw: dict[str, Any] = {}
    if isinstance(spec, dict):
        kw = {str(k).strip().lower(): v for k, v in spec.items()}
    elif isinstance(spec, str):
        text = spec.strip().lower()
        if text in _OFF:
            return None
        if text in _ON:
            return {"interval_s": 1.0, "rules": DEFAULT_RULES}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"watchdog: spec entries must be key=value, got {part!r}"
                )
            key, _, value = part.partition("=")
            kw[key.strip().lower()] = value.strip()
    else:
        raise ValueError(
            f"watchdog: cannot parse spec of type {type(spec).__name__}"
        )
    interval = 1.0
    breach_for = clear_for = None
    overrides: dict[str, dict[str, float]] = {}
    for key, value in kw.items():
        if key in ("interval", "interval_s"):
            interval = float(value)
        elif key == "breach_for":
            breach_for = int(value)
        elif key == "clear_for":
            clear_for = int(value)
        elif key in _THRESHOLD_KEYS:
            rule_name, field = _THRESHOLD_KEYS[key]
            overrides.setdefault(rule_name, {})[field] = float(value)
        else:
            raise ValueError(
                f"watchdog: unknown spec key {key!r} (known: interval, "
                f"breach_for, clear_for, {sorted(_THRESHOLD_KEYS)})"
            )
    rules = []
    for rule in DEFAULT_RULES:
        changes: dict[str, Any] = dict(overrides.get(rule.name, {}))
        if breach_for is not None:
            changes["breach_for"] = breach_for
        if clear_for is not None:
            changes["clear_for"] = clear_for
        if changes:
            from dataclasses import replace as _replace

            rule = _replace(rule, **changes)
        rules.append(rule)
    return {"interval_s": interval, "rules": tuple(rules)}


def _deadline_budget_s() -> float | None:
    """The serving deadline budget: ``PATHWAY_DEADLINE_MS`` override,
    else the ServingConfig default (per-request headers can tighten a
    given request, but the server-side default is the burn baseline)."""
    raw = os.environ.get("PATHWAY_DEADLINE_MS", "")
    if raw.strip():
        try:
            ms = float(raw)
            return ms / 1000.0 if ms > 0 else None
        except ValueError:
            pass
    try:
        from ..serving.admission import ServingConfig

        ms = ServingConfig.default_deadline_ms
        return float(ms) / 1000.0 if ms else None
    except Exception:
        return None


def render_verdict(verdict: dict) -> str:
    """Human rendering of a :class:`HealthWatchdog` verdict: overall
    status, one line per plane with its evidence lines indented below
    (what ``pathway doctor`` prints without ``--json``)."""
    lines = [f"overall: {str(verdict.get('status', 'unknown')).upper()}"]
    planes = verdict.get("planes") or {}
    for plane in sorted(planes):
        entry = planes[plane]
        lines.append(f"  {plane:<8} {entry.get('status', 'unknown')}")
        for evidence in entry.get("evidence", []):
            lines.append(f"    {evidence}")
    hbm = verdict.get("hbm")
    if hbm:
        accounts = hbm.get("accounts") or {}
        lines.append(
            f"  ledger: {hbm.get('total_bytes', 0) / 2**20:.1f} MiB live "
            f"across {len(accounts)} accounts "
            f"(high water {hbm.get('high_water_bytes', 0) / 2**20:.1f} MiB, "
            f"budget {hbm.get('budget_bytes', 0) / 2**20:.1f} MiB)"
        )
        for account in sorted(accounts):
            acc = accounts[account]
            lines.append(
                f"    {account:<14} {acc.get('bytes', 0) / 2**20:8.1f} MiB "
                f"({acc.get('owners', 0)} owners, "
                f"frag {acc.get('fragmentation', 0.0) * 100:.0f}%)"
            )
    chip = verdict.get("chip")
    if chip:
        lines.append(
            f"  chip-time: {chip.get('busy_seconds', 0.0):.3f}s busy / "
            f"{chip.get('wall_seconds', 0.0):.3f}s wall "
            f"(accounted {chip.get('accounted_fraction', 0.0) * 100:.0f}%, "
            f"stranded {chip.get('stranded_fraction', 0.0) * 100:.0f}%)"
        )
        for account, row in (chip.get("accounts") or {}).items():
            lines.append(
                f"    {account:<14} {row.get('seconds', 0.0):8.3f}s "
                f"({row.get('share', 0.0) * 100:5.1f}%, "
                f"{row.get('dispatches', 0)} dispatches)"
            )
        causes = chip.get("stranded_causes") or {}
        cause_txt = ", ".join(
            f"{c}={s:.3f}s" for c, s in causes.items() if s
        )
        if cause_txt:
            lines.append(f"    stranded causes: {cause_txt}")
        mfu = chip.get("encode_mfu")
        if mfu:
            lines.append(
                f"    encode MFU {mfu.get('mfu', 0.0) * 100:.2f}% "
                f"({mfu.get('achieved_tflops', 0.0):.1f} / "
                f"{mfu.get('peak_tflops', 0.0):.1f} TFLOPs)"
            )
    fresh = verdict.get("freshness")
    if fresh:
        lag = fresh.get("lag") or {}
        slo_ms = fresh.get("slo_ms")
        slo_txt = f", slo {slo_ms:g}ms" if slo_ms else ""
        lines.append(
            f"  freshness: lag p50 {lag.get('p50_ms', 0.0):.1f}ms / "
            f"p99 {lag.get('p99_ms', 0.0):.1f}ms "
            f"(ewma {lag.get('ewma_ms') or 0.0:.1f}ms over "
            f"{fresh.get('epochs', 0)} epochs{slo_txt})"
        )
        planes_acc = fresh.get("planes") or {}
        acc_txt = ", ".join(
            f"{p}={row.get('seconds', 0.0) * 1000:.1f}ms"
            for p, row in planes_acc.items()
            if row.get("events")
        )
        if acc_txt:
            lines.append(f"    lag accrual: {acc_txt}")
        for key, row in (fresh.get("watermarks") or {}).items():
            lines.append(
                f"    {key:<14} staleness {row.get('staleness_ms', 0.0):8.1f}ms "
                f"(wm epoch {row.get('wm_epoch', -1)}, "
                f"{row.get('shards', 0)} shards, gen {row.get('generation', 0)})"
            )
    tenants = verdict.get("tenants")
    if tenants:
        rows = tenants.get("tenants") or {}
        folded = tenants.get("folded", 0)
        summary = f"  tenants: {tenants.get('tenant_count', len(rows))} active"
        if folded:
            summary += f" ({folded} folded into \"other\")"
        lines.append(summary)
        for tenant, row in rows.items():
            shed = sum((row.get("shed") or {}).values())
            state = "cold" if row.get("cold") else "hot"
            lines.append(
                f"    {tenant:<14} {row.get('docs', 0):>7} docs "
                f"{row.get('hbm_bytes', 0) / 2**20:8.1f} MiB {state:<4} "
                f"admitted={row.get('admitted', 0)} shed={shed} "
                f"inflight={row.get('inflight', 0)} "
                f"chip={row.get('chip_seconds', 0.0):.3f}s"
            )
    if verdict.get("dump_path"):
        lines.append(f"  flight recorder dump: {verdict['dump_path']}")
    if verdict.get("dump_error"):
        lines.append(
            f"  flight recorder dump failed: {verdict['dump_error']}"
        )
    lines.append(
        f"  samples={verdict.get('samples', 0)} "
        f"breaches={verdict.get('breaches', 0)}"
    )
    return "\n".join(lines)
