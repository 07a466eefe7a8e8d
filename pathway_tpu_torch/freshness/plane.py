"""End-to-end freshness plane: event-time watermarks from connector
arrival to queryability, and answer-level staleness bounds.

The port's copy of the reference's ``freshness/plane.py``. One
process-wide registry (:data:`FRESHNESS`) tracks three things:

* **Arrival watermarks** — every ``InputSession.insert/upsert/remove``
  stamps the arrival wall clock per source; ``commit``/``drain`` move
  those stamps with the data so each engine epoch knows the arrival
  window of the rows it carries.
* **Epoch transition marks** — the stager/executor pipeline (and the
  strict serial loop) stamp each epoch at four points: drained →
  staged (upsert resolution + KIND_FEED) → exec begin → committed.
  The per-plane visibility-lag split (``ingest_queue`` / ``staging`` /
  ``epoch`` / ``publish``) falls out of consecutive differences, so
  the accrual sums to the measured end-to-end lag *by construction*.
* **Per-shard visible watermarks** — every index publish (scatter
  commit) advances ``(index, shard) → (wm_epoch, wm_wall)``
  monotonically. The watermark value is the epoch's *drain cutoff*:
  every row that arrived before it is queryable on that shard. An
  elastic cutover carries the old generation's index-level minimum onto
  every new shard (:meth:`FreshnessPlane.carry_over`, called by
  ``elastic/controller.py`` at the cutover), and a finished migration
  accrues its wall time under ``migration``.

At query time ``staleness = now − min(visible_wm over shards
touched)``: REST replies carry ``X-Pathway-Freshness-Ms``, RAG answers
inherit the retrieval bound, and trace spans get freshness attributes.

The plane follows the chip-ledger gating discipline: off by default,
enabled via ``pw.run(freshness=...)`` or ``PATHWAY_FRESHNESS``, every
hook a single flag check when off, and nothing renders on
``/metrics``/``/status`` until the plane actually saw activity — a
freshness-off scrape is byte-identical.

Import-light (stdlib only at module level): ``pw.run`` resolves the spec
before anything touches a device.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any

_TRUTHY = ("1", "true", "on", "yes")
_FALSY = ("0", "false", "off", "no", "none")

#: itinerary planes the visibility lag is attributed to, in path order
PLANES = (
    "ingest_queue",  # connector arrival -> epoch drain
    "staging",       # drain -> staged (upsert resolution, KIND_FEED)
    "epoch",         # staged -> executor pickup (pipeline queue wait)
    "publish",       # exec begin -> scatter commit (visible)
    "promotion",     # tier promotion wall (additive, off the hot path)
    "migration",     # elastic migration wall (additive, off the hot path)
)

#: ingest->visible lag histogram bucket upper bounds, seconds
LAG_BUCKETS_S = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

#: bounded sample reservoir for the p50/p99 lag estimates
_MAX_SAMPLES = 8192


def _parse_duration_ms(value: Any, key: str) -> float:
    """``250`` / ``"250"`` = ms; ``"250ms"``; ``"0.25s"``."""
    if isinstance(value, (int, float)):
        return float(value)
    text = str(value).strip().lower()
    try:
        if text.endswith("ms"):
            return float(text[:-2])
        if text.endswith("s"):
            return float(text[:-1]) * 1000.0
        return float(text)
    except ValueError:
        raise ValueError(f"freshness: cannot parse {key}={value!r} as a duration")


@dataclass(frozen=True)
class FreshnessConfig:
    """Parsed ``pw.run(freshness=)`` / ``PATHWAY_FRESHNESS`` spec."""

    slo_ms: float | None = None

    def as_dict(self) -> dict:
        return {"slo_ms": self.slo_ms}


def parse_freshness_spec(spec: Any) -> FreshnessConfig | None:
    """Coerce a freshness spec into a config (or ``None`` = plane off).

    Accepted forms::

        freshness=True                 # plane on, no SLO
        freshness="slo=250ms"          # plane on + freshness SLO budget
        freshness={"slo_ms": 250}
        PATHWAY_FRESHNESS=1 | off | slo=2s

    Raises ``ValueError`` on malformed specs.
    """
    if spec is None or spec is False:
        return None
    if spec is True:
        return FreshnessConfig()
    if isinstance(spec, FreshnessConfig):
        return spec
    kw: dict[str, Any] = {}
    if isinstance(spec, dict):
        kw = {str(k).strip().lower(): v for k, v in spec.items()}
    elif isinstance(spec, str):
        text = spec.strip().lower()
        if text in _FALSY:
            return None
        if text in _TRUTHY or text == "":
            return FreshnessConfig()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"freshness: spec entries must be key=value, got {part!r}"
                )
            key, _, value = part.partition("=")
            kw[key.strip().lower()] = value.strip()
    else:
        raise ValueError(
            f"freshness: cannot parse spec of type {type(spec).__name__}"
        )
    slo_ms: float | None = None
    for key, value in kw.items():
        if key in ("slo", "slo_ms"):
            slo_ms = _parse_duration_ms(value, key)
        else:
            raise ValueError(f"freshness: unknown spec key {key!r} (known: slo)")
    return FreshnessConfig(slo_ms=slo_ms)


def freshness_enabled() -> bool:
    """Process default from ``PATHWAY_FRESHNESS`` (any non-off spec
    counts as on; a malformed env spec counts as off)."""
    raw = os.environ.get("PATHWAY_FRESHNESS", "")
    if not raw.strip():
        return False
    try:
        return parse_freshness_spec(raw) is not None
    except ValueError:
        return False


class _SourceStats:
    """Arrival window of one source's rows: pending (uncommitted),
    then committed (awaiting drain)."""

    __slots__ = ("p_min", "p_max", "p_n", "c_min", "c_max", "c_n")

    def __init__(self) -> None:
        self.p_min = self.p_max = None
        self.p_n = 0
        self.c_min = self.c_max = None
        self.c_n = 0


class FreshnessPlane:
    """Process-wide watermark registry. Thread-safe; every public hook
    is a no-op single flag check while the plane is disabled."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._override: bool | None = None
        self._touched = False
        self.slo_ms: float | None = None
        # arrival tracking, keyed by id(InputSession)
        self._sources: dict[int, _SourceStats] = {}
        # drained-but-not-yet-epoch-assigned arrival window
        self._drained: list | None = None  # [min, max, n, drain_ts]
        # in-flight epoch records keyed by engine epoch time
        self._epochs: dict[int, dict] = {}
        # ambient executing epoch (one epoch executes at a time)
        self._exec_epoch: int | None = None
        self._epoch_touched: set[tuple[str, int]] = set()
        # (index, shard) -> [wm_epoch, wm_wall]; index -> generation
        self._wm: dict[str, dict[int, list]] = {}
        self._gen: dict[str, int] = {}
        self._index_seq = 0
        # per-plane accrual: plane -> [seconds, events]
        self._accrued: dict[str, list] = {p: [0.0, 0] for p in PLANES}
        # end-to-end ingest->visible lag
        self._lag_samples: list[float] = []  # ms, bounded reservoir
        self._lag_hist = [0] * (len(LAG_BUCKETS_S) + 1)
        self._lag_count = 0
        self._lag_total_s = 0.0
        self._lag_last_ms = 0.0
        self._lag_ewma_ms: float | None = None
        self._epochs_committed = 0
        # answer-level staleness (per tenant; "" = untagged)
        self._answers: dict[str, list] = {}  # tenant -> [n, sum, max, last]

    # -- gating --

    def set_enabled(self, on: bool | None) -> None:
        """Run-scoped override: True/False wins over the env default,
        ``None`` restores env-driven behavior."""
        self._override = on

    def configure(self, cfg: FreshnessConfig | None) -> None:
        self.slo_ms = cfg.slo_ms if cfg is not None else None

    def enabled(self) -> bool:
        if self._override is not None:
            return self._override
        return freshness_enabled()

    def on(self) -> bool:
        return self.enabled()

    def active(self) -> bool:
        """True once the enabled plane actually recorded something —
        the /metrics and /status gate (off runs stay byte-identical)."""
        return self._touched

    # -- arrival watermarks (connector threads) --

    def note_arrival(self, source_id: int, ts: float | None = None, n: int = 1) -> None:
        if not self.enabled():
            return
        now = time.time() if ts is None else float(ts)
        with self._lock:
            self._touched = True
            st = self._sources.get(source_id)
            if st is None:
                st = self._sources[source_id] = _SourceStats()
            if st.p_min is None or now < st.p_min:
                st.p_min = now
            if st.p_max is None or now > st.p_max:
                st.p_max = now
            st.p_n += n

    def note_commit(self, source_id: int) -> None:
        if not self.enabled():
            return
        with self._lock:
            st = self._sources.get(source_id)
            if st is None or st.p_n == 0:
                return
            if st.c_min is None or st.p_min < st.c_min:
                st.c_min = st.p_min
            if st.c_max is None or st.p_max > st.c_max:
                st.c_max = st.p_max
            st.c_n += st.p_n
            st.p_min = st.p_max = None
            st.p_n = 0

    def note_drain(self, source_id: int) -> None:
        """A non-empty drain moved this source's committed rows toward
        the next epoch; fold its arrival window into the holding area
        the next ``begin_epoch`` sweeps."""
        if not self.enabled():
            return
        now = time.time()
        with self._lock:
            st = self._sources.get(source_id)
            if st is None or st.c_n == 0:
                return
            if self._drained is None:
                self._drained = [st.c_min, st.c_max, st.c_n, now]
            else:
                d = self._drained
                if st.c_min < d[0]:
                    d[0] = st.c_min
                if st.c_max > d[1]:
                    d[1] = st.c_max
                d[2] += st.c_n
                d[3] = now
            st.c_min = st.c_max = None
            st.c_n = 0

    # -- epoch transition marks (engine loop / stager / executor) --

    def begin_epoch(self, t: int) -> None:
        if not self.enabled():
            return
        with self._lock:
            self._touched = True
            drained, self._drained = self._drained, None
            rec: dict[str, Any] = {"drained": time.time()}
            if drained is not None:
                rec["arrival_min"] = drained[0]
                rec["arrival_max"] = drained[1]
                rec["n"] = drained[2]
                rec["drained"] = drained[3]
            self._epochs[int(t)] = rec

    def epoch_staged(self, t: int) -> None:
        if not self.enabled():
            return
        with self._lock:
            rec = self._epochs.get(int(t))
            if rec is not None:
                rec["staged"] = time.time()

    def epoch_exec(self, t: int) -> None:
        if not self.enabled():
            return
        with self._lock:
            rec = self._epochs.get(int(t))
            if rec is not None:
                rec["exec"] = time.time()
            self._exec_epoch = int(t)
            self._epoch_touched.clear()

    def epoch_committed(self, t: int) -> None:
        """Scatter-commit point: the epoch's rows are queryable. Accrue
        the per-plane lag split and advance the visible watermark of
        every shard the epoch touched to the epoch's drain cutoff."""
        if not self.enabled():
            return
        now = time.time()
        with self._lock:
            t = int(t)
            rec = self._epochs.pop(t, None)
            touched, self._epoch_touched = self._epoch_touched, set()
            self._exec_epoch = None
            cutoff = now
            if rec is not None:
                drained = rec.get("drained", now)
                staged = rec.get("staged", drained)
                execd = rec.get("exec", staged)
                cutoff = drained
                arrival = rec.get("arrival_min")
                if arrival is not None:
                    self._accrue_locked("ingest_queue", drained - arrival)
                    self._accrue_locked("staging", staged - drained)
                    self._accrue_locked("epoch", execd - staged)
                    self._accrue_locked("publish", now - execd)
                    self._observe_lag_locked((now - arrival) * 1000.0)
                    self._epochs_committed += 1
            for key, shard in touched:
                self._publish_locked(key, shard, cutoff, t)

    # -- per-shard visible watermarks --

    def index_key(self, index: Any) -> str:
        """Stable plane key for an index object. Named indexes key by
        name — ``spawn_like`` reshard targets inherit it, which is what
        makes the watermark continuous across an elastic cutover."""
        name = getattr(index, "name", None)
        if name:
            return str(name)
        key = getattr(index, "_freshness_key", None)
        if key is None:
            with self._lock:
                self._index_seq += 1
                key = f"index-{self._index_seq}"
            try:
                index._freshness_key = key
            except Exception:
                pass
        return key

    def note_index_add(self, index: Any, shards) -> None:
        """Scatter commit on ``shards`` of ``index``. Inside an engine
        epoch the watermark advance is deferred to ``epoch_committed``
        (the epoch's drain cutoff is the watermark value); standalone
        adds are immediately visible and publish ``now``."""
        if not self.enabled():
            return
        key = self.index_key(index)
        with self._lock:
            self._touched = True
            if self._exec_epoch is not None:
                for s in shards:
                    self._epoch_touched.add((key, int(s)))
            else:
                now = time.time()
                for s in shards:
                    self._publish_locked(key, int(s), now, None)

    def publish(self, index: Any, shard: int, wall: float | None = None,
                epoch: int | None = None) -> None:
        """Directly advance one shard's visible watermark (bench/test
        hook; the engine path goes through ``note_index_add``)."""
        if not self.enabled():
            return
        with self._lock:
            self._touched = True
            self._publish_locked(
                self.index_key(index), int(shard),
                time.time() if wall is None else float(wall), epoch,
            )

    def _publish_locked(self, key: str, shard: int, wall: float,
                        epoch: int | None) -> None:
        shards = self._wm.setdefault(key, {})
        wm = shards.get(shard)
        if wm is None:
            shards[shard] = [epoch if epoch is not None else -1, wall]
            return
        # monotone: the watermark never regresses
        if epoch is not None and epoch > wm[0]:
            wm[0] = epoch
        if wall > wm[1]:
            wm[1] = wall

    def carry_over(self, old_index: Any, new_index: Any, generation: int) -> None:
        """Elastic cutover: the new generation's shard set inherits the
        old index-level minimum watermark — the migrated rows are
        exactly as fresh as the source was, so the post-cutover
        watermark never regresses and never claims fresher than real
        (the dual-answer dedup window serves under the same bound)."""
        if not self.enabled():
            return
        with self._lock:
            self._touched = True
            old_key = self.index_key(old_index)
            new_key = self.index_key(new_index)
            old_min = self._min_wm_locked(old_key)
            n_new = max(1, int(getattr(new_index, "n_shards", 1) or 1))
            shards = self._wm.setdefault(new_key, {})
            # shrink prunes shards beyond the new generation's set
            for s in [s for s in shards if s >= n_new]:
                del shards[s]
            if old_min is not None:
                for s in range(n_new):
                    self._publish_locked(new_key, s, old_min[1], old_min[0])
            self._gen[new_key] = int(generation)

    def _min_wm_locked(self, key: str, shards=None):
        entries = self._wm.get(key)
        if not entries:
            return None
        if shards is not None:
            picked = [entries[s] for s in shards if s in entries]
            if not picked:
                return None
        else:
            picked = list(entries.values())
        return min(picked, key=lambda wm: wm[1])

    def visible_wm(self, index: Any, shards=None):
        """``(wm_epoch, wm_wall)`` — the index's visible watermark (min
        over its shards, or the given subset); None before any publish."""
        with self._lock:
            wm = self._min_wm_locked(self.index_key(index), shards)
            return (wm[0], wm[1]) if wm is not None else None

    # -- answer staleness --

    def answer_bound(self, index: Any = None, shards=None,
                     now: float | None = None) -> dict | None:
        """The staleness bound a served answer carries:
        ``now − min(visible_wm over shards touched)`` (all registered
        indexes when ``index`` is None — the REST layer's conservative
        bound). None until some shard published a watermark."""
        if not self.enabled():
            return None
        now = time.time() if now is None else float(now)
        with self._lock:
            if index is not None:
                wm = self._min_wm_locked(self.index_key(index), shards)
            else:
                mins = [self._min_wm_locked(k) for k in self._wm]
                mins = [m for m in mins if m is not None]
                wm = min(mins, key=lambda m: m[1]) if mins else None
            if wm is None:
                return None
            return {
                "staleness_ms": max(0.0, (now - wm[1]) * 1000.0),
                "visible_wm": wm[1],
                "wm_epoch": wm[0],
            }

    def observe_answer(self, index: Any = None, shards=None,
                       tenant: str | None = None,
                       now: float | None = None) -> dict | None:
        """Record one served answer's staleness bound (per-tenant when
        tagged) and return it."""
        bound = self.answer_bound(index, shards, now)
        if bound is None:
            return None
        with self._lock:
            st = self._answers.setdefault(tenant or "", [0, 0.0, 0.0, 0.0])
            ms = bound["staleness_ms"]
            st[0] += 1
            st[1] += ms
            st[2] = max(st[2], ms)
            st[3] = ms
        return bound

    # -- accrual (promotion / migration ride-alongs) --

    def accrue(self, plane: str, seconds: float) -> None:
        if not self.enabled():
            return
        with self._lock:
            self._touched = True
            self._accrue_locked(plane, seconds)

    def _accrue_locked(self, plane: str, seconds: float) -> None:
        acc = self._accrued.setdefault(plane, [0.0, 0])
        acc[0] += max(0.0, float(seconds))
        acc[1] += 1

    def _observe_lag_locked(self, lag_ms: float) -> None:
        lag_ms = max(0.0, lag_ms)
        self._lag_count += 1
        self._lag_total_s += lag_ms / 1000.0
        self._lag_last_ms = lag_ms
        if len(self._lag_samples) < _MAX_SAMPLES:
            self._lag_samples.append(lag_ms)
        else:  # bounded reservoir: overwrite round-robin
            self._lag_samples[self._lag_count % _MAX_SAMPLES] = lag_ms
        for i, le in enumerate(LAG_BUCKETS_S):
            if lag_ms <= le * 1000.0:
                self._lag_hist[i] += 1
                break
        else:
            self._lag_hist[-1] += 1
        # EWMA over ~8 epochs: the watchdog's breach-forecast signal
        if self._lag_ewma_ms is None:
            self._lag_ewma_ms = lag_ms
        else:
            self._lag_ewma_ms = 0.25 * lag_ms + 0.75 * self._lag_ewma_ms

    # -- reporting --

    def lag_ewma_ms(self) -> float | None:
        with self._lock:
            return self._lag_ewma_ms

    def _quantile(self, q: float) -> float:
        data = sorted(self._lag_samples)
        if not data:
            return 0.0
        idx = min(len(data) - 1, int(q * (len(data) - 1) + 0.5))
        return data[idx]

    def snapshot(self, now: float | None = None) -> dict:
        """Everything the /metrics, /status, journal, CLI and watchdog
        surfaces consume, in one dict."""
        now = time.time() if now is None else float(now)
        with self._lock:
            planes = {
                p: {"seconds": acc[0], "events": acc[1]}
                for p, acc in self._accrued.items()
                if acc[1] > 0 or p in PLANES
            }
            pipeline_s = sum(
                self._accrued.get(p, [0.0, 0])[0]
                for p in ("ingest_queue", "staging", "epoch", "publish")
            )
            coverage = (
                pipeline_s / self._lag_total_s if self._lag_total_s > 1e-12 else None
            )
            watermarks = {}
            for key in sorted(self._wm):
                wm = self._min_wm_locked(key)
                if wm is None:
                    continue
                watermarks[key] = {
                    "shards": len(self._wm[key]),
                    "wm_epoch": wm[0],
                    "visible_wm": wm[1],
                    "staleness_ms": max(0.0, (now - wm[1]) * 1000.0),
                    "generation": self._gen.get(key, 0),
                }
            answers = {
                tenant: {
                    "count": st[0],
                    "mean_ms": st[1] / st[0] if st[0] else 0.0,
                    "max_ms": st[2],
                    "last_ms": st[3],
                }
                for tenant, st in self._answers.items()
            }
            return {
                "slo_ms": self.slo_ms,
                "epochs": self._epochs_committed,
                "lag": {
                    "count": self._lag_count,
                    "p50_ms": self._quantile(0.50),
                    "p99_ms": self._quantile(0.99),
                    "ewma_ms": self._lag_ewma_ms,
                    "last_ms": self._lag_last_ms,
                    "total_s": self._lag_total_s,
                    "buckets_s": list(LAG_BUCKETS_S),
                    "hist": list(self._lag_hist),
                },
                "planes": planes,
                "coverage": coverage,
                "watermarks": watermarks,
                "answers": answers,
            }

    def reset(self) -> None:
        with self._lock:
            self._touched = False
            self.slo_ms = None
            self._sources.clear()
            self._drained = None
            self._epochs.clear()
            self._exec_epoch = None
            self._epoch_touched.clear()
            self._wm.clear()
            self._gen.clear()
            self._accrued = {p: [0.0, 0] for p in PLANES}
            self._lag_samples = []
            self._lag_hist = [0] * (len(LAG_BUCKETS_S) + 1)
            self._lag_count = 0
            self._lag_total_s = 0.0
            self._lag_last_ms = 0.0
            self._lag_ewma_ms = None
            self._epochs_committed = 0
            self._answers.clear()


#: Process-wide freshness plane, surfaced on /metrics and /status.
FRESHNESS = FreshnessPlane()
