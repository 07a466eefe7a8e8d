"""Live reshard: grow/shrink the index mesh under traffic with zero
dropped requests.

The port's copy of the reference's ``elastic/controller.py``. Three
pieces, smallest first:

- :class:`ElasticIndexHandle` — the serve-through wrapper queries and
  writes go through. It holds the *current-generation* index behind one
  lock; a reshard swaps the backend atomically under that lock, so a
  request observes either the old generation or the new one, never a
  torn mix and never an error. While a migration is in flight the
  handle mirrors every write into a delta log (applied to the live old
  index immediately, replayed onto the target before cutover), and
  during the brief cutover window it answers from BOTH generations,
  deduplicating per-key with the new generation winning — the
  "double answer" a distributed cutover can produce is resolved here,
  and counted (``pathway_elastic_dedup_dropped_total``).

- :func:`reshard` — the migration itself. Bumps the durable cluster
  generation (the fencing token) and records a durable reshard *intent*
  when a persistence backend is registered, spawns an empty
  like-configured index on the target mesh (resolved on the source
  index's platform: a CPU mesh for a CPU index, the cards or the device
  pool of ``parallel/mesh.py`` for a card's), streams the source's rows
  over in bounded chunks (``chunk_rows``) through the host with queries
  flowing between chunks, then barriers the target's device state
  (every target card synchronised), replays the write delta, and cuts every
  handle over atomically. The old index is fenced: a zombie writer
  still holding it gets :class:`~pathway_tpu_torch.ops.knn.StaleGeneration`
  instead of silently corrupting a dead generation. Any failure before
  cutover aborts back to the untouched old generation (rollback is a
  pointer drop — the source is never mutated by migration); a SIGKILL
  leaves the durable intent behind, and
  :func:`recover_pending_reshard` either completes it idempotently or
  rolls it back on restart. Chaos sites ``elastic.migrate_chunk`` /
  ``elastic.cutover`` / ``elastic.abort`` cover every one of those
  boundaries.

- :class:`ElasticController` — the watermark loop ``pw.run(elastic=)``
  arms: every ``interval_s`` it reads the HBM ledger (footprint vs
  ``PATHWAY_HBM_BYTES`` budget, EWMA time-to-OOM forecast) and the
  chip ledger's stranded fraction, and reshards — grow by doubling up
  to ``max_shards``, shrink by halving down to ``min_shards`` — with a
  ``cooldown_s`` floor between controller-initiated reshards. Manual
  :func:`reshard` calls are never throttled.
"""

from __future__ import annotations

import threading
import time as _time
import weakref
from typing import Any

from ..internals import flight_recorder
from ..resilience import chaos
from ..resilience.cluster import CLUSTER_HEALTH, CLUSTER_METRICS
from .config import ElasticConfig, active_elastic
from .metrics import ELASTIC_METRICS

__all__ = [
    "ElasticController",
    "ElasticIndexHandle",
    "current_shards",
    "handles",
    "recover_pending_reshard",
    "register_cluster",
    "register_handle",
    "register_persistence",
    "reshard",
    "reset_registry",
]


# ---------------------------------------------------------------------------
# the serve-through handle


def _dedup_rows(new_rows, old_rows, k: int):
    """Merge per-query answers from both generations: the new
    generation wins on key collisions (its answer reflects post-delta
    state), survivors of the old answer fill in, best-score order,
    truncated to k. Returns (rows, dropped_duplicates)."""
    out = []
    dropped = 0
    for new_row, old_row in zip(new_rows, old_rows):
        seen = {key for key, _ in new_row}
        merged = list(new_row)
        for key, score in old_row:
            if key in seen:
                dropped += 1
                continue
            merged.append((key, score))
        merged.sort(key=lambda t: -t[1])
        out.append(merged[:k])
    return out, dropped


class ElasticIndexHandle:
    """One logical index across generations (see module docstring).

    Duck-types the index protocol the engine and serving layers use —
    add/remove/search and the tenant/tier variants — and forwards
    everything else to the current backend via ``__getattr__``, so it
    drops in anywhere a ``DeviceKnnIndex`` (or tiered / tenant-packed
    slab) is expected."""

    _WRITE_OPS = (
        "add",
        "add_batch",
        "add_batch_arrays",
        "add_batch_device",
        "remove",
        "add_tenant",
        "add_tenant_batch",
        "remove_tenant",
    )

    def __init__(self, index: Any):
        self._lock = threading.RLock()
        self._index = index
        self._migrating = False
        self._delta: list[tuple[str, tuple, dict]] = []
        self._dual: Any = None  # old-generation index, cutover window only
        self.generation = int(getattr(index, "generation", 0) or 0)

    # -- introspection --

    @property
    def index(self) -> Any:
        with self._lock:
            return self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def __getattr__(self, name: str) -> Any:
        # only reached for names not defined on the handle; delegation
        # keeps duck-typed callers (engine diff protocol, serving)
        # working against whichever generation is current — resolved
        # under the lock so a concurrent cutover can't hand out the
        # just-fenced old generation
        d = self.__dict__
        with d["_lock"]:
            return getattr(d["_index"], name)

    # -- writes (mirrored into the delta log while migrating) --

    def _write(self, op: str, *args: Any, **kwargs: Any) -> Any:
        with self._lock:
            if self._migrating:
                self._delta.append((op, args, kwargs))
            return getattr(self._index, op)(*args, **kwargs)

    def add(self, *a: Any, **k: Any):
        return self._write("add", *a, **k)

    def add_batch(self, *a: Any, **k: Any):
        return self._write("add_batch", *a, **k)

    def add_batch_arrays(self, *a: Any, **k: Any):
        return self._write("add_batch_arrays", *a, **k)

    def add_batch_device(self, *a: Any, **k: Any):
        return self._write("add_batch_device", *a, **k)

    def remove(self, *a: Any, **k: Any):
        return self._write("remove", *a, **k)

    def add_tenant(self, *a: Any, **k: Any):
        return self._write("add_tenant", *a, **k)

    def add_tenant_batch(self, *a: Any, **k: Any):
        return self._write("add_tenant_batch", *a, **k)

    def remove_tenant(self, *a: Any, **k: Any):
        return self._write("remove_tenant", *a, **k)

    # -- reads (dual-served + deduped during the cutover window) --

    def search_batch(self, queries, k: int, filter_fns=None):
        with self._lock:
            if self._dual is None:
                return self._index.search_batch(queries, k, filter_fns)
            new_rows = self._index.search_batch(queries, k, filter_fns)
            old_rows = self._dual.search_batch(queries, k, filter_fns)
        rows, dropped = _dedup_rows(new_rows, old_rows, k)
        if dropped:
            ELASTIC_METRICS.record_dedup_dropped(dropped)
        return rows

    def search_tenant_batch(self, tenant, queries, k: int, filter_fns=None):
        with self._lock:
            if self._dual is None:
                return self._index.search_tenant_batch(tenant, queries, k, filter_fns)
            new_rows = self._index.search_tenant_batch(tenant, queries, k, filter_fns)
            old_rows = self._dual.search_tenant_batch(tenant, queries, k, filter_fns)
        rows, dropped = _dedup_rows(new_rows, old_rows, k)
        if dropped:
            ELASTIC_METRICS.record_dedup_dropped(dropped)
        return rows

    # -- migration protocol (driven by reshard()) --

    def begin_migration(self) -> None:
        with self._lock:
            self._migrating = True
            self._delta = []

    def drain_delta(self) -> list[tuple[str, tuple, dict]]:
        with self._lock:
            delta, self._delta = self._delta, []
            return delta

    def abort_migration(self) -> None:
        with self._lock:
            self._migrating = False
            self._delta = []
            self._dual = None

    def cutover(self, target: Any, generation: int) -> Any:
        """Atomic generation swap; returns the old index (now frozen
        behind the dual-serve window until :meth:`end_cutover`)."""
        with self._lock:
            old, self._index = self._index, target
            self._dual = old
            self._migrating = False
            self._delta = []
            self.generation = int(generation)
            # generation-aware watermark carry: the new shard set
            # inherits the old index-level minimum, so the visible
            # watermark is monotone across the cutover (no time-travel)
            # and the dual-answer dedup window serves under it
            from ..freshness.plane import FRESHNESS

            FRESHNESS.carry_over(old, target, int(generation))
            return old

    def end_cutover(self) -> None:
        with self._lock:
            self._dual = None


# ---------------------------------------------------------------------------
# registry: handles + durable/cluster hooks


_reg_lock = threading.Lock()
_handles: list[weakref.ref] = []
_persistence_ref: Any = None  # weakref to the engine persistence backend
_cluster_ref: Any = None  # weakref to the live CoordinatorCluster


def _install_eta_source() -> None:
    """Hook the admission plane's Retry-After to the live migration ETA
    (satellite: proportional back-off instead of a constant). Lazy —
    installed when the elastic plane first activates, never at import —
    and deferential: an ETA source someone else registered stays."""
    CLUSTER_HEALTH.set_eta_source(
        ELASTIC_METRICS.migration_eta_s, if_unset=True
    )


def register_handle(index_or_handle: Any) -> ElasticIndexHandle:
    """Wrap ``index_or_handle`` (idempotent for an existing handle) and
    enroll it with the reshard plane. Everything enrolled migrates
    together on :func:`reshard` — one generation, one cutover."""
    h = (
        index_or_handle
        if isinstance(index_or_handle, ElasticIndexHandle)
        else ElasticIndexHandle(index_or_handle)
    )
    _install_eta_source()
    with _reg_lock:
        if all(r() is not h for r in _handles):
            _handles.append(weakref.ref(h))
    return h


def handles() -> list[ElasticIndexHandle]:
    with _reg_lock:
        out = []
        live = []
        for r in _handles:
            h = r()
            if h is not None:
                out.append(h)
                live.append(r)
        _handles[:] = live
        return out


def register_persistence(p: Any) -> None:
    """Give the reshard plane a durable token store (the engine's
    persistence backend): generation bumps and reshard intents become
    durable, which is what makes SIGKILL-at-any-boundary recoverable."""
    global _persistence_ref
    with _reg_lock:
        _persistence_ref = weakref.ref(p) if p is not None else None


def register_cluster(c: Any) -> None:
    """Called by ``CoordinatorCluster`` at formation so a reshard can
    advance the live cluster's generation (fencing zombie frames)."""
    global _cluster_ref
    with _reg_lock:
        _cluster_ref = weakref.ref(c) if c is not None else None


def _persistence() -> Any:
    with _reg_lock:
        return _persistence_ref() if _persistence_ref is not None else None


def _cluster() -> Any:
    with _reg_lock:
        return _cluster_ref() if _cluster_ref is not None else None


def reset_registry() -> None:
    """Test hook: drop every enrolled handle and hook."""
    global _persistence_ref, _cluster_ref
    with _reg_lock:
        _handles.clear()
        _persistence_ref = None
        _cluster_ref = None


def current_shards() -> int:
    """The shard count of the current generation (max across handles —
    they cut over together, so a mix only exists mid-bug)."""
    hs = handles()
    if not hs:
        return 1
    return max(int(getattr(h.index, "n_shards", 1) or 1) for h in hs)


# ---------------------------------------------------------------------------
# the migration


def _resolve_target_mesh(to_shards: int, index: Any):
    """Mesh for the target generation, on the source index's platform:
    None keeps the single-device index (on the source's first device); a
    CPU index resolves a CPU mesh, a card's index the cards (or the device
    pool). Raises, before any state is touched, when fewer devices are
    visible than ``to_shards``: an aborted reshard, not a crash, and never
    a fall back to the CPU."""
    if to_shards <= 1:
        return None
    from ..parallel.mesh import resolve_mesh

    device = getattr(index, "device", None)
    return resolve_mesh(int(to_shards), device="cpu" if getattr(device, "type", None) == "cpu" else None)


def _estimate_chunks(index: Any, chunk_rows: int) -> int:
    n = max(1, -(-len(index) // max(1, chunk_rows)))
    # tiered indexes prepend one tier-state chunk
    return n + (1 if getattr(index, "is_tiered", False) else 0)


def _barrier(index: Any) -> None:
    """Commit the target's staged writes to its device slabs and wait
    for every target card: the barrier-snapshot before cutover."""
    from ..ops.knn import _sync_cards

    hot = getattr(index, "hot", None)
    flat = hot if hot is not None else index
    sync = getattr(flat, "_sync", None)
    if callable(sync):
        sync()
    _sync_cards(getattr(flat, "shard_devices", ()))


def reshard(
    to_shards: int,
    *,
    reason: str = "manual",
    chunk_rows: int | None = None,
    config: ElasticConfig | None = None,
) -> dict:
    """Migrate every registered index to ``to_shards`` shards, live.

    Returns a summary dict (``from_shards``, ``to_shards``,
    ``generation``, ``mttr_s``, ``rows_migrated``, ``indexes``). A
    no-op (already at ``to_shards``) returns with ``indexes=0`` and
    clears any durable intent — which is exactly what makes a retried
    reshard idempotent. Raises on failure, with the old generation
    still serving (rollback)."""
    cfg = config if config is not None else (active_elastic() or ElasticConfig())
    rows_per_chunk = int(chunk_rows) if chunk_rows else cfg.chunk_rows
    to_shards = int(to_shards)
    if to_shards < 1:
        raise ValueError(f"reshard: target shard count must be >= 1, got {to_shards}")
    hs = handles()
    from_shards = current_shards()
    p = _persistence()
    if not hs or all(int(getattr(h.index, "n_shards", 1) or 1) == to_shards for h in hs):
        if p is not None:
            p.clear_reshard_intent()
        return {
            "from_shards": from_shards,
            "to_shards": to_shards,
            "generation": max([h.generation for h in hs], default=0),
            "mttr_s": 0.0,
            "rows_migrated": 0,
            "indexes": 0,
        }
    t0 = _time.monotonic()
    mesh = _resolve_target_mesh(to_shards, hs[0].index)  # raises before any state change
    if p is not None:
        generation = p.bump_cluster_generation()
        p.record_reshard_intent(to_shards, generation)
    else:
        generation = max(h.generation for h in hs) + 1
    flight_recorder.record(
        "elastic.reshard_begin",
        from_shards=from_shards,
        to_shards=to_shards,
        generation=generation,
        reason=reason,
        indexes=len(hs),
    )
    ELASTIC_METRICS.migration_begin(
        sum(_estimate_chunks(h.index, rows_per_chunk) for h in hs),
        from_shards,
        to_shards,
    )
    migrated: list[tuple[ElasticIndexHandle, Any, Any, int]] = []
    begun: list[ElasticIndexHandle] = []
    total_rows = 0
    try:
        for h in hs:
            old = h.index
            target = old.spawn_like(mesh)
            target.generation = generation
            h.begin_migration()
            begun.append(h)
            n_rows = 0
            exporter = old.reshard_export_chunks(rows_per_chunk)
            while True:
                # advance the exporter under the handle lock: writers
                # mutate the source under that same lock, and the
                # export's filter-then-lookup walk is not atomic
                # against a racing remove()
                with h._lock:
                    chunk = next(exporter, None)
                if chunk is None:
                    break
                chaos.inject("elastic.migrate_chunk")
                # the import runs without the handle lock: no reader or
                # writer can reach the target before the cutover, and a
                # chunk's import (a doubling of the target's host mirror
                # among it) must not stall the queries on the old generation
                target.reshard_import_chunk(chunk)
                rows = len(chunk.get("keys", ()))
                n_rows += rows
                ELASTIC_METRICS.record_chunk(rows)
            target.reshard_finish()
            # writes that raced the chunk loop: replay toward quiescence,
            # but bounded — a writer pushing at full speed must not
            # livelock the migration. Whatever still races is drained
            # under the cutover lock below, where writers are blocked.
            for _ in range(8):
                delta = h.drain_delta()
                if not delta:
                    break
                for op, args, kwargs in delta:
                    getattr(target, op)(*args, **kwargs)
            migrated.append((h, old, target, n_rows))
            total_rows += n_rows
        for _h, _old, target, _n in migrated:
            _barrier(target)
        chaos.inject("elastic.cutover")
        for h, old, target, _n in migrated:
            with h._lock:
                for op, args, kwargs in h.drain_delta():
                    getattr(target, op)(*args, **kwargs)
                h.cutover(target, generation)
            old.fence(generation)
            flight_recorder.record(
                "elastic.cutover",
                index=getattr(old, "name", "?"),
                generation=generation,
                from_shards=from_shards,
                to_shards=to_shards,
            )
        if p is not None:
            p.clear_reshard_intent()
        cl = _cluster()
        if cl is not None:
            cl.advance_generation(generation)
        elif p is not None:
            CLUSTER_METRICS.set_generation(generation)
        mttr_s = _time.monotonic() - t0
        ELASTIC_METRICS.record_cutover(generation, mttr_s, reason)
        from ..freshness.plane import FRESHNESS

        # rows finished migrating this much after they were first
        # visible on the old generation — additive freshness accrual
        FRESHNESS.accrue("migration", mttr_s)
        for h, _old, _target, _n in migrated:
            h.end_cutover()
        flight_recorder.record(
            "elastic.reshard_done",
            from_shards=from_shards,
            to_shards=to_shards,
            generation=generation,
            mttr_s=round(mttr_s, 6),
            rows=total_rows,
            reason=reason,
        )
        _record_reshard_span(t0, from_shards, to_shards, generation, reason)
        return {
            "from_shards": from_shards,
            "to_shards": to_shards,
            "generation": generation,
            "mttr_s": mttr_s,
            "rows_migrated": total_rows,
            "indexes": len(migrated),
        }
    except BaseException as exc:
        # rollback: the old generation was never touched — dropping the
        # half-built target IS the recovery. The abort chaos site sits
        # first so scripted kills exercise crash-during-abort too; a
        # scripted *raise* must not mask the original failure.
        try:
            chaos.inject("elastic.abort")
        except chaos.ChaosInjected:
            pass
        for h in begun:
            h.abort_migration()
        ELASTIC_METRICS.record_rollback()
        if p is not None:
            try:
                p.clear_reshard_intent()
            except Exception:
                pass
        flight_recorder.record(
            "elastic.reshard_abort",
            from_shards=from_shards,
            to_shards=to_shards,
            generation=generation,
            reason=str(exc)[:200],
        )
        raise


def _record_reshard_span(
    t0: float, from_shards: int, to_shards: int, generation: int, reason: str
) -> None:
    """One `elastic.reshard` span per migration so `pathway trace slow`
    surfaces reshard MTTR next to slow requests."""
    from ..tracing.store import record_span

    record_span(
        "elastic.reshard",
        start_mono=t0,
        end_mono=_time.monotonic(),
        new_trace=True,
        from_shards=from_shards,
        to_shards=to_shards,
        generation=generation,
        reason=reason,
    )


def recover_pending_reshard(*, complete: bool = True) -> dict | None:
    """Resolve a reshard interrupted by a crash (SIGKILL at a chunk or
    cutover boundary): the durable intent survives the process, and on
    restart — after persistence replay has rebuilt the indexes — this
    either re-runs the migration to the recorded target (idempotent:
    the data came back via the log; only the slab layout is redone) or
    clears the intent, formally rolling back to the pre-reshard shard
    count. Byte-identical either way: migration never mutates source
    data. Returns the reshard summary, or None when nothing pended."""
    p = _persistence()
    if p is None:
        return None
    intent = p.reshard_intent()
    if intent is None:
        return None
    target_shards, generation = intent
    if complete and handles():
        flight_recorder.record(
            "elastic.recover",
            action="complete",
            to_shards=target_shards,
            generation=generation,
        )
        return reshard(target_shards, reason="recovery")
    p.clear_reshard_intent()
    ELASTIC_METRICS.record_rollback()
    flight_recorder.record(
        "elastic.recover",
        action="rollback",
        to_shards=target_shards,
        generation=generation,
    )
    return None


# ---------------------------------------------------------------------------
# the watermark controller


class ElasticController:
    """Background watermark loop (see module docstring). Cheap when
    idle: one ledger snapshot per ``interval_s``; the /metrics scrape
    of a run that never reshards stays byte-identical because the
    elastic registry only activates on the first migration."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_action: float | None = None
        self._prev_bytes: int | None = None
        self._prev_t: float | None = None
        self._rate = 0.0  # EWMA bytes/s of ledger footprint growth

    # -- lifecycle --

    def start(self) -> None:
        if self._thread is not None:
            return
        _install_eta_source()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pathway-elastic", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.evaluate_once()
            except Exception as exc:  # watermark loop must never die
                flight_recorder.record(
                    "elastic.controller_error", error=str(exc)[:200]
                )

    # -- one evaluation --

    def _watermarks(self) -> tuple[float | None, float | None, float | None]:
        """(oom_warn_s, hbm_frac, stranded_frac) with auto defaults:
        ``mesh=auto``/``elastic="auto"`` arms the footprint watermark at
        85% of the per-device budget even with nothing else set."""
        cfg = self.cfg
        hbm_frac = cfg.hbm_frac
        if hbm_frac is None and cfg.auto:
            hbm_frac = 0.85
        return cfg.oom_warn_s, hbm_frac, cfg.stranded_frac

    def evaluate_once(self) -> str | None:
        """Evaluate the watermarks once; returns the action taken
        ("grow"/"shrink"/"target") or None."""
        cfg = self.cfg
        if not handles() or ELASTIC_METRICS.migrating():
            return None
        cur = current_shards()
        if cfg.shards is not None and cur != cfg.shards:
            return self._act(cfg.shards, "target")
        oom_warn_s, hbm_frac, stranded_frac = self._watermarks()
        if oom_warn_s is None and hbm_frac is None and stranded_frac is None:
            return None
        from ..internals.ledger import LEDGER, default_hbm_bytes

        snap = LEDGER.snapshot()
        total = int(snap.get("total_bytes") or 0)
        budget = int(snap.get("budget_bytes") or 0) or default_hbm_bytes()
        now = _time.monotonic()
        if self._prev_bytes is not None and self._prev_t is not None:
            dt = max(1e-6, now - self._prev_t)
            inst = (total - self._prev_bytes) / dt
            self._rate = 0.5 * self._rate + 0.5 * max(0.0, inst)
        self._prev_bytes, self._prev_t = total, now
        frac = total / budget if budget else 0.0
        grow = min(cfg.max_shards, max(cur * 2, cfg.min_shards))
        shrink = max(cfg.min_shards, cur // 2)
        if hbm_frac is not None and frac > hbm_frac and grow > cur:
            return self._act(grow, "hbm_watermark")
        if oom_warn_s is not None and self._rate > 0 and grow > cur:
            headroom = max(0, budget - total)
            if headroom / self._rate < oom_warn_s:
                return self._act(grow, "time_to_oom")
        if stranded_frac is not None and shrink < cur:
            from ..internals.chip_ledger import CHIP_LEDGER

            chip = CHIP_LEDGER.snapshot()
            if float(chip.get("stranded_fraction") or 0.0) > stranded_frac:
                return self._act(shrink, "stranded_chip_time")
        if (
            cfg.auto
            and hbm_frac is not None
            and shrink < cur
            and budget
            and frac < hbm_frac / 4.0
        ):
            # auto shrink: footprint fell far below the grow watermark
            return self._act(shrink, "footprint_shrunk")
        return None

    def _act(self, to_shards: int, reason: str) -> str | None:
        now = _time.monotonic()
        if self._last_action is not None and (
            now - self._last_action < self.cfg.cooldown_s
        ):
            return None
        self._last_action = now
        try:
            reshard(
                to_shards,
                reason=reason,
                chunk_rows=self.cfg.chunk_rows,
                config=self.cfg,
            )
        except Exception as exc:
            flight_recorder.record(
                "elastic.reshard_failed",
                to_shards=to_shards,
                reason=reason,
                error=str(exc)[:200],
            )
            return None
        return reason


