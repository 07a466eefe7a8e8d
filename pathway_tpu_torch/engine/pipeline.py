"""Overlapped host/device epoch pipeline.

The strict engine loop (``EngineGraph.run``) serializes host work with
device work, epoch by epoch: drain connectors → resolve upserts → log
KIND_FEED → topo sweep (which launches device compute and then blocks
on whatever sinks consume on the host) → advance. While the sweep waits
on the card, the host sits idle instead of preparing the next epoch.

``run_pipelined`` splits the loop into a *stager* and an *executor*:

- the **stager** (one background thread) owns epoch formation — it
  drains sessions, resolves upsert protocols against source state,
  durably logs the KIND_FEED record (the staging **commit point**: once
  logged, a crash replays the epoch from the log, so connector offsets
  may advance past it) and hands a :class:`StagedEpoch` to a bounded
  queue of ``pipeline_depth - 1`` entries;
- the **executor** (the calling thread) pops staged epochs in order and
  runs the unchanged strict tail: emit → topo sweep → sink flush →
  ``mark_delivered`` → ADVANCE → snapshot.

While the executor blocks inside epoch N's sweep, the stager is already
tokenizing/resolving/staging epoch N+1 — that concurrency is the
overlap the profiler attributes (``host_prep_s`` / ``device_wait_s`` /
``overlap_s``). ``pipeline_depth=1`` never enters this module: the
strict loop is byte-for-byte today's behavior.

Exactly-once composition: KIND_FEED moves from feed time to
staging-commit time. A staged-but-not-delivered epoch is therefore
*fed* (its input is durable and will replay) but never *delivered*
(``mark_delivered`` still happens only after the real sink flush), so
recovery re-executes it exactly once — the crash-window contract is
unchanged, only the write moved earlier. Chaos sites
``engine.before_stage_commit`` / ``engine.after_stage_commit`` bracket
the commit for fault-injection tests.

Operator snapshots run on the executor under the stager's commit lock,
and first quiesce every active :class:`~.device_ring.DeviceRing` so a
slot whose copy is still in flight is never pickled.

Device wait is read two ways. Wall time minus the executor thread's CPU
time is the blocked remainder of each sweep; it is the reading on the
CPU. On a card a CUDA synchronisation may spin, and spinning counts as
CPU time, so there the sweep is bracketed by two CUDA events on the
executor's current stream and the device time between them is the
reading (``device_wait_s``); both are kept (``device_wait_cpu_s``,
``device_wait_events_s``). The events are read once they have completed,
so the reading adds no synchronisation to the epoch. The stager and the
ingest workers do host work only.
"""

from __future__ import annotations

import queue
import threading
import time as _wall
from dataclasses import dataclass, field
from typing import Any, Callable

from ..freshness.plane import FRESHNESS
from ..internals import flight_recorder

__all__ = ["PipelineStats", "StagedEpoch", "run_pipelined"]

_SENTINEL = object()


class PipelineStats:
    """Host-prep / device-wait / overlap attribution for one run.

    ``host_prep_s``: wall time the stager spent forming epochs (drain,
    upsert resolution, KIND_FEED write).
    ``device_wait_s``: the sweeps' device wait — on a card the device
    time between CUDA events around each sweep (``device_wait_events_s``),
    on the CPU the executor wall time not backed by executor CPU time
    (``device_wait_cpu_s``, kept on a card as well).
    ``overlap_s``: wall time during which the stager was preparing an
    epoch *while* the executor was executing another — the recovered
    portion.  ``overlap_ratio`` = overlap_s / host_prep_s (the fraction
    of host prep hidden behind device execution).
    """

    def __init__(self, depth: int = 1):
        self.depth = depth
        self.host_prep_s = 0.0
        self.device_wait_s = 0.0
        self.device_wait_cpu_s = 0.0
        self.device_wait_events_s = 0.0
        self.exec_s = 0.0
        self.overlap_s = 0.0
        self.staged_epochs = 0
        self.executed_epochs = 0
        self._lock = threading.Lock()
        self._active: dict[str, float] = {}  # "prep"/"exec" -> start

    @property
    def overlap_ratio(self) -> float:
        return self.overlap_s / self.host_prep_s if self.host_prep_s > 0 else 0.0

    def begin(self, kind: str) -> None:
        with self._lock:
            self._active[kind] = _wall.perf_counter()

    def end(self, kind: str) -> float:
        """Close a prep/exec window; returns its duration. Adds the
        exact intersection with the *other* side's currently-open
        window to ``overlap_s`` (each closing window claims only the
        intersection ending at its own close, so nothing double-counts)."""
        now = _wall.perf_counter()
        other = "exec" if kind == "prep" else "prep"
        with self._lock:
            start = self._active.pop(kind, now)
            dur = now - start
            if kind == "prep":
                self.host_prep_s += dur
            else:
                self.exec_s += dur
            o = self._active.get(other)
            if o is not None:
                self.overlap_s += max(0.0, now - max(start, o))
        if kind == "prep":
            # host-bound prep is the first stranded-chip-time cause the
            # attribution snapshot checks (no-op when accounting is off)
            from ..internals.chip_ledger import CHIP_LEDGER

            CHIP_LEDGER.note_stall("host_prep", dur)
        return dur

    def add_device_wait(self, seconds: float, events_s: float | None = None) -> None:
        """Book one sweep: ``seconds`` is wall minus thread CPU time,
        ``events_s`` the device time between the sweep's CUDA events (None
        off the card). ``device_wait_s`` takes the events' reading where
        there is one."""
        with self._lock:
            self.device_wait_cpu_s += max(0.0, seconds)
            if events_s is None:
                self.device_wait_s += max(0.0, seconds)
            else:
                self.device_wait_events_s += max(0.0, events_s)
                self.device_wait_s += max(0.0, events_s)

    def as_dict(self) -> dict:
        out = {
            "depth": self.depth,
            "host_prep_s": round(self.host_prep_s, 6),
            "device_wait_s": round(self.device_wait_s, 6),
            "device_wait_cpu_s": round(self.device_wait_cpu_s, 6),
            "device_wait_events_s": round(self.device_wait_events_s, 6),
            "exec_s": round(self.exec_s, 6),
            "overlap_s": round(self.overlap_s, 6),
            "overlap_ratio": round(self.overlap_ratio, 4),
            "staged_epochs": self.staged_epochs,
            "executed_epochs": self.executed_epochs,
        }
        # encoder-kernel MFU attribution rides the pipeline stats into
        # the chrome trace / monitoring snapshot when the run dispatched
        # the fused encoder (zero-cost otherwise)
        from ..internals.profiler import ENCODER_KERNEL_STATS

        if ENCODER_KERNEL_STATS.dispatches:
            enc = ENCODER_KERNEL_STATS.snapshot()
            out["encoder_achieved_tflops"] = round(enc["achieved_tflops"], 2)
            out["encoder_pad_fraction"] = round(enc["pad_fraction"], 4)
            out["encoder_dispatches"] = enc["dispatches"]
        # ditto for staging-ring backpressure: stall time here is the
        # "host can't keep pace" signal PATHWAY_WIRE_RING_DEPTH tunes
        from .device_ring import active_rings

        stall = sum(r.stage_stall_s for r in active_rings())
        if stall:
            out["ring_stage_stall_s"] = round(stall, 6)
        # collaborative host-ingest stage telemetry (zero-cost when no
        # stage was ever configured — active() stays False)
        from ..ingest.metrics import INGEST_METRICS

        if INGEST_METRICS.active():
            ing = INGEST_METRICS.snapshot()
            out["ingest_workers"] = ing["host_workers"]
            out["ingest_queue_depth"] = ing["queue_depth"]
            out["ingest_utilization"] = ing["utilization"]
            out["ingest_retried"] = ing["retried"]
        return out


@dataclass
class StagedEpoch:
    """One epoch formed ahead of execution. ``resolved`` holds each
    session's already-resolved update list (source state mutated at
    staging time; the executor only emits). ``offsets`` snapshots each
    source's reader offsets at drain time — the executor's ADVANCE must
    use these, not the source's live ``last_offsets``, which the stager
    may have moved past while this epoch waited in the queue."""

    time: int
    resolved: list[tuple[Any, list]] = field(default_factory=list)
    offsets: dict[int, dict] = field(default_factory=dict)  # id(source) -> offsets
    scripted: bool = False  # static/replay feeds fire at execute time
    fed: bool = False       # any persisted session batch was KIND_FEED-logged
    done: threading.Event = field(default_factory=threading.Event)


class _Stager(threading.Thread):
    """Forms epochs ahead of the executor. Owns epoch-time assignment
    and all source-state mutation (upsert resolution); the commit lock
    serializes that state against executor-side snapshot pickling."""

    def __init__(self, engine, depth: int, stats: PipelineStats):
        super().__init__(name="pathway-epoch-stager", daemon=True)
        self.engine = engine
        self.stats = stats
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, depth - 1))
        self.commit_lock = threading.Lock()
        self.error: BaseException | None = None
        self._halt = False

    def stop(self) -> None:
        self._halt = True
        self.engine.wake()

    def _put(self, item) -> bool:
        stalled = False
        while not (self._halt or self.engine._stop):
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                if not stalled and item is not _SENTINEL:
                    # depth budget exhausted: staging is running ahead of
                    # execution — the transition (not each retry) is ringed
                    stalled = True
                    flight_recorder.record(
                        "pipeline.stall", t=getattr(item, "time", None)
                    )
                continue
        return False

    def run(self) -> None:
        try:
            self._stage_loop()
        except BaseException as exc:  # surfaced by the executor
            self.error = exc
        finally:
            try:
                self.q.put_nowait(_SENTINEL)
            except queue.Full:
                # executor will re-check `error`/liveness on timeout
                pass
            self.engine.wake()

    def _stage_loop(self) -> None:
        from ..resilience import chaos as _chaos

        engine = self.engine
        last_time = -1
        while not (self._halt or engine._stop):
            engine._raise_connector_failure()
            times = [s.next_time() for s in engine.static_sources]
            replay_pending = False
            for s in engine.session_sources:
                rt = s.next_replay_time()
                if rt is not None:
                    times.append(rt)
                    replay_pending = True
            times = [t for t in times if t is not None]
            scripted_t = min(times) if times else None

            session_batches = []
            if not replay_pending:
                if last_time < engine.replay_frontier:
                    last_time = engine.replay_frontier
                for s in engine.session_sources:
                    b = s.session.drain()
                    if b:
                        session_batches.append((s, b))

            if scripted_t is None and not session_batches:
                if engine._speedrun:
                    break  # recorded stream exhausted
                if all(
                    s.session.closed
                    for s in engine.session_sources
                    if not s.is_error_log
                ):
                    break
                engine._wake.wait(timeout=0.05)
                engine._wake.clear()
                continue

            self.stats.begin("prep")
            t = scripted_t if scripted_t is not None else last_time + 1
            if session_batches and scripted_t is not None:
                t = max(scripted_t, last_time + 1)
            t = max(t, last_time + 1) if t <= last_time else t
            FRESHNESS.begin_epoch(int(t))

            ep = StagedEpoch(time=t, scripted=scripted_t is not None)
            with self.commit_lock:
                # Collaborative ingest: hand per-source upsert resolution
                # to the host worker pool (distinct sources touch
                # disjoint state). The stager stays the single committer
                # — results come back in source order and the KIND_FEED
                # log below is written serially, so durability and
                # output are byte-identical to the inline loop.
                from ..ingest import stage as _ingest

                ist = _ingest.get_stage()
                if ist is not None and session_batches:
                    resolved_all = list(
                        ist.map_ordered(
                            lambda sb: sb[0].resolve_batch(sb[1]), session_batches
                        )
                    )
                else:
                    resolved_all = [s.resolve_batch(b) for s, b in session_batches]
                for (s, b), resolved in zip(session_batches, resolved_all):
                    offsets = dict(s.last_offsets or {})
                    ep.resolved.append((s, resolved))
                    ep.offsets[id(s)] = offsets
                    if (
                        engine.persistence is not None
                        and s.persistent_id is not None
                        and resolved
                    ):
                        # staging-commit point: once KIND_FEED is
                        # durable the epoch replays from the log on a
                        # crash, so reader offsets may advance past it
                        # even though it was never executed
                        _chaos.inject("engine.before_stage_commit", time=int(t))
                        engine.persistence.log_batch(
                            s.persistent_id, t, resolved, offsets
                        )
                        _chaos.inject("engine.after_stage_commit", time=int(t))
                        ep.fed = True
            self.stats.staged_epochs += 1
            self.stats.end("prep")
            FRESHNESS.epoch_staged(int(t))
            if ist is not None:
                # host_prep/device_wait attribution feeds the stage's
                # autoscaler: host-bound epochs grow the worker pool
                ist.observe_attribution(
                    self.stats.host_prep_s, self.stats.device_wait_s
                )
            flight_recorder.record(
                "pipeline.staged", t=int(t), fed=ep.fed, scripted=ep.scripted
            )
            last_time = t
            if not self._put(ep):
                break
            if ep.scripted:
                # scripted feeds (static tables, recovery replay) are
                # consumed by the EXECUTOR (feed/feed_replay at execute
                # time): staging ahead would re-observe the same pending
                # time and burn phantom epoch numbers, so hand scripted
                # epochs off synchronously — they are startup-only paths
                while not ep.done.wait(timeout=0.05):
                    if self._halt or self.engine._stop:
                        return


def _execute_epoch(engine, ep: StagedEpoch, stats: PipelineStats, clock: "_SweepClock") -> None:
    """The strict tail of the epoch loop: emit → sweep → deliver →
    advance → snapshot. Runs on the caller (executor) thread."""
    t = ep.time
    engine.current_time = t
    engine._frontier_hooks(t)
    if ep.scripted:
        for s in engine.static_sources:
            s.feed(t)
        for s in engine.session_sources:
            s.feed_replay(t)
    for s, resolved in ep.resolved:
        s.emit(resolved, t)

    stats.begin("exec")
    FRESHNESS.epoch_exec(int(t))
    clock.start()
    cpu0 = _wall.thread_time()
    w0 = _wall.perf_counter()
    # the profiler folds the epoch after it advanced (as the strict loop)
    engine._topo_pass(t, end_epoch=False)
    wall = _wall.perf_counter() - w0
    cpu = _wall.thread_time() - cpu0
    clock.stop(wall - cpu)
    FRESHNESS.epoch_committed(int(t))
    stats.end("exec")
    if engine.epoch_observers:
        # query-dispatch slot: epoch N just finished on the device —
        # the serving batcher observes its wall time (EWMA sizing) and
        # may flush a fused query batch before epoch N+1 executes
        engine._notify_epoch_observers(int(t), wall)

    if engine.persistence is not None:
        if ep.resolved:
            from ..resilience import chaos as _chaos

            _chaos.inject("engine.after_sink_flush", time=int(t))
            engine.persistence.mark_delivered(int(t))
        for s, _resolved in ep.resolved:
            if s.persistent_id is not None:
                engine.persistence.advance(s.persistent_id, t, ep.offsets.get(id(s)) or {})
    stats.executed_epochs += 1
    flight_recorder.record("pipeline.executed", t=int(t))
    prof = engine.profiler
    if prof is not None:
        prof.end_epoch(engine.worker_id, engine, t)
        prof.observe_pipeline(stats)


class _SweepClock:
    """Books each sweep's device wait into ``stats``. On a card (torch's
    CUDA context already up) it records a CUDA event pair on the executor's
    current stream around the sweep and books the pair once its end event
    has completed, polled at the next sweep and drained at the end of the
    run; off the card it books wall minus thread CPU time at once."""

    def __init__(self, stats: PipelineStats):
        import sys

        self.stats = stats
        self._torch = None
        self._pending: list = []  # (start event, end event, wall - cpu)
        self._start = None
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
            self._torch = torch

    def start(self) -> None:
        if self._torch is not None:
            self._start = self._torch.cuda.Event(enable_timing=True)
            self._start.record()

    def stop(self, cpu_wait_s: float) -> None:
        if self._torch is None:
            self.stats.add_device_wait(cpu_wait_s)
            return
        end = self._torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending.append((self._start, end, cpu_wait_s))
        self._book(block=False)

    def _book(self, block: bool) -> None:
        while self._pending:
            start, end, cpu_wait_s = self._pending[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._pending.pop(0)
            self.stats.add_device_wait(cpu_wait_s, start.elapsed_time(end) / 1000.0)

    def drain(self) -> None:
        if self._torch is not None:
            self._book(block=True)


def run_pipelined(engine, monitoring_callback: Callable | None = None) -> None:
    """``EngineGraph.run`` with a staging thread forming epoch N+1
    while epoch N executes (``pipeline_depth >= 2``). Output order is
    identical to the strict loop: epochs execute strictly in staged
    order on one thread; only their *formation* overlaps execution."""
    if engine.persistence_config is not None:
        engine._setup_persistence()
    if not engine._speedrun:
        for th in engine.connector_threads:
            th.start()
        engine._threads_started = True

    stats = PipelineStats(depth=engine.pipeline_depth)
    engine.pipeline_stats = stats
    clock = _SweepClock(stats)
    stager = _Stager(engine, engine.pipeline_depth, stats)
    engine._stage_commit_lock = stager.commit_lock
    stager.start()
    last_time = -1
    try:
        while not engine._stop:
            engine._raise_connector_failure()
            if stager.error is not None:
                raise stager.error
            try:
                item = stager.q.get(timeout=0.05)
            except queue.Empty:
                if not stager.is_alive() and stager.q.empty():
                    break
                continue
            if item is _SENTINEL:
                break
            try:
                _execute_epoch(engine, item, stats, clock)
            finally:
                item.done.set()
            last_time = item.time
            if item.fed or item.resolved:
                if engine.persistence is not None:
                    # snapshot under the commit lock: the stager mutates
                    # source upsert state while forming the NEXT epoch,
                    # and pickling must not race that (the snapshot itself
                    # quiesces the staging rings first)
                    with stager.commit_lock:
                        engine._maybe_snapshot_operators(last_time)
            if monitoring_callback is not None:
                monitoring_callback(engine)
        if stager.error is not None:
            raise stager.error
    finally:
        stager.stop()
        stager.join(timeout=5.0)
        engine._stage_commit_lock = None
        clock.drain()

    if not engine._stop:
        engine._raise_connector_failure()

    # ---- end-of-input tail: identical to the strict loop ----
    if engine._final_snapshot_due(last_time):
        engine._snapshot_operators(last_time)
    engine._finish_run(last_time)
