"""Multi-worker sharded execution: N engine shards over key partitions.

The port's copy of the reference's in-process worker parallelism
(timely workers in upstream Pathway, src/engine/dataflow/shard.rs: every
worker runs the same dataflow on ``hash(key) & SHARD_MASK % n``
partitions, exchanging rows at re-keying operators over channels). Here
the N shards are N copies of the engine DAG in one process, driven in
bulk-synchronous sweeps per epoch:

    feed epoch t on shard 0 → all shards run a local topo sweep in
    parallel threads → cross-shard updates (collected at emit time
    through each consumer's ``route_owner``) are delivered into the
    target shard's queues → repeat until every shard is quiescent and no
    mail remains → frontier advances.

Exchange boundaries are the operators' own keying rules (group key,
join key, row key, instance) — see ``Node.route_owner`` overrides.
Sources read on shard 0; sinks and captures consolidate on shard 0 so
delivery stays single-streamed and time-ordered. Shards that run device
work (an embedder UDF, the KNN index) share one card and one model from
their threads. Persistence (input logs on shard 0's sources, one
operator snapshot over every shard's state) and the overlapped epoch
pipeline run here as in the reference's cluster. Each epoch records
``epoch.begin`` and ``epoch.advance`` in the flight recorder, as the
reference's cluster does.

A :class:`ShardCluster` owns a contiguous slice of the global shard space:
all of it in a single-process run, this process's shards in a
multi-process one (``parallel/multiprocess.py``). Its mailboxes span the
whole world: mail for a local shard is delivered in-process, mail for a
remote shard waits for the transport (:meth:`ShardCluster.drain_remote_mail`).
The hooks at the end of the class are what the multi-process coordinator
overrides; in-process they do nothing.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from ..engine import dataflow as df
from ..internals import flight_recorder


def recover_sources(persistence, sources, cfg, auto_prefix: str = "auto", delivered_frontier: int = -1,
                    speedrun: bool = False) -> int:
    """The source-recovery pass: assign auto ids, reset offset-unaware
    logs, restore offsets and replay batches; returns the largest
    recovered frontier. ``delivered_frontier`` is the durable delivered
    marker: epochs fed (and delivered) but never ADVANCEd finalize instead
    of re-delivering (``EnginePersistence.recover_source``)."""
    mode = str(getattr(cfg, "persistence_mode", "batch") or "batch").lower()
    record_mode = "record" in mode
    if getattr(cfg, "auto_persistent_ids", False) or record_mode or speedrun:
        for i, s in enumerate(sources):
            if s.persistent_id is not None or s.is_error_log:
                continue
            # speedrun never starts readers, so offset-unaware sources are
            # safe to replay; otherwise only offset-aware (or freshly reset
            # record-mode) sources get ids
            if speedrun or record_mode or s.supports_offsets:
                s.persistent_id = f"{auto_prefix}_{i}"
    frontier = -1
    for s in sources:
        if s.persistent_id is None:
            continue
        if not s.supports_offsets and not speedrun:
            # offset-unaware reader: run() re-produces all input, so
            # replaying a stale log on top would double it — reset
            persistence.reset_source(s.persistent_id)
            continue
        batches, offsets, f = persistence.recover_source(s.persistent_id, delivered_frontier=delivered_frontier)
        s.replay_batches = list(batches)
        s.session.restore_offsets(offsets)
        frontier = max(frontier, f)
    return frontier


class ShardCluster:
    """Owns a contiguous slice of the global shard space: all of it in a
    single-process run (``base=0``, ``world=n``), or this process's T shards
    of a P x T world (``base=pid*T``, ``world=P*T``; upstream Pathway's
    ``CommunicationConfig::Cluster``, config.rs:62-86)."""

    # the overlapped epoch pipeline runs in-process only: the multi-process
    # coordinator's epoch frontier is a cluster-wide broadcast
    pipelined = True

    def __init__(self, engines: list[df.EngineGraph], base: int = 0, world: int | None = None):
        assert len(engines) >= 1
        self.engines = engines
        self.n = len(engines)
        self.base = base
        self.world = world if world is not None else len(engines)
        assert self.base + self.n <= self.world
        for i, e in enumerate(engines):
            e.worker_id = base + i
            e.n_workers = self.world
            e.cluster = self
        # mail[global shard] = list of (node_id, port, update)
        self._mail: list[list] = [[] for _ in range(self.world)]
        self._mail_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=self.n) if self.n > 1 else None
        self._stop = False
        self._persistence = None
        self._speedrun = False
        self._opsnap_ok = False
        self._opsnap_time = -1
        self._last_opsnap_wall = 0.0

    def _is_local(self, shard: int) -> bool:
        return self.base <= shard < self.base + self.n

    # -- routing (called from Node.emit during topo sweeps) --

    def route(self, from_graph: df.EngineGraph, consumer: df.Node, port: int, updates):
        local = []
        mail = None
        me = from_graph.worker_id
        for u in updates:
            owner = consumer.route_owner(u[0], u[1], port, self.world)
            if owner is None or owner == me:
                local.append(u)
            elif owner == df.BROADCAST:
                local.append(u)
                if mail is None:
                    mail = []
                for j in range(self.world):
                    if j != me:
                        mail.append((j, consumer.id, port, u))
            else:
                if mail is None:
                    mail = []
                mail.append((owner, consumer.id, port, u))
        if mail:
            with self._mail_lock:
                for j, nid, p, u in mail:
                    self._mail[j].append((nid, p, u))
        return local

    def _deliver_mail(self) -> bool:
        """Move local shards' mailbox contents into their queues; True if
        any. Boxes of remote shards stay for the transport."""
        boxes = {}
        with self._mail_lock:
            for shard in range(self.base, self.base + self.n):
                if self._mail[shard]:
                    boxes[shard] = self._mail[shard]
                    self._mail[shard] = []
        return self.post_mail(boxes)

    def drain_remote_mail(self) -> dict[int, list]:
        """Pop the mail addressed to shards outside this process:
        ``{global shard: [(node_id, port, update), ...]}``."""
        out = {}
        with self._mail_lock:
            for shard in range(self.world):
                if not self._is_local(shard) and self._mail[shard]:
                    out[shard] = self._mail[shard]
                    self._mail[shard] = []
        return out

    def post_mail(self, boxes: dict[int, list]) -> bool:
        """Deliver mail (local or received by the transport) into the local
        shards' queues; True if any."""
        delivered = False
        for shard, box in boxes.items():
            assert self._is_local(shard), (shard, self.base, self.n)
            engine = self.engines[shard - self.base]
            for nid, port, u in box:
                engine.nodes[nid].queues[port].append(u)
                engine._dirty.add(nid)
                delivered = True
        return delivered

    # -- epoch machinery --

    def _sync_watermarks(self, mark_dirty: bool = False) -> bool:
        """Time-based operators (buffer/forget/freeze) advance their
        watermark from the rows THEY see — per-shard after key routing.
        Releases must use the GLOBAL maximum (the reference's shared
        frontier), so the per-node maxima are exchanged and written back
        to every shard — including BETWEEN sweeps, since these operators
        release during process() in the same epoch the watermark moves.
        ``mark_dirty`` queues a lagging shard's node for another pass so
        it releases immediately. Returns True when any watermark moved
        (monotone, so the sweep loop terminates)."""
        changed = False
        n_nodes = len(self.engines[0].nodes)
        for nid in range(n_nodes):
            nodes = [e.nodes[nid] for e in self.engines]
            if not hasattr(nodes[0], "watermark"):
                continue
            wms = [n.watermark for n in nodes if n.watermark is not None]
            if not wms:
                continue
            global_wm = max(wms)
            for e, n in zip(self.engines, nodes):
                if n.watermark is None or n.watermark < global_wm:
                    n.watermark = global_wm
                    changed = True
                    if mark_dirty:
                        e._dirty.add(nid)
        return changed

    def watermark_map(self) -> dict[int, object]:
        """Per-node maximum watermark over this process's shards (the
        cross-process frontier exchange)."""
        out: dict[int, object] = {}
        for nid in range(len(self.engines[0].nodes)):
            if not hasattr(self.engines[0].nodes[nid], "watermark"):
                continue
            wms = [e.nodes[nid].watermark for e in self.engines if e.nodes[nid].watermark is not None]
            if wms:
                out[nid] = max(wms)
        return out

    def apply_watermarks(self, wm: dict[int, object]) -> bool:
        """Raise local watermarks to the global maxima, marking the nodes
        dirty so they release in the same epoch; True when any moved."""
        changed = False
        for nid, global_wm in wm.items():
            for e in self.engines:
                n = e.nodes[nid]
                if n.watermark is None or n.watermark < global_wm:
                    n.watermark = global_wm
                    e._dirty.add(nid)
                    changed = True
        return changed

    def _sweep(self, time) -> None:
        """One bulk-synchronous epoch sweep (in one process the world is
        local, so the local fixpoint is the global one), then the time-end
        hooks and the delivered marker."""
        for e in self.engines:
            if e.profiler is not None:
                e.profiler.begin_epoch(e.worker_id)
        self._sweep_local(time)
        self._time_end_all(time)
        if self._persistence is not None:
            # sinks flushed above, offset cursors advance after: a crash in
            # between must finalize the epoch on recovery
            self._persistence.mark_delivered(int(time))
        for e in self.engines:
            if e.profiler is not None:
                e.profiler.end_epoch(e.worker_id, e, time)

    def _sweep_local(self, time) -> None:
        """The local fixpoint: every dirty local shard runs its topological
        pass (in parallel threads), local mail is exchanged; repeat until
        this process's shards are quiescent (remote mail may remain)."""

        def run_one(e):
            prof = e.profiler
            while e._dirty:
                for node in e.nodes:
                    if node.id in e._dirty:
                        e._dirty.discard(node.id)
                        if prof is not None:
                            t0 = prof.now_ns()
                            node.process(time)
                            prof.record_process(e.worker_id, node, t0, prof.now_ns() - t0)
                        else:
                            node.process(time)

        while True:
            dirty_engines = [e for e in self.engines if e._dirty]
            if not dirty_engines:
                moved = self._deliver_mail()
                moved |= self._sync_watermarks(mark_dirty=True)
                if not moved:
                    break
                continue
            if self._pool is not None and len(dirty_engines) > 1:
                list(self._pool.map(run_one, dirty_engines))
            else:
                for e in dirty_engines:
                    run_one(e)
            self._deliver_mail()
            self._sync_watermarks(mark_dirty=True)

    def _time_end_all(self, time) -> None:
        for e in self.engines:
            prof = e.profiler
            for node in e.nodes:
                te = getattr(node, "time_end", None)
                if te is not None:
                    if prof is not None:
                        t0 = prof.now_ns()
                        te(time)
                        prof.record_process(e.worker_id, node, t0, prof.now_ns() - t0)
                    else:
                        te(time)

    # -- persistence: input logs on shard 0's sources, one operator
    #    snapshot over the state of every shard --

    def _setup_persistence(self) -> None:
        import pickle

        from ..engine.persistence import EnginePersistence

        primary = self.engines[0]
        cfg = primary.persistence_config
        mode = str(getattr(cfg, "persistence_mode", "batch") or "batch").lower()
        if "speedrun" in mode:
            if not self._speedrun_supported():
                raise NotImplementedError(
                    "speedrun replay runs in one process (any PATHWAY_THREADS); a multi-process replay would "
                    "need every worker's log"
                )
            # speedrun across all shards: readers never start, the recorded
            # stream replays through the normal epoch loop sharded like a
            # live run, and sinks re-deliver every epoch. The log is
            # read-only here: no batch logging, no snapshots.
            self._speedrun = True
            p = EnginePersistence(cfg)
            recover_sources(p, primary.session_sources, cfg, speedrun=True)
            # a snapshot-compacted log has no full stream to replay
            p.check_compaction_covered(
                [s.persistent_id for s in primary.session_sources if s.persistent_id is not None], None
            )
            p.close()
            for e in self.engines:
                e.replay_frontier = -1
            return
        p = EnginePersistence(cfg)
        self._persistence = p
        frontier = recover_sources(p, primary.session_sources, cfg, delivered_frontier=p.delivered_frontier())
        # worker processes may have logged epochs past process 0's own
        # frontier: snapshot recovery must see the global maximum, or it
        # rejects the snapshots taken at trailing worker-only epochs
        frontier = max(frontier, self._remote_replay_frontier())
        for e in self.engines:
            e.replay_frontier = frontier
        all_persistent = all(s.persistent_id is not None for s in primary.session_sources if not s.is_error_log)
        if frontier >= 0 and not all_persistent:
            import warnings

            warnings.warn(
                "only a subset of sources has a persistent_id: non-persistent sources re-feed at fresh epochs "
                "after a restart, so rows derived from them may be delivered to sinks again — exactly-once "
                "only holds when every source is persisted",
                stacklevel=2,
            )
        self._opsnap_ok = all_persistent
        restored_t = None
        if frontier >= 0 and all_persistent:
            rec = p.recover_operator_snapshot(frontier)
            if rec is not None:
                t0, blob = rec
                data = pickle.loads(blob)
                if data.get("sig") == self._cluster_signature():
                    self._restore_states(data["states"], t0)
                    for s in primary.session_sources:
                        s.replay_batches = [(tt, ups) for tt, ups in s.replay_batches if tt > t0]
                    for st_src in primary.static_sources:
                        while st_src.pos < len(st_src.batches) and st_src.batches[st_src.pos][0] <= t0:
                            st_src.pos += 1
                    self._opsnap_time = t0
                    restored_t = t0
        # trimmed logs are only recoverable through a compatible snapshot
        p.check_compaction_covered(
            [s.persistent_id for s in primary.session_sources if s.persistent_id is not None], restored_t
        )

    def _cluster_signature(self):
        return [(shard, n.id, n.snapshot_signature()) for shard, e in enumerate(self.engines) for n in e.nodes]

    def _restore_states(self, states: dict, time: int = -1) -> None:
        for (shard, nid), st in states.items():
            self.engines[shard].nodes[nid].restore_state(st)

    def _maybe_snapshot_operators(self, t: int) -> None:
        """Interval snapshots (``snapshot_interval_ms``), as the single
        engine's ``_maybe_snapshot_operators``."""
        import time as _wall

        if not self._opsnap_ok:
            return
        interval_ms = getattr(self.engines[0].persistence_config, "snapshot_interval_ms", 0) or 0
        if interval_ms <= 0:
            return
        if (_wall.monotonic() - self._last_opsnap_wall) * 1000.0 >= interval_ms:
            self._snapshot_operators(t)

    def _snapshot_operators(self, t: int) -> None:
        import time as _wall

        from ..engine import device_ring

        # no staging-ring slot whose copy is still in flight is pickled
        device_ring.quiesce_all()
        states = {}
        for shard, e in enumerate(self.engines):
            for n in e.nodes:
                st = n.snapshot_state()
                if st is not None:
                    states[(shard, n.id)] = st
        blob = df.dumps_host({"sig": self._cluster_signature(), "time": int(t), "states": states})
        self._persistence.save_operator_snapshot(int(t), blob)
        self._compact_inputs(int(t))
        self._last_opsnap_wall = _wall.monotonic()
        if self.world > 1:
            # a multi-worker snapshot is the barrier all shards agree on
            from ..resilience.cluster import CLUSTER_METRICS

            flight_recorder.record("cluster.barrier", t=int(t), generation=0, world=self.world)
            CLUSTER_METRICS.record_barrier()

    def _compact_inputs(self, t: int) -> None:
        cfg = self.engines[0].persistence_config
        if getattr(cfg, "compact_inputs_on_snapshot", False):
            self._persistence.compact_inputs(
                [s.persistent_id for s in self.engines[0].session_sources
                 if s.persistent_id is not None and not s.is_error_log],
                t,
            )

    # -- the epoch loops --

    def _next_epoch(self, last_time: int):
        """Form the next epoch's inputs on shard 0: ``(scripted time or
        None, session batches, last_time)``; None when every source has
        closed (or a speedrun's recorded stream is exhausted). An epoch with
        no input of this process runs when a worker process holds input of
        its partitioned sources; otherwise the caller waits."""
        primary = self.engines[0]
        times = [s.next_time() for s in primary.static_sources]
        replay_pending = False
        for s in primary.session_sources:
            rt = s.next_replay_time()
            if rt is not None:
                times.append(rt)
                replay_pending = True
        times = [t for t in times if t is not None]
        scripted_t = min(times) if times else None
        session_batches = []
        if not replay_pending:
            # live epochs land strictly past the recovered frontier
            last_time = max(last_time, primary.replay_frontier)
            for s in primary.session_sources:
                b = s.session.drain()
                if b:
                    session_batches.append((s, b))
        # row errors reported on replica shards land in THEIR error
        # sessions; drain them all (delivery routes to shard 0)
        for e in self.engines[1:]:
            for s in e.session_sources:
                if s.is_error_log:
                    b = s.session.drain()
                    if b:
                        session_batches.append((s, b))
        if scripted_t is None and not session_batches:
            if self._speedrun:
                return None
            if self._remote_input_pending():
                return (None, [], last_time, True)
            if all(s.session.closed for s in primary.session_sources if not s.is_error_log) \
                    and self._remote_sources_closed():
                return None
            return (None, [], last_time, False)
        return (scripted_t, session_batches, last_time, True)

    @staticmethod
    def _epoch_time(scripted_t, session_batches, last_time) -> int:
        t = scripted_t if scripted_t is not None else last_time + 1
        if session_batches and scripted_t is not None:
            t = max(scripted_t, last_time + 1)
        return max(t, last_time + 1) if t <= last_time else t

    def _log_feed(self, s, t, resolved, offsets) -> bool:
        """The staging-commit point: KIND_FEED for a persisted source's
        resolved batch, between the chaos sites that bracket it."""
        if self._persistence is None or s.persistent_id is None or not resolved:
            return False
        from ..resilience import chaos as _chaos

        _chaos.inject("engine.before_stage_commit", time=int(t))
        self._persistence.log_batch(s.persistent_id, t, resolved, offsets)
        _chaos.inject("engine.after_stage_commit", time=int(t))
        return True

    def _begin_epoch(self, t) -> None:
        self._sync_watermarks()
        for e in self.engines:
            e.current_time = t
            e._frontier_hooks(t)
        self.set_epoch_frontier(t)

    def _epoch_fields(self, t) -> dict:
        kw = {"t": int(t), "world": self.world}
        generation = int(getattr(self, "generation", 0) or 0)
        if generation:
            kw["generation"] = generation
        return kw

    def _start(self) -> None:
        primary = self.engines[0]
        if primary.persistence_config is not None:
            self._setup_persistence()
        if not self._speedrun:
            for t in primary.connector_threads:
                t.start()
            primary._threads_started = True

    def run(self, monitoring_callback: Callable | None = None) -> None:
        primary = self.engines[0]
        try:
            self._start()
            if primary.pipeline_depth > 1 and self.pipelined:
                last_time = self._run_pipelined(monitoring_callback)
            else:
                last_time = self._run_strict(monitoring_callback)
            self._finish(last_time)
        finally:
            primary.stopped.set()
            if self._pool is not None:
                self._pool.shutdown(wait=False)

    def _run_strict(self, monitoring_callback: Callable | None) -> int:
        primary = self.engines[0]
        last_time = -1
        while not (self._stop or primary._stop):
            primary._raise_connector_failure()
            nxt = self._next_epoch(last_time)
            if nxt is None:
                break
            scripted_t, session_batches, last_time, ready = nxt
            if not ready:
                primary._wake.wait(timeout=0.05)
                primary._wake.clear()
                continue
            t = self._epoch_time(scripted_t, session_batches, last_time)
            _epoch_kw = self._epoch_fields(t)
            flight_recorder.record("epoch.begin", batches=len(session_batches), **_epoch_kw)
            self._begin_epoch(t)
            for s in primary.static_sources:
                s.feed(t)
            for s in primary.session_sources:
                s.feed_replay(t)
            for s, b in session_batches:
                # depth 1: the staging-commit point is feed time
                self._log_feed(s, t, s.feed_batch(b, t), s.last_offsets or {})
            self._deliver_mail()
            self._sweep(t)
            if self._persistence is not None:
                for s, _b in session_batches:
                    if s.persistent_id is not None:
                        self._persistence.advance(s.persistent_id, t, s.last_offsets or {})
                if session_batches:
                    self._maybe_snapshot_operators(t)
            last_time = t
            flight_recorder.record("epoch.advance", **_epoch_kw)
            if monitoring_callback is not None:
                monitoring_callback(primary)
        return last_time

    def _run_pipelined(self, monitoring_callback: Callable | None) -> int:
        """The sharded loop with staged epoch formation (``pipeline_depth
        >= 2``): a stager thread drains shard 0's sessions, resolves their
        wire protocols and commits KIND_FEED for epoch N+1 while the sweep
        of epoch N runs. Sweeps execute strictly in staged order, so the
        output is the strict loop's."""
        import queue as _queue
        import time as _wall

        from ..engine.pipeline import PipelineStats, StagedEpoch, _SweepClock

        primary = self.engines[0]
        stats = PipelineStats(depth=primary.pipeline_depth)
        for e in self.engines:
            e.pipeline_stats = stats
        clock = _SweepClock(stats)
        commit_lock = threading.Lock()
        q: "_queue.Queue" = _queue.Queue(maxsize=max(1, primary.pipeline_depth - 1))
        sentinel = object()
        stage_error: list[BaseException] = []
        stop_staging = threading.Event()

        def halted() -> bool:
            return stop_staging.is_set() or self._stop or primary._stop

        def stage_loop() -> None:
            last_time = -1
            try:
                while not halted():
                    primary._raise_connector_failure()
                    nxt = self._next_epoch(last_time)
                    if nxt is None:
                        break
                    scripted_t, session_batches, last_time, ready = nxt
                    if not ready:
                        primary._wake.wait(timeout=0.05)
                        primary._wake.clear()
                        continue
                    stats.begin("prep")
                    t = self._epoch_time(scripted_t, session_batches, last_time)
                    ep = StagedEpoch(time=t, scripted=scripted_t is not None)
                    with commit_lock:
                        for s, b in session_batches:
                            resolved = s.resolve_batch(b)
                            offsets = dict(s.last_offsets or {})
                            ep.resolved.append((s, resolved))
                            ep.offsets[id(s)] = offsets
                            ep.fed |= self._log_feed(s, t, resolved, offsets)
                    stats.staged_epochs += 1
                    stats.end("prep")
                    flight_recorder.record("pipeline.staged", t=int(t), fed=ep.fed, scripted=ep.scripted)
                    last_time = t
                    placed = False
                    while not halted():
                        try:
                            q.put(ep, timeout=0.05)
                            placed = True
                            break
                        except _queue.Full:
                            continue
                    if placed and ep.scripted:
                        # scripted feeds (static tables, recovery replay) are
                        # consumed at execute time: staging ahead would
                        # re-observe the same pending time, so hand them off
                        # synchronously
                        while not ep.done.wait(timeout=0.05):
                            if halted():
                                return
            except BaseException as exc:
                stage_error.append(exc)
            finally:
                try:
                    q.put_nowait(sentinel)
                except _queue.Full:
                    pass
                primary.wake()

        stager = threading.Thread(target=stage_loop, name="pathway-shard-stager", daemon=True)
        stager.start()
        last_time = -1
        try:
            while not (self._stop or primary._stop):
                primary._raise_connector_failure()
                if stage_error:
                    raise stage_error[0]
                try:
                    item = q.get(timeout=0.05)
                except _queue.Empty:
                    if not stager.is_alive() and q.empty():
                        break
                    continue
                if item is sentinel:
                    break
                t = item.time
                self._begin_epoch(t)
                if item.scripted:
                    for s in primary.static_sources:
                        s.feed(t)
                    for s in primary.session_sources:
                        s.feed_replay(t)
                for s, resolved in item.resolved:
                    s.emit(resolved, t)
                self._deliver_mail()
                stats.begin("exec")
                clock.start()
                cpu0 = _wall.thread_time()
                w0 = _wall.perf_counter()
                self._sweep(t)
                clock.stop((_wall.perf_counter() - w0) - (_wall.thread_time() - cpu0))
                stats.end("exec")
                if self._persistence is not None:
                    for s, _resolved in item.resolved:
                        if s.persistent_id is not None:
                            self._persistence.advance(s.persistent_id, t, item.offsets.get(id(s)) or {})
                    if item.resolved:
                        with commit_lock:
                            self._maybe_snapshot_operators(t)
                stats.executed_epochs += 1
                item.done.set()
                flight_recorder.record("pipeline.executed", t=int(t))
                if primary.profiler is not None:
                    primary.profiler.observe_pipeline(stats)
                last_time = t
                if monitoring_callback is not None:
                    monitoring_callback(primary)
            if stage_error:
                raise stage_error[0]
        finally:
            stop_staging.set()
            primary.wake()
            stager.join(timeout=5.0)
            clock.drain()
        return last_time

    def _finish(self, last_time: int) -> None:
        """The end-of-input tail of both loops."""
        primary = self.engines[0]
        if not (self._stop or primary._stop):
            primary._raise_connector_failure()
        # final snapshot BEFORE the end-of-input flush (the flush assumes
        # input is over, which a restarted run cannot know)
        if (
            self._persistence is not None
            and self._opsnap_ok
            and last_time >= 0
            and last_time != self._opsnap_time
            and primary.session_sources
        ):
            self._snapshot_operators(last_time)
        # end of input: final flush on every shard
        self._sync_watermarks()
        for e in self.engines:
            e.current_time = last_time + 1
            e._frontier_hooks(df.INF_TIME)
        self.set_epoch_frontier(df.INF_TIME)
        self._deliver_mail()
        # only run (and fire time_end for) the flush epoch if it has work
        if self._flush_needed():
            self._sweep(last_time + 1)
        # trailing error deliveries
        err = []
        for e in self.engines:
            for s in e.session_sources:
                if s.is_error_log:
                    b = s.session.drain()
                    if b:
                        err.append((s, b))
        if err:
            for s, b in err:
                s.feed_batch(b, last_time + 2)
            self._deliver_mail()
            self._sweep(last_time + 2)
        for e in self.engines:
            for node in e.nodes:
                node.on_end()
        self._finish_remote()
        if self._persistence is not None:
            self._persistence.close()
        primary.stopped.set()
        if primary._threads_started:
            for t in primary.connector_threads:
                t.join(timeout=5.0)

    # -- hooks the multi-process coordinator overrides --

    def set_epoch_frontier(self, frontier) -> None:
        pass

    def _flush_needed(self) -> bool:
        return any(e._dirty for e in self.engines)

    def _finish_remote(self) -> None:
        pass

    def _speedrun_supported(self) -> bool:
        """An in-process cluster replays a recorded stream over any number
        of shards; worker processes' logs are not visible to process 0."""
        return True

    def _remote_input_pending(self) -> bool:
        return False

    def _remote_replay_frontier(self) -> int:
        return -1

    def _remote_sources_closed(self) -> bool:
        return True

    def stop(self) -> None:
        self._stop = True
        self.engines[0].wake()
