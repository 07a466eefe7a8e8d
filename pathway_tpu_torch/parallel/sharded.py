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
their threads. Persistence, the overlapped epoch pipeline and
multi-process clusters are not part of this package. Each epoch records
``epoch.begin`` and ``epoch.advance`` in the flight recorder, as the
reference's cluster does.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from ..engine import dataflow as df
from ..internals import flight_recorder


class ShardCluster:
    """Owns every shard of a single-process run."""

    def __init__(self, engines: list[df.EngineGraph]):
        assert len(engines) >= 1
        self.engines = engines
        self.n = self.world = len(engines)
        for i, e in enumerate(engines):
            e.worker_id = i
            e.n_workers = self.world
            e.cluster = self
        # mail[shard] = list of (node_id, port, update)
        self._mail: list[list] = [[] for _ in range(self.world)]
        self._mail_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=self.n) if self.n > 1 else None
        self._stop = False

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
        """Move local-shard mailbox contents into target shard queues;
        True if any. Remote-shard boxes stay for the transport."""
        boxes = {}
        with self._mail_lock:
            for shard in range(self.base, self.base + self.n):
                if self._mail[shard]:
                    boxes[shard] = self._mail[shard]
                    self._mail[shard] = []
        delivered = False
        for shard, box in boxes.items():
            delivered = True
            engine = self.engines[shard - self.base]
            for nid, port, u in box:
                engine.nodes[nid].queues[port].append(u)
                engine._dirty.add(nid)
        return delivered

    def _deliver_mail(self) -> bool:
        """Move mailbox contents into the target shards' queues; True if any."""
        boxes = {}
        with self._mail_lock:
            for shard in range(self.world):
                if self._mail[shard]:
                    boxes[shard] = self._mail[shard]
                    self._mail[shard] = []
        for shard, box in boxes.items():
            engine = self.engines[shard]
            for nid, port, u in box:
                engine.nodes[nid].queues[port].append(u)
                engine._dirty.add(nid)
        return bool(boxes)

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

    def _sweep(self, time) -> None:
        """One bulk-synchronous epoch sweep: every dirty shard runs its
        topological pass (in parallel), mail is exchanged; repeat until
        all shards are quiescent, then fire the time-end hooks."""

        for e in self.engines:
            if e.profiler is not None:
                e.profiler.begin_epoch(e.worker_id)

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
        for e in self.engines:
            if e.profiler is not None:
                e.profiler.end_epoch(e.worker_id, e, time)

    def run(self, monitoring_callback: Callable | None = None) -> None:
        primary = self.engines[0]
        for t in primary.connector_threads:
            t.start()
        primary._threads_started = True
        last_time = -1
        try:
            while not (self._stop or primary._stop):
                primary._raise_connector_failure()
                times = [s.next_time() for s in primary.static_sources]
                times = [t for t in times if t is not None]
                scripted_t = min(times) if times else None

                session_batches = []
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
                    if all(s.session.closed for s in primary.session_sources if not s.is_error_log):
                        break
                    primary._wake.wait(timeout=0.05)
                    primary._wake.clear()
                    continue

                t = scripted_t if scripted_t is not None else last_time + 1
                if session_batches and scripted_t is not None:
                    t = max(scripted_t, last_time + 1)
                t = max(t, last_time + 1) if t <= last_time else t
                _epoch_kw = {"t": int(t), "world": self.world}
                flight_recorder.record("epoch.begin", batches=len(session_batches), **_epoch_kw)
                self._sync_watermarks()
                for e in self.engines:
                    e.current_time = t
                    e._frontier_hooks(t)
                for s in primary.static_sources:
                    s.feed(t)
                for s, b in session_batches:
                    s.feed_batch(b, t)
                self._deliver_mail()
                self._sweep(t)
                last_time = t
                flight_recorder.record("epoch.advance", **_epoch_kw)
                if monitoring_callback is not None:
                    monitoring_callback(primary)

            if not (self._stop or primary._stop):
                primary._raise_connector_failure()
            # end of input: final flush on every shard
            self._sync_watermarks()
            for e in self.engines:
                e.current_time = last_time + 1
                e._frontier_hooks(df.INF_TIME)
            self._deliver_mail()
            # only run (and fire time_end for) the flush epoch if it has work
            if any(e._dirty for e in self.engines):
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
            primary.stopped.set()
            for t in primary.connector_threads:
                t.join(timeout=5.0)
        finally:
            primary.stopped.set()
            if self._pool is not None:
                self._pool.shutdown(wait=False)

    def stop(self) -> None:
        self._stop = True
        self.engines[0].wake()
