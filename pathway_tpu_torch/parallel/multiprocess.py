"""Multi-process dataflow execution (PATHWAY_PROCESSES > 1).

The port's copy of the reference's process cluster (upstream Pathway's
``CommunicationConfig::Cluster``, src/engine/dataflow/config.rs:62-120;
``pathway spawn``, cli.py:53): P OS processes each own T=PATHWAY_THREADS
engine shards of a P*T-shard world. Every process runs the SAME user
program, so node ids line up across processes (exactly like in-process
replica shards).

Topology: a coordinator star for control flow plus, at P>2, a direct
worker<->worker data mesh (timely's all-pairs channels, reference
external/timely config.rs:62-86). Process 0 (which owns sinks and
persistence) listens on 127.0.0.1:PATHWAY_FIRST_PORT; worker pid p
listens for its peers on first_port+p. Epochs run bulk-synchronous
rounds:

    POLL          (only with partitioned sources) any worker input?
    ROUND(t, frontier, feed, mail, watermarks)
        worker: apply frontier hooks + watermarks, on feed drain its
        partitioned sources into the epoch, deliver mail, then run
        sweep/exchange iterations: local fixpoint, mail for peers goes
        DIRECTLY over the mesh (one frame to and from every peer, in
        global pair order — no circular wait), mail for p0 rides the
        reply
    TIME_END(t)   close the epoch everywhere (sinks only fire on p0)
    SNAPSHOT / RESTORE   whole-cluster operator snapshots
    END           on_end hooks, shutdown

Rounds repeat until a full round moves no mail, no watermarks, and
every process is quiescent. This mirrors the reference's frontier
agreement, simplified to totally-ordered epochs (bulk-synchronous
micro-epochs per commit tick). This layer is host code: it scales the
dataflow the way upstream Pathway's TCP cluster does. Each process runs
its own device work on the package's default device (an embedder UDF on
its own key shards; the index, pinned to shard 0, on process 0), so the
processes of a cluster on one card share ``cuda:0``.

Sources: single-reader sources are read on process 0 and exchanged by
key shard (the reference's forward mode, graph.rs:943); sources built
with ``parallel_readers=True`` start a reader on EVERY process, each
reading its own partition slice (graph.rs:943-950 partitioned mode).
Workers suppress sink callbacks — delivery stays on process 0.
Partitioned sources persist per process: each worker logs its slice
under its own EnginePersistence namespace (proc-<pid>/), recovers it on
restart, and reports its replay frontier in the hello so the
coordinator's epoch numbering continues past every process's logged
times; cluster-wide operator snapshots carry worker state, and the
RESTORE broadcast's snapshot time trims already-snapshotted replay.

Exactly-once across the crash window: workers append the epoch's batch
plus feed-time offsets (KIND_FEED) durably BEFORE replying to the feed
round; process 0 flushes sinks, then durably marks the epoch delivered
(mark_delivered), then tells workers to ADVANCE. Recovery finalizes any
fed-but-unadvanced epoch at or below the delivered marker (replay, no
re-delivery) and trims epochs above it (re-read, delivered once) — so
no crash position loses or duplicates an epoch.

Fault domains: with a lease configured (pw.run(cluster_lease_ms=...) /
PATHWAY_CLUSTER_LEASE_MS, default 30 s, 0 disables), every socket read
is bounded and both sides heartbeat at lease/3 over the SAME
authenticated channel (no extra listener), so a dead, hung or
partitioned process is detected within one lease. Frames are
seq-stamped (receivers drop duplicates) and generation-stamped: the
coordinator durably bumps a cluster generation on every partial
restart, survivors regroup at the last coordinated snapshot barrier,
ONLY the dead worker is respawned (internals/run.py), and zombies of a
buried generation are fenced at the hello and on every frame.

An elastic reshard's cutover advances the generation in place
(:meth:`CoordinatorCluster.advance_generation`): the coordinator's next
request carries it and a worker adopts it before replying, so a reshard
costs no regroup; a frame stamped with the old generation after that is
fenced. (The reference's workers keep the generation of their welcome, so
their next reply after a reshard is fenced as a zombie's.)

Trust boundary: after an authenticated JSON handshake, frames are
pickled (rows may hold arbitrary python values), so a peer that knows
the cluster token can execute code — exactly the trust level of the
spawning user. This applies to the coordinator connection AND the
worker<->worker mesh links (both token-checked before any pickle
frame). `pathway spawn` generates a random per-cluster token in
PATHWAY_CLUSTER_TOKEN; manual launches must set it themselves (there
is deliberately no fallback — a guessable token would be an RCE door
on multi-user hosts).

At formation the coordinator registers with the elastic plane
(``elastic.controller.register_cluster``), so a live reshard's cutover
advances the cluster's generation (:meth:`CoordinatorCluster.advance_generation`)
and frames stamped with the old one are fenced.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import pickle
import socket
import struct
import sys
import threading
import time as _wall
from typing import Any

from ..engine import dataflow as df
from ..internals import flight_recorder
from ..resilience import chaos
from ..resilience.cluster import (
    CLUSTER_HEALTH,
    CLUSTER_METRICS,
    ClusterRegroup,
    WorkerLost,
)
from .sharded import ShardCluster, recover_sources

_HDR = struct.Struct("<I")
_MAX_HELLO = 4096  # handshake frames are tiny; bound pre-auth reads


def cluster_token() -> str:
    tok = os.environ.get("PATHWAY_CLUSTER_TOKEN")
    if not tok:
        # a guessable fallback (uid-derived etc.) would hand any local
        # user pickle-deserialization RCE — refuse instead
        raise RuntimeError(
            "multi-process execution needs a shared secret: launch via "
            "`python -m pathway_tpu_torch spawn` (which generates one) or set "
            "PATHWAY_CLUSTER_TOKEN to the same random value in every "
            "process"
        )
    return tok


def _send_json(sock: socket.socket, obj: dict) -> None:
    blob = json.dumps(obj).encode()
    sock.sendall(_HDR.pack(len(blob)) + blob)


def _recv_json(sock: socket.socket) -> dict:
    hdr = _recv_exact(sock, _HDR.size)
    (n,) = _HDR.unpack(hdr)
    if n > _MAX_HELLO:
        raise ConnectionError("oversized handshake frame")
    return json.loads(_recv_exact(sock, n))


def _send(sock: socket.socket, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=4)
    sock.sendall(_HDR.pack(len(blob)) + blob)


def _recv(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _HDR.size)
    (n,) = _HDR.unpack(hdr)
    return pickle.loads(_recv_exact(sock, n))


def _send_frame(
    sock: socket.socket,
    obj: Any,
    lock: threading.Lock | None = None,
    *,
    site: str = "cluster.send",
    time: int | None = None,
) -> None:
    """Pickle send through the chaos channel seam: an active plan may
    drop or duplicate this frame (or delay/kill via the usual actions)
    to model a lossy or partitioned cluster network. ``lock``
    serializes protocol frames against the heartbeat thread sharing the
    socket, so interleaved sendall calls cannot corrupt the stream."""
    verdict = chaos.channel(site, time=time)
    if verdict == "drop":
        return
    blob = pickle.dumps(obj, protocol=4)
    frame = _HDR.pack(len(blob)) + blob
    if verdict == "duplicate":
        frame = frame + frame
    if lock is None:
        sock.sendall(frame)
    else:
        with lock:
            sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _group_by_process(boxes: dict[int, list], threads: int) -> dict[int, dict[int, list]]:
    """{global_shard: box} -> {pid: {global_shard: box}}."""
    out: dict[int, dict[int, list]] = {}
    for shard, box in boxes.items():
        out.setdefault(shard // threads, {})[shard] = box
    return out


def _telemetry_stats(cluster: ShardCluster) -> dict[int, dict]:
    """Per-shard telemetry piggybacked on worker protocol replies — the
    cluster channel is already token-authenticated, so workers never
    open a listener of their own for the telemetry plane."""
    from ..internals.monitoring import sample_worker
    from ..resilience import SUPERVISOR_METRICS

    restarts = SUPERVISOR_METRICS.snapshot()["restarts_total"]
    out: dict[int, dict] = {}
    for e in cluster.engines:
        w = sample_worker(e)
        w["restarts"] = restarts
        out[int(e.worker_id)] = w
    return out


def _trace_spans() -> list[dict]:
    """Completed request spans since the last drain, piggybacked on the
    same authenticated replies as :func:`_telemetry_stats` — workers
    never open a listener of their own for the tracing plane either."""
    from ..tracing import TRACE_STORE, tracing_enabled

    if not tracing_enabled():
        return []
    return TRACE_STORE.drain_outbox()


def _stored_generation(engines) -> int:
    """Durable cluster generation (0 when never bumped / no
    persistence). Read at formation time so a coordinator that crashed
    mid-regroup still fences the zombies of the generation it buried."""
    cfg = engines[0].persistence_config
    if cfg is None:
        return 0
    from ..engine.persistence import EnginePersistence

    p = EnginePersistence(cfg)
    try:
        return p.cluster_generation()
    finally:
        p.close()


class CoordinatorCluster(ShardCluster):
    """Process 0's cluster: local shards [0, T) of a P*T world, plus the
    protocol driving P-1 remote worker processes.

    Fault domain: each worker process is failure-isolated. With a lease
    (``lease_ms``), every socket read is bounded and both sides send
    heartbeats at lease/3, so a dead, hung or partitioned worker
    surfaces as :class:`WorkerLost` within one lease instead of a hang.
    With persistence configured, the coordinator converts that into a
    *partial restart*: bump the durable cluster generation, tell the
    survivors to regroup at the last snapshot barrier, and raise
    :class:`ClusterRegroup` so ``internals/run.py`` respawns only the
    dead worker. ``fence`` maps respawned pids to the minimum hello
    generation they must present — a zombie of the buried generation
    (e.g. a worker that was partitioned, not dead) is refused and told
    to exit, so its stale writes can never reach the cluster."""

    pipelined = False

    def __init__(
        self,
        engines,
        processes: int,
        first_port: int,
        accept_timeout: float = 60.0,
        hello_timeout: float = 10.0,
        lease_ms: float | None = None,
        fence: dict[int, int] | None = None,
    ):
        threads = len(engines)
        super().__init__(engines, base=0, world=processes * threads)
        self._replay_only_feed = False
        self.threads = threads
        self.processes = processes
        self.lease_s = (
            float(lease_ms) / 1000.0
            if lease_ms is not None and float(lease_ms) > 0
            else None
        )
        self._lease_ms = float(lease_ms) if lease_ms is not None else 0.0
        self._fence = {int(p): int(g) for p, g in (fence or {}).items()}
        self.generation = _stored_generation(engines)
        CLUSTER_METRICS.set_generation(self.generation)
        # enroll with the elastic plane: a live reshard advances this
        # cluster's generation through advance_generation (weakly held —
        # the registry never keeps a dead cluster alive)
        from ..elastic.controller import register_cluster

        register_cluster(self)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", first_port))
        srv.listen(processes)
        srv.settimeout(accept_timeout)
        self._conns: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._send_seq: dict[int, int] = {}
        self._expect_seq: dict[int, int] = {}
        self._stale_hb: dict[int, int] = {}
        # when each worker's awaited request went on the wire (wall clock:
        # the cluster is one host's processes)
        self._sent_at: dict[int, float] = {}
        self._worker_frontiers: list[int] = []
        sig = _graph_sig(engines[0])
        token = cluster_token()
        try:
            while len(self._conns) < processes - 1:
                try:
                    conn, addr = srv.accept()
                except socket.timeout:
                    missing = sorted(
                        set(range(1, processes)) - set(self._conns)
                    )
                    raise df.EngineError(
                        f"cluster formation timed out after {accept_timeout:g}s: "
                        f"worker process(es) {missing} never connected to port "
                        f"{first_port} (connected: {sorted(self._conns)}). "
                        "Check that every process was spawned with the same "
                        "PATHWAY_FIRST_PORT; raise the limit via "
                        "pw.run(cluster_accept_timeout=...) or "
                        "PATHWAY_CLUSTER_ACCEPT_TIMEOUT."
                    ) from None
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # the handshake is JSON and token-checked BEFORE any
                # pickle frame is accepted from the peer; a connected
                # peer that stalls mid-hello must not eat the whole
                # accept budget
                conn.settimeout(hello_timeout)
                peer = f"{addr[0]}:{addr[1]}"
                try:
                    hello = _recv_json(conn)
                except (ConnectionError, ValueError, socket.timeout) as exc:
                    conn.close()
                    raise df.EngineError(
                        f"cluster formation failed: peer {peer} did not "
                        f"complete its hello within {hello_timeout:g}s "
                        f"({type(exc).__name__})"
                    ) from None
                if hello.get("op") != "hello" or not hmac.compare_digest(
                    str(hello.get("token", "")), token
                ):
                    conn.close()
                    raise df.EngineError(
                        f"cluster formation failed: peer {peer} "
                        f"(pid {hello.get('pid', '?')}) sent a bad hello or "
                        "cluster token (PATHWAY_CLUSTER_TOKEN must match in "
                        "every process)"
                    )
                wpid = int(hello["pid"])
                hello_gen = int(hello.get("gen", -1))
                floor = self._fence.get(wpid)
                if wpid in self._conns or (
                    floor is not None and hello_gen < floor
                ):
                    # zombie fencing: a worker declared dead and replaced
                    # must not rejoin under its buried generation — its
                    # slot belongs to the respawned process now
                    flight_recorder.record(
                        "cluster.fenced_write",
                        pid=wpid,
                        generation=self.generation,
                        hello_generation=hello_gen,
                        phase="formation",
                    )
                    CLUSTER_METRICS.record_fenced_write(wpid)
                    try:
                        _send_json(
                            conn,
                            {
                                "op": "fatal",
                                "error": (
                                    f"fenced: worker {wpid} was superseded "
                                    f"(cluster generation is {self.generation})"
                                ),
                            },
                        )
                    except Exception:
                        pass
                    conn.close()
                    continue
                if hello["sig"] != sig:
                    _send_json(conn, {"op": "fatal", "error": "graph mismatch: every process must run the same program"})
                    conn.close()
                    raise df.EngineError(
                        f"cluster formation failed: worker {wpid} built a "
                        f"different graph (sig {hello['sig']} != {sig})"
                    )
                if hello["threads"] != threads:
                    _send_json(conn, {"op": "fatal", "error": "PATHWAY_THREADS mismatch"})
                    conn.close()
                    raise df.EngineError(
                        f"cluster formation failed: worker {wpid} runs "
                        f"{hello['threads']} threads, this process runs "
                        f"{threads} (PATHWAY_THREADS differs across processes)"
                    )
                _send_json(
                    conn,
                    {
                        "op": "welcome",
                        "token": token,
                        "gen": self.generation,
                        "lease_ms": self._lease_ms,
                    },
                )
                # lease: every inbound frame (heartbeats included) resets
                # it; a socket silent for a whole lease means the worker
                # is dead, hung, or partitioned. None = legacy blocking.
                conn.settimeout(self.lease_s)
                self._conns[wpid] = conn
                self._send_locks[wpid] = threading.Lock()
                self._send_seq[wpid] = 0
                self._expect_seq[wpid] = 1
                self._stale_hb[wpid] = 0
                self._worker_frontiers.append(
                    int(hello.get("replay_frontier", -1))
                )
        except BaseException as exc:
            # a half-formed cluster must not leak sockets: tell every
            # already-accepted peer why formation died, then close them
            # all before surfacing the offender
            for c in self._conns.values():
                try:
                    _send_json(
                        c,
                        {"op": "fatal", "error": f"cluster formation failed: {exc}"},
                    )
                except Exception:
                    pass
                try:
                    c.close()
                except Exception:
                    pass
            self._conns.clear()
            raise
        finally:
            srv.close()
        # full strength again: clear any shards marked down by a
        # previous generation's partial restart
        CLUSTER_HEALTH.mark_all_up()
        # relay buffer: worker→worker mail waiting for the next round
        self._relay: dict[int, dict[int, list]] = {}
        self._epoch_frontier: Any = None
        self._poll_replies: dict[int, dict] | None = None
        self._last_poll = 0.0
        # telemetry plane: latest per-shard stats piggybacked on worker
        # replies, keyed by global shard id; StatsMonitor merges this
        # into its snapshot's `workers` map (engine.cluster == self)
        self.worker_telemetry: dict[int, dict] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        if self.lease_s is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name="pathway:cluster-heartbeat",
                daemon=True,
            )
            self._hb_thread.start()

    # -- protocol helpers --

    def _heartbeat_loop(self) -> None:
        # liveness frames both sides skip on receive, but whose arrival
        # resets the peer's lease timer — so a slow epoch on a healthy
        # cluster never reads as a failure. Each heartbeat also carries
        # the protocol progress ("sent": the last request seq on the
        # wire), which lets the receiver distinguish "peer is slow" from
        # "a frame was lost": heartbeats flowing while the awaited frame
        # never arrives would otherwise wait forever, invisible to the
        # lease. The seq is read and sent under the send lock so wire
        # order matches seq order.
        interval = self.lease_s / 3.0
        while not self._hb_stop.wait(interval):
            for wpid, conn in list(self._conns.items()):
                lock = self._send_locks.get(wpid)
                if lock is None:
                    continue
                try:
                    with lock:
                        _send_frame(
                            conn,
                            {
                                "op": "hb",
                                "gen": self.generation,
                                "sent": self._send_seq.get(wpid, 0),
                            },
                        )
                except Exception:
                    return  # the protocol loop reports the broken conn

    def _stop_heartbeats(self) -> None:
        self._hb_stop.set()
        t = self._hb_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._hb_thread = None

    def _send_worker(self, wpid: int, msg: dict) -> None:
        """Seq/generation-stamped frame to one worker. The seq lets the
        receiver drop duplicated frames (chaos ``duplicate`` verdicts,
        retransmits) without breaking the strict request/reply shape."""
        self._send_seq[wpid] += 1
        self._sent_at[wpid] = _wall.time()
        stamped = dict(msg)
        stamped["seq"] = self._send_seq[wpid]
        stamped["gen"] = self.generation
        try:
            _send_frame(
                self._conns[wpid],
                stamped,
                self._send_locks[wpid],
                time=msg.get("t"),
            )
        except (ConnectionError, OSError) as exc:
            raise WorkerLost(wpid, f"send failed ({exc})") from None

    def _recv_worker(self, wpid: int) -> dict:
        """Next protocol reply from one worker, skipping heartbeats and
        duplicated frames; lease expiry and dead connections surface as
        :class:`WorkerLost` for the partial-restart path."""
        conn = self._conns[wpid]
        while True:
            try:
                r = _recv(conn)
            except socket.timeout:
                flight_recorder.record(
                    "cluster.lease_expired", pid=wpid, lease_s=self.lease_s
                )
                CLUSTER_METRICS.record_lease_expired(wpid)
                raise WorkerLost(
                    wpid, f"lease expired ({self.lease_s:g}s without a frame)"
                ) from None
            except (ConnectionError, OSError) as exc:
                raise WorkerLost(wpid, f"connection lost ({exc})") from None
            if not isinstance(r, dict):
                raise WorkerLost(wpid, "protocol violation (non-dict frame)")
            if r.get("op") == "hb":
                # heartbeats prove liveness but also progress: if the
                # worker reports it already replied to the request we
                # are waiting for, or repeatedly reports never having
                # received it, the channel lost a frame — heartbeats
                # would keep resetting the lease forever otherwise
                awaiting = self._send_seq.get(wpid, 0)
                done = r.get("done")
                if done is not None and int(done) >= awaiting > 0:
                    flight_recorder.record(
                        "cluster.frame_lost",
                        pid=wpid,
                        direction="reply",
                        seq=awaiting,
                    )
                    raise WorkerLost(
                        wpid,
                        f"reply to seq {awaiting} lost in transit "
                        f"(worker reports done={int(done)})",
                    )
                got = r.get("got")
                if float(r.get("at", _wall.time())) < self._sent_at.get(wpid, 0.0):
                    # written before the request left: it queued in the
                    # socket while this process swept its own shards, and
                    # says nothing of the request (the reference counts it,
                    # and a local sweep longer than 2/3 of a lease then
                    # reads as a lost frame)
                    continue
                if got is not None and int(got) < awaiting:
                    self._stale_hb[wpid] = self._stale_hb.get(wpid, 0) + 1
                    # two consecutive stale heartbeats (~2/3 of a lease)
                    # rule out the instant between the frame arriving
                    # and the worker recording it
                    if self._stale_hb[wpid] >= 2:
                        flight_recorder.record(
                            "cluster.frame_lost",
                            pid=wpid,
                            direction="request",
                            seq=awaiting,
                        )
                        raise WorkerLost(
                            wpid,
                            f"request seq {awaiting} lost in transit "
                            f"(worker reports got={int(got)})",
                        )
                else:
                    self._stale_hb[wpid] = 0
                continue  # liveness traffic, not a reply
            rgen = r.get("gen")
            if rgen is not None and int(rgen) != self.generation:
                # a frame stamped with a buried generation is a zombie
                # write — refuse it and retire the sender
                flight_recorder.record(
                    "cluster.fenced_write",
                    pid=wpid,
                    generation=self.generation,
                    frame_generation=int(rgen),
                )
                CLUSTER_METRICS.record_fenced_write(wpid)
                raise WorkerLost(
                    wpid,
                    f"stale generation {rgen} (cluster is at {self.generation})",
                )
            seq = r.get("seq")
            if seq is not None:
                if int(seq) < self._expect_seq[wpid]:
                    continue  # duplicated frame; already processed
                self._expect_seq[wpid] = int(seq) + 1
            if r.get("op") == "error":
                raise df.EngineError(
                    f"worker process {wpid} failed:\n{r['traceback']}"
                )
            self._stale_hb[wpid] = 0
            return r

    def _round_all(self, msg_per_pid: dict[int, dict]) -> dict[int, dict]:
        for wpid in self._conns:
            self._send_worker(wpid, msg_per_pid[wpid])
        replies = {}
        for wpid in list(self._conns):
            replies[wpid] = self._recv_worker(wpid)
        return replies

    def _broadcast(self, msg: dict) -> dict[int, dict]:
        return self._round_all({pid: msg for pid in self._conns})

    # -- fault domain: detection -> partial restart --

    def run(self, monitoring_callback=None) -> None:
        try:
            super().run(monitoring_callback)
        except WorkerLost as exc:
            self._begin_partial_restart(exc)
        finally:
            self._stop_heartbeats()

    def advance_generation(self, generation: int) -> None:
        """Adopt an externally bumped (already durable) cluster
        generation — the elastic reshard path calls this after cutover
        so protocol frames stamped with the pre-reshard generation are
        fenced by the existing stale-frame machinery."""
        gen = int(generation)
        if gen <= self.generation:
            return
        self.generation = gen
        CLUSTER_METRICS.set_generation(gen)
        flight_recorder.record(
            "cluster.generation_advanced", generation=gen, reason="elastic"
        )

    def _begin_partial_restart(self, exc: WorkerLost) -> None:
        """Convert a lost worker into a partial restart: bump the
        durable generation (fencing the dead worker's zombie writes),
        quiesce the survivors at the last snapshot barrier, and raise
        :class:`ClusterRegroup` for ``internals/run.py`` to respawn
        ONLY the dead process. Without persistence there is no barrier
        to restart from, so the whole attempt fails instead (charged to
        the supervisor's full-restart budget when ``recovery=`` is on)."""
        self._stop_heartbeats()
        persistence = getattr(self, "_persistence", None)
        if persistence is None:
            self._close_conns(f"cluster failed: {exc}")
            raise df.EngineError(str(exc)) from exc
        gen = persistence.bump_cluster_generation()
        self.generation = gen
        CLUSTER_METRICS.set_generation(gen)
        CLUSTER_METRICS.record_partial_restart(exc.pid)
        # the dead worker's shard range is down until the next formation
        # completes; the serving plane degrades those shards instead of
        # failing the whole endpoint
        CLUSTER_HEALTH.mark_down(
            range(exc.pid * self.threads, (exc.pid + 1) * self.threads),
            retry_after_s=self.lease_s,
        )
        flight_recorder.record(
            "cluster.partial_restart",
            pid=exc.pid,
            generation=gen,
            reason=exc.reason,
        )
        # survivors drop volatile state and rejoin the next formation
        # under the bumped generation; best-effort — an unreachable
        # survivor discovers the regroup via its own lease
        for wpid, conn in self._conns.items():
            if wpid == exc.pid:
                continue
            try:
                with self._send_locks[wpid]:
                    _send(conn, {"op": "regroup", "gen": gen})
            except Exception:
                pass
        self._close_conns(None)
        try:
            persistence.close()
        except Exception:
            pass
        self._persistence = None
        raise ClusterRegroup([exc.pid], gen, exc.reason) from exc

    def _close_conns(self, fatal: str | None) -> None:
        for wpid, conn in self._conns.items():
            if fatal is not None:
                try:
                    with self._send_locks[wpid]:
                        _send(conn, {"op": "fatal", "error": fatal})
                except Exception:
                    pass
            try:
                conn.close()
            except Exception:
                pass
        self._conns.clear()

    # -- distributed sweep --

    def set_epoch_frontier(self, frontier) -> None:
        """The frontier the workers must apply before sweeping the next
        epoch (run() applies it locally via _frontier_hooks)."""
        self._epoch_frontier = frontier

    def _has_partitioned_sources(self) -> bool:
        # every process builds the same graph, so the coordinator's own
        # sources tell whether ANY process runs partitioned readers —
        # without them there is nothing to poll (and no protocol
        # traffic racing against worker shutdown)
        return bool(_partitioned_sources(self))

    def _poll_cached(self) -> dict[int, dict]:
        # rate-limited: polling every idle cycle steals GIL time from
        # the very reader threads the poll is waiting on
        now = _wall.monotonic()
        if self._poll_replies is None or now - self._last_poll >= 0.1:
            self._last_poll = now
            self._poll_replies = self._broadcast({"op": "poll"})
            self._capture_telemetry(self._poll_replies)
        return self._poll_replies

    def _capture_telemetry(self, replies: dict[int, dict]) -> None:
        for r in replies.values():
            for wid, stats in (r.get("stats") or {}).items():
                self.worker_telemetry[int(wid)] = stats
            spans = r.get("spans")
            if spans:
                # remote request spans ride the same replies as stats;
                # ingest dedups by span id so a chaos-duplicated frame
                # cannot double-count a stage (the same fence as the frames' seq)
                from ..tracing import TRACE_STORE

                TRACE_STORE.ingest_remote(spans)

    def _speedrun_supported(self) -> bool:
        return False  # worker-process logs are not visible to process 0

    def _remote_replay_frontier(self) -> int:
        return max(self._worker_frontiers, default=-1)

    def _setup_persistence(self) -> None:
        super()._setup_persistence()
        wf = max(self._worker_frontiers, default=-1)
        if wf >= 0:
            # dedicated replay round AT the frontier: workers flush
            # recovered batches, state rebuilds cluster-wide, and sinks
            # (time <= replay_frontier) do not re-deliver
            t = self.engines[0].replay_frontier
            for e in self.engines:
                e.current_time = t
                e._frontier_hooks(t)
            self._replay_only_feed = True
            try:
                self.set_epoch_frontier(t)
                self._sweep(t)
            finally:
                self._replay_only_feed = False

    def _remote_input_pending(self) -> bool:
        if not self._has_partitioned_sources():
            return False
        return any(r.get("pending") for r in self._poll_cached().values())

    def _remote_sources_closed(self) -> bool:
        if not self._has_partitioned_sources():
            return True
        return all(r.get("closed", True) for r in self._poll_cached().values())

    def _sweep(self, time) -> None:
        for e in self.engines:
            if e.profiler is not None:
                e.profiler.begin_epoch(e.worker_id)
        frontier = self._epoch_frontier
        self._epoch_frontier = None
        feed = True  # workers drain their partitioned sources once per epoch
        # an epoch at or below the replay frontier replays recovered input
        # only: live worker input fed into it would carry a replayed time,
        # which the sinks never deliver, and be lost to them (the reference
        # feeds it there; its rows then reach the state but no sink)
        replay_only = self._replay_only_feed or time <= self.engines[0].replay_frontier
        while True:
            self._sweep_local(time)
            outbound = _group_by_process(self.drain_remote_mail(), self.threads)
            # fold in relayed worker→worker mail from the previous round
            for pid, boxes in self._relay.items():
                dst = outbound.setdefault(pid, {})
                for shard, box in boxes.items():
                    dst.setdefault(shard, []).extend(box)
            self._relay = {}
            wm = self.watermark_map()
            sent_any = any(outbound.values())
            msgs = {
                pid: {
                    "op": "round",
                    "t": time,
                    "frontier": frontier,
                    "feed": feed,
                    "replay_only": replay_only,
                    "mail": outbound.get(pid, {}),
                    "wm": wm,
                }
                for pid in self._conns
            }
            frontier = None  # applied once per epoch
            feed = False
            replies = self._round_all(msgs)
            got_mail = False
            wm_changed = False
            for pid, r in replies.items():
                for dest_pid, boxes in r["mail"].items():
                    if dest_pid == 0:
                        got_mail |= self.post_mail(boxes)
                    else:
                        dst = self._relay.setdefault(dest_pid, {})
                        for shard, box in boxes.items():
                            dst.setdefault(shard, []).extend(box)
                        got_mail = True
                wm_changed |= self.apply_watermarks(r["wm"])
                wm_changed |= bool(r["active"])
            if not (sent_any or got_mail or wm_changed or any(e._dirty for e in self.engines)):
                break
        # process 0's sinks flush the epoch FIRST; only then do workers
        # advance their input-offset cursors (time_end) — the reverse
        # order loses the epoch's output if the cluster dies in between
        # (workers would resume past input that was never delivered)
        self._time_end_all(time)
        chaos.inject("coordinator.after_sink_flush", time=int(time))
        if self._persistence is not None:
            # durable delivered marker between the sink flush and the
            # workers' ADVANCE: a crash in that window must finalize the
            # epoch on recovery (workers promote fed-but-unadvanced
            # epochs at or below this marker), never re-deliver it
            self._persistence.mark_delivered(int(time))
        chaos.inject("coordinator.after_mark_delivered", time=int(time))
        # the time_end acks carry each worker's latest telemetry sample
        # (previously discarded) — this is what puts remote workers on
        # the coordinator's /metrics under their worker= labels
        self._capture_telemetry(self._broadcast({"op": "time_end", "t": time}))
        # the feed round consumed worker input: a cached pending=True
        # would spin empty epochs until the cache expired
        self._poll_replies = None
        for e in self.engines:
            if e.profiler is not None:
                e.profiler.end_epoch(e.worker_id, e, time)

    # -- persistence across processes --

    def _snapshot_operators(self, t: int) -> None:
        from ..engine import device_ring

        # no staging-ring slot whose copy is still in flight is pickled
        device_ring.quiesce_all()
        states = {}
        for shard, e in enumerate(self.engines):
            for n in e.nodes:
                s = n.snapshot_state()
                if s is not None:
                    states[(shard, n.id)] = s
        for pid, r in self._broadcast({"op": "snapshot", "t": int(t)}).items():
            states.update(r["states"])
        blob = df.dumps_host(
            {
                "sig": self._cluster_signature(),
                "time": int(t),
                "states": states,
                "generation": self.generation,
            }
        )
        self._persistence.save_operator_snapshot(int(t), blob)
        self._compact_inputs(int(t))
        self._last_opsnap_wall = _wall.monotonic()
        # the snapshot broadcast IS the coordinated barrier: every
        # worker contributed state for the same epoch t, so a partial
        # restart resumes the whole cluster from here
        flight_recorder.record(
            "cluster.barrier", t=int(t), generation=self.generation, world=self.world
        )
        CLUSTER_METRICS.record_barrier(self.generation)

    def _cluster_signature(self):
        # all processes build the identical graph, so the signature of
        # global shard s equals shard 0's with the shard id substituted
        base = [(n.id, n.snapshot_signature()) for n in self.engines[0].nodes]
        return [(shard, nid, s) for shard in range(self.world) for nid, s in base]

    def _restore_states(self, states: dict, time: int = -1) -> None:
        local: dict = {}
        remote: dict[int, dict] = {}
        for (shard, nid), st in states.items():
            if self._is_local(shard):
                self.engines[shard].nodes[nid].restore_state(st)
            else:
                remote.setdefault(shard // self.threads, {})[(shard, nid)] = st
        for pid in self._conns:
            self._send_worker(
                pid, {"op": "restore", "states": remote.get(pid, {}), "time": time}
            )
            r = self._recv_worker(pid)
            assert r.get("op") == "ok"

    def _flush_needed(self) -> bool:
        return True  # remote processes may hold buffered state

    def _finish_remote(self) -> None:
        # heartbeats first: a racing hb sendall mid-"end" would corrupt
        # the stream. END deliberately bypasses the chaos channel — a
        # dropped shutdown frame models nothing the lease doesn't
        # already cover, and would wedge fault-free teardown.
        self._stop_heartbeats()
        for pid, conn in self._conns.items():
            try:
                with self._send_locks[pid]:
                    _send(conn, {"op": "end"})
            except Exception:
                pass
        for conn in self._conns.values():
            try:
                conn.close()
            except Exception:
                pass


def _graph_sig(engine: df.EngineGraph) -> str:
    # JSON-safe digest: node count + names in creation order
    h = hashlib.sha256()
    h.update(str(len(engine.nodes)).encode())
    for n in engine.nodes:
        h.update(b"\x00" + n.name.encode())
    return h.hexdigest()


class PeerMesh:
    """Direct worker<->worker TCP links (timely's all-pairs channels,
    upstream timely's config.rs:62-86) so re-key mail moves in
    one hop instead of relaying through the coordinator. Pair (i, j),
    i<j: j connects to i's listener on first_port+i; both sides check
    the cluster token before any pickle frame. Exchange is one frame to
    and from every peer per iteration, in global pair order (i sends
    first in its pairs with higher pids) — consistent ordering, so no
    circular wait."""

    def __init__(self, pid: int, processes: int, first_port: int, token: str, retries: int = 120):
        self.pid = pid
        self.peers: dict[int, socket.socket] = {}
        others = [j for j in range(1, processes) if j != pid]
        srv = None
        higher = [j for j in others if j > pid]
        if higher:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", first_port + pid))
            srv.listen(len(higher))
            srv.settimeout(60.0)
        try:
            for j in [j for j in others if j < pid]:
                conn = None
                for _ in range(retries):
                    try:
                        conn = socket.create_connection(
                            ("127.0.0.1", first_port + j), timeout=5.0
                        )
                        break
                    except OSError:
                        _wall.sleep(0.25)
                if conn is None:
                    raise ConnectionError(f"cannot reach peer worker {j}")
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _send_json(conn, {"op": "peer", "pid": pid, "token": token})
                ack = _recv_json(conn)
                if ack.get("op") != "peer_ok" or not hmac.compare_digest(
                    str(ack.get("token", "")), token
                ):
                    raise ConnectionError(f"peer {j} failed token check")
                self.peers[j] = conn
            while len(self.peers) < len(others):
                conn, _ = srv.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    hello = _recv_json(conn)
                except (ConnectionError, ValueError):
                    conn.close()
                    continue
                if hello.get("op") != "peer" or not hmac.compare_digest(
                    str(hello.get("token", "")), token
                ):
                    conn.close()
                    continue
                _send_json(conn, {"op": "peer_ok", "token": token})
                self.peers[hello["pid"]] = conn
        finally:
            if srv is not None:
                srv.close()

    def exchange(self, outbound: dict[int, dict]) -> dict[int, list]:
        """Send one mail frame to every peer (empty allowed), receive
        one from each; returns merged inbound {shard: box}."""
        inbound: dict[int, list] = {}
        for j in sorted(self.peers):
            conn = self.peers[j]
            if self.pid < j:
                _send(conn, outbound.get(j, {}))
                got = _recv(conn)
            else:
                got = _recv(conn)
                _send(conn, outbound.get(j, {}))
            for shard, box in got.items():
                inbound.setdefault(shard, []).extend(box)
        return inbound

    def close(self) -> None:
        for conn in self.peers.values():
            try:
                conn.close()
            except Exception:
                pass


def _partitioned_sources(cluster: ShardCluster):
    return [
        s
        for s in cluster.engines[0].session_sources
        if getattr(s, "parallel_readers", False)
    ]


def _feed_partitioned(
    cluster: ShardCluster,
    t,
    persistence=None,
    replay_only: bool = False,
    pending_advance: dict | None = None,
) -> bool:
    fed = False
    for s in _partitioned_sources(cluster):
        # recovered batches rebuild state in the coordinator's dedicated
        # replay round (t == replay frontier, so sinks on process 0
        # suppress the re-delivery exactly like process-0 replay)
        fed |= s.flush_replay(t)
        if replay_only:
            continue
        b = s.session.drain()
        if b:
            resolved = s.feed_batch(b, t)
            if (
                persistence is not None
                and s.persistent_id is not None
                and resolved
            ):
                # feed-time offsets ride in the same flushed append as
                # the batch (KIND_FEED): if p0 delivers this epoch and
                # the cluster dies before our ADVANCE, recovery promotes
                # the epoch to finalized instead of re-delivering it
                persistence.log_batch(
                    s.persistent_id, t, resolved, offsets=s.last_offsets or {}
                )
                chaos.inject(
                    "worker.after_feed_log",
                    time=int(t),
                    offset=persistence.log_position(s.persistent_id),
                )
                # the ADVANCE (offset cursor) flushes only when the
                # epoch CLOSES: advancing at feed time would mark rows
                # consumed that a mid-epoch crash never delivered —
                # same ordering as the single-process path
                if pending_advance is not None:
                    pending_advance[s.persistent_id] = (t, s.last_offsets or {})
            fed = True
    return fed


def run_worker(
    cluster: ShardCluster,
    first_port: int,
    pid: int,
    retries: int = 120,
    lease_ms: float | None = None,
) -> None:
    """Worker process main loop (PATHWAY_PROCESS_ID > 0): serve rounds
    until the coordinator says END.

    The welcome carries the coordinator's lease and cluster generation;
    with a lease, the worker heartbeats at lease/3 and bounds every
    socket read, raising :class:`ClusterRegroup` (rejoin the next
    formation via ``internals/run.py``) when the coordinator goes
    silent or orders a regroup."""
    # worker-side persistence FIRST: the hello reports this process's
    # replay frontier, so recovery must happen before connecting
    wp = None
    replay_frontier = -1
    part_srcs = _partitioned_sources(cluster)
    cfg = cluster.engines[0].persistence_config
    if cfg is not None and part_srcs:
        from ..engine.persistence import EnginePersistence

        wp = EnginePersistence(cfg)
        replay_frontier = recover_sources(
            wp,
            part_srcs,
            cfg,
            auto_prefix="auto_part",
            delivered_frontier=wp.delivered_frontier(),
        )
    sock = None
    for _ in range(retries):
        try:
            sock = socket.create_connection(("127.0.0.1", first_port), timeout=5.0)
            break
        except OSError:
            _wall.sleep(0.25)
    if sock is None:
        raise ConnectionError(f"cannot reach coordinator on port {first_port}")
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    token = cluster_token()
    _send_json(
        sock,
        {
            "op": "hello",
            "pid": pid,
            "threads": cluster.n,
            "sig": _graph_sig(cluster.engines[0]),
            "token": token,
            "replay_frontier": replay_frontier,
            # the generation this process believes is current: respawned
            # workers inherit the bumped one via the environment, zombies
            # present a buried one and are fenced at the door
            "gen": int(os.environ.get("PATHWAY_CLUSTER_GENERATION", "-1") or -1),
        },
    )
    welcome = _recv_json(sock)
    if welcome.get("op") == "fatal":
        raise RuntimeError(welcome["error"])
    # mutual auth: a port squatter can't feed us pickles either
    assert welcome.get("op") == "welcome"
    if not hmac.compare_digest(str(welcome.get("token", "")), token):
        raise ConnectionError("coordinator failed token check")
    gen = int(welcome.get("gen", 0))
    # carried into the next formation (and any process we fork): the
    # learned generation is what distinguishes a survivor from a zombie
    os.environ["PATHWAY_CLUSTER_GENERATION"] = str(gen)
    # spans recorded in this process carry its first global shard id and
    # buffer in an outbox until a poll/time_end reply drains them
    from ..tracing import set_worker as _trace_set_worker

    _trace_set_worker(int(cluster.base))
    w_lease = welcome.get("lease_ms")
    if w_lease is None:
        w_lease = lease_ms
    lease_s = (
        float(w_lease) / 1000.0 if w_lease is not None and float(w_lease) > 0 else None
    )
    # the 5s connect timeout bounded the handshake; steady state is
    # bounded by the lease (None = legacy blocking protocol)
    sock.settimeout(lease_s)
    send_lock = threading.Lock()
    hb_stop = threading.Event()
    last_seq = 0  # last request seq received from the coordinator
    done_seq = 0  # last request seq whose reply has been handed to the wire

    def _reply(obj: dict, *, seq: int | None = None, time: int | None = None) -> None:
        nonlocal done_seq
        if seq is not None:
            obj["seq"] = seq
        obj["gen"] = gen
        try:
            _send_frame(sock, obj, send_lock, time=time)
        except (ConnectionError, OSError) as exc:
            # the coordinator dropped this connection (it declared the
            # worker lost): rejoin the next formation, as a lost read does
            raise ClusterRegroup([], gen, f"coordinator connection lost ({exc})") from None
        if seq is not None:
            done_seq = int(seq)

    def _hb_loop() -> None:
        # heartbeats carry protocol progress (got/done), so the
        # coordinator can tell a slow epoch (got the request, still
        # working) from a lost frame (never got it / already replied)
        while not hb_stop.wait(lease_s / 3.0):
            try:
                _send_frame(
                    sock,
                    {"op": "hb", "gen": gen, "got": last_seq, "done": done_seq, "at": _wall.time()},
                    send_lock,
                )
            except Exception:
                return

    if lease_s is not None:
        threading.Thread(
            target=_hb_loop, name="pathway:cluster-heartbeat", daemon=True
        ).start()

    stale_hb = 0

    def _recv_op() -> dict:
        nonlocal last_seq, stale_hb, gen
        while True:
            try:
                msg = _recv(sock)
            except socket.timeout:
                flight_recorder.record(
                    "cluster.lease_expired", pid=pid, side="worker", lease_s=lease_s
                )
                CLUSTER_METRICS.record_lease_expired(pid)
                raise ClusterRegroup(
                    [], gen, "coordinator unreachable (lease expired)"
                ) from None
            except (ConnectionError, OSError) as exc:
                raise ClusterRegroup(
                    [], gen, f"coordinator connection lost ({exc})"
                ) from None
            if not isinstance(msg, dict):
                continue
            if msg.get("op") == "hb":
                # the coordinator's heartbeat names the last request seq
                # it put on the wire; if it is repeatedly ahead of what
                # we received, that request was lost in transit and the
                # lease alone would never notice (heartbeats keep it
                # fresh) — regroup instead of waiting forever
                sent = msg.get("sent")
                if sent is not None and int(sent) > last_seq:
                    stale_hb += 1
                    if stale_hb >= 2:
                        flight_recorder.record(
                            "cluster.frame_lost",
                            pid=pid,
                            side="worker",
                            direction="request",
                            seq=int(sent),
                        )
                        raise ClusterRegroup(
                            [], gen, f"request seq {sent} lost in transit"
                        )
                else:
                    stale_hb = 0
                continue
            seq = msg.get("seq")
            if seq is not None:
                if int(seq) <= last_seq:
                    continue  # duplicated frame; already processed
                last_seq = int(seq)
            stale_hb = 0
            mgen = msg.get("gen")
            if mgen is not None and int(mgen) > gen:
                # the coordinator advanced the generation in place (an
                # elastic reshard's cutover): adopt it, so this worker's
                # replies are not fenced as a zombie's. Only the
                # coordinator's connection carries requests, so a zombie
                # never learns a generation this way
                gen = int(mgen)
                os.environ["PATHWAY_CLUSTER_GENERATION"] = str(gen)
                flight_recorder.record("cluster.generation_advanced", pid=pid, generation=gen, reason="coordinator")
            return msg

    processes = cluster.world // cluster.n
    mesh = PeerMesh(pid, processes, first_port, token) if processes > 2 else None
    # partitioned sources read their slice HERE: start only the readers
    # flagged parallel (single-reader sources stay on process 0)
    for th in cluster.engines[0].connector_threads:
        if getattr(th, "pathway_parallel_reader", False):
            th.start()
    pending_advance: dict = {}
    try:
        while True:
            msg = _recv_op()
            op = msg["op"]
            if op == "round":
                t = msg["t"]
                had = False
                if msg.get("feed"):
                    # one feed round per epoch: the worker-side epoch
                    # boundary for the black-box ring
                    flight_recorder.record("epoch.begin", t=t, pid=pid)
                if msg.get("frontier") is not None:
                    for e in cluster.engines:
                        e.current_time = t
                        e._frontier_hooks(msg["frontier"])
                if msg.get("feed"):
                    had |= _feed_partitioned(
                        cluster,
                        t,
                        wp,
                        replay_only=msg.get("replay_only", False),
                        pending_advance=pending_advance,
                    )
                had |= cluster.post_mail(msg["mail"])
                had |= cluster.apply_watermarks(msg["wm"])
                p0_mail: dict[int, dict] = {}
                sent_peer = got_peer = False
                # two exchange iterations: mail produced by the first
                # sweep reaches its peer and is swept in THIS round
                for _it in range(2 if mesh is not None else 1):
                    cluster._sweep_local(t)
                    out = _group_by_process(cluster.drain_remote_mail(), cluster.n)
                    if mesh is not None:
                        peer_out = {p: b for p, b in out.items() if p != 0}
                        sent_peer |= any(peer_out.values())
                        try:
                            inbound = mesh.exchange(peer_out)
                        except (ConnectionError, OSError) as exc:
                            # a dead peer breaks the mesh before the
                            # coordinator's lease notices: regroup, the
                            # next formation rebuilds the mesh
                            raise ClusterRegroup(
                                [], gen, f"peer mesh broken ({exc})"
                            ) from None
                        if inbound:
                            cluster.post_mail(inbound)
                            got_peer = True
                        out = {0: out.get(0, {})} if out.get(0) else {}
                    for dest_pid, boxes in out.items():
                        dst = p0_mail.setdefault(dest_pid, {})
                        for shard, box in boxes.items():
                            dst.setdefault(shard, []).extend(box)
                _reply(
                    {
                        "op": "reply",
                        "mail": p0_mail,
                        "wm": cluster.watermark_map(),
                        "active": had or bool(p0_mail) or sent_peer or got_peer,
                    },
                    seq=msg.get("seq"),
                    time=t,
                )
            elif op == "poll":
                srcs = _partitioned_sources(cluster)
                _reply(
                    {
                        "op": "poll_reply",
                        "pending": any(s.session.pending() for s in srcs),
                        "closed": all(s.session.closed for s in srcs),
                        "stats": _telemetry_stats(cluster),
                        "spans": _trace_spans(),
                    },
                    seq=msg.get("seq"),
                )
            elif op == "time_end":
                cluster._time_end_all(msg["t"])
                flight_recorder.record("epoch.time_end", t=msg["t"], pid=pid)
                chaos.inject("worker.before_advance", time=int(msg["t"]))
                if wp is not None and pending_advance:
                    for sid, (at, offs) in pending_advance.items():
                        wp.advance(sid, at, offs)
                    pending_advance.clear()
                chaos.inject("worker.after_advance", time=int(msg["t"]))
                _reply(
                    {
                        "op": "ok",
                        "stats": _telemetry_stats(cluster),
                        "spans": _trace_spans(),
                    },
                    seq=msg.get("seq"),
                    time=int(msg["t"]),
                )
            elif op == "snapshot":
                states = {}
                for i, e in enumerate(cluster.engines):
                    for n in e.nodes:
                        s = n.snapshot_state()
                        if s is not None:
                            states[(cluster.base + i, n.id)] = s
                # cluster-wide operator snapshots cover worker state, so
                # this process's input logs compact at the same point
                # (p0 compacts its own in _compact_inputs)
                if (
                    wp is not None
                    and getattr(cfg, "compact_inputs_on_snapshot", False)
                ):
                    wp.compact_inputs(
                        [
                            s_.persistent_id
                            for s_ in part_srcs
                            if s_.persistent_id is not None
                        ],
                        msg.get("t", -1),
                    )
                # contributing state to the cluster snapshot is this
                # worker's side of the coordinated barrier
                flight_recorder.record(
                    "cluster.barrier", t=msg.get("t"), pid=pid, generation=gen
                )
                CLUSTER_METRICS.record_barrier(gen)
                _reply({"op": "states", "states": states}, seq=msg.get("seq"))
            elif op == "restore":
                for (shard, nid), st in msg["states"].items():
                    cluster.engines[shard - cluster.base].nodes[nid].restore_state(st)
                t0 = msg.get("time")
                if t0 is not None:
                    # rows at or before the snapshot are inside the
                    # restored operator state: replaying them again
                    # would double-ingest
                    for s_ in _partitioned_sources(cluster):
                        s_.replay_batches = [
                            (tt, ups) for tt, ups in s_.replay_batches if tt > t0
                        ]
                _reply({"op": "ok"}, seq=msg.get("seq"))
            elif op == "end":
                for e in cluster.engines:
                    for n in e.nodes:
                        n.on_end()
                if wp is not None:
                    wp.close()
                return
            elif op == "regroup":
                # the coordinator lost a worker: drop volatile state and
                # rejoin the next formation under the bumped generation
                new_gen = int(msg.get("gen", -1))
                os.environ["PATHWAY_CLUSTER_GENERATION"] = str(new_gen)
                if wp is not None:
                    wp.close()
                raise ClusterRegroup([], new_gen, "coordinator regroup")
            elif op == "fatal":
                raise RuntimeError(msg["error"])
            else:
                raise RuntimeError(f"unknown op {op!r}")
    except ClusterRegroup as exc:
        # not a crash: no black-box dump, no error frame — the regroup
        # loop in internals/run.py rebuilds the runner and reconnects
        flight_recorder.record(
            "cluster.regroup", pid=pid, generation=exc.generation, reason=exc.reason
        )
        if wp is not None:
            try:
                wp.close()
            except Exception:
                pass
        raise
    except Exception as exc:
        import traceback

        flight_recorder.record("worker.error", pid=pid, error=type(exc).__name__)
        flight_recorder.dump("worker_crash", exc)
        try:
            with send_lock:
                _send(sock, {"op": "error", "traceback": traceback.format_exc()})
        except Exception:
            pass
        raise
    finally:
        hb_stop.set()
        if mesh is not None:
            mesh.close()
        sock.close()
