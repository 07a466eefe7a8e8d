"""The cluster fault domain of the port against the JAX package's, on the CPU.

The reference's unit cases (``tests/test_cluster_fault_domain.py``) run on
both packages: the shared registries (``ClusterMetrics``,
``ClusterHealth``), ``WorkerLost`` and ``ClusterRegroup``, the admission
gate on shard health (``admit(shard=)``: a typed 503, degraded service,
tenant caps first), the chaos channel's verdicts and the frames
``_send_frame`` puts on the wire under them, the durable cluster
generation seen from a worker's namespace, the cluster lines of
``/metrics`` and the flight recorder's dump retention.

Then the multi-process cases of the port: a worker SIGKILLed mid-stream is
respawned alone (a partial restart under ``PATHWAY_CLUSTER_RESPAWN``), the
generation advances by one, and every row is delivered exactly once with
the uninterrupted run's answers; the twin of the reference's cross-tier
case (``tests/test_cross_tier_restart.py``: worker 1 killed inside a tiered
index's promotion); and two processes joining one ``gloo`` group through
``host_mesh_from_env``. Each process has its own wall-clock limit."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import pytest

import pathway_tpu as jpw
import pathway_tpu.engine.persistence as j_persist
import pathway_tpu.internals.flight_recorder as j_fr
import pathway_tpu.internals.http_monitoring as j_http
import pathway_tpu.parallel.multiprocess as j_mp
import pathway_tpu.resilience.chaos as j_chaos
import pathway_tpu.resilience.cluster as j_cluster
import pathway_tpu.resilience.supervisor as j_sup
import pathway_tpu.serving as j_sv
import pathway_tpu.serving.metrics as j_svm
import pathway_tpu.tenancy as j_ten
import pathway_tpu_torch as tpw
import pathway_tpu_torch.engine.persistence as t_persist
import pathway_tpu_torch.internals.flight_recorder as t_fr
import pathway_tpu_torch.internals.http_monitoring as t_http
import pathway_tpu_torch.parallel.multiprocess as t_mp
import pathway_tpu_torch.resilience.chaos as t_chaos
import pathway_tpu_torch.resilience.cluster as t_cluster
import pathway_tpu_torch.resilience.supervisor as t_sup
import pathway_tpu_torch.serving as t_sv
import pathway_tpu_torch.serving.metrics as t_svm
import pathway_tpu_torch.tenancy as t_ten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 180

J = SimpleNamespace(pw=jpw, persist=j_persist, fr=j_fr, http=j_http, mp=j_mp, chaos=j_chaos, cluster=j_cluster,
                    sup=j_sup, sv=j_sv, svm=j_svm, ten=j_ten)
T = SimpleNamespace(pw=tpw, persist=t_persist, fr=t_fr, http=t_http, mp=t_mp, chaos=t_chaos, cluster=t_cluster,
                    sup=t_sup, sv=t_sv, svm=t_svm, ten=t_ten)
BOTH = pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    for P in (J, T):
        P.cluster.CLUSTER_METRICS.reset()
        P.cluster.CLUSTER_HEALTH.mark_all_up()
        P.chaos.deactivate()


# ---------------------------------------------------------- registries


@BOTH
def test_cluster_metrics_counts_and_snapshot(P):
    m = P.cluster.ClusterMetrics()
    assert not m.active()
    m.record_lease_expired(1)
    m.record_lease_expired(1)
    m.record_lease_expired(2)
    m.record_partial_restart(1)
    m.record_fenced_write(2)
    m.record_barrier(generation=3)
    snap = m.snapshot()
    assert snap["lease_expiries"] == {"1": 2, "2": 1}
    assert snap["lease_expiries_total"] == 3
    assert snap["partial_restarts_total"] == 1
    assert snap["fenced_writes_total"] == 1
    assert snap["barriers_total"] == 1
    assert snap["generation"] == 3
    assert m.active()
    m.reset()
    assert not m.active()


@BOTH
def test_cluster_health_down_and_recovery(P):
    h = P.cluster.ClusterHealth()
    assert not h.any_down()
    h.mark_down([2, 3], retry_after_s=4.5)
    assert h.is_down(2) and h.is_down(3) and not h.is_down(0)
    assert h.down_shards() == frozenset({2, 3})
    assert h.retry_after_s() == 4.5
    h.mark_down([5])  # accumulates until the next full formation
    assert h.down_shards() == frozenset({2, 3, 5})
    h.mark_all_up()
    assert not h.any_down()


@BOTH
def test_worker_lost_and_regroup_carry_identity(P):
    wl = P.cluster.WorkerLost(3, "lease expired (2s without a frame)")
    assert wl.pid == 3 and "lease expired" in str(wl)
    rg = P.cluster.ClusterRegroup([3, 1], 7, "lease expired")
    assert rg.dead_pids == [1, 3] and rg.generation == 7 and "generation=7" in str(rg)
    # the partial-restart loop's signal is not one the supervisor restarts on
    assert not isinstance(rg, P.sup._default_restart_on())


# ------------------------------------------------- shard-aware admission


def _ctl(P, **cfg):
    return P.sv.AdmissionController(P.sv.ServingConfig(max_queue=8, **cfg), metrics=P.svm.ServingMetrics())


def _shed_script(P):
    P.cluster.CLUSTER_HEALTH.mark_down([1], retry_after_s=2.0)
    ctl = _ctl(P)
    ctl.release(ctl.admit(shard=0))  # a healthy shard is unaffected
    with pytest.raises(P.sv.ShardUnavailable) as ei:
        ctl.admit(shard=1)
    ctl.release(ctl.admit())  # not pinned to a shard: answered
    e = ei.value
    return [e.status, e.reason, e.retry_after_s, ctl.metrics.snapshot()["shed_total"]]


def test_admit_sheds_down_shard_with_typed_503():
    got = _shed_script(T)
    T.cluster.CLUSTER_HEALTH.mark_all_up()
    assert got == _shed_script(J) == [503, "shard_unavailable", 2.0, {"shard_unavailable": 1}]


@BOTH
def test_admit_degrade_mode_serves_down_shard_degraded(P):
    P.cluster.CLUSTER_HEALTH.mark_down([1])
    ctl = _ctl(P, shed="degrade")
    t = ctl.admit(shard=1)
    assert t.degraded
    ctl.release(t)
    t = ctl.admit(shard=0)
    assert not t.degraded
    ctl.release(t)


@BOTH
def test_tenant_cap_beats_down_shard_deterministically(P):
    """A tenant at its inflight cap asking a down shard always sees its 429:
    the tenant gates run before the shard's health."""
    P.cluster.CLUSTER_HEALTH.mark_down([1], retry_after_s=2.0)
    ctl = _ctl(P)
    with P.ten.use_tenancy({"quotas": {"acme": {"inflight": 1}}}):
        held = ctl.admit(shard=0, tenant="acme")
        for _ in range(10):
            with pytest.raises(P.sv.TenantRateLimited) as ei:
                ctl.admit(shard=1, tenant="acme")
            assert (ei.value.status, ei.value.reason, ei.value.tenant) == (429, "tenant_rate_limited", "acme")
        ctl.release(held)


@BOTH
def test_under_cap_tenant_still_sheds_down_shard(P):
    """Under its cap the same tenant gets the shard's 503, and the shed
    admits never hold its inflight slot."""
    P.cluster.CLUSTER_HEALTH.mark_down([1], retry_after_s=2.0)
    ctl = _ctl(P)
    with P.ten.use_tenancy({"quotas": {"acme": {"inflight": 1}}}):
        for _ in range(10):
            with pytest.raises(P.sv.ShardUnavailable) as ei:
                ctl.admit(shard=1, tenant="acme")
            assert (ei.value.status, ei.value.reason) == (503, "shard_unavailable")
        ctl.release(ctl.admit(shard=0, tenant="acme"))


# ------------------------------------------- cluster-channel chaos family


@BOTH
def test_chaos_channel_drop_and_duplicate_verdicts(P):
    P.chaos.activate([{"site": "cluster.send", "action": "drop", "hit": 2},
                      {"site": "cluster.send", "action": "duplicate", "hit": 3}])
    assert [P.chaos.channel("cluster.send") for _ in range(4)] == [None, "drop", "duplicate", None]


@BOTH
def test_chaos_channel_partition_is_sticky_until_expiry(P):
    P.chaos.activate([{"site": "cluster.send", "action": "partition", "duration_s": 0.2}])
    assert P.chaos.channel("cluster.send") == "drop"  # arms the partition
    assert P.chaos.channel("cluster.send") == "drop"  # sticky
    assert P.chaos.channel("other.site") is None  # per site
    time.sleep(0.25)
    assert P.chaos.channel("cluster.send") is None  # healed


@BOTH
def test_chaos_channel_filters_on_process_and_generation(P, monkeypatch):
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    monkeypatch.setenv("PATHWAY_CLUSTER_GENERATION", "0")
    P.chaos.activate([{"site": "cluster.send", "action": "drop", "process": 1, "generation": 0}])
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "0")
    assert P.chaos.channel("cluster.send") is None  # another process
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    monkeypatch.setenv("PATHWAY_CLUSTER_GENERATION", "1")
    assert P.chaos.channel("cluster.send") is None  # a partial restart moved the generation on
    monkeypatch.setenv("PATHWAY_CLUSTER_GENERATION", "0")
    assert P.chaos.channel("cluster.send") == "drop"


class _FakeSock:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def _wire_script(P):
    P.chaos.activate([{"site": "cluster.send", "action": "drop", "hit": 1}])
    s = _FakeSock()
    P.mp._send_frame(s, {"op": "poll", "seq": 3}, threading.Lock())
    dropped = s.data
    P.chaos.activate([{"site": "cluster.send", "action": "duplicate", "hit": 1}])
    P.mp._send_frame(s, {"op": "poll", "seq": 3})
    P.chaos.deactivate()
    return dropped, s.data


def test_send_frame_applies_channel_verdicts():
    """A dropped frame never reaches the wire, a duplicated one goes twice;
    the port's frames are the reference's bytes."""
    got = _wire_script(T)
    assert got == _wire_script(J)
    dropped, wire = got
    (n,) = T.mp._HDR.unpack(wire[: T.mp._HDR.size])
    assert dropped == b"" and len(wire) == 2 * (T.mp._HDR.size + n)
    assert wire[: T.mp._HDR.size + n] == wire[T.mp._HDR.size + n:]


@BOTH
def test_deterministic_seed_stable_per_plan_and_process(P, monkeypatch):
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    P.chaos.activate([{"site": "cluster.send", "action": "drop"}])
    s1 = P.chaos.deterministic_seed()
    assert s1 is not None and s1 == P.chaos.deterministic_seed()
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "2")
    assert P.chaos.deterministic_seed() != s1
    P.chaos.deactivate()
    assert P.chaos.deterministic_seed() is None


def test_handshake_and_frames_match_the_reference(monkeypatch):
    """The cluster token, the JSON handshake frame and the graph signature
    are the reference's, so the wire protocol is the same."""
    assert T.mp._HDR.format == J.mp._HDR.format and T.mp._MAX_HELLO == J.mp._MAX_HELLO
    a, b = _FakeSock(), _FakeSock()
    hello = {"op": "hello", "pid": 1, "threads": 2, "sig": "x", "token": "t", "replay_frontier": -1, "gen": 0}
    T.mp._send_json(a, hello)
    J.mp._send_json(b, hello)
    assert a.data == b.data
    monkeypatch.delenv("PATHWAY_CLUSTER_TOKEN", raising=False)
    for P in (J, T):  # no token, no cluster
        with pytest.raises(RuntimeError, match="shared secret"):
            P.mp.cluster_token()


# ----------------------------------------------- durable generation token


@BOTH
def test_cluster_generation_bump_is_durable(P, tmp_path):
    cfg = P.pw.persistence.Config.simple_config(P.pw.persistence.Backend.filesystem(str(tmp_path / "p")))
    p = P.persist.EnginePersistence(cfg)
    assert p.cluster_generation() == 0
    assert p.bump_cluster_generation() == 1
    assert p.bump_cluster_generation() == 2
    p.close()
    p2 = P.persist.EnginePersistence(cfg)
    assert p2.cluster_generation() == 2
    p2.close()


@BOTH
def test_cluster_generation_visible_from_worker_namespace(P, tmp_path, monkeypatch):
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)
    cfg = P.pw.persistence.Config.simple_config(P.pw.persistence.Backend.filesystem(str(tmp_path / "p")))
    p0 = P.persist.EnginePersistence(cfg)
    p0.bump_cluster_generation()
    p0.close()
    # a worker keeps its logs under proc-<pid>, and reads the coordinator's
    # generation from the base namespace
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    pw1 = P.persist.EnginePersistence(cfg)
    assert pw1.cluster_generation() == 1
    pw1.close()


# ------------------------------------------------- metrics plane gating


def _lines_script(P):
    out = ["\n".join(P.http.MonitoringHttpServer._cluster_lines())]
    P.cluster.CLUSTER_METRICS.record_barrier(generation=1)
    P.cluster.CLUSTER_HEALTH.mark_down([3])
    out.append("\n".join(P.http.MonitoringHttpServer._cluster_lines()))
    P.cluster.CLUSTER_METRICS.reset()
    P.cluster.CLUSTER_HEALTH.mark_all_up()
    P.cluster.CLUSTER_METRICS.record_lease_expired(1)
    P.cluster.CLUSTER_METRICS.record_partial_restart(1)
    P.cluster.CLUSTER_METRICS.record_fenced_write(2)
    P.cluster.CLUSTER_METRICS.record_fenced_write(2)
    out.append("\n".join(P.http.MonitoringHttpServer._cluster_lines()))
    return out


def test_metrics_cluster_lines_gated_and_per_process():
    got = _lines_script(T)
    assert got == _lines_script(J)
    idle, barrier, counters = got
    assert idle == ""
    assert "pathway_cluster_barriers_total 1" in barrier and "pathway_cluster_generation 1" in barrier
    assert 'pathway_cluster_shard_down{shard="3"} 1' in barrier
    assert 'pathway_cluster_lease_expiries_total{process="1"} 1' in counters
    assert "pathway_cluster_partial_restarts_total 1" in counters
    assert "pathway_cluster_fenced_writes_total 2" in counters


@BOTH
@pytest.mark.parametrize("keep,want", [("2", 2), ("0", 4)], ids=["keep2", "keep_all"])
def test_flight_recorder_keep_prunes_old_dumps(P, tmp_path, monkeypatch, keep, want):
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER_KEEP", keep)
    fr = P.fr.FlightRecorder(size=16, enabled=True)
    d = str(tmp_path / "bb")
    paths = []
    for i in range(4):
        fr.record("epoch.begin", t=i)
        paths.append(fr.dump(f"r{i}", directory=d))
    assert P.fr.list_dumps(d) == sorted(paths[-want:])


# --------------------------------------------- multi-process, the port


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_")}
    env.update(JAX_PLATFORMS="cpu", PATHWAY_CLUSTER_TOKEN="fault-domain-test",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _cluster(cwd, prog: str, processes: int, extra_env: dict, tries: int = 3):
    """Start ``processes`` processes of ``prog``, wait for process 0 and
    return (processes, process 0's stderr); a cluster whose port was taken
    is formed again on a new one."""
    for attempt in range(tries):
        env = _env({"PATHWAY_THREADS": 1, "PATHWAY_PROCESSES": processes, "PATHWAY_FIRST_PORT": _free_port(),
                    **extra_env})
        # each process leads its own session, so the workers process 0
        # respawns (which share its stderr pipe) are killed with it
        procs = [subprocess.Popen([sys.executable, prog], env={**env, "PATHWAY_PROCESS_ID": str(pid)},
                                  cwd=str(cwd), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                                  start_new_session=True)
                 for pid in range(processes)]
        try:
            _, err0 = procs[0].communicate(timeout=PROC_TIMEOUT)
            for p in procs[1:]:  # a worker exits once it has seen END
                p.communicate(timeout=30)
        finally:
            for p in procs:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                if p.returncode is None:
                    p.communicate()
        if attempt + 1 < tries and "Address already in use" in err0:
            continue
        return procs, err0
    raise AssertionError("unreachable")


KILL_PROGRAM = textwrap.dedent(
    """
    import os, time
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io._connector import input_table_from_reader

    N = int(os.environ["KP_N"])
    NPROC = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    PID = os.environ.get("PATHWAY_PROCESS_ID", "0")
    WORDS = ["cat", "dog", "bird"]

    class S(pw.Schema):
        word: str
        i: int

    def reader(ctx):
        start = int(ctx.offsets.get("pos", 0))
        for i in range(N):
            if i % NPROC != ctx.process_id or i < start:
                continue
            ctx.insert({"word": WORDS[i % 3], "i": i}, offsets={"pos": i + 1})
            ctx.commit()
            time.sleep(0.01)

    t = input_table_from_reader(S, reader, name="slow_src", parallel_readers=True, persistent_id="kp",
                                supports_offsets=True, autocommit_duration_ms=50)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, os.environ["KP_OUT"] + ".counts." + PID)
    pw.io.jsonlines.write(t, os.environ["KP_OUT"] + ".rows." + PID)
    pw.run(monitoring_level="none", cluster_lease_ms=1500, persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.environ["KP_STORE"]), snapshot_interval_ms=200))
    """
)


def _net(path: str, key: str) -> dict:
    state: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["diff"] > 0:
                state[rec[key]] = rec
            else:
                state.pop(rec[key], None)
    return state


def test_sigkilled_worker_is_respawned_alone_and_rows_delivered_once(tmp_path):
    """Worker 1 dies (SIGKILL at its third logged feed); the coordinator
    turns the lost connection into a partial restart: the durable
    generation goes 0 -> 1, only worker 1 is respawned (its replacement
    presents the new generation, so the generation-0 chaos rule no longer
    fires), and every row is delivered exactly once, with the counts of an
    uninterrupted run."""
    prog = tmp_path / "kp.py"
    prog.write_text(KILL_PROGRAM)
    n = 90
    outs = {}
    for tag, chaos in (("plain", None), ("killed", {"site": "worker.after_feed_log", "process": 1,
                                                     "generation": 0, "hit": 3, "action": "kill"})):
        out, store = str(tmp_path / tag), str(tmp_path / f"store_{tag}")
        extra = {"KP_N": n, "KP_OUT": out, "KP_STORE": store, "PATHWAY_CLUSTER_RESPAWN": "1",
                 "PATHWAY_FLIGHT_RECORDER_DIR": tmp_path / f"bb_{tag}"}
        if chaos:
            extra["PATHWAY_CHAOS"] = json.dumps(chaos)
        procs, err0 = _cluster(tmp_path, str(prog), 2, extra)
        assert procs[0].returncode == 0, err0[-3000:]
        outs[tag] = (out, store, procs, err0)
    plain, killed = outs["plain"], outs["killed"]
    assert plain[2][1].returncode == 0 and "partial restart" not in plain[3]
    assert killed[2][1].returncode == -signal.SIGKILL, killed[3][-3000:]
    assert killed[3].count("cluster partial restart") == 1, killed[3][-3000:]
    cfg = tpw.persistence.Config.simple_config(tpw.persistence.Backend.filesystem(killed[1]))
    p = T.persist.EnginePersistence(cfg)
    try:
        assert p.cluster_generation() == 1
    finally:
        p.close()
    counts = {w: r["n"] for w, r in _net(killed[0] + ".counts.0", "word").items()}
    assert counts == {w: r["n"] for w, r in _net(plain[0] + ".counts.0", "word").items()} == {
        "cat": 30, "dog": 30, "bird": 30}
    with open(killed[0] + ".rows.0") as f:
        rows = [json.loads(line) for line in f]
    assert all(r["diff"] == 1 for r in rows)
    assert sorted(r["i"] for r in rows) == list(range(n))  # each row once
    assert not os.path.exists(killed[0] + ".rows.1")


XT_PROGRAM = textwrap.dedent(
    """
    import os, threading, time
    import numpy as np
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io._connector import input_table_from_reader
    from pathway_tpu_torch.ops.tiered_knn import TierConfig, TieredKnnIndex

    N = int(os.environ["XT_N"])
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    NPROC = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    GEN = int(os.environ.get("PATHWAY_CLUSTER_GENERATION", "0") or 0)
    WORDS = ["cat", "dog", "bird"]
    joined = threading.Event()  # set by the reader, which starts once the worker joined the cluster

    def tier_churn():
        joined.wait()
        rng = np.random.default_rng(7)
        centers = rng.normal(size=(4, 16)).astype(np.float32) * 2.0
        vecs = (centers[rng.integers(0, 4, size=100)] + rng.normal(size=(100, 16))).astype(np.float32)
        qs = (centers[rng.integers(0, 4, size=4)] + rng.normal(size=(4, 16))).astype(np.float32)
        idx = TieredKnnIndex(dim=16, reserved_space=128, device="cpu",
                             tiers=TierConfig(n_clusters=4, n_probe=4, cold_dtype="f32"))
        idx.add_batch_arrays(list(range(100)), vecs)
        while True:
            idx.force_demote()
            for _ in range(8):
                idx.search_batch(qs, 5)
            # generation 0: the chaos rule SIGKILLs the process here, inside
            # the promotion; the respawned worker (GEN > 0) completes it
            idx.maybe_rebalance(force=True)
            if GEN > 0:
                got = idx.search_batch(np.asarray(vecs, np.float32), 1)
                found = sorted(row[0][0] for row in got if row)
                ok = found == list(range(100)) and idx.hot_docs() + idx.cold_docs() == 100
                with open(os.environ["XT_MARKER"], "w") as f:
                    f.write("ok" if ok else f"bad coverage={len(found)}")
                return

    churn = None
    if PID == 1:
        churn = threading.Thread(target=tier_churn, daemon=False)
        churn.start()

    class S(pw.Schema):
        word: str

    def reader(ctx):
        joined.set()
        start = int(ctx.offsets.get("pos", 0))
        for i in range(N):
            if i % NPROC != ctx.process_id or i < start:
                continue
            ctx.insert({"word": WORDS[i % 3]}, offsets={"pos": i + 1})
            ctx.commit()
            time.sleep(0.01)

    t = input_table_from_reader(S, reader, name="slow_src", parallel_readers=True, persistent_id="xt",
                                supports_offsets=True, autocommit_duration_ms=50)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, os.environ["XT_OUT"] + "." + str(PID))
    pw.run(monitoring_level="none", persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.environ["XT_STORE"]), snapshot_interval_ms=200))
    if churn is not None:
        churn.join(timeout=60)
    """
)


@pytest.mark.parametrize("hit", [1, 2])
def test_sigkill_in_tier_promotion_partial_restart(tmp_path, hit):
    """Worker 1 is SIGKILLed at the ``hit``-th visit to ``index.tier.promote``
    (at 2 the hot slab is torn mid-move); the coordinator partial-restarts
    it, the stream ends with exact counts, and the respawned worker
    completes a clean promotion cycle. The churn starts once the worker
    joined the cluster (its partitioned reader runs): the reference's
    program can die before it joins, and its coordinator then waits out
    the formation limit."""
    prog = tmp_path / "xt.py"
    prog.write_text(XT_PROGRAM)
    out, marker = str(tmp_path / "out.jsonl"), str(tmp_path / "tier.ok")
    spec = {"site": "index.tier.promote", "process": 1, "generation": 0, "hit": hit, "action": "kill"}
    procs, err0 = _cluster(tmp_path, str(prog), 2, {
        "XT_N": 120, "XT_OUT": out, "XT_STORE": tmp_path / "store", "XT_MARKER": marker,
        "PATHWAY_CLUSTER_LEASE_MS": 1500, "PATHWAY_CLUSTER_RESPAWN": "1", "PATHWAY_CHAOS": json.dumps(spec),
        "PATHWAY_FLIGHT_RECORDER_DIR": tmp_path / "blackbox"})
    assert procs[1].returncode == -signal.SIGKILL, (procs[1].returncode, err0[-3000:])
    assert procs[0].returncode == 0, err0[-3000:]
    assert "cluster partial restart" in err0
    assert {w: r["n"] for w, r in _net(out + ".0", "word").items()} == {"cat": 40, "dog": 40, "bird": 40}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not os.path.exists(marker):
        time.sleep(0.2)
    with open(marker) as f:
        assert f.read() == "ok"


MESH_PROGRAM = textwrap.dedent(
    """
    import json, os, sys
    import torch
    import torch.distributed as dist
    from pathway_tpu_torch.parallel.sharding import host_mesh_from_env

    mesh = host_mesh_from_env(device="cpu")
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    print(json.dumps({"shape": mesh.shape, "devices": [str(d) for d in mesh.data_devices()],
                      "rank": dist.get_rank(), "world": dist.get_world_size(), "sum": float(x)}))
    dist.destroy_process_group()
    """
)


def test_host_mesh_from_env_forms_a_gloo_group(tmp_path):
    """Two processes of one cluster join a ``gloo`` process group through
    ``host_mesh_from_env`` (the rendezvous at ``127.0.0.1:PATHWAY_FIRST_PORT``)
    and get the global mesh: one data shard per process."""
    prog = tmp_path / "mesh.py"
    prog.write_text(MESH_PROGRAM)
    for attempt in range(3):
        env = _env({"PATHWAY_PROCESSES": 2, "PATHWAY_FIRST_PORT": _free_port()})
        procs = [subprocess.Popen([sys.executable, str(prog)], env={**env, "PATHWAY_PROCESS_ID": str(pid)},
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in range(2)]
        try:
            results = [p.communicate(timeout=PROC_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if all(p.returncode == 0 for p in procs) or attempt == 2 or not any(
                "ddress already in use" in err for _, err in results):
            break
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in results]
    assert [g["rank"] for g in got] == [0, 1] and all(g["world"] == 2 and g["sum"] == 3.0 for g in got)
    assert all(g["shape"] == {"data": 2, "model": 1} and g["devices"] == ["cpu", "cpu"] for g in got)


def _formed_coordinator(monkeypatch, lease_ms: float):
    """A 2-process ``CoordinatorCluster`` of the port formed in this process
    against a hand-driven worker socket."""
    monkeypatch.setenv("PATHWAY_CLUSTER_TOKEN", "fault-domain-test")
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    engine = GraphRunner().engine
    port = _free_port()
    box = {}
    former = threading.Thread(target=lambda: box.setdefault("c", T.mp.CoordinatorCluster(
        [engine], processes=2, first_port=port, accept_timeout=30.0, lease_ms=lease_ms)))
    former.start()
    deadline = time.monotonic() + 30
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
            break
        except OSError:
            assert time.monotonic() < deadline, "the coordinator never listened"
            time.sleep(0.05)
    T.mp._send_json(sock, {"op": "hello", "pid": 1, "threads": 1, "sig": T.mp._graph_sig(engine),
                           "token": "fault-domain-test", "replay_frontier": -1, "gen": 0})
    assert T.mp._recv_json(sock)["op"] == "welcome"
    former.join(timeout=30)
    return box["c"], sock


def test_heartbeats_queued_before_a_request_do_not_read_as_its_loss(monkeypatch):
    """While the coordinator sweeps its own shards for longer than a third
    of a lease, the worker's heartbeats (still reporting the last request)
    queue in the socket. Read after the next request left, they say nothing
    of it: the port skips them by their send time, and the reply is taken.
    Two heartbeats written after the request that still miss it do mean a
    lost frame."""
    cluster, sock = _formed_coordinator(monkeypatch, lease_ms=3000)
    try:
        before = time.time()
        for _ in range(3):  # queued during a long local sweep
            T.mp._send(sock, {"op": "hb", "gen": 0, "got": 0, "done": 0, "at": before})
        time.sleep(0.01)
        cluster._send_worker(1, {"op": "poll"})
        frame = T.mp._recv(sock)
        while frame["op"] == "hb":  # the coordinator's own heartbeats
            frame = T.mp._recv(sock)
        assert frame["seq"] == 1
        T.mp._send(sock, {"op": "poll_reply", "gen": 0, "seq": 1})
        assert cluster._recv_worker(1)["op"] == "poll_reply"
        cluster._send_worker(1, {"op": "poll"})
        for _ in range(2):  # written after seq 2 left, still without it
            T.mp._send(sock, {"op": "hb", "gen": 0, "got": 1, "done": 1, "at": time.time()})
        with pytest.raises(T.cluster.WorkerLost, match="request seq 2 lost in transit"):
            cluster._recv_worker(1)
    finally:
        cluster._stop_heartbeats()
        cluster._close_conns(None)
        sock.close()
