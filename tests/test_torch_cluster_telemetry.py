"""The cluster telemetry plane of the port: one ``/metrics`` endpoint, every
worker labelled (the reference's ``tests/test_cluster_telemetry.py``).

In-process sharded runs sample every shard's engine; the cases run on both
packages and render the same series. In a multi-process cluster of the
port the workers piggyback the same per-worker stats on their protocol
replies (they open no listener of their own), and the coordinator's
``/metrics`` and ``/status`` show every worker under ``worker=`` labels. A
worker killed by the chaos plan leaves a flight-recorder dump that names it
and its last fed epochs, and ``python -m pathway_tpu_torch blackbox show``
renders it. Each process has its own wall-clock limit."""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request
from types import SimpleNamespace

import pytest

import pathway_tpu as jpw
import pathway_tpu.internals.graph_runner as j_gr
import pathway_tpu.internals.http_monitoring as j_http
import pathway_tpu.internals.monitoring as j_mon
import pathway_tpu_torch as tpw
import pathway_tpu_torch.internals.graph_runner as t_gr
import pathway_tpu_torch.internals.http_monitoring as t_http
import pathway_tpu_torch.internals.monitoring as t_mon
from pathway_tpu import tracing as j_tr
from pathway_tpu.decode.metrics import DECODE_METRICS as J_DECODE
from pathway_tpu.freshness.plane import FRESHNESS as J_FRESH
from pathway_tpu.internals.chip_ledger import CHIP_LEDGER as J_CHIP
from pathway_tpu.internals.ledger import LEDGER as J_LEDGER
from pathway_tpu.ops.index_metrics import INDEX_METRICS as J_INDEX
from pathway_tpu.serving import SERVING_METRICS as J_SERVING
from pathway_tpu.tenancy.metrics import TENANCY_METRICS as J_TENANCY
from pathway_tpu_torch import tracing as t_tr
from pathway_tpu_torch.decode.metrics import DECODE_METRICS as T_DECODE
from pathway_tpu_torch.freshness.plane import FRESHNESS as T_FRESH
from pathway_tpu_torch.internals import flight_recorder as t_fr
from pathway_tpu_torch.internals.chip_ledger import CHIP_LEDGER as T_CHIP
from pathway_tpu_torch.internals.ledger import LEDGER as T_LEDGER
from pathway_tpu_torch.ops.index_metrics import INDEX_METRICS as T_INDEX
from pathway_tpu_torch.serving import SERVING_METRICS as T_SERVING
from pathway_tpu_torch.tenancy.metrics import TENANCY_METRICS as T_TENANCY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 120

J = SimpleNamespace(pw=jpw, gr=j_gr, http=j_http, mon=j_mon)
T = SimpleNamespace(pw=tpw, gr=t_gr, http=t_http, mon=t_mon)


def _reset_planes():
    """Every process-global registry of both packages whose activity adds
    series to ``/metrics``: one left active by an earlier file on the same
    worker (the HBM ledger, the tracing plane's stage histograms) would add
    its series to one package's scrape only."""
    for reg in (J_LEDGER, T_LEDGER, J_CHIP, T_CHIP, J_FRESH, T_FRESH, J_SERVING, T_SERVING, J_INDEX, T_INDEX,
                J_DECODE, T_DECODE, J_TENANCY, T_TENANCY, j_tr.TRACE_STORE, t_tr.TRACE_STORE, j_tr.TRACING_METRICS,
                t_tr.TRACING_METRICS):
        reg.reset()


@pytest.fixture(autouse=True)
def _planes_reset_before_each_case():
    _reset_planes()


def _series_lines(body: str) -> list[str]:
    return [ln for ln in body.splitlines() if ln and not ln.startswith("#")]


def _run_sharded_monitored(P, tmp_path, n_workers: int):
    t = P.pw.debug.table_from_markdown(
        """
        | word
      1 | cat
      2 | dog
      3 | cat
      4 | emu
      5 | dog
      6 | cat
        """
    )
    c = t.groupby(P.pw.this.word).reduce(P.pw.this.word, n=P.pw.reducers.count())
    P.pw.io.jsonlines.write(c, str(tmp_path / "out.jsonl"))
    runner = P.gr.GraphRunner(n_workers=n_workers)
    for table, sink in list(P.pw.parse_graph.outputs):
        sink["build"](runner, table)
    monitor = P.mon.StatsMonitor()
    runner.run(monitoring_callback=monitor.update)
    P.pw.clear_graph()
    return monitor


def _shape(body: str) -> list[str]:
    """The series' names and labels, values dropped (times and rates vary)."""
    return sorted(ln.rsplit(" ", 1)[0] for ln in _series_lines(body))


def _sharded_worker_series(tmp_path) -> dict:
    """Each package's two-worker scrape: every line labelled, the per-worker
    epoch / rows / restarts series present; -> its ``pathway_(epoch|rows_|
    worker_)`` series' names and labels by package."""
    got = {}
    for tag, P in (("jax", J), ("torch", T)):
        (tmp_path / tag).mkdir()
        monitor = _run_sharded_monitored(P, tmp_path / tag, n_workers=2)
        workers = monitor.snapshot.workers
        assert sorted(workers) == [0, 1]
        for w in workers.values():
            assert {"epoch", "rows_in", "rows_out", "pid", "rows_per_s"} <= set(w)
        body = P.http.MonitoringHttpServer(monitor, port=0)._prometheus()
        lines = _series_lines(body)
        assert lines and all('worker="' in ln for ln in lines), body
        for wid in (0, 1):
            assert f'pathway_epoch{{worker="{wid}"}}' in body
            assert f'pathway_rows_input_total{{worker="{wid}"}}' in body
            assert f'pathway_worker_restarts_total{{worker="{wid}"}}' in body
        got[tag] = {ln for ln in _shape(body) if re.match(r"pathway_(epoch|rows_|worker_)", ln)}
    return got


def test_sharded_metrics_label_every_worker(tmp_path):
    got = _sharded_worker_series(tmp_path)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("leaked", ["jax", "torch"])
def test_sharded_metrics_after_one_package_left_its_ledger_active(tmp_path, leaked):
    """An earlier file left one package's HBM ledger active (as
    ``tests/test_torch_profiler.py``'s encoder case left the port's); the
    reset each case starts with takes it back, and the scrapes agree."""
    (J_LEDGER if leaked == "jax" else T_LEDGER).update("weights", "earlier-file", 1 << 20)
    _reset_planes()
    got = _sharded_worker_series(tmp_path)
    assert got["torch"] == got["jax"]


def test_sharded_metrics_with_both_hbm_ledgers_active(tmp_path):
    """With both packages' HBM ledgers active, both scrapes carry each
    worker's ``pathway_worker_hbm_bytes`` alike."""
    for ledger in (J_LEDGER, T_LEDGER):
        ledger.update("weights", "telemetry-test", 1 << 20)
    got = _sharded_worker_series(tmp_path)
    assert got["torch"] == got["jax"]
    assert {f'pathway_worker_hbm_bytes{{worker="{wid}"}}' for wid in (0, 1)} <= got["torch"]


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_sharded_status_json_has_workers_and_resilience(P, tmp_path):
    monitor = _run_sharded_monitored(P, tmp_path, n_workers=2)
    status = json.loads(P.http.MonitoringHttpServer(monitor, port=0)._status())
    assert sorted(status["workers"]) == ["0", "1"]
    assert "restarts_total" in status and "retries" in status
    assert status["pipeline"]["depth"] == 1 and "overlap_ratio" in status["pipeline"]


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_single_process_metrics_have_no_worker_labels(P, tmp_path):
    monitor = _run_sharded_monitored(P, tmp_path, n_workers=1)
    assert monitor.snapshot.workers == {}
    body = P.http.MonitoringHttpServer(monitor, port=0)._prometheus()
    assert 'worker="' not in body and "pathway_epoch " in body


# ------------------------------------------------- the port's clusters


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_cluster(tmp_path, program: str, extra_env: dict, processes: int = 2) -> list:
    prog = tmp_path / "prog.py"
    prog.write_text(program)
    port = _free_port()
    procs = []
    for pid in range(processes):
        env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_")}
        env.update(WC_IN=str(tmp_path / "in"), WC_OUT=str(tmp_path / "out.jsonl"), PATHWAY_THREADS="1",
                   PATHWAY_PROCESSES=str(processes), PATHWAY_PROCESS_ID=str(pid), PATHWAY_FIRST_PORT=str(port),
                   PATHWAY_CLUSTER_TOKEN="telemetry-test", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        env.update({k: str(v) for k, v in extra_env.items()})
        procs.append(subprocess.Popen([sys.executable, str(prog)], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    return procs


def _reap(procs) -> list[str]:
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=PROC_TIMEOUT)[1])
        except subprocess.TimeoutExpired:
            p.kill()
            errs.append(p.communicate()[1])
    return errs


STREAM_PROGRAM = textwrap.dedent(
    """
    import os, threading, time
    import pathway_tpu_torch as pw

    class S(pw.Schema):
        word: str

    t = pw.io.jsonlines.read(os.environ["WC_IN"], schema=S, mode="streaming", autocommit_duration_ms=100)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pid = os.environ.get("PATHWAY_PROCESS_ID", "0")
    pw.io.jsonlines.write(c, os.environ["WC_OUT"] + "." + pid)

    def stop():
        time.sleep(float(os.environ["RUN_S"]))
        os._exit(0)

    threading.Thread(target=stop, daemon=True).start()
    pw.run(monitoring_level="none", with_http_server=pid == "0", monitoring_http_port=int(os.environ["MET_PORT"]))
    """
)


def test_multiprocess_scrape_covers_every_worker(tmp_path):
    """Scrape the coordinator's ``/metrics`` while a 2-process cluster runs:
    worker 1's stats came on its protocol replies, so both shards show up
    under ``worker=`` labels on the one endpoint, and ``/status`` has them
    as JSON."""
    (tmp_path / "in").mkdir()
    words = ["cat", "dog", "cat", "bird", "dog", "cat", "emu", "fox"] * 6
    (tmp_path / "in" / "words.jsonl").write_text("".join(json.dumps({"word": w}) + "\n" for w in words))
    for attempt in range(3):
        met_port = _free_port()
        procs = _spawn_cluster(tmp_path, STREAM_PROGRAM, {"MET_PORT": met_port, "RUN_S": 8.0})
        body = candidate = None
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and procs[0].poll() is None:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{met_port}/metrics", timeout=2) as resp:
                        candidate = resp.read().decode()
                except OSError:
                    time.sleep(0.1)
                    continue
                if 'worker="0"' in candidate and 'worker="1"' in candidate:
                    body = candidate
                    with urllib.request.urlopen(f"http://127.0.0.1:{met_port}/status", timeout=2) as resp:
                        status = json.loads(resp.read().decode())
                    break
                time.sleep(0.1)
        finally:
            errs = _reap(procs)
        if body is not None or attempt == 2 or "ddress already in use" not in errs[0]:
            break
    assert body is not None, f"never saw both workers:\n{candidate!r}\n{errs[0][-2000:]}"
    assert all('worker="' in ln for ln in _series_lines(body)), body
    for wid in (0, 1):
        assert f'pathway_epoch{{worker="{wid}"}}' in body
    assert sorted(status["workers"]) == ["0", "1"]
    assert status["workers"]["1"]["pid"] != status["workers"]["0"]["pid"]


CHAOS_PROGRAM = textwrap.dedent(
    """
    import os, time
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io._connector import input_table_from_reader

    NPROC = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    WORDS = ["cat", "dog", "bird"]

    class S(pw.Schema):
        word: str

    def reader(ctx):
        for i in range(90):
            if i % NPROC != ctx.process_id:
                continue
            ctx.insert({"word": WORDS[i % 3]}, offsets={"pos": i + 1})
            ctx.commit()
            time.sleep(0.01)

    t = input_table_from_reader(S, reader, name="slow_src", parallel_readers=True, persistent_id="ct",
                                supports_offsets=True, autocommit_duration_ms=50)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pid = os.environ.get("PATHWAY_PROCESS_ID", "0")
    pw.io.jsonlines.write(c, os.environ["WC_OUT"] + "." + pid)
    pw.run(monitoring_level="none", persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.environ["WC_STORE"])))
    """
)


def test_killed_worker_leaves_flight_recorder_dump(tmp_path):
    """SIGKILL worker 1 right after it logged its third fed epoch: the chaos
    injector dumps the ring in-process before the signal, so a black-box
    file names the killed worker and its last fed epochs, and ``blackbox
    show`` renders the epoch transitions."""
    bb_dir = tmp_path / "blackbox"
    spec = json.dumps({"site": "worker.after_feed_log", "process": 1, "hit": 3, "action": "kill"})
    procs = _spawn_cluster(tmp_path, CHAOS_PROGRAM, {
        "PATHWAY_CHAOS": spec, "PATHWAY_FLIGHT_RECORDER_DIR": bb_dir, "WC_STORE": tmp_path / "store",
        "PATHWAY_CLUSTER_RESPAWN": "0", "PATHWAY_CLUSTER_LEASE_MS": 1500})
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and procs[1].poll() is None:
            time.sleep(0.1)
        assert procs[1].poll() == -signal.SIGKILL, "the chaos kill never fired"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        _reap(procs)
    dumps = t_fr.list_dumps(str(bb_dir))
    killed = [(p, d) for p in dumps for d in [t_fr.load_dump(p)] if d["process_id"] == 1]
    assert killed, f"no dump names the killed worker in {dumps}"
    path, data = killed[-1]
    assert data["reason"] == "chaos.kill"
    kinds = [e["kind"] for e in data["events"]]
    assert "feed.commit" in kinds and "chaos.hit" in kinds, kinds
    assert t_fr.last_epoch(data) is not None
    env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "blackbox", "show", path], capture_output=True,
                          text=True, env=env, timeout=PROC_TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert "epoch transitions:" in proc.stdout and "reason=chaos.kill" in proc.stdout
