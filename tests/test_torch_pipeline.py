"""The port's overlapped epoch pipeline, held against the JAX package.

The cases of ``tests/test_pipeline.py``: ``pipeline_depth=2`` stages epoch
N+1 while epoch N executes, and every output is the strict loop's, on a
scripted stream, a live connector stream (byte for byte the reference's
sink file), the four-worker threaded cluster, ``PATHWAY_PIPELINE_DEPTH``,
and a persisted run and its restart; the overlap counters, the monitoring
snapshot's columns, the dashboard's overlap column and the ``/metrics``
series. The device-wait reading on a card (CUDA events around each sweep,
booked once they completed) is held with a stand-in ``torch.cuda``.
"""

from __future__ import annotations

import io
import json
import sys
import time
import types
import urllib.request

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import pipeline as tpipeline
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.resilience import chaos

STREAM = """
  | g | v | __time__ | __diff__
1 | a | 1 | 2        | 1
2 | b | 2 | 2        | 1
3 | a | 3 | 4        | 1
4 | c | 4 | 4        | 1
2 | b | 2 | 6        | -1
5 | a | 5 | 6        | 1
3 | a | 3 | 8        | -1
"""
WORDS = ["cat", "dog", "bird", "cat", "dog", "cat", "emu", "dog"]
FINAL = {"cat": 3, "dog": 3, "bird": 1, "emu": 1}


@pytest.fixture(autouse=True)
def _fresh():
    chaos.deactivate()
    yield
    chaos.deactivate()
    jpw.clear_graph()
    tpw.clear_graph()


def _scripted(pw):
    t = pw.debug.table_from_markdown(STREAM)
    return t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v), n=pw.reducers.count(),
                                       tup=pw.reducers.sorted_tuple(pw.this.v))


def _run_captured(pw, n_workers: int, depth: int):
    runner = (JRunner if pw is jpw else TRunner)(n_workers=n_workers, pipeline_depth=depth)
    cap, names = runner.capture(_scripted(pw))
    runner.run()
    pw.clear_graph()
    return sorted(cap.state.values()), names, runner


def _build_wordcount(pw, out: str, store: str | None = None):
    """One epoch per row (a commit, then a wait until the engine took it):
    runs compare byte for byte at either depth."""
    conn = sys.modules[pw.__name__ + ".io._connector"]

    class S(pw.Schema):
        word: str

    def reader(ctx):
        for i, w in enumerate(WORDS):
            if i < int(ctx.offsets.get("pos", 0)):
                continue
            ctx.insert({"word": w}, offsets={"pos": i + 1})
            ctx.commit()
            deadline = time.monotonic() + 2.0
            while ctx.session.pending() and time.monotonic() < deadline:
                time.sleep(0.002)

    t = conn.input_table_from_reader(S, reader, name="wsrc", persistent_id="w" if store else None,
                                     supports_offsets=True, autocommit_duration_ms=10)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, out)
    return pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store)) if store else None


def _net(text: str) -> dict:
    state: dict = {}
    for line in text.splitlines():
        rec = json.loads(line)
        if rec["diff"] > 0:
            state[rec["word"]] = rec["n"]
        else:
            state.pop(rec["word"], None)
    return state


def _live(pw, tmp_path, tag, **run_kw) -> str:
    out = str(tmp_path / f"{tag}_{pw.__name__}.jsonl")
    cfg = _build_wordcount(pw, out, run_kw.pop("store", None))
    pw.run(monitoring_level="none", persistence_config=cfg, **run_kw)
    pw.clear_graph()
    with open(out) as f:
        return f.read()


@pytest.mark.parametrize("n_workers", [1, 4])
def test_scripted_stream_depth2_equals_depth1_and_the_reference(n_workers):
    want, jnames, _ = _run_captured(jpw, 1, 1)
    for depth in (1, 2):
        got, names, _ = _run_captured(tpw, n_workers, depth)
        assert names == jnames and got == want


def test_live_stream_depth2_byte_identical_to_the_reference(tmp_path):
    ref = _live(jpw, tmp_path, "d1")
    assert ref and _net(ref) == FINAL
    assert _live(tpw, tmp_path, "d1") == ref
    assert _live(tpw, tmp_path, "d2", pipeline_depth=2) == ref


def test_depth1_never_enters_the_pipeline():
    _, _, runner = _run_captured(tpw, 1, 1)
    assert runner.engine.pipeline_stats is None


def test_env_var_sets_depth(monkeypatch, tmp_path):
    monkeypatch.setenv("PATHWAY_PIPELINE_DEPTH", "2")
    runners = []
    real = TRunner.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        runners.append(self)

    monkeypatch.setattr(TRunner, "__init__", init)
    assert _net(_live(tpw, tmp_path, "env")) == FINAL
    assert runners[-1].engine.pipeline_stats is not None and runners[-1].engine.pipeline_depth == 2


def test_depth2_overlap_counters_populated():
    _, _, runner = _run_captured(tpw, 1, 2)
    d = runner.engine.pipeline_stats.as_dict()
    assert d["depth"] == 2 and d["staged_epochs"] >= 2 and d["executed_epochs"] == d["staged_epochs"]
    assert d["host_prep_s"] >= 0.0 and d["overlap_ratio"] >= 0.0 and d["overlap_s"] <= d["host_prep_s"] + 1e-9
    # on the CPU the device wait is wall minus the executor's thread time
    assert d["device_wait_events_s"] == 0.0 and d["device_wait_s"] == d["device_wait_cpu_s"] >= 0.0


def test_monitoring_snapshot_carries_pipeline_columns(tmp_path):
    from pathway_tpu_torch.internals.monitoring import StatsMonitor
    from pathway_tpu_torch.internals.parse_graph import G

    _build_wordcount(tpw, str(tmp_path / "mon.jsonl"))
    mon = StatsMonitor()
    runner = TRunner(n_workers=1, pipeline_depth=2)
    for table, sink in list(G.outputs):
        sink["build"](runner, table)
    runner.run(monitoring_callback=mon.update)
    snap = mon.snapshot
    assert snap.pipeline_depth == 2 and snap.host_prep_s >= 0.0 and snap.device_wait_s >= 0.0 and snap.rows_in > 0


def test_dashboard_gains_overlap_column():
    from rich.console import Console

    bodies = []
    for mod in ("pathway_tpu.internals.monitoring", "pathway_tpu_torch.internals.monitoring"):
        m = __import__(mod, fromlist=["x"])
        mon = m.StatsMonitor()
        mon.snapshot = m.StatsSnapshot(time=3, rows_in=10, rows_out=8, pipeline_depth=2, host_prep_s=0.12,
                                       device_wait_s=0.4, overlap_ratio=0.83)
        entry = m.OperatorEntry(name="groupby")
        entry.rows_in, entry.rows_out = 10, 8
        mon.operators[1] = entry
        console = Console(file=io.StringIO(), width=200)
        console.print(m.build_dashboard(mon, time.monotonic()))
        body = console.file.getvalue()
        assert "overlap ratio" in body and "epoch pipeline (depth 2)" in body and "0.83" in body
        mon.snapshot = m.StatsSnapshot(time=3, rows_in=10, rows_out=8)  # depth 1: the column stays hidden
        console = Console(file=io.StringIO(), width=200)
        console.print(m.build_dashboard(mon, time.monotonic()))
        assert "overlap ratio" not in console.file.getvalue()
        bodies.append(body.count("\n"))
    assert bodies[1] == bodies[0]


def test_prometheus_exposes_pipeline_series():
    from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer
    from pathway_tpu_torch.internals.monitoring import StatsMonitor

    monitor = StatsMonitor()
    runner = TRunner(n_workers=1, pipeline_depth=2)
    runner.capture(_scripted(tpw))
    server = MonitoringHttpServer(monitor, port=0)
    server.start()
    try:
        runner.run(monitoring_callback=monitor.update)
        body = urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=5).read().decode()
    finally:
        server.stop()
    for series in ("pathway_host_prep_seconds", "pathway_device_wait_seconds", "pathway_pipeline_overlap_ratio",
                   "pathway_pipeline_depth 2"):
        assert series in body


@pytest.mark.parametrize("depth", [1, 2])
def test_persistence_clean_run_then_replay(tmp_path, depth):
    """A clean persisted run delivers everything; a restart from the same
    store re-delivers nothing, at either depth, as the reference's does."""
    for pw in (jpw, tpw):
        store = str(tmp_path / f"store_{pw.__name__}")
        first = _live(pw, tmp_path, "first", store=store, pipeline_depth=depth)
        again = _live(pw, tmp_path, "again", store=store, pipeline_depth=depth)
        assert _net(first) == FINAL and again == ""


def test_depth2_snapshot_while_staging_in_flight(tmp_path):
    """A chaos delay pins the stager inside the staging commit while the
    executor snapshots: the output's net state is the clean run's."""
    cfg = _build_wordcount(tpw, str(tmp_path / "delay.jsonl"), str(tmp_path / "store"))
    chaos.activate([{"site": "engine.before_stage_commit", "action": "delay", "delay_s": 0.03, "repeat": True}])
    tpw.run(monitoring_level="none", persistence_config=cfg, pipeline_depth=2)
    with open(tmp_path / "delay.jsonl") as f:
        assert _net(f.read()) == FINAL


class _Event:
    """A stand-in ``torch.cuda.Event``: complete once the test says so."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.at = None
        self.done = False

    def record(self):
        self.at = self.clock[0]

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return (end.at - self.at) * 1000.0


def test_sweep_clock_books_cuda_event_time_once_complete(monkeypatch):
    """On a card the sweep's device wait comes from a CUDA event pair on
    the executor's stream, booked once the end event completed (polled at
    the next sweep, drained at the end: no added synchronisation); the
    wall-minus-thread-time reading is kept beside it."""
    cuda = types.SimpleNamespace(is_available=lambda: True, is_initialized=lambda: True, Event=_Event)
    monkeypatch.setitem(sys.modules, "torch", types.SimpleNamespace(cuda=cuda))
    stats = tpipeline.PipelineStats(depth=2)
    clock = tpipeline._SweepClock(stats)
    clock.start()
    _Event.clock[0] = 0.25
    clock.stop(0.01)  # the first sweep's end event has not completed yet
    assert stats.device_wait_s == 0.0 and stats.device_wait_cpu_s == 0.0
    clock._pending[0][1].done = True
    clock.start()
    _Event.clock[0] = 0.75
    clock.stop(0.02)  # polls: books the first pair only
    assert stats.device_wait_events_s == pytest.approx(0.25) and stats.device_wait_cpu_s == pytest.approx(0.01)
    clock.drain()  # the end of the run waits for the rest
    assert stats.device_wait_events_s == pytest.approx(0.25 + 0.5) == stats.device_wait_s
    assert stats.device_wait_cpu_s == pytest.approx(0.03)
    off = tpipeline.PipelineStats(depth=2)
    monkeypatch.setitem(sys.modules, "torch", types.SimpleNamespace(
        cuda=types.SimpleNamespace(is_available=lambda: False)))
    cpu_clock = tpipeline._SweepClock(off)
    cpu_clock.start()
    cpu_clock.stop(0.04)
    assert off.device_wait_s == pytest.approx(0.04) and off.device_wait_events_s == 0.0
