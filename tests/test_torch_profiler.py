"""The port's run profiler against the JAX package, on the CPU: the
latency histogram, the build-vs-execute split of ``wrap_jit``, the engine
hooks (every node every epoch, one worker and two), the batch-UDF split,
event-time lag, the Chrome trace of ``pw.run(profile=)``, the bounded
event ring, and the encoder's kernel statistics behind the encode MFU
(``tests/test_profiler.py``'s cases).

Tolerances: counts, node sets, epochs and token counts equal; FLOPs equal
to the reference's formula; times only checked positive (this is a CPU)."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.internals.profiler as jprof
import pathway_tpu_torch as tpw
import pathway_tpu_torch.internals.profiler as tprof
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu.internals.ledger import LEDGER as JLEDGER
from pathway_tpu_torch.engine import dataflow as tdf
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.internals.ledger import LEDGER as TLEDGER


# the HBM ledger's state (``internals/ledger.DeviceLedger``)
_LEDGER_FIELDS = ("_rows", "_high", "_high_total", "_touched")


@pytest.fixture(autouse=True)
def _restore_hbm_ledgers():
    """Both packages' HBM ledgers as each test found them: a ledger left
    active by one package alone would add ``pathway_worker_hbm_bytes`` to
    that package's ``/metrics`` only, in a later file on the same worker."""
    saved = [(led, {f: copy.deepcopy(getattr(led, f)) for f in _LEDGER_FIELDS}) for led in (JLEDGER, TLEDGER)]
    yield
    for led, fields in saved:
        with led._lock:
            for f, v in fields.items():
                setattr(led, f, v)


WORDS = """
  | text
1 | to be or not to be
2 | that is the question
3 | to be is to do
"""


@pytest.fixture(autouse=True)
def _clean():
    jpw.clear_graph()
    tpw.clear_graph()
    tprof.ENCODER_KERNEL_STATS.reset()
    yield
    jpw.clear_graph()
    tpw.clear_graph()
    tprof.set_current_profiler(None)
    tprof.ENCODER_KERNEL_STATS.reset()


def _word_counts(pw):
    docs = pw.debug.table_from_markdown(WORDS)
    words = docs.select(word=pw.apply_with_type(str.split, list[str], pw.this.text)).flatten(pw.this.word)
    return words.groupby(pw.this.word).reduce(pw.this.word, count=pw.reducers.count())


def _profiled(pw, runner_cls, prof_mod, n_workers=1):
    runner = runner_cls(n_workers=n_workers)
    runner.capture(_word_counts(pw))
    prof = prof_mod.RunProfiler()
    runner.attach_profiler(prof)
    assert all(e.profiler is prof for e in runner._cluster_engines())
    runner.run()
    return runner, prof


# ------------------------------------------------------------------- units


def test_latency_histogram_buckets_and_cumulative():
    for mod in (jprof, tprof):
        h = mod.LatencyHistogram()
        for s in (0.0, 0.002, 1e9):
            h.observe(s)
        assert h.count == 3 and h.total == pytest.approx(0.002 + 1e9)
    assert tprof.HISTOGRAM_BOUNDS == jprof.HISTOGRAM_BOUNDS
    assert h.cumulative()[-1] == ("+Inf", 3) and len(h.cumulative()) == len(tprof.HISTOGRAM_BOUNDS) + 1


def test_wrap_jit_reports_compile_then_execute(monkeypatch):
    """The port's "compile" is a call that built a kernel library
    (``ops/_build._LIBS`` grew); every other call is "execute"."""
    from pathway_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_LIBS", {})
    prof = tprof.RunProfiler()
    tprof.set_current_profiler(prof)

    def fn(x, build=False):
        if build:
            _build._LIBS["knn_topk.cu"] = object()
        return x + 1

    wrapped = tprof.wrap_jit("test.fn", fn)
    assert wrapped(np.zeros(3), build=True).shape == (3,)
    assert wrapped(np.zeros(3)).shape == (3,)
    stats = prof.jit_stats["test.fn"]
    assert (stats["compiles"], stats["calls"], stats["rows"]) == (1, 1, 6)
    assert stats["compile_ns"] > 0 and stats["execute_ns"] > 0
    assert [e["name"] for e in prof.events] == ["test.fn [compile]", "test.fn [execute]"]


def test_wrap_jit_noop_without_profiler():
    assert tprof.current_profiler() is None
    calls = []
    wrapped = tprof.wrap_jit("n", lambda x: calls.append(x) or x)
    assert wrapped(5) == 5 and calls == [5] and wrapped.__wrapped__ is not None


def test_profiler_bounded_events():
    for mod in (jprof, tprof):
        prof = mod.RunProfiler(max_events=2)
        for _ in range(5):
            prof.record_jit("x", "execute", 100, 1)
        assert len(prof.events) == 2 and prof.dropped_events == 3
        assert prof.chrome_trace()["otherData"]["dropped_events"] == 3


# ---------------------------------------------------------- engine hooks


@pytest.mark.parametrize("n_workers", [1, 2])
def test_profiler_covers_every_engine_node_every_epoch(n_workers):
    runner, prof = _profiled(tpw, TRunner, tprof, n_workers)
    jrunner, jprofile = _profiled(jpw, JRunner, jprof, n_workers)
    assert {w for w, _ in prof.profiles} == set(range(n_workers))
    node_ids = {n.id for n in runner.engine.nodes}
    for w in range(n_workers):
        assert {nid for ww, nid in prof.profiles if ww == w} == node_ids
    for p in prof.profiles.values():
        assert p.epochs == 1 and p.histogram.count == p.epochs
    assert any(p.self_time_ns > 0 for p in prof.profiles.values())
    # the same operators, epochs and rows as the reference's profile
    shape = lambda pr: sorted((a["name"], a["epochs"], a["rows_in"], a["rows_out"])  # noqa: E731
                              for a in pr.by_operator().values())
    assert shape(prof) == shape(jprofile)
    if n_workers == 2:
        names = {m["args"]["name"] for m in prof.chrome_trace()["traceEvents"] if m["ph"] == "M"}
        assert {"worker 0", "worker 1"} <= names


def test_profiler_event_lag_for_watermark_nodes():
    import time as _time

    lag_target = 5.0
    now = _time.time()
    g = tdf.EngineGraph()
    src = g.static_table([(0, [(1, (now - lag_target,), 1), (2, (now - lag_target * 2,), 1)])])
    buf = tdf.BufferNode(g, threshold_fn=lambda k, r: r[0], time_fn=lambda k, r: r[0])
    buf.connect(src)
    prof = tprof.RunProfiler()
    g.profiler = prof
    g.run()
    bp = prof.profiles[(0, buf.id)]
    assert bp.event_lag_s == pytest.approx(lag_target, abs=2.0)
    assert prof.by_operator()[bp.key]["event_lag_s"] == pytest.approx(bp.event_lag_s)
    assert prof.profiles[(0, src.id)].event_lag_s is None


def _batch_apply(pw, runner_cls, prof_mod):
    t = pw.debug.table_from_markdown("""
      | a
    1 | 1
    2 | 2
    3 | 3
    """)

    @pw.udf(executor=pw.udfs.BatchExecutor(max_batch_size=8))
    def double(xs: list[int]) -> list[int]:
        return [x * 2 for x in xs]

    runner = runner_cls()
    runner.capture(t.select(b=double(pw.this.a)))
    prof = prof_mod.RunProfiler()
    runner.attach_profiler(prof)
    prof_mod.set_current_profiler(prof)
    try:
        runner.run()
    finally:
        prof_mod.set_current_profiler(None)
    return {k: (v["calls"], v["rows"]) for k, v in prof.jit_stats.items()}, prof


def test_batch_apply_reports_jit_execute_split():
    got, prof = _batch_apply(tpw, TRunner, tprof)
    want, _ = _batch_apply(jpw, JRunner, jprof)
    keys = [k for k in got if k.startswith("batch_udf/")]
    assert keys and got[keys[0]][1] == 3
    assert prof.jit_stats[keys[0]]["execute_ns"] > 0
    assert sorted(v for k, v in got.items() if k.startswith("batch_udf/")) == sorted(
        v for k, v in want.items() if k.startswith("batch_udf/"))


# ------------------------------------------------------------- chrome trace


def _trace_shape(trace: dict) -> dict:
    """Golden shape: trace-event JSON with process / worker metadata and one
    complete slice per node per epoch. Returns node id -> epochs."""
    assert set(trace) >= {"traceEvents", "displayTimeUnit"}
    events = trace["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "M"} >= {"process_name", "thread_name"}
    per_node: dict[int, list[int]] = {}
    for s in (e for e in events if e["ph"] == "X" and e.get("cat") == "operator"):
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(s) and s["ts"] >= 0 and s["dur"] >= 0
        per_node.setdefault(s["args"]["node_id"], []).append(s["args"]["epoch"])
    epochs = {e for ep in per_node.values() for e in ep}
    assert all(sorted(ep) == sorted(epochs) for ep in per_node.values())
    return per_node


def test_run_profile_kwarg_writes_chrome_trace(tmp_path):
    traces = []
    for pw, name in ((jpw, "j.json"), (tpw, "t.json")):
        pw.io.null.write(_word_counts(pw))
        pw.run(profile=str(tmp_path / name))
        traces.append(json.loads((tmp_path / name).read_text()))
    got, want = _trace_shape(traces[1]), _trace_shape(traces[0])
    assert len(got) == len(want) >= 5
    assert traces[1]["otherData"]["producer"] == "pathway_tpu_torch.profiler"
    slices = [e for e in traces[1]["traceEvents"] if e["ph"] == "X" and e.get("cat") == "operator"]
    # build-time source frames ride on the slices of user-built operators
    assert any(s["args"].get("file", "").endswith(".py") for s in slices)
    tids = {m["tid"] for m in traces[1]["traceEvents"] if m["ph"] == "M" and m["name"] == "thread_name"}
    assert {s["tid"] for s in slices} <= tids


# ------------------------------------------------- encoder kernel statistics


def test_encoder_kernel_stats_follow_the_reference():
    """The same dispatch geometry gives the same token counts, pad fraction
    and FLOPs in both packages' statistics."""
    from pathway_tpu.models.encoder import EncoderConfig as JCfg
    from pathway_tpu.ops.fused_layer import encoder_flops_per_token as jflops
    from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
    from pathway_tpu_torch.ops.fused_layer import encoder_flops

    jcfg, tcfg = JCfg.minilm_l6(), TCfg.minilm_l6()
    stats = {}
    for mod, flops in ((jprof, lambda b, s: b * s * jflops(jcfg, s)),
                       (tprof, lambda b, s: encoder_flops(tcfg, b * s, b * s * s))):
        st = mod.EncoderKernelStats()
        for batch, seq, real in ((32, 64, 1500), (16, 128, 1900)):
            st.record_dispatch(seq=seq, batch=batch, real_tokens=real, computed_tokens=batch * seq,
                               flops=flops(batch, seq))
        snap = st.snapshot()
        snap.pop("achieved_tflops")
        stats[mod is tprof] = snap
    assert stats[True] == stats[False]
    assert stats[True]["pad_fraction"] == pytest.approx(1 - 3400 / (32 * 64 + 16 * 128))


def test_encoder_dispatches_feed_the_encode_mfu(monkeypatch):
    """A CPU encode records its dispatches (every row computed); the chip
    ledger's MFU block divides by the configured peak (the card's 989 on an
    H100), and there is none without a peak."""
    from pathway_tpu_torch.internals.chip_ledger import ChipTimeLedger
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.models.sentence_encoder import SentenceEncoder
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer

    cfg = EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                        max_position=128)
    enc = SentenceEncoder(config=cfg, device="cpu", max_batch=8)
    enc.tokenizer = WordPieceTokenizer(vocab_size=cfg.vocab_size)
    texts = ["a short one", "a somewhat longer text with more words in it", "mid length text"]
    enc.encode(texts)
    snap = tprof.ENCODER_KERNEL_STATS.snapshot()
    assert snap["dispatches"] >= 1 and snap["skipped_tokens"] == 0
    assert snap["real_tokens"] < snap["computed_tokens"] and 0.0 < snap["pad_fraction"] < 1.0
    monkeypatch.delenv("PATHWAY_CHIP_PEAK_TFLOPS", raising=False)
    assert ChipTimeLedger()._mfu() is None  # no card, no peak
    monkeypatch.setenv("PATHWAY_CHIP_PEAK_TFLOPS", "989")
    mfu = ChipTimeLedger()._mfu()
    assert mfu["peak_tflops"] == 989.0 and mfu["pad_fraction"] == snap["pad_fraction"]


def test_profiler_times_the_encoder_and_index_callables():
    """Under an active profiler the encoder's forwards and the index's top-k
    report through wrap_jit (execute on the CPU: no kernel is built)."""
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.models.sentence_encoder import SentenceEncoder
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    cfg = EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                        max_position=64)
    enc = SentenceEncoder(config=cfg, device="cpu", max_batch=8)
    enc.tokenizer = WordPieceTokenizer(vocab_size=cfg.vocab_size)
    idx = DeviceKnnIndex(32, reserved_space=64, device="cpu")
    prof = tprof.RunProfiler()
    tprof.set_current_profiler(prof)
    vecs = enc.encode(["one doc", "two docs", "three docs here"])
    idx.add_batch_arrays([0, 1, 2], vecs)
    idx.search_batch(vecs[:1], 2)
    tprof.set_current_profiler(None)
    assert prof.jit_stats["sentence_encoder.fwd_group"]["calls"] >= 1
    assert prof.jit_stats["knn.topk"]["calls"] == 1 and prof.jit_stats["knn.topk"]["compiles"] == 0
