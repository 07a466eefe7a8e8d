"""The port's request-tracing plane against the JAX package's, on the CPU:
``traceparent`` parsing and formatting, the span store's ring eviction and
exemplar retention on a fixed span list, ``attribute``, ``slow_report``,
``render_slow_report`` and ``render_waterfall`` over fixed spans, and the
``pathway_request_stage_seconds`` lines. Span ids and clocks are injected
(``Span``s are built with explicit times and recorded through ``finish``).
The port's own parts are held too: a :class:`TraceFanout` records one span
per member trace, and ``ROW_TRACES`` binds the traces of the rows an
operator works on.

Tolerances: every value and every character equal."""

from __future__ import annotations

import pytest

from pathway_tpu import tracing as jtr
from pathway_tpu.internals import http_monitoring as jhm
from pathway_tpu.tracing import metrics as jtm
from pathway_tpu_torch import tracing as ttr
from pathway_tpu_torch.internals import http_monitoring as thm
from pathway_tpu_torch.tracing import metrics as ttm

HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01 ",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "garbage", "", None, "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-ff",
]


@pytest.mark.parametrize("header", HEADERS, ids=repr)
def test_traceparent_parse_and_format_match_the_reference(header):
    want = jtr.TraceContext.from_traceparent(header)
    got = ttr.TraceContext.from_traceparent(header)
    if want is None:
        assert got is None
        return
    assert (got.trace_id, got.span_id, got.sampled) == (want.trace_id, want.span_id, want.sampled)
    assert got.to_traceparent() == want.to_traceparent()
    assert ttr.TRACE_RESPONSE_HEADER == jtr.TRACE_RESPONSE_HEADER and ttr.TRACEPARENT_HEADER == jtr.TRACEPARENT_HEADER


def _span_dicts() -> list[dict]:
    """Three fixed request journeys: request -> admission, queue, dispatch,
    pipeline, with an index search and a rerank under the pipeline wait."""
    out = []
    for n, (tid, wall) in enumerate((("a" * 32, 40.0), ("b" * 32, 95.0), ("c" * 32, 12.0))):
        t0 = 1_700_000_000.0 + n
        root = f"{n}" * 16
        parts = [("admission", 0.0, 0.05), ("queue", 0.001, 0.3), ("dispatch", 0.0013, 0.1),
                 ("pipeline", 0.0014, 0.6)]
        out.append({"trace": tid, "span": root, "parent": "", "stage": "request", "worker": 0, "start": t0,
                    "dur_ms": wall, "boundary": True})
        for i, (stage, off, frac) in enumerate(parts):
            out.append({"trace": tid, "span": f"{n}{i}".ljust(16, "e"), "parent": root, "stage": stage,
                        "worker": 0, "start": t0 + off, "dur_ms": round(wall * frac, 4)})
        out.append({"trace": tid, "span": f"{n}s".ljust(16, "f"), "parent": root, "stage": "index_search",
                    "worker": 1, "start": t0 + 0.002, "dur_ms": 1.5, "attrs": {"index": "knn0", "k": 6}})
        out.append({"trace": tid, "span": f"{n}r".ljust(16, "d"), "parent": root, "stage": "rerank",
                    "worker": 1, "start": t0 + 0.004, "dur_ms": 3.25, "links": ["f" * 32]})
    return out


def _by_trace(spans):
    out: dict[str, list] = {}
    for s in spans:
        out.setdefault(s["trace"], []).append(s)
    return out


@pytest.mark.parametrize("tid", ["a" * 32, "b" * 32, "c" * 32])
def test_attribute_and_waterfall_match_the_reference(tid):
    spans = _by_trace(_span_dicts())[tid]
    assert ttr.attribute(spans, tid) == jtr.attribute(spans, tid)
    events = [{"time": spans[0]["start"] + 0.001, "kind": "serving.admit", "trace": tid, "seq": 1}]
    assert ttr.render_waterfall(tid, spans, events) == jtr.render_waterfall(tid, spans, events)


@pytest.mark.parametrize("top_n", [1, 3])
def test_slow_report_matches_the_reference(top_n):
    traces = [{"trace_id": tid, "wall_ms": spans[0]["dur_ms"], "spans": spans}
              for tid, spans in _by_trace(_span_dicts()).items()]
    want, got = jtr.slow_report(traces, top_n=top_n), ttr.slow_report(traces, top_n=top_n)
    assert got == want
    assert ttr.render_slow_report(got) == jtr.render_slow_report(want)


def _store(mod, ring: int, slots: int):
    store = mod.TraceStore(ring_size=ring, exemplar_slots=slots, window_s=3600.0)
    for d in _span_dicts():
        sp = mod.Span.from_dict(d)
        sp.start_mono = 0.0
        store.finish(sp)
    return store


@pytest.mark.parametrize("ring,slots", [(64, 10), (64, 1), (64, 2)])
def test_store_eviction_and_exemplars_match_the_reference(monkeypatch, ring, slots):
    for mod in (jtm, ttm):
        monkeypatch.setattr(mod, "TRACING_METRICS", mod.TracingMetrics())
    want, got = _store(jtr.store, ring, slots), _store(ttr.store, ring, slots)
    assert got.recent_spans(ring) == want.recent_spans(ring)
    assert got.exemplar_traces() == want.exemplar_traces()
    assert got.snapshot() == want.snapshot()
    for tid in ("a" * 32, "b" * 32):
        assert got.get_trace(tid) == want.get_trace(tid)


def test_ring_evicts_oldest_like_the_reference(monkeypatch):
    for mod in (jtm, ttm):
        monkeypatch.setattr(mod, "TRACING_METRICS", mod.TracingMetrics())
    stores = []
    for mod in (jtr.store, ttr.store):
        store = mod.TraceStore(ring_size=64, exemplar_slots=3, window_s=3600.0)
        for rep in range(4):
            for d in _span_dicts():
                d = dict(d, span=f"{rep}" + d["span"][1:], trace=f"{rep}" + d["trace"][1:])
                sp = mod.Span.from_dict(d)
                store.finish(sp)
        stores.append(store)
    assert stores[1].recent_spans(64) == stores[0].recent_spans(64)
    assert len(stores[1].recent_spans(1000)) == 64


def test_stage_metric_lines_match_the_reference(monkeypatch):
    for mod, pkg in ((jtm, jtr), (ttm, ttr)):
        m = mod.TracingMetrics()
        for d in _span_dicts():
            m.observe(d["stage"], d["dur_ms"] / 1000.0, d["trace"], worker=d["worker"])
        monkeypatch.setattr(pkg, "TRACING_METRICS", m)
    want = jhm.MonitoringHttpServer._tracing_lines("")
    got = thm.MonitoringHttpServer._tracing_lines("")
    # the exemplars carry the observation's unix time: compare without it
    strip = [line.rsplit(" ", 1)[0] if "# {" in line else line for line in got]
    assert strip == [line.rsplit(" ", 1)[0] if "# {" in line else line for line in want] and got


@pytest.fixture
def traced():
    prev = ttr.set_tracing_enabled(True)
    ttr.TRACE_STORE.reset()
    yield
    ttr.set_tracing_enabled(prev)
    ttr.TRACE_STORE.reset()
    ttr.ROW_TRACES.clear()


def test_fanout_records_one_span_per_request(traced):
    a, b = ttr.TraceContext.new(), ttr.TraceContext.new()
    with ttr.bind_trace(ttr.TraceFanout([a, b])):
        with ttr.span("index_search", k=6) as sp:
            with ttr.span("rerank"):
                pass
    spans = ttr.TRACE_STORE.recent_spans()
    assert sp is not None and sorted(s["stage"] for s in spans) == ["index_search"] * 2 + ["rerank"] * 2
    for ctx in (a, b):
        mine = [s for s in spans if s["trace"] == ctx.trace_id]
        search = next(s for s in mine if s["stage"] == "index_search")
        rerank = next(s for s in mine if s["stage"] == "rerank")
        assert search["parent"] == ctx.span_id and rerank["parent"] == search["span"]
    assert len({s["span"] for s in spans}) == 4


def test_row_traces_bind_the_rows_of_an_operator(traced):
    a, b = ttr.TraceContext.new(), ttr.TraceContext.new()
    ttr.ROW_TRACES.register(1, a)
    ttr.ROW_TRACES.register(2, b)
    with ttr.ROW_TRACES.bind([7, 8]):
        assert ttr.current_trace() is None
    with ttr.ROW_TRACES.bind([2, 9]):
        assert ttr.current_trace() is b
    with ttr.ROW_TRACES.bind([1, 2]):
        assert ttr.trace_members(ttr.current_trace()) == (a, b)
    ttr.ROW_TRACES.forget(1)
    ttr.ROW_TRACES.forget(2)
    assert len(ttr.ROW_TRACES) == 0
    # the OTLP export is ported: no exemplar retained, nothing exported
    from pathway_tpu_torch.internals.telemetry import Telemetry

    ttr.TRACE_STORE.reset()
    assert ttr.emit_telemetry(Telemetry("unused.jsonl")) == 0
