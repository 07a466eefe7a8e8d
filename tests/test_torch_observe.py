"""The slice as a whole, against the JAX package, on the CPU, with every
observability plane on: a streaming ``pw.io.python.read`` -> embedder ->
``DataIndex(BruteForceKnn)`` pipeline served through
``rest_connector(serving=...)``, and a small ``DecodeService`` run.

Both packages get the same documents and the same sequential requests.
The port runs under ``pw.run(tracing=True, chip_ledger=True,
freshness=True, watchdog=..., with_http_server=True, ...)``; the reference,
whose REST reader never returns, runs its ``GraphRunner`` on a daemon
thread with the same planes switched on by hand. They give:

* equal answers (hits equal; float32 encoders on both sides), each with an
  ``X-Pathway-Trace`` id and an ``X-Pathway-Freshness-Ms`` bound;
* the same flight-recorder event kinds in the same order (the batcher's
  ``serving.batch`` is recorded on its own thread and races the engine's
  epoch events, so it is compared by count; the port's watchdog events
  are left out, the reference runs none here);
* per request, the reference's span names with the same parents; the
  port's trace holds in addition the engine-side ``index_search``, which
  the reference leaves untraced (its request context does not cross into
  the epoch thread);
* the same chip-ledger accounts and dispatch counts, but for ``compile``
  (the reference books JAX's jit compiles there, the port its ``nvcc``
  builds, of which a CPU run has none) and ``ingest.stage`` (the
  reference's device staging ring, which comes with ROADMAP Queue A item
  6);
* where the reference's text query runs its fused embed-and-top-k jit, it
  records no ``index.search`` event, span or booking, and its index serves
  no freshness bound; the port's text search records them as its vector
  search does (one ``index.search`` event, one ``index.search`` booking
  and one ``encode`` booking for the query's embedding a request), which
  the comparisons above take out;
* the same ``/metrics`` metric names and label keys in the plane sections;
* in the port, equal answers with every plane off.

A scripted overload through ``rest_connector(serving=)`` (a rate limit, a
deadline too short to serve, ``shed="degrade"``) gets the same statuses,
reasons and degraded answers as the reference's, and degrade cuts ``k`` to
``degrade_top_k``. The decode run's streams, ``decode.*`` events and
``decode`` bookings equal the reference engine's (``impl="xla"``).

Tolerances: hits equal, scores within 1e-5; everything else equal."""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import tracing as jtr
from pathway_tpu.decode import DecodeConfig as JDecodeConfig
from pathway_tpu.decode import DecodeEngine as JEngine
from pathway_tpu.decode import DecoderConfig as JDecoderConfig
from pathway_tpu.decode import DecodeService as JService
from pathway_tpu.decode import init_decoder_params as jinit_decoder
from pathway_tpu.decode.metrics import DECODE_METRICS as JDECODE
from pathway_tpu.freshness.plane import FRESHNESS as JFRESH
from pathway_tpu.internals import flight_recorder as jfr
from pathway_tpu.internals import http_monitoring as jhm
from pathway_tpu.internals import monitoring as jmon
from pathway_tpu.internals.chip_ledger import CHIP_LEDGER as JCHIP
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu.internals.ledger import LEDGER as JLEDGER
from pathway_tpu.models import sentence_encoder as jse
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu.ops.index_metrics import INDEX_METRICS as JINDEX
from pathway_tpu.serving import SERVING_METRICS as JSERVING
from pathway_tpu.tenancy.metrics import TENANCY_METRICS as JTENANCY
from pathway_tpu_torch import tracing as ttr
from pathway_tpu_torch.decode import DecodeConfig, DecodeEngine, DecoderConfig, DecodeService
from pathway_tpu_torch.decode.metrics import DECODE_METRICS as TDECODE
from pathway_tpu_torch.freshness.plane import FRESHNESS as TFRESH
from pathway_tpu_torch.internals import flight_recorder as tfr
from pathway_tpu_torch.internals.chip_ledger import CHIP_LEDGER as TCHIP
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.internals.ledger import LEDGER as TLEDGER
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.ops.index_metrics import INDEX_METRICS as TINDEX
from pathway_tpu_torch.serving import SERVING_METRICS as TSERVING
from pathway_tpu_torch.tenancy.metrics import TENANCY_METRICS as TTENANCY
from pathway_tpu_torch.weights import from_jax_decoder_params, from_jax_params

F32 = dict(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=64)
WORDS = [f"w{i}" for i in range(200)] + ["river", "stone", "cloud", "light", "apple"]
SCORE_TOL = 1e-5
PLANE_PREFIXES = ("pathway_serving_", "pathway_index_", "pathway_request_stage_", "pathway_hbm_", "pathway_chip_",
                  "pathway_freshness_", "pathway_decode_")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, payload, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


def _post_in_turn(recorder, port, payload, headers=None):
    """Post one request; once it was admitted, wait until the epoch that
    answered it has advanced. The engine thread records ``epoch.advance``
    after the answer has left it, so without the wait the next request's
    ``serving.admit`` can overtake it, in either package, and the flight
    recorders' orders would compare two thread interleavings."""
    before = len(recorder.events())
    answer = _post(port, payload, headers)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        kinds = [e["kind"] for e in recorder.events()[before:]]
        if "serving.admit" not in kinds or "epoch.advance" in kinds[kinds.index("serving.admit"):]:
            break
        time.sleep(0.002)
    return answer


def _reset_planes():
    # every process-global registry whose activity gates a /metrics section:
    # one left active by an earlier test file on the same worker would add
    # its section to one side's scrape only (the tenancy registries did)
    for reg in (JSERVING, TSERVING, JINDEX, TINDEX, JDECODE, TDECODE, JLEDGER, TLEDGER, JCHIP, TCHIP, JFRESH, TFRESH,
                JTENANCY, TTENANCY, jtr.TRACE_STORE, ttr.TRACE_STORE, jtr.TRACING_METRICS, ttr.TRACING_METRICS):
        reg.reset()
    jfr.RECORDER.clear()
    tfr.RECORDER.clear()


def _settle_reference_servers(timeout: float = 60.0) -> None:
    """Wait for the reference's served runs that earlier test files left on
    daemon threads (``BaseRestServer.run(threaded=True)``, threads named
    ``rest_server:<port>``): such a run returns only after its connectors'
    joins time out, and its ``pw.run`` then restores the process-global
    switches it saved (chip ledger, tracing, freshness) in the middle of
    whatever test runs next on the worker."""
    deadline = time.monotonic() + timeout
    for thread in threading.enumerate():
        if thread.name.startswith("rest_server:") and thread.is_alive():
            thread.join(max(0.0, deadline - time.monotonic()))


@pytest.fixture
def planes():
    """The reference's planes switched on by hand (the port's through
    ``pw.run``); every registry of both packages reset before and after."""
    _settle_reference_servers()
    jpw.clear_graph()
    tpw.clear_graph()
    _reset_planes()
    prev = jtr.set_tracing_enabled(True)
    jprev = (JCHIP._override, JFRESH._override)
    JCHIP.set_enabled(True)
    JFRESH.set_enabled(True)
    yield
    jtr.set_tracing_enabled(prev)
    JCHIP.set_enabled(jprev[0])
    JFRESH.set_enabled(jprev[1])
    _reset_planes()
    jpw.clear_graph()
    tpw.clear_graph()


@pytest.fixture
def encoders(monkeypatch):
    jenc = jse.SentenceEncoder(config=JCfg(**F32, dtype=jnp.float32), checkpoint_dir="/nonexistent",
                               max_seq_len=32, max_batch=64)
    jenc.tokenizer = JTok(vocab_size=F32["vocab_size"])
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jenc.params))
    tenc = tse.SentenceEncoder(config=TCfg(**F32, dtype=torch.float32), max_seq_len=32, max_batch=64,
                               device="cpu", params=from_jax_params(tree))
    tenc.tokenizer = TTok(vocab_size=F32["vocab_size"])
    monkeypatch.setattr(jse, "SentenceEncoder", lambda *a, **k: jenc)
    monkeypatch.setattr(tse, "SentenceEncoder", lambda *a, **k: tenc)
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmb
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmb

    return JEmb(), TEmb(device="cpu")


def _texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1))) for _ in range(n)]


def _build(pw, embedder, docs, port, serving, ingested):
    class Source(pw.io.python.ConnectorSubject):
        def run(self):
            # one commit: one ingest epoch in both packages
            for i, text in enumerate(docs):
                self.next(doc_id=i, text=text)
            self.commit()

    class DocSchema(pw.Schema):
        doc_id: int
        text: str

    class Query(pw.Schema):
        q: str
        k: int = pw.column_definition(default_value=3)

    table = pw.io.python.read(Source(), schema=DocSchema, autocommit_duration_ms=None)
    pw.io.subscribe(table, lambda key, row, time, is_addition: ingested.append(row["doc_id"]))
    knn = pw.indexing.BruteForceKnn(table.text, dimensions=F32["hidden_size"], reserved_space=64, embedder=embedder,
                                    **({"device": "cpu"} if pw is tpw else {}))
    index = pw.indexing.DataIndex(table, knn)
    queries, writer = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=Query, serving=serving,
                                                delete_completed_queries=False)
    replies = index.query_as_of_now(queries.q, number_of_matches=queries.k)
    writer(replies.select(result=pw.make_tuple(pw.this.doc_id, pw.this._pw_index_reply_score)))


def _wait(cond, what, timeout=60.0):
    until = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > until:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _until_up(port):
    for _ in range(300):
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.05)
    raise AssertionError("the endpoint did not come up")


def _serve_reference(embedder, docs, requests, serving):
    ingested: list = []
    port = _free_port()
    _build(jpw, embedder, docs, port, serving, ingested)
    runner = JRunner()
    for spec in list(jpw.parse_graph.subscriptions):
        runner.subscribe(spec["table"], on_change=spec.get("on_change"))
    jpw.clear_graph()
    threading.Thread(target=runner.run, daemon=True).start()
    _wait(lambda: len(ingested) == len(docs), "the reference's ingest")
    _until_up(port)
    jfr.RECORDER.clear()
    answers = [_post_in_turn(jfr.RECORDER, port, payload, headers) for payload, headers in requests]
    runner.engine.stop()  # the reference's endpoint serves until its process ends
    return answers


def _serve_port(embedder, docs, requests, serving, **planes):
    ingested: list = []
    port = _free_port()
    _build(tpw, embedder, docs, port, serving, ingested)
    runners, out = [], {}
    real_init = TRunner.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    def run():
        out["result"] = tpw.run(**planes)

    TRunner.__init__ = recording_init
    try:
        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        _wait(lambda: len(ingested) == len(docs), "the port's ingest")
        _until_up(port)
        tfr.RECORDER.clear()
        answers = [_post_in_turn(tfr.RECORDER, port, payload, headers) for payload, headers in requests]
        scrape = None
        if planes.get("with_http_server"):
            with urllib.request.urlopen(f"http://127.0.0.1:{planes['monitoring_http_port']}/metrics", timeout=30) as r:
                scrape = r.read().decode()
            with urllib.request.urlopen(f"http://127.0.0.1:{planes['monitoring_http_port']}/status", timeout=30) as r:
                out["status"] = json.loads(r.read().decode())
    finally:
        TRunner.__init__ = real_init
    runners[-1].engine.stop()
    thread.join(timeout=60)
    assert not thread.is_alive()
    tpw.clear_graph()
    return answers, scrape, out


def _hits(answer):
    status, body, _ = answer
    assert status == 200, answer
    return [(int(i), float(s)) for i, s in zip(*body)]


def _hits_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=SCORE_TOL, atol=SCORE_TOL)


def _shape(store, trace_id):
    """(stage, parent's stage) of every span of one trace ("" for the
    root); parents are looked up within the trace only."""
    spans = store.get_trace(trace_id)
    stage_of = {s["span"]: s["stage"] for s in spans}
    return sorted((s["stage"], stage_of.get(s["parent"], "")) for s in spans), spans


def _metric_keys(text: str) -> set:
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if not name.startswith(PLANE_PREFIXES):
            continue
        labels = line.split("{", 1)[1].split("}", 1)[0] if "{" in line.split(" ", 1)[0] else ""
        keys = tuple(sorted(p.split("=", 1)[0] for p in labels.split(",") if p))
        out.add((name, keys))
    return out


def test_served_pipeline_with_every_plane_matches_the_reference(planes, encoders, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TRACE_DIR", str(tmp_path / "traces"))
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER_DIR", str(tmp_path / "blackbox"))
    jemb, temb = encoders
    rng = np.random.default_rng(11)
    docs = _texts(rng, 24, 3, 12)
    requests = [({"q": q, "k": 3}, None) for q in _texts(rng, 3, 2, 8) + [docs[5]]]
    jcfg = jpw.serving.ServingConfig(max_queue=16, batch_window_ms=1.0, default_deadline_ms=30_000.0)
    tcfg = tpw.serving.ServingConfig(max_queue=16, batch_window_ms=1.0, default_deadline_ms=30_000.0)

    want = _serve_reference(jemb, docs, requests, jcfg)
    jevents = [e["kind"] for e in jfr.RECORDER.events()]
    jchip = JCHIP.snapshot(wall_s=1.0)["accounts"]
    jscrape = jhm.MonitoringHttpServer(jmon.StatsMonitor(), port=0)._prometheus()
    jshapes = [_shape(jtr.TRACE_STORE, a[2]["X-Pathway-Trace"])[0] for a in want]

    got, scrape, out = _serve_port(temb, docs, requests, tcfg, tracing=True, chip_ledger=True, freshness=True,
                                   watchdog="interval=0.05", with_http_server=True, monitoring_http_port=_free_port())
    tevents = [e["kind"] for e in tfr.RECORDER.events()]
    tchip = TCHIP.snapshot(wall_s=1.0)["accounts"]

    # answers
    for g, w in zip(got, want):
        _hits_equal(_hits(g), _hits(w))
        assert g[2]["X-Pathway-Trace"] and w[2]["X-Pathway-Trace"]
        assert float(g[2]["X-Pathway-Freshness-Ms"]) >= 0.0 and "X-Pathway-Freshness-Ms" in w[2]
    # flight recorder: same kinds in the same order, the batcher's events by count
    ours = ("serving.batch", "index.search", "health.breach")
    assert [k for k in tevents if k not in ours] == [k for k in jevents if k not in ours]
    assert tevents.count("serving.batch") == jevents.count("serving.batch") == len(requests)
    assert tevents.count("index.search") == len(requests) and "index.search" not in jevents
    # spans: the reference's per request, with the same parents, plus the port's index search
    for answer, jshape in zip(got, jshapes):
        tid = answer[2]["X-Pathway-Trace"]
        tshape, spans = _shape(ttr.TRACE_STORE, tid)
        assert [s for s in tshape if s[0] != "index_search"] == jshape
        assert ("index_search", "request") in tshape
        assert {s["trace"] for s in spans} == {tid}
    all_spans = [s for a in got for s in ttr.TRACE_STORE.get_trace(a[2]["X-Pathway-Trace"])]
    assert len({s["span"] for s in all_spans}) == len(all_spans)  # no span in two requests
    # chip ledger: same accounts (but compile) and dispatch counts
    assert set(tchip) == set(jchip) - {"compile", "ingest.stage"} | {"index.search"}
    assert tchip["encode"]["dispatches"] == jchip["encode"]["dispatches"] + len(requests)
    assert tchip["index.search"]["dispatches"] == len(requests)
    # /metrics: same plane metric names and label keys
    assert _metric_keys(scrape) == _metric_keys(jscrape)
    assert {"serving", "index", "tracing", "hbm", "chip", "freshness"} <= set(out["status"])
    result = out["result"]
    assert result.trace_dumps and result.health is not None and result.monitoring_http_port

    # the port with every plane off serves the same answers
    off, _, _ = _serve_port(temb, docs, requests, tcfg)
    for g, o in zip(got, off):
        assert o[1] == g[1] and "X-Pathway-Trace" not in o[2] and "X-Pathway-Freshness-Ms" not in o[2]


@pytest.fixture
def earlier_tenant():
    """What an earlier test file on the same worker can leave behind: a
    tenant named in the reference's process-global tenancy registry (and
    the port's), before the ``planes`` fixture runs."""
    JTENANCY.record_admit("earlier-file")
    TTENANCY.record_admit("earlier-file")
    yield
    JTENANCY.reset()
    TTENANCY.reset()


def test_scrape_comparison_holds_after_an_earlier_tenant(earlier_tenant, planes, encoders, tmp_path, monkeypatch):
    """Regression: with a reference tenant named before the test, the scrape
    comparison of the served pipeline still holds (the reset covers the
    tenancy registries, so neither scrape carries tenant families)."""
    assert not JTENANCY.active() and not TTENANCY.active()
    test_served_pipeline_with_every_plane_matches_the_reference(planes, encoders, tmp_path, monkeypatch)


def test_scripted_overload_sheds_and_degrades_like_the_reference(planes, encoders, monkeypatch):
    jemb, temb = encoders
    rng = np.random.default_rng(5)
    docs = _texts(rng, 16, 3, 10)
    q = docs[3]
    requests = [({"q": q, "k": 5}, None), ({"q": q, "k": 1}, None),
                ({"q": q, "k": 5}, {"X-Pathway-Deadline-Ms": "1"}), ({"q": q, "k": 4}, None),
                ({"q": q, "k": 4}, None), ({"q": q, "k": 4}, None)]
    kw = dict(max_queue=4, shed="degrade", degrade_watermark=0.0, degrade_top_k=2, rate_limit_qps=0.001,
              rate_limit_burst=4, min_service_ms=5.0, default_deadline_ms=30_000.0, batch_window_ms=1.0)
    want = _serve_reference(jemb, docs, requests, jpw.serving.ServingConfig(**kw))
    got, _, _ = _serve_port(temb, docs, requests, tpw.serving.ServingConfig(**kw), tracing=True)
    outcome = [(a[0], a[1].get("reason") if isinstance(a[1], dict) else None, a[2].get("X-Pathway-Degraded"))
               for a in got]
    assert outcome == [(a[0], a[1].get("reason") if isinstance(a[1], dict) else None, a[2].get("X-Pathway-Degraded"))
                       for a in want]
    assert [o[0] for o in outcome] == [200, 200, 503, 200, 429, 429]
    assert [o[2] for o in outcome[:2]] == ["1", "1"]
    assert len(_hits(got[0])) == 2 and len(_hits(got[1])) == 1  # k cut to degrade_top_k
    _hits_equal(_hits(got[0]), _hits(want[0]))
    # every response, sheds included, carries its request's trace id
    assert all(a[2].get("X-Pathway-Trace") for a in got)


GEOM = dict(vocab_size=97, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, max_position=64)
POOL = dict(pages=64, page_size=4, lanes=4, max_new_tokens=6, degrade_max_new_tokens=2, max_seq=48)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8], [9, 9], [31, 41, 5, 92, 6, 53, 5, 89, 79, 3]]


@pytest.mark.parametrize("over", [{}, dict(prefix_cache=True, prefill_chunk=4, spec_tokens=2, draft_layers=1)],
                         ids=["greedy", "cache_chunk_spec"])
def test_decode_service_with_every_plane_matches_the_reference(planes, over):
    jparams = jinit_decoder(JDecoderConfig(**GEOM), seed=0)
    prev = ttr.set_tracing_enabled(True)
    TCHIP.set_enabled(True)
    try:
        runs = []
        for mk, tr, svc_cls, sv, recorder, chip in (
            (lambda: JEngine(JDecoderConfig(**GEOM), JDecodeConfig(**POOL, **over, impl="xla"), params=jparams),
             jtr, JService, jpw.serving, jfr.RECORDER, JCHIP),
            (lambda: DecodeEngine(DecoderConfig(**GEOM), DecodeConfig(**POOL, **over),
                                  params=from_jax_decoder_params(jparams), device="cpu"),
             ttr, DecodeService, tpw.serving, tfr.RECORDER, TCHIP),
        ):
            recorder.clear()
            svc = svc_cls(mk(), config=sv.ServingConfig(batch_window_ms=500.0, latency_budget_ms=60_000.0,
                                                        query_share=1.0))
            try:
                tickets, traces = [], []
                for p in PROMPTS:
                    with tr.span("request", new_trace=True) as sp:
                        tickets.append(svc.submit(p, deadline=sv.Deadline(60_000.0)))
                    traces.append(sp.trace_id)
                streams = [t.result(timeout=60.0) for t in tickets]
            finally:
                svc.stop()
            steps = [s for s in tr.TRACE_STORE.recent_spans(4096) if s["stage"] == "decode_step"]
            runs.append(dict(
                streams=streams,
                events=[e["kind"] for e in recorder.events() if e["kind"].startswith("decode.")],
                chip={a: r["dispatches"] for a, r in chip.snapshot(wall_s=1.0)["accounts"].items()
                      if a.startswith("decode")},
                steps=len(steps), linked=sorted({t for s in steps for t in s.get("links", ())} & set(traces)),
                traces=sorted(traces),
            ))
        want, got = runs
        assert got["streams"] == want["streams"]
        assert got["events"] == want["events"] and "decode.step" in got["events"]
        assert got["chip"] == want["chip"] and got["chip"]["decode" if not over else "decode.verify"] > 0
        assert got["steps"] == want["steps"] > 0
        assert got["linked"] == got["traces"] and want["linked"] == want["traces"]
    finally:
        ttr.set_tracing_enabled(prev)
        TCHIP.set_enabled(None)
