"""The port's OTLP exporter (``internals/telemetry.py``) and licensing
against the JAX package, on the CPU (``tests/test_telemetry.py``'s cases):
a local HTTP sink records the OTLP/HTTP JSON posts of both packages, whose
payloads must agree once ids, clocks, the process id and the service name
are set aside; the file exporter's JSON lines; a run's span tree under
``PATHWAY_TELEMETRY_SERVER``; the request traces ``tracing.emit_telemetry``
exports; and the license tiers and their worker cap.

Tolerances: payload structure, names, attributes and values equal."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import pathway_tpu as jpw
import pathway_tpu.internals.licensing as jlic
import pathway_tpu.internals.telemetry as jtel
import pathway_tpu_torch as tpw
import pathway_tpu_torch.internals.licensing as tlic
import pathway_tpu_torch.internals.telemetry as ttel

BOTH = pytest.mark.parametrize("tel", [jtel, ttel], ids=["jax", "torch"])


class _Sink:
    """A minimal OTLP/HTTP collector: records every POST body by path."""

    def __init__(self):
        self.requests: dict[str, list[dict]] = {}
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                sink.requests.setdefault(self.path, []).append(body)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        self.endpoint = f"http://127.0.0.1:{self._httpd.server_port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


@pytest.fixture()
def sink():
    s = _Sink()
    yield s
    s.close()


def _attrs(attrs: list[dict]) -> dict:
    return {a["key"]: next(iter(a["value"].values())) for a in attrs}


def _normal(payload: dict) -> dict:
    """A payload with its ids, clocks, process id and service name set
    aside (they differ by run and by package)."""
    def walk(v):
        if isinstance(v, dict):
            out = {}
            for k, x in v.items():
                if k in ("traceId", "spanId", "parentSpanId", "startTimeUnixNano", "endTimeUnixNano", "timeUnixNano"):
                    out[k] = bool(x)
                elif k == "attributes":
                    out[k] = sorted((a["key"], json.dumps(a["value"], sort_keys=True)) for a in x
                                    if a["key"] not in ("service.name", "process.pid"))
                elif k == "scope":
                    out[k] = "scope"
                else:
                    out[k] = walk(x)
            return out
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v

    return walk(payload)


def _export(tel, sink):
    t = tel.Telemetry(endpoint=sink.endpoint)
    assert t.enabled and t._is_http
    with t.span("outer", workers=2) as outer:
        pass
    t.add_span("operator/Select", start_unix_ns=outer.start_unix_ns, end_unix_ns=outer.end_unix_ns, parent=outer,
               attrs={"pathway.node_id": 1, "code.filepath": "prog.py", "pathway.self_time_s": 0.5, "flag": True})
    t.gauge("rows_in", 7.0)
    t.gauge("rows_out", 5.5)
    t.flush()
    return sink.requests.pop("/v1/traces"), sink.requests.pop("/v1/metrics")


def test_http_exporter_traces_payload_shape(sink):
    traces, _ = _export(ttel, sink)
    jtraces, _ = _export(jtel, sink)
    assert [_normal(p) for p in traces] == [_normal(p) for p in jtraces]
    rs = traces[0]["resourceSpans"][0]
    assert _attrs(rs["resource"]["attributes"])["service.name"] == "pathway_tpu_torch"
    spans = rs["scopeSpans"][0]["spans"]
    assert [s["name"] for s in spans] == ["outer", "operator/Select"]
    assert len({s["traceId"] for s in spans}) == 1
    assert spans[1]["parentSpanId"] == spans[0]["spanId"] and "parentSpanId" not in spans[0]
    assert _attrs(spans[1]["attributes"])["pathway.node_id"] == "1"  # OTLP intValue is a string
    for s in spans:
        assert int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"]) and s["kind"] == 1


def test_http_exporter_metrics_payload_shape(sink):
    _, metrics = _export(ttel, sink)
    _, jmetrics = _export(jtel, sink)
    assert [_normal(p) for p in metrics] == [_normal(p) for p in jmetrics]
    by_name = {m["name"]: m for m in metrics[0]["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    assert set(by_name) == {"rows_in", "rows_out"}
    assert by_name["rows_out"]["gauge"]["dataPoints"][0]["asDouble"] == 5.5


@BOTH
def test_file_exporter_writes_parseable_jsonl(tel, tmp_path):
    path = tmp_path / "telemetry.jsonl"
    for i in range(2):  # two flushes, two lines
        t = tel.Telemetry(endpoint=str(path))
        assert t.enabled and not t._is_http
        with t.span(f"run{i}", attempt=i):
            pass
        t.gauge("rows", float(i))
        t.flush()
    lines = path.read_text().strip().split("\n")
    assert len(lines) == 2
    for i, line in enumerate(lines):
        rec = json.loads(line)
        assert rec["spans"][0]["name"] == f"run{i}" and rec["spans"][0]["ms"] >= 0
        assert rec["metrics"] == {"rows": float(i)} and rec["ts"] > 0


@BOTH
def test_unknown_scheme_disables_exporter(tel, monkeypatch):
    monkeypatch.delenv("PATHWAY_TELEMETRY_SERVER", raising=False)
    assert not tel.Telemetry().enabled
    t = tel.Telemetry(endpoint="grpc://collector:4317")
    assert not t.enabled
    t.flush()  # must not raise


def _run_spans(pw, sink, monkeypatch):
    monkeypatch.setenv("PATHWAY_TELEMETRY_SERVER", sink.endpoint)
    pw.clear_graph()
    t = pw.debug.table_from_markdown("""
      | a
    1 | 1
    2 | 2
    """)
    pw.io.null.write(t.select(b=pw.this.a * 2))
    pw.run()
    pw.clear_graph()
    return sink.requests.pop("/v1/traces")[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]


def test_run_emits_per_operator_child_spans(sink, monkeypatch):
    """pw.run with PATHWAY_TELEMETRY_SERVER exports one span per operator,
    under graph_runner.run, sharing its trace id, with the node's source
    location: the reference's span tree."""
    spans = _run_spans(tpw, sink, monkeypatch)
    jspans = _run_spans(jpw, sink, monkeypatch)
    assert sorted(s["name"] for s in spans) == sorted(s["name"] for s in jspans)
    run_span = next(s for s in spans if s["name"] == "graph_runner.run")
    ops = [s for s in spans if s["name"].startswith("operator/")]
    assert len(ops) >= 3
    for s in ops:
        assert s["traceId"] == run_span["traceId"] and s["parentSpanId"] == run_span["spanId"]
        assert {"pathway.node_id", "pathway.self_time_s"} <= set(_attrs(s["attributes"]))
    assert any("code.filepath" in _attrs(s["attributes"]) for s in ops)


def test_tracing_exports_request_traces_with_their_ids(tmp_path):
    """The retained request traces leave through the exporter with their
    own trace and span ids (``tracing.emit_telemetry``)."""
    from pathway_tpu_torch import tracing as ttr

    prev = ttr.set_tracing_enabled(True)
    ttr.TRACE_STORE.reset()
    try:
        with ttr.span("request", new_trace=True) as root:
            with ttr.span("admission"):
                pass
        t = ttel.Telemetry(endpoint=str(tmp_path / "t.jsonl"))
        n = ttr.emit_telemetry(t)
        assert n == 2 and {s.name for s in t.spans} == {"request.request", "request.admission"}
        assert {s.trace_id for s in t.spans} == {root.trace_id}
        child = next(s for s in t.spans if s.name == "request.admission")
        assert child.parent_span_id == next(s for s in t.spans if s.name == "request.request").span_id
    finally:
        ttr.set_tracing_enabled(prev)
        ttr.TRACE_STORE.reset()


# ------------------------------------------------------------------ licensing


@pytest.mark.parametrize("key", [None, "", "  ", "enterprise-abc", "ENTERPRISE", "other-key"])
def test_license_tiers_follow_the_reference(key):
    got, want = tlic.License.new(key), jlic.License.new(key)
    assert (got.tier, got.telemetry_required, got.max_workers()) == (want.tier, want.telemetry_required,
                                                                     want.max_workers())
    for feature in ("xpack-spatial", "xpack-sharepoint", "anything"):
        outcomes = []
        for lic, err in ((got, tlic.LicenseError), (want, jlic.LicenseError)):
            try:
                lic.check_entitlement(feature)
                outcomes.append("ok")
            except err:
                outcomes.append("denied")
        assert outcomes[0] == outcomes[1]


def test_free_tier_caps_the_run_workers(monkeypatch):
    """pw.run checks the worker count against the license: nine workers
    need a key (license_key= or PATHWAY_LICENSE_KEY)."""
    monkeypatch.setenv("PATHWAY_THREADS", "9")
    tpw.clear_graph()
    t = tpw.debug.table_from_markdown("""
      | a
    1 | 1
    """)
    tpw.io.subscribe(t, lambda **_: None)
    with pytest.raises(tlic.LicenseError, match="free tier"):
        tpw.run()
    monkeypatch.setenv("PATHWAY_THREADS", "1")
    tpw.run(license_key="enterprise-key")
    tpw.clear_graph()
