"""The port's REST connector (standard library) against the JAX package's
(aiohttp), on the CPU.

Both packages serve the same endpoints on one shared webserver each and
get the same requests: a valid one, a missing field, a wrong type, a GET
with a query string, a ``format="raw"`` body, an expired
``X-Pathway-Deadline-Ms``, the tracing and tenant headers (answered as
with those planes off), an unknown route and a wrong method. Status codes
and JSON bodies are equal, and so is ``/_schema``. After
``engine.stop()`` the port's run returns and its socket is closed (the
reference serves until its process ends, so its run is left to its
daemon threads).
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.io.http import _server as tserver


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, path, payload=None, method="POST", headers=None, raw: bytes | None = None):
    """-> (status, body as JSON or text, response headers)."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=20) as resp:
            status, body, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), dict(e.headers)
    text = body.decode()
    try:
        return status, json.loads(text), hdrs
    except ValueError:
        return status, text, hdrs


REQUESTS = [
    ("valid", "/", dict(payload={"value": 21, "tag": "x"})),
    ("default", "/", dict(payload={"value": 4})),
    ("missing", "/", dict(payload={})),
    ("wrong_type", "/", dict(payload={"value": "x"})),
    ("bool_for_int", "/", dict(payload={"value": True})),
    ("not_json", "/", dict(raw=b"value=3")),
    ("get_query", "/echo?text=hello+world&text=again", dict(method="GET")),
    ("raw", "/raw", dict(raw=b"free text body")),
    ("deadline", "/", dict(payload={"value": 1}, headers={"X-Pathway-Deadline-Ms": "0"})),
    ("bad_deadline", "/", dict(payload={"value": 2}, headers={"X-Pathway-Deadline-Ms": "soon"})),
    ("planes_off", "/", dict(payload={"value": 5}, headers={
        "traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01", "X-Pathway-Tenant": "acme"})),
    ("unknown_route", "/nowhere", dict(payload={"value": 1})),
    ("wrong_method", "/raw", dict(method="GET")),
    ("schema", "/_schema", dict(method="GET")),
]


def _serve(pw, runner_cls, port):
    """One webserver, three endpoints; every request of REQUESTS in turn ->
    ({name: (status, body, headers)}, runner, run thread)."""

    class Doubled(pw.Schema):
        value: int = pw.column_definition(description="the number to double", example=21)
        tag: str = pw.column_definition(default_value="none")

    class Echo(pw.Schema):
        text: str

    web = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    docs = pw.io.http.EndpointDocumentation(
        summary="Double a number", tags=["math"],
        examples=pw.io.http.EndpointExamples().add_example("default", "double 21", {"value": 21}))
    q, writer = pw.io.http.rest_connector(webserver=web, route="/", schema=Doubled, documentation=docs,
                                          delete_completed_queries=False)
    writer(q.select(result=pw.apply(lambda v, t: {"doubled": v * 2, "tag": t}, pw.this.value, pw.this.tag)))
    e, echo_writer = pw.io.http.rest_connector(webserver=web, route="/echo", methods=["GET", "POST"], schema=Echo)
    echo_writer(e.select(result=pw.this.text))
    r, raw_writer = pw.io.http.rest_connector(webserver=web, route="/raw", format="raw")
    raw_writer(r.select(result=pw.this.query))

    runner = runner_cls()
    for spec in list(pw.parse_graph.subscriptions):
        runner.subscribe(spec["table"], on_change=spec.get("on_change"))
    pw.clear_graph()
    run = threading.Thread(target=runner.run, daemon=True)
    run.start()
    answers = {}
    for attempt in range(100):  # until the endpoint is up
        try:
            answers["valid"] = _request(port, "/", payload={"value": 21, "tag": "x"})
            break
        except urllib.error.URLError:
            run.join(timeout=0.1)
    for name, path, kw in REQUESTS[1:]:
        answers[name] = _request(port, path, **kw)
    return answers, runner, run


def test_rest_connector_answers_equal_reference():
    want, jrunner, _ = _serve(jpw, JRunner, _free_port())
    jrunner.engine.stop()  # the reference's endpoint serves until its process ends
    port = _free_port()
    got, runner, run = _serve(tpw, TRunner, port)
    assert port in tserver.bound_serving_ports()
    runner.engine.stop()
    run.join(timeout=30)
    assert not run.is_alive(), "the port's run returns once the engine stops"

    assert got["valid"][:2] == (200, {"doubled": 42, "tag": "x"})
    assert got["missing"][0] == got["wrong_type"][0] == 400
    assert got["deadline"][1]["reason"] == "deadline_exceeded"
    assert got["get_query"][:2] == (200, "hello world") and "json" in got["get_query"][2]["Content-Type"]
    assert got["raw"][:2] == (200, "free text body")
    assert got["unknown_route"][:2] == (404, "404: Not Found")
    for name, *_ in REQUESTS:
        assert got[name][:2] == want[name][:2], name
    # the tracing plane is off in both: no trace id is echoed
    assert "X-Pathway-Trace" not in got["planes_off"][2] and "X-Pathway-Trace" not in want["planes_off"][2]
    assert got["planes_off"][1] == got["default"][1] | {"doubled": 10}
    # the socket is closed: a new listener binds the port, and nothing answers there
    assert port not in tserver.bound_serving_ports()
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
    with pytest.raises(urllib.error.URLError):
        _request(port, "/", payload={"value": 1})


def _start(webserver_kw, route_kw=None):
    port = _free_port()
    web = tpw.io.http.PathwayWebserver(host="127.0.0.1", port=port, **webserver_kw)
    q, writer = tpw.io.http.rest_connector(webserver=web, schema=tpw.schema_from_types(value=int), **(route_kw or {}))
    writer(q.select(result=tpw.this.value + 1))
    runner = TRunner()
    for spec in list(tpw.parse_graph.subscriptions):
        runner.subscribe(spec["table"], on_change=spec.get("on_change"))
    run = threading.Thread(target=runner.run, daemon=True)
    run.start()
    return web, runner, run


def _until_up(web, path="/", **kw):
    for _ in range(100):
        if web.serving:
            return _request(web.port, path, **kw)
        threading.Event().wait(0.05)
    raise AssertionError("the webserver did not start")


def test_cors_preflight_and_headers():
    web, runner, run = _start(dict(with_cors=True))
    try:
        status, body, headers = _until_up(web, payload={"value": 1})
        assert (status, body) == (200, 2) and headers["Access-Control-Allow-Origin"] == "*"
        status, _, headers = _request(web.port, "/", method="OPTIONS")
        assert status == 200 and "POST" in headers["Access-Control-Allow-Methods"]
    finally:
        runner.engine.stop()
        run.join(timeout=30)
    assert not run.is_alive()


def test_taken_port_falls_back_to_an_ephemeral_one():
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        web = tpw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
        q, writer = tpw.io.http.rest_connector(webserver=web, schema=tpw.schema_from_types(value=int))
        writer(q.select(result=tpw.this.value * 3))
        runner = TRunner()
        for spec in list(tpw.parse_graph.subscriptions):
            runner.subscribe(spec["table"], on_change=spec.get("on_change"))
        run = threading.Thread(target=runner.run, daemon=True)
        run.start()
        try:
            assert _until_up(web, payload={"value": 2})[:2] == (200, 6)
            assert web.port != port and web.port in tpw.io.http.bound_serving_ports()
        finally:
            runner.engine.stop()
            run.join(timeout=30)
    assert not run.is_alive() and not web.serving


def test_unported_http_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 3"):
        tpw.io.http.rest_connector(host="127.0.0.1", port=_free_port(), serving=object())
    for fn in (tpw.io.http.read, tpw.io.http.write):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 1"):
            fn("http://localhost:1/")
    with pytest.raises(ValueError, match="format"):
        tpw.io.http.rest_connector(host="127.0.0.1", port=_free_port(), format="xml")


def test_chunked_request_body_and_keep_alive():
    """HTTP/1.1 clients may stream a body in chunks and reuse a connection."""
    import http.client

    web, runner, run = _start({})
    try:
        assert _until_up(web, payload={"value": 0})[:2] == (200, 1)
        conn = http.client.HTTPConnection("127.0.0.1", web.port, timeout=20)
        conn.request("POST", "/", body=iter([b'{"val', b'ue": 41}']), headers={"Content-Type": "application/json"},
                     encode_chunked=True)
        first = conn.getresponse()
        assert (first.status, json.loads(first.read())) == (200, 42)
        conn.request("POST", "/", body=json.dumps({"value": 9}), headers={"Content-Type": "application/json"})
        second = conn.getresponse()
        assert (second.status, json.loads(second.read())) == (200, 10)
        conn.close()
    finally:
        runner.engine.stop()
        run.join(timeout=30)
    assert not run.is_alive()


@pytest.mark.parametrize("header", [None, "0", "-5", "250", "1e3", "soon", ""])
def test_deadline_header_parsing_equals_reference(header):
    from pathway_tpu.serving.deadline import Deadline as JDeadline
    from pathway_tpu_torch.serving.deadline import Deadline as TDeadline

    for default in (None, 500.0):
        want, got = JDeadline.from_header(header, default), TDeadline.from_header(header, default)
        assert got.budget_ms == want.budget_ms
        assert (got.remaining() == float("inf")) == (want.remaining() == float("inf"))
