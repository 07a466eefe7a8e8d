"""The port's HTTP client connectors held against the JAX package's, on the CPU.

The cases of ``tests/test_http_streaming.py``, each run on both packages
through the same injected fake sessions (a requests-shaped double that
plays a scripted list of responses and errors): ``split_stream``'s
re-framing, the retry policy, ``RequestRunner``'s retries, the streaming
transport's reconnects and give-ups, ``pw.io.http.read`` in both
transports end to end, and the bounded dedupe window. The results are
equal. Then the port's default session, ``UrllibSession`` on the standard
library, against a server on localhost: a chunked newline-delimited
stream dropped once at half and resumed on reconnect, a polled endpoint,
and ``pw.io.http.write`` posting every change once.
"""

from __future__ import annotations

import http.server
import itertools
import json
import threading

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.io.http import _client as jclient
from pathway_tpu.io.http import _retry as jretry
from pathway_tpu_torch.io.http import _client as tclient
from pathway_tpu_torch.io.http import _retry as tretry

PACKAGES = {"reference": (jpw, jclient, jretry), "port": (tpw, tclient, tretry)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    pw, client, retry = PACKAGES[request.param]
    pw.clear_graph()
    yield pw, client, retry
    pw.clear_graph()


def _collect(pw, table):
    rows = []
    pw.io.subscribe(table, on_change=lambda key, row, time, is_addition: rows.append(row))
    pw.run(monitoring_level="none")
    pw.clear_graph()
    return rows


class _Resp:
    def __init__(self, status=200, chunks=()):
        self.status_code = status
        self._chunks = list(chunks)

    def iter_content(self, chunk_size=None):
        for c in self._chunks:
            if isinstance(c, Exception):
                raise c
            yield c


class ScriptedSession:
    """requests-shaped double: each request() pops the next scripted
    outcome (a _Resp or an Exception to raise)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def request(self, method, url, headers=None, data=None, stream=False, timeout=None, allow_redirects=True):
        self.calls.append((method, url))
        outcome = self.script.pop(0) if self.script else ConnectionError("exhausted")
        if isinstance(outcome, Exception):
            raise outcome
        return outcome


# ------------------------------------------------------------ split_stream


def test_split_stream_reframes_arbitrary_chunk_boundaries(pkg):
    _, client, _ = pkg
    chunks = [b'{"a"', b": 1}\n{", b'"a": 2}\n{"a"', b": 3}"]
    assert list(client.split_stream(chunks, None)) == [b'{"a": 1}', b'{"a": 2}', b'{"a": 3}']


def test_split_stream_custom_delimiter_and_crlf(pkg):
    _, client, _ = pkg
    assert list(client.split_stream([b"a|b|", b"c"], "|")) == [b"a", b"b", b"c"]
    assert list(client.split_stream([b"x\r\ny\r\n"], None)) == [b"x", b"y"]
    assert list(client.split_stream([b"x\r;y"], ";")) == [b"x\r", b"y"]


# ------------------------------------------------------------- RetryPolicy


def test_retry_policy_escalates_geometrically(pkg):
    _, _, retry = pkg
    p = retry.RetryPolicy(first_delay_ms=100, backoff_factor=2.0, jitter_ms=0)
    assert [p.wait_duration_before_retry() for _ in range(3)] == [0.1, 0.2, 0.4]


def test_retry_policy_jitter_bounded(pkg):
    _, _, retry = pkg
    p = retry.RetryPolicy(first_delay_ms=100, backoff_factor=1.0, jitter_ms=50)
    waits = [p.wait_duration_before_retry() for _ in range(50)]
    assert waits[0] == 0.1
    assert all(0.1 <= w <= 0.1 + 50 * 0.05 for w in waits)


# ----------------------------------------------------------- RequestRunner


def test_request_runner_retries_retryable_status_then_succeeds(pkg):
    _, _, retry = pkg
    session = ScriptedSession([_Resp(503), _Resp(503), _Resp(200)])
    slept = []
    runner = retry.RequestRunner(session, n_retries=3, retry_policy_factory=lambda: retry.RetryPolicy(100, 2.0, 0),
                                 sleep=slept.append)
    assert runner.send("GET", "http://x/s").status_code == 200
    assert len(session.calls) == 3
    assert slept == [0.1, 0.2]
    assert runner.backoffs == [(0, 0.1), (1, 0.2)]


def test_request_runner_does_not_retry_non_retryable_status(pkg):
    _, _, retry = pkg
    session = ScriptedSession([_Resp(404), _Resp(200)])
    runner = retry.RequestRunner(session, n_retries=5, sleep=lambda s: None)
    assert runner.send("GET", "http://x/s").status_code == 404
    assert len(session.calls) == 1


def test_request_runner_raises_last_exception_after_exhaustion(pkg):
    _, _, retry = pkg
    session = ScriptedSession([OSError("down"), OSError("still down")])
    runner = retry.RequestRunner(session, n_retries=1, sleep=lambda s: None)
    with pytest.raises(OSError, match="still down"):
        runner.send("GET", "http://x/s")
    assert len(session.calls) == 2


def test_request_runner_returns_retryable_response_when_out_of_retries(pkg):
    _, _, retry = pkg
    session = ScriptedSession([_Resp(503), _Resp(503)])
    runner = retry.RequestRunner(session, n_retries=1, sleep=lambda s: None)
    assert runner.send("GET", "http://x/s").status_code == 503


def test_request_runner_deadline_skips_a_backoff_past_it(pkg):
    _, _, retry = pkg
    session = ScriptedSession([_Resp(503), _Resp(200)])
    slept = []
    runner = retry.RequestRunner(session, n_retries=3, retry_policy_factory=lambda: retry.RetryPolicy(5000, 2.0, 0),
                                 sleep=slept.append)
    assert runner.send("GET", "http://x/s", deadline=1.0).status_code == 503
    assert slept == [] and len(session.calls) == 1


# ---------------------------------------------------------- stream_records


def test_stream_records_chunked_delivery(pkg):
    _, client, _ = pkg
    session = ScriptedSession([_Resp(200, [b"r1\nr2", b"\nr3\n"])])
    assert list(client.stream_records(session, "http://x/stream", once=True, sleep=lambda s: None)) == [
        b"r1", b"r2", b"r3"]


def test_stream_records_reconnects_mid_stream_and_resumes(pkg):
    _, client, retry = pkg
    session = ScriptedSession([_Resp(200, [b"a\nb\n", ConnectionError("reset by peer")]), _Resp(200, [b"c\nd\n"])])
    slept = []
    gen = client.stream_records(session, "http://x/stream", retry_policy=retry.RetryPolicy(100, 2.0, 0),
                                sleep=slept.append)
    assert list(itertools.islice(gen, 4)) == [b"a", b"b", b"c", b"d"]
    assert len(session.calls) == 2
    assert slept == [0.1]


def test_stream_records_backoff_escalates_across_dataless_drops(pkg):
    _, client, retry = pkg
    session = ScriptedSession([ConnectionError("1"), ConnectionError("2"), ConnectionError("3"), _Resp(200, [b"ok\n"])])
    slept = []
    gen = client.stream_records(session, "http://x/stream", retry_policy=retry.RetryPolicy(100, 2.0, 0),
                                sleep=slept.append)
    assert next(gen) == b"ok"
    assert slept == [0.1, 0.2, 0.4]


def test_stream_records_gives_up_after_consecutive_dataless_drops(pkg):
    _, client, retry = pkg
    session = ScriptedSession([ConnectionError("down")] * 10)
    gen = client.stream_records(session, "http://x/stream", retry_policy=retry.RetryPolicy(1, 1.0, 0),
                                max_failed_attempts_in_row=3, sleep=lambda s: None)
    with pytest.raises(ConnectionError):
        list(gen)
    assert len(session.calls) == 3


def test_stream_records_once_fails_loudly_on_drop(pkg):
    _, client, _ = pkg
    session = ScriptedSession([_Resp(200, [b"a\n", ConnectionError("reset")])])
    gen = client.stream_records(session, "http://x/stream", once=True, sleep=lambda s: None)
    assert next(gen) == b"a"
    with pytest.raises(ConnectionError):
        next(gen)


def test_stream_records_error_status_triggers_reconnect(pkg):
    _, client, retry = pkg
    session = ScriptedSession([_Resp(502), _Resp(200, [b"a\n"])])
    gen = client.stream_records(session, "http://x/stream",
                                runner=retry.RequestRunner(session, n_retries=0, sleep=lambda s: None),
                                retry_policy=retry.RetryPolicy(1, 1.0, 0), sleep=lambda s: None)
    assert next(gen) == b"a"


# --------------------------------------------------------------- e2e read


def test_http_read_stream_static_end_to_end(pkg):
    pw, _, _ = pkg

    class S(pw.Schema):
        id: int
        word: str

    lines = b'{"id": 1, "word": "a"}\n{"id": 2, "word": "b"}\n'
    session = ScriptedSession([_Resp(200, [lines[:10], lines[10:]])])
    t = pw.io.http.read("http://x/stream", schema=S, stream=True, mode="static", _session=session,
                        _sleep=lambda s: None)
    assert sorted((r["id"], r["word"]) for r in _collect(pw, t)) == [(1, "a"), (2, "b")]


def test_http_read_stream_response_mapper(pkg):
    pw, _, _ = pkg

    class S(pw.Schema):
        key: int

    def mapper(msg: bytes) -> bytes:
        return json.dumps({"key": json.loads(msg)["id"] * 10}).encode()

    session = ScriptedSession([_Resp(200, [b'{"id": 3}\n'])])
    t = pw.io.http.read("http://x/stream", schema=S, mode="static", response_mapper=mapper, _session=session,
                        _sleep=lambda s: None)
    assert [r["key"] for r in _collect(pw, t)] == [30]


def test_http_read_stream_skips_non_json_keepalives(pkg):
    pw, _, _ = pkg

    class S(pw.Schema):
        id: int

    session = ScriptedSession([_Resp(200, [b": ping\n{\"id\": 5}\n: ping\n"])])
    t = pw.io.http.read("http://x/stream", schema=S, stream=True, mode="static", _session=session,
                        _sleep=lambda s: None)
    assert [r["id"] for r in _collect(pw, t)] == [5]


def test_http_read_without_schema_lands_in_data(pkg):
    pw, _, _ = pkg
    session = ScriptedSession([_Resp(200, [b'[1, 2]\n"x"\n'])])
    t = pw.io.http.read("http://x/stream", stream=True, mode="static", _session=session, _sleep=lambda s: None)
    got = sorted(json.dumps(r["data"].value if hasattr(r["data"], "value") else r["data"]) for r in _collect(pw, t))
    assert got == ['"x"', "[1, 2]"]


# --------------------------------------------------------- bounded dedupe


def test_recent_window_is_bounded_lru(pkg):
    _, client, _ = pkg
    w = client._RecentWindow(2)
    assert not w.check_and_add("a")
    assert not w.check_and_add("b")
    assert w.check_and_add("a")
    assert not w.check_and_add("c")
    assert w.check_and_add("a")
    assert not w.check_and_add("b")


def test_poll_read_sends_method_and_headers(pkg):
    pw, _, _ = pkg

    class S(pw.Schema):
        id: int

    seen = {}

    class Recording:
        def request(self, method, url, headers=None, **kw):
            seen["method"], seen["headers"] = method, headers

            class R:
                status_code = 200

                @staticmethod
                def json():
                    return [{"id": 1}]

            return R()

    t = pw.io.http.read("http://x/feed", schema=S, mode="static", method="POST",
                        headers={"Authorization": "Bearer tok"}, _session=Recording(), _sleep=lambda s: None)
    assert [r["id"] for r in _collect(pw, t)] == [1]
    assert seen == {"method": "POST", "headers": {"Authorization": "Bearer tok"}}


def test_poll_read_dedupes_within_single_poll(pkg):
    pw, _, _ = pkg

    class S(pw.Schema):
        id: int

    class OnePoll:
        def request(self, method, url, **kw):
            class R:
                status_code = 200

                @staticmethod
                def json():
                    return [{"id": 1}, {"id": 1}, {"id": 2}]

            return R()

    t = pw.io.http.read("http://x/feed", schema=S, mode="static", _session=OnePoll(), _sleep=lambda s: None)
    assert sorted(r["id"] for r in _collect(pw, t)) == [1, 2]


def test_write_posts_each_change_with_time_and_diff(pkg):
    pw, _, _ = pkg
    sent = []

    class Recording:
        def request(self, method, url, headers=None, data=None, **kw):
            sent.append((method, url, headers["Content-Type"], json.loads(data)))

            class R:
                status_code = 200

            return R()

    t = pw.debug.table_from_markdown("""
        a | b
        1 | x
        2 | y
    """)
    pw.io.http.write(t, "http://x/sink", _session=Recording(), _sleep=lambda s: None)
    pw.run(monitoring_level="none")
    got = sorted((m, u, c, b["a"], b["b"], b["diff"]) for m, u, c, b in sent)
    assert got == [("POST", "http://x/sink", "application/json", 1, "x", 1),
                   ("POST", "http://x/sink", "application/json", 2, "y", 1)]
    assert all(isinstance(b["time"], int) for *_, b in sent)


# ------------------------------------------- the port's urllib session


class _Feed(http.server.BaseHTTPRequestHandler):
    """``/stream``: newline-delimited JSON, chunked; the first connection
    is cut after half the records, the next serves the rest. ``/feed``:
    one JSON list. ``/sink``: records each POSTed body. ``/moved``: a 302."""

    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - keep test output quiet
        pass

    def do_GET(self):
        srv = self.server
        if self.path == "/stream":
            with srv.lock:
                srv.connections += 1
                first = srv.connections == 1
            lo, hi = (0, srv.n // 2) if first else (srv.sent, srv.n)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for i in range(lo, hi):
                line = json.dumps({"id": i, "text": f"doc {i}"}).encode() + b"\n"
                self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                srv.sent = i + 1
            if first:  # drop the connection without the last chunk
                self.wfile.flush()
                self.close_connection = True
                return
            self.wfile.write(b"0\r\n\r\n")
        elif self.path == "/feed":
            body = json.dumps([{"id": 1, "text": "a"}, {"id": 2, "text": "b"}]).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/moved":
            self.send_response(302)
            self.send_header("Location", "/feed")
            self.send_header("Content-Length", "0")
            self.end_headers()
        else:
            self.send_error(404)

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with self.server.lock:
            self.server.posted.append(json.loads(body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture
def feed():
    # the port's parse graph is process-global: a sink left in it would post
    # to this server after it closed, from the next run in this process
    tpw.clear_graph()
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Feed)
    srv.daemon_threads = True
    srv.lock, srv.connections, srv.sent, srv.n, srv.posted = threading.Lock(), 0, 0, 64, []
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    tpw.clear_graph()
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def test_urllib_stream_reconnects_once_and_delivers_every_record(feed):
    slept = []
    gen = tclient.stream_records(tclient.UrllibSession(), f"http://127.0.0.1:{feed.server_address[1]}/stream",
                                 retry_policy=tretry.RetryPolicy(10, 2.0, 0), sleep=slept.append)
    got = [json.loads(p)["id"] for p in itertools.islice(gen, feed.n)]
    gen.close()
    assert got == list(range(feed.n))
    assert feed.connections == 2 and slept == [0.01]


def test_urllib_read_and_write_through_a_run(feed):
    base = f"http://127.0.0.1:{feed.server_address[1]}"

    class S(tpw.Schema):
        id: int
        text: str

    polled = tpw.io.http.read(f"{base}/moved", schema=S, mode="static")
    assert sorted((r["id"], r["text"]) for r in _collect(tpw, polled)) == [(1, "a"), (2, "b")]
    session = tclient.UrllibSession()
    assert session.request("GET", f"{base}/moved", allow_redirects=False).status_code == 302
    assert session.request("GET", f"{base}/nowhere").status_code == 404
    t = tpw.debug.table_from_markdown("""
        id | text
        7  | seven
    """)
    tpw.io.http.write(t, f"{base}/sink")
    tpw.run(monitoring_level="none")
    assert [(b["id"], b["text"], b["diff"]) for b in feed.posted] == [(7, "seven", 1)]
