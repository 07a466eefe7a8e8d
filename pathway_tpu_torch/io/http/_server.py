"""REST server connector.

The port's copy of the reference's ``io/http/_server.py`` (upstream
Pathway's python/pathway/io/http/_server.py: PathwayWebserver :329,
RestServerSubject :490, rest_connector :624), served by the standard
library's ``http.server``: one thread per connection, each request
inserted into the dataflow as a row; the handler thread waits on a
``concurrent.futures.Future`` that the result table's subscription
resolves. Query/response cycle:

    HTTP request -> row inserted and committed (epoch t)
    -> pipeline computes the result (same or later epoch)
    -> the response subscription resolves the request's future
    -> HTTP response.

The endpoint's reader returns when the engine's run ends, and the server
closes its socket then.

``serving=`` puts the endpoint behind the serving plane, wired as the
reference wires it: an ``AdmissionController`` (bounded deadline-ordered
queue, optional rate limit, typed 429/503 sheds) and an ``AdaptiveBatcher``
that inserts a batch of admitted requests and commits once. With tracing
on, each request gets a ``request`` root span (continuing an inbound
``traceparent``), ``admission``, ``queue``, ``dispatch`` and ``pipeline``
spans, and every response echoes its trace id in ``X-Pathway-Trace``; the
request's row key is registered in ``tracing.ROW_TRACES`` while it is in
flight, so the engine's index search and rerank spans join the request's
trace on the epoch thread. While the freshness plane is live, every
response carries ``X-Pathway-Freshness-Ms``. The tenant header
(``X-Pathway-Tenant``) is carried into admission (the tenant's quotas
under an active tenancy), the batcher's weighted fair share and the
degrade floor (the quota's ``min_top_k``).
"""

from __future__ import annotations

import concurrent.futures
import http.server
import json
import logging
import threading
import time
import uuid
import weakref
from typing import Any, Callable
from urllib.parse import parse_qsl, urlsplit

from ...engine.value import Json, ref_scalar
from ...freshness.plane import FRESHNESS
from ...internals import dtype as dt
from ...internals.parse_graph import G
from ...internals.schema import ColumnDefinition, Schema, schema_builder
from ...internals.table import Table
from ...serving.admission import AdmissionController, DeadlineExceeded, OverloadError
from ...serving.batching import AdaptiveBatcher
from ...serving.deadline import DEADLINE_HEADER, Deadline
from ...serving.metrics import SERVING_METRICS
from ...tracing import (
    ROW_TRACES,
    TRACE_RESPONSE_HEADER,
    TRACEPARENT_HEADER,
    TraceContext,
    current_trace,
    tracing_enabled,
)
from ...tracing import span as trace_span
from .._connector import StreamingContext, input_table_from_reader
from ..fs import _jsonable
from ._docs import EndpointDocumentation, _LoggingContext, validate_payload

logger = logging.getLogger(__name__)

#: Answer-level staleness bound (ms) stamped on every REST reply while the
#: freshness plane is live: any row this reply could have seen was visible
#: at most this many milliseconds ago.
FRESHNESS_HEADER = "X-Pathway-Freshness-Ms"

#: the reference's tenant header (its tenancy plane's)
TENANT_HEADER = "X-Pathway-Tenant"

#: every serving webserver registers here (ports bound at start, including
#: ``port=0`` and the ephemeral-port fallback)
_ACTIVE_WEBSERVERS: "weakref.WeakSet[PathwayWebserver]" = weakref.WeakSet()

#: every port a webserver bound, in order (a run reads the ones bound
#: during it, after its servers closed)
_BOUND_PORTS: list[int] = []


def bound_serving_ports() -> list[int]:
    """Ports of all PathwayWebservers serving now."""
    return sorted({ws.port for ws in _ACTIVE_WEBSERVERS if ws.serving})


class _Request:
    """One HTTP request, with the fields the handlers and the access log
    read (the subset of an ``aiohttp.web.Request`` the reference uses)."""

    scheme = "http"

    def __init__(self, method: str, target: str, headers, body: bytes, remote: str, host: str):
        parts = urlsplit(target)
        self.method = method
        self.path = parts.path
        self.rel_url = target
        self.query: dict[str, str] = {}
        for name, value in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(name, value)  # a repeated name keeps its first value
        self.headers = headers
        self.body = body
        self.remote = remote
        self.host = headers.get("Host") or host

    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.text())


class _Text(str):
    """A plain-text response body (the server's own 404, 405 and preflight
    answers); every other body is JSON."""


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "pathway"
    disable_nagle_algorithm = True  # headers and body leave in separate writes
    timeout = 120  # idle keep-alive connections end after this many seconds

    def log_message(self, format, *args):  # noqa: A002 - the access log is _LoggingContext's
        pass

    def _body(self) -> bytes:
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            chunks = []
            while True:
                size = int(self.rfile.readline().split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass  # trailer fields
                    return b"".join(chunks)
                chunks.append(self.rfile.read(size))
                self.rfile.readline()
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length > 0 else b""

    def _handle(self) -> None:
        ws: PathwayWebserver = self.server.webserver
        request = _Request(self.command, self.path, self.headers, self._body(), self.client_address[0],
                           f"{ws.host}:{ws.port}")
        try:
            status, data, headers = ws._dispatch(request)
        except Exception:
            logger.exception("request handler failed: %s %s", self.command, self.path)
            status, data, headers = 500, {"error": "internal server error"}, None
        if isinstance(data, _Text):
            content_type, body = "text/plain; charset=utf-8", data.encode()
        else:
            content_type, body = "application/json; charset=utf-8", json.dumps(data).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in ws._cors_headers().items():
            self.send_header(name, value)
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = do_OPTIONS = _handle


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 1024  # the listen backlog: bursts of concurrent clients

    def __init__(self, address, webserver: "PathwayWebserver"):
        self.webserver = webserver
        super().__init__(address, _Handler)


class PathwayWebserver:
    """Shared HTTP server hosting several endpoints (the reference's
    _server.py:329), on the standard library. ``with_cors`` adds
    ``Access-Control-Allow-*`` headers to every response and answers
    preflight ``OPTIONS`` requests; ``with_schema_endpoint`` serves the
    endpoints' OpenAPI description at ``GET /_schema``. The server starts
    with the first endpoint's reader and closes its socket when the
    engine's run ends."""

    def __init__(self, host: str, port: int, with_cors: bool = False, with_schema_endpoint: bool = True):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: dict[str, dict[str, Callable]] = {}
        self._openapi: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None
        if with_schema_endpoint:
            self._routes["/_schema"] = {"GET": self._schema_handler}

    def _schema_handler(self, request: _Request):
        return 200, {"openapi": "3.0.3", "info": {"title": "pathway_tpu", "version": "1.0"},
                     "paths": self._openapi}, None

    def add_route(self, route: str, methods: list[str], handler: Callable, schema_doc: dict | None = None):
        """``handler(request) -> (status, data, headers)``; ``data`` is
        sent as JSON."""
        for m in methods:
            self._routes.setdefault(route, {})[m.upper()] = handler
        # merge: several connectors may share a route with distinct methods
        self._openapi.setdefault(route, {}).update(schema_doc or {})

    def _cors_headers(self) -> dict[str, str]:
        return {"Access-Control-Allow-Origin": "*"} if self.with_cors else {}

    def _dispatch(self, request: _Request):
        methods = self._routes.get(request.path)
        if methods is None:
            return 404, _Text("404: Not Found"), None
        if request.method == "OPTIONS" and self.with_cors:
            return 200, _Text(""), {"Access-Control-Allow-Methods": ", ".join(sorted(methods)),
                               "Access-Control-Allow-Headers": "*"}
        handler = methods.get(request.method)
        if handler is None:
            return 405, _Text("405: Method Not Allowed"), {"Allow": ", ".join(sorted(methods))}
        return handler(request)

    @property
    def serving(self) -> bool:
        return self._server is not None

    def start(self) -> None:
        """Bind and serve on a daemon thread (no-op when serving). A taken
        port falls back to an ephemeral one, as the reference does; ``port``
        then holds the bound port."""
        with self._lock:
            if self._server is not None:
                return
            try:
                server = _Server((self.host, self.port), self)
            except OSError as exc:
                server = _Server((self.host, 0), self)
                logger.warning("serving port %d unavailable (%s); endpoint bound to an ephemeral port instead",
                               self.port, exc)
            self.port = server.server_address[1]
            self._server = server
            self._thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                                            daemon=True, name="pathway:http")
            self._thread.start()
            _ACTIVE_WEBSERVERS.add(self)
            _BOUND_PORTS.append(self.port)

    def close(self) -> None:
        """Stop serving and close the listening socket (no-op when closed)."""
        with self._lock:
            server, thread = self._server, self._thread
            self._server = self._thread = None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        _ACTIVE_WEBSERVERS.discard(self)


class _PipelineStopped(Exception):
    """The engine's run ended before the request was answered."""


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    methods: list[str] = ("POST",),
    schema: type[Schema] | None = None,
    format: str = "custom",
    autocommit_duration_ms: int | None = 50,
    keep_queries: bool = False,
    delete_completed_queries: bool = True,
    request_validator=None,
    validate_schema: bool | None = None,
    documentation: EndpointDocumentation | None = None,
    serving=None,
) -> tuple[Table, Any]:
    """Expose an HTTP endpoint as an input table. Returns
    (query_table, response_writer); call response_writer(result_table)
    where result_table has a `result` column and query keys.

    ``format``: ``"custom"`` decodes a JSON body into schema columns;
    ``"raw"`` feeds the request body as text into the ``query`` column.
    GET requests take their fields from the query string.
    ``documentation``: EndpointDocumentation rendered into ``/_schema``.
    ``validate_schema``: answer 400 for payloads that don't match the
    schema (missing required fields, scalar type mismatches); defaults
    to on for ``custom``-format endpoints with an explicit schema.
    Every request logs one structured JSON access record.

    ``serving``: a :class:`pathway_tpu_torch.serving.ServingConfig` puts the
    endpoint behind the serving plane: admission control (bounded
    deadline-ordered queue, optional token-bucket rate limit), per-request
    deadlines (``X-Pathway-Deadline-Ms`` or the config's
    ``default_deadline_ms``), load shedding with typed 429/503 responses,
    reduced work (``k`` clamped to ``degrade_top_k``, ``rerank`` off) under
    ``shed="degrade"``, and adaptive batching of queries into one engine
    commit. Without it the endpoint still honours a client deadline header
    (expiry answers a typed 503), but nothing bounds the queue."""
    if webserver is None:
        if host is None or port is None:
            raise ValueError("rest_connector needs host and port, or a webserver")
        webserver = PathwayWebserver(host, port)
    if format not in ("custom", "raw"):
        raise ValueError(f"unknown format {format!r}; expected 'custom' or 'raw'")
    if documentation is None:
        documentation = EndpointDocumentation()

    explicit_schema = schema is not None
    if schema is None:
        schema = schema_builder({"query": ColumnDefinition(dtype=dt.JSON)}, name="RestSchema")
    if validate_schema is None:
        validate_schema = format == "custom" and explicit_schema
    dtypes = schema.dtypes()
    names = list(dtypes.keys())

    pending: dict[int, concurrent.futures.Future] = {}
    pending_lock = threading.Lock()
    ctx_holder: dict[str, StreamingContext] = {}
    started = threading.Event()

    G.serving_endpoints.append(
        {
            "route": route,
            "kind": "rest_connector",
            "protected": serving is not None,
            "deadline_ms": serving.default_deadline_ms if serving is not None else None,
            "batch_window_ms": serving.batch_window_ms if serving is not None else None,
        }
    )
    admission = AdmissionController(serving, route=route) if serving is not None else None

    def _dispatch(items: list[tuple[int, tuple]]) -> None:
        """Fused engine dispatch: one commit for a whole batch of queries
        (runs on the batcher's worker thread)."""
        ctx = ctx_holder.get("ctx")
        if ctx is None:
            raise RuntimeError("pipeline not running")
        for key, row in items:
            ctx.session.insert(key, row)
        ctx.session.commit()

    batcher = AdaptiveBatcher(_dispatch, config=serving, name=f"rest:{route}") if serving is not None else None

    def _overload_response(respond, exc: OverloadError):
        headers = {}
        if exc.retry_after_s is not None:
            headers["Retry-After"] = f"{max(0.0, exc.retry_after_s):.3f}"
        return respond(exc.to_response(), status=exc.status, headers=headers)

    def handler(request: _Request):
        qid = str(uuid.uuid4())
        log_ctx = _LoggingContext(request, qid)
        t_start = time.monotonic()
        # request-journey tracing: continue the client's W3C trace when a
        # traceparent came in, else start a fresh one; every response,
        # sheds and degraded replies included, echoes the trace id
        inbound = TraceContext.from_traceparent(request.headers.get(TRACEPARENT_HEADER)) if tracing_enabled() else None
        tenant = request.headers.get(TENANT_HEADER) or None
        with trace_span("request", ctx=inbound, new_trace=True, boundary=True, route=route,
                        **({"tenant": tenant} if tenant else {})) as root_sp:
            trace_id = root_sp.trace_id if root_sp is not None else ""

            def respond(data, status=200, headers=None):
                if trace_id:
                    headers = dict(headers or {})
                    headers[TRACE_RESPONSE_HEADER] = trace_id
                if FRESHNESS.active():
                    # answer-level staleness bound: now - min(visible
                    # watermark) over every registered index
                    bound = FRESHNESS.answer_bound()
                    if bound is not None:
                        headers = dict(headers or {})
                        headers[FRESHNESS_HEADER] = f"{bound['staleness_ms']:.1f}"
                        FRESHNESS.observe_answer(tenant=tenant)
                        if root_sp is not None:
                            root_sp.attrs["freshness_ms"] = round(bound["staleness_ms"], 3)
                            root_sp.attrs["freshness_wm_epoch"] = bound["wm_epoch"]
                log_ctx.log_response(status)
                return status, data, headers

            # per-request deadline: the client header wins, then the serving
            # config's default, then unbounded
            deadline = Deadline.from_header(
                request.headers.get(DEADLINE_HEADER), serving.default_deadline_ms if serving is not None else None
            )
            ticket = None
            if admission is not None:
                if batcher.error is not None:
                    return respond({"error": f"serving plane failed: {batcher.error!r}"}, status=500)
                try:
                    ticket = admission.admit(deadline, tenant=tenant)
                except OverloadError as exc:
                    return _overload_response(respond, exc)
            try:
                return _serve_admitted(request, respond, deadline, ticket, qid, tenant)
            finally:
                if ticket is not None:
                    admission.release(ticket)
                    SERVING_METRICS.observe_stage("total", time.monotonic() - t_start)

    def _serve_admitted(request: _Request, respond, deadline, ticket, qid, tenant=None):
        if request.method == "GET":
            payload = dict(request.query)
        elif format == "raw":
            payload = {"query": request.text()}
        else:
            try:
                payload = request.json()
            except ValueError:
                payload = {"query": request.text()}
        if validate_schema:
            problem = validate_payload(payload, schema)
            if problem is not None:
                return respond({"error": problem}, status=400)
        if request_validator is not None:
            try:
                request_validator(payload)
            except Exception as e:
                return respond({"error": str(e)}, status=400)

        values: dict[str, Any] = {}
        for n in names:
            if n == "id":
                continue
            v = payload.get(n)
            props = schema.columns().get(n)
            if v is None and props is not None and props.has_default_value:
                v = props.default_value
            if dt.unoptionalize(dtypes[n]) is dt.JSON and not isinstance(v, Json):
                v = Json(v)
            values[n] = v
        degraded = ticket is not None and ticket.degraded
        if degraded:
            # shed="degrade": serve reduced top-k instead of rejecting, and
            # skip the rerank where the endpoint has one. A tenant quota's
            # min_top_k is that tenant's floor: degradation never clamps
            # below it.
            floor_k = serving.degrade_top_k
            if tenant is not None:
                from ...tenancy.config import active_tenancy

                cfg = active_tenancy()
                quota = cfg.quota_for(tenant) if cfg is not None else None
                if quota is not None and quota.min_top_k is not None:
                    floor_k = max(floor_k, quota.min_top_k)
            k = values.get("k")
            if isinstance(k, int) and k > floor_k:
                values["k"] = floor_k
            if isinstance(values.get("rerank"), bool):
                values["rerank"] = False
        key = int(ref_scalar(qid))
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with pending_lock:
            pending[key] = fut
        # the request's trace follows its row into the engine's epoch thread
        ROW_TRACES.register(key, current_trace())
        try:
            started.wait(timeout=30)
            ctx = ctx_holder.get("ctx")
            if ctx is None:
                return respond({"error": "pipeline not running"}, status=503)
            row = tuple(values.get(n) for n in names)
            if batcher is not None:
                # adaptive batching: concurrent queries fuse into one commit
                batcher.submit((key, row), deadline, tenant=tenant)
            else:
                ctx.session.insert(key, row)
                ctx.session.commit()
            # the wait is bounded by the request's remaining budget;
            # unbounded deadlines keep a 120 s backstop
            remaining = deadline.remaining()
            try:
                # the wait for the engine's reply: the part of the journey
                # the queue and dispatch spans do not cover
                with trace_span("pipeline"):
                    result = fut.result(timeout=min(remaining, 120.0))
            except concurrent.futures.TimeoutError:
                if remaining >= 120.0:
                    return respond({"error": "timeout"}, status=504)
                if ticket is not None:
                    exc = admission.expire(ticket)
                else:
                    exc = DeadlineExceeded("deadline expired before the pipeline produced a response")
                return _overload_response(respond, exc)
            except _PipelineStopped:
                return respond({"error": "pipeline not running"}, status=503)
        finally:
            ROW_TRACES.forget(key)
            with pending_lock:
                pending.pop(key, None)
        if isinstance(result, Json):
            result = result.value
        return respond(_jsonable(result), headers={"X-Pathway-Degraded": "1"} if degraded else None)

    docs: dict = {}
    for m in methods:
        docs.update(documentation.generate_docs(format, m, schema))
    webserver.add_route(route, list(methods), handler, schema_doc=docs)

    def reader(ctx: StreamingContext) -> None:
        ctx_holder["ctx"] = ctx
        if batcher is not None:
            # query-dispatch slots: epoch completions feed the batcher's
            # latency EWMA and wake its worker
            batcher.attach_engine(ctx.session.node.graph)
        started.set()
        webserver.start()
        ctx.wait_stopped()  # serve until the engine's run ends
        ctx_holder.pop("ctx", None)
        webserver.close()
        if batcher is not None:
            batcher.stop()
        with pending_lock:
            waiting = list(pending.values())
        for f in waiting:
            _resolve(f, exc=_PipelineStopped())

    table = input_table_from_reader(
        schema, reader, name=f"rest:{route}", autocommit_duration_ms=autocommit_duration_ms
    )

    def response_writer(result_table: Table) -> None:
        names_r = result_table.column_names()
        result_idx = names_r.index("result") if "result" in names_r else 0

        def on_change(key, row, time, diff):
            if diff <= 0:
                return
            with pending_lock:
                f = pending.get(int(key))
            if f is not None:
                _resolve(f, value=row.get("result") if isinstance(row, dict) else row[result_idx])

        from ..._graph_hooks import subscribe_raw

        subscribe_raw(result_table, on_change)

    return table, response_writer


def _resolve(fut: concurrent.futures.Future, value=None, exc: BaseException | None = None) -> None:
    """Complete ``fut`` unless another thread already has."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except concurrent.futures.InvalidStateError:
        pass

