"""HTTP client connectors.

The port's copy of the reference's ``io/http/_client.py`` (upstream
Pathway's python/pathway/io/http/__init__.py read :100-155 / write
:158-230, ``_streaming.py`` HttpStreamingSubject :13, ``_common.py``
Sender / RetryPolicy). Two transports:

- ``stream=True`` (or any ``delimiter`` / ``response_mapper``): one
  long-lived request; the chunked response body is split on the
  delimiter and every piece becomes a row. A drop mid-stream reconnects
  with :class:`RetryPolicy` backoff while the run is in streaming mode.
- otherwise: poll the endpoint every ``poll_interval_s`` and emit the
  records not seen in the recent-fingerprint window (a bounded LRU: a
  long poll must not grow memory without limit, and a record repeated
  beyond the window is emitted again).

The requests go through a requests-shaped session. Where the reference
imports ``requests``, the port's default is :class:`UrllibSession`, a small
one on the standard library's ``urllib.request`` (``request(...)`` with
``status_code``, ``iter_content`` over the chunks as they arrive,
``content`` / ``text`` / ``json()``); ``_session=`` injects another, as the
tests do.
"""

from __future__ import annotations

import copy
import json
import logging
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Any, Callable

from ...internals import dtype as dt
from ...internals.schema import ColumnDefinition, Schema, schema_builder
from ...internals.table import Table
from .._connector import StreamingContext, add_output_sink, input_table_from_reader
from ._retry import DEFAULT_RETRY_CODES, RequestRunner, RetryPolicy

logger = logging.getLogger(__name__)


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """``allow_redirects=False``: a 3xx answer comes back as the response."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None


class UrllibResponse:
    """A requests-shaped response: ``status_code``, ``headers``,
    ``iter_content`` (a streamed request's chunks as they arrive),
    ``content``, ``text`` and ``json()``. A request that is not streamed
    reads its body at once and closes its connection, as requests does."""

    def __init__(self, raw, stream: bool):
        self._raw = raw
        self.status_code = int(getattr(raw, "status", None) or raw.getcode())
        self.headers = dict(raw.headers.items()) if raw.headers is not None else {}
        self._content: bytes | None = None
        if not stream:
            self._content = self._read_all()

    def _read_all(self) -> bytes:
        try:
            return self._raw.read()
        finally:
            self._raw.close()

    def iter_content(self, chunk_size: int | None = None):
        """A streamed body's bytes as they arrive (``chunk_size`` caps a piece)."""
        size = chunk_size or 65536
        try:
            while True:
                piece = self._raw.read1(size) if hasattr(self._raw, "read1") else self._raw.read(size)
                if not piece:
                    return
                yield piece
        finally:
            self._raw.close()

    @property
    def content(self) -> bytes:
        if self._content is None:
            self._content = self._read_all()
        return self._content

    @property
    def text(self) -> str:
        charset = "utf-8"
        ctype = self.headers.get("Content-Type") or self.headers.get("content-type") or ""
        if "charset=" in ctype:
            charset = ctype.split("charset=", 1)[1].split(";")[0].strip() or charset
        return self.content.decode(charset, errors="replace")

    def json(self) -> Any:
        return json.loads(self.content)


class UrllibSession:
    """The default session of :func:`read` and :func:`write`: requests'
    ``request(method, url, headers=, data=, stream=, timeout=,
    allow_redirects=)`` on ``urllib.request``. ``timeout`` is requests'
    ``(connect, read)`` pair or one number; urllib applies one figure to the
    connect and to every read, the read timeout when there is one. An
    error status is a response, not an exception, as in requests."""

    def __init__(self):
        self._follow = urllib.request.build_opener()
        self._stay = urllib.request.build_opener(_NoRedirect())

    def request(self, method, url, headers=None, data=None, stream=False, timeout=None, allow_redirects=True):
        if isinstance(data, str):
            data = data.encode()
        req = urllib.request.Request(url, data=data, headers=dict(headers or {}), method=method)
        if isinstance(timeout, tuple):
            timeout = timeout[1] if timeout[1] is not None else timeout[0]
        opener = self._follow if allow_redirects else self._stay
        kwargs = {} if timeout is None else {"timeout": timeout}
        try:
            raw = opener.open(req, **kwargs)
        except urllib.error.HTTPError as err:
            return UrllibResponse(err, stream=False)
        return UrllibResponse(raw, stream=stream)


def _policy_factory(retry_policy) -> Callable[[], RetryPolicy]:
    if retry_policy is None:
        return RetryPolicy.default
    if callable(retry_policy) and not isinstance(retry_policy, RetryPolicy):
        return retry_policy
    # an instance is a prototype: each logical request restarts its schedule
    return lambda: copy.copy(retry_policy)


def split_stream(chunks, delimiter: str | bytes | None):
    """Re-frame a chunked byte stream into delimiter-separated records.

    ``delimiter=None`` means newline records with optional ``\\r``
    (the wire format of SSE-ish / JSONL endpoints).  The trailing
    unterminated piece is flushed when the stream ends.
    """
    if delimiter is None:
        sep, universal = b"\n", True
    else:
        sep = delimiter.encode() if isinstance(delimiter, str) else delimiter
        universal = False
    buffered = b""
    for chunk in chunks:
        if not chunk:
            continue
        if isinstance(chunk, str):
            chunk = chunk.encode()
        buffered += chunk
        *complete, buffered = buffered.split(sep)
        for piece in complete:
            if universal and piece.endswith(b"\r"):
                piece = piece[:-1]
            yield piece
    if buffered:
        if universal and buffered.endswith(b"\r"):
            buffered = buffered[:-1]
        yield buffered


class _RecentWindow:
    """Bounded LRU of record fingerprints for the polled transport."""

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._entries: OrderedDict[str, None] = OrderedDict()

    def check_and_add(self, fingerprint: str) -> bool:
        """True if the fingerprint was already in the window (refreshes
        its recency); False if new (and records it)."""
        if fingerprint in self._entries:
            self._entries.move_to_end(fingerprint)
            return True
        self._entries[fingerprint] = None
        while len(self._entries) > self._capacity:
            self._entries.popitem(last=False)
        return False


def stream_records(
    session: Any,
    url: str,
    *,
    method: str = "GET",
    headers: dict[str, str] | None = None,
    payload: Any = None,
    delimiter: str | bytes | None = None,
    response_mapper: Callable[[bytes], bytes] | None = None,
    once: bool = False,
    runner: RequestRunner | None = None,
    retry_policy: RetryPolicy | Callable[[], RetryPolicy] | None = None,
    max_failed_attempts_in_row: int | None = 8,
    sleep: Callable[[float], None] = time.sleep,
    stopped: Callable[[], bool] | None = None,
):
    """Yield record payloads from a long-lived streaming endpoint.

    Opens one request with ``stream=True`` and splits the chunked body
    on ``delimiter``.  A drop (connection error, mid-body exception, or
    error status) reconnects with backoff — the reconnect schedule
    restarts whenever data actually arrives, and
    ``max_failed_attempts_in_row`` consecutive dataless failures give
    up.  With ``once=True`` the body is consumed exactly one time and
    any failure raises (static-read semantics). ``stopped()`` true ends
    the generator before the next (re)connect: the reader of a run that
    has ended stops there instead of reconnecting for ever."""
    policy_factory = _policy_factory(retry_policy)
    if runner is None:
        runner = RequestRunner(
            session, retry_policy_factory=policy_factory, sleep=sleep
        )
    reconnect = policy_factory()
    drops = 0
    while stopped is None or not stopped():
        try:
            resp = runner.send(method, url, headers=headers, data=payload, stream=True)
            status = getattr(resp, "status_code", 200)
            if status >= 400:
                raise RuntimeError(f"http stream {url} answered {status}")
            for piece in split_stream(resp.iter_content(chunk_size=None), delimiter):
                if response_mapper is not None:
                    piece = response_mapper(piece)
                if not piece:
                    continue
                yield piece
                drops = 0
                reconnect = policy_factory()
        except Exception as exc:  # noqa: BLE001 - any drop reconnects; the policy decides when to give up
            drops += 1
            if once or (
                max_failed_attempts_in_row is not None
                and drops >= max_failed_attempts_in_row
            ):
                raise
            wait = reconnect.wait_duration_before_retry()
            logger.error(
                "http stream %s dropped (%s); reconnecting in %.2fs", url, exc, wait
            )
            sleep(wait)
            continue
        if once:
            return


def _emit_value(ctx: StreamingContext, value: Any) -> None:
    """Insert an already-parsed record: dicts become rows, anything else
    lands in the ``data`` column."""
    if isinstance(value, dict):
        ctx.insert(value)
    else:
        ctx.insert({"data": value})


def _emit_wire(ctx: StreamingContext, piece: bytes | str, format: str) -> bool:
    """Insert one wire-format record from the streaming transport.
    In json mode, undecodable pieces (SSE keep-alives, comments) are
    logged and skipped rather than crashing the stream.  Returns True
    if a row was produced."""
    text = piece.decode("utf-8", errors="replace") if isinstance(piece, bytes) else piece
    if format == "json":
        try:
            value = json.loads(text)
        except ValueError:
            logger.warning("http stream: skipping non-JSON record %.80r", text)
            return False
        _emit_value(ctx, value)
    else:
        ctx.insert({"data": text})
    return True


def read(
    url: str,
    *,
    schema: type[Schema] | None = None,
    format: str = "json",
    mode: str = "streaming",
    method: str = "GET",
    headers: dict[str, str] | None = None,
    payload: Any = None,
    # long-lived streaming-response transport
    stream: bool = False,
    delimiter: str | bytes | None = None,
    response_mapper: Callable[[bytes], bytes] | None = None,
    # polled transport
    poll_interval_s: float = 1.0,
    dedupe_window: int = 65536,
    # resilience
    n_retries: int = 0,
    retry_policy: RetryPolicy | Callable[[], RetryPolicy] | None = None,
    retry_codes: tuple | None = DEFAULT_RETRY_CODES,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = 30_000,
    allow_redirects: bool = True,
    max_failed_attempts_in_row: int | None = 8,
    autocommit_duration_ms: int | None = 1500,
    name: str = "http",
    _session=None,
    _sleep: Callable[[float], None] = time.sleep,
    **kwargs,
) -> Table:
    """Read an HTTP endpoint into a table.

    With ``stream=True`` (implied by ``delimiter`` or
    ``response_mapper``) a single long-lived request is made and the
    chunked response is split on ``delimiter`` (newline by default);
    each piece — optionally rewritten by ``response_mapper(bytes) ->
    bytes`` — becomes a row.  If the response drops mid-stream the
    connector reconnects with ``retry_policy`` backoff, up to
    ``max_failed_attempts_in_row`` consecutive failures (``None`` =
    reconnect forever); in static mode the stream is consumed once.

    Without ``stream`` the endpoint is polled every ``poll_interval_s``
    seconds and records are deduplicated against the last
    ``dedupe_window`` fingerprints (bounded — repeats beyond the window
    re-emit rather than leaking memory).

    ``n_retries``/``retry_codes`` bound per-request retries inside each
    attempt.  ``_session`` injects a requests-shaped client and
    ``_sleep`` a time source for tests.
    """
    if schema is None:
        schema = schema_builder(
            {"data": ColumnDefinition(dtype=dt.JSON)}, name="HttpSchema"
        )
    use_stream = stream or delimiter is not None or response_mapper is not None

    def _make_runner(session):
        return RequestRunner(
            session,
            n_retries=n_retries,
            retry_policy_factory=_policy_factory(retry_policy),
            retry_codes=retry_codes,
            connect_timeout_ms=connect_timeout_ms,
            request_timeout_ms=request_timeout_ms,
            allow_redirects=allow_redirects,
            sleep=_sleep,
        )

    def _get_session():
        return _session if _session is not None else UrllibSession()

    def stream_reader(ctx: StreamingContext) -> None:
        session = _get_session()
        for piece in stream_records(
            session,
            url,
            method=method,
            headers=headers,
            payload=payload,
            delimiter=delimiter,
            response_mapper=response_mapper,
            once=(mode == "static"),
            runner=_make_runner(session),
            retry_policy=retry_policy,
            max_failed_attempts_in_row=max_failed_attempts_in_row,
            sleep=_sleep,
            stopped=lambda: ctx.wait_stopped(0),
        ):
            if _emit_wire(ctx, piece, format):
                ctx.commit()

    def poll_reader(ctx: StreamingContext) -> None:
        session = _get_session()
        runner = _make_runner(session)
        window = _RecentWindow(dedupe_window)
        failures = 0
        while not ctx.wait_stopped(0):
            try:
                resp = runner.send(method, url, headers=headers, data=payload)
                status = getattr(resp, "status_code", 200)
                if status >= 400:
                    raise RuntimeError(f"http.read {url} answered {status}")
                body = resp.json() if format == "json" else resp.text
                failures = 0
            except Exception as e:  # noqa: BLE001 - any failed poll is retried up to the limit
                failures += 1
                if mode == "static" or (
                    max_failed_attempts_in_row is not None
                    and failures >= max_failed_attempts_in_row
                ):
                    raise
                logger.error(
                    "http.read %s failed (%s); retrying in %ss",
                    url,
                    e,
                    poll_interval_s,
                )
                _sleep(poll_interval_s)
                continue
            records = body if isinstance(body, list) else [body]
            changed = False
            for rec in records:
                fp = json.dumps(rec, sort_keys=True, default=str)
                if window.check_and_add(fp):
                    continue
                _emit_value(ctx, rec)
                changed = True
            if changed:
                ctx.commit()
            if mode == "static":
                break
            _sleep(poll_interval_s)

    return input_table_from_reader(
        schema,
        stream_reader if use_stream else poll_reader,
        name=name,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def write(
    table: Table,
    url: str,
    *,
    method: str = "POST",
    name: str = "http.write",
    n_retries: int = 0,
    retry_policy: RetryPolicy | Callable[[], RetryPolicy] | None = None,
    retry_codes: tuple | None = DEFAULT_RETRY_CODES,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = 30_000,
    allow_redirects: bool = True,
    headers: dict[str, str] | None = None,
    retry_delay_s: float | None = None,
    _session=None,
    _sleep: Callable[[float], None] = time.sleep,
    **kwargs,
) -> None:
    """POST each change of ``table`` to ``url`` as JSON (payload carries
    the row columns plus time/diff).  Failures raise after ``n_retries``
    backoff-scheduled attempts — a dead sink must fail the run, not drop
    deliveries silently.  ``retry_delay_s`` (legacy) builds a fixed-delay
    policy."""
    names = table.column_names()
    if retry_policy is None and retry_delay_s is not None:
        retry_policy = RetryPolicy(
            first_delay_ms=int(retry_delay_s * 1000), backoff_factor=1.0, jitter_ms=0
        )

    session = _session if _session is not None else UrllibSession()

    def on_change(key, row, time_, diff):
        from ..fs import _jsonable

        body = {n: _jsonable(row[n]) for n in names}
        body["time"] = time_
        body["diff"] = diff
        send_headers = {"Content-Type": "application/json", **(headers or {})}
        runner = RequestRunner(
            session,
            n_retries=n_retries,
            retry_policy_factory=_policy_factory(retry_policy),
            retry_codes=retry_codes,
            connect_timeout_ms=connect_timeout_ms,
            request_timeout_ms=request_timeout_ms,
            allow_redirects=allow_redirects,
            sleep=_sleep,
        )
        resp = runner.send(method, url, headers=send_headers, data=json.dumps(body))
        status = getattr(resp, "status_code", 200)
        if status >= 400:
            raise RuntimeError(f"http.write {url} answered {status}")

    add_output_sink(table, on_change, name=name)
