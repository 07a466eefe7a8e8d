"""W3C trace context for the request-journey tracing plane.

The port's copy of the reference's ``tracing/context.py``. A
:class:`TraceContext` is the (trace_id, span_id) pair that rides a
request through the serving plane, exactly as the request
:class:`~pathway_tpu_torch.serving.deadline.Deadline` does: the HTTP handler
parses the inbound ``traceparent`` header (or the admission controller
generates a fresh context), binds it to the current execution context
with :class:`bind_trace`, and every downstream layer picks it up with
:func:`current_trace` — no explicit threading through call signatures.

The wire format is the W3C Trace Context ``traceparent`` header
(``00-<32 hex trace id>-<16 hex span id>-<2 hex flags>``); responses
echo the trace id in the ``X-Pathway-Trace`` header so a client can
quote it back — including shed (429/503) and degraded responses, which
are exactly the ones worth attributing.

**Across threads.** The port's REST server answers each connection on a
thread of its own, and the engine runs its epochs on another, so a bound
context does not reach the engine by itself. :data:`ROW_TRACES` carries
it: the REST reader registers each request's row key under the request's
context before the row enters the engine, and the engine binds the
contexts of the rows an operator is working on (:meth:`RowTraces.bind`)
while it works on them. One piece of work that serves several requests
(a batched top-k, a batched rerank) binds a :class:`TraceFanout`, and a
span recorded under it is recorded once into each request's trace, each
with its own span id, so no span belongs to two requests.
"""

from __future__ import annotations

import contextvars
import re
import secrets
import threading
from typing import Any, Iterable, Optional

#: Inbound W3C header (lowercase per spec; aiohttp headers are
#: case-insensitive anyway).
TRACEPARENT_HEADER = "traceparent"

#: Response header echoing the request's trace id (satellite: overload
#: and degraded replies carry it so rejected requests are attributable).
TRACE_RESPONSE_HEADER = "X-Pathway-Trace"

_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})"
    r"-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


def gen_trace_id() -> str:
    return secrets.token_hex(16)


def gen_span_id() -> str:
    return secrets.token_hex(8)


class TraceContext:
    """One point in a request journey: the trace and the span that is
    current at this point (new child spans parent under ``span_id``)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, *, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(gen_trace_id(), gen_span_id())

    @classmethod
    def from_traceparent(cls, header_value: str | None) -> "TraceContext | None":
        """Parse a W3C ``traceparent`` header; None for an absent or
        malformed header (a bad header never rejects the request — the
        server just starts a fresh trace, mirroring
        ``Deadline.from_header``). All-zero ids are invalid per spec."""
        if not header_value:
            return None
        m = _TRACEPARENT_RE.match(header_value.strip().lower())
        if m is None:
            return None
        trace_id, span_id = m.group("trace_id"), m.group("span_id")
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        sampled = bool(int(m.group("flags"), 16) & 0x01)
        return cls(trace_id, span_id, sampled=sampled)

    def to_traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    def child(self) -> "TraceContext":
        """Same trace, fresh span id (the caller records the span)."""
        return TraceContext(self.trace_id, gen_span_id(), sampled=self.sampled)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id[:8]}…/{self.span_id})"


class TraceFanout:
    """Several request journeys served by one piece of work: a span
    recorded under it is recorded into each member's trace."""

    __slots__ = ("members",)

    def __init__(self, members: Iterable[TraceContext]):
        self.members = tuple(members)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceFanout({len(self.members)} traces)"


def trace_members(ctx) -> tuple:
    """The request contexts a bound context stands for: itself, or a
    fan-out's members; none for ``None``."""
    if ctx is None:
        return ()
    if isinstance(ctx, TraceFanout):
        return ctx.members
    return (ctx,)


#: In-context propagation, mirroring ``serving.deadline._CURRENT``: the
#: handler binds the request's context here; admission, the batcher,
#: and the ops layers pick it up without signature changes.
_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "pathway_trace_context", default=None
)


def current_trace() -> TraceContext | None:
    """The trace context bound to the current execution context."""
    return _CURRENT.get()


class bind_trace:
    """``with bind_trace(ctx): ...`` — scope a trace context so
    :func:`current_trace` (and every span recorded below) sees it."""

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> TraceContext | None:
        self._token = _CURRENT.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None


class _Unbound:
    """The context manager :meth:`RowTraces.bind` returns when no row it
    names carries a trace: it leaves the current context alone."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        pass


_UNBOUND = _Unbound()


class RowTraces:
    """Request journeys by engine row key, so a trace follows its row from
    the HTTP thread into the engine's epoch thread. Empty (and every
    :meth:`bind` a single check) while no traced request is in flight."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_key: dict[Any, TraceContext] = {}

    def register(self, key, ctx: TraceContext | None) -> None:
        if ctx is None:
            return
        with self._lock:
            self._by_key[key] = ctx

    def forget(self, key) -> None:
        if not self._by_key:
            return
        with self._lock:
            self._by_key.pop(key, None)

    def bind(self, keys) -> Any:
        """A context manager binding the traces of ``keys``' rows: one
        context for one traced row, a :class:`TraceFanout` for several; the
        current context stays when none of the rows is traced."""
        if not self._by_key:
            return _UNBOUND
        with self._lock:
            found = [self._by_key.get(k) for k in keys]
        members, seen = [], set()
        for ctx in found:
            if ctx is not None and ctx.span_id not in seen:
                seen.add(ctx.span_id)
                members.append(ctx)
        if not members:
            return _UNBOUND
        return bind_trace(members[0] if len(members) == 1 else TraceFanout(members))

    def __len__(self) -> int:
        return len(self._by_key)

    def clear(self) -> None:
        with self._lock:
            self._by_key.clear()


#: Process-wide row-key -> request-context registry.
ROW_TRACES = RowTraces()
