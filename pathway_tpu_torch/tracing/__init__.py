"""Request-journey tracing plane.

The port's copy of the reference's ``tracing/``. Per-request traces
across the serving path — admission, queue wait, adaptive-batch fan-in
(batch spans *link* their member request traces), the engine-side index
search and rerank (carried from the HTTP thread to the engine's epoch
thread by :data:`ROW_TRACES`), mesh per-shard top-k and merge, and
per-tick decode steps — with p99 exemplar retention and a
tail-attribution aggregator. :func:`emit_telemetry` exports the retained
traces through the run's OTLP exporter (``internals/telemetry.py``), and
``python -m pathway_tpu_torch trace`` reads the dumps.

Enable with ``pw.run(tracing=True)`` or ``PATHWAY_TRACING=1``; with
tracing off every instrumentation site is a single flag check.
"""

from __future__ import annotations

from .attribution import attribute, render_slow_report, render_waterfall, slow_report
from .context import (
    ROW_TRACES,
    TRACE_RESPONSE_HEADER,
    TRACEPARENT_HEADER,
    RowTraces,
    TraceContext,
    TraceFanout,
    bind_trace,
    current_trace,
    trace_members,
)
from .metrics import TRACING_METRICS, TracingMetrics
from .store import (
    Span,
    TRACE_STORE,
    TraceStore,
    default_trace_dir,
    list_trace_dumps,
    load_trace_dump,
    record_span,
    set_tracing_enabled,
    span,
    tracing_enabled,
)

__all__ = [
    "ROW_TRACES",
    "RowTraces",
    "Span",
    "TRACE_RESPONSE_HEADER",
    "TRACE_STORE",
    "TRACEPARENT_HEADER",
    "TRACING_METRICS",
    "TraceContext",
    "TraceFanout",
    "TraceStore",
    "TracingMetrics",
    "attribute",
    "bind_trace",
    "current_trace",
    "default_trace_dir",
    "emit_telemetry",
    "ensure_trace",
    "list_trace_dumps",
    "load_trace_dump",
    "record_span",
    "render_slow_report",
    "render_waterfall",
    "set_tracing_enabled",
    "set_worker",
    "slow_report",
    "span",
    "trace_members",
    "tracing_enabled",
]


def ensure_trace() -> TraceContext | None:
    """The current trace context, generating a fresh one when tracing
    is on and the request arrived without a ``traceparent`` — the
    admission controller calls this so even requests admitted outside
    the HTTP surface (embedded callers such as a DecodeService client) get a journey."""
    if not tracing_enabled():
        return current_trace()
    ctx = current_trace()
    return ctx if ctx is not None else TraceContext.new()


def set_worker(worker_id: int) -> None:
    """Cluster-worker initialization: label this process's spans and
    start buffering them for the coordinator piggyback."""
    TRACE_STORE.configure_worker(worker_id)


def emit_telemetry(telemetry) -> int:
    """Export the retained exemplar traces through the run's OTLP exporter
    (:class:`~pathway_tpu_torch.internals.telemetry.Telemetry`) with their
    *real* per-request trace ids, so an OTel collector shows request
    journeys alongside the run / profiler spans."""
    count = 0
    for tr in TRACE_STORE.exemplar_traces():
        for s in tr["spans"]:
            start_ns = int(float(s.get("start", 0.0)) * 1e9)
            end_ns = start_ns + int(float(s.get("dur_ms", 0.0)) * 1e6)
            attrs = dict(s.get("attrs") or {})
            attrs["pathway.stage"] = s.get("stage", "?")
            attrs["pathway.worker"] = s.get("worker", 0)
            telemetry.add_span(
                f"request.{s.get('stage', '?')}",
                start_unix_ns=start_ns,
                end_unix_ns=end_ns,
                attrs=attrs,
                trace_id=s.get("trace", ""),
                span_id=s.get("span", ""),
                parent_span_id=s.get("parent", ""),
            )
            count += 1
    return count
