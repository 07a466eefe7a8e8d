"""Run telemetry: spans + counters, pluggable exporter.

The port's copy of the reference's ``internals/telemetry.py`` (upstream
Pathway's telemetry.rs: OTLP traces/metrics of a run). This build never
phones home: the exporter only activates when
PATHWAY_TELEMETRY_SERVER / monitoring_server is explicitly configured.
Two exporter shapes:

- a local file path -> JSON-lines spans/metrics (debug-friendly), or
- an http(s) endpoint -> OpenTelemetry OTLP/HTTP **JSON** protocol
  (POST <endpoint>/v1/traces and /v1/metrics) over ``urllib``,
  consumable by any OTel collector. Encoded by hand (the OTLP JSON mapping is a stable public wire
  format; the container ships no OTel SDK).
"""

from __future__ import annotations

import json
import os
import secrets
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start: float
    end: float | None = None
    attrs: dict = field(default_factory=dict)
    start_unix_ns: int = 0
    end_unix_ns: int = 0
    span_id: str = ""
    parent_span_id: str = ""
    #: per-span trace override: request-journey spans (the tracing
    #: plane) keep their own W3C trace id instead of the run's
    trace_id: str = ""

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.monotonic()) - self.start) * 1000.0


def _otlp_attr(key, value):
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": str(key), "value": v}


class Telemetry:
    """Collects spans/metrics for one run. ``endpoint``: local file
    path (JSON lines) or an http(s) OTLP collector base URL."""

    SERVICE = "pathway_tpu_torch"

    def __init__(self, endpoint: str | None = None):
        self.endpoint = endpoint or os.environ.get("PATHWAY_TELEMETRY_SERVER")
        self.spans: list[Span] = []
        self.metrics: dict[str, float] = {}
        self.trace_id = secrets.token_hex(16)

    @property
    def _is_http(self) -> bool:
        return self.endpoint is not None and self.endpoint.startswith(
            ("http://", "https://")
        )

    @property
    def enabled(self) -> bool:
        if self.endpoint is None:
            return False
        if "://" in self.endpoint and not self._is_http:
            return False  # unknown scheme: refuse rather than guess
        return True

    @contextmanager
    def span(self, name: str, **attrs):
        s = Span(
            name,
            time.monotonic(),
            attrs=dict(attrs),
            start_unix_ns=time.time_ns(),
            span_id=secrets.token_hex(8),
        )
        self.spans.append(s)
        try:
            yield s
        finally:
            s.end = time.monotonic()
            s.end_unix_ns = time.time_ns()

    def add_span(
        self,
        name: str,
        *,
        start_unix_ns: int,
        end_unix_ns: int,
        parent: "Span | None" = None,
        attrs: dict | None = None,
        trace_id: str = "",
        span_id: str = "",
        parent_span_id: str = "",
    ) -> Span:
        """Record an already-measured span (the profiler replays its
        per-operator timings here after the run); nests under ``parent``
        via parentSpanId while sharing this run's trace_id. The tracing
        plane passes explicit ``trace_id``/``span_id``/``parent_span_id``
        so request journeys export under their real W3C ids."""
        s = Span(
            name,
            time.monotonic(),
            end=time.monotonic(),
            attrs=dict(attrs or {}),
            start_unix_ns=start_unix_ns,
            end_unix_ns=end_unix_ns,
            span_id=span_id or secrets.token_hex(8),
            parent_span_id=(
                parent_span_id
                if parent_span_id
                else (parent.span_id if parent is not None else "")
            ),
            trace_id=trace_id,
        )
        self.spans.append(s)
        return s

    def gauge(self, name: str, value: float) -> None:
        self.metrics[name] = float(value)

    # ---- OTLP/HTTP JSON encoding (trace/v1 + metrics/v1) ----

    def _otlp_resource(self) -> dict:
        return {
            "attributes": [
                _otlp_attr("service.name", self.SERVICE),
                _otlp_attr("process.pid", os.getpid()),
            ]
        }

    def otlp_traces_payload(self) -> dict:
        spans = [
            {
                "traceId": s.trace_id or self.trace_id,
                "spanId": s.span_id or secrets.token_hex(8),
                **({"parentSpanId": s.parent_span_id} if s.parent_span_id else {}),
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(s.start_unix_ns),
                "endTimeUnixNano": str(s.end_unix_ns or time.time_ns()),
                "attributes": [_otlp_attr(k, v) for k, v in s.attrs.items()],
                "status": {},
            }
            for s in self.spans
        ]
        return {
            "resourceSpans": [
                {
                    "resource": self._otlp_resource(),
                    "scopeSpans": [
                        {"scope": {"name": self.SERVICE}, "spans": spans}
                    ],
                }
            ]
        }

    def otlp_metrics_payload(self) -> dict:
        now = str(time.time_ns())
        metrics = [
            {
                "name": name,
                "gauge": {
                    "dataPoints": [
                        {"timeUnixNano": now, "asDouble": value}
                    ]
                },
            }
            for name, value in self.metrics.items()
        ]
        return {
            "resourceMetrics": [
                {
                    "resource": self._otlp_resource(),
                    "scopeMetrics": [
                        {"scope": {"name": self.SERVICE}, "metrics": metrics}
                    ],
                }
            ]
        }

    def _post(self, path: str, payload: dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.endpoint.rstrip("/") + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        urllib.request.urlopen(req, timeout=5.0).read()

    def flush(self) -> None:
        if not self.enabled:
            return
        try:
            if self._is_http:
                if self.spans:
                    self._post("/v1/traces", self.otlp_traces_payload())
                if self.metrics:
                    self._post("/v1/metrics", self.otlp_metrics_payload())
                return
            with open(self.endpoint, "a") as f:
                f.write(
                    json.dumps(
                        {
                            "ts": time.time(),
                            "spans": [
                                {"name": s.name, "ms": round(s.duration_ms, 3), **s.attrs}
                                for s in self.spans
                            ],
                            "metrics": self.metrics,
                        }
                    )
                    + "\n"
                )
        except OSError:
            pass  # telemetry must never break the run
