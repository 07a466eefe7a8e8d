"""Per-operator run profiler.

The port's copy of the reference's ``internals/profiler.py``. Every
``Node``'s work is timed per epoch by the scheduler
(``EngineGraph._topo_pass``, ``ShardCluster._sweep``), the event-time
watermark lag of time-aware operators is sampled at epoch boundaries, and
the batched UDF / model path reports its build-vs-execute split through
:func:`record_jit` / :func:`wrap_jit` (the port has no jit cache: a call
that builds a kernel library, ``ops/_build.py``, is its "compile").

Everything is keyed by the same ``(node.id, node.name)`` identity (plus
the build-time ``user_frame``) that ``EngineError`` cites, so a slow
operator in a trace names the same source line a failing one would.

Four consumers read a :class:`RunProfiler`:

- ``internals.monitoring.StatsMonitor`` — dashboard self-time/lag columns;
- ``internals.http_monitoring`` — ``pathway_operator_self_time_seconds``
  Prometheus histograms + ``pathway_operator_event_lag_seconds`` gauges;
- ``internals.telemetry.Telemetry`` — per-operator child spans under the
  run span (same trace_id), via :meth:`RunProfiler.emit_telemetry`;
- :meth:`RunProfiler.write_chrome_trace` — a Chrome-trace-event JSON
  file (``pw.run(profile=...)`` / ``PATHWAY_PROFILE`` /
  ``python -m pathway_tpu_torch profile``), loadable in Perfetto: one
  track per worker, one slice per node-epoch.

:data:`ENCODER_KERNEL_STATS` counts the encoder's dispatches (real,
computed, padded and skipped tokens, model FLOPs) for the encode MFU, which
the chip ledger divides by the card's dense bf16 peak.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any


# Prometheus-style le bounds for the bounded per-node self-time
# histograms (seconds). 12 buckets + +Inf: 10us .. 30s covers a python
# operator epoch from trivial map to a pathological stall.
HISTOGRAM_BOUNDS = (
    1e-5,
    1e-4,
    3e-4,
    1e-3,
    3e-3,
    1e-2,
    3e-2,
    1e-1,
    3e-1,
    1.0,
    3.0,
    30.0,
)


class LatencyHistogram:
    """Fixed-bound latency histogram (bounded memory per node)."""

    __slots__ = ("counts", "total", "count")

    def __init__(self):
        self.counts = [0] * (len(HISTOGRAM_BOUNDS) + 1)  # last = +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        for i, bound in enumerate(HISTOGRAM_BOUNDS):
            if seconds <= bound:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += seconds
        self.count += 1

    def cumulative(self) -> list[tuple[str, int]]:
        """Prometheus exposition order: (le, cumulative_count) pairs."""
        out = []
        acc = 0
        for bound, c in zip(HISTOGRAM_BOUNDS, self.counts):
            acc += c
            out.append((repr(bound), acc))
        out.append(("+Inf", acc + self.counts[-1]))
        return out


def _event_time_seconds(value: Any) -> float | None:
    """Best-effort conversion of an event-time watermark to unix
    seconds: datetimes via .timestamp(), numbers taken as seconds.
    Non-temporal watermarks (strings, tuples) yield None."""
    ts = getattr(value, "timestamp", None)
    if callable(ts):
        try:
            return float(ts())
        except (ValueError, OverflowError, OSError):
            return None
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    return None


class NodeProfile:
    """Accumulated per-(worker, node) timing."""

    __slots__ = (
        "node_id",
        "name",
        "worker_id",
        "trace",
        "epochs",
        "self_time_ns",
        "batches",
        "rows_in",
        "rows_out",
        "histogram",
        "watermark",
        "event_lag_s",
        "first_work_ns",
        "last_work_ns",
        "_last_rows_in",
        "_last_rows_out",
    )

    def __init__(self, worker_id: int, node_id: int, name: str, trace=None):
        self.worker_id = worker_id
        self.node_id = node_id
        self.name = name
        self.trace = trace  # build-time user Frame (internals.trace)
        self.epochs = 0
        self.self_time_ns = 0
        self.batches = 0
        self.rows_in = 0
        self.rows_out = 0
        self.histogram = LatencyHistogram()
        self.watermark: Any = None
        self.event_lag_s: float | None = None
        self.first_work_ns: int | None = None  # perf offsets from run start
        self.last_work_ns: int | None = None
        self._last_rows_in = 0
        self._last_rows_out = 0

    @property
    def key(self) -> str:
        return f"{self.node_id}:{self.name}"

    @property
    def self_time_s(self) -> float:
        return self.self_time_ns / 1e9


class RunProfiler:
    """Collects per-operator timing for one run.

    One instance is shared by every worker shard's ``EngineGraph``
    (``graph_runner.attach_profiler``); per-worker state is partitioned
    by ``worker_id`` so the only cross-thread structure is the profiles
    dict itself, guarded by a lock on insert."""

    def __init__(self, max_events: int = 200_000):
        self._t0_perf_ns = time.perf_counter_ns()
        self._t0_unix_ns = time.time_ns()
        self.profiles: dict[tuple[int, int], NodeProfile] = {}
        self.max_events = max_events
        self.events: list[dict] = []  # chrome trace events
        self.dropped_events = 0
        self.jit_stats: dict[str, dict[str, float]] = {}
        #: the overlapped epoch pipeline's attribution (engine/pipeline.py):
        #: host_prep_s / device_wait_s / overlap_s / overlap_ratio /
        #: staged_epochs; None until a pipelined run reports in
        self.pipeline: dict | None = None
        self._lock = threading.Lock()
        # per-worker per-epoch scratch: node_id -> [ns, batches, start_ns]
        self._scratch: dict[int, dict[int, list]] = {}
        self._epoch_start: dict[int, int] = {}

    # ---- scheduler hooks (engine/dataflow.py) ----

    def now_ns(self) -> int:
        """Offset from run start, perf-clock."""
        return time.perf_counter_ns() - self._t0_perf_ns

    def begin_epoch(self, worker_id: int) -> None:
        self._scratch[worker_id] = {}
        self._epoch_start[worker_id] = self.now_ns()

    def record_process(self, worker_id: int, node, start_ns: int, dur_ns: int) -> None:
        """One ``node.process``/``time_end`` invocation; start_ns is a
        run-start offset (see :meth:`now_ns`)."""
        scratch = self._scratch.setdefault(worker_id, {})
        ent = scratch.get(node.id)
        if ent is None:
            scratch[node.id] = [dur_ns, 1, start_ns]
        else:
            ent[0] += dur_ns
            ent[1] += 1

    def end_epoch(self, worker_id: int, engine, epoch_time) -> None:
        """Epoch closed on ``worker_id``: fold the scratch into the
        per-node profiles and emit one trace slice per node-epoch."""
        scratch = self._scratch.pop(worker_id, {})
        epoch_start = self._epoch_start.pop(worker_id, self.now_ns())
        now_unix = time.time()
        for node in engine.nodes:
            prof = self.profiles.get((worker_id, node.id))
            if prof is None:
                trace = getattr(node, "user_frame", None)
                with self._lock:
                    prof = self.profiles.setdefault(
                        (worker_id, node.id),
                        NodeProfile(worker_id, node.id, node.name, trace),
                    )
            ent = scratch.get(node.id)
            ns, batches, start_ns = (ent if ent is not None else (0, 0, epoch_start))
            prof.epochs += 1
            prof.self_time_ns += ns
            prof.batches += batches
            prof.histogram.observe(ns / 1e9)
            if ent is not None:
                if prof.first_work_ns is None:
                    prof.first_work_ns = start_ns
                prof.last_work_ns = start_ns + ns
            stats = node.stats
            prof.rows_in, prof.rows_out = stats.rows_in, stats.rows_out
            rows_in_d = stats.rows_in - prof._last_rows_in
            rows_out_d = stats.rows_out - prof._last_rows_out
            prof._last_rows_in, prof._last_rows_out = stats.rows_in, stats.rows_out
            # event-time watermark lag: any node lowered with a time_fn
            # (Buffer/Forget/Freeze) exposes .watermark
            if getattr(node, "time_fn", None) is not None:
                wm = getattr(node, "watermark", None)
                if wm is not None:
                    prof.watermark = wm
                    wm_s = _event_time_seconds(wm)
                    if wm_s is not None:
                        prof.event_lag_s = now_unix - wm_s
            self._emit_slice(
                worker_id,
                node,
                epoch_time,
                start_ns,
                ns,
                rows_in_d,
                rows_out_d,
                prof,
            )

    def _emit_slice(
        self, worker_id, node, epoch_time, start_ns, dur_ns, rows_in, rows_out, prof
    ) -> None:
        if len(self.events) >= self.max_events:
            self.dropped_events += 1
            return
        args = {
            "node_id": node.id,
            "epoch": int(epoch_time) if epoch_time is not None else -1,
            "rows_in": rows_in,
            "rows_out": rows_out,
        }
        if prof.trace is not None:
            args["file"] = prof.trace.filename
            args["line"] = prof.trace.line_number
        if prof.event_lag_s is not None:
            args["event_lag_s"] = round(prof.event_lag_s, 6)
        with self._lock:
            self.events.append(
                {
                    "name": node.name,
                    "cat": "operator",
                    "ph": "X",
                    "ts": start_ns / 1000.0,  # microseconds
                    "dur": dur_ns / 1000.0,
                    "pid": 0,
                    "tid": worker_id,
                    "args": args,
                }
            )

    # ---- jit compile/execute split (models + jit-batched UDFs) ----

    # ---- overlapped epoch pipeline (engine/pipeline.py) ----

    def observe_pipeline(self, stats) -> None:
        """Fold the pipeline's host-prep, device-wait and overlap
        attribution into the profile (called once per executed epoch with
        the run's cumulative ``PipelineStats``; the last observation wins,
        the stats are monotone)."""
        with self._lock:
            self.pipeline = stats.as_dict()

    def record_jit(
        self, name: str, phase: str, dur_ns: int, n_rows: int = 0
    ) -> None:
        """``phase``: "compile" (the call built a kernel library) or
        "execute" (dur is the dispatch wall time — device work may still be
        in flight)."""
        with self._lock:
            ent = self.jit_stats.setdefault(
                name,
                {"compile_ns": 0, "execute_ns": 0, "compiles": 0, "calls": 0, "rows": 0},
            )
            ent[f"{phase}_ns"] = ent.get(f"{phase}_ns", 0) + dur_ns
            ent["compiles" if phase == "compile" else "calls"] += 1
            ent["rows"] += n_rows
            if len(self.events) < self.max_events:
                self.events.append(
                    {
                        "name": f"{name} [{phase}]",
                        "cat": "jit",
                        "ph": "X",
                        "ts": (self.now_ns() - dur_ns) / 1000.0,
                        "dur": dur_ns / 1000.0,
                        "pid": 0,
                        "tid": "jit",
                        "args": {"phase": phase, "rows": n_rows},
                    }
                )
            else:
                self.dropped_events += 1

    # ---- aggregate views ----

    def by_operator(self) -> dict[str, dict]:
        """Merge workers: "id:name" -> totals (the label space the
        monitoring snapshot and the Prometheus endpoint share)."""
        out: dict[str, dict] = {}
        with self._lock:
            profs = list(self.profiles.values())
        for p in profs:
            agg = out.setdefault(
                p.key,
                {
                    "name": p.name,
                    "node_id": p.node_id,
                    "self_time_s": 0.0,
                    "epochs": 0,
                    "batches": 0,
                    "rows_in": 0,
                    "rows_out": 0,
                    "event_lag_s": None,
                    "trace": p.trace,
                    "histogram": LatencyHistogram(),
                },
            )
            agg["self_time_s"] += p.self_time_s
            agg["epochs"] = max(agg["epochs"], p.epochs)
            agg["batches"] += p.batches
            agg["rows_in"] += p.rows_in
            agg["rows_out"] += p.rows_out
            if p.event_lag_s is not None:
                lag = agg["event_lag_s"]
                agg["event_lag_s"] = (
                    p.event_lag_s if lag is None else max(lag, p.event_lag_s)
                )
            h = agg["histogram"]
            for i, c in enumerate(p.histogram.counts):
                h.counts[i] += c
            h.total += p.histogram.total
            h.count += p.histogram.count
        return out

    # ---- surface 3: per-operator OTLP child spans ----

    def emit_telemetry(self, telemetry, parent=None) -> None:
        """Append one child span per operator (under ``parent``, the
        run span) and the jit split as gauges. Spans reuse the run's
        trace_id and carry the node's build-time source location."""
        for key, agg in sorted(self.by_operator().items()):
            attrs = {
                "pathway.node_id": agg["node_id"],
                "pathway.node_name": agg["name"],
                "pathway.self_time_s": round(agg["self_time_s"], 9),
                "pathway.epochs": agg["epochs"],
                "pathway.rows_in": agg["rows_in"],
                "pathway.rows_out": agg["rows_out"],
            }
            trace = agg["trace"]
            if trace is not None:
                attrs["code.filepath"] = trace.filename
                if trace.line_number is not None:
                    attrs["code.lineno"] = trace.line_number
                attrs["code.function"] = trace.function
            if agg["event_lag_s"] is not None:
                attrs["pathway.event_lag_s"] = round(agg["event_lag_s"], 6)
            # place the span at the node's observed work window
            prof_times = [
                (p.first_work_ns, p.last_work_ns)
                for p in self.profiles.values()
                if p.key == key and p.first_work_ns is not None
            ]
            if prof_times:
                start_off = min(t[0] for t in prof_times)
                end_off = max(t[1] for t in prof_times)
            else:
                start_off = end_off = 0
            telemetry.add_span(
                f"operator/{agg['name']}",
                start_unix_ns=self._t0_unix_ns + start_off,
                end_unix_ns=self._t0_unix_ns + max(end_off, start_off),
                parent=parent,
                attrs=attrs,
            )
        for name, ent in sorted(self.jit_stats.items()):
            telemetry.gauge(f"jit_compile_seconds/{name}", ent["compile_ns"] / 1e9)
            telemetry.gauge(f"jit_execute_seconds/{name}", ent["execute_ns"] / 1e9)

    # ---- surface 4: chrome trace ----

    def chrome_trace(self) -> dict:
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 0,
                "args": {"name": "pathway_tpu_torch"},
            }
        ]
        with self._lock:
            tids = sorted(
                {e["tid"] for e in self.events if isinstance(e["tid"], int)}
            )
            events = list(self.events)
        for tid in tids:
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": tid,
                    "args": {"name": f"worker {tid}"},
                }
            )
        # the jit track uses a synthetic tid past the worker range
        jit_tid = (tids[-1] + 1) if tids else 1
        for e in events:
            if e["tid"] == "jit":
                e["tid"] = jit_tid
        if any(e.get("cat") == "jit" for e in events):
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": jit_tid,
                    "args": {"name": "jit"},
                }
            )
        # retained request-journey exemplars (tracing plane) render as
        # their own track, laying the run's slowest requests out
        # against operator/jit time in the same Perfetto view
        try:
            from ..tracing import TRACE_STORE

            _exemplars = TRACE_STORE.exemplar_traces()
        except Exception:
            _exemplars = []
        if _exemplars:
            req_tid = jit_tid + 1
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": req_tid,
                    "args": {"name": "requests (slowest traces)"},
                }
            )
            for t in _exemplars:
                for sp in t.get("spans", ()):
                    ts_us = (sp["start"] * 1e9 - self._t0_unix_ns) / 1e3
                    events.append(
                        {
                            "name": sp["stage"],
                            "ph": "X",
                            "pid": 0,
                            "tid": req_tid,
                            "ts": ts_us,
                            "dur": sp["dur_ms"] * 1e3,
                            "cat": "request",
                            "args": {
                                "trace": sp["trace"],
                                "span": sp["span"],
                            },
                        }
                    )
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "pathway_tpu_torch.profiler",
                "dropped_events": self.dropped_events,
                "trace_start_unix_ns": str(self._t0_unix_ns),
                **({"pipeline": self.pipeline} if self.pipeline else {}),
            },
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# ---- fused-encoder kernel MFU / pad-waste attribution ----


class EncoderKernelStats:
    """Process-global achieved-TFLOPs and pad-waste accounting for the
    encoder's kernels (B1's whole-layer path, ``ops/fused_layer.py``, and
    the packed B4 path).

    Every dispatch on the encode hot path reports its geometry: how many
    tokens were real, how many the kernels computed (the GEMMs run every
    row of a dispatch, so nothing is skipped on the card), and how many the
    (batch, seq) shape nominally holds.  From those this
    derives the two first-class observability signals of the MFU round:

    - ``pad_fraction`` — of the tokens the kernel computed, the share
      that was padding (the FLOP tax the bucketing layer failed to
      avoid); skipped dead blocks are *excluded* — they cost nothing.
    - ``achieved_tflops`` — model FLOPs of computed tokens over wall
      time, windowed over recent dispatches.  Attribution is
      dispatch-clock: FLOPs are counted when a dispatch is issued while
      the device crunches asynchronously, so the rate is meaningful
      across a stream of dispatches (the steady state of the encode
      path), not for a single isolated call.

    A module singleton (:data:`ENCODER_KERNEL_STATS`) feeds the
    StatsSnapshot dashboard column, the ``pathway_encoder_*`` gauges on
    ``/metrics``, and ``kernel.dispatch`` flight-recorder events.
    """

    WINDOW_S = 30.0

    def __init__(self) -> None:
        from collections import deque

        self._lock = threading.Lock()
        self.dispatches = 0
        self.real_tokens = 0
        self.computed_tokens = 0
        self.padded_tokens = 0
        self.skipped_tokens = 0
        self.model_flops = 0.0
        self._samples: Any = deque(maxlen=512)  # (monotonic t, cum flops)

    def record_dispatch(
        self,
        *,
        seq: int,
        batch: int,
        real_tokens: int,
        computed_tokens: int,
        flops: float,
    ) -> None:
        padded = seq * batch
        now = time.monotonic()
        with self._lock:
            self.dispatches += 1
            self.real_tokens += int(real_tokens)
            self.computed_tokens += int(computed_tokens)
            self.padded_tokens += int(padded)
            self.skipped_tokens += int(padded - computed_tokens)
            self.model_flops += float(flops)
            self._samples.append((now, self.model_flops))
        from . import flight_recorder

        flight_recorder.record(
            "kernel.dispatch",
            seq=int(seq),
            batch=int(batch),
            real_tokens=int(real_tokens),
            computed_tokens=int(computed_tokens),
            gflops=round(float(flops) / 1e9, 3),
        )

    def pad_fraction(self) -> float:
        """Padding share of the tokens the kernel actually computed."""
        with self._lock:
            if not self.computed_tokens:
                return 0.0
            return 1.0 - self.real_tokens / self.computed_tokens

    def achieved_tflops(self) -> float:
        """Model-FLOPs throughput over the recent dispatch window."""
        now = time.monotonic()
        with self._lock:
            recent = [s for s in self._samples if now - s[0] <= self.WINDOW_S]
            if len(recent) < 2:
                return 0.0
            (t0, f0), (t1, f1) = recent[0], recent[-1]
            if t1 - t0 <= 1e-6:
                return 0.0
            return (f1 - f0) / (t1 - t0) / 1e12

    def snapshot(self) -> dict:
        tflops = self.achieved_tflops()
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "real_tokens": self.real_tokens,
                "computed_tokens": self.computed_tokens,
                "padded_tokens": self.padded_tokens,
                "skipped_tokens": self.skipped_tokens,
                "model_flops": self.model_flops,
                "pad_fraction": (
                    1.0 - self.real_tokens / self.computed_tokens
                    if self.computed_tokens
                    else 0.0
                ),
                "achieved_tflops": tflops,
            }

    def reset(self) -> None:
        with self._lock:
            self.dispatches = 0
            self.real_tokens = 0
            self.computed_tokens = 0
            self.padded_tokens = 0
            self.skipped_tokens = 0
            self.model_flops = 0.0
            self._samples.clear()


ENCODER_KERNEL_STATS = EncoderKernelStats()


# ---- module-level current profiler (jit hooks in models/ and udfs/) ----

_current: RunProfiler | None = None


def set_current_profiler(profiler: RunProfiler | None) -> None:
    global _current
    _current = profiler


def current_profiler() -> RunProfiler | None:
    return _current


def record_jit(name: str, phase: str, dur_ns: int, n_rows: int = 0) -> None:
    prof = _current
    if prof is not None:
        prof.record_jit(name, phase, dur_ns, n_rows)


def _libraries_built() -> int:
    from ..ops import _build

    return len(_build._LIBS)


def wrap_jit(name: str, fn):
    """Wrap a device callable (the encoder's, the index's, the decode
    step's) so each call reports its build-vs-execute split to the active
    profiler: a call during which a kernel library was built is its
    "compile" (``ops/_build.py`` books the build under the chip ledger's
    ``compile`` account itself); every other call reports its dispatch
    wall as "execute". One global read when no profiler is active."""

    def profiled(*args, **kwargs):
        prof = _current
        if prof is None:
            return fn(*args, **kwargs)
        before = _libraries_built()
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        dur = time.perf_counter_ns() - t0
        n_rows = 0
        for a in args:
            shape = getattr(a, "shape", None)
            if shape:
                n_rows = int(shape[0])
                break
        prof.record_jit(name, "compile" if _libraries_built() > before else "execute", dur, n_rows)
        return out

    profiled.__wrapped__ = fn
    return profiled
