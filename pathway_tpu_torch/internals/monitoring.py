"""Monitoring dashboard + stats.

The port's copy of the reference's ``internals/monitoring.py`` (upstream
Pathway's rich console dashboard, python/pathway/internals/monitoring.py
:56-273, and the engine-side ProberStats, src/engine/graph.rs:523-567): a
``StatsMonitor`` collects per-epoch
operator/connector stats from the engine; ``LiveDashboard`` renders them
as the reference's PROGRESS DASHBOARD — a connectors table (messages in
the last minibatch / last minute / since start), an operators table
(latency to wall clock), and a LOGS panel capturing the root logger —
refreshed live via ``rich.live.Live``. With a profiler attached it adds
the operators' self-times and event lags; once the encoder dispatched,
its kernel column (achieved TFLOP/s, pad fraction); with the overlapped
epoch pipeline, its host-prep, device-wait and overlap columns; with a
host-ingest stage, the stage's workers, queue and utilisation. A plane that
is off leaves its fields at their zero values, so nothing renders for it.
"""

from __future__ import annotations

import contextlib
import enum
import logging
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field


class MonitoringLevel(enum.Enum):
    """Verbosity of the monitoring dashboard (reference :228-258)."""

    AUTO = enum.auto()  #: IN_OUT in an interactive terminal, NONE otherwise
    AUTO_ALL = enum.auto()  #: ALL in an interactive terminal, NONE otherwise
    NONE = enum.auto()  #: no monitoring
    IN_OUT = enum.auto()  #: connectors + input/output latency
    ALL = enum.auto()  #: per-operator latency too

    @classmethod
    def coerce(cls, value) -> "MonitoringLevel":
        if isinstance(value, cls):
            return value
        if value is None or value is False:
            return cls.NONE
        if value is True:
            return cls.AUTO
        if isinstance(value, str):
            try:
                return cls[value.upper()]
            except KeyError:
                raise ValueError(f"unknown monitoring_level {value!r}")
        raise ValueError(f"unknown monitoring_level {value!r}")

    def resolve(self) -> "MonitoringLevel":
        if self in (MonitoringLevel.AUTO, MonitoringLevel.AUTO_ALL):
            if not sys.stderr.isatty():
                return MonitoringLevel.NONE
            return (
                MonitoringLevel.IN_OUT
                if self is MonitoringLevel.AUTO
                else MonitoringLevel.ALL
            )
        return self


@dataclass
class ConnectorStats:
    """Per-source counters (reference ConnectorMonitor,
    src/connectors/monitoring.rs:237)."""

    name: str = ""
    num_messages_recently_committed: int = 0
    num_messages_from_start: int = 0
    finished: bool = False
    #: (wall_time, cumulative_count) samples for the last-minute window;
    #: appended at most ~4/s and aged out past 120s, so the window base
    #: is never evicted by count (which would over-report an idle
    #: connector's last-minute rate as its all-time total)
    history: deque = field(default_factory=deque)

    def observe(self, now: float, count: int) -> None:
        if self.history and now - self.history[-1][0] < 0.25:
            return
        self.history.append((now, count))
        while self.history and now - self.history[0][0] > 120.0:
            self.history.popleft()

    def num_messages_in_last_minute(self, now: float) -> int:
        cutoff = now - 60.0
        base = None
        for ts, count in self.history:
            if ts < cutoff:
                base = count
            else:
                break
        if base is None:
            # no sample older than the window: either the pipeline is
            # young (all messages are recent) or everything aged out
            # (idle for >120s -> nothing recent)
            oldest = self.history[0][0] if self.history else now
            base = 0 if oldest >= cutoff else self.num_messages_from_start
        return self.num_messages_from_start - base


@dataclass
class OperatorEntry:
    name: str = ""
    rows_in: int = 0
    rows_out: int = 0
    #: wall time of the last observed output change (None = initializing)
    last_change: float | None = None
    done: bool = False
    #: cumulative scheduler self-time (profiler, seconds); None = not profiled
    self_time_s: float | None = None
    #: event-time watermark lag (seconds); None = not a time-aware node
    event_lag_s: float | None = None

    def latency_ms(self, now: float) -> int | None:
        if self.last_change is None:
            return None
        return max(0, int((now - self.last_change) * 1000))


@dataclass
class StatsSnapshot:
    time: int = 0
    rows_in: int = 0
    rows_out: int = 0
    operators: dict = field(default_factory=dict)  # "id:name" -> (in, out)
    #: "id:name" -> cumulative self-time seconds (profiler attached only)
    operator_self_time_s: dict = field(default_factory=dict)
    #: "id:name" -> event-time watermark lag seconds (time-aware nodes)
    operator_event_lag_s: dict = field(default_factory=dict)
    #: overlapped epoch pipeline (pw.run(pipeline_depth=)): host time
    #: spent forming epochs, executor time blocked on the device, and
    #: the fraction of host prep hidden behind device execution
    pipeline_depth: int = 1
    host_prep_s: float = 0.0
    device_wait_s: float = 0.0
    overlap_ratio: float = 0.0
    #: fused-encoder kernel MFU attribution (profiler
    #: ENCODER_KERNEL_STATS): windowed achieved model-TFLOPs, the
    #: padding share of computed tokens, and the dispatch count.
    #: All zero when no fused encoder ran — rendering stays
    #: byte-identical for non-encoder pipelines.
    encoder_achieved_tflops: float = 0.0
    encoder_pad_fraction: float = 0.0
    encoder_dispatches: int = 0
    encoder_skipped_tokens: int = 0
    #: collaborative host-ingest stage (pathway_tpu/ingest/): pool
    #: size, live queue depth, stage utilization and the committed-task
    #: count. All zero when no stage was configured — rendering stays
    #: byte-identical for inline-prep pipelines.
    ingest_workers: int = 0
    ingest_queue_depth: int = 0
    ingest_utilization: float = 0.0
    ingest_committed: int = 0
    #: tiered device index (ops/tiered_knn.py): total hot/cold resident
    #: docs, lifetime promotions/demotions, and the hot-hit ratio over
    #: answered results. All zero when no tiered index ran — rendering
    #: stays byte-identical for flat-index pipelines.
    tier_hot_docs: int = 0
    tier_cold_docs: int = 0
    tier_promotions: int = 0
    tier_demotions: int = 0
    tier_hot_hit_ratio: float = 0.0
    #: decode plane (pathway_tpu/decode/): generated-token throughput,
    #: continuous-batching lane occupancy and KV page-pool usage. All
    #: zero when no decode engine ran — rendering stays byte-identical
    #: for retrieval-only pipelines.
    decode_tokens: int = 0
    decode_tokens_per_s: float = 0.0
    decode_active_lanes: int = 0
    decode_kv_pages_in_use: int = 0
    decode_kv_page_pool: int = 0
    decode_preempted: int = 0
    #: request tracing plane (pathway_tpu/tracing/): span/trace counts
    #: and retained slow-trace exemplars. All zero when tracing never
    #: ran, keeping rendering byte-identical for untraced pipelines.
    trace_spans: int = 0
    trace_traces: int = 0
    trace_open_spans: int = 0
    trace_exemplars: int = 0
    #: HBM ledger plane (internals/ledger.py): live per-account device
    #: bytes and the process total/high-water. All zero/empty when no
    #: subsystem reported an allocation — rendering stays byte-identical
    #: for non-ledger runs.
    hbm_total_bytes: int = 0
    hbm_high_water_bytes: int = 0
    hbm_accounts: dict = field(default_factory=dict)  # account -> bytes
    #: cluster telemetry plane: worker_id -> per-worker stats dict
    #: (epoch, rows_in, rows_out, rows_per_s, event_lag_s,
    #: overlap_ratio, restarts, pid). Empty outside sharded /
    #: multiprocess runs, so single-process /metrics output is
    #: byte-identical to before.
    workers: dict = field(default_factory=dict)
    #: worker id of the engine this snapshot was sampled from
    primary_worker: int = 0


def sample_worker(engine) -> dict:
    """Compact per-shard stats dict for the cluster telemetry plane.

    In-process shards are sampled directly off their engines;
    multiprocess workers build the same shape and piggyback it on their
    protocol replies over the already-authenticated cluster channel
    (parallel/multiprocess.py) — workers never open their own
    unauthenticated listener."""
    rows_in = rows_out = 0
    for node in engine.nodes:
        rows_in += node.stats.rows_in
        rows_out += node.stats.rows_out
    out: dict = {
        "epoch": int(getattr(engine, "current_time", 0) or 0),
        "rows_in": rows_in,
        "rows_out": rows_out,
        "pid": os.getpid(),
    }
    profiler = getattr(engine, "profiler", None)
    if profiler is not None:
        lags = [
            agg["event_lag_s"]
            for agg in profiler.by_operator().values()
            if agg["event_lag_s"] is not None
        ]
        if lags:
            out["event_lag_s"] = max(lags)
    pipeline = getattr(engine, "pipeline_stats", None)
    if pipeline is not None:
        out["overlap_ratio"] = pipeline.overlap_ratio
    from .ledger import LEDGER

    if LEDGER.active():
        out["hbm_bytes"] = LEDGER.total_bytes()
    return out


class StatsMonitor:
    """Collects per-epoch operator stats from the engine; optionally
    feeds a live rich dashboard (set via ``attach_dashboard``)."""

    def __init__(self, render: bool = False, interval: float = 1.0):
        self.render = render
        self.interval = interval
        self._last_render = 0.0
        self.snapshot = StatsSnapshot()
        self.connectors: dict[int, ConnectorStats] = {}
        self.operators: dict[int, OperatorEntry] = {}
        self.dashboard: "LiveDashboard | None" = None
        #: RunProfiler picked up from the engine on update() (if attached)
        self.profiler = None
        #: the actually-bound /metrics port, set by pw.run once the
        #: monitoring HTTP server is up (ephemeral-port fallback included)
        self.http_port: int | None = None
        # per-worker (last_sample_wall, last_rows_in) for rows/s rates
        self._worker_rates: dict[int, tuple[float, int]] = {}
        # wall-clock of the last observed input/output row-count change,
        # for the latency gauges (reference telemetry.rs:41-45)
        self._last_in_change = time.monotonic()
        self._last_out_change = time.monotonic()

    def attach_dashboard(self, dashboard: "LiveDashboard") -> None:
        self.dashboard = dashboard

    def input_latency_ms(self, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        return int((now - self._last_in_change) * 1000)

    def output_latency_ms(self, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        return int((now - self._last_out_change) * 1000)

    def update(self, engine) -> None:
        now = time.monotonic()
        snap = StatsSnapshot(time=engine.current_time)
        profiler = getattr(engine, "profiler", None)
        if profiler is not None:
            self.profiler = profiler
            for key, agg in profiler.by_operator().items():
                snap.operator_self_time_s[key] = agg["self_time_s"]
                if agg["event_lag_s"] is not None:
                    snap.operator_event_lag_s[key] = agg["event_lag_s"]
        pipeline = getattr(engine, "pipeline_stats", None)
        if pipeline is not None:
            snap.pipeline_depth = pipeline.depth
            snap.host_prep_s = pipeline.host_prep_s
            snap.device_wait_s = pipeline.device_wait_s
            snap.overlap_ratio = pipeline.overlap_ratio
        from .profiler import ENCODER_KERNEL_STATS

        if ENCODER_KERNEL_STATS.dispatches:
            enc = ENCODER_KERNEL_STATS.snapshot()
            snap.encoder_achieved_tflops = enc["achieved_tflops"]
            snap.encoder_pad_fraction = enc["pad_fraction"]
            snap.encoder_dispatches = enc["dispatches"]
            snap.encoder_skipped_tokens = enc["skipped_tokens"]
        from ..ingest.metrics import INGEST_METRICS

        if INGEST_METRICS.active():
            ing = INGEST_METRICS.snapshot()
            snap.ingest_workers = ing["host_workers"]
            snap.ingest_queue_depth = ing["queue_depth"]
            snap.ingest_utilization = ing["utilization"]
            snap.ingest_committed = ing["committed"]
        from ..ops.index_metrics import INDEX_METRICS

        if INDEX_METRICS.tiered_active():
            idx = INDEX_METRICS.snapshot()
            ratios = []
            for e in idx["indexes"].values():
                t = e.get("tiers")
                if t is None:
                    continue
                snap.tier_hot_docs += t["hot_docs"]
                snap.tier_cold_docs += t["cold_docs"]
                snap.tier_promotions += t["promotions"]
                snap.tier_demotions += t["demotions"]
                ratios.append(t["hot_hit_ratio"])
            if ratios:
                snap.tier_hot_hit_ratio = sum(ratios) / len(ratios)
        from ..decode.metrics import DECODE_METRICS

        if DECODE_METRICS.active():
            dec = DECODE_METRICS.snapshot()
            snap.decode_tokens = dec["tokens_total"]
            snap.decode_tokens_per_s = dec["tokens_per_second"]
            snap.decode_active_lanes = dec["active_lanes"]
            snap.decode_kv_pages_in_use = dec["kv_pages_in_use"]
            snap.decode_kv_page_pool = dec["kv_page_pool"]
            snap.decode_preempted = dec["preempted_total"]
        from ..tracing import TRACE_STORE

        if TRACE_STORE.active():
            tr = TRACE_STORE.snapshot()
            snap.trace_spans = tr["spans_total"]
            snap.trace_traces = tr["traces_total"]
            snap.trace_open_spans = tr["open_spans"]
            snap.trace_exemplars = tr["exemplars_retained"]
        from .ledger import LEDGER

        if LEDGER.active():
            led = LEDGER.snapshot()
            snap.hbm_total_bytes = led["total_bytes"]
            snap.hbm_high_water_bytes = led["high_water_bytes"]
            snap.hbm_accounts = {
                account: e["bytes"] for account, e in led["accounts"].items()
            }
        for node in engine.nodes:
            rows_in, rows_out = node.stats.rows_in, node.stats.rows_out
            key = f"{node.id}:{node.name}"
            snap.operators[key] = (rows_in, rows_out)
            snap.rows_in += rows_in
            snap.rows_out += rows_out
            entry = self.operators.get(node.id)
            if entry is None:
                entry = self.operators[node.id] = OperatorEntry(name=node.name)
            if rows_out != entry.rows_out or rows_in != entry.rows_in:
                entry.last_change = now
            entry.rows_in, entry.rows_out = rows_in, rows_out
            if key in snap.operator_self_time_s:
                entry.self_time_s = snap.operator_self_time_s[key]
            entry.event_lag_s = snap.operator_event_lag_s.get(key)
            if node.n_inputs == 0:
                conn = self.connectors.get(node.id)
                if conn is None:
                    conn = self.connectors[node.id] = ConnectorStats(name=node.name)
                delta = rows_out - conn.num_messages_from_start
                # assign unconditionally: an idle connector shows 0 for
                # its last minibatch, not its last nonzero batch forever
                conn.num_messages_recently_committed = delta
                conn.num_messages_from_start = rows_out
                conn.observe(now, rows_out)
                session = getattr(node, "session", None)
                if session is not None:
                    try:
                        conn.finished = session.closed
                    except Exception:
                        pass
        snap.primary_worker = int(getattr(engine, "worker_id", 0) or 0)
        cluster = getattr(engine, "cluster", None)
        if cluster is not None and getattr(cluster, "world", 1) > 1:
            self._sample_cluster(snap, cluster, now)
        if snap.rows_in != self.snapshot.rows_in:
            self._last_in_change = now
        if snap.rows_out != self.snapshot.rows_out:
            self._last_out_change = now
        self.snapshot = snap
        if self.dashboard is not None:
            # throttle: rebuilding the renderable tree every engine epoch
            # would steal hot-loop time (Live paints at 4 fps anyway)
            if now - self._last_render > min(self.interval, 0.25):
                self.dashboard.refresh(self, now)
                self._last_render = now
        elif self.render and now - self._last_render > self.interval:
            self._render()
            self._last_render = now

    def _sample_cluster(self, snap: StatsSnapshot, cluster, now: float) -> None:
        """Populate ``snap.workers``: every in-process shard is sampled
        directly; remote multiprocess workers are merged from the stats
        they piggybacked on the coordinator's protocol replies
        (``cluster.worker_telemetry``)."""
        from ..resilience import SUPERVISOR_METRICS

        restarts = SUPERVISOR_METRICS.snapshot()["restarts_total"]
        workers: dict[int, dict] = {}
        for e in cluster.engines:
            w = sample_worker(e)
            w["restarts"] = restarts
            workers[int(e.worker_id)] = w
        for wid, stats in getattr(cluster, "worker_telemetry", {}).items():
            workers.setdefault(int(wid), dict(stats))
        for wid, w in workers.items():
            prev = self._worker_rates.get(wid)
            rows = int(w.get("rows_in", 0))
            if prev is not None and now > prev[0]:
                w["rows_per_s"] = max(0.0, (rows - prev[1]) / (now - prev[0]))
            else:
                w["rows_per_s"] = 0.0
            self._worker_rates[wid] = (now, rows)
        snap.workers = workers

    def _render(self) -> None:  # pragma: no cover
        try:
            from rich.console import Console

            Console(file=sys.stderr).print(build_dashboard(self, time.monotonic()))
        except Exception:
            pass


# ------------------------------------------------------------ rich layer


class ConsolePrintingToBuffer:
    """A console stand-in that buffers records for the LOGS panel
    (reference ConsolePrintingToBuffer :22)."""

    def __init__(self):
        from rich.console import Console

        self._devnull = open(os.devnull, "w")
        self._console = Console(file=self._devnull)
        self.logs: list = []

    def print(self, *records, **kwargs) -> None:
        self.logs.extend(records)

    def forget(self, num_records_to_remember: int) -> None:
        self.logs = self.logs[-num_records_to_remember:]

    def __getattr__(self, name):
        return getattr(self._console, name)


def _connectors_table(monitor: StatsMonitor, now: float):
    from rich import box
    from rich.table import Table

    table = Table(box=box.SIMPLE)
    table.add_column("connector", justify="left")
    table.add_column("no. messages in the last minibatch", justify="right")
    table.add_column("in the last minute", justify="right")
    table.add_column("since start", justify="right")
    for conn in monitor.connectors.values():
        table.add_row(
            conn.name,
            "finished" if conn.finished else f"{conn.num_messages_recently_committed}",
            f"{conn.num_messages_in_last_minute(now)}",
            f"{conn.num_messages_from_start}",
        )
    return table


def _operators_table(monitor: StatsMonitor, now: float, with_operators: bool):
    from rich import box
    from rich.table import Table

    caption = (
        "Latency is measured as the difference between the time the "
        "operator processed the data and the time pathway acquired it."
    )
    snap = monitor.snapshot
    # HBM ledger plane rides the caption, not a column: the operators
    # table already carries one column per active plane and a wide table
    # gets center-cropped by the layout pane, losing headers
    if snap.hbm_total_bytes > 0 or snap.hbm_accounts:
        caption += (
            f" HBM ledger: {snap.hbm_total_bytes / 2**20:.1f} MiB live"
            f" (hw {snap.hbm_high_water_bytes / 2**20:.1f}) across"
            f" {len(snap.hbm_accounts)} accounts."
        )
    # profiler-backed columns only appear when a profiler is attached;
    # the overlap column only when the epoch pipeline is on (depth >= 2)
    profiled = monitor.profiler is not None
    pipelined = snap.pipeline_depth > 1
    # encoder-kernel MFU column only when the fused encoder dispatched
    encoding = snap.encoder_dispatches > 0
    # ingest column only when a collaborative host stage is running
    ingesting = snap.ingest_workers > 0
    # tier column only when a tiered device index is accounting
    tiering = (snap.tier_hot_docs + snap.tier_cold_docs) > 0
    # decode column only when the generation plane emitted tokens
    decoding = snap.decode_tokens > 0
    table = Table(caption=caption, box=box.SIMPLE)
    table.add_column("operator", justify="left")
    table.add_column(r"latency to wall clock \[ms]", justify="right")
    table.add_column("rows out", justify="right")
    if profiled:
        table.add_column(r"self-time \[ms]", justify="right")
        table.add_column(r"event lag \[s]", justify="right")
    if pipelined:
        table.add_column("overlap ratio", justify="right")
    if encoding:
        table.add_column(r"MFU \[TF] / pad", justify="right")
    if ingesting:
        table.add_column("ingest util / queue", justify="right")
    if tiering:
        table.add_column("tier hot/cold", justify="right")
    if decoding:
        table.add_column("decode tok/s / lanes", justify="right")
    pad = (
        (2 if profiled else 0)
        + (1 if pipelined else 0)
        + (1 if encoding else 0)
        + (1 if ingesting else 0)
        + (1 if tiering else 0)
        + (1 if decoding else 0)
    )

    def row(*cells):
        table.add_row(*(cells + ("",) * pad))

    row("input", f"{monitor.input_latency_ms(now)}", "")
    if with_operators:
        for entry in monitor.operators.values():
            latency = entry.latency_ms(now)
            cells = (
                entry.name,
                "initializing" if latency is None else f"{latency}",
                f"{entry.rows_out}",
            )
            if profiled:
                cells = cells + (
                    ""
                    if entry.self_time_s is None
                    else f"{entry.self_time_s * 1000:.1f}",
                    "" if entry.event_lag_s is None else f"{entry.event_lag_s:.2f}",
                )
            if pipelined:
                cells = cells + ("",)
            if encoding:
                cells = cells + ("",)
            if ingesting:
                cells = cells + ("",)
            if tiering:
                cells = cells + ("",)
            if decoding:
                cells = cells + ("",)
            table.add_row(*cells)
    if pipelined:
        cells = (
            f"epoch pipeline (depth {snap.pipeline_depth})",
            "",
            "",
        )
        if profiled:
            cells = cells + (f"{snap.host_prep_s * 1000:.1f}", "")
        cells = cells + (f"{snap.overlap_ratio:.2f}",)
        if encoding:
            cells = cells + ("",)
        if ingesting:
            cells = cells + ("",)
        if tiering:
            cells = cells + ("",)
        if decoding:
            cells = cells + ("",)
        table.add_row(*cells)
    if encoding:
        cells = (
            f"encoder kernel ({snap.encoder_dispatches} dispatches)",
            "",
            "",
        )
        if profiled:
            cells = cells + ("", "")
        if pipelined:
            cells = cells + ("",)
        cells = cells + (
            f"{snap.encoder_achieved_tflops:.1f} / "
            f"{snap.encoder_pad_fraction * 100:.1f}%",
        )
        if ingesting:
            cells = cells + ("",)
        if tiering:
            cells = cells + ("",)
        if decoding:
            cells = cells + ("",)
        table.add_row(*cells)
    if ingesting:
        cells = (
            f"host ingest ({snap.ingest_workers} workers)",
            "",
            f"{snap.ingest_committed}",
        )
        if profiled:
            cells = cells + ("", "")
        if pipelined:
            cells = cells + ("",)
        if encoding:
            cells = cells + ("",)
        cells = cells + (
            f"{snap.ingest_utilization * 100:.0f}% / {snap.ingest_queue_depth}",
        )
        if tiering:
            cells = cells + ("",)
        if decoding:
            cells = cells + ("",)
        table.add_row(*cells)
    if tiering:
        cells = (
            f"index tiers ({snap.tier_promotions}p/{snap.tier_demotions}d, "
            f"hit {snap.tier_hot_hit_ratio * 100:.0f}%)",
            "",
            "",
        )
        if profiled:
            cells = cells + ("", "")
        if pipelined:
            cells = cells + ("",)
        if encoding:
            cells = cells + ("",)
        if ingesting:
            cells = cells + ("",)
        cells = cells + (
            f"{snap.tier_hot_docs} / {snap.tier_cold_docs}",
        )
        if decoding:
            cells = cells + ("",)
        table.add_row(*cells)
    if decoding:
        cells = (
            f"decode plane ({snap.decode_tokens} tok, "
            f"{snap.decode_preempted} preempted)",
            "",
            "",
        )
        if profiled:
            cells = cells + ("", "")
        if pipelined:
            cells = cells + ("",)
        if encoding:
            cells = cells + ("",)
        if ingesting:
            cells = cells + ("",)
        if tiering:
            cells = cells + ("",)
        cells = cells + (
            f"{snap.decode_tokens_per_s:.1f} / {snap.decode_active_lanes} "
            f"(kv {snap.decode_kv_pages_in_use}/{snap.decode_kv_page_pool})",
        )
        table.add_row(*cells)
    row("output", f"{monitor.output_latency_ms(now)}", "")
    return table


def _workers_table(monitor: StatsMonitor, now: float):
    """Cluster telemetry plane: one dashboard row per worker shard
    (local shards + remote multiprocess workers)."""
    from rich import box
    from rich.table import Table

    table = Table(title="WORKERS", box=box.SIMPLE)
    table.add_column("worker", justify="right")
    table.add_column("epoch", justify="right")
    table.add_column("rows/s", justify="right")
    table.add_column(r"event lag \[s]", justify="right")
    table.add_column("overlap", justify="right")
    table.add_column("restarts", justify="right")
    # per-worker HBM only when some shard piggybacked a ledger total
    any_hbm = any(
        w.get("hbm_bytes") is not None for w in monitor.snapshot.workers.values()
    )
    if any_hbm:
        table.add_column(r"HBM \[MiB]", justify="right")
    for wid in sorted(monitor.snapshot.workers):
        w = monitor.snapshot.workers[wid]
        lag = w.get("event_lag_s")
        overlap = w.get("overlap_ratio")
        cells = (
            str(wid),
            str(w.get("epoch", "")),
            f"{w.get('rows_per_s', 0.0):.1f}",
            "" if lag is None else f"{lag:.2f}",
            "" if overlap is None else f"{overlap:.2f}",
            str(w.get("restarts", 0)),
        )
        if any_hbm:
            hbm = w.get("hbm_bytes")
            cells = cells + ("" if hbm is None else f"{hbm / 2**20:.1f}",)
        table.add_row(*cells)
    return table


def build_dashboard(monitor: StatsMonitor, now: float, with_operators: bool = True):
    """The PROGRESS DASHBOARD renderable (reference MonitoringOutput
    :55-162): connectors beside operators, plus a per-worker table in
    cluster runs."""
    from rich import box
    from rich.align import Align
    from rich.layout import Layout
    from rich.panel import Panel

    layout = Layout(name="monitoring_inner")
    layout.split_row(Layout(name="connectors"), Layout(name="operators"))
    layout["connectors"].update(Align.center(_connectors_table(monitor, now)))
    layout["operators"].update(
        Align.center(_operators_table(monitor, now, with_operators))
    )
    panel = Panel(
        layout,
        title=f"PATHWAY PROGRESS DASHBOARD @ t={monitor.snapshot.time}",
        box=box.MINIMAL,
    )
    if monitor.snapshot.workers:
        from rich.console import Group

        return Group(panel, Align.center(_workers_table(monitor, now)))
    return panel


class LiveDashboard:
    """Live-updating dashboard + LOGS panel (reference StatsMonitor
    :165-189 + monitor_stats :191-227)."""

    def __init__(self, with_operators: bool = True, console=None, screen: bool = True):
        from rich.layout import Layout
        from rich.logging import RichHandler

        self.with_operators = with_operators
        self.layout = Layout(name="root")
        self.layout.split(
            Layout(name="monitoring", ratio=2 if with_operators else 1),
            Layout(name="logs"),
        )
        self.layout["monitoring"].update("")
        self._log_buffer = ConsolePrintingToBuffer()
        self.handler = RichHandler(console=self._log_buffer, show_path=False)
        self._screen = screen
        self._console = console
        self._live = None
        self._update_logs_panel()

    def _update_logs_panel(self) -> None:
        from rich import box
        from rich.console import Group
        from rich.panel import Panel

        self._log_buffer.forget(32)
        self.layout["logs"].update(
            Panel(Group(*self._log_buffer.logs), title="LOGS", box=box.MINIMAL)
        )

    def start(self) -> None:
        from rich.console import Console
        from rich.live import Live

        if self._console is None:
            # stderr, never stdout: a piped stdout must not receive the
            # dashboard's ANSI escapes interleaved with program output
            self._console = Console(file=sys.stderr)
        logging.getLogger().addHandler(self.handler)
        self._live = Live(
            self.layout,
            refresh_per_second=4,
            screen=self._screen,
            console=self._console,
        )
        self._live.start()

    def stop(self) -> None:
        if self._live is not None:
            self._live.stop()
            self._live = None
        logging.getLogger().removeHandler(self.handler)

    def refresh(self, monitor: StatsMonitor, now: float) -> None:
        self.layout["monitoring"].update(
            build_dashboard(monitor, now, self.with_operators)
        )
        self._update_logs_panel()


@contextlib.contextmanager
def monitor_stats(
    monitoring_level,
    *,
    process_id: int = 0,
    console=None,
    screen: bool = True,
):
    """Yield a StatsMonitor wired per the monitoring level (reference
    monitor_stats :191): NONE → plain collector without rendering;
    IN_OUT/ALL on process 0 → live dashboard; worker processes stay
    quiet."""
    level = MonitoringLevel.coerce(monitoring_level).resolve()
    monitor = StatsMonitor()
    if level is MonitoringLevel.NONE or process_id != 0:
        yield monitor
        return
    dashboard = LiveDashboard(
        with_operators=level is MonitoringLevel.ALL,
        console=console,
        screen=screen,
    )
    monitor.attach_dashboard(dashboard)
    dashboard.start()
    try:
        yield monitor
    finally:
        dashboard.stop()
