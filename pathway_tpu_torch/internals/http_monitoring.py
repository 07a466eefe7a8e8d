"""Monitoring HTTP server: Prometheus/OpenMetrics endpoint per process.

The port's copy of the reference's ``internals/http_monitoring.py``
(upstream Pathway's src/engine/http_server.rs:21-60): serves
``/metrics`` in Prometheus text format and ``/status`` as JSON on port
``20000 + process_id``, exposing row counters, per-operator stats and
input/output latency gauges (reference telemetry.rs:41-45). When a
profiler is attached to the run, ``/metrics`` additionally exposes
per-operator self-time histograms (``pathway_operator_self_time_seconds``)
and event-time lag gauges (``pathway_operator_event_lag_seconds``).

It renders the sections of the planes the port holds: resilience (retry
attempts per scope, supervisor restarts), cluster health, serving, index,
decode, tracing, the HBM ledger, tenancy, the host-ingest stage, the chip
ledger, the elastic reshard plane and freshness, each only once its plane
has seen activity; the epoch pipeline's host-prep, device-wait and overlap
series come with a pipelined run. With every plane off a scrape is
byte-identical to one from a run that never had them.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .monitoring import StatsMonitor

BASE_PORT = 20000

logger = logging.getLogger(__name__)


def _escape_label(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote,
    and line feed (the exposition format's own escape set)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


class MonitoringHttpServer:
    """Daemon HTTP server reading a StatsMonitor's latest snapshot."""

    def __init__(self, monitor: StatsMonitor, port: int | None = None, host: str = "127.0.0.1"):
        if port is None:
            explicit = os.environ.get("PATHWAY_MONITORING_HTTP_PORT")
            port = int(explicit) if explicit else BASE_PORT + int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
        self.monitor = monitor
        self.port = port
        self.host = host
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- rendering --

    def _prometheus(self) -> str:
        snap = self.monitor.snapshot
        now = time.monotonic()
        workers = getattr(snap, "workers", {}) or {}
        # cluster runs label EVERY series with worker=<global shard id>;
        # process-scoped series carry this process's primary shard.
        # single-process output stays byte-identical (wl == "").
        wl = (
            f'worker="{getattr(snap, "primary_worker", 0)}"' if workers else ""
        )

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        lines = ["# TYPE pathway_epoch gauge"]
        if workers:
            for wid in sorted(workers):
                lines.append(
                    f'pathway_epoch{{worker="{wid}"}} {workers[wid].get("epoch", 0)}'
                )
        else:
            lines.append(f"pathway_epoch {snap.time}")
        lines.append("# TYPE pathway_rows_input_total counter")
        if workers:
            for wid in sorted(workers):
                lines.append(
                    f'pathway_rows_input_total{{worker="{wid}"}} '
                    f'{workers[wid].get("rows_in", 0)}'
                )
        else:
            lines.append(f"pathway_rows_input_total {snap.rows_in}")
        lines.append("# TYPE pathway_rows_output_total counter")
        if workers:
            for wid in sorted(workers):
                lines.append(
                    f'pathway_rows_output_total{{worker="{wid}"}} '
                    f'{workers[wid].get("rows_out", 0)}'
                )
        else:
            lines.append(f"pathway_rows_output_total {snap.rows_out}")
        lines.extend(
            [
                "# TYPE pathway_input_latency_ms gauge",
                series("pathway_input_latency_ms", self.monitor.input_latency_ms(now)),
                "# TYPE pathway_output_latency_ms gauge",
                series("pathway_output_latency_ms", self.monitor.output_latency_ms(now)),
                "# TYPE pathway_operator_rows_total counter",
            ]
        )
        for op_name, (rows_in, rows_out) in sorted(snap.operators.items()):
            label = _escape_label(op_name)
            lines.append(
                series(
                    "pathway_operator_rows_total",
                    rows_in,
                    f'operator="{label}",direction="in"',
                )
            )
            lines.append(
                series(
                    "pathway_operator_rows_total",
                    rows_out,
                    f'operator="{label}",direction="out"',
                )
            )
        profiler = self.monitor.profiler
        if profiler is not None:
            lines.append("# TYPE pathway_operator_self_time_seconds histogram")
            by_op = profiler.by_operator()
            for key in sorted(by_op):
                agg = by_op[key]
                label = _escape_label(key)
                hist = agg["histogram"]
                for le, count in hist.cumulative():
                    lines.append(
                        series(
                            "pathway_operator_self_time_seconds_bucket",
                            count,
                            f'operator="{label}",le="{le}"',
                        )
                    )
                lines.append(
                    series(
                        "pathway_operator_self_time_seconds_sum",
                        f"{hist.total:.9f}",
                        f'operator="{label}"',
                    )
                )
                lines.append(
                    series(
                        "pathway_operator_self_time_seconds_count",
                        hist.count,
                        f'operator="{label}"',
                    )
                )
            lag_lines = []
            for key in sorted(by_op):
                lag = by_op[key]["event_lag_s"]
                if lag is not None:
                    lag_lines.append(
                        series(
                            "pathway_operator_event_lag_seconds",
                            f"{lag:.6f}",
                            f'operator="{_escape_label(key)}"',
                        )
                    )
            if lag_lines:
                lines.append("# TYPE pathway_operator_event_lag_seconds gauge")
                lines.extend(lag_lines)
        if getattr(snap, "pipeline_depth", 1) > 1:
            # overlapped epoch pipeline (pw.run(pipeline_depth=)):
            # host-prep vs device-wait attribution, previously only
            # measurable by hand in bench.py
            lines.extend(
                [
                    "# TYPE pathway_host_prep_seconds counter",
                    series("pathway_host_prep_seconds", f"{snap.host_prep_s:.6f}"),
                    "# TYPE pathway_device_wait_seconds counter",
                    series("pathway_device_wait_seconds", f"{snap.device_wait_s:.6f}"),
                    "# TYPE pathway_pipeline_overlap_ratio gauge",
                    series(
                        "pathway_pipeline_overlap_ratio", f"{snap.overlap_ratio:.4f}"
                    ),
                    "# TYPE pathway_pipeline_depth gauge",
                    series("pathway_pipeline_depth", snap.pipeline_depth),
                ]
            )
        if getattr(snap, "encoder_dispatches", 0) > 0:
            # fused-encoder MFU / pad-waste attribution (profiler
            # ENCODER_KERNEL_STATS): achieved model-TFLOPs over the
            # recent dispatch window and the padding share of computed
            # tokens. Rendered only when the fused encoder dispatched,
            # so non-encoder pipelines' output stays byte-identical.
            lines.extend(
                [
                    "# TYPE pathway_encoder_achieved_tflops gauge",
                    series(
                        "pathway_encoder_achieved_tflops",
                        f"{snap.encoder_achieved_tflops:.3f}",
                    ),
                    "# TYPE pathway_encoder_pad_fraction gauge",
                    series(
                        "pathway_encoder_pad_fraction",
                        f"{snap.encoder_pad_fraction:.4f}",
                    ),
                    "# TYPE pathway_encoder_dispatches_total counter",
                    series(
                        "pathway_encoder_dispatches_total", snap.encoder_dispatches
                    ),
                    "# TYPE pathway_encoder_skipped_tokens_total counter",
                    series(
                        "pathway_encoder_skipped_tokens_total",
                        snap.encoder_skipped_tokens,
                    ),
                ]
            )
        if workers:
            lines.extend(self._worker_lines(workers))
        lines.extend(self._resilience_lines(wl))
        lines.extend(self._cluster_lines(wl))
        lines.extend(self._serving_lines(wl))
        lines.extend(self._index_lines(wl))
        lines.extend(self._ingest_lines(wl))
        lines.extend(self._decode_lines(wl))
        lines.extend(self._tracing_lines(wl))
        lines.extend(self._ledger_lines(wl))
        lines.extend(self._tenancy_lines(wl))
        lines.extend(self._chip_lines(wl))
        lines.extend(self._elastic_lines(wl))
        lines.extend(self._freshness_lines(wl))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _worker_lines(workers: dict) -> list[str]:
        """Cluster telemetry plane: per-worker gauges aggregated from
        local shards and remote workers' piggybacked stats."""
        lines = ["# TYPE pathway_worker_rows_per_second gauge"]
        for wid in sorted(workers):
            lines.append(
                f'pathway_worker_rows_per_second{{worker="{wid}"}} '
                f'{workers[wid].get("rows_per_s", 0.0):.3f}'
            )
        lag_lines = [
            f'pathway_worker_event_lag_seconds{{worker="{wid}"}} '
            f'{workers[wid]["event_lag_s"]:.6f}'
            for wid in sorted(workers)
            if workers[wid].get("event_lag_s") is not None
        ]
        if lag_lines:
            lines.append("# TYPE pathway_worker_event_lag_seconds gauge")
            lines.extend(lag_lines)
        overlap_lines = [
            f'pathway_worker_overlap_ratio{{worker="{wid}"}} '
            f'{workers[wid]["overlap_ratio"]:.4f}'
            for wid in sorted(workers)
            if workers[wid].get("overlap_ratio") is not None
        ]
        if overlap_lines:
            lines.append("# TYPE pathway_worker_overlap_ratio gauge")
            lines.extend(overlap_lines)
        hbm_lines = [
            f'pathway_worker_hbm_bytes{{worker="{wid}"}} '
            f'{workers[wid]["hbm_bytes"]}'
            for wid in sorted(workers)
            if workers[wid].get("hbm_bytes") is not None
        ]
        if hbm_lines:
            lines.append("# TYPE pathway_worker_hbm_bytes gauge")
            lines.extend(hbm_lines)
        lines.append("# TYPE pathway_worker_restarts_total counter")
        for wid in sorted(workers):
            lines.append(
                f'pathway_worker_restarts_total{{worker="{wid}"}} '
                f'{workers[wid].get("restarts", 0)}'
            )
        return lines

    @staticmethod
    def _resilience_lines(wl: str = "") -> list[str]:
        """Retry-policy attempt counters and supervisor restart counters
        (reference telemetry: one series per connector/udf scope).
        ``wl`` is the worker label in cluster runs (these registries are
        process-scoped, so they carry the process's primary shard id)."""
        from ..resilience import RETRY_METRICS, SUPERVISOR_METRICS

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        lines: list[str] = []
        retries = RETRY_METRICS.snapshot()
        if retries:
            for metric in ("attempts", "retries", "successes", "failures"):
                lines.append(f"# TYPE pathway_retry_{metric}_total counter")
                for scope in sorted(retries):
                    lines.append(
                        series(
                            f"pathway_retry_{metric}_total",
                            retries[scope][metric],
                            f'scope="{_escape_label(scope)}"',
                        )
                    )
        sup = SUPERVISOR_METRICS.snapshot()
        if sup["restarts_total"] or sup["escalations"]:
            lines.append("# TYPE pathway_supervisor_restarts_total counter")
            for cause in sorted(sup["restarts"]):
                lines.append(
                    series(
                        "pathway_supervisor_restarts_total",
                        sup["restarts"][cause],
                        f'cause="{_escape_label(cause)}"',
                    )
                )
            lines.append("# TYPE pathway_supervisor_escalations_total counter")
            lines.append(
                series("pathway_supervisor_escalations_total", sup["escalations"])
            )
        return lines

    @staticmethod
    def _cluster_lines(wl: str = "") -> list[str]:
        """Cluster fault-domain counters (``pathway_cluster_*``): lease
        expiries, partial restarts, fenced writes, snapshot barriers and
        the current cluster generation. Rendered only once the fault
        domain has seen an event (or a shard is marked down), so
        single-process ``/metrics`` output stays byte-identical."""
        from ..resilience import CLUSTER_HEALTH, CLUSTER_METRICS

        if not (CLUSTER_METRICS.active() or CLUSTER_HEALTH.any_down()):
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = CLUSTER_METRICS.snapshot()
        lines = ["# TYPE pathway_cluster_lease_expiries_total counter"]
        for pid in sorted(snap["lease_expiries"]):
            lines.append(
                series(
                    "pathway_cluster_lease_expiries_total",
                    snap["lease_expiries"][pid],
                    f'process="{_escape_label(pid)}"',
                )
            )
        lines.extend(
            [
                "# TYPE pathway_cluster_partial_restarts_total counter",
                series(
                    "pathway_cluster_partial_restarts_total",
                    snap["partial_restarts_total"],
                ),
                "# TYPE pathway_cluster_fenced_writes_total counter",
                series(
                    "pathway_cluster_fenced_writes_total",
                    snap["fenced_writes_total"],
                ),
                "# TYPE pathway_cluster_barriers_total counter",
                series("pathway_cluster_barriers_total", snap["barriers_total"]),
                "# TYPE pathway_cluster_generation gauge",
                series("pathway_cluster_generation", snap["generation"]),
            ]
        )
        down = CLUSTER_HEALTH.down_shards()
        if down:
            lines.append("# TYPE pathway_cluster_shard_down gauge")
            for shard in sorted(down):
                lines.append(
                    series(
                        "pathway_cluster_shard_down", 1, f'shard="{int(shard)}"'
                    )
                )
        return lines

    @staticmethod
    def _ingest_lines(wl: str = "") -> list[str]:
        """Collaborative host-ingest plane (``pathway_ingest_*``): queue
        depth, pool size, stage utilization and the short/long routing
        split. Rendered only once a stage has run — ``/metrics`` stays
        byte-identical for pipelines without one."""
        from ..ingest.metrics import INGEST_METRICS

        if not INGEST_METRICS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = INGEST_METRICS.snapshot()
        lines: list[str] = []
        for metric, key, kind in (
            ("pathway_ingest_queue_depth", "queue_depth", "gauge"),
            ("pathway_ingest_queue_high_water", "queue_high_water", "gauge"),
            ("pathway_ingest_host_workers", "host_workers", "gauge"),
            ("pathway_ingest_host_stage_utilization", "utilization", "gauge"),
            ("pathway_ingest_enqueued_total", "enqueued", "counter"),
            ("pathway_ingest_committed_total", "committed", "counter"),
            ("pathway_ingest_retried_total", "retried", "counter"),
            ("pathway_ingest_scale_up_total", "scale_up", "counter"),
            ("pathway_ingest_scale_down_total", "scale_down", "counter"),
            ("pathway_ingest_routed_short_total", "routed_short", "counter"),
            ("pathway_ingest_routed_long_total", "routed_long", "counter"),
        ):
            lines.append(f"# TYPE {metric} {kind}")
            lines.append(series(metric, snap[key]))
        return lines

    @staticmethod
    def _serving_lines(wl: str = "") -> list[str]:
        """Overload-safe serving plane counters/gauges
        (``pathway_serving_*``). Rendered only once a serving-enabled
        endpoint has seen traffic — ``/metrics`` output stays
        byte-identical for pipelines that never configure serving."""
        from ..serving import SERVING_METRICS

        if not SERVING_METRICS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = SERVING_METRICS.snapshot()
        lines = [
            "# TYPE pathway_serving_admitted_total counter",
            series("pathway_serving_admitted_total", snap["admitted_total"]),
            "# TYPE pathway_serving_degraded_total counter",
            series("pathway_serving_degraded_total", snap["degraded_total"]),
            "# TYPE pathway_serving_deadline_expired_total counter",
            series(
                "pathway_serving_deadline_expired_total",
                snap["deadline_expired_total"],
            ),
        ]
        lines.append("# TYPE pathway_serving_shed_total counter")
        for reason in sorted(snap["shed_total"]):
            lines.append(
                series(
                    "pathway_serving_shed_total",
                    snap["shed_total"][reason],
                    f'reason="{_escape_label(reason)}"',
                )
            )
        lines.extend(
            [
                "# TYPE pathway_serving_queue_depth gauge",
                series("pathway_serving_queue_depth", snap["queue_depth"]),
                "# TYPE pathway_serving_inflight gauge",
                series("pathway_serving_inflight", snap["inflight"]),
                "# TYPE pathway_serving_batches_total counter",
                series("pathway_serving_batches_total", snap["batches_total"]),
                "# TYPE pathway_serving_batched_queries_total counter",
                series(
                    "pathway_serving_batched_queries_total",
                    snap["batched_queries_total"],
                ),
                "# TYPE pathway_serving_batch_size gauge",
                series("pathway_serving_batch_size", snap["last_batch_size"]),
                "# TYPE pathway_serving_ewma_item_seconds gauge",
                series(
                    "pathway_serving_ewma_item_seconds",
                    f"{snap['ewma_item_s']:.6f}",
                ),
            ]
        )
        stage_lines = []
        for stage in sorted(SERVING_METRICS.stages):
            hist = SERVING_METRICS.stages[stage]
            if not hist.count:
                continue
            for le, cum in hist.cumulative():
                stage_lines.append(
                    series(
                        "pathway_serving_stage_seconds_bucket",
                        cum,
                        f'stage="{stage}",le="{le}"',
                    )
                )
            stage_lines.append(
                series(
                    "pathway_serving_stage_seconds_sum",
                    f"{hist.total:.9f}",
                    f'stage="{stage}"',
                )
            )
            stage_lines.append(
                series(
                    "pathway_serving_stage_seconds_count",
                    hist.count,
                    f'stage="{stage}"',
                )
            )
        if stage_lines:
            lines.append("# TYPE pathway_serving_stage_seconds histogram")
            lines.extend(stage_lines)
        return lines

    @staticmethod
    def _index_lines(wl: str = "") -> list[str]:
        """Device-backed index plane (``pathway_index_*``): per-shard
        occupancy from the hash router, the shard-imbalance gauge, and
        the cross-chip merge-collective latency histogram. Rendered only
        once an index exists — ``/metrics`` stays byte-identical for
        pipelines without one."""
        from ..ops.index_metrics import INDEX_METRICS

        if not INDEX_METRICS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = INDEX_METRICS.snapshot()
        lines: list[str] = []
        per_shard: list[str] = []
        valid: list[str] = []
        for name in sorted(snap["indexes"]):
            e = snap["indexes"][name]
            cap = e["shard_capacity"]
            for s, docs in enumerate(e["docs_shard"]):
                lbl = f'index="{_escape_label(name)}",shard="{s}"'
                per_shard.append(series("pathway_index_docs", docs, lbl))
                if cap > 0:
                    valid.append(
                        series("pathway_index_valid_fraction", f"{docs / cap:.4f}", lbl)
                    )
        lines.append("# TYPE pathway_index_docs gauge")
        lines.extend(per_shard)
        if valid:
            lines.append("# TYPE pathway_index_valid_fraction gauge")
            lines.extend(valid)
        for metric, key, kind in (
            ("pathway_index_shards", "shards", "gauge"),
            ("pathway_index_shard_capacity", "shard_capacity", "gauge"),
            ("pathway_index_imbalance", "imbalance", "gauge"),
            ("pathway_index_searches_total", "searches", "counter"),
            ("pathway_index_queries_total", "queries", "counter"),
        ):
            lines.append(f"# TYPE {metric} {kind}")
            for name in sorted(snap["indexes"]):
                lines.append(
                    series(
                        metric,
                        snap["indexes"][name][key],
                        f'index="{_escape_label(name)}"',
                    )
                )
        merge = INDEX_METRICS.merge
        if merge.count:
            lines.append("# TYPE pathway_index_merge_seconds histogram")
            for le, cum in merge.cumulative():
                lines.append(
                    series("pathway_index_merge_seconds_bucket", cum, f'le="{le}"')
                )
            lines.append(series("pathway_index_merge_seconds_sum", f"{merge.total:.9f}"))
            lines.append(series("pathway_index_merge_seconds_count", merge.count))
        # tiered-index plane: rendered only for indexes with tier
        # accounting, so flat-index runs stay byte-identical
        tiered = {
            name: e["tiers"]
            for name, e in snap["indexes"].items()
            if "tiers" in e
        }
        if tiered:
            docs_l: list[str] = []
            bytes_l: list[str] = []
            for name in sorted(tiered):
                e = snap["indexes"][name]
                t = tiered[name]
                hot_b = t.get("hot_bytes_shard", [])
                cold_b = t.get("cold_bytes_shard", [])
                for s, docs in enumerate(e["docs_shard"]):
                    lbl = f'index="{_escape_label(name)}",shard="{s}",tier="hot"'
                    docs_l.append(series("pathway_index_tier_docs", docs, lbl))
                    if s < len(hot_b):
                        bytes_l.append(
                            series("pathway_index_tier_bytes", hot_b[s], lbl)
                        )
                for s, docs in enumerate(t["cold_docs_shard"]):
                    lbl = f'index="{_escape_label(name)}",shard="{s}",tier="cold"'
                    docs_l.append(series("pathway_index_tier_docs", docs, lbl))
                    if s < len(cold_b):
                        bytes_l.append(
                            series("pathway_index_tier_bytes", cold_b[s], lbl)
                        )
            lines.append("# TYPE pathway_index_tier_docs gauge")
            lines.extend(docs_l)
            lines.append("# TYPE pathway_index_tier_bytes gauge")
            lines.extend(bytes_l)
            for metric, key, kind in (
                ("pathway_index_tier_promotions_total", "promotions", "counter"),
                ("pathway_index_tier_demotions_total", "demotions", "counter"),
                ("pathway_index_tier_hot_hit_ratio", "hot_hit_ratio", "gauge"),
            ):
                lines.append(f"# TYPE {metric} {kind}")
                for name in sorted(tiered):
                    lines.append(
                        series(
                            metric,
                            tiered[name][key],
                            f'index="{_escape_label(name)}"',
                        )
                    )
            cold_fetch = INDEX_METRICS.cold_fetch
            if cold_fetch.count:
                lines.append("# TYPE pathway_index_tier_cold_fetch_seconds histogram")
                for le, cum in cold_fetch.cumulative():
                    lines.append(
                        series(
                            "pathway_index_tier_cold_fetch_seconds_bucket",
                            cum,
                            f'le="{le}"',
                        )
                    )
                lines.append(
                    series(
                        "pathway_index_tier_cold_fetch_seconds_sum",
                        f"{cold_fetch.total:.9f}",
                    )
                )
                lines.append(
                    series(
                        "pathway_index_tier_cold_fetch_seconds_count",
                        cold_fetch.count,
                    )
                )
        return lines

    @staticmethod
    def _decode_lines(wl: str = "") -> list[str]:
        """Decode plane (``pathway_decode_*``): token throughput, KV
        page-pool occupancy and prefill/step latency histograms.
        Rendered only once the decode plane has run — ``/metrics``
        stays byte-identical for pipelines that never decode."""
        from ..decode.metrics import DECODE_METRICS

        if not DECODE_METRICS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = DECODE_METRICS.snapshot()
        lines: list[str] = []
        for metric, key, kind in (
            ("pathway_decode_tokens_total", "tokens_total", "counter"),
            ("pathway_decode_prefills_total", "prefill_total", "counter"),
            ("pathway_decode_steps_total", "steps_total", "counter"),
            ("pathway_decode_preempted_total", "preempted_total", "counter"),
            ("pathway_decode_degraded_total", "degraded_total", "counter"),
            ("pathway_decode_queries_total", "queries_total", "counter"),
            ("pathway_decode_kv_pages_in_use", "kv_pages_in_use", "gauge"),
            ("pathway_decode_kv_page_pool", "kv_page_pool", "gauge"),
            ("pathway_decode_active_lanes", "active_lanes", "gauge"),
            ("pathway_decode_tokens_per_second", "tokens_per_second", "gauge"),
        ):
            lines.append(f"# TYPE {metric} {kind}")
            lines.append(series(metric, snap[key]))
        # prefix-cache / speculative series render only once those
        # features recorded something (snapshot gates the keys) — the
        # cache-off / spec-off scrape stays byte-identical
        for metric, key, kind in (
            ("pathway_decode_prefix_hit_pages_total", "prefix_hit_pages_total", "counter"),
            ("pathway_decode_prefix_miss_pages_total", "prefix_miss_pages_total", "counter"),
            ("pathway_decode_prefix_cached_pages", "prefix_cached_pages", "gauge"),
            ("pathway_decode_prefix_hit_ratio", "prefix_hit_ratio", "gauge"),
            ("pathway_decode_spec_proposed_total", "spec_proposed_total", "counter"),
            ("pathway_decode_spec_accepted_total", "spec_accepted_total", "counter"),
            ("pathway_decode_spec_acceptance_rate", "spec_acceptance_rate", "gauge"),
        ):
            if key not in snap:
                continue
            lines.append(f"# TYPE {metric} {kind}")
            lines.append(series(metric, snap[key]))
        for stage, hist in DECODE_METRICS.stages.items():
            if not hist.count:
                continue
            metric = f"pathway_decode_{stage}_seconds"
            lines.append(f"# TYPE {metric} histogram")
            for le, cum in hist.cumulative():
                lines.append(series(f"{metric}_bucket", cum, f'le="{le}"'))
            lines.append(series(f"{metric}_sum", f"{hist.total:.9f}"))
            lines.append(series(f"{metric}_count", hist.count))
        return lines

    @staticmethod
    def _tracing_lines(wl: str = "") -> list[str]:
        """Request tracing plane (``pathway_request_stage_seconds``):
        per-stage latency histograms whose buckets carry OpenMetrics
        trace-id exemplars (``# {trace_id="..."} value ts``), so a
        dashboard's slow bucket links straight to
        ``pathway trace show <id>``. Rendered only once a span has been
        recorded — a tracing-off run scrapes byte-identical output."""
        from ..tracing import TRACING_METRICS

        if not TRACING_METRICS.active():
            return []

        def series(name: str, value, labels: str = "", exemplar: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            line = f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"
            return line + exemplar

        metric = "pathway_request_stage_seconds"
        lines = [f"# TYPE {metric} histogram"]
        for row in TRACING_METRICS.series():
            labels = (
                f'stage="{_escape_label(row["stage"])}",worker="{row["worker"]}"'
            )
            for le, cum, ex in row["buckets"]:
                exemplar = ""
                if ex is not None:
                    tid, val, ts = ex
                    exemplar = (
                        f' # {{trace_id="{tid}"}} {val:.9f} {ts:.3f}'
                    )
                lines.append(
                    series(
                        f"{metric}_bucket", cum, f'{labels},le="{le}"', exemplar
                    )
                )
            lines.append(series(f"{metric}_sum", f"{row['sum']:.9f}", labels))
            lines.append(series(f"{metric}_count", row["count"], labels))
        return lines

    @staticmethod
    def _ledger_lines(wl: str = "") -> list[str]:
        """HBM ledger plane (``pathway_hbm_*``): per-account live bytes,
        used bytes, high-water and fragmentation, plus the process
        totals. Rendered only once a subsystem reported an allocation —
        runs that never touch the ledger scrape byte-identical."""
        from .ledger import LEDGER

        if not LEDGER.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = LEDGER.snapshot()
        lines: list[str] = []
        for metric, key, kind in (
            ("pathway_hbm_bytes", "bytes", "gauge"),
            ("pathway_hbm_used_bytes", "used_bytes", "gauge"),
            ("pathway_hbm_high_water_bytes", "high_water_bytes", "gauge"),
            ("pathway_hbm_fragmentation", "fragmentation", "gauge"),
            ("pathway_hbm_owners", "owners", "gauge"),
        ):
            lines.append(f"# TYPE {metric} {kind}")
            for account in sorted(snap["accounts"]):
                lines.append(
                    series(
                        metric,
                        snap["accounts"][account][key],
                        f'account="{_escape_label(account)}"',
                    )
                )
        lines.append("# TYPE pathway_hbm_total_bytes gauge")
        lines.append(series("pathway_hbm_total_bytes", snap["total_bytes"]))
        lines.append("# TYPE pathway_hbm_total_high_water_bytes gauge")
        lines.append(
            series("pathway_hbm_total_high_water_bytes", snap["high_water_bytes"])
        )
        lines.append("# TYPE pathway_hbm_budget_bytes gauge")
        lines.append(series("pathway_hbm_budget_bytes", snap["budget_bytes"]))
        return lines

    @staticmethod
    def _tenancy_lines(wl: str = "") -> list[str]:
        """Per-tenant plane (``tenant``-labeled series under the
        serving/index/hbm prefixes). Rendered only once a tenant was
        ever named on an admit or index — single-tenant runs scrape
        byte-identical. Tenants past PATHWAY_METRIC_TENANTS fold into
        ``tenant="other"`` (the fold happens in snapshot(), so the
        label set stays bounded no matter how many tenants exist)."""
        from ..tenancy.metrics import TENANCY_METRICS

        if not TENANCY_METRICS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = TENANCY_METRICS.snapshot()
        tenants = snap["tenants"]
        lines: list[str] = []
        for metric, key, kind, fmt in (
            ("pathway_serving_tenant_admitted_total", "admitted", "counter", str),
            ("pathway_serving_tenant_degraded_total", "degraded", "counter", str),
            ("pathway_serving_tenant_inflight", "inflight", "gauge", str),
            (
                "pathway_serving_tenant_chip_seconds_total",
                "chip_seconds",
                "counter",
                lambda v: f"{v:.6f}",
            ),
            ("pathway_index_tenant_docs", "docs", "gauge", str),
            ("pathway_index_tenant_searches_total", "searches", "counter", str),
            ("pathway_hbm_tenant_bytes", "hbm_bytes", "gauge", str),
        ):
            lines.append(f"# TYPE {metric} {kind}")
            for tenant, row in tenants.items():
                lines.append(
                    series(metric, fmt(row[key]), f'tenant="{_escape_label(tenant)}"')
                )
        shed_lines = [
            series(
                "pathway_serving_tenant_shed_total",
                n,
                f'tenant="{_escape_label(tenant)}",reason="{_escape_label(reason)}"',
            )
            for tenant, row in tenants.items()
            for reason, n in sorted(row["shed"].items())
        ]
        if shed_lines:
            lines.append("# TYPE pathway_serving_tenant_shed_total counter")
            lines.extend(shed_lines)
        lines.append("# TYPE pathway_tenant_count gauge")
        lines.append(series("pathway_tenant_count", snap["tenant_count"]))
        lines.append("# TYPE pathway_tenant_folded gauge")
        lines.append(series("pathway_tenant_folded", snap["folded"]))
        return lines

    @staticmethod
    def _chip_lines(wl: str = "") -> list[str]:
        """Chip-time attribution plane (``pathway_chip_*``): per-account
        device-seconds/dispatches/share, the stranded residual with its
        cause split, encode MFU, and per-tenant chip share vs DRR
        weight. Rendered only once a dispatch booked chip time — runs
        with accounting off scrape byte-identical."""
        from .chip_ledger import CHIP_LEDGER

        if not CHIP_LEDGER.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = CHIP_LEDGER.snapshot()
        lines: list[str] = []
        for metric, key, kind, fmt in (
            (
                "pathway_chip_seconds_total",
                "seconds",
                "counter",
                lambda v: f"{v:.6f}",
            ),
            ("pathway_chip_dispatches_total", "dispatches", "counter", str),
            ("pathway_chip_share", "share", "gauge", lambda v: f"{v:.4f}"),
        ):
            lines.append(f"# TYPE {metric} {kind}")
            for account in snap["accounts"]:
                lines.append(
                    series(
                        metric,
                        fmt(snap["accounts"][account][key]),
                        f'account="{_escape_label(account)}"',
                    )
                )
        lines.append("# TYPE pathway_chip_busy_seconds_total counter")
        lines.append(
            series("pathway_chip_busy_seconds_total", f"{snap['busy_seconds']:.6f}")
        )
        lines.append("# TYPE pathway_chip_accounted_fraction gauge")
        lines.append(
            series(
                "pathway_chip_accounted_fraction",
                f"{snap['accounted_fraction']:.4f}",
            )
        )
        lines.append("# TYPE pathway_chip_stranded_seconds_total counter")
        lines.append(
            series(
                "pathway_chip_stranded_seconds_total",
                f"{snap['stranded_seconds']:.6f}",
            )
        )
        lines.append("# TYPE pathway_chip_stranded_fraction gauge")
        lines.append(
            series(
                "pathway_chip_stranded_fraction", f"{snap['stranded_fraction']:.4f}"
            )
        )
        causes = snap.get("stranded_causes") or {}
        if causes:
            lines.append("# TYPE pathway_chip_stranded_cause_seconds_total counter")
            for cause in sorted(causes):
                lines.append(
                    series(
                        "pathway_chip_stranded_cause_seconds_total",
                        f"{causes[cause]:.6f}",
                        f'cause="{_escape_label(cause)}"',
                    )
                )
        mfu = snap.get("encode_mfu")
        if mfu:
            lines.append("# TYPE pathway_chip_encode_mfu gauge")
            lines.append(series("pathway_chip_encode_mfu", f"{mfu['mfu']:.6f}"))
        tenants = snap.get("tenants") or {}
        if tenants:
            lines.append("# TYPE pathway_chip_tenant_seconds_total counter")
            for tenant in tenants:
                lines.append(
                    series(
                        "pathway_chip_tenant_seconds_total",
                        f"{tenants[tenant]['seconds']:.6f}",
                        f'tenant="{_escape_label(tenant)}"',
                    )
                )
            lines.append("# TYPE pathway_chip_tenant_share gauge")
            for tenant in tenants:
                lines.append(
                    series(
                        "pathway_chip_tenant_share",
                        f"{tenants[tenant]['share']:.4f}",
                        f'tenant="{_escape_label(tenant)}"',
                    )
                )
        return lines

    @staticmethod
    def _elastic_lines(wl: str = "") -> list[str]:
        """Elastic reshard plane (``pathway_elastic_*``): completed
        reshards by trigger reason, migrated chunk/row counters, cutover
        and rollback totals, the dual-window dedup and fence counters,
        last reshard MTTR, the generation gauge, and — while a migration
        is in flight — its progress. Rendered only once the plane saw a
        migration, so elastic-off runs scrape byte-identical."""
        from ..elastic.metrics import ELASTIC_METRICS

        if not ELASTIC_METRICS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = ELASTIC_METRICS.snapshot()
        lines = ["# TYPE pathway_elastic_reshards_total counter"]
        for reason in sorted(snap["reshards"]):
            lines.append(
                series(
                    "pathway_elastic_reshards_total",
                    snap["reshards"][reason],
                    f'reason="{_escape_label(reason)}"',
                )
            )
        lines.extend(
            [
                "# TYPE pathway_elastic_chunks_migrated_total counter",
                series(
                    "pathway_elastic_chunks_migrated_total", snap["chunks_migrated"]
                ),
                "# TYPE pathway_elastic_rows_migrated_total counter",
                series("pathway_elastic_rows_migrated_total", snap["rows_migrated"]),
                "# TYPE pathway_elastic_cutovers_total counter",
                series("pathway_elastic_cutovers_total", snap["cutovers_total"]),
                "# TYPE pathway_elastic_rollbacks_total counter",
                series("pathway_elastic_rollbacks_total", snap["rollbacks_total"]),
                "# TYPE pathway_elastic_dedup_dropped_total counter",
                series(
                    "pathway_elastic_dedup_dropped_total", snap["dedup_dropped_total"]
                ),
                "# TYPE pathway_elastic_fenced_writes_total counter",
                series(
                    "pathway_elastic_fenced_writes_total", snap["fenced_writes_total"]
                ),
                "# TYPE pathway_elastic_last_mttr_seconds gauge",
                series(
                    "pathway_elastic_last_mttr_seconds", f"{snap['last_mttr_s']:.6f}"
                ),
                "# TYPE pathway_elastic_generation gauge",
                series("pathway_elastic_generation", snap["generation"]),
            ]
        )
        mig = snap.get("migration")
        if mig:
            lines.extend(
                [
                    "# TYPE pathway_elastic_migration_chunks_done gauge",
                    series(
                        "pathway_elastic_migration_chunks_done", mig["chunks_done"]
                    ),
                    "# TYPE pathway_elastic_migration_chunks_total gauge",
                    series(
                        "pathway_elastic_migration_chunks_total", mig["chunks_total"]
                    ),
                    "# TYPE pathway_elastic_migration_target_shards gauge",
                    series(
                        "pathway_elastic_migration_target_shards", mig["to_shards"]
                    ),
                ]
            )
        return lines

    @staticmethod
    def _freshness_lines(wl: str = "") -> list[str]:
        """Freshness plane (``pathway_freshness_*``): per-plane lag
        accrual (ingest queue / staging / epoch / publish / promotion /
        migration), the ingest→visible lag histogram, per-index visible
        watermarks with current staleness, the configured SLO, and
        per-tenant answer bounds. Rendered only once the plane recorded
        something, so freshness-off runs scrape byte-identical."""
        from ..freshness.plane import FRESHNESS

        if not FRESHNESS.active():
            return []

        def series(name: str, value, labels: str = "") -> str:
            parts = ",".join(p for p in (labels, wl) if p)
            return f"{name}{{{parts}}} {value}" if parts else f"{name} {value}"

        snap = FRESHNESS.snapshot()
        lines = ["# TYPE pathway_freshness_seconds counter"]
        for plane in sorted(snap["planes"]):
            row = snap["planes"][plane]
            lines.append(
                series(
                    "pathway_freshness_seconds",
                    f"{row['seconds']:.6f}",
                    f'plane="{_escape_label(plane)}"',
                )
            )
        lag = snap["lag"]
        lines.append("# TYPE pathway_freshness_visibility_lag_seconds histogram")
        cum = 0
        for le, count in zip(lag["buckets_s"], lag["hist"]):
            cum += count
            lines.append(
                series(
                    "pathway_freshness_visibility_lag_seconds_bucket",
                    cum,
                    f'le="{le:g}"',
                )
            )
        lines.extend(
            [
                series(
                    "pathway_freshness_visibility_lag_seconds_bucket",
                    lag["count"],
                    'le="+Inf"',
                ),
                series(
                    "pathway_freshness_visibility_lag_seconds_sum",
                    f"{lag['total_s']:.6f}",
                ),
                series(
                    "pathway_freshness_visibility_lag_seconds_count", lag["count"]
                ),
            ]
        )
        lines.append("# TYPE pathway_freshness_staleness_seconds gauge")
        for key in sorted(snap["watermarks"]):
            row = snap["watermarks"][key]
            lines.append(
                series(
                    "pathway_freshness_staleness_seconds",
                    f"{row['staleness_ms'] / 1000.0:.6f}",
                    f'index="{_escape_label(key)}",shard="min"',
                )
            )
        if snap["slo_ms"] is not None:
            lines.extend(
                [
                    "# TYPE pathway_freshness_slo_seconds gauge",
                    series(
                        "pathway_freshness_slo_seconds",
                        f"{snap['slo_ms'] / 1000.0:.6f}",
                    ),
                ]
            )
        tenants = {t: row for t, row in snap["answers"].items() if t}
        if tenants:
            lines.append("# TYPE pathway_freshness_answer_staleness_seconds gauge")
            for t in sorted(tenants):
                lines.append(
                    series(
                        "pathway_freshness_answer_staleness_seconds",
                        f"{tenants[t]['last_ms'] / 1000.0:.6f}",
                        f'tenant="{_escape_label(t)}"',
                    )
                )
        return lines

    def _status(self) -> str:
        snap = self.monitor.snapshot
        from ..resilience import RETRY_METRICS, SUPERVISOR_METRICS

        sup = SUPERVISOR_METRICS.snapshot()
        status: dict = {
            "epoch": snap.time,
            "rows_in": snap.rows_in,
            "rows_out": snap.rows_out,
            "operators": snap.operators,
            "operator_self_time_s": snap.operator_self_time_s,
            "operator_event_lag_s": snap.operator_event_lag_s,
            # one JSON poll gives run health: the resilience + pipeline
            # state already rendered on /metrics
            "restarts_total": sup["restarts_total"],
            "retries": RETRY_METRICS.snapshot(),
            "supervisor": sup,
            "pipeline": {
                "depth": getattr(snap, "pipeline_depth", 1),
                "host_prep_s": getattr(snap, "host_prep_s", 0.0),
                "device_wait_s": getattr(snap, "device_wait_s", 0.0),
                "overlap_ratio": getattr(snap, "overlap_ratio", 0.0),
            },
            "monitoring_http_port": self.port,
        }
        workers = getattr(snap, "workers", {}) or {}
        if workers:
            status["workers"] = {str(wid): workers[wid] for wid in sorted(workers)}
        from ..resilience import CLUSTER_HEALTH, CLUSTER_METRICS

        if CLUSTER_METRICS.active() or CLUSTER_HEALTH.any_down():
            cluster = CLUSTER_METRICS.snapshot()
            cluster["down_shards"] = sorted(CLUSTER_HEALTH.down_shards())
            status["cluster"] = cluster
        from ..serving import SERVING_METRICS

        if SERVING_METRICS.active():
            status["serving"] = SERVING_METRICS.snapshot()
        from ..ops.index_metrics import INDEX_METRICS

        if INDEX_METRICS.active():
            status["index"] = INDEX_METRICS.snapshot()
        from ..ingest.metrics import INGEST_METRICS

        if INGEST_METRICS.active():
            status["ingest"] = INGEST_METRICS.snapshot()
        from ..decode.metrics import DECODE_METRICS

        if DECODE_METRICS.active():
            status["decode"] = DECODE_METRICS.snapshot()
        from ..tracing import TRACE_STORE, TRACING_METRICS

        if TRACING_METRICS.active() or TRACE_STORE.active():
            status["tracing"] = {
                "stages": TRACING_METRICS.snapshot(),
                **TRACE_STORE.snapshot(),
            }
        from .ledger import LEDGER

        if LEDGER.active():
            status["hbm"] = LEDGER.snapshot()
        from ..tenancy.metrics import TENANCY_METRICS

        if TENANCY_METRICS.active():
            status["tenants"] = TENANCY_METRICS.snapshot()
        from .chip_ledger import CHIP_LEDGER

        if CHIP_LEDGER.active():
            status["chip"] = CHIP_LEDGER.snapshot()
        from ..elastic.metrics import ELASTIC_METRICS

        if ELASTIC_METRICS.active():
            status["elastic"] = ELASTIC_METRICS.snapshot()
        from ..freshness.plane import FRESHNESS

        if FRESHNESS.active():
            status["freshness"] = FRESHNESS.snapshot()
        return json.dumps(status)

    # -- lifecycle --

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/metrics"):
                    body = server._prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/status"):
                    body = server._status().encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence request logging
                pass

        try:
            self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        except OSError as exc:
            # two concurrent runs on one machine both compute
            # 20000 + process_id; rather than dying, fall back to an
            # ephemeral port and say where we ended up
            self._httpd = ThreadingHTTPServer((self.host, 0), Handler)
            logger.warning(
                "monitoring HTTP port %d unavailable (%s); serving /metrics on "
                "port %d instead",
                self.port,
                exc,
                self._httpd.server_port,
            )
        self.port = self._httpd.server_port  # resolves port=0 to the bound one
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pathway_tpu_torch:monitoring-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
