"""Tail-latency attribution: "where did the p99 go".

The port's copy of the reference's ``tracing/attribution.py``. Works on
serialized span dicts (the shape :class:`~.store.Span.to_dict` produces,
which is also the trace-dump wire format), so the same code
answers live queries (``/status``), post-mortem CLI queries
(``pathway trace slow`` over dump files), and a benchmark gate that
requires per-stage attribution to cover ≥95% of each slow request's
measured wall time.

Attribution of one trace: the *root* span's duration is the request's
wall time; its direct children are the stage decomposition
(admission → queue → dispatch → ...). ``coverage`` is the root-clipped
interval **union** of the children over the wall — overlapping spans
don't double-count, and coverage < 1 means part of the journey is
unattributed (a gap worth a new span site)."""

from __future__ import annotations

import time as _time
from typing import Iterable


def _root_of(spans: list[dict]) -> dict | None:
    # boundary spans are the journey root even when an inbound
    # ``traceparent`` gave them a remote (client-side) parent
    roots = [s for s in spans if not s.get("parent") or s.get("boundary")]
    if not roots:
        return None
    return max(roots, key=lambda s: s.get("dur_ms", 0.0))


def attribute(spans: list[dict], trace_id: str | None = None) -> dict:
    """Per-stage breakdown of one trace's spans."""
    spans = [s for s in spans if s.get("dur_ms") is not None]
    if trace_id is None and spans:
        trace_id = spans[0].get("trace", "")
    root = _root_of(spans)
    if root is not None:
        wall_ms = float(root.get("dur_ms", 0.0))
        t0 = float(root.get("start", 0.0))
        children = [s for s in spans if s.get("parent") == root.get("span")]
    else:
        starts = [float(s.get("start", 0.0)) for s in spans]
        ends = [
            float(s.get("start", 0.0)) + float(s.get("dur_ms", 0.0)) / 1000.0
            for s in spans
        ]
        t0 = min(starts) if starts else 0.0
        wall_ms = (max(ends) - t0) * 1000.0 if spans else 0.0
        children = list(spans)

    stages: dict[str, float] = {}
    intervals: list[tuple[float, float]] = []
    t1 = t0 + wall_ms / 1000.0
    for s in children:
        dur_ms = float(s.get("dur_ms", 0.0))
        stages[s.get("stage", "?")] = stages.get(s.get("stage", "?"), 0.0) + dur_ms
        a = float(s.get("start", 0.0))
        b = a + dur_ms / 1000.0
        a, b = max(a, t0), min(b, t1)
        if b > a:
            intervals.append((a, b))

    covered = _union_seconds(intervals)
    coverage = min(1.0, covered / (wall_ms / 1000.0)) if wall_ms > 0 else 0.0
    breakdown = {
        stage: {
            "ms": round(ms, 4),
            "pct": round(100.0 * ms / wall_ms, 2) if wall_ms > 0 else 0.0,
        }
        for stage, ms in sorted(stages.items(), key=lambda kv: -kv[1])
    }
    return {
        "trace_id": trace_id or "",
        "wall_ms": round(wall_ms, 4),
        "stages": breakdown,
        "coverage": round(coverage, 4),
        "spans": len(spans),
    }


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_a, cur_b = intervals[0]
    for a, b in intervals[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    total += cur_b - cur_a
    return total


def slow_report(exemplar_traces: Iterable[dict], top_n: int = 10) -> dict:
    """Attribution over retained exemplars: the top-N slowest traces
    individually, plus the aggregate per-stage share — the direct
    answer to "where did the p99 go"."""
    rows = []
    for tr in exemplar_traces:
        att = attribute(tr.get("spans", []), tr.get("trace_id"))
        if not att["wall_ms"]:
            att["wall_ms"] = float(tr.get("wall_ms", 0.0))
        rows.append(att)
    rows.sort(key=lambda r: -r["wall_ms"])
    rows = rows[:top_n]
    agg_ms: dict[str, float] = {}
    wall_total = 0.0
    for r in rows:
        wall_total += r["wall_ms"]
        for stage, d in r["stages"].items():
            agg_ms[stage] = agg_ms.get(stage, 0.0) + d["ms"]
    aggregate = {
        stage: round(100.0 * ms / wall_total, 2) if wall_total > 0 else 0.0
        for stage, ms in sorted(agg_ms.items(), key=lambda kv: -kv[1])
    }
    return {"traces": rows, "aggregate_pct": aggregate, "wall_ms_total": round(wall_total, 4)}


def render_slow_report(report: dict) -> str:
    rows = report.get("traces", [])
    lines = [f"top {len(rows)} slowest traces (retained exemplars):"]
    stage_order = list(report.get("aggregate_pct", {}).keys())
    header = f"  {'trace':<18} {'wall_ms':>9} {'cover':>6}"
    for stage in stage_order:
        header += f" {stage[:12]:>12}"
    lines.append(header)
    for r in rows:
        line = (
            f"  {r['trace_id'][:16]:<18} {r['wall_ms']:>9.3f}"
            f" {100.0 * r['coverage']:>5.1f}%"
        )
        for stage in stage_order:
            d = r["stages"].get(stage)
            line += f" {d['pct']:>11.1f}%" if d else f" {'-':>12}"
        lines.append(line)
    agg = report.get("aggregate_pct", {})
    if agg:
        lines.append(
            "  where the tail went: "
            + "  ".join(f"{stage}={pct:.1f}%" for stage, pct in agg.items())
        )
    return "\n".join(lines)


def render_waterfall(
    trace_id: str,
    spans: list[dict],
    blackbox_events: list[dict] | None = None,
    width: int = 32,
) -> str:
    """Text waterfall of one trace, with matching flight-recorder
    events interleaved at their timestamps (``pathway trace show``)."""
    spans = sorted(spans, key=lambda s: float(s.get("start", 0.0)))
    att = attribute(spans, trace_id)
    lines = [
        f"trace {trace_id} — wall {att['wall_ms']:.3f} ms, "
        f"{len(spans)} spans, coverage {100.0 * att['coverage']:.1f}%"
    ]
    if not spans:
        return "\n".join(lines + ["  (no spans)"])
    t0 = min(float(s.get("start", 0.0)) for s in spans)
    t1 = max(
        float(s.get("start", 0.0)) + float(s.get("dur_ms", 0.0)) / 1000.0
        for s in spans
    )
    total_s = max(t1 - t0, 1e-9)

    rows: list[tuple[float, str]] = []
    for s in spans:
        start = float(s.get("start", 0.0))
        dur_ms = float(s.get("dur_ms", 0.0))
        off = start - t0
        lead = int(width * off / total_s)
        bar = max(1, int(width * (dur_ms / 1000.0) / total_s))
        extras = ""
        attrs = s.get("attrs") or {}
        if attrs:
            extras = " " + " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
        if s.get("links"):
            extras += f" links={len(s['links'])}"
        if s.get("open"):
            extras += " (OPEN)"
        rows.append(
            (
                start,
                f"  {off * 1000.0:>9.3f} ms |{' ' * lead}{'█' * bar:<{width - lead}}|"
                f" {s.get('stage', '?')} {dur_ms:.3f} ms"
                f" [w{s.get('worker', 0)}]{extras}",
            )
        )
    for ev in blackbox_events or []:
        t = float(ev.get("time", 0.0))
        off = t - t0
        extras = " ".join(
            f"{k}={ev[k]}"
            for k in sorted(ev)
            if k not in ("seq", "time", "kind", "trace")
        )
        stamp = _time.strftime("%H:%M:%S", _time.gmtime(t))
        rows.append(
            (
                t,
                f"  {off * 1000.0:>9.3f} ms {'·':>{width + 3}} blackbox {stamp} "
                f"{ev.get('kind', '?')} {extras}".rstrip(),
            )
        )
    rows.sort(key=lambda r: r[0])
    lines.extend(text for _t, text in rows)
    if att["stages"]:
        lines.append(
            "  breakdown: "
            + "  ".join(
                f"{stage}={d['pct']:.1f}%" for stage, d in att["stages"].items()
            )
        )
    return "\n".join(lines)
