"""BENCH_r*-style snapshots from the metrics journal, and the per-plane
regression diff ``pathway perf diff`` prints.

A benchmark harness appends one ``kind="bench"`` journal record per FINAL
SUMMARY (suite name, the summary records, the headline metric).
:func:`build_snapshot` reassembles those into the exact shape the
checked-in ``BENCH_r0*.json`` files use — ``{"n", "cmd", "rc", "tail",
"parsed"}`` — automating the BENCH_r06 capture runbook: run the suites
with ``PATHWAY_JOURNAL_DIR`` set, then ``pathway perf snapshot`` writes
the round file without hand-collection.

:func:`diff_snapshots` compares two such files metric-by-metric with
direction-aware gate thresholds (throughput metrics must not fall,
latency metrics must not rise, ``gate=``-carrying fractions must still
clear their gate).
"""

from __future__ import annotations

import json
from typing import Any

from .journal import get_journal

SUMMARY_MARKER = "=== FINAL SUMMARY (one line per metric) ==="

#: Default relative-change gate for `perf diff` (10%); override with
#: ``--gate`` on the CLI.
DEFAULT_GATE = 0.10

_HIGHER_UNITS = {
    "rows/s",
    "queries/s",
    "docs/s",
    "embeddings/s",
    "tokens/s",
    "items/s",
    "eps",
    "qps",
}
_LOWER_UNITS = {"ms", "s", "seconds", "bytes"}


def build_snapshot(
    directory: str | None = None,
    *,
    n: int | None = None,
    cmd: str | None = None,
) -> dict:
    """Assemble a BENCH_r*-style dict from the journal's bench records.

    ``tail`` is the reconstructed FINAL SUMMARY text (every suite's
    lines, in journal order); ``parsed`` is the last headline metric.
    Raises ``ValueError`` when the journal holds no bench records —
    there is nothing truthful to snapshot.
    """
    j = get_journal(directory)
    recs = j.tail(10_000, kind="bench") if j is not None else []
    if not recs:
        raise ValueError(
            "no bench records in the journal — run bench suites with "
            "PATHWAY_JOURNAL_DIR set, then snapshot"
        )
    lines: list[str] = [SUMMARY_MARKER]
    parsed: dict | None = None
    suites: list[str] = []
    for rec in recs:
        suite = rec.get("suite")
        if suite:
            suites.append(str(suite))
        for r in rec.get("records") or []:
            lines.append(json.dumps(r, sort_keys=True))
        headline = rec.get("headline")
        if isinstance(headline, dict) and headline:
            lines.append(json.dumps(headline, sort_keys=True))
            parsed = headline
    return {
        "n": int(n) if n is not None else 0,
        "cmd": cmd or f"pathway perf snapshot ({', '.join(suites) or 'journal'})",
        "rc": 0,
        "tail": "\n".join(lines),
        "parsed": parsed or {},
    }


def parse_summary_lines(tail: str) -> list[dict]:
    """Extract the one-JSON-per-metric records from a snapshot's
    ``tail`` text (everything after the FINAL SUMMARY marker; tolerant
    of prose lines mixed in)."""
    if SUMMARY_MARKER in tail:
        tail = tail.split(SUMMARY_MARKER, 1)[1]
    out: list[dict] = []
    for line in tail.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metric" in rec and "value" in rec:
            out.append(rec)
    return out


def _metrics_of(snap: dict) -> dict[str, dict]:
    """metric name -> record, last occurrence wins (reruns supersede)."""
    out: dict[str, dict] = {}
    for rec in parse_summary_lines(str(snap.get("tail", ""))):
        out[str(rec["metric"])] = rec
    parsed = snap.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed and "value" in parsed:
        out[str(parsed["metric"])] = parsed
    return out


def _direction(metric: str, unit: str) -> str:
    """'higher' (throughput must not fall), 'lower' (latency must not
    rise), or 'two_sided' (any large move is suspect)."""
    u = unit.strip().lower()
    m = metric.lower()
    if u in _HIGHER_UNITS or u.endswith("/s") or m.endswith(("_per_sec", "_eps", "_qps")):
        return "higher"
    if u in _LOWER_UNITS or m.endswith(("_ms", "_s", "_seconds", "_bytes")):
        return "lower"
    # freshness metrics are lags/staleness: lower is better, even the
    # unitless ones — except coverage/fraction gauges, which carry
    # their own absolute gate and grade higher-is-better
    if m.startswith(("freshness_", "staleness_")) and not m.endswith(
        ("coverage", "fraction")
    ):
        return "lower"
    return "two_sided"


def diff_snapshots(a: dict, b: dict, *, gate: float = DEFAULT_GATE) -> dict:
    """Compare snapshot ``a`` (baseline) to ``b`` (candidate).

    Returns ``{"rows": [...], "regressions": [...], "rc": 0|1}`` where
    each row is ``{metric, unit, a, b, rel_change, direction, status}``.
    A metric regresses when it moves past ``gate`` in its bad direction,
    or when it carries an absolute ``gate`` field (accounted-fraction
    style) that the candidate value no longer clears.

    A metric present in only one snapshot is reported as status
    ``"new"`` (candidate only) or ``"removed"`` (baseline only) with
    the missing side ``None`` — suite membership drift is information,
    not a regression, so one-sided rows never fail the diff.
    """
    am, bm = _metrics_of(a), _metrics_of(b)
    rows: list[dict] = []
    regressions: list[dict] = []
    for name in sorted(set(am) | set(bm)):
        ra, rb = am.get(name), bm.get(name)
        if ra is None or rb is None:
            only = rb if ra is None else ra
            try:
                val = float(only["value"])
            except (TypeError, ValueError):
                continue
            row = {
                "metric": name,
                "unit": str(only.get("unit", "")),
                "a": None if ra is None else val,
                "b": val if ra is None else None,
                "rel_change": None,
                "direction": _direction(name, str(only.get("unit", ""))),
                "status": "new" if ra is None else "removed",
            }
            if only.get("gate") is not None:
                row["gate"] = only["gate"]
            rows.append(row)
            continue
        try:
            va, vb = float(ra["value"]), float(rb["value"])
        except (TypeError, ValueError):
            continue
        unit = str(rb.get("unit", ra.get("unit", "")))
        direction = _direction(name, unit)
        rel = (vb - va) / abs(va) if va else (0.0 if vb == va else float("inf"))
        status = "ok"
        if direction == "higher" and rel < -gate:
            status = "regression"
        elif direction == "lower" and rel > gate:
            status = "regression"
        elif direction == "two_sided" and abs(rel) > gate:
            status = "regression"
        abs_gate = rb.get("gate", ra.get("gate"))
        if abs_gate is not None:
            try:
                g = float(abs_gate)
                # which side of the gate is "good"? the baseline says:
                # accounted-fraction style clears a floor from above
                # (regress when the candidate falls below), overhead
                # style sits under a ceiling (regress when it rises past)
                if va >= g:
                    if vb < g:
                        status = "regression"
                elif vb > g:
                    status = "regression"
            except (TypeError, ValueError):
                pass
        row = {
            "metric": name,
            "unit": unit,
            "a": va,
            "b": vb,
            "rel_change": round(rel, 4) if rel != float("inf") else rel,
            "direction": direction,
            "status": status,
        }
        if abs_gate is not None:
            row["gate"] = abs_gate
        rows.append(row)
        if status == "regression":
            regressions.append(row)
    return {"rows": rows, "regressions": regressions, "rc": 1 if regressions else 0}


def render_diff(result: dict) -> str:
    """Human table for ``pathway perf diff``."""
    rows = result["rows"]
    if not rows:
        return "perf diff: no overlapping metrics"
    name_w = max(len(r["metric"]) for r in rows)
    out = [f"{'metric'.ljust(name_w)}  {'baseline':>12}  {'candidate':>12}  {'Δ%':>8}  status"]
    for r in rows:
        rel = r["rel_change"]
        if rel is None:
            pct = "-"
        elif rel == float("inf"):
            pct = "inf"
        else:
            pct = f"{100 * rel:+.1f}"
        mark = "REGRESSION" if r["status"] == "regression" else r["status"]
        gate = f" (gate {r['gate']})" if "gate" in r else ""
        va = "-".rjust(12) if r["a"] is None else f"{r['a']:>12.3f}"
        vb = "-".rjust(12) if r["b"] is None else f"{r['b']:>12.3f}"
        out.append(
            f"{r['metric'].ljust(name_w)}  {va}  {vb}  {pct:>8}  {mark}{gate}"
        )
    n = len(result["regressions"])
    shared = sum(1 for r in rows if r["status"] not in ("new", "removed"))
    extra = len(rows) - shared
    tail = f" (+{extra} new/removed)" if extra else ""
    out.append(f"-- {n} regression(s) across {shared} shared metric(s){tail}")
    return "\n".join(out)


def load_snapshot(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: not a snapshot object")
    return data
