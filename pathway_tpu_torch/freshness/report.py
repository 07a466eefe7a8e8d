"""``pathway freshness`` — where the visibility lag accrues.

The port's copy of the reference's ``freshness/report.py``. Renders a
freshness-plane snapshot (from a live ``/status`` endpoint or the last
journal sample) as a per-plane accrual report: how much of the
ingest→visible lag each plane (ingest queue, staging, epoch, publish,
promotion, migration) is responsible for, the end-to-end p50/p99, every
index's visible watermark + current staleness, per-tenant answer bounds,
and the verdict against the configured freshness SLO. Pure stdlib.
"""

from __future__ import annotations

from typing import Any

from .plane import PLANES

#: fraction of the SLO at which the verdict goes yellow (matches the
#: watchdog freshness rule's warn threshold on freshness_burn)
SLO_WARN_FRACTION = 0.8


def freshness_state(fresh: dict | None) -> str:
    """'green' / 'yellow' / 'red' from the lag EWMA vs the configured
    SLO; 'empty' when there is no freshness block to judge."""
    if not fresh:
        return "empty"
    slo_ms = fresh.get("slo_ms")
    lag = fresh.get("lag") or {}
    ewma = lag.get("ewma_ms")
    if not slo_ms or ewma is None:
        return "green"
    if ewma >= float(slo_ms):
        return "red"
    if ewma >= SLO_WARN_FRACTION * float(slo_ms):
        return "yellow"
    return "green"


def _fmt_ms(ms: float) -> str:
    if ms >= 10_000:
        return f"{ms / 1000.0:7.1f}s"
    return f"{ms:7.2f}ms"


def render_freshness(data: dict[str, Any]) -> tuple[str, str]:
    """Render one report. ``data`` is a ``/status`` payload or a journal
    sample — both carry the same activity-gated ``freshness`` block.
    Returns ``(text, state)`` with state in green/yellow/red/empty."""
    fresh = data.get("freshness")
    state = freshness_state(fresh)
    lines: list[str] = ["pathway freshness — ingest→visible watermark plane"]
    if state == "empty":
        lines.append(
            "  (no freshness samples — enable with pw.run(freshness=True) "
            "or PATHWAY_FRESHNESS=1)"
        )
        return "\n".join(lines), state

    lag = fresh.get("lag") or {}
    slo_ms = fresh.get("slo_ms")
    head = (
        f"  e2e lag p50 {_fmt_ms(float(lag.get('p50_ms', 0.0))).strip()}"
        f"  p99 {_fmt_ms(float(lag.get('p99_ms', 0.0))).strip()}"
        f"  ewma {_fmt_ms(float(lag.get('ewma_ms') or 0.0)).strip()}"
        f"  epochs {int(fresh.get('epochs', 0))}"
    )
    if slo_ms:
        head += f"  slo {_fmt_ms(float(slo_ms)).strip()}"
    head += f"  [{state}]"
    lines.append(head)

    planes = fresh.get("planes") or {}
    total_s = sum(float((planes.get(p) or {}).get("seconds", 0.0)) for p in planes)
    measured_s = float(lag.get("total_s", 0.0))
    lines.append(f"  {'plane':<14} {'accrued':>10} {'share':>7} {'events':>8}")
    ordered = [p for p in PLANES if p in planes] + sorted(
        p for p in planes if p not in PLANES
    )
    for p in ordered:
        row = planes.get(p) or {}
        secs = float(row.get("seconds", 0.0))
        share = secs / total_s if total_s > 1e-12 else 0.0
        lines.append(
            f"  {p:<14} {secs * 1000.0:>8.1f}ms {100 * share:>6.1f}% "
            f"{int(row.get('events', 0)):>8}"
        )
    coverage = fresh.get("coverage")
    if coverage is not None and measured_s > 1e-12:
        lines.append(
            f"  accrual covers {100 * float(coverage):.1f}% of the measured "
            f"{measured_s * 1000.0:.1f}ms end-to-end lag"
        )

    watermarks = fresh.get("watermarks") or {}
    if watermarks:
        lines.append(
            f"  {'index':<14} {'shards':>6} {'wm epoch':>9} {'staleness':>10} {'gen':>4}"
        )
        for key, row in watermarks.items():
            lines.append(
                f"  {key:<14} {int(row.get('shards', 0)):>6} "
                f"{int(row.get('wm_epoch', -1)):>9} "
                f"{_fmt_ms(float(row.get('staleness_ms', 0.0))):>10} "
                f"{int(row.get('generation', 0)):>4}"
            )

    answers = fresh.get("answers") or {}
    if answers:
        lines.append(f"  {'tenant':<14} {'answers':>8} {'mean bound':>11} {'max bound':>10}")
        for tenant, row in answers.items():
            lines.append(
                f"  {tenant or '(untagged)':<14} {int(row.get('count', 0)):>8} "
                f"{_fmt_ms(float(row.get('mean_ms', 0.0))):>11} "
                f"{_fmt_ms(float(row.get('max_ms', 0.0))):>10}"
            )
    return "\n".join(lines), state
