"""``pathway top`` — a terminal view of where the chip time goes.

Reads either a live ``/status`` endpoint (``--url``) or the last
journal sample (``--journal`` / ``PATHWAY_JOURNAL_DIR``) and renders:
per-plane chip-time share, encode MFU, the stranded fraction with its
cause breakdown, per-tenant share vs DRR weight, and HBM per account.
Pure stdlib.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any

from .journal import tail_samples

#: Stranded-fraction thresholds for the overall verdict line (matched
#: to the watchdog's stranded_chip_time rule defaults).
STRANDED_WARN = 0.5
STRANDED_CRITICAL = 0.8


def load_status_from_url(url: str, timeout: float = 5.0) -> dict:
    """Fetch a monitoring server's ``/status`` JSON."""
    if not url.rstrip("/").endswith("/status"):
        url = url.rstrip("/") + "/status"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def load_from_journal(directory: str | None = None) -> dict:
    """The most recent journal sample (chip/hbm/serving/tenancy blocks),
    or ``{}`` when the journal is missing or empty."""
    samples = tail_samples(1, directory)
    return samples[-1] if samples else {}


def _fmt_s(seconds: float) -> str:
    if seconds >= 100:
        return f"{seconds:8.1f}s"
    if seconds >= 0.1:
        return f"{seconds:8.3f}s"
    return f"{seconds * 1e3:7.2f}ms"


def verdict_state(chip: dict | None) -> str:
    """'green' / 'yellow' / 'red' from the stranded fraction; 'empty'
    when there is no chip block to judge."""
    if not chip:
        return "empty"
    stranded = float(chip.get("stranded_fraction", 0.0))
    if stranded >= STRANDED_CRITICAL:
        return "red"
    if stranded >= STRANDED_WARN:
        return "yellow"
    return "green"


def render_top(data: dict[str, Any]) -> tuple[str, str]:
    """Render one frame. ``data`` is a ``/status`` payload or a journal
    sample — both carry the same activity-gated blocks. Returns
    ``(text, state)`` with state in green/yellow/red/empty."""
    chip = data.get("chip")
    state = verdict_state(chip)
    lines: list[str] = ["pathway top — chip-time attribution"]
    if state == "empty":
        lines.append(
            "  (no chip-time samples — enable with pw.run(chip_ledger=True) "
            "or PATHWAY_CHIP_LEDGER=1)"
        )
        # a freshness-only session still gets its row below
        fresh = data.get("freshness")
        if not (isinstance(fresh, dict) and fresh):
            return "\n".join(lines), state
        state = "green"
    else:
        wall = float(chip.get("wall_seconds", 0.0))
        busy = float(chip.get("busy_seconds", 0.0))
        lines.append(
            f"  wall {_fmt_s(wall).strip()}  busy {_fmt_s(busy).strip()}  "
            f"accounted {100 * float(chip.get('accounted_fraction', 0.0)):.1f}%  "
            f"[{state}]"
        )

        accounts = chip.get("accounts") or {}
        if accounts:
            lines.append(
                f"  {'plane':<14} {'chip-time':>10} {'share':>7} {'dispatches':>11}"
            )
            for name, row in accounts.items():
                lines.append(
                    f"  {name:<14} {_fmt_s(float(row.get('seconds', 0.0))):>10} "
                    f"{100 * float(row.get('share', 0.0)):>6.1f}% "
                    f"{int(row.get('dispatches', 0)):>11}"
                )

        mfu = chip.get("encode_mfu")
        if mfu:
            lines.append(
                f"  encode MFU {100 * float(mfu.get('mfu', 0.0)):.2f}%  "
                f"({float(mfu.get('achieved_tflops', 0.0)):.1f} / "
                f"{float(mfu.get('peak_tflops', 0.0)):.1f} TFLOPs, "
                f"pad {100 * float(mfu.get('pad_fraction', 0.0)):.1f}%)"
            )

        stranded = float(chip.get("stranded_fraction", 0.0))
        causes = chip.get("stranded_causes") or {}
        cause_txt = ", ".join(
            f"{c}={_fmt_s(float(s)).strip()}" for c, s in causes.items()
        )
        lines.append(
            f"  stranded {100 * stranded:.1f}%"
            + (f"  ({cause_txt})" if cause_txt else "")
        )

        tenants = chip.get("tenants") or {}
        if tenants:
            lines.append(f"  {'tenant':<14} {'chip share':>10} {'drr weight':>11}")
            for t, row in tenants.items():
                ws = row.get("weight_share")
                ws_txt = (
                    f"{100 * float(ws):>10.1f}%" if ws is not None else f"{'—':>11}"
                )
                lines.append(
                    f"  {t:<14} {100 * float(row.get('share', 0.0)):>9.1f}% {ws_txt}"
                )

    fresh = data.get("freshness")
    if isinstance(fresh, dict) and fresh:
        from ..freshness.report import freshness_state

        fstate = freshness_state(fresh)
        lag = fresh.get("lag") or {}
        slo_ms = fresh.get("slo_ms")
        slo_txt = f"  slo {float(slo_ms):.0f}ms" if slo_ms else ""
        lines.append(
            f"  freshness p50 {float(lag.get('p50_ms', 0.0)):.1f}ms  "
            f"p99 {float(lag.get('p99_ms', 0.0)):.1f}ms  "
            f"ewma {float(lag.get('ewma_ms') or 0.0):.1f}ms{slo_txt}  [{fstate}]"
        )
        # freshness SLO breach outranks a green stranded verdict
        if fstate == "red" or (fstate == "yellow" and state == "green"):
            state = fstate

    hbm = data.get("hbm")
    if isinstance(hbm, dict) and hbm:
        # journal samples store the flat accounts() dict; /status nests
        # it under LEDGER.snapshot()["accounts"]
        if isinstance(hbm.get("accounts"), dict):
            hbm = hbm["accounts"]
        rows = {
            name: row
            for name, row in hbm.items()
            if isinstance(row, dict) and "bytes" in row
        }
        if rows:
            lines.append(f"  {'hbm account':<14} {'alloc':>14} {'high water':>14}")
            for name, row in rows.items():
                lines.append(
                    f"  {name:<14} {int(row.get('bytes', 0)):>14,} "
                    f"{int(row.get('high_water_bytes', row.get('bytes', 0))):>14,}"
                )
    return "\n".join(lines), state
