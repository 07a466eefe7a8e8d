"""Black-box flight recorder: bounded ring of structured engine events.

The port's copy of the reference's ``internals/flight_recorder.py``. Every
process keeps an always-on ring buffer (a ``deque(maxlen=N)``) of
the engine's recent structured events — epoch begin/advance/delivered,
connector feed commits, retry attempts, chaos hits, pipeline
stage/stall transitions, device-ring donations, supervisor restarts.
Recording an event is an append of a small tuple under a lock; nothing
is formatted or flushed until a crash actually happens, so the hot path
costs well under a microsecond and the steady-state overhead is noise.

On a crash the ring is dumped to a timestamped JSON file:

- ``pw.run`` dumps when the run fails, the health watchdog once on its
  first critical breach, and a chaos kill or exit (``resilience/chaos.py``)
  before its signal (the injector runs in-process, so the evidence survives
  even SIGKILL);
- a :class:`~pathway_tpu_torch.resilience.RecoveryEscalated` dump is
  attached to the raised error as ``flight_recorder_dump``.

Dumps live in ``PATHWAY_FLIGHT_RECORDER_DIR`` (default
``<tmp>/pathway-blackbox``) and are read back with :func:`load_dump`,
:func:`render` and :func:`diff` (``python -m pathway_tpu_torch blackbox``).
Set ``PATHWAY_FLIGHT_RECORDER=0`` to disable recording entirely;
``PATHWAY_FLIGHT_RECORDER_SIZE`` resizes the ring (default 512 events).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

DUMP_FORMAT_VERSION = 1

# Event kinds that mark an epoch boundary; `pathway blackbox show`
# highlights the trailing ones so "what was the engine doing right
# before it died" is answerable at a glance.
EPOCH_KINDS = frozenset(
    {"epoch.begin", "epoch.advance", "epoch.delivered", "epoch.time_end"}
)


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false", "off", "no")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v else default
    except ValueError:
        return default


def default_dump_dir() -> str:
    d = os.environ.get("PATHWAY_FLIGHT_RECORDER_DIR")
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "pathway-blackbox")


class FlightRecorder:
    """Process-wide bounded event ring with crash dumping."""

    def __init__(self, size: int | None = None, enabled: bool | None = None):
        if size is None:
            size = max(16, _env_int("PATHWAY_FLIGHT_RECORDER_SIZE", 512))
        if enabled is None:
            enabled = _env_flag("PATHWAY_FLIGHT_RECORDER", True)
        self.enabled = enabled
        self._ring: deque[tuple[int, float, str, dict[str, Any]]] = deque(
            maxlen=size
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._dumped_paths: list[str] = []

    # -- hot path --

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event; near-zero cost, never raises."""
        if not self.enabled:
            return
        try:
            with self._lock:
                self._seq += 1
                self._ring.append((self._seq, time.time(), kind, fields))
        except Exception:
            pass  # observability must never take the engine down

    # -- inspection --

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            ring = list(self._ring)
        return [
            {"seq": seq, "time": t, "kind": kind, **fields}
            for seq, t, kind, fields in ring
        ]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- crash dumping --

    def dump(
        self,
        reason: str,
        error: BaseException | None = None,
        directory: str | None = None,
    ) -> str | None:
        """Write the ring to ``blackbox-<stamp>-p<pid>.json``; returns
        the path, or None when recording is disabled or the write fails
        (a dump failure must never mask the original crash)."""
        if not self.enabled:
            return None
        try:
            directory = directory or default_dump_dir()
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            pid = os.getpid()
            path = os.path.join(directory, f"blackbox-{stamp}-p{pid}.json")
            n = 1
            while os.path.exists(path):
                path = os.path.join(
                    directory, f"blackbox-{stamp}-p{pid}-{n}.json"
                )
                n += 1
            header: dict[str, Any] = {
                "version": DUMP_FORMAT_VERSION,
                "reason": reason,
                "pid": pid,
                "process_id": _env_int("PATHWAY_PROCESS_ID", 0),
                "created_at": time.time(),
            }
            if error is not None:
                header["error"] = {
                    "type": type(error).__name__,
                    "message": str(error),
                }
            header["events"] = self.events()
            # a crash mid-request must not lose the journey: spans
            # still open in the tracing plane ride along (this runs
            # in-process before chaos kill signals, so even SIGKILL
            # leaves the in-flight request attributable)
            try:
                from ..tracing import TRACE_STORE

                open_spans = TRACE_STORE.open_spans()
                if open_spans:
                    header["open_trace_spans"] = open_spans
            except Exception:
                pass
            # chip-time attribution at the moment of death: where the
            # device-seconds went rides along when the plane is active
            try:
                from .chip_ledger import CHIP_LEDGER

                if CHIP_LEDGER.active():
                    header["chip"] = CHIP_LEDGER.snapshot()
            except Exception:
                pass
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(header, f, indent=1, default=repr)
                f.write("\n")
            os.replace(tmp, path)
            self._dumped_paths.append(path)
            self._prune(directory)
            return path
        except Exception:
            return None

    @staticmethod
    def _prune(directory: str) -> None:
        """Retention (PATHWAY_FLIGHT_RECORDER_KEEP=N): after a dump,
        delete all but the N newest blackbox files in the directory.
        A chaos-heavy soak can otherwise write one dump per kill and
        fill the disk. 0 (default) keeps everything."""
        keep = max(0, _env_int("PATHWAY_FLIGHT_RECORDER_KEEP", 0))
        if not keep:
            return

        def _age(path: str) -> tuple[float, str]:
            # dumps in the same second get -1/-2 suffixes that sort
            # lexically BEFORE the unsuffixed name; mtime is the real
            # creation order
            try:
                return (os.path.getmtime(path), path)
            except OSError:
                return (0.0, path)

        for stale in sorted(list_dumps(directory), key=_age)[:-keep]:
            try:
                os.remove(stale)
            except OSError:
                pass  # racing processes pruning the same dir is fine


RECORDER = FlightRecorder()


def record(kind: str, **fields: Any) -> None:
    """Module-level fast path used by the engine seams."""
    RECORDER.record(kind, **fields)


def dump(reason: str, error: BaseException | None = None) -> str | None:
    return RECORDER.dump(reason, error)


# -- dump files: load / list / render / diff (pathway blackbox CLI) --


def load_dump(path: str) -> dict[str, Any]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "events" not in data:
        raise ValueError(f"{path}: not a flight-recorder dump")
    return data


def list_dumps(directory: str | None = None) -> list[str]:
    directory = directory or default_dump_dir()
    if not os.path.isdir(directory):
        return []
    out = [
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.startswith("blackbox-") and name.endswith(".json")
    ]
    return sorted(out)


def last_epoch(dump_data: dict[str, Any]) -> Any:
    """The newest epoch time named by any event in the dump."""
    latest = None
    for ev in dump_data.get("events", []):
        t = ev.get("t")
        if t is not None:
            latest = t
    return latest


def render(dump_data: dict[str, Any], tail_epochs: int = 3) -> str:
    """Human rendering of a dump: header, the last ``tail_epochs``
    epoch transitions, then the full event log."""
    lines = []
    err = dump_data.get("error")
    lines.append(
        f"flight recorder dump (v{dump_data.get('version', '?')}) — "
        f"reason={dump_data.get('reason', '?')} "
        f"process_id={dump_data.get('process_id', '?')} pid={dump_data.get('pid', '?')}"
    )
    created = dump_data.get("created_at")
    if created is not None:
        lines.append(
            "created: "
            + time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime(created))
        )
    if err:
        lines.append(f"error: {err.get('type')}: {err.get('message')}")
    events = dump_data.get("events", [])
    epoch_events = [e for e in events if e.get("kind") in EPOCH_KINDS]
    if epoch_events:
        lines.append("")
        lines.append(f"last {min(tail_epochs, len(epoch_events))} epoch transitions:")
        for ev in epoch_events[-tail_epochs:]:
            lines.append("  " + _format_event(ev))
    chip = dump_data.get("chip")
    if chip:
        lines.append("")
        lines.append(
            f"chip time at dump: {chip.get('busy_seconds', 0.0):.3f}s busy / "
            f"{chip.get('wall_seconds', 0.0):.3f}s wall "
            f"(accounted {chip.get('accounted_fraction', 0.0) * 100:.0f}%, "
            f"stranded {chip.get('stranded_fraction', 0.0) * 100:.0f}%)"
        )
        for account, row in (chip.get("accounts") or {}).items():
            lines.append(
                f"  {account:<14} {row.get('seconds', 0.0):8.3f}s "
                f"({row.get('share', 0.0) * 100:5.1f}%, "
                f"{row.get('dispatches', 0)} dispatches)"
            )
        causes = chip.get("stranded_causes") or {}
        cause_txt = ", ".join(f"{c}={s:.3f}s" for c, s in causes.items() if s)
        if cause_txt:
            lines.append(f"  stranded causes: {cause_txt}")
    journal_tail = dump_data.get("journal_tail") or []
    if journal_tail:
        lines.append("")
        lines.append(f"journal samples before dump ({len(journal_tail)}):")
        for rec in journal_tail:
            c = rec.get("chip") or {}
            stamp = time.strftime("%H:%M:%S", time.gmtime(rec.get("t", 0)))
            lines.append(
                f"  {stamp} busy={c.get('busy_seconds', 0.0):.3f}s "
                f"stranded={c.get('stranded_fraction', 0.0) * 100:.0f}% "
                f"accounts={len(c.get('accounts') or {})}"
            )
    lines.append("")
    lines.append(f"events ({len(events)} ringed):")
    for ev in events:
        lines.append("  " + _format_event(ev))
    open_spans = dump_data.get("open_trace_spans") or []
    if open_spans:
        lines.append("")
        lines.append(f"open request spans at dump ({len(open_spans)} in flight):")
        for sp in open_spans:
            lines.append(
                f"  trace={sp.get('trace', '?')} stage={sp.get('stage', '?')} "
                f"open for {sp.get('dur_ms', 0.0):.3f} ms [w{sp.get('worker', 0)}]"
            )
    traced = sorted(
        {str(ev["trace"]) for ev in events if ev.get("trace")}
        | {str(sp["trace"]) for sp in open_spans if sp.get("trace")}
    )
    if traced:
        lines.append("")
        lines.append(
            "traces referenced (cross-link with `pathway trace show <id>`):"
        )
        for tid in traced:
            lines.append(f"  {tid}")
    return "\n".join(lines)


def events_for_trace(trace_id: str, directory: str | None = None) -> list[dict]:
    """Flight-recorder events carrying ``trace=<id>`` across all dumps
    in a directory — ``pathway trace show`` folds these into the
    waterfall so a shed or chaos hit shows up on the request timeline."""
    out: list[dict] = []
    for path in list_dumps(directory):
        try:
            data = load_dump(path)
        except (OSError, ValueError):
            continue
        for ev in data.get("events", []):
            if str(ev.get("trace", "")) == trace_id:
                out.append(ev)
        for sp in data.get("open_trace_spans", []) or []:
            if str(sp.get("trace", "")) == trace_id:
                out.append(
                    {
                        "time": sp.get("start", 0.0),
                        "kind": "trace.open_span",
                        "stage": sp.get("stage"),
                        "dur_ms": sp.get("dur_ms"),
                        "trace": trace_id,
                    }
                )
    out.sort(key=lambda ev: ev.get("time", 0.0))
    return out


def _format_event(ev: dict[str, Any]) -> str:
    extras = " ".join(
        f"{k}={ev[k]}"
        for k in sorted(ev)
        if k not in ("seq", "time", "kind")
    )
    stamp = time.strftime("%H:%M:%S", time.gmtime(ev.get("time", 0)))
    return f"#{ev.get('seq', '?'):>5} {stamp} {ev.get('kind', '?'):<22} {extras}".rstrip()


def diff(a: dict[str, Any], b: dict[str, Any]) -> str:
    """Compare two dumps: per-kind event counts and last-epoch delta —
    quick triage for 'did both workers die at the same point?'."""

    def _counts(d: dict[str, Any]) -> dict[str, int]:
        out: dict[str, int] = {}
        for ev in d.get("events", []):
            k = ev.get("kind", "?")
            out[k] = out.get(k, 0) + 1
        return out

    ca, cb = _counts(a), _counts(b)
    lines = [
        f"A: reason={a.get('reason')} process_id={a.get('process_id')} "
        f"last_epoch={last_epoch(a)}",
        f"B: reason={b.get('reason')} process_id={b.get('process_id')} "
        f"last_epoch={last_epoch(b)}",
        "",
        f"{'kind':<24} {'A':>6} {'B':>6} {'Δ':>6}",
    ]
    for kind in sorted(set(ca) | set(cb)):
        na, nb = ca.get(kind, 0), cb.get(kind, 0)
        lines.append(f"{kind:<24} {na:>6} {nb:>6} {nb - na:>+6}")
    return "\n".join(lines)
