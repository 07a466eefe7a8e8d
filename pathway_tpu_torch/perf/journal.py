"""Append-only on-disk metrics journal (bounded segment ring).

Activated by ``PATHWAY_JOURNAL_DIR``: when set, runs and bench suites
append JSONL records under it; when unset every writer is a no-op (the
house rule: observability that was not asked for costs nothing and
changes nothing).

Layout: ``journal-000001.jsonl``, ``journal-000002.jsonl``, ... — the
writer rolls to a new segment once the open one passes
``PATHWAY_JOURNAL_SEGMENT_BYTES`` (default 1 MiB) and prunes the oldest
segments beyond ``PATHWAY_JOURNAL_SEGMENTS`` (default 8), so the
journal is a bounded ring regardless of run length. Appends are one
``json.dumps`` line + flush each, so a crash can tear at most the final
line; readers skip unparsable lines, which is the whole crash-recovery
story.

Record shape: ``{"t": <unix-seconds>, "kind": <str>, ...payload}``.
Kinds written by this repo: ``sample`` (periodic chip/HBM/serving/index
gauges, see :meth:`MetricsJournal.sample`) and ``bench`` (one record
per benchmark FINAL SUMMARY, consumed by ``perf snapshot``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

_SEG_PREFIX = "journal-"
_SEG_SUFFIX = ".jsonl"


def journal_dir() -> str | None:
    """The configured journal directory, or None when journaling is off."""
    d = os.environ.get("PATHWAY_JOURNAL_DIR", "").strip()
    return d or None


def journal_active() -> bool:
    return journal_dir() is not None


def _env_int(name: str, default: int, floor: int) -> int:
    try:
        v = int(os.environ.get(name, str(default)))
    except ValueError:
        return default
    return max(floor, v)


def segment_bytes() -> int:
    return _env_int("PATHWAY_JOURNAL_SEGMENT_BYTES", 1 << 20, 1 << 12)


def max_segments() -> int:
    return _env_int("PATHWAY_JOURNAL_SEGMENTS", 8, 2)


def sample_interval_s() -> float:
    try:
        v = float(os.environ.get("PATHWAY_JOURNAL_INTERVAL", "1.0"))
    except ValueError:
        return 1.0
    return max(0.05, v)


class MetricsJournal:
    """One journal directory: a lock-serialized segment-ring writer plus
    tolerant readers. Safe to share across threads; cheap to construct
    (the segment file opens lazily on first append)."""

    def __init__(
        self,
        directory: str,
        *,
        seg_bytes: int | None = None,
        segments: int | None = None,
    ) -> None:
        self.directory = directory
        self._seg_bytes = seg_bytes if seg_bytes is not None else segment_bytes()
        self._max_segments = segments if segments is not None else max_segments()
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0

    # -- segment ring --

    def segments(self) -> list[str]:
        """Existing segment paths, oldest first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        segs = [
            n
            for n in names
            if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)
        ]
        return [os.path.join(self.directory, n) for n in sorted(segs)]

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"{_SEG_PREFIX}{seq:06d}{_SEG_SUFFIX}")

    def _open_locked(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        segs = self.segments()
        if segs:
            last = os.path.basename(segs[-1])
            try:
                self._seq = int(last[len(_SEG_PREFIX) : -len(_SEG_SUFFIX)])
            except ValueError:
                self._seq = len(segs)
        else:
            self._seq = 1
        self._fh = open(self._seg_path(self._seq), "a", encoding="utf-8")

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._seq += 1
        self._fh = open(self._seg_path(self._seq), "a", encoding="utf-8")
        segs = self.segments()
        excess = len(segs) - self._max_segments
        for path in segs[: max(0, excess)]:
            try:
                os.remove(path)
            except OSError:
                pass

    # -- writing --

    def append(self, kind: str, payload: dict[str, Any]) -> dict:
        """Append one record (crash-safe: single line + flush) and
        return it. Rolls/prunes segments as needed."""
        rec = {"t": round(time.time(), 3), "kind": str(kind)}
        rec.update(payload)
        line = json.dumps(rec, sort_keys=True, default=str)
        with self._lock:
            if self._fh is None:
                self._open_locked()
            elif self._fh.tell() >= self._seg_bytes:
                self._rotate_locked()
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def sample(self) -> dict:
        """Compose one periodic sample from every activity-gated
        registry (chip ledger, HBM ledger, serving, index, tenancy) and
        append it. Registries that never woke contribute nothing."""
        payload: dict[str, Any] = {}
        try:
            from ..internals.chip_ledger import CHIP_LEDGER

            if CHIP_LEDGER.active():
                payload["chip"] = CHIP_LEDGER.snapshot()
        except Exception:
            pass
        try:
            from ..internals.ledger import LEDGER

            if LEDGER.active():
                payload["hbm"] = LEDGER.accounts()
        except Exception:
            pass
        try:
            from ..serving.metrics import SERVING_METRICS

            if SERVING_METRICS.active():
                payload["serving"] = SERVING_METRICS.snapshot()
        except Exception:
            pass
        try:
            from ..ops.index_metrics import INDEX_METRICS

            if INDEX_METRICS.active():
                payload["index"] = INDEX_METRICS.snapshot()
        except Exception:
            pass
        try:
            from ..tenancy.metrics import TENANCY_METRICS

            if TENANCY_METRICS.active():
                payload["tenancy"] = TENANCY_METRICS.snapshot()
        except Exception:
            pass
        try:
            from ..freshness.plane import FRESHNESS

            if FRESHNESS.active():
                payload["freshness"] = FRESHNESS.snapshot()
        except Exception:
            pass
        return self.append("sample", payload)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- reading --

    def read_all(self) -> list[dict]:
        """Every parsable record across the ring, oldest first. Torn or
        corrupt lines (crash mid-append) are skipped, not fatal."""
        out: list[dict] = []
        for path in self.segments():
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict):
                            out.append(rec)
            except OSError:
                continue
        return out

    def tail(self, n: int = 10, kind: str | None = None) -> list[dict]:
        recs = self.read_all()
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs[-max(0, int(n)) :]


_JOURNALS: dict[str, MetricsJournal] = {}
_JOURNALS_LOCK = threading.Lock()


def get_journal(directory: str | None = None) -> MetricsJournal | None:
    """The process-wide journal for ``directory`` (default: the
    ``PATHWAY_JOURNAL_DIR`` environment); None when journaling is off."""
    d = directory if directory is not None else journal_dir()
    if not d:
        return None
    d = os.path.abspath(d)
    with _JOURNALS_LOCK:
        j = _JOURNALS.get(d)
        if j is None:
            j = _JOURNALS[d] = MetricsJournal(d)
        return j


def append_record(kind: str, payload: dict[str, Any]) -> bool:
    """Convenience writer: no-op (False) when no journal is configured."""
    j = get_journal()
    if j is None:
        return False
    try:
        j.append(kind, payload)
        return True
    except Exception:
        return False


def tail_samples(n: int = 10, directory: str | None = None) -> list[dict]:
    """Last ``n`` periodic samples, for flight-recorder embedding and
    ``pathway top``. Empty when no journal exists."""
    j = get_journal(directory)
    if j is None:
        return []
    try:
        return j.tail(n, kind="sample")
    except Exception:
        return []


class JournalSampler:
    """Daemon thread taking a journal sample every ``interval_s`` while
    a run is live (started/stopped by ``pw.run`` when
    ``PATHWAY_JOURNAL_DIR`` is set)."""

    def __init__(self, journal: MetricsJournal, interval_s: float | None = None):
        self.journal = journal
        self.interval_s = (
            interval_s if interval_s is not None else sample_interval_s()
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="pathway-journal-sampler", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.journal.sample()
            except Exception:
                pass

    def stop(self) -> None:
        """Stop the loop and write one final sample (the run's parting
        state is usually the one a post-mortem wants)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            self.journal.sample()
        except Exception:
            pass
