"""The port's copy of the reference's ``perf/``. Performance surfaces: the on-disk metrics journal, BENCH_r*-style
snapshots, per-plane regression diffs, and the ``pathway top`` renderer.

Everything here is host-side and import-light (no torch at module level):
the journal is written by live runs and benchmark harnesses
(``append_record``), and read back by ``python -m pathway_tpu_torch perf`` /
``top`` — possibly from a different
process, possibly after a crash.
"""

from .journal import (
    MetricsJournal,
    append_record,
    get_journal,
    journal_active,
    journal_dir,
    tail_samples,
)
from .snapshot import build_snapshot, diff_snapshots, parse_summary_lines
from .top import load_from_journal, load_status_from_url, render_top

__all__ = [
    "MetricsJournal",
    "append_record",
    "build_snapshot",
    "diff_snapshots",
    "get_journal",
    "journal_active",
    "journal_dir",
    "load_from_journal",
    "load_status_from_url",
    "parse_summary_lines",
    "render_top",
    "tail_samples",
]
