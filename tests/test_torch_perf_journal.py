"""The port's ``perf/`` (metrics journal, snapshots, regression diff,
``top``) against the JAX package, on the CPU
(``tests/test_chip_ledger.py``'s and ``tests/test_freshness.py``'s journal,
perf and top cases): segment rotation and pruning, torn-line recovery,
the sampler, ``PATHWAY_JOURNAL_DIR``, snapshot assembly, the diff's gate
math and rendering, and ``render_top`` over journal samples and ``/status``
payloads, plus the journal a ``pw.run`` writes.

Tolerances: records (without their wall-clock stamps), snapshots, diff
rows and rendered text equal."""

from __future__ import annotations

import json
import time

import pytest

import pathway_tpu.internals.chip_ledger as jchip
import pathway_tpu.perf.journal as jj
import pathway_tpu.perf.snapshot as jsnap
import pathway_tpu.perf.top as jtop
import pathway_tpu_torch as tpw
import pathway_tpu_torch.internals.chip_ledger as tchip
import pathway_tpu_torch.perf.journal as tj
import pathway_tpu_torch.perf.snapshot as tsnap
import pathway_tpu_torch.perf.top as ttop

PKGS = [(jj, jsnap, jtop, jchip), (tj, tsnap, ttop, tchip)]
BOTH = pytest.mark.parametrize("journal,snapshot,top,chip", PKGS, ids=["jax", "torch"])


def _reset():
    # the chip snapshot's stranded causes read the serving queue and the
    # staging rings, which earlier tests in the process may have used
    import pathway_tpu.engine.device_ring as jring
    import pathway_tpu.serving as jsv
    import pathway_tpu_torch.engine.device_ring as tring
    import pathway_tpu_torch.serving as tsv

    for *_, chip in PKGS:
        chip.CHIP_LEDGER.reset()
    for sv in (jsv, tsv):
        sv.SERVING_METRICS.reset()
    for ring in jring.active_rings() + tring.active_rings():
        ring.stage_stall_s = 0.0


@pytest.fixture(autouse=True)
def _chip(monkeypatch):
    monkeypatch.setenv("PATHWAY_CHIP_LEDGER", "1")
    _reset()
    yield
    _reset()


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "t"} for r in recs]


def _rotation(journal, path):
    j = journal.MetricsJournal(str(path), seg_bytes=4096, segments=3)
    try:
        for i in range(400):
            j.append("sample", {"i": i, "pad": "x" * 64})
    finally:
        j.close()
    return [p.rsplit("/", 1)[-1] for p in j.segments()], _strip(j.read_all())


@BOTH
def test_journal_rotates_and_prunes_segments(journal, snapshot, top, chip, tmp_path):
    # (a record's length follows its wall-clock stamp, so where a segment
    # rolls over varies by a record between runs: no cross-run equality)
    segs, recs = _rotation(journal, tmp_path)
    assert 1 < len(segs) <= 3 and recs[-1]["i"] == 399 and recs[0]["i"] > 0
    assert [r["i"] for r in recs] == list(range(recs[0]["i"], 400))


@BOTH
def test_journal_crash_recovery_skips_torn_line(journal, snapshot, top, chip, tmp_path):
    j = journal.MetricsJournal(str(tmp_path))
    j.append("sample", {"i": 1})
    j.append("sample", {"i": 2})
    j.close()
    with open(j.segments()[-1], "a", encoding="utf-8") as fh:
        fh.write('{"t": 3, "kind": "sample", "i": 3')  # a torn last line
    assert [r["i"] for r in j.read_all()] == [1, 2] and j.tail(1)[-1]["i"] == 2


@BOTH
def test_journal_sampler_writes_samples(journal, snapshot, top, chip, tmp_path):
    chip.CHIP_LEDGER.book("encode", 0.01)
    j = journal.MetricsJournal(str(tmp_path))
    s = journal.JournalSampler(j, interval_s=0.05)
    s.start()
    deadline = time.monotonic() + 10.0  # at least one tick, however loaded the machine
    while not j.read_all() and time.monotonic() < deadline:
        time.sleep(0.05)
    s.stop()
    j.close()
    recs = [r for r in j.read_all() if r["kind"] == "sample"]
    assert len(recs) >= 2 and recs[-1]["chip"]["accounts"]["encode"]["seconds"] > 0


@BOTH
def test_journal_inactive_without_dir(journal, snapshot, top, chip, monkeypatch, tmp_path):
    monkeypatch.delenv("PATHWAY_JOURNAL_DIR", raising=False)
    assert journal.journal_active() is False and journal.append_record("bench", {"x": 1}) is False
    monkeypatch.setenv("PATHWAY_JOURNAL_DIR", str(tmp_path))
    assert journal.journal_active() and journal.append_record("bench", {"x": 1})
    assert journal.get_journal().tail(1, kind="bench")[0]["x"] == 1


def _snap(metrics):
    """A BENCH_r*-shaped snapshot from (metric, value, unit[, extra])."""
    lines = []
    for m in metrics:
        rec = {"metric": m[0], "value": m[1], "unit": m[2]}
        if len(m) > 3:
            rec.update(m[3])
        lines.append(json.dumps(rec))
    return {"n": 1, "cmd": "test", "rc": 0, "tail": "=== FINAL SUMMARY (one line per metric) ===\n" + "\n".join(lines),
            "parsed": {}}


_DIFFS = [
    ([("ingest_eps", 1000.0, "rows/s"), ("p50_ms", 10.0, "ms")], [("ingest_eps", 800.0, "rows/s"), ("p50_ms", 9.0, "ms")],
     0.10),
    ([("ingest_eps", 1000.0, "rows/s")], [("ingest_eps", 950.0, "rows/s")], 0.10),
    ([("chip_time_accounted_fraction", 0.99, "fraction", {"gate": 0.95})],
     [("chip_time_accounted_fraction", 0.93, "fraction", {"gate": 0.95})], 0.5),
    ([("ingest_eps", 1000.0, "rows/s"), ("old_only_ms", 5.0, "ms")],
     [("ingest_eps", 1000.0, "rows/s"), ("brand_new_qps", 50.0, "qps")], 0.10),
    ([("alpha_ms", 1.0, "ms")], [("beta_ms", 2.0, "ms")], 0.10),
    ([("freshness_p50_ms", 10.0, "ms"), ("freshness_coverage", 0.9, "")],
     [("freshness_p50_ms", 20.0, "ms"), ("freshness_coverage", 0.5, "")], 0.10),
]


@pytest.mark.parametrize("a,b,gate", _DIFFS, ids=["direction", "within-gate", "absolute-gate", "one-sided",
                                                   "disjoint", "freshness"])
def test_perf_diff_follows_the_reference(a, b, gate):
    got = tsnap.diff_snapshots(_snap(a), _snap(b), gate=gate)
    assert got == jsnap.diff_snapshots(_snap(a), _snap(b), gate=gate)
    assert tsnap.render_diff(got) == jsnap.render_diff(got)
    if a[0][0] == "ingest_eps" and len(a) == 2 and a[1][0] == "p50_ms":
        assert [r["metric"] for r in got["regressions"]] == ["ingest_eps"] and got["rc"] == 1


def _snapshot(journal, snapshot, path):
    j = journal.MetricsJournal(str(path))
    j.append("bench", {"suite": "smoke", "records": [{"metric": "ingest_eps", "value": 1234.5, "unit": "rows/s"}],
                       "headline": {"metric": "rag_p50_ms", "value": 42.0, "unit": "ms"}})
    j.close()
    return snapshot.build_snapshot(str(path))


def test_perf_snapshot_builds_from_journal(tmp_path):
    got = _snapshot(tj, tsnap, tmp_path / "t")
    assert got == _snapshot(jj, jsnap, tmp_path / "j")
    assert tsnap.SUMMARY_MARKER in got["tail"] and got["parsed"]["metric"] == "rag_p50_ms" and got["rc"] == 0
    assert [r["metric"] for r in tsnap.parse_summary_lines(got["tail"])] == ["ingest_eps", "rag_p50_ms"]
    with pytest.raises(ValueError):
        tsnap.build_snapshot(str(tmp_path / "empty"))


def test_top_renders_the_same_frames():
    assert ttop.render_top({}) == jtop.render_top({})
    for verdict in ({"stranded_fraction": 0.1}, {"stranded_fraction": 0.6}, {"stranded_fraction": 0.85}, None):
        assert ttop.verdict_state(verdict) == jtop.verdict_state(verdict)
    frames = []
    for chip, top in ((jchip, jtop), (tchip, ttop)):
        chip.CHIP_LEDGER.book("encode", 0.08, tenant="gold")
        chip.CHIP_LEDGER.book("index.search", 0.02)
        snap = chip.CHIP_LEDGER.snapshot(0.2)
        snap.pop("encode_mfu", None)
        flat = {"index.hot": {"bytes": 4096, "high_water_bytes": 8192}}
        frames.append([top.render_top({"chip": snap, "hbm": hbm}) for hbm in (flat, {"accounts": flat})])
    assert frames[1] == frames[0]
    text, state = frames[1][0]
    assert state == ttop.verdict_state(snap) and "gold" in text and "index.hot" in text and "4,096" in text


def test_run_writes_journal_samples_that_top_renders(tmp_path, monkeypatch):
    """A run with PATHWAY_JOURNAL_DIR set leaves samples (the final one at
    the run's end) that ``load_from_journal`` and ``render_top`` read."""
    monkeypatch.setenv("PATHWAY_JOURNAL_DIR", str(tmp_path))
    tpw.clear_graph()
    t = tpw.debug.table_from_markdown("""
      | a
    1 | 1
    """)
    tpw.io.subscribe(t, lambda **_: None)
    tchip.CHIP_LEDGER.book("encode", 0.01)
    tpw.run(chip_ledger=True)
    tpw.clear_graph()
    sample = ttop.load_from_journal(str(tmp_path))
    assert sample["kind"] == "sample" and sample["chip"]["accounts"]["encode"]["seconds"] > 0
    text, state = ttop.render_top(sample)
    assert state != "empty" and "encode" in text
