"""Persistence of the PyTorch port held against the JAX package's.

The single-process cases of ``tests/test_persistence.py``, each run on both
packages with the same inputs: restarts on a filesystem, a mock and the
Python log format, operator snapshots (taken, skipped, rejected when the
program changed), record mode, the delivered marker, and the logs
themselves: both packages' writers frame one record sequence into
byte-identical files, and each package reads the other's.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import native as jnative
from pathway_tpu.engine import dataflow as jdf
from pathway_tpu.engine import persistence as jpersist
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu.io import _connector as jconn
from pathway_tpu_torch import native as tnative
from pathway_tpu_torch.engine import dataflow as tdf
from pathway_tpu_torch.engine import persistence as tpersist
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.io import _connector as tconn

PKGS = {
    "ref": SimpleNamespace(pw=jpw, persist=jpersist, Runner=JRunner, native=jnative, df=jdf, conn=jconn),
    "port": SimpleNamespace(pw=tpw, persist=tpersist, Runner=TRunner, native=tnative, df=tdf, conn=tconn),
}


@pytest.fixture(autouse=True)
def _oneshot_fs(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    # start from empty graphs: pw.run runs every sink an earlier test file in
    # this process left in a package's global graph
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def both(fn, tmp_path, **kw):
    """Run ``fn(pkg, folder)`` on the reference and the port, each in a
    folder of its own; the two results must be equal. Returns the port's."""
    out = {}
    for name, pkg in PKGS.items():
        folder = tmp_path / name
        folder.mkdir()
        out[name] = fn(pkg, folder, **kw)
        pkg.pw.clear_graph()
    assert out["port"] == out["ref"]
    return out["port"]


def _write_jsonl(path, words):
    with open(path, "w") as f:
        for w in words:
            f.write(json.dumps({"word": w}) + "\n")


def _schema(pw):
    class WordSchema(pw.Schema):
        word: str

    return WordSchema


def _wordcount_run(pkg, in_dir, backend) -> list:
    pw = pkg.pw
    events: list = []
    words = pw.io.jsonlines.read(str(in_dir), schema=_schema(pw), mode="streaming", persistent_id="words")
    counts = words.groupby(pw.this.word).reduce(word=pw.this.word, count=pw.reducers.count())
    pw.io.subscribe(counts, on_change=lambda key, row, time, is_addition: events.append(
        (row["word"], row["count"], is_addition)))
    pw.run(persistence_config=pw.persistence.Config.simple_config(backend))
    pw.clear_graph()
    return sorted(events)


def test_wordcount_recovery_filesystem(tmp_path):
    def scenario(pkg, d):
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["cat", "dog", "cat"])
        backend = pkg.pw.persistence.Backend.filesystem(str(d / "pstorage"))
        ev1 = _wordcount_run(pkg, in_dir, backend)
        ev2 = _wordcount_run(pkg, in_dir, backend)  # unchanged input: the sinks stay quiet
        _write_jsonl(in_dir / "b.jsonl", ["cat", "emu"])
        ev3 = _wordcount_run(pkg, in_dir, backend)
        return ev1, ev2, ev3

    ev1, ev2, ev3 = both(scenario, tmp_path)
    assert ("cat", 2, True) in ev1 and ("dog", 1, True) in ev1
    assert ev2 == []
    assert ("emu", 1, True) in ev3 and ("cat", 2, False) in ev3 and ("cat", 3, True) in ev3
    assert not any(w == "dog" for w, _c, _a in ev3)


def test_recovered_state_visible_to_capture(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["x", "y"])
        backend = pw.persistence.Backend.filesystem(str(d / "pstorage"))
        _wordcount_run(pkg, in_dir, backend)
        words = pw.io.jsonlines.read(str(in_dir), schema=_schema(pw), mode="streaming", persistent_id="words")
        counts = words.groupby(pw.this.word).reduce(word=pw.this.word, count=pw.reducers.count())
        runner = pkg.Runner()
        runner.engine.persistence_config = pw.persistence.Config.simple_config(backend)
        cap, names = runner.capture(counts)
        runner.run()
        return {row[names.index("word")]: row[names.index("count")] for row in cap.state.values()}

    assert both(scenario, tmp_path) == {"x": 1, "y": 1}


def test_file_modification_after_restart(tmp_path):
    def scenario(pkg, d):
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["a", "b"])
        backend = pkg.pw.persistence.Backend.filesystem(str(d / "pstorage"))
        _wordcount_run(pkg, in_dir, backend)
        _write_jsonl(in_dir / "a.jsonl", ["a", "c"])
        os.utime(in_dir / "a.jsonl", (1e9, 1e9))  # a distinct mtime
        return _wordcount_run(pkg, in_dir, backend)

    ev2 = both(scenario, tmp_path)
    assert ("c", 1, True) in ev2 and ("b", 1, False) in ev2


def _range_subject(pw, stop):
    class RangeSubject(pw.io.python.ConnectorSubject):
        supports_offsets = True

        def run(self):
            for i in range(int(self.offsets.get("next", 0)), stop):
                self.next_with_offset("next", i + 1, word=f"w{i}")
            self.commit()

    return RangeSubject()


def test_mock_backend_python_connector_resume(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.mock({}))

        def run_once(stop):
            t = pw.io.python.read(_range_subject(pw, stop), schema=_schema(pw), autocommit_duration_ms=None,
                                  persistent_id="rng")
            runner = pkg.Runner()
            runner.engine.persistence_config = cfg
            sink: list = []
            runner.subscribe(t, on_change=lambda key, row, time, diff: sink.append(row["word"]))
            cap, _names = runner.capture(t)
            runner.run()
            pw.clear_graph()
            return sorted(sink), len(cap.state)

        return run_once(5), run_once(8)

    (s1, n1), (s2, n2) = both(scenario, tmp_path)
    assert s1 == [f"w{i}" for i in range(5)] and n1 == 5
    assert s2 == ["w5", "w6", "w7"] and n2 == 8


def test_operator_snapshot_skips_replay(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["cat", "dog", "cat"])
        backend = pw.persistence.Backend.filesystem(str(d / "pstorage"))
        ev1 = _wordcount_run(pkg, in_dir, backend)
        assert os.path.exists(d / "pstorage" / "streams" / "__operators__.bin")
        words = pw.io.jsonlines.read(str(in_dir), schema=_schema(pw), mode="streaming", persistent_id="words")
        counts = words.groupby(pw.this.word).reduce(word=pw.this.word, count=pw.reducers.count())
        ev2: list = []
        runner = pkg.Runner()
        runner.engine.persistence_config = pw.persistence.Config.simple_config(backend)
        runner.subscribe(counts, on_change=lambda key, row, time, diff: ev2.append(row["word"]))
        runner.run()
        gb = next(n for n in runner.engine.nodes if n.name == "GroupBy")
        return ev1, ev2, gb.stats.rows_in, runner.engine._opsnap_time >= 0, len(gb.groups)

    ev1, ev2, rows_in, restored, groups = both(scenario, tmp_path)
    assert ("cat", 2, True) in ev1 and ev2 == [] and rows_in == 0 and restored and groups == 2


def test_operator_snapshot_with_new_data_replays_only_tail(tmp_path):
    def scenario(pkg, d):
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["cat", "dog"])
        backend = pkg.pw.persistence.Backend.filesystem(str(d / "pstorage"))
        _wordcount_run(pkg, in_dir, backend)
        _write_jsonl(in_dir / "b.jsonl", ["cat"])
        ev2 = _wordcount_run(pkg, in_dir, backend)
        ev3 = _wordcount_run(pkg, in_dir, backend)
        return ev2, ev3

    ev2, ev3 = both(scenario, tmp_path)
    assert ("cat", 1, False) in ev2 and ("cat", 2, True) in ev2 and not any(w == "dog" for w, _c, _a in ev2)
    assert ev3 == []


def test_operator_snapshot_ignored_when_graph_changes(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["x", "y"])
        backend = pw.persistence.Backend.filesystem(str(d / "pstorage"))
        _wordcount_run(pkg, in_dir, backend)
        words = pw.io.jsonlines.read(str(in_dir), schema=_schema(pw), mode="streaming", persistent_id="words")
        runner = pkg.Runner()
        runner.engine.persistence_config = pw.persistence.Config.simple_config(backend)
        cap, _names = runner.capture(words)
        runner.run()
        return sorted(row for row in cap.state.values())

    assert both(scenario, tmp_path) == [("x",), ("y",)]


def test_snapshot_restore_with_static_source(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["cat"])
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(d / "pstorage")))

        def run_once():
            schema = _schema(pw)
            static = pw.debug.table_from_rows(schema, [("static_word",)])
            stream = pw.io.jsonlines.read(str(in_dir), schema=schema, mode="streaming", persistent_id="words")
            counts = stream.concat_reindex(static).groupby(pw.this.word).reduce(
                word=pw.this.word, count=pw.reducers.count())
            runner = pkg.Runner()
            runner.engine.persistence_config = cfg
            cap, names = runner.capture(counts)
            runner.run()
            pw.clear_graph()
            return {row[names.index("word")]: row[names.index("count")] for row in cap.state.values()}

        return run_once(), run_once()

    first, again = both(scenario, tmp_path)
    assert first == again == {"cat": 1, "static_word": 1}


def test_snapshot_ignored_when_reducer_changes(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["cat", "dog"])
        backend = pw.persistence.Backend.filesystem(str(d / "pstorage"))
        _wordcount_run(pkg, in_dir, backend)
        words = pw.io.jsonlines.read(str(in_dir), schema=_schema(pw), mode="streaming", persistent_id="words")
        sums = words.groupby(pw.this.word).reduce(word=pw.this.word, total=pw.reducers.sum(pw.apply(len, pw.this.word)))
        runner = pkg.Runner()
        runner.engine.persistence_config = pw.persistence.Config.simple_config(backend)
        cap, names = runner.capture(sums)
        runner.run()
        got = {row[names.index("word")]: row[names.index("total")] for row in cap.state.values()}
        return got, runner.engine._opsnap_time

    got, opsnap = both(scenario, tmp_path)
    assert got == {"cat": 3, "dog": 3} and opsnap == -1


def test_snapshot_disabled_with_non_persistent_source(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["cat"])
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(d / "pstorage")))

        class Once(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(word="dog")  # not persistent: re-emits every run
                self.commit()

        def run_once():
            schema = _schema(pw)
            stream = pw.io.jsonlines.read(str(in_dir), schema=schema, mode="streaming", persistent_id="words")
            other = pw.io.python.read(Once(), schema=schema, autocommit_duration_ms=None)
            counts = stream.concat_reindex(other).groupby(pw.this.word).reduce(
                word=pw.this.word, count=pw.reducers.count())
            runner = pkg.Runner()
            runner.engine.persistence_config = cfg
            cap, names = runner.capture(counts)
            runner.run()
            pw.clear_graph()
            return {row[names.index("word")]: row[names.index("count")] for row in cap.state.values()}

        return run_once(), run_once()

    first, again = both(scenario, tmp_path)
    assert first == again == {"cat": 1, "dog": 1}


def test_ops_log_stays_bounded(tmp_path):
    def scenario(pkg, d):
        cfg = pkg.pw.persistence.Config.simple_config(pkg.pw.persistence.Backend.filesystem(str(d / "p")))
        p = pkg.persist.EnginePersistence(cfg)
        blob = b"x" * 10_000
        for i in range(20):
            p.save_operator_snapshot(i, blob)
        p.close()
        size = os.path.getsize(p._source_path(pkg.persist.EnginePersistence.OPS_SOURCE))
        p2 = pkg.persist.EnginePersistence(cfg)
        rec = p2.recover_operator_snapshot(100)
        p2.close()
        return size < 3 * len(blob), rec

    bounded, rec = both(scenario, tmp_path)
    assert bounded and rec == (19, b"x" * 10_000)


RECORDS = [(1, 7, 42, b"hello"), (2, 8, 0, b"world"), (5, 9, (1 << 64) - 1, b""), (3, 10, 3, bytes(range(256)))]


def _write(writer_cls, path, records=RECORDS):
    w = writer_cls(path, append=True)
    for rec in records:
        w.append(*rec)
    w.flush()
    w.close()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["native", "python"])
def test_log_writers_frame_byte_identical_files(tmp_path, fmt):
    """Both packages' writers (the native CRC log, and the Python format)
    frame one record sequence into byte-identical files, and each
    package's readers read the other's file back."""
    files = {}
    for name, pkg in PKGS.items():
        cls = pkg.native.SnapshotLogWriter if fmt == "native" else pkg.persist.PyLogWriter
        files[name] = _write(cls, str(tmp_path / f"{name}.bin"))
    assert files["port"] == files["ref"] and len(files["port"]) > 0
    for name, pkg in PKGS.items():
        other = "ref" if name == "port" else "port"
        reader = pkg.persist.sniff_log_reader(str(tmp_path / f"{other}.bin"))
        assert list(reader) == RECORDS
        reader.close()
    if fmt == "native":
        r = tnative.SnapshotLogReader(str(tmp_path / "ref.bin"))
        assert list(r) == RECORDS
        r.close()


def test_py_log_roundtrip_and_torn_tail(tmp_path):
    def scenario(pkg, d):
        path = str(d / "log.bin")
        _write(pkg.persist.PyLogWriter, path, RECORDS[:2])
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        r = pkg.persist.PyLogReader(path)
        recs = list(r)
        r.close()
        return recs

    assert both(scenario, tmp_path) == [RECORDS[0]]


def test_native_log_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "n.bin")
    _write(tnative.SnapshotLogWriter, path, RECORDS[:2])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    r = tnative.SnapshotLogReader(path)
    got = list(r)
    r.close()
    assert got == [RECORDS[0]]
    w = tnative.SnapshotLogWriter(str(tmp_path / "o.bin"), append=False)
    w.append_obj(4, 1, 2, {"a": [1, 2]})
    w.close()
    assert list(tnative.SnapshotLogReader(str(tmp_path / "o.bin")).iter_objects()) == [(4, 1, 2, {"a": [1, 2]})]


def test_orphaned_data_compacted_on_recovery(tmp_path):
    def scenario(pkg, d):
        cfg = pkg.pw.persistence.Config.simple_config(pkg.pw.persistence.Backend.filesystem(str(d / "p")))
        p = pkg.persist.EnginePersistence(cfg)
        p.log_batch("s", 0, [(1, ("dog",), 1)])
        p.advance("s", 0, {"next": 1})
        p.log_batch("s", 1, [(2, ("cat",), 1)])  # crash: no ADVANCE
        p.close()
        p2 = pkg.persist.EnginePersistence(cfg)
        first = p2.recover_source("s")
        p2.log_batch("s", 1, [(2, ("cat",), 1)])  # re-ingest after recovery
        p2.advance("s", 1, {"next": 2})
        p2.close()
        p3 = pkg.persist.EnginePersistence(cfg)
        third = p3.recover_source("s")
        p3.close()
        return first, third

    (b1, o1, f1), (b3, _o3, f3) = both(scenario, tmp_path)
    assert f1 == 0 and o1 == {"next": 1} and b1 == [(0, [(1, ("dog",), 1)])]
    assert f3 == 1 and b3 == [(0, [(1, ("dog",), 1)]), (1, [(2, ("cat",), 1)])]


def test_format_flip_native_to_python(tmp_path, monkeypatch):
    def scenario(pkg, d):
        cfg = pkg.pw.persistence.Config.simple_config(pkg.pw.persistence.Backend.filesystem(str(d / "p")))
        p = pkg.persist.EnginePersistence(cfg)
        p.log_batch("s", 0, [(1, ("dog",), 1)])
        p.advance("s", 0, {})
        p.close()
        monkeypatch.setenv("PATHWAY_PERSISTENCE_FORCE_PY", "1")
        p2 = pkg.persist.EnginePersistence(cfg)
        second = p2.recover_source("s")
        p2.log_batch("s", 1, [(2, ("cat",), 1)])
        p2.advance("s", 1, {})
        p2.close()
        monkeypatch.delenv("PATHWAY_PERSISTENCE_FORCE_PY")
        p3 = pkg.persist.EnginePersistence(cfg)
        third = p3.recover_source("s")
        p3.close()
        return second, third

    (b2, _o2, f2), (b3, _o3, f3) = both(scenario, tmp_path)
    assert f2 == 0 and b2 == [(0, [(1, ("dog",), 1)])] and f3 == 1 and len(b3) == 2


def test_mock_backend_shared_store_and_isolated_sources(tmp_path):
    def scenario(pkg, d):
        store: list = []
        mk = lambda: pkg.persist.EnginePersistence(  # noqa: E731
            pkg.pw.persistence.Config.simple_config(pkg.pw.persistence.Backend.mock(store)))
        p = mk()
        p.log_batch("a", 0, [(1, ("from_a",), 1)])
        p.advance("a", 0, {"oa": 1})
        p.log_batch("b", 0, [(2, ("from_b",), 1)])
        p.advance("b", 0, {"ob": 2})
        p.close()
        p2 = mk()  # a fresh Backend.mock over the same store
        out = p2.recover_source("a"), p2.recover_source("b")
        p2.close()
        return bool(store), out

    landed, (a, b) = both(scenario, tmp_path)
    assert landed
    assert a == ([(0, [(1, ("from_a",), 1)])], {"oa": 1}, 0) and b == ([(0, [(2, ("from_b",), 1)])], {"ob": 2}, 0)


def test_row_and_offset_commit_atomically(tmp_path):
    def scenario(pkg, d):
        g = pkg.df.EngineGraph()
        node = pkg.df.SessionSourceNode(g)
        node.session.insert(1, ("a",), offsets={"next": 1})
        node.session.commit()
        node.session.drain()
        return node.last_offsets

    assert both(scenario, tmp_path) == {"next": 1}


def test_record_mode_resets_offset_unaware_source(tmp_path):
    def scenario(pkg, d):
        pw = pkg.pw

        def reader(ctx):
            for w in ("x", "y"):
                ctx.insert({"word": w})
            ctx.commit()
            ctx.close()

        def run_once():
            t = pkg.conn.input_table_from_reader(_schema(pw), reader, autocommit_duration_ms=None,
                                                 supports_offsets=False)
            runner = pkg.Runner()
            cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(d / "rec")),
                                                      persistence_mode="record")
            cfg.auto_persistent_ids = True
            runner.engine.persistence_config = cfg
            cap, _names = runner.capture(t)
            runner.run()
            pw.clear_graph()
            return sorted(cap.state.values())

        return run_once(), run_once()

    first, again = both(scenario, tmp_path)
    assert first == again == [("x",), ("y",)]


def test_py_writer_heals_torn_tail_via_compaction(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_PERSISTENCE_FORCE_PY", "1")

    def scenario(pkg, d):
        cfg = pkg.pw.persistence.Config.simple_config(pkg.pw.persistence.Backend.filesystem(str(d / "p")))
        p = pkg.persist.EnginePersistence(cfg)
        p.log_batch("s", 0, [(1, ("good",), 1)])
        p.advance("s", 0, {})
        p.close()
        path = p._source_path("s")
        with open(path, "r+b") as f:  # torn mid-record
            f.truncate(os.path.getsize(path) - 3)
        p2 = pkg.persist.EnginePersistence(cfg)
        p2.recover_source("s")
        p2.log_batch("s", 1, [(2, ("post-crash",), 1)])
        p2.advance("s", 1, {})
        p2.close()
        p3 = pkg.persist.EnginePersistence(cfg)
        batches, _o, f3 = p3.recover_source("s")
        p3.close()
        return f3, [row[0] for _t, ups in batches for _k, row, _d in ups]

    f3, rows = both(scenario, tmp_path)
    assert f3 == 1 and "post-crash" in rows


def test_python_fallback_forced(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_PERSISTENCE_FORCE_PY", "1")

    def scenario(pkg, d):
        in_dir = d / "in"
        in_dir.mkdir()
        _write_jsonl(in_dir / "a.jsonl", ["p", "q"])
        backend = pkg.pw.persistence.Backend.filesystem(str(d / "pstorage"))
        return _wordcount_run(pkg, in_dir, backend), _wordcount_run(pkg, in_dir, backend)

    ev1, ev2 = both(scenario, tmp_path)
    assert {w for w, _c, _a in ev1} == {"p", "q"} and ev2 == []


@pytest.mark.parametrize("delivered,frontier,offsets,times", [(5, 5, {"cursor": 20}, [3, 5]),
                                                             (3, 3, {"cursor": 10}, [3])])
def test_delivered_marker_finalizes_or_trims_fed_epoch(tmp_path, monkeypatch, delivered, frontier, offsets, times):
    """A worker fed epoch 5 (KIND_FEED offsets) and crashed before its
    ADVANCE: with the delivered marker at 5 recovery finalizes the epoch,
    with it at 3 the epoch is trimmed and the reader re-reads it."""

    def scenario(pkg, d):
        cfg = pkg.pw.persistence.Config.simple_config(pkg.pw.persistence.Backend.filesystem(str(d / "p")))
        monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
        wp = pkg.persist.EnginePersistence(cfg)
        wp.log_batch("src", 3, [(1, ("seen",), 1)])
        wp.advance("src", 3, {"cursor": 10})
        wp.log_batch("src", 5, [(2, ("window",), 1)], offsets={"cursor": 20})
        wp.close()
        monkeypatch.setenv("PATHWAY_PROCESS_ID", "0")
        p0 = pkg.persist.EnginePersistence(cfg)
        p0.mark_delivered(delivered)
        p0.close()
        monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
        wp2 = pkg.persist.EnginePersistence(cfg)
        marker = wp2.delivered_frontier()
        batches, offs, f = wp2.recover_source("src", delivered_frontier=marker)
        wp2.close()
        monkeypatch.delenv("PATHWAY_PROCESS_ID")
        return marker, f, offs, [t for t, _ in batches]

    assert both(scenario, tmp_path) == (delivered, frontier, offsets, times)
