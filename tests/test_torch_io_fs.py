"""The port's file connectors against the JAX package's, on the CPU.

One seeded temporary folder is read by ``pathway_tpu.io.fs.read`` and
``pathway_tpu_torch.io.fs.read`` in the plaintext, binary, csv and json
formats, static and streaming (one scan, ``PATHWAY_TPU_FS_ONESHOT``):
the engines' update streams are equal (keys, rows, times, diffs),
ignoring the ``seen_at`` and ``modified_at`` metadata, which record when
each package read. The streaming scanner is also driven scan by scan
(files added, modified and deleted between scans) through a recording
context: the upserts, retractions, commits and offsets are equal. The
csv and jsonlines writers produce the same files.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.io import fs as jfs
from pathway_tpu_torch.io import fs as tfs

FORMATS = ["plaintext", "binary", "csv", "json"]
WORDS = ["river", "stone", "cloud", "light", "apple", "tpu", "graph", "epoch", "delta", "kappa"]
VOLATILE = ("seen_at", "modified_at")  # when each package looked at the file


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _content(rng, fmt: str, n_rows: int) -> bytes:
    rows = [(" ".join(rng.choice(WORDS, rng.integers(1, 5))), int(rng.integers(0, 100))) for _ in range(n_rows)]
    if fmt == "plaintext":
        return "".join(f"{w}\n" for w, _ in rows).encode()
    if fmt == "binary":
        return rng.integers(0, 256, 8 * n_rows, dtype=np.uint8).tobytes()
    if fmt == "csv":
        return ("word,n\n" + "".join(f"{w},{n}\n" for w, n in rows)).encode()
    return "".join(f'{{"word": "{w}", "n": {n}}}\n' for w, n in rows).encode()


def _folder(tmp_path, fmt: str, seed: int = 5, n_files: int = 4):
    rng = np.random.default_rng(seed)
    root = tmp_path / fmt
    (root / "sub").mkdir(parents=True)
    for i in range(n_files):
        where = root / "sub" if i % 2 else root
        (where / f"f{i}.dat").write_bytes(_content(rng, fmt, int(rng.integers(1, 4))))
    (root / "skip.tmp").write_bytes(_content(rng, fmt, 2))  # not matched by object_pattern
    return root, rng


def _schema(pw, fmt):
    if fmt in ("csv", "json"):
        return pw.schema_from_types(word=str, n=int)
    return None


def _norm(row: dict) -> dict:
    out = {}
    for name, v in row.items():
        if hasattr(v, "value") and isinstance(v.value, dict):
            v = {k: x for k, x in v.value.items() if k not in VOLATILE}
        out[name] = v
    return out


def _stream(pw, path, fmt, mode):
    table = pw.io.fs.read(str(path), format=fmt, schema=_schema(pw, fmt), mode=mode, with_metadata=True,
                          object_pattern="*.dat")
    events = []
    pw.io.subscribe(table, lambda key, row, time, is_addition: events.append(
        (int(key), _norm(row), time, is_addition)))
    pw.run()
    pw.clear_graph()
    return sorted(events, key=lambda e: (e[2], e[0], not e[3]))


@pytest.mark.parametrize("mode", ["static", "streaming"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_fs_read_update_streams_equal(tmp_path, monkeypatch, fmt, mode):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    root, _ = _folder(tmp_path, fmt)
    want = _stream(jpw, root, fmt, mode)
    got = _stream(tpw, root, fmt, mode)
    assert len(got) >= 4 and all(e[3] for e in got)
    assert got == want


class _RecordingContext:
    """What the streaming scanner sees of a connector: offsets kept across
    scans, keyed upserts (None = retraction) and commits, recorded."""

    def __init__(self):
        self.offsets: dict = {}
        self.log: list = []

    def set_offset(self, key, value):
        if value is None:
            self.offsets.pop(key, None)
        else:
            self.offsets[key] = tuple(value)

    def upsert_keyed(self, key_parts, values, offsets=None):
        self.log.append((key_parts, None if values is None else _norm(values)))

    def commit(self):
        self.log.append("commit")

    def wait_stopped(self, timeout=None):
        return True


def _scanner(fs_mod, monkeypatch, path, fmt, pw):
    monkeypatch.setattr(fs_mod, "input_table_from_reader", lambda schema, reader, **kw: reader)
    return fs_mod.read(str(path), format=fmt, schema=_schema(pw, fmt), mode="streaming", with_metadata=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_fs_streaming_scans_modify_and_delete_equal(tmp_path, monkeypatch, fmt):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    root, rng = _folder(tmp_path, fmt)
    readers = [_scanner(jfs, monkeypatch, root, fmt, jpw), _scanner(tfs, monkeypatch, root, fmt, tpw)]
    ctxs = [_RecordingContext(), _RecordingContext()]

    def scan():
        for reader, ctx in zip(readers, ctxs):
            reader(ctx)

    scan()  # every file new
    first = root / "f0.dat"
    first.write_bytes(_content(rng, fmt, 3))  # grows to 3 rows
    os.utime(first, (1_000_000, 1_000_000))  # a distinct mtime whatever the clock's resolution
    (root / "sub" / "f1.dat").write_bytes(_content(rng, fmt, 1))
    os.utime(root / "sub" / "f1.dat", (1_000_001, 1_000_001))
    (root / "new.dat").write_bytes(_content(rng, fmt, 2))
    scan()  # modified and added
    os.remove(root / "f2.dat")
    scan()  # deleted
    scan()  # unchanged: no commit
    assert ctxs[1].log.count("commit") == 3
    assert any(v is None for e in ctxs[1].log if e != "commit" for v in [e[1]])
    assert ctxs[1].log == ctxs[0].log
    assert ctxs[1].offsets == ctxs[0].offsets


@pytest.mark.parametrize("writer", ["csv", "jsonlines"])
def test_writers_produce_same_files(tmp_path, writer):
    root, _ = _folder(tmp_path, "json")
    outs = []
    for pw in (jpw, tpw):
        table = pw.io.jsonlines.read(str(root), schema=_schema(pw, "json"), mode="static")
        table = table.select(pw.this.word, n2=pw.this.n * 2)
        out = tmp_path / f"{pw.__name__}.{writer}"
        getattr(pw.io, writer).write(table, str(out))
        pw.run()
        pw.clear_graph()
        outs.append(out.read_text())
    assert outs[0].count("\n") >= 5 and outs[1] == outs[0]


def test_fs_read_errors_and_unported_options(tmp_path):
    for pw in (jpw, tpw):
        with pytest.raises(FileNotFoundError):
            pw.io.fs.read(str(tmp_path / "missing"), mode="static")
    # retry_policy= runs since persistence and recovery came over
    assert tpw.io.fs.read(str(tmp_path), retry_policy=tpw.RetryPolicy(max_retries=1)) is not None
    assert isinstance(tpw.io.CsvParserSettings(delimiter=";").reader_kwargs(), dict)
