"""The port's C++ host helpers (``pathway_tpu_torch/native.py`` over
``csrc/host/pathway_native.cc``): the batched WordPiece tokenizer gives
the Python ``encode``'s ids, native consolidation gives the Python path's
multiset, the library builds into the gitignored ``build/`` directory, a
failed build raises, and ``PATHWAY_DISABLE_NATIVE`` takes the Python
paths."""

from __future__ import annotations

import collections
import os
import subprocess

import numpy as np
import pytest

from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch import native
from pathway_tpu_torch.engine import dataflow
from pathway_tpu_torch.engine.value import Json, Pointer
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "Hello, World! 123",
    "the quick brown fox jumps over the lazy dog",
    "",
    "naïve café — ok",  # non-ASCII: detours through the Python encode
    "x" * 300,
    "a-b_c.d,e;f:g!h?i",
    "Straße und Ärger",
    "tab\tand\nnewline   spaces",
    "UPPER lower MiXeD 42x 7",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown", "fox", "##es", "hello",
            "world", "ok", "caf", "##e", "a", "b", "c", "##x", "42", "up", "##per", "low", "##er"]
    path.write_text("\n".join(toks) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("mode", ["hashed", "vocab"])
@pytest.mark.parametrize("max_len", [8, 64])
def test_batch_encode_matrix_equals_python_encode(mode, max_len, vocab_file):
    tok = TTok(vocab_size=2048) if mode == "hashed" else TTok(vocab_file=vocab_file)
    ref = JTok(vocab_size=2048) if mode == "hashed" else JTok(vocab_file=vocab_file)
    ids, lens = tok.batch_encode_matrix(TEXTS, max_len)
    assert tok._native is not None, "ASCII rows go through the native tokenizer"
    assert ids.shape == (len(TEXTS), max_len) and ids.dtype == np.int32 and lens.dtype == np.int32
    for i, text in enumerate(TEXTS):
        want = tok.encode(text, max_len)
        assert want == ref.encode(text, max_len)
        assert ids[i, : lens[i]].tolist() == want, text
        assert (ids[i, lens[i]:] == tok.pad_id).all()


@pytest.mark.parametrize("texts", [TEXTS[:3], [TEXTS[3], TEXTS[6]], []], ids=["ascii", "non_ascii", "empty"])
def test_batch_encode_matrix_all_ascii_or_none(texts):
    tok = TTok(vocab_size=2048)
    ids, lens = tok.batch_encode_matrix(texts, 16)
    assert ids.shape == (len(texts), 16)
    for i, text in enumerate(texts):
        assert ids[i, : lens[i]].tolist() == tok.encode(text, 16)


def test_disable_native_takes_the_python_path(monkeypatch):
    monkeypatch.setenv("PATHWAY_DISABLE_NATIVE", "1")
    assert native.library() is None and not native.is_available()
    tok = TTok(vocab_size=2048)
    ids, lens = tok.batch_encode_matrix(TEXTS, 32)
    assert tok._native is None
    for i, text in enumerate(TEXTS):
        assert ids[i, : lens[i]].tolist() == tok.encode(text, 32)
    assert native.consolidate_native([(1, (1,), 1)] * 70) is None


def _updates(rng, n):
    rows = [(1, "a"), (2.5, None), ("x", (1, 2)), (Pointer(7), True), (b"zz", -4), (3, "a"), (3.0, "a")]
    out = []
    for _ in range(n):
        key = int(rng.integers(0, 6))
        out.append((key, rows[int(rng.integers(0, len(rows)))], int(rng.choice([-1, 1, 2]))))
    return out


def _python_path(updates, monkeypatch):
    """The engine's ``consolidate`` with native off: its Python grouping
    (``rows_equal``, so 3 and 3.0 are one value)."""
    with monkeypatch.context() as m:
        m.setenv("PATHWAY_DISABLE_NATIVE", "1")
        return dataflow.consolidate(updates)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_consolidation_equals_python(seed, monkeypatch):
    updates = _updates(np.random.default_rng(seed), 300)
    out = native.consolidate_native(updates)
    assert out is not None and all(d in (1, -1) for *_, d in out)
    want = _python_path(updates, monkeypatch)
    assert collections.Counter(out) == collections.Counter(want)
    assert sorted(map(repr, out)) == sorted(map(repr, want))  # the same representative rows
    # the engine's entry point takes the native path at this size
    assert collections.Counter(dataflow.consolidate(updates)) == collections.Counter(want)


@pytest.mark.parametrize("row", [(Json({"k": [1, 2]}),), (object(),)], ids=["json", "object"])
def test_consolidation_declines_rows_it_cannot_serialize(row, monkeypatch):
    """Rows without an exact byte form go back to the Python path, which
    the engine's ``consolidate`` then takes."""
    updates = [(1, row, 1), (1, row, -1), (2, row, 1)] * 30
    assert native.consolidate_native(updates) is None
    assert dataflow.consolidate(updates) == [(2, row, 1)] * 30 == _python_path(updates, monkeypatch)


def test_library_builds_into_the_gitignored_build_directory():
    assert native.library() is not None
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.path.commonpath([path, os.path.join(REPO, "build")]) == os.path.join(REPO, "build")
    ignored = subprocess.run(["git", "check-ignore", "-q", path], cwd=REPO)
    assert ignored.returncode == 0, f"{path} is not gitignored"
    assert native.library().pn_version()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n", encoding="utf-8")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library()
