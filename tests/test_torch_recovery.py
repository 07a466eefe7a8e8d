"""Crash recovery of the PyTorch port, held against the JAX package.

The single-process cases of ``tests/test_recovery_crash.py`` on the port:
a streaming wordcount SIGKILLed mid-stream in a child process and restarted
(filesystem and a disk-backed fake S3 client; one worker and four), the
sink exactly-once across both runs; record and speedrun replay (one worker
and four) giving the live run's output; the S3 log storage and backend on
the reference's in-memory fake client, and input compaction, each against
the reference on the same inputs. Then the live index: a
``DataIndex(BruteForceKnn(embedder=...))`` restarted from its operator
snapshot (re-embedded and re-added through ``_index_add``, flat and
tiered) answers as the reference's restarted run and the port's
uninterrupted one do, at ``test_torch_engine_index.py``'s tolerance.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import persistence as jpersist
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu.models import sentence_encoder as jse
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch.engine import persistence as tpersist
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5  # test_torch_engine_index.py's


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


# --------------------------------------------- SIGKILLed wordcount children

DISK_S3 = textwrap.dedent(
    """
    import io, os

    class DiskS3:
        def __init__(self, root):
            self.root = root

        def _p(self, key):
            return os.path.join(self.root, key.replace("/", "%2F"))

        def put_object(self, Bucket, Key, Body):
            os.makedirs(self.root, exist_ok=True)
            tmp = self._p(Key) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(Body if isinstance(Body, bytes) else Body.read())
            os.replace(tmp, self._p(Key))

        def get_object(self, Bucket, Key):
            with open(self._p(Key), "rb") as f:
                return {"Body": io.BytesIO(f.read())}

        def list_objects_v2(self, Bucket, Prefix, **kw):
            out = []
            if os.path.isdir(self.root):
                for name in sorted(os.listdir(self.root)):
                    key = name.replace("%2F", "/")
                    if not name.endswith(".tmp") and key.startswith(Prefix):
                        out.append({"Key": key})
            return {"Contents": out, "IsTruncated": False}

        def delete_object(self, Bucket, Key):
            try:
                os.remove(self._p(Key))
            except FileNotFoundError:
                pass
    """
)

PROGRAM = textwrap.dedent(
    """
    import os, threading, time
    import pathway_tpu_torch as pw

    {fake_s3}

    class S(pw.Schema):
        word: str

    if os.environ["WC_BACKEND"] == "filesystem":
        backend = pw.persistence.Backend.filesystem(os.environ["WC_PSTORE"])
    else:
        backend = pw.persistence.Backend.s3("s3://bucket/pstore", _client=DiskS3(os.environ["WC_PSTORE"]))
    t = pw.io.jsonlines.read(os.environ["WC_IN"], schema=S, mode="streaming", autocommit_duration_ms=100,
                             persistent_id="words")
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, os.environ["WC_OUT"])

    def watchdog():
        while not os.path.exists(os.environ["WC_STOP"]):
            time.sleep(0.1)
        os._exit(0)

    threading.Thread(target=watchdog, daemon=True).start()
    pw.run(monitoring_level="none", persistence_config=pw.persistence.Config.simple_config(backend))
    """
)


def _strict_apply(paths: list[str]) -> dict:
    """Replay sink events; raise on any exactly-once violation."""
    state: dict[str, int] = {}
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                w, n, diff = rec["word"], rec["n"], rec["diff"]
                if diff > 0:
                    assert state.get(w) != n, f"duplicate insert {rec}"
                    state[w] = n
                else:
                    assert state.get(w) == n, f"retract mismatch {rec} vs {state.get(w)}"
                    del state[w]
    return state


def _write_words(d, fname, words):
    with open(os.path.join(d, fname), "w") as f:
        for w in words:
            f.write(json.dumps({"word": w}) + "\n")


def _start(tmp, tag: str, backend: str, extra_env: dict | None = None):
    prog = tmp / "wc.py"
    prog.write_text(PROGRAM.format(fake_s3=DISK_S3 if backend == "s3" else ""))
    env = dict(os.environ)
    env.update(WC_IN=str(tmp / "in"), WC_OUT=str(tmp / f"out.{tag}.jsonl"), WC_PSTORE=str(tmp / "pstore"),
               WC_STOP=str(tmp / f"stop.{tag}"), WC_BACKEND=backend,
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("PATHWAY_TPU_FS_ONESHOT", None)
    env.update(extra_env or {})
    proc = subprocess.Popen([sys.executable, str(prog)], env=env, cwd=str(tmp), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, str(tmp / f"out.{tag}.jsonl"), str(tmp / f"stop.{tag}")


def _wait_for_events(path: str, minimum: int, timeout: float = 30.0) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if os.path.exists(path):
            with open(path) as f:
                if sum(1 for _ in f) >= minimum:
                    return
        time.sleep(0.1)
    raise TimeoutError(f"no {minimum} events in {path}")


def _finish(proc, stop: str, outs: list, want: dict) -> None:
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and _strict_apply(outs) != want:
            time.sleep(0.2)
        open(stop, "w").close()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("backend,threads", [("filesystem", 1), ("s3", 1), ("filesystem", 4)],
                         ids=["filesystem", "s3", "filesystem_four_workers"])
def test_crash_recovery_wordcount(tmp_path, backend, threads):
    """SIGKILL mid-stream; the restarted child resumes from the input log and
    the sink is exactly-once across both runs (one worker, or four: the
    threaded cluster restores its sharded state)."""
    env = {"PATHWAY_THREADS": str(threads)}
    (tmp_path / "in").mkdir()
    words1 = ["cat", "dog", "cat"] if threads == 1 else ["cat", "dog", "cat", "emu", "fox", "dog", "cat", "ant"] * 5
    _write_words(tmp_path / "in", "a.jsonl", words1)
    p1, out1, _stop1 = _start(tmp_path, "run1", backend, env)
    try:
        _wait_for_events(out1, 2)
        os.kill(p1.pid, signal.SIGKILL)  # a hard crash, mid-stream
        p1.wait(timeout=30)
    finally:
        if p1.poll() is None:
            p1.kill()
    words2 = ["dog", "emu"] if threads == 1 else ["dog", "emu", "gnu", "cat"] * 3
    _write_words(tmp_path / "in", "b.jsonl", words2)
    want: dict[str, int] = {}
    for w in words1 + words2:
        want[w] = want.get(w, 0) + 1
    p2, out2, stop2 = _start(tmp_path, "run2", backend, env)
    _wait_for_events(out2, 1)
    _finish(p2, stop2, [out1, out2], want)
    assert _strict_apply([out1, out2]) == want


@pytest.mark.parametrize("threads", [1, 4])
def test_record_then_speedrun_replay_matches_live(tmp_path, monkeypatch, threads):
    """``PATHWAY_REPLAY_STORAGE`` / ``PATHWAY_REPLAY_MODE`` (the CLI's
    ``spawn --record`` / ``--replay-mode``): a recorded live run on four
    workers, replayed at speed on one or four, gives the live run's output,
    as the reference's record and replay do."""
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    words = ["red", "blue", "red", "green", "blue", "red"] * 4
    (tmp_path / "in").mkdir()
    _write_words(tmp_path / "in", "a.jsonl", words)

    def run(pw, tag, mode, n):
        monkeypatch.setenv("PATHWAY_THREADS", str(n))
        monkeypatch.setenv("PATHWAY_REPLAY_STORAGE", str(tmp_path / f"rec_{pw.__name__}"))
        monkeypatch.setenv("PATHWAY_REPLAY_MODE", mode)

        class S(pw.Schema):
            word: str

        t = pw.io.jsonlines.read(str(tmp_path / "in"), schema=S, mode="streaming", persistent_id="words")
        c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
        out = str(tmp_path / f"{tag}_{pw.__name__}.jsonl")
        pw.io.jsonlines.write(c, out)
        pw.run(monitoring_level="none")
        pw.clear_graph()
        return _strict_apply([out])

    want = {"red": 12, "blue": 8, "green": 4}
    for pw in (jpw, tpw):
        assert run(pw, "live", "record", 4) == want
        assert run(pw, "replay", "speedrun", threads) == want, pw.__name__


# ------------------------------------------- S3 storage on the fake client


class MemS3:
    def __init__(self):
        self.objects: dict[str, bytes] = {}

    def put_object(self, Bucket, Key, Body):
        self.objects[Key] = Body if isinstance(Body, bytes) else Body.read()

    def get_object(self, Bucket, Key):
        return {"Body": io.BytesIO(self.objects[Key])}

    def list_objects_v2(self, Bucket, Prefix, **kw):
        return {"Contents": [{"Key": k} for k in sorted(self.objects) if k.startswith(Prefix)], "IsTruncated": False}

    def delete_object(self, Bucket, Key):
        self.objects.pop(Key, None)


def test_s3_log_storage_roundtrip_and_generations():
    out = []
    for persist in (jpersist, tpersist):
        s3 = MemS3()
        st = persist.S3LogStorage(s3, "bucket", "root")
        w = st.writer("src")
        w.append(1, 7, 42, b"hello")
        w.flush()
        w.append(2, 8, 0, b"world")
        w.close()
        first = st.read_records("src")
        st.replace_records("src", [(1, 9, 1, b"only")])  # compaction flips the generation
        out.append((first, st.read_records("src"), st.generation("src"), sorted(s3.objects),
                    {k: v for k, v in s3.objects.items()}))
    assert out[1] == out[0]
    first, after, gen, keys, _objs = out[1]
    assert first == [(1, 7, 42, b"hello"), (2, 8, 0, b"world")] and after == [(1, 9, 1, b"only")] and gen == 1
    assert not [k for k in keys if "/g000000/" in k], "old generation objects must be deleted"


def test_s3_backend_engine_persistence_resume():
    out = []
    for pw, persist in ((jpw, jpersist), (tpw, tpersist)):
        s3 = MemS3()

        def make_p():
            return persist.EnginePersistence(pw.persistence.Config.simple_config(
                pw.persistence.Backend.s3("s3://bucket/pstore", _client=s3)))

        p1 = make_p()
        p1.log_batch("s", 0, [(1, ("a",), 1)])
        p1.advance("s", 0, {"pos": 1})
        p1.log_batch("s", 2, [(2, ("b",), 1)])
        p1.advance("s", 2, {"pos": 2})
        p1.log_batch("s", 4, [(3, ("orphan",), 1)])  # never finalized
        p1.close()
        out.append((make_p().recover_source("s"), make_p().recover_source("s")))
    assert out[1] == out[0]
    (batches, offsets, frontier), (b3, _o3, f3) = out[1]
    assert frontier == 2 and offsets == {"pos": 2} and batches == [(0, [(1, ("a",), 1)]), (2, [(2, ("b",), 1)])]
    assert f3 == 2 and len(b3) == 2


def test_compact_inputs_on_snapshot_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _write_words(in_dir, "a.jsonl", ["cat", "dog", "cat"])
    for pw, persist, runner_cls in ((jpw, jpersist, JRunner), (tpw, tpersist, TRunner)):
        backend = pw.persistence.Backend.filesystem(str(tmp_path / f"ps_{pw.__name__}"))

        def run(changed: bool):
            class S(pw.Schema):
                word: str

            t = pw.io.jsonlines.read(str(in_dir), schema=S, mode="streaming", persistent_id="words")
            if changed:
                t = t.select(word=pw.this.word + "!")
            c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
            runner = runner_cls()
            runner.engine.persistence_config = pw.persistence.Config.simple_config(
                backend, compact_inputs_on_snapshot=True)
            cap, _names = runner.capture(c)
            try:
                runner.run()
            finally:
                pw.clear_graph()
            return {row[0]: row[1] for row in cap.state.values()}

        assert run(False) == {"cat": 2, "dog": 1}
        p = persist.EnginePersistence(pw.persistence.Config.simple_config(backend))
        p.recover_source("words")
        assert p.compacted_to["words"] >= 0  # the log was trimmed below the end-of-run snapshot
        p.close()
        assert run(False) == {"cat": 2, "dog": 1}  # the same program restarts from the snapshot
        with pytest.raises(Exception, match="snapshot-compacted"):
            run(True)  # a changed program cannot replay a trimmed log


def test_compact_source_below_trims_and_guards(tmp_path):
    out = []
    for pw, persist in ((jpw, jpersist), (tpw, tpersist)):
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__)))
        p1 = persist.EnginePersistence(cfg)
        p1.log_batch("s", 0, [(1, ("a",), 1)])
        p1.advance("s", 0, {})
        p1.log_batch("s", 2, [(2, ("b",), 1)])
        p1.advance("s", 2, {"pos": 9})
        p1.compact_source_below("s", 0)  # a snapshot at 0 covers epoch 0
        p1.close()
        p2 = persist.EnginePersistence(cfg)
        out.append((p2.recover_source("s"), p2.compacted_to["s"]))
        p2.close()
    assert out[1] == out[0] == (([(2, [(2, ("b",), 1)])], {"pos": 9}, 2), 0)


# ------------------------------------------------------- the live index

F32 = dict(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=64)
WORDS = ["river", "stone", "cloud", "light", "apple", "night", "field", "glass", "ocean", "ember", "frost", "maple"]


@pytest.fixture(scope="module")
def encoders():
    """One float32 encoder per package over the same weights."""
    jenc = jse.SentenceEncoder(config=JCfg(**F32, dtype=jnp.float32), checkpoint_dir="/nonexistent",
                               max_seq_len=32, max_batch=64)
    jenc.tokenizer = JTok(vocab_size=F32["vocab_size"])
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jenc.params))
    tenc = tse.SentenceEncoder(config=TCfg(**F32, dtype=torch.float32), max_seq_len=32, max_batch=64, device="cpu",
                               params=from_jax_params(tree))
    tenc.tokenizer = TTok(vocab_size=F32["vocab_size"])
    return jenc, tenc


@pytest.fixture
def embedders(monkeypatch, encoders):
    jenc, tenc = encoders
    monkeypatch.setattr(jse, "SentenceEncoder", lambda *a, **k: jenc)
    monkeypatch.setattr(tse, "SentenceEncoder", lambda *a, **k: tenc)
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmb
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmb

    return {jpw: JEmb(), tpw: TEmb(device="cpu")}


def _texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1))) for _ in range(n)]


def _index_run(pw, embedder, root, docs, queries, *, upto: int, ask: bool, tiers=None):
    """Documents ``[..upto)`` (resuming at the source's offset, 8 an epoch),
    then, with ``ask``, the queries once every document was delivered ->
    ({query: [(doc_id, score)]}, the engine)."""
    delivered = threading.Event()
    seen = {"rows": 0}

    class Docs(pw.io.python.ConnectorSubject):
        supports_offsets = True

        def run(self):
            start = int(self.offsets.get("next", 0))
            seen["rows"] = start
            for i in range(start, upto):
                self.next_with_offset("next", i + 1, doc_id=i, text=docs[i])
                if i % 8 == 7:
                    self.commit()
            self.commit()
            if seen["rows"] >= upto:
                delivered.set()

    class Queries(pw.io.python.ConnectorSubject):
        supports_offsets = True

        def run(self):
            if not ask:
                return
            delivered.wait(30)
            for j, q in enumerate(queries):
                self.next_with_offset("next", j + 1, q=q)
            self.commit()

    class DocSchema(pw.Schema):
        doc_id: int
        text: str

    def on_doc(key, row, time, is_addition):
        seen["rows"] += 1
        if seen["rows"] >= upto:
            delivered.set()

    table = pw.io.python.read(Docs(), schema=DocSchema, autocommit_duration_ms=None, persistent_id="docs")
    qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(q=str), autocommit_duration_ms=None,
                           persistent_id="queries")
    kw = {"device": "cpu"} if pw is tpw else {}
    knn = pw.indexing.BruteForceKnn(table.text, dimensions=F32["hidden_size"], reserved_space=64, embedder=embedder,
                                    tiers=tiers, **kw)
    replies = pw.indexing.DataIndex(table, knn).query_as_of_now(qt.q, number_of_matches=4)
    out = replies.select(q=qt.q, ids=pw.this.doc_id, scores=pw.this._pw_index_reply_score)
    runner = (JRunner if pw is jpw else TRunner)()
    runner.engine.persistence_config = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(root))
    runner.subscribe(table, on_change=on_doc)
    cap, names = runner.capture(out)
    runner.run()
    pw.clear_graph()
    iq, ii, isc = (names.index(c) for c in ("q", "ids", "scores"))
    hits = {row[iq]: list(zip([int(i) for i in row[ii]], [float(s) for s in row[isc]])) for row in cap.state.values()}
    return hits, runner.engine


def _hits_equal(got, want):
    assert sorted(got) == sorted(want)
    for q in want:
        g, w = got[q], want[q]
        assert len(g) == len(w) == 4, (q, g, w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=SCORE_TOL, atol=SCORE_TOL)
        for (gi, gs), (wi, ws) in zip(g, w):
            assert gi == wi or any(abs(s - gs) <= SCORE_TOL and i == gi for i, s in w), (q, g, w)


TIERS = {"hot_rows": 8, "n_clusters": 4, "n_probe": 4, "cold_dtype": "f32"}


@pytest.mark.parametrize("tiers", [None, TIERS], ids=["flat", "tiered"])
def test_index_restored_from_its_snapshot_answers_as_the_reference(tmp_path, embedders, tiers):
    """A first run ingests 16 documents and ends with an operator snapshot;
    the restart restores the index node from it (re-embedding its 16 rows
    through the encoder and re-adding them, a tiered index's clusters and
    hot set first), takes 8 more documents and answers the queries: the
    answers equal the reference's restarted run's and the port's
    uninterrupted run's."""
    rng = np.random.default_rng(5)
    docs = _texts(rng, 24, 3, 10)
    queries = _texts(rng, 4, 2, 6) + [docs[3], docs[20]]
    got = {}
    for pw in (jpw, tpw):
        root = str(tmp_path / f"root_{pw.__name__}")
        _index_run(pw, embedders[pw], root, docs, queries, upto=16, ask=False, tiers=tiers)
        hits, engine = _index_run(pw, embedders[pw], root, docs, queries, upto=24, ask=True, tiers=tiers)
        assert engine._opsnap_time >= 0, f"{pw.__name__} did not restore from the snapshot"
        got[pw] = hits, engine
    _hits_equal(got[tpw][0], got[jpw][0])
    straight, _engine = _index_run(tpw, embedders[tpw], str(tmp_path / "straight"), docs, queries, upto=24, ask=True,
                                   tiers=tiers)
    _hits_equal(got[tpw][0], straight)
    for text, doc_id in ((docs[3], 3), (docs[20], 20)):
        assert got[tpw][0][text][0][0] == doc_id
