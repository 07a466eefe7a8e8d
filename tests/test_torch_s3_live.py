"""A live index over an S3 prefix across a restart, the port against the JAX package, on the CPU.

A miniature of ``chip_smoke.py``'s ``s3_path`` on both packages: the
script's ``boto3`` stand-in (an in-process bucket in ``sys.modules``, pages
of 100 keys here) holds 512 objects under ``s3://docs/corpus/`` ->
``pw.io.s3.read(format="plaintext_by_file", with_metadata=True,
mode="streaming", persistent_id=, object_cache=)`` through the connector's
own ``AwsS3Settings.create_client()`` branch, under a filesystem
persistence backend -> a ``SentenceTransformerEmbedder`` ->
``pw.ml.KNNIndex`` <- queries from ``pw.io.python.read`` (one single query
after each phase, then a burst of 8 in one epoch). Phases: the snapshot
scan; 64 objects rewritten, 32 deleted and 32 added between two scans; the
run stopped, 16 objects added and 16 rewritten while it is down, and the run
restarted on the same persistence directory and object cache. The
embedders run float32 encoders at a tiny width (vocab 2048, two layers, d
32) with the reference's weights carried across by
``weights.from_jax_params``. The live objects, the hits (ids exact, scores
within 1e-5) and the GETs are equal; in each package every phase fetches
exactly the objects it changed, no answer names an object deleted before
its query, and every rewritten object comes first for its new text. The
reference's reader scans for ever, so the stand-in refuses listings once a
run is stopped, which ends it.
"""

from __future__ import annotations

import importlib
import os
import queue
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.models import sentence_encoder as jse
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import S3StandIn  # noqa: E402

TINY = dict(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=64)
WORDS = [f"w{i}" for i in range(300)] + ["river", "stone", "cloud", "light", "apple"]
N_OBJECTS, N_REWRITES, N_DELETES, N_ADDS, N_DOWN_ADDS, N_DOWN_REWRITES, N_BURST, K = 512, 64, 32, 32, 16, 16, 8, 4
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


@pytest.fixture
def embedders(monkeypatch):
    """A SentenceTransformerEmbedder per package over the same float32
    encoder weights (each package's SentenceEncoder swapped for the tiny
    one while its embedder is built)."""
    jenc = jse.SentenceEncoder(config=JCfg(**TINY, dtype=jnp.float32), checkpoint_dir="/nonexistent",
                               max_seq_len=32, max_batch=64)
    jenc.tokenizer = JTok(vocab_size=TINY["vocab_size"])
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, meta.unbox(jenc.params)))
    tenc = tse.SentenceEncoder(config=TCfg(**TINY, dtype=torch.float32), max_seq_len=32, max_batch=64, device="cpu",
                               params=params)
    tenc.tokenizer = TTok(vocab_size=TINY["vocab_size"])
    monkeypatch.setattr(jse, "SentenceEncoder", lambda *a, **k: jenc)
    monkeypatch.setattr(tse, "SentenceEncoder", lambda *a, **k: tenc)
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmb
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmb

    return {jpw: JEmb(), tpw: TEmb(device="cpu")}


def _corpus():
    """The bucket's three states, the single queries and the burst."""
    rng = np.random.default_rng(20)
    text = lambda: " ".join(rng.choice(WORDS, rng.integers(4, 13)))  # noqa: E731
    name = lambda i: f"corpus/doc-{i:04d}.txt"  # noqa: E731
    start = {name(i): text() for i in range(N_OBJECTS)}
    order = rng.permutation(N_OBJECTS)
    rewritten_b = [name(i) for i in order[:N_REWRITES]]
    deleted_b = [name(i) for i in order[N_REWRITES : N_REWRITES + N_DELETES]]
    change_b = {key: text() for key in rewritten_b + [name(N_OBJECTS + j) for j in range(N_ADDS)]}
    after_b = {key: t for key, t in {**start, **change_b}.items() if key not in deleted_b}
    live_b = sorted(after_b)
    rewritten_c = [live_b[i] for i in rng.choice(len(live_b), N_DOWN_REWRITES, replace=False)]
    change_c = {key: text() for key in rewritten_c + [name(N_OBJECTS + N_ADDS + j) for j in range(N_DOWN_ADDS)]}
    final = {**after_b, **change_c}
    rewritten = sorted(set(rewritten_b) | set(rewritten_c))
    singles = [start[name(0)], change_b[rewritten_b[0]], start[deleted_b[0]], change_c[rewritten_c[0]]]
    burst = [final[key] for key in rewritten[: N_BURST // 2]] + [final[key] for key in sorted(final)[: N_BURST // 2]]
    return dict(start=start, change_b=change_b, deleted_b=deleted_b, after_b=after_b, change_c=change_c, final=final,
                rewritten=rewritten, singles=singles, burst=burst)


def _s3_run(pw, embedder, monkeypatch, c, root, **knn_kw) -> dict:
    """The pipeline over the stand-in, phase by phase -> what the runs made."""
    stand_in = S3StandIn(page_size=100)
    for name, mod in stand_in.modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    stand_in.apply("docs", {key: t.encode() for key, t in c["start"].items()})
    settings = pw.io.s3.AwsS3Settings(bucket_name="docs", endpoint="http://127.0.0.1:9000", with_path_style=True)
    persistence = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(os.path.join(root, "p")))

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    cv = threading.Condition()
    state = {"count": {}, "path_of": {}, "texts": {}, "answers": {}}

    def on_doc(key, row, time, is_addition):
        with cv:
            state["count"][key] = state["count"].get(key, 0) + (1 if is_addition else -1)
            if is_addition:
                state["path_of"][key] = row["path"]
                state["texts"][row["path"]] = row["data"]
            cv.notify_all()

    def on_answer(key, row, time, is_addition):
        with cv:
            state["answers"][row["qid"]] = ([str(p) for p in row["ids"]], [float(d) for d in row["dists"]])
            cv.notify_all()

    def live() -> dict:
        return {state["path_of"][key]: state["texts"][state["path_of"][key]]
                for key, n in state["count"].items() if n > 0}

    runner_cls = importlib.import_module(f"{pw.__name__}.internals.graph_runner").GraphRunner
    runners, real_init = [], runner_cls.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    monkeypatch.setattr(runner_cls, "__init__", recording_init)
    errors: list = []
    qids = iter(range(1000))
    asked_after: dict = {}
    gone: set = set()

    def start_run():
        asks = queue.Queue()

        class Queries(pw.io.python.ConnectorSubject):
            def run(self):
                while (batch := asks.get()) is not None:
                    for qid, text in batch:
                        self.next(qid=qid, text=text)
                    self.commit()

        docs = pw.io.s3.read("s3://docs/corpus/", aws_s3_settings=settings, format="plaintext_by_file",
                             with_metadata=True, mode="streaming", persistent_id="s3-docs-corpus",
                             object_cache=os.path.join(root, "cache"), poll_interval_s=0.05,
                             autocommit_duration_ms=None)
        queries = pw.io.python.read(Queries(), schema=QuerySchema, autocommit_duration_ms=None)
        d_emb = docs.select(path=pw.this._metadata["path"].as_str(), data=pw.this.data, emb=embedder(pw.this.data))
        q_emb = queries.select(qid=pw.this.qid, emb=embedder(pw.this.text))
        index = pw.ml.KNNIndex(d_emb.emb, d_emb, n_dimensions=TINY["hidden_size"], reserved_space=N_OBJECTS + 64,
                               distance_type="cosine", **knn_kw)
        answers = index.get_nearest_items_asof_now(q_emb.emb, k=K, with_distances=True).select(
            qid=q_emb.qid, ids=pw.this.path, dists=pw.this.dist)
        pw.io.subscribe(d_emb, on_doc)
        pw.io.subscribe(answers, on_answer)

        def run():
            try:
                pw.run(monitoring_level="none", persistence_config=persistence)
            except Exception as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)
                with cv:
                    cv.notify_all()

        th = threading.Thread(target=run, daemon=True)
        th.start()
        return asks, th

    def wait(cond):
        with cv:
            assert cv.wait_for(lambda: cond() or errors, timeout=120) and not errors, errors

    def ask(asks, texts):
        ids = [next(qids) for _ in texts]
        for i in ids:
            asked_after[i] = frozenset(gone)
        asks.put(list(zip(ids, texts)))
        wait(lambda: all(i in state["answers"] for i in ids))

    def stop(asks, th):
        asks.put(None)
        runners[-1].engine.stop()
        stand_in.shutdown()  # the reference's reader scans for ever: its next listing raises
        th.join(timeout=60)
        pw.clear_graph()
        assert not th.is_alive() and not errors, errors
        stand_in.resume()

    gets = []
    asks, th = start_run()
    wait(lambda: live() == c["start"])
    gets.append(stand_in.calls["get_object"])
    ask(asks, c["singles"][:1])
    stand_in.apply("docs", {key: t.encode() for key, t in c["change_b"].items()}, c["deleted_b"])
    gone.update(c["deleted_b"])
    wait(lambda: live() == c["after_b"])
    gets.append(stand_in.calls["get_object"] - sum(gets))
    ask(asks, c["singles"][1:3])
    stop(asks, th)
    stand_in.apply("docs", {key: t.encode() for key, t in c["change_c"].items()})
    before = dict(stand_in.gets)
    asks, th = start_run()
    wait(lambda: live() == c["final"])
    gets.append(stand_in.calls["get_object"] - sum(gets))
    restart_keys = sorted(k for k, n in stand_in.gets.items() if n != before.get(k, 0))
    ask(asks, c["singles"][3:])
    first_burst = len(state["answers"])
    ask(asks, c["burst"])
    stop(asks, th)
    stale = [(q, p) for q, (ids, _d) in state["answers"].items() for p in ids if p in asked_after[q]]
    return dict(live=live(), answers=state["answers"], gets=gets, restart_keys=restart_keys, stale=stale,
                first_burst=first_burst, clients=len(stand_in.clients))


def test_s3_prefix_into_a_live_index_across_a_restart_equals_reference(embedders, monkeypatch, tmp_path):
    c = _corpus()
    want = _s3_run(jpw, embedders[jpw], monkeypatch, c, str(tmp_path / "reference"))
    got = _s3_run(tpw, embedders[tpw], monkeypatch, c, str(tmp_path / "port"), device="cpu")
    for out in (want, got):
        assert out["live"] == c["final"] and not out["stale"] and out["clients"] == 2
        assert out["gets"] == [N_OBJECTS, N_REWRITES + N_ADDS, N_DOWN_ADDS + N_DOWN_REWRITES]
        assert out["restart_keys"] == sorted(c["change_c"])
        # each rewritten object comes first for its new text (the second and fourth singles, the burst's first half)
        assert c["change_b"][out["answers"][1][0][0]] == c["singles"][1]
        assert c["change_c"][out["answers"][3][0][0]] == c["singles"][3]
        for n, key in enumerate(c["rewritten"][: N_BURST // 2]):
            assert out["answers"][out["first_burst"] + n][0][0] == key
    assert sorted(got["answers"]) == sorted(want["answers"]) == list(range(4 + N_BURST))
    for q, (ids, dists) in want["answers"].items():
        g_ids, g_dists = got["answers"][q]
        assert g_ids == ids, (q, g_ids, ids)
        np.testing.assert_allclose(g_dists, dists, rtol=SCORE_TOL, atol=SCORE_TOL)
