"""A Debezium change stream into a live index, the port against the JAX package, on the CPU.

A miniature of ``chip_smoke.py``'s ``kafka_path`` on both packages: the
script's ``confluent_kafka`` stand-in (an in-process broker in
``sys.modules``; an idle poll returns after 50 ms here) carries topic
``pg.public.docs`` (4 partitions, keyed by document id) with 64 ``op: r``
snapshot rows, then 16 ``op: u`` updates, then 8 ``op: d`` deletes ->
``pw.io.debezium.read`` (the connector's confluent branch) -> a
``SentenceTransformerEmbedder`` -> ``pw.ml.KNNIndex`` <- queries from topic
``queries`` through ``pw.io.kafka.read`` (one single query after each
phase, then a burst of 8 in one epoch), answered as of now ->
``pw.io.kafka.write`` to topic ``answers``. The embedders run float32
encoders at a tiny width (vocab 2048, two layers, d 32) with the
reference's weights carried across by ``weights.from_jax_params``. The
final key sets are equal, the hits equal (ids exact, scores within 1e-5),
the records written to ``answers`` equal; and in each package no answer
names a key deleted in an earlier epoch and every updated row comes first
for its new text.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
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
from pathway_tpu.models import sentence_encoder as jse
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import KafkaStandIn, debezium_envelope  # noqa: E402

TINY = dict(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=64)
WORDS = [f"w{i}" for i in range(300)] + ["river", "stone", "cloud", "light", "apple"]
SETTINGS = {"bootstrap.servers": "localhost:9092", "group.id": "cdc", "auto.offset.reset": "earliest"}
N_SNAPSHOT, N_UPDATES, N_DELETES, N_BURST, K = 64, 16, 8, 8, 4
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


def _stream():
    """The topic's three phases, the single queries and the burst."""
    rng = np.random.default_rng(19)
    text = lambda: " ".join(rng.choice(WORDS, rng.integers(4, 13)))  # noqa: E731
    texts = [text() for _ in range(N_SNAPSHOT)]
    updated = rng.choice(N_SNAPSHOT, N_UPDATES, replace=False).tolist()
    new_texts = {i: text() for i in updated}
    deleted = rng.choice(N_SNAPSHOT, N_DELETES, replace=False).tolist()
    final = {i: new_texts.get(i, t) for i, t in enumerate(texts) if i not in deleted}
    lsn = iter(range(1 << 20))
    phases = [
        [debezium_envelope("r", i, None, {"doc_id": i, "text": t}, next(lsn)) for i, t in enumerate(texts)],
        [debezium_envelope("u", i, {"doc_id": i, "text": texts[i]}, {"doc_id": i, "text": new_texts[i]}, next(lsn))
         for i in updated],
        [debezium_envelope("d", i, {"doc_id": i, "text": new_texts.get(i, texts[i])}, None, next(lsn))
         for i in deleted],
    ]
    singles = [texts[0], new_texts[updated[0]], texts[deleted[0]]]
    live_updated = [i for i in updated if i in final]
    burst = [new_texts[i] for i in live_updated[: N_BURST // 2]] + [final[i] for i in sorted(final)[: N_BURST // 2]]
    return dict(phases=phases, singles=singles, burst=burst, final=final, updated=updated, new_texts=new_texts,
                deleted=deleted, live_updated=live_updated)


def _cdc_run(pw, embedder, monkeypatch, s, **knn_kw) -> dict:
    """The pipeline over the stand-in, phase by phase -> what the run made."""
    broker = KafkaStandIn()
    poll = broker.module.Consumer.poll
    monkeypatch.setattr(broker.module.Consumer, "poll", lambda self, timeout=None: poll(self, min(timeout, 0.05)))
    monkeypatch.setitem(sys.modules, "confluent_kafka", broker.module)
    broker.create_topic("pg.public.docs", 4)
    broker.create_topic("queries", 1)

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    docs = pw.io.debezium.read(SETTINGS, "pg.public.docs", schema=DocSchema, db_type="postgres",
                               persistent_id="pg-public-docs", autocommit_duration_ms=None)
    queries = pw.io.kafka.read(SETTINGS, "queries", schema=QuerySchema, format="json", autocommit_duration_ms=None)
    d_emb = docs.select(doc_id=pw.this.doc_id, text=pw.this.text, emb=embedder(pw.this.text))
    q_emb = queries.select(qid=pw.this.qid, emb=embedder(pw.this.text))
    index = pw.ml.KNNIndex(d_emb.emb, d_emb, n_dimensions=TINY["hidden_size"], reserved_space=N_SNAPSHOT,
                           distance_type="cosine", **knn_kw)
    answers = index.get_nearest_items_asof_now(q_emb.emb, k=K, with_distances=True).select(
        qid=q_emb.qid, ids=pw.this.doc_id, dists=pw.this.dist)
    pw.io.kafka.write(answers, SETTINGS, "answers", format="json")
    cv = threading.Condition()
    state = {"live": {}, "texts": {}, "removed_at": {}, "answers": {}}

    def on_doc(key, row, time, is_addition):
        with cv:
            if is_addition:
                state["live"][key] = row["doc_id"]
                state["texts"][row["doc_id"]] = row["text"]
            else:
                state["live"].pop(key, None)
                state["removed_at"][row["doc_id"]] = time
            cv.notify_all()

    def on_answer(key, row, time, is_addition):
        with cv:
            state["answers"][row["qid"]] = (time, [int(i) for i in row["ids"]], [float(d) for d in row["dists"]])
            cv.notify_all()

    pw.io.subscribe(d_emb, on_doc)
    pw.io.subscribe(answers, on_answer)
    runner_cls = importlib.import_module(f"{pw.__name__}.internals.graph_runner").GraphRunner
    runners, real_init = [], runner_cls.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    monkeypatch.setattr(runner_cls, "__init__", recording_init)
    errors: list = []

    def run():
        try:
            pw.run(monitoring_level="none")
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)
            with cv:
                cv.notify_all()

    def wait(cond):
        with cv:
            assert cv.wait_for(lambda: cond() or errors, timeout=120) and not errors, errors

    qids = iter(range(1000))

    def ask(texts):
        ids = [next(qids) for _ in texts]
        broker.produce_many("queries", [(None, json.dumps({"qid": i, "text": t}).encode()) for i, t in zip(ids, texts)])
        wait(lambda: all(i in state["answers"] for i in ids))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    arrived = [
        lambda: len(state["live"]) >= N_SNAPSHOT,
        lambda: all(state["texts"].get(i) == s["new_texts"][i] for i in s["updated"]),
        lambda: len(state["live"]) <= len(s["final"]),
    ]
    for records, done, single in zip(s["phases"], arrived, s["singles"]):
        broker.produce_many("pg.public.docs", records)
        wait(done)
        ask([single])
    first_burst = len(state["answers"])
    ask(s["burst"])
    runners[-1].engine.stop()
    broker.shutdown()
    th.join(timeout=60)
    pw.clear_graph()
    assert not th.is_alive() and not errors, errors
    written = sorted((r["qid"], [int(i) for i in r["ids"]], r["dists"], r["diff"])
                     for r in (json.loads(v) for _k, v, _ts in broker.records("answers")))
    return dict(state=state, written=written, first_burst=first_burst, subscriptions=broker.subscriptions,
                polls=broker.calls["poll"])


def test_debezium_stream_into_a_live_index_equals_reference(embedders, monkeypatch):
    s = _stream()
    want = _cdc_run(jpw, embedders[jpw], monkeypatch, s)
    got = _cdc_run(tpw, embedders[tpw], monkeypatch, s, device="cpu")
    for out in (want, got):
        st = out["state"]
        assert sorted(out["subscriptions"]) == [["pg.public.docs"], ["queries"]] and out["polls"] > 0
        assert sorted(st["live"].values()) == sorted(s["final"])
        # no answer names a key whose delete was committed in an earlier epoch
        removed = {i: st["removed_at"][i] for i in s["deleted"]}
        assert not [(q, i) for q, (t, ids, _d) in st["answers"].items() for i in ids if i in removed and removed[i] < t]
        # each updated row comes first for its new text (the second single and the burst's first half)
        assert st["answers"][1][1][0] == s["updated"][0]
        for n, i in enumerate(s["live_updated"][: N_BURST // 2]):
            assert st["answers"][out["first_burst"] + n][1][0] == i
        # every query written to ``answers`` once
        assert [w[0] for w in out["written"]] == sorted(st["answers"]) and all(w[3] == 1 for w in out["written"])
    assert set(got["state"]["live"].values()) == set(want["state"]["live"].values())
    assert sorted(got["state"]["answers"]) == sorted(want["state"]["answers"]) == list(range(3 + N_BURST))
    for q, (_t, ids, dists) in want["state"]["answers"].items():
        g_ids, g_dists = got["state"]["answers"][q][1:]
        assert g_ids == ids, (q, g_ids, ids)
        np.testing.assert_allclose(g_dists, dists, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert [(w[0], w[1], w[3]) for w in got["written"]] == [(w[0], w[1], w[3]) for w in want["written"]]
    np.testing.assert_allclose([d for w in got["written"] for d in w[2]], [d for w in want["written"] for d in w[2]],
                               rtol=SCORE_TOL, atol=SCORE_TOL)
