"""``FusedRagPipeline`` of the PyTorch port: the six cases of
``tests/test_fused_rag.py`` on the port, then parity with the JAX
pipeline on the same documents, queries and (bridged) weights: the same
hit keys, scores within tolerance, and equal ``answer_batch`` tokens from a
tiny decoder.

Tolerances: the parity cases run float32 encoders on both sides, so
retrieval and cross-encoder scores agree within 1e-4 and no two candidates
lie within rounding of each other; keys and tokens are then equal."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.decode import DecoderConfig as JDecoderConfig
from pathway_tpu.decode import init_decoder_params as jinit_decoder
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.sentence_encoder import CrossEncoderScorer as JScorer
from pathway_tpu.models.sentence_encoder import SentenceEncoder as JEncoder
from pathway_tpu.ops.fused_rag import FusedRagPipeline as JPipeline
from pathway_tpu_torch import SentenceEncoder
from pathway_tpu_torch.decode import DecodeEngine, DecoderConfig
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.reranker import DeviceReranker
from pathway_tpu_torch.models.sentence_encoder import CrossEncoderScorer
from pathway_tpu_torch.ops.fused_rag import FusedRagPipeline
from pathway_tpu_torch.weights import from_jax_cross_encoder_params, from_jax_decoder_params, from_jax_params

SMALL = dict(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=128)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


@pytest.fixture(scope="module")
def enc():
    return SentenceEncoder(config=TCfg(**SMALL), max_batch=64, max_seq_len=64, device="cpu")


@pytest.fixture(scope="module")
def cross():
    return CrossEncoderScorer(config=TCfg.cross_encoder_l6(**SMALL), max_seq_len=64, device="cpu")


# ---------------------------------------------- the reference's six cases


def test_retrieval_only_exact_match(enc):
    p = FusedRagPipeline(enc, None, reserved_space=128)
    docs = [f"passage {i} about topic {i % 7}" for i in range(40)]
    p.add_docs(list(range(40)), docs)
    r = p.query("passage 3 about topic 3", k=1, k_retrieve=8)
    assert r[0][0] == 3


def test_rerank_returns_k(enc, cross):
    p = FusedRagPipeline(enc, cross, reserved_space=128, doc_seq_len=48)
    docs = [f"passage {i} about topic {i % 7}" for i in range(30)]
    p.add_docs(list(range(30)), docs)
    r = p.query("passage 12 about topic 5", k=5, k_retrieve=16)
    assert len(r) == 5
    assert len({k for k, _ in r}) == 5  # distinct docs
    # a DeviceReranker is taken for its scorer
    assert FusedRagPipeline(enc, DeviceReranker(scorer=cross)).cross is cross


def test_incremental_adds_and_removes(enc):
    p = FusedRagPipeline(enc, None, reserved_space=64)
    p.add_docs(list(range(20)), [f"doc number {i}" for i in range(20)])
    p.query("doc number 1", k=1)  # resident
    p.add_docs([100], ["an unmistakably unique zebra document"])
    r = p.query("an unmistakably unique zebra document", k=1)
    assert r[0][0] == 100
    p.remove_docs([100])
    r = p.query("an unmistakably unique zebra document", k=1)
    assert r[0][0] != 100


def test_growth_past_reserved_space(enc):
    p = FusedRagPipeline(enc, None, reserved_space=64)
    docs = [f"growing corpus item {i} flavor {i % 11}" for i in range(300)]
    p.add_docs(list(range(300)), docs)
    r = p.query("growing corpus item 250 flavor 8", k=1, k_retrieve=8)
    assert r[0][0] == 250


def test_query_async_matches_sync(enc):
    p = FusedRagPipeline(enc, None, reserved_space=64)
    p.add_docs(list(range(10)), [f"async path doc {i}" for i in range(10)])
    sync = p.query("async path doc 4", k=3, k_retrieve=8)
    hits = p.resolve(*p.query_async("async path doc 4", k=3, k_retrieve=8), k=3)
    assert [k for k, _ in sync] == [k for k, _ in hits]


def test_empty_and_missing(enc):
    p = FusedRagPipeline(enc, None, reserved_space=64)
    assert p.query_batch([], 3) == []
    assert p.query("anything", 3) == []  # empty index
    p.add_docs([1], ["only doc"])
    r = p.query("only doc", k=5, k_retrieve=8)
    assert [k for k, _ in r] == [1]  # padding slots filtered out


# ---------------------------------------------- parity with the JAX pipeline

F32 = dict(vocab_size=30522, **SMALL)
DEC = dict(vocab_size=2048, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32, max_position=96)
DOCS = [f"passage {i} on subject {i % 9} with detail {i * 7 % 13}" for i in range(60)]
QUERIES = ["passage 12 on subject 3", "subject 5 with detail 4", "what do pelicans eat", DOCS[41]]


@pytest.fixture(scope="module")
def pipelines():
    jenc = JEncoder(config=JCfg(**F32, dtype=jnp.float32), checkpoint_dir="/nonexistent", max_seq_len=64, max_batch=64)
    jx = JScorer(config=JCfg.cross_encoder_l6(**F32, dtype=jnp.float32), checkpoint_dir="/nonexistent", max_seq_len=64)
    tenc = SentenceEncoder(config=TCfg(**F32, dtype=torch.float32), max_seq_len=64, max_batch=64, device="cpu",
                           params=from_jax_params(_tree(jenc.params)))
    tx = CrossEncoderScorer(config=TCfg.cross_encoder_l6(**F32, dtype=torch.float32), max_seq_len=64, device="cpu",
                            params=from_jax_cross_encoder_params(_tree(jx.params)))
    jparams = jinit_decoder(JDecoderConfig(**DEC), seed=0)
    jp = JPipeline(jenc, jx, reserved_space=64, doc_seq_len=32, decoder=(jparams, JDecoderConfig(**DEC)))
    tp = FusedRagPipeline(tenc, tx, reserved_space=64, doc_seq_len=32,
                          decoder=(from_jax_decoder_params(jparams), DecoderConfig(**DEC)))
    for p in (jp, tp):
        p.add_docs(list(range(50)), DOCS[:50])
        p.add_docs(list(range(50, 60)), DOCS[50:])  # grows past 64 slots
        p.remove_docs([7, 55])
    return jp, tp


def _same_hits(want, got):
    assert [[k for k, _ in r] for r in got] == [[k for k, _ in r] for r in want]
    for w, g in zip(want, got):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,k_retrieve", [(5, 20), (3, 8)])
def test_query_batch_matches_jax(pipelines, k, k_retrieve):
    jp, tp = pipelines
    _same_hits(jp.query_batch(QUERIES, k, k_retrieve), tp.query_batch(QUERIES, k, k_retrieve))
    assert tp.query(DOCS[41], k=1)[0][0] == jp.query(DOCS[41], k=1)[0][0]


def test_retrieval_only_matches_jax(pipelines):
    jp, tp = pipelines
    jc, tc = jp.cross, tp.cross
    jp.cross = tp.cross = None
    try:
        jp._jit_cache.clear()
        _same_hits(jp.query_batch(QUERIES, 6, 16), tp.query_batch(QUERIES, 6, 16))
    finally:
        jp.cross, tp.cross = jc, tc
        jp._jit_cache.clear()


@pytest.mark.parametrize("rerank", [True, False])
def test_answer_batch_matches_jax(pipelines, rerank):
    jp, tp = pipelines
    want = jp.answer_batch(QUERIES, k=2, max_new=5, rerank=rerank)
    got = tp.answer_batch(QUERIES, k=2, max_new=5, rerank=rerank)
    _same_hits([w["hits"] for w in want], [g["hits"] for g in got])
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert all(len(g["tokens"]) == 5 for g in got)


def test_answer_without_decoder_or_room_raises_and_engine_shares_weights(pipelines, enc):
    p = FusedRagPipeline(enc, None, reserved_space=64)
    p.add_docs([1], ["only doc"])
    with pytest.raises(RuntimeError, match="decoder"):
        p.answer("only doc")
    engine = DecodeEngine(DecoderConfig(**DEC), device="cpu")
    p.set_decoder(engine)
    with pytest.raises(ValueError, match="prompt room"):
        p.answer("only doc", max_new=96)
    out = p.answer("only doc", k=1, max_new=3)
    assert out["hits"][0][0] == 1 and len(out["tokens"]) == 3
    with pytest.raises(TypeError):
        p.set_decoder(3)
