"""The port's dataflow engine with its device layer, against the JAX
package, on the CPU (the port on ``device="cpu"``):

* the ``_pipeline_doc_ids`` pipeline of ``__graft_entry__.py`` (a
  streaming ``pw.io.python.read`` -> ``pw.apply`` embed -> ``KNNIndex`` ->
  nearest items) at its tiny geometry (vocab 512, d 32, 1 layer, 2 heads,
  FFN 64), weights carried across through ``weights.py``: neighbour sets
  equal the JAX package's, and the port's 1- and 4-worker runs (bf16, as
  the pipeline runs) are equal. The cross-package comparison runs float32
  encoders: with seeded random weights the twelve documents lie within
  about 1e-3 (squared L2) of each query, below the two frameworks' bf16
  rounding difference of about 2e-3 per component;
* ``DataIndex`` + ``BruteForceKnn`` with a ``SentenceTransformerEmbedder``
  (vocab 2048, float32 encoders on both sides so scores are comparable):
  device-resident ingest through ``add_batch_device``, queries through
  the fused text path; hits equal, scores within 1e-5;
* every unported ``pw.run`` option and index placement raises
  ``NotImplementedError``; ``mesh=`` (the run's, ``PATHWAY_MESH`` or an
  index's) runs on a CPU mesh, except ``"auto"``, which arms the elastic
  plane and raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu.models import sentence_encoder as jse
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu.stdlib.ml.index import KNNIndex as JKNNIndex
from pathway_tpu_torch.internals import run as trun
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.stdlib.ml.index import KNNIndex as TKNNIndex
from pathway_tpu_torch.weights import from_jax_params

SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


# --------------------------------------------------- _pipeline_doc_ids

FLAGSHIP = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32,
                pooling="mean")


def _flagship_encoders(f32: bool):
    jcfg = JCfg(**FLAGSHIP, dtype=jnp.float32) if f32 else JCfg(**FLAGSHIP)
    tcfg = TCfg(**FLAGSHIP, dtype=torch.float32) if f32 else TCfg(**FLAGSHIP)
    jenc = jse.SentenceEncoder(config=jcfg, checkpoint_dir="/nonexistent", max_seq_len=16, max_batch=16)
    tenc = tse.SentenceEncoder(config=tcfg, max_seq_len=16, max_batch=16, device="cpu",
                               params=from_jax_params(_tree(jenc.params)))
    return jenc, tenc


@pytest.fixture(scope="module")
def flagship_encoders():
    return _flagship_encoders(f32=True)


@pytest.fixture(scope="module")
def flagship_encoders_bf16():
    return _flagship_encoders(f32=False)


def _pipeline_doc_ids(pw, enc, runner_cls, knn_cls, n_workers, **knn_kw):
    """``__graft_entry__._pipeline_doc_ids`` with the package, encoder and
    index class as arguments -> {query_id: nearest doc_ids}."""
    rng = np.random.default_rng(7)
    doc_toks = [rng.integers(3, FLAGSHIP["vocab_size"], 8).tolist() for _ in range(12)]
    query_toks = [rng.integers(3, FLAGSHIP["vocab_size"], 8).tolist() for _ in range(3)]

    def embed_one(toks) -> tuple:
        vec = enc.encode_tokens([list(toks)])[0]
        return tuple(float(x) for x in vec)

    class DocSource(pw.io.python.ConnectorSubject):
        def run(self):
            for i, toks in enumerate(doc_toks):
                self.next(doc_id=i, toks=tuple(int(x) for x in toks))
                if i % 4 == 3:
                    self.commit()

    class DocSchema(pw.Schema):
        doc_id: int
        toks: tuple

    docs = pw.io.python.read(DocSource(), schema=DocSchema, autocommit_duration_ms=None)
    docs = docs.select(pw.this.doc_id, emb=pw.apply(embed_one, pw.this.toks))
    queries = pw.debug.table_from_rows(
        schema=DocSchema, rows=[(100 + i, tuple(int(x) for x in t)) for i, t in enumerate(query_toks)]
    )
    queries = queries.select(pw.this.doc_id, emb=pw.apply(embed_one, pw.this.toks))
    idx = knn_cls(docs.emb, docs, n_dimensions=FLAGSHIP["hidden_size"], **knn_kw)
    result = idx.get_nearest_items(queries.emb, k=3).select(qid=queries.doc_id, nearest=pw.this.doc_id)
    runner = runner_cls(n_workers=n_workers)
    cap, names = runner.capture(result)
    runner.run()
    pw.clear_graph()
    i_qid, i_near = names.index("qid"), names.index("nearest")
    return {row[i_qid]: tuple(row[i_near]) for row in cap.state.values()}


@pytest.mark.parametrize("n_workers", [1, 4])
def test_pipeline_doc_ids_equals_reference(flagship_encoders, n_workers):
    jenc, tenc = flagship_encoders
    want = _pipeline_doc_ids(jpw, jenc, JRunner, JKNNIndex, 1)
    got = _pipeline_doc_ids(tpw, tenc, TRunner, TKNNIndex, n_workers, device="cpu")
    assert sorted(got) == [100, 101, 102]
    assert all(len(v) == 3 for v in got.values())
    assert {q: set(v) for q, v in got.items()} == {q: set(v) for q, v in want.items()}


def test_pipeline_doc_ids_four_workers_equal_one(flagship_encoders_bf16):
    _, tenc = flagship_encoders_bf16
    one = _pipeline_doc_ids(tpw, tenc, TRunner, TKNNIndex, 1, device="cpu")
    four = _pipeline_doc_ids(tpw, tenc, TRunner, TKNNIndex, 4, device="cpu")
    assert {q: set(v) for q, v in four.items()} == {q: set(v) for q, v in one.items()}


# ------------------------------------- DataIndex + BruteForceKnn + embedder

F32 = dict(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=64)
WORDS = [f"w{i}" for i in range(200)] + ["river", "stone", "cloud", "light", "apple"]


def _texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1))) for _ in range(n)]


@pytest.fixture
def embedders(monkeypatch):
    """A SentenceTransformerEmbedder per package over the same float32
    encoder weights (the packages' SentenceEncoder swapped for a tiny one
    while the embedder is built)."""
    jenc = jse.SentenceEncoder(config=JCfg(**F32, dtype=jnp.float32), checkpoint_dir="/nonexistent",
                               max_seq_len=32, max_batch=64)
    jenc.tokenizer = JTok(vocab_size=F32["vocab_size"])
    tenc = tse.SentenceEncoder(config=TCfg(**F32, dtype=torch.float32), max_seq_len=32, max_batch=64,
                               device="cpu", params=from_jax_params(_tree(jenc.params)))
    tenc.tokenizer = TTok(vocab_size=F32["vocab_size"])
    monkeypatch.setattr(jse, "SentenceEncoder", lambda *a, **k: jenc)
    made = {}

    def make_port(model, max_batch, device, mesh=None):
        made["device"] = device
        return tenc

    monkeypatch.setattr(tse, "SentenceEncoder", make_port)
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmb
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmb

    pair = JEmb(), TEmb(device="cpu")
    assert made["device"] == "cpu" and pair[1]._encoder is tenc
    return pair


def _data_index_hits(pw, embedder, docs, queries, n_workers, **knn_kw):
    """DataIndex(BruteForceKnn) fed by a streaming subject (commits every 8
    rows), text queries as of now -> {query: [(doc_id, score), ...]}."""

    class Source(pw.io.python.ConnectorSubject):
        def run(self):
            for i, text in enumerate(docs):
                self.next(doc_id=i, text=text)
                if i % 8 == 7:
                    self.commit()

    class DocSchema(pw.Schema):
        doc_id: int
        text: str

    table = pw.io.python.read(Source(), schema=DocSchema, autocommit_duration_ms=None)
    knn = pw.indexing.BruteForceKnn(table.text, dimensions=F32["hidden_size"], reserved_space=64,
                                    embedder=embedder, **knn_kw)
    index = pw.indexing.DataIndex(table, knn)
    qschema = pw.schema_from_types(q=str)
    qt = pw.debug.table_from_rows(schema=qschema, rows=[(q,) for q in queries])
    # all documents first: the queries arrive after the data's last epoch
    replies = index.query_as_of_now(qt.q, number_of_matches=4)
    out = replies.select(q=qt.q, ids=pw.this.doc_id, scores=pw.this._pw_index_reply_score)
    runner = (JRunner if pw is jpw else TRunner)(n_workers=n_workers)
    cap, names = runner.capture(out)
    runner.run()
    pw.clear_graph()
    iq, ii, isc = (names.index(c) for c in ("q", "ids", "scores"))
    result = {}
    for row in cap.state.values():
        result[row[iq]] = list(zip([int(i) for i in row[ii]], [float(s) for s in row[isc]]))
    return result


def _hits_equal(got, want):
    assert sorted(got) == sorted(want)
    for q in want:
        g, w = got[q], want[q]
        assert len(g) == len(w) == 4, (q, g, w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=SCORE_TOL, atol=SCORE_TOL)
        # ids equal, up to swaps between candidates whose scores tie within the tolerance
        for (gi, gs), (wi, ws) in zip(g, w):
            assert gi == wi or any(abs(s - gs) <= SCORE_TOL and i == gi for i, s in w), (q, g, w)
        assert {i for i, _ in g} == {i for i, _ in w} or abs(g[-1][1] - w[-1][1]) <= SCORE_TOL


@pytest.mark.parametrize("n_workers", [1, 4])
def test_data_index_brute_force_knn_with_embedder_equals_reference(embedders, monkeypatch, n_workers):
    jemb, temb = embedders
    rng = np.random.default_rng(3)
    docs = _texts(rng, 24, 3, 12)
    queries = _texts(rng, 5, 2, 8) + [docs[5], docs[17]]
    calls = []
    real = tknn.DeviceKnnIndex.add_batch_device

    def counted(self, keys, vecs, metas=None):
        assert isinstance(vecs, torch.Tensor)
        calls.append(len(keys))
        return real(self, keys, vecs, metas)

    monkeypatch.setattr(tknn.DeviceKnnIndex, "add_batch_device", counted)
    want = _data_index_hits(jpw, jemb, docs, queries, 1)
    got = _data_index_hits(tpw, temb, docs, queries, n_workers, device="cpu")
    assert sum(calls) == len(docs)  # device-resident ingest: every row through add_batch_device
    _hits_equal(got, want)
    for text, doc_id in ((docs[5], 5), (docs[17], 17)):
        assert got[text][0][0] == doc_id and abs(got[text][0][1] - 1.0) < 1e-4, "a document's own text comes first"


def test_embedder_batched_udf_and_dimension(embedders):
    jemb, temb = embedders
    texts = ["river stone", "cloud light apple", ""]
    got = np.stack(temb.__wrapped__(texts))
    want = np.stack(jemb.__wrapped__(texts))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert temb.get_embedding_dimension() == jemb.get_embedding_dimension() == F32["hidden_size"]
    dev = temb.encode_device(texts, pad_to=8)
    assert isinstance(dev, torch.Tensor) and dev.shape == (8, F32["hidden_size"]) and (dev[3:] == 0).all()


# -------------------------------------------------- unported options raise


@pytest.mark.parametrize(
    "kwargs",
    [dict(mesh="auto"), dict(index_tiers="hot=64"), dict(tenancy=True), dict(elastic=True),
     dict(freshness=True), dict(chip_ledger=True), dict(persistence_config=object()), dict(recovery=True),
     dict(profile=True), dict(tracing=True), dict(watchdog=True), dict(with_http_server=True),
     dict(ingest_workers=2), dict(pipeline_depth=2), dict(analysis="strict"), dict(cluster_lease_ms=100),
     dict(monitoring_level="all")],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_run_options_raise(kwargs):
    t = tpw.debug.table_from_markdown("""
      | a
    1 | 1
    """)
    tpw.io.subscribe(t, lambda **_: None)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        tpw.run(**kwargs)


@pytest.mark.parametrize(
    "var,value",
    [("PATHWAY_MESH", "auto"), ("PATHWAY_INDEX_TIERS", "hot=64"), ("PATHWAY_TENANCY", "on"),
     ("PATHWAY_ELASTIC", "on"), ("PATHWAY_FRESHNESS", "on"), ("PATHWAY_CHIP_LEDGER", "1"), ("PATHWAY_PROFILE", "p.json"),
     ("PATHWAY_TRACING", "1"), ("PATHWAY_WATCHDOG", "1"), ("PATHWAY_PIPELINE_DEPTH", "2"),
     ("PATHWAY_INGEST_WORKERS", "2"), ("PATHWAY_PROCESSES", "2"), ("PATHWAY_REPLAY_STORAGE", "/tmp/x"),
     ("PATHWAY_ANALYSIS", "strict")],
)
def test_unported_env_options_raise(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    assert trun.unported_options({}) and var in trun.unported_options({})[0]
    with pytest.raises(NotImplementedError, match=var):
        tpw.run()


def test_run_options_at_their_off_values_pass(monkeypatch):
    monkeypatch.setenv("PATHWAY_PIPELINE_DEPTH", "1")
    monkeypatch.setenv("PATHWAY_TRACING", "0")
    seen = []
    t = tpw.debug.table_from_markdown("""
      | a
    1 | 1
    2 | 5
    """)
    tpw.io.subscribe(t.select(b=tpw.this.a * 2), lambda key, row, time, is_addition: seen.append(row["b"]))
    result = tpw.run(pipeline_depth=1, mesh=None, with_http_server=False, terminate_on_error=True)
    assert sorted(seen) == [2, 10] and isinstance(result, tpw.RunResult)
    with pytest.raises(TypeError, match="unexpected"):
        tpw.run(no_such_option=1)


@pytest.mark.parametrize("placement", [dict(tiers="hot=64"), dict(tenant="acme")], ids=lambda kw: next(iter(kw)))
@pytest.mark.parametrize("kind", ["BruteForceKnn", "LshKnn", "KNNIndex"])
def test_unported_index_placements_raise(placement, kind):
    t = tpw.debug.table_from_rows(schema=tpw.schema_from_types(v=tuple), rows=[((1.0, 0.0),)])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        if kind == "KNNIndex":
            idx = TKNNIndex(t.v, t, n_dimensions=2, device="cpu", **placement)
        else:
            idx = tpw.indexing.DataIndex(t, getattr(tpw.indexing, kind)(t.v, dimensions=2, device="cpu", **placement))
        (idx.get_nearest_items(t.v) if kind == "KNNIndex" else idx.query(t.v))


def _nearest_on_mesh(kind, monkeypatch, **run_kwargs):
    """A two-row index of ``kind`` queried by its own rows under
    ``pw.run(**run_kwargs)`` -> ({query: nearest row}, shard counts of the
    device indexes built)."""
    shards = []
    real_init = tknn.DeviceKnnIndex.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        shards.append(self.n_shards)

    monkeypatch.setattr(tknn.DeviceKnnIndex, "__init__", recording_init)
    t = tpw.debug.table_from_rows(schema=tpw.schema_from_types(name=str, v=tuple),
                                  rows=[("a", (1.0, 0.0)), ("b", (0.0, 1.0))])
    if kind == "KNNIndex":
        res = TKNNIndex(t.v, t, n_dimensions=2, device="cpu").get_nearest_items(t.v, k=1).select(
            q=t.name, near=tpw.this.name)
    else:
        index = tpw.indexing.DataIndex(t, getattr(tpw.indexing, kind)(t.v, dimensions=2, device="cpu"))
        res = index.query(t.v, number_of_matches=1).select(q=t.name, near=tpw.this.name)
    got = {}
    tpw.io.subscribe(res, lambda key, row, time, is_addition: got.__setitem__(row["q"], tuple(row["near"])))
    tpw.run(**run_kwargs)
    return got, shards


@pytest.mark.parametrize("kind", ["BruteForceKnn", "UsearchKnn", "LshKnn", "KNNIndex"])
def test_mesh_placements_run_on_a_cpu_mesh(kind, monkeypatch):
    """``pw.run(mesh=)`` shards the device-backed indexes over the mesh's
    data axis (LshKnn, a host index, ignores it, as in the reference)."""
    from pathway_tpu_torch.parallel.mesh import active_mesh, resolve_mesh

    got, shards = _nearest_on_mesh(kind, monkeypatch, mesh=resolve_mesh(4, device="cpu"))
    assert got == {"a": ("a",), "b": ("b",)} and active_mesh() is None
    assert shards == ([] if kind == "LshKnn" else [4])


@pytest.mark.parametrize("kind", ["BruteForceKnn", "KNNIndex"])
def test_pathway_mesh_env_runs_on_a_cpu_mesh(kind, monkeypatch):
    monkeypatch.setenv("PATHWAY_MESH", "2")
    got, shards = _nearest_on_mesh(kind, monkeypatch)
    assert got == {"a": ("a",), "b": ("b",)} and shards == [2]


def test_index_mesh_spec_resolves_on_the_index_device(monkeypatch):
    t = tpw.debug.table_from_rows(schema=tpw.schema_from_types(v=tuple), rows=[((1.0, 0.0),)])
    idx = tpw.indexing.BruteForceKnn(t.v, dimensions=2, device="cpu", mesh="data=3")._index_factory()()
    assert idx.n_shards == 3 and idx.shard_devices == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 3 visible CUDA cards"):
        tpw.indexing.BruteForceKnn(t.v, dimensions=2, mesh=3)._index_factory()()


def test_index_and_embedder_default_to_cuda(monkeypatch):
    """``device=None`` resolves to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpw.xpacks.llm.embedders.SentenceTransformerEmbedder()
    t = tpw.debug.table_from_rows(schema=tpw.schema_from_types(v=tuple), rows=[((1.0, 0.0),)])
    knn = tpw.indexing.BruteForceKnn(t.v, dimensions=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn._index_factory()()
