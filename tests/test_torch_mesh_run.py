"""The port's data-parallel encoder and the mesh through ``pw.run``, against
the JAX package, on the CPU (the port's meshes are lists of CPU devices,
the reference's the eight virtual CPU devices of ``tests/conftest.py``):

* ``SentenceEncoder(mesh=CPU x 4)`` against the reference's
  ``SentenceEncoder(mesh=make_mesh(4, model_parallel=1))`` and the port's
  single-device encoder, with the same converted weights, at the bounds of
  ``tests/test_sharding.py`` (rtol 2e-3, atol 1e-3, min cosine 0.9999);
  float32 configs on both sides of the cross-package comparison;
* ``pw.run(mesh=8)`` over ``tests/test_mesh_index.py``'s KNNIndex pipeline in
  both packages: ids equal, distances within 1e-5; ``PATHWAY_MESH`` the same;
* ``__graft_entry__._pipeline_doc_ids`` on the port with a mesh encoder of 4
  at 4 engine workers gives the neighbour sets of its solo run
  (``dryrun_multichip``'s own check);
* ``DataIndex(BruteForceKnn(embedder=SentenceTransformerEmbedder(mesh=)))``
  under ``pw.run(mesh=)``: device-resident ingest into the mesh index, hits
  equal to the reference's mesh run.
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
from pathway_tpu.models import sentence_encoder as jse
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu.parallel.sharding import make_mesh as jmake_mesh
from pathway_tpu.stdlib.ml.index import KNNIndex as JKNNIndex
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.parallel.mesh import active_mesh, resolve_mesh
from pathway_tpu_torch.stdlib.ml.index import KNNIndex as TKNNIndex
from pathway_tpu_torch.weights import from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
ENC_TOL = dict(rtol=2e-3, atol=1e-3)
TINY = dict(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=64)


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _cpu_mesh(n):
    return resolve_mesh(n, device="cpu")


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _encoders(f32: bool = True, max_batch: int = 64):
    """(reference mesh encoder of 4, port mesh encoder of 4, port solo) over
    the same weights and the same hashed tokenizer."""
    jcfg = JCfg(**TINY, dtype=jnp.float32) if f32 else JCfg(**TINY)
    tcfg = TCfg(**TINY, dtype=torch.float32) if f32 else TCfg(**TINY)
    jenc = jse.SentenceEncoder(config=jcfg, checkpoint_dir="/nonexistent", max_seq_len=32, max_batch=max_batch,
                               mesh=jmake_mesh(n_devices=4, model_parallel=1))
    jenc.tokenizer = JTok(vocab_size=TINY["vocab_size"])
    params = from_jax_params(_tree(jenc.params))
    out = [jenc]
    for mesh in (_cpu_mesh(4), None):
        enc = tse.SentenceEncoder(config=tcfg, max_seq_len=32, max_batch=max_batch, device="cpu", params=params,
                                  mesh=mesh)
        enc.tokenizer = TTok(vocab_size=TINY["vocab_size"])
        out.append(enc)
    return out


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, **ENC_TOL)
    assert (a * b).sum(axis=1).min() > 0.9999


def test_sentence_encoder_mesh_matches_reference_and_solo():
    jenc, tmesh_enc, tsolo = _encoders()
    assert tmesh_enc.mesh.shape == {"data": 4, "model": 1} and len(tmesh_enc._replicas) == 1  # one CPU
    rng = np.random.default_rng(1)
    # 21 rows in batches of 64 -> 60 on the mesh: a ragged last group, padded to the data axis
    toks = [[101] + rng.integers(999, 2000, int(rng.integers(3, 20))).tolist() + [102] for _ in range(70)]
    want = jenc.encode_tokens(toks)
    got = tmesh_enc.encode_tokens(toks)
    _close(got, want)
    _close(got, tsolo.encode_tokens(toks))
    texts = [" ".join(f"w{int(i)}" for i in rng.integers(0, 300, int(rng.integers(2, 25)))) for _ in range(30)]
    _close(tmesh_enc.encode(texts), jenc.encode(texts))
    dev = tmesh_enc.encode_device(texts, pad_to=32)
    assert dev.shape == (32, TINY["hidden_size"]) and (dev[30:] == 0).all()
    _close(dev[:30].numpy(), tsolo.encode(texts))


def test_sentence_encoder_mesh_bf16_matches_solo():
    """bf16 as the pipelines run: the mesh path and the solo module path
    differ only in how rows are batched."""
    _, tmesh_enc, tsolo = _encoders(f32=False, max_batch=16)
    rng = np.random.default_rng(2)
    toks = [[101] + rng.integers(999, 2000, int(rng.integers(3, 12))).tolist() + [102] for _ in range(19)]
    _close(tmesh_enc.encode_tokens(toks), tsolo.encode_tokens(toks))


def test_sentence_encoder_replicas_are_cast_like_the_first_module():
    """A data device of its own gets a copy of the first module with the same
    parameters in the same dtypes (bf16 projections, f32 LayerNorm), so its
    forward adds no casts; its rows embed as the solo encoder's do. Two
    distinct CPU devices (``cpu`` and ``cpu:0``) stand in for two cards."""
    from pathway_tpu_torch.parallel.sharding import make_mesh

    _, _, tsolo = _encoders(f32=False, max_batch=16)
    enc = tse.SentenceEncoder(config=TCfg(**TINY), max_seq_len=32, max_batch=16, device="cpu",
                              params=tsolo.module.state_dict(),
                              mesh=make_mesh(devices=["cpu", "cpu:0"], model_parallel=1))
    enc.tokenizer = TTok(vocab_size=TINY["vocab_size"])
    first, second = (enc._replicas[d] for d in enc._data_devices)
    assert first is not second
    want = first.state_dict()
    for name, t in second.state_dict().items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name
    assert {t.dtype for t in want.values()} == {torch.bfloat16, torch.float32}
    rng = np.random.default_rng(3)
    toks = [[101] + rng.integers(999, 2000, int(rng.integers(3, 12))).tolist() + [102] for _ in range(11)]
    _close(enc.encode_tokens(toks), tsolo.encode_tokens(toks))


def _knn_pipeline(pw, knn_cls, docs_v, qs_v, **knn_kw):
    """``tests/test_mesh_index.py::_knn_pipeline`` in either package."""
    docs = pw.debug.table_from_rows(pw.schema_from_types(i=int), [(i,) for i in range(len(docs_v))])
    docs = docs.select(docs.i, emb=pw.apply_with_type(lambda i: tuple(map(float, docs_v[i])), pw.ANY, docs.i))
    queries = pw.debug.table_from_rows(pw.schema_from_types(i=int), [(i,) for i in range(len(qs_v))])
    queries = queries.select(emb=pw.apply_with_type(lambda i: tuple(map(float, qs_v[i])), pw.ANY, queries.i))
    index = knn_cls(docs.emb, docs, n_dimensions=16, reserved_space=32, **knn_kw)
    return index.get_nearest_items(queries.emb, k=3, collapse_rows=True, with_distances=True)


def _collect(pw, res, **run_kwargs):
    rows = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[int(key)] = (tuple(row["i"]), tuple(row["dist"]))

    pw.io.subscribe(res, on_change=on_change)
    pw.run(**run_kwargs)
    return [rows[k] for k in sorted(rows)]


def _same_rows(got, want):
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], **TOL)


def test_pw_run_mesh_end_to_end_equals_reference():
    rng = np.random.default_rng(0)
    docs_v = rng.normal(size=(20, 16)).astype(np.float32)
    qs_v = rng.normal(size=(5, 16)).astype(np.float32)
    built = []
    real_init = tknn.DeviceKnnIndex.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        built.append(self)

    tknn.DeviceKnnIndex.__init__ = recording_init
    try:
        got = _collect(tpw, _knn_pipeline(tpw, TKNNIndex, docs_v, qs_v, device="cpu"), mesh=_cpu_mesh(8))
    finally:
        tknn.DeviceKnnIndex.__init__ = real_init
    assert active_mesh() is None, "the run-scoped mesh leaked"
    assert [idx.n_shards for idx in built] == [8]
    want = _collect(jpw, _knn_pipeline(jpw, JKNNIndex, docs_v, qs_v), mesh=8)
    assert len(got) == 5
    _same_rows(got, want)
    solo = _collect(tpw, _knn_pipeline(tpw, TKNNIndex, docs_v, qs_v, device="cpu"))
    _same_rows(solo, want)


def test_pathway_mesh_env_shards_the_index(monkeypatch):
    rng = np.random.default_rng(1)
    docs_v = rng.normal(size=(12, 16)).astype(np.float32)
    qs_v = rng.normal(size=(3, 16)).astype(np.float32)
    solo = _collect(tpw, _knn_pipeline(tpw, TKNNIndex, docs_v, qs_v, device="cpu"))
    monkeypatch.setenv("PATHWAY_MESH", "4")
    shards = []
    real_sync = tknn.DeviceKnnIndex._sync

    def recording_sync(self):
        shards.append(self.n_shards)
        return real_sync(self)

    monkeypatch.setattr(tknn.DeviceKnnIndex, "_sync", recording_sync)
    _same_rows(_collect(tpw, _knn_pipeline(tpw, TKNNIndex, docs_v, qs_v, device="cpu")), solo)
    assert shards and set(shards) == {4}


FLAGSHIP = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32,
                pooling="mean")


def _pipeline_doc_ids(enc, n_workers):
    """``__graft_entry__._pipeline_doc_ids`` on the port -> {query_id: nearest doc_ids}."""
    pw = tpw
    rng = np.random.default_rng(7)
    doc_toks = [rng.integers(3, FLAGSHIP["vocab_size"], 8).tolist() for _ in range(12)]
    query_toks = [rng.integers(3, FLAGSHIP["vocab_size"], 8).tolist() for _ in range(3)]

    def embed_one(toks) -> tuple:
        return tuple(float(x) for x in enc.encode_tokens([list(toks)])[0])

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
    idx = TKNNIndex(docs.emb, docs, n_dimensions=FLAGSHIP["hidden_size"], device="cpu")
    result = idx.get_nearest_items(queries.emb, k=3).select(qid=queries.doc_id, nearest=pw.this.doc_id)
    runner = TRunner(n_workers=n_workers)
    cap, names = runner.capture(result)
    runner.run()
    pw.clear_graph()
    i_qid, i_near = names.index("qid"), names.index("nearest")
    return {row[i_qid]: tuple(row[i_near]) for row in cap.state.values()}


def test_pipeline_doc_ids_mesh_encoder_four_workers_equal_solo():
    """``dryrun_multichip``'s check: a mesh encoder of 4 under 4 engine
    workers gives the neighbour sets of the single-device, single-worker run
    (bf16, as the pipeline runs)."""
    jenc = jse.SentenceEncoder(config=JCfg(**FLAGSHIP), checkpoint_dir="/nonexistent", max_seq_len=16, max_batch=16)
    params = from_jax_params(_tree(jenc.params))
    mesh_enc, solo_enc = (tse.SentenceEncoder(config=TCfg(**FLAGSHIP), max_seq_len=16, max_batch=16, device="cpu",
                                              params=params, mesh=m) for m in (_cpu_mesh(4), None))
    sharded = _pipeline_doc_ids(mesh_enc, 4)
    solo = _pipeline_doc_ids(solo_enc, 1)
    assert sorted(sharded) == [100, 101, 102] and all(len(v) == 3 for v in sharded.values())
    assert {q: set(v) for q, v in sharded.items()} == {q: set(v) for q, v in solo.items()}


WORDS = [f"w{i}" for i in range(200)] + ["river", "stone", "cloud", "light", "apple"]


def _data_index_hits(pw, embedder, docs, queries, **run_kwargs):
    """DataIndex(BruteForceKnn(embedder=)) fed by a streaming subject (commits
    every 8 rows), text queries as of now, under ``pw.run(**run_kwargs)``
    -> {query: [(doc_id, score), ...]}."""

    class Source(pw.io.python.ConnectorSubject):
        def run(self):
            for i, text in enumerate(docs):
                self.next(doc_id=i, text=text)
                if i % 8 == 7:
                    self.commit()

    table = pw.io.python.read(Source(), schema=pw.schema_from_types(doc_id=int, text=str),
                              autocommit_duration_ms=None)
    knn = pw.indexing.BruteForceKnn(table.text, dimensions=TINY["hidden_size"], reserved_space=64, embedder=embedder)
    qt = pw.debug.table_from_rows(schema=pw.schema_from_types(q=str), rows=[(q,) for q in queries])
    replies = pw.indexing.DataIndex(table, knn).query_as_of_now(qt.q, number_of_matches=4)
    out = replies.select(q=qt.q, ids=pw.this.doc_id, scores=pw.this._pw_index_reply_score)
    hits = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            hits[row["q"]] = list(zip([int(i) for i in row["ids"]], [float(s) for s in row["scores"]]))

    pw.io.subscribe(out, on_change=on_change)
    pw.run(**run_kwargs)
    return hits


def test_data_index_with_mesh_embedder_equals_reference(monkeypatch):
    jenc, tenc, _ = _encoders()
    monkeypatch.setattr(jse, "SentenceEncoder", lambda *a, **k: jenc)
    seen = {}

    def make_port(model, max_batch, device, mesh=None):
        seen["mesh"] = mesh
        return tenc

    monkeypatch.setattr(tse, "SentenceEncoder", make_port)
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmb
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmb

    mesh = _cpu_mesh(4)
    temb = TEmb(device="cpu", mesh=mesh)
    assert seen["mesh"] is mesh
    calls = []
    real = tknn.DeviceKnnIndex.add_batch_device

    def counted(self, keys, vecs, metas=None):
        assert self.n_shards == 4 and isinstance(vecs, torch.Tensor)
        calls.append(len(keys))
        return real(self, keys, vecs, metas)

    monkeypatch.setattr(tknn.DeviceKnnIndex, "add_batch_device", counted)
    rng = np.random.default_rng(3)
    docs = [" ".join(rng.choice(WORDS, rng.integers(3, 13))) for _ in range(24)]
    queries = [" ".join(rng.choice(WORDS, rng.integers(2, 9))) for _ in range(5)] + [docs[5], docs[17]]
    got = _data_index_hits(tpw, temb, docs, queries, mesh=mesh)
    want = _data_index_hits(jpw, JEmb(mesh=jenc.mesh), docs, queries, mesh=jenc.mesh)
    assert sum(calls) == len(docs)
    assert sorted(got) == sorted(want)
    for q in want:
        assert [i for i, _ in got[q]] == [i for i, _ in want[q]], q
        np.testing.assert_allclose([s for _, s in got[q]], [s for _, s in want[q]], **TOL)
    assert got[docs[5]][0][0] == 5 and got[docs[17]][0][0] == 17
