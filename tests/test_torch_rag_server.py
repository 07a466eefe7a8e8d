"""The port's RAG document servers against the JAX package's, on the CPU.

The README's example in both packages: ``pw.io.fs.read(folder,
format="binary", mode="streaming", with_metadata=True)`` (one scan,
``PATHWAY_TPU_FS_ONESHOT``) -> ``ParseUtf8`` -> ``TokenCountSplitter`` ->
``SentenceTransformerEmbedder`` -> ``VectorStoreServer.run_server``, and
``DocumentStoreServer`` over a ``DocumentStore`` with the
``BruteForceKnnFactory``, ``TantivyBM25Factory`` and
``HybridIndexFactory`` retrievers, over the same documents and real HTTP.

The embedder is a tiny float32 encoder on both sides (vocab 2048, d 32,
one layer), its weights carried from the JAX encoder through
``weights.py``; float32 keeps the rankings comparable. ``/v1/retrieve``
(with ``k``, ``metadata_filter``, ``filepath_globpattern``) gives the same
paths and texts in the same order up to score ties, with ``dist`` within
``DIST_TOL``; ``/v1/statistics`` and ``/v1/inputs`` the same files. The
splitter and parser give identical chunks, and the QA servers answer
through a fake answerer as the reference's do.
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.request

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
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.models import sentence_encoder as tse
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_params

DIST_TOL = 1e-4  # float32 encoders on both sides, one layer at d 32
F32 = dict(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=64)
WORDS = [f"w{i}" for i in range(120)] + ["river", "stone", "cloud", "light", "apple", "graph", "epoch"]
SPLITTER = lambda pw: pw.xpacks.llm.splitters.TokenCountSplitter(min_tokens=4, max_tokens=12)  # noqa: E731


@pytest.fixture(autouse=True)
def _clear_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


@pytest.fixture(scope="module")
def encoders():
    jenc = jse.SentenceEncoder(config=JCfg(**F32, dtype=jnp.float32), checkpoint_dir="/nonexistent",
                               max_seq_len=32, max_batch=64)
    jenc.tokenizer = JTok(vocab_size=F32["vocab_size"])
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jenc.params))
    tenc = tse.SentenceEncoder(config=TCfg(**F32, dtype=torch.float32), max_seq_len=32, max_batch=64,
                               device="cpu", params=from_jax_params(params))
    tenc.tokenizer = TTok(vocab_size=F32["vocab_size"])
    return jenc, tenc


@pytest.fixture
def embedders(encoders, monkeypatch):
    """A SentenceTransformerEmbedder per package over the same float32
    encoder weights (each package's SentenceEncoder swapped for a tiny one
    while the embedder is built)."""
    jenc, tenc = encoders
    monkeypatch.setattr(jse, "SentenceEncoder", lambda *a, **k: jenc)
    monkeypatch.setattr(tse, "SentenceEncoder", lambda *a, **k: tenc)
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmb
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmb

    return JEmb(), TEmb(device="cpu")


def _prose(rng, n_sentences: int) -> str:
    return " ".join(" ".join(rng.choice(WORDS, rng.integers(3, 9))) + rng.choice([".", "!", "?"])
                    for _ in range(n_sentences))


@pytest.fixture
def folder(tmp_path):
    rng = np.random.default_rng(17)
    (tmp_path / "docs" / "sub").mkdir(parents=True)
    texts = {}
    for i in range(6):
        rel = f"sub/f{i}.txt" if i % 2 else f"f{i}.txt"
        texts[rel] = _prose(rng, int(rng.integers(2, 6)))
        (tmp_path / "docs" / rel).write_text(texts[rel])
    return tmp_path / "docs", texts


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, path: str, payload: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read().decode())


def _serve(pw, runner_cls, monkeypatch, start, n_files: int, queries: list):
    """``start(port)`` registers a server's endpoints and starts its run;
    once ``/v1/statistics`` counts ``n_files``, post ``queries``
    [(path, payload)] in turn and stop the engine -> the answers."""
    runners = []
    real_init = runner_cls.__init__

    def recording_init(self, *a, **k):
        real_init(self, *a, **k)
        runners.append(self)

    monkeypatch.setattr(runner_cls, "__init__", recording_init)
    port = _free_port()
    run = start(port)
    stats = None
    for _ in range(300):
        try:
            stats = _post(port, "/v1/statistics", {})
            if stats["file_count"] == n_files:
                break
        except OSError:
            pass
        threading.Event().wait(0.05)
    assert stats is not None and stats["file_count"] == n_files, stats
    answers = [_post(port, path, payload) for path, payload in queries]
    runners[-1].engine.stop()
    if pw is tpw:  # the reference serves until its process ends
        run.join(timeout=30)
        assert not run.is_alive()
    pw.clear_graph()
    return answers


def _queries(texts: dict) -> list:
    chunk = lambda rel, i: SPLITTER(tpw).__wrapped__(texts[rel])[i][0]  # noqa: E731 - a chunk's exact text
    return [
        ("/v1/retrieve", {"query": "river stone light w7", "k": 3}),
        ("/v1/retrieve", {"query": chunk("f2.txt", 1), "k": 4}),
        ("/v1/retrieve", {"query": chunk("f0.txt", 0) + " " + chunk("sub/f3.txt", 0), "k": 2,
                          "metadata_filter": "contains(path, `f3`)"}),
        ("/v1/retrieve", {"query": chunk("sub/f5.txt", 0), "k": 5, "filepath_globpattern": "**/sub/*.txt"}),
        ("/v1/statistics", {}),
        ("/v1/inputs", {}),
        ("/v1/inputs", {"filepath_globpattern": "**/sub/*.txt"}),
    ]


def _hits_equal(got: list, want: list) -> None:
    """Same (path, text) hits in the same order, up to swaps of hits whose
    distances tie within DIST_TOL; distances within DIST_TOL."""
    assert len(got) == len(want), (got, want)
    np.testing.assert_allclose([h["dist"] for h in got], [h["dist"] for h in want], rtol=0, atol=DIST_TOL)
    key = lambda h: (h["metadata"]["path"], h["text"])  # noqa: E731
    for g, w in zip(got, want):
        assert key(g) == key(w) or any(key(x) == key(g) and abs(x["dist"] - g["dist"]) <= DIST_TOL for x in want)
    assert {key(h) for h in got} == {key(h) for h in want} or abs(got[-1]["dist"] - want[-1]["dist"]) <= DIST_TOL


def _answers_equal(got: list, want: list, queries: list, texts: dict, root) -> None:
    for (path, payload), g, w in zip(queries, got, want):
        if path == "/v1/retrieve":
            assert len(g) == min(payload["k"], len(g)) and g, (payload, g)
            _hits_equal(g, w)
            if "filepath_globpattern" in payload:
                assert all("/sub/" in h["metadata"]["path"] for h in g)
            if "metadata_filter" in payload:
                assert all("f3" in h["metadata"]["path"] for h in g)
        elif path == "/v1/statistics":
            assert g["file_count"] == w["file_count"] == len(texts)
            assert g["last_modified"] == w["last_modified"]
        else:
            paths = lambda metas: sorted(m["path"] for m in metas)  # noqa: E731
            assert paths(g) == paths(w) and len(g) >= 1
            assert set(paths(g)) <= {str(root / rel) for rel in texts}


def _vector_store(pw, emb, root, port):
    docs = pw.io.fs.read(str(root), format="binary", mode="streaming", with_metadata=True)
    server = pw.xpacks.llm.VectorStoreServer(docs, embedder=emb, parser=pw.xpacks.llm.parsers.ParseUtf8(),
                                             splitter=SPLITTER(pw))
    return server.run_server(host="127.0.0.1", port=port, threaded=True)


def test_vector_store_server_equals_reference(embedders, folder, monkeypatch):
    jemb, temb = embedders
    root, texts = folder
    queries = _queries(texts)
    want = _serve(jpw, JRunner, monkeypatch, lambda port: _vector_store(jpw, jemb, root, port), len(texts), queries)
    got = _serve(tpw, TRunner, monkeypatch, lambda port: _vector_store(tpw, temb, root, port), len(texts), queries)
    _answers_equal(got, want, queries, texts, root)
    probe = queries[1][1]["query"]
    assert got[1][0]["text"] == probe and abs(got[1][0]["dist"] + 1.0) < 1e-4, "a chunk finds itself"


def _retriever(pw, emb, kind):
    knn = pw.indexing.BruteForceKnnFactory(embedder=emb)
    if kind == "knn":
        return knn
    if kind == "bm25":
        return pw.indexing.TantivyBM25Factory()
    return pw.indexing.HybridIndexFactory([knn, pw.indexing.TantivyBM25Factory()], k=60.0)


def _document_store(pw, emb, root, kind, port):
    docs = pw.io.fs.read(str(root), format="binary", mode="streaming", with_metadata=True)
    store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=_retriever(pw, emb, kind), splitter=SPLITTER(pw))
    server = pw.xpacks.llm.servers.DocumentStoreServer("127.0.0.1", port, store)
    return server.run(threaded=True)


@pytest.mark.parametrize("kind", ["knn", "bm25", "hybrid"])
def test_document_store_server_equals_reference(embedders, folder, monkeypatch, kind):
    jemb, temb = embedders
    root, texts = folder
    queries = _queries(texts)
    want = _serve(jpw, JRunner, monkeypatch, lambda port: _document_store(jpw, jemb, root, kind, port),
                  len(texts), queries)
    got = _serve(tpw, TRunner, monkeypatch, lambda port: _document_store(tpw, temb, root, kind, port),
                 len(texts), queries)
    _answers_equal(got, want, queries, texts, root)


class _FakeAnswerer:
    """The question answerer the QA servers expect: the store's retrieval
    handlers, and answers that echo the prompt."""

    def __init__(self, pw, store):
        self.pw = pw
        self.RetrieveQuerySchema = store.RetrieveQuerySchema
        self.StatisticsQuerySchema = store.StatisticsQuerySchema
        self.InputsQuerySchema = store.InputsQuerySchema
        self.retrieve = store.retrieve_query
        self.statistics = store.statistics_query
        self.list_documents = store.inputs_query

        class AnswerQuerySchema(pw.Schema):
            prompt: str

        class SummarizeQuerySchema(pw.Schema):
            text_list: list

        self.AnswerQuerySchema = AnswerQuerySchema
        self.SummarizeQuerySchema = SummarizeQuerySchema

    def answer_query(self, queries):
        return queries.select(result=self.pw.apply(lambda p: f"answer to {p!r}", self.pw.this.prompt))

    def summarize_query(self, queries):
        return queries.select(result=self.pw.apply(lambda texts: " | ".join(texts), self.pw.this.text_list))


def _qa_server(pw, root, port):
    docs = pw.io.fs.read(str(root), format="binary", mode="streaming", with_metadata=True)
    store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=pw.indexing.TantivyBM25Factory())
    server = pw.xpacks.llm.servers.QASummaryRestServer("127.0.0.1", port, _FakeAnswerer(pw, store))
    return server.run(threaded=True)


def test_qa_servers_with_a_fake_answerer_equal_reference(folder, monkeypatch):
    root, texts = folder
    queries = [
        ("/v1/pw_ai_answer", {"prompt": "what is a river"}),
        ("/v2/answer", {"prompt": "stone"}),
        ("/v1/pw_ai_summary", {"text_list": ["one", "two"]}),
        ("/v2/summarize", {"text_list": ["x"]}),
        ("/v1/retrieve", {"query": "river stone", "k": 2}),
        ("/v1/pw_list_documents", {}),
    ]
    want = _serve(jpw, JRunner, monkeypatch, lambda port: _qa_server(jpw, root, port), len(texts), queries)
    got = _serve(tpw, TRunner, monkeypatch, lambda port: _qa_server(tpw, root, port), len(texts), queries)
    assert got[:4] == want[:4] == ["answer to 'what is a river'", "answer to 'stone'", "one | two", "x"]
    _hits_equal(got[4], want[4])
    assert sorted(m["path"] for m in got[5]) == sorted(m["path"] for m in want[5])


def test_splitter_and_parser_chunks_equal_reference():
    from pathway_tpu.xpacks.llm import parsers as jparsers
    from pathway_tpu.xpacks.llm import splitters as jsplit
    from pathway_tpu_torch.xpacks.llm import parsers as tparsers
    from pathway_tpu_torch.xpacks.llm import splitters as tsplit

    rng = np.random.default_rng(23)
    texts = [_prose(rng, int(rng.integers(1, 40))) for _ in range(12)]
    texts += [" ".join(rng.choice(WORDS, 700)), "Ünïcödé ﬁne text. Ⅻ chapters!", ""]
    for lo, hi in ((50, 500), (4, 12), (1, 3)):
        js, ts = jsplit.TokenCountSplitter(min_tokens=lo, max_tokens=hi), tsplit.TokenCountSplitter(
            min_tokens=lo, max_tokens=hi)
        for text in texts:
            assert ts.__wrapped__(text) == js.__wrapped__(text)
    for raw in [t.encode() for t in texts] + [b"\xff\xfe broken utf-8", "already text"]:
        assert tparsers.ParseUtf8().__wrapped__(raw) == jparsers.ParseUtf8().__wrapped__(raw)
    assert tsplit.null_splitter("abc") == jsplit.null_splitter("abc")


def test_unported_xpack_options_raise():
    """``BaseRestServer(serving=)`` serves now; ``OpenParse`` is ported and,
    as the reference's, raises the reference's ``ImportError`` when the
    ``openparse`` package is absent."""
    for parsers in (tpw.xpacks.llm.parsers, jpw.xpacks.llm.parsers):
        with pytest.raises(ImportError, match="OpenParse requires the openparse package"):
            parsers.OpenParse()
    cfg = tpw.serving.ServingConfig(max_queue=8, default_deadline_ms=20_000.0)
    server = tpw.xpacks.llm.servers.BaseRestServer("127.0.0.1", _free_port(), serving=cfg)
    server.serve("/x", tpw.schema_from_types(a=int), lambda q: q.select(result=tpw.this.a * 2))
    assert tpw.parse_graph.serving_endpoints[-1] == {
        "route": "/x", "kind": "rest_connector", "protected": True, "deadline_ms": 20_000.0,
        "batch_window_ms": cfg.batch_window_ms}
