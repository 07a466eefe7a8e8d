"""Guards of the PyTorch port: it imports nothing of JAX, flax or
pathway_tpu, also when its dataflow engine runs a ``pw.run`` pipeline
(``pw.io.python.read`` -> embedder -> ``DataIndex`` -> ``pw.io.subscribe``)
or serves the RAG document servers over a folder, or shards an index and
an encoder over a mesh of CPU devices, or runs the decode extensions under
``pw.run(decode=)`` through ``DecodeService`` and answers questions through
the xpack's question answerer; it never imports ``aiohttp`` or
``requests``, which the card's machine lacks (its webserver is the standard
library's), and imports no service client (``openai``, ``litellm``,
``cohere``, ``transformers``, ``flashrank``) at module load; its entry
points never fall back to the CPU;
its kernels are built only at first use on a CUDA tensor;
``chip_smoke.py`` refuses to run without a card."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pathway_tpu_torch")

_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|pathway_tpu|aiohttp|requests)(?:\.|\s|$)", re.M)
_FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pathway_tpu", "aiohttp", "requests")
# service clients: imported only inside the function that calls them
_CLIENTS = ("openai", "litellm", "cohere", "transformers", "flashrank")
_CLIENT_AT_LOAD = re.compile(r"^(?:import|from)\s+(?:" + "|".join(_CLIENTS) + r")(?:\.|\s|$)", re.M)

_PROBE = r"""
import sys
before = set(sys.modules)
import numpy as np
import pathway_tpu_torch as pt
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer
cfg = EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32)
enc = pt.SentenceEncoder(config=cfg, max_seq_len=16, max_batch=8, device="cpu")
enc.tokenizer = WordPieceTokenizer(vocab_size=2048)
index = pt.DeviceKnnIndex(dim=32, device="cpu")
index.add_batch_device(list(range(5)), enc.encode_device(["a b", "c d", "e f", "g h", "i j"]))
index.attach_encoder(enc)
assert index.search_batch(enc.encode(["a b"]), 2)[0][0][0] == 0
assert index.search_texts_batch(["c d"], 2)[0][0][0] == 1
ccfg = EncoderConfig.cross_encoder_l6(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=64)
cross = pt.CrossEncoderScorer(config=ccfg, max_seq_len=32, device="cpu")
cross.tokenizer = enc.tokenizer
rag = pt.FusedRagPipeline(enc, pt.as_reranker(cross), reserved_space=64, doc_seq_len=8,
                          decoder=pt.DecoderConfig(vocab_size=2048, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32, max_position=48))
rag.add_docs(list(range(5)), ["a b", "c d", "e f", "g h", "i j"])
assert len(rag.answer("c d", k=2, max_new=3)["tokens"]) == 3
dec = pt.DecodeEngine(pt.DecoderConfig(vocab_size=97, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32, max_position=32),
                      pt.DecodeConfig(pages=16, page_size=4, lanes=2, max_new_tokens=3, degrade_max_new_tokens=1, max_seq=16), device="cpu")
assert [len(s) for s in dec.generate([[1, 2, 3], [4]])] == [3, 3]
import pathway_tpu_torch as pw
class Docs(pw.io.python.ConnectorSubject):
    def run(self):
        for i, text in enumerate(["a b", "c d", "e f", "g h", "i j"]):
            self.next(doc_id=i, text=text)
            if i % 2:
                self.commit()
class DocSchema(pw.Schema):
    doc_id: int
    text: str
docs = pw.io.python.read(Docs(), schema=DocSchema, autocommit_duration_ms=None)
index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(docs.text, dimensions=32, reserved_space=64,
                                                                embedder=enc, device="cpu"))
queries = pw.debug.table_from_rows(schema=pw.schema_from_types(q=str), rows=[("c d",)])
hits = []
pw.io.subscribe(index.query_as_of_now(queries.q, number_of_matches=2).select(ids=pw.this.doc_id),
                lambda key, row, time, is_addition: hits.append(row["ids"]))
pw.run()
assert hits and hits[-1][0] == 1, hits
rows = pw.debug.table_from_rows(schema=pw.schema_from_types(k=str, v=int), rows=[("a", 1), ("a", 2), ("b", 5)])
counts = rows.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
assert sorted(pw.debug.table_to_dicts(counts)[1]["s"].values()) == [3, 5]
from pathway_tpu_torch.parallel.mesh import active_mesh, parse_mesh_spec, resolve_mesh, use_mesh
from pathway_tpu_torch.parallel.sharding import make_mesh
mesh = resolve_mesh("4", device="cpu")
assert mesh.shape == {"data": 4, "model": 1} and parse_mesh_spec("4x2") == {"data": 4, "model": 2}
assert make_mesh(devices=["cpu"] * 4, model_parallel=1) == mesh
menc = pt.SentenceEncoder(config=cfg, max_seq_len=16, max_batch=8, device="cpu", mesh=mesh)
menc.tokenizer = enc.tokenizer
mindex = pt.DeviceKnnIndex(dim=32, mesh=mesh)
mindex.add_batch_device(list(range(5)), menc.encode_device(["a b", "c d", "e f", "g h", "i j"]))
assert mindex.search_batch(menc.encode(["c d"]), 2)[0][0][0] == 1
with use_mesh(mesh):
    assert active_mesh() is mesh
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN)
print("BAD", bad)
"""

_SERVER_PROBE = r"""
import importlib, json, os, pkgutil, sys, tempfile, threading, urllib.request
before = set(sys.modules)
import pathway_tpu_torch as pw
for info in pkgutil.walk_packages(pw.__path__, "pathway_tpu_torch."):
    importlib.import_module(info.name)
from pathway_tpu_torch.internals.graph_runner import GraphRunner
from pathway_tpu_torch.models import sentence_encoder
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer
cfg = EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32)
enc = sentence_encoder.SentenceEncoder(config=cfg, max_seq_len=16, max_batch=8, device="cpu")
enc.tokenizer = WordPieceTokenizer(vocab_size=2048)
sentence_encoder.SentenceEncoder = lambda *a, **k: enc
os.environ["PATHWAY_TPU_FS_ONESHOT"] = "1"
folder = tempfile.mkdtemp()
for i, text in enumerate(["river stone. cloud light.", "apple graph epoch.", "delta kappa river."]):
    with open(os.path.join(folder, f"d{i}.txt"), "w") as f:
        f.write(text)
runners = []
real_init = GraphRunner.__init__
def recording_init(self, *a, **k):
    real_init(self, *a, **k)
    runners.append(self)
GraphRunner.__init__ = recording_init
def post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read().decode())
def serve(start, port):
    run = start(port)
    for _ in range(400):
        try:
            if post(port, "/v1/statistics", {})["file_count"] == 3:
                break
        except OSError:
            threading.Event().wait(0.05)
    hits = post(port, "/v1/retrieve", {"query": "apple graph epoch.", "k": 2})
    runners[-1].engine.stop()
    run.join(timeout=30)
    assert not run.is_alive()
    pw.clear_graph()
    return hits
embedder = pw.xpacks.llm.embedders.SentenceTransformerEmbedder(device="cpu")
def vector_store(port):
    docs = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    server = pw.xpacks.llm.VectorStoreServer(docs, embedder=embedder, splitter=pw.xpacks.llm.splitters.TokenCountSplitter())
    return server.run_server(host="127.0.0.1", port=port, threaded=True)
def document_store(port):
    docs = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    factory = pw.indexing.HybridIndexFactory([pw.indexing.BruteForceKnnFactory(embedder=embedder),
                                              pw.indexing.TantivyBM25Factory()])
    store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=factory)
    return pw.xpacks.llm.servers.DocumentStoreServer("127.0.0.1", port, store).run(threaded=True)
import socket
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
assert serve(vector_store, free_port())[0]["text"] == "apple graph epoch."
assert serve(document_store, free_port())[0]["text"] == "apple graph epoch."
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN)
print("BAD", bad)
"""


_DECODE_QA_PROBE = r"""
import sys
before = set(sys.modules)
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.decode import DecodeService
from pathway_tpu_torch.serving import Deadline
geom = pw.DecoderConfig(vocab_size=97, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, max_position=64)
streams = []
class One(pw.io.python.ConnectorSubject):
    def run(self):
        self.next(x=1)
t = pw.io.python.read(One(), schema=pw.schema_from_types(x=int))
def on_change(key, row, time, is_addition):
    for spec in ("cache=on,chunk=4", "spec=2,draft=1", "spec=3,ngram=2", "temp=0.8,top_k=5,seed=1"):
        with pw.decode.use_decode("pages=64,page=4,lanes=2,max_new=4,degrade=1,max_seq=48," + spec):
            svc = DecodeService(pw.DecodeEngine(geom, device="cpu"))
            tickets = [svc.submit([1, 2, 3, 4, 5, 6, 7], deadline=Deadline(60_000.0)), svc.submit([9, 8])]
            streams.append([tk.result(timeout=60) for tk in tickets])
            assert svc.error is None
            svc.stop()
pw.io.subscribe(t, on_change)
pw.run(decode="pages=64,page=4,lanes=2,max_new=4,degrade=1,max_seq=48")
assert len(streams) == 4 and all(len(s) == 4 for pair in streams for s in pair), streams
pw.clear_graph()
class Chat(pw.xpacks.llm.llms.BaseChat):
    def __wrapped__(self, messages, **kwargs):
        return "answer"
    def _accepts_call_arg(self, arg_name):
        return True
@pw.udf
def embed(x: str) -> np.ndarray:
    v = np.array([len(x), x.count("a"), x.count("e"), 1.0], np.float32)
    return v / np.linalg.norm(v)
class DocSchema(pw.Schema):
    data: bytes
    _metadata: pw.Json
docs = pw.debug.table_from_rows(DocSchema, [(t.encode(), pw.Json({"path": f"/d{i}"}))
                                           for i, t in enumerate(["alpha beta", "gamma", "eee"])])
store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=pw.indexing.BruteForceKnnFactory(embedder=embed, device="cpu"))
rag = pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer(Chat(), store, search_topk=2)
class Q(pw.Schema):
    prompt: str
    filters: str | None = pw.column_definition(default_value=None)
    model: str | None = pw.column_definition(default_value=None)
    return_context_docs: bool | None = pw.column_definition(default_value=True)
out = pw.debug.table_to_dicts(rag.answer_query(pw.debug.table_from_rows(Q, [("gamma", None, None, True)])))[1]
(answer,) = out["result"].values()
assert answer.value["response"] == "answer" and len(answer.value["context_docs"]) == 2
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN + CLIENTS)
print("BAD", bad)
"""


def _run_probe(probe: str) -> None:
    out = subprocess.run(
        [sys.executable, "-c", f"FORBIDDEN = {_FORBIDDEN_MODULES!r}\nCLIENTS = {_CLIENTS!r}\n" + probe], cwd=REPO,
        capture_output=True,
        text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout


def test_port_run_imports_no_jax_flax_or_reference():
    _run_probe(_PROBE)


def test_port_servers_import_no_jax_flax_reference_or_http_clients():
    """Every module of the port imported, then the README's RAG server and a
    DocumentStoreServer over a hybrid index served over a folder."""
    _run_probe(_SERVER_PROBE)


def test_port_decode_extensions_and_qa_import_no_jax_flax_reference_or_clients():
    """``pw.run(decode=)`` around engines behind ``DecodeService`` in every
    extension (cache and chunks, both drafts, sampling), then the xpack's
    question answerer over a document store: nothing of JAX or the
    reference, and no service client, is imported."""
    _run_probe(_DECODE_QA_PROBE)


def test_port_sources_and_chip_smoke_have_no_forbidden_imports():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        hits = _FORBIDDEN.findall(text) + _CLIENT_AT_LOAD.findall(text)
        assert not hits, (path, hits)


def test_entry_points_raise_without_a_card(monkeypatch):
    import pathway_tpu_torch as pt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: pt.resolve_device(None),
        lambda: pt.resolve_device("cuda"),
        lambda: pt.DeviceKnnIndex(dim=4),
        lambda: pt.SentenceEncoder(config=pt.EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=1,
                                                           num_heads=2, intermediate_size=64)),
        lambda: pt.CrossEncoderScorer(config=pt.EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=1,
                                                              num_heads=2, intermediate_size=64)),
        lambda: pt.DecodeEngine(pt.DecoderConfig(vocab_size=97, hidden_size=16, num_layers=1, num_heads=2,
                                                 intermediate_size=32, max_position=32)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert pt.resolve_device("cpu").type == "cpu"


def test_hf_pipeline_chat_runs_on_the_card_by_default(monkeypatch):
    """``HFPipelineChat`` hands the card to its pipeline unless the caller
    asks for the CPU, and raises, naming ``device='cpu'``, when there is no
    card. ``transformers`` is a fake here, so nothing is downloaded."""
    import types

    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat

    built = []

    class _Pipe:
        def __init__(self, task, model=None, device=None, **kw):
            built.append(device)
            self.tokenizer = None

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(pipeline=_Pipe))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HFPipelineChat(model="tiny")
    assert built == []
    HFPipelineChat(model="tiny", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    HFPipelineChat(model="tiny")
    assert built == [torch.device("cpu"), torch.device("cuda", 0)]


def test_cpu_tensors_never_launch_kernels_and_build_is_lazy(monkeypatch):
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_attention import masked_attention, segment_attention
    from pathway_tpu_torch.ops.fused_layer import gemm_bias_act
    from pathway_tpu_torch.ops.knn_topk import knn_topk
    from pathway_tpu_torch.ops.paged_attention import paged_decode_attention

    _build.reset_launches()
    masked_attention(torch.randn(2, 16, 96), torch.ones(2, 16, dtype=torch.bool), 2)
    segment_attention(torch.randn(2, 16, 96), torch.zeros(2, 16, dtype=torch.int32), 2)
    gemm_bias_act(torch.randn(4, 8), torch.randn(3, 8), torch.zeros(3))
    knn_topk(torch.randn(2, 8), torch.randn(30, 8), k=4)
    paged_decode_attention(torch.randn(2, 8), torch.randn(3, 4, 8), torch.randn(3, 4, 8),
                           torch.zeros(2, 2, dtype=torch.int32), torch.tensor([3, 0], dtype=torch.int32), n_heads=2)
    assert sum(_build.LAUNCHES.values()) == 0
    assert _build._LIBS == {}
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_every_kernel_source_names_its_tpu_counterpart():
    sources = {
        "gemm_epilogue.cu": "pathway_tpu/ops/fused_layer.py::fused_layer_tokens",
        "masked_attention.cu": "pathway_tpu/ops/fused_attention.py::_fused_call",
        "knn_topk.cu": "pathway_tpu/ops/pallas_knn.py::knn_topk",
        "segment_attention.cu": "pathway_tpu/ops/fused_attention.py::_packed_call",
        "paged_decode_attention.cu": "pathway_tpu/ops/paged_attention.py::paged_decode_attention",
    }
    from pathway_tpu_torch.ops import _build

    assert set(_build.SOURCES) == set(sources)
    for name, counterpart in sources.items():
        with open(os.path.join(PKG, "csrc", name), encoding="utf-8") as f:
            text = f.read()
        assert "Replaces" in text and counterpart in text, name


def test_every_csrc_file_is_a_built_source_or_a_header_one_includes():
    """A header is hashed into every library's cache key; each one in
    ``csrc/`` is included by a kernel source and names the kernels it
    serves, and nothing else sits there unbuilt. ``csrc/host/`` holds the
    host helpers' C++ source, built with g++ by ``native.py``, not nvcc."""
    from pathway_tpu_torch import native
    from pathway_tpu_torch.ops import _build

    csrc = os.path.join(PKG, "csrc")
    names = sorted(os.listdir(csrc))
    assert os.listdir(os.path.join(csrc, "host")) == [os.path.basename(native.SRC)]
    assert os.path.dirname(native.SRC) == os.path.join(csrc, "host")
    sources = {n: open(os.path.join(csrc, n), encoding="utf-8").read() for n in _build.SOURCES}
    for name in names:
        if name in _build.SOURCES or name == "host":
            continue
        assert name.endswith(".cuh"), name
        users = [s for s, text in sources.items() if f'#include "{name}"' in text]
        assert users, f"{name} is included by no kernel source"
        with open(os.path.join(csrc, name), encoding="utf-8") as f:
            head = f.read(2000)
        assert all(u in head for u in users), (name, users)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        with open(script, encoding="utf-8") as f:
            (tmp_path / "chip_smoke.py").write_text(f.read(), encoding="utf-8")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
