"""Guards of the PyTorch port: it imports nothing of JAX, flax or
pathway_tpu, also when its dataflow engine runs a ``pw.run`` pipeline
(``pw.io.python.read`` -> embedder -> ``DataIndex`` -> ``pw.io.subscribe``)
or serves the RAG document servers over a folder, or shards an index and
an encoder over a mesh of CPU devices, or runs the decode extensions under
``pw.run(decode=)`` through ``DecodeService`` and answers questions through
the xpack's question answerer, or serves a REST endpoint behind the
serving plane with every observability plane on (``tracing/``,
``freshness/``, the chip and HBM ledgers, the watchdog, ``/metrics`` and
``/status``), or grows and shrinks live indexes with the elastic plane
under ``pw.run(mesh="auto", elastic=)``, or runs as a 2-process cluster
through ``spawn --processes 2`` (the coordinator and the worker alike);
or reads object stores, Delta Lake, Airbyte and SharePoint through injected
clients, or runs windows, temporal joins, SQL, iterate fixpoints, row
transformers and live tables (and imports, with ``yaml`` hidden), or runs
the rest of the stdlib (graphs, sorting, the KNN classifier, async
transformers, ``viz``) and the demos; its public names are the reference's
but for those whose modules wait in a ROADMAP item; it never imports
``aiohttp`` or ``requests``, which the card's machine lacks (its webserver
is the standard library's), nor ``pydantic`` or ``yaml``, which that
machine lacks too, nor, with ``chip_smoke.py``'s import chain, ``pandas``
or ``bokeh``, which it lacks as well, and imports no
service client (``openai``, ``litellm``, ``cohere``, ``transformers``,
``flashrank``, ``boto3``, ``deltalake``, the Drive, ``fs``, ``office365``
and ``openparse`` clients) at module load; its entry points never fall back
to the CPU;
its kernels are built only at first use on a CUDA tensor;
``chip_smoke.py`` refuses to run without a card."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pathway_tpu_torch")

_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|pathway_tpu|aiohttp|requests|click)(?:\.|\s|$)", re.M)
# ``pydantic`` and ``yaml`` are not on the card's machine: the port imports
# them only where a call needs them (``openparse_utils.LLMArgs``, an Airbyte
# config file)
_FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pathway_tpu", "aiohttp", "requests", "pydantic", "yaml")
# service clients: imported only inside the function that calls them
_CLIENTS = ("openai", "litellm", "cohere", "transformers", "flashrank", "boto3", "botocore", "deltalake",
            "googleapiclient", "fs", "office365", "openparse", "pydantic", "yaml")
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


_PLANES_PROBE = r"""
import json, socket, sys, threading, time, urllib.request
before = set(sys.modules)
import pathway_tpu_torch as pw
from pathway_tpu_torch import freshness, tracing
from pathway_tpu_torch.freshness import report
from pathway_tpu_torch.internals import chip_ledger, flight_recorder, http_monitoring, ledger, monitoring
from pathway_tpu_torch.internals.graph_runner import GraphRunner
from pathway_tpu_torch.ops import index_metrics
def free():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
port, mport = free(), free()
q, writer = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=pw.schema_from_types(value=int),
                                      serving=pw.serving.ServingConfig(max_queue=8))
writer(q.select(result=pw.this.value + 1))
runners = []
real_init = GraphRunner.__init__
def recording_init(self, *a, **k):
    real_init(self, *a, **k)
    runners.append(self)
GraphRunner.__init__ = recording_init
out = {}
run = threading.Thread(target=lambda: out.update(r=pw.run(tracing=True, chip_ledger=True, freshness=True,
                                                          watchdog=True, with_http_server=True,
                                                          monitoring_http_port=mport)), daemon=True)
run.start()
for _ in range(400):
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=b'{"value": 41}',
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read()) == 42 and resp.headers["X-Pathway-Trace"]
        break
    except OSError:
        time.sleep(0.05)
with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=30) as resp:
    assert "pathway_serving_admitted_total" in resp.read().decode()
with urllib.request.urlopen(f"http://127.0.0.1:{mport}/status", timeout=30) as resp:
    assert "serving" in json.loads(resp.read())
runners[-1].engine.stop()
run.join(timeout=60)
assert out["r"].health is not None and out["r"].trace_dumps
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


def test_port_observability_planes_import_no_jax_flax_or_reference(tmp_path, monkeypatch):
    """``tracing/``, ``freshness/`` and every plane module imported, then a
    REST endpoint behind the serving plane under ``pw.run`` with every
    plane on, its ``/metrics`` and ``/status`` scraped: nothing of JAX or
    the reference, and no service client, is imported."""
    monkeypatch.setenv("PATHWAY_TRACE_DIR", str(tmp_path))
    _run_probe(_PLANES_PROBE)


_TIERS_PROFILE_PROBE = r"""
import json, os, subprocess, sys, tempfile
before = set(sys.modules)
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch import cli, perf, resilience, tenancy
from pathway_tpu_torch.engine import device_ring
from pathway_tpu_torch.internals import licensing, profiler, telemetry
from pathway_tpu_torch.ops import tiered_knn
from pathway_tpu_torch.perf import journal, snapshot, top
from pathway_tpu_torch.stdlib.ml.index import KNNIndex
tmp = tempfile.mkdtemp()
os.environ["PATHWAY_JOURNAL_DIR"] = os.path.join(tmp, "journal")
os.environ["PATHWAY_TELEMETRY_SERVER"] = os.path.join(tmp, "telemetry.jsonl")
vecs = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
docs = pw.debug.table_from_rows(pw.schema_from_types(i=int), [(i,) for i in range(40)])
docs = docs.select(docs.i, emb=pw.apply_with_type(lambda i: tuple(map(float, vecs[i])), pw.ANY, docs.i))
for kw in ({"tenant": "acme"}, {}):
    idx = KNNIndex(docs.emb, docs, n_dimensions=8, reserved_space=16, device="cpu", **kw)
    res = idx.get_nearest_items(docs.emb, k=1)
    pw.io.subscribe(res, lambda **_: None)
pw.run(index_tiers="hot=16,clusters=4,probe=4", tenancy={"quotas": {"acme": {"weight": 2}}},
       profile=os.path.join(tmp, "profile.json"), license_key="enterprise-x", tracing=True)
assert json.load(open(os.path.join(tmp, "profile.json")))["traceEvents"]
assert os.path.exists(os.path.join(tmp, "telemetry.jsonl")) and journal.get_journal().tail(1)
cli.main(["top", "--once", "--journal", os.environ["PATHWAY_JOURNAL_DIR"]])
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN + CLIENTS + ("click",))
print("BAD", bad)
"""


def test_port_tiers_tenancy_profiler_and_cli_import_no_jax_flax_reference_or_click(tmp_path, monkeypatch):
    """Every module of this slice imported, then a run with tiered and
    tenant indexes, the profiler, the journal, telemetry and a license, and
    the CLI's ``top``: nothing of JAX, the reference or ``click`` loads."""
    monkeypatch.setenv("PATHWAY_TRACE_DIR", str(tmp_path))
    _run_probe(_TIERS_PROFILE_PROBE)


_DURABLE_PROBE = r"""
import json, os, sys, tempfile, time
before = set(sys.modules)
import pathway_tpu_torch as pw
from pathway_tpu_torch import ingest, native, persistence
from pathway_tpu_torch.engine import persistence as engine_persistence, pipeline
from pathway_tpu_torch.parallel import sharded
from pathway_tpu_torch.resilience import chaos, cluster, retry, supervisor
tmp = tempfile.mkdtemp()
log = native.SnapshotLogWriter(os.path.join(tmp, "n.bin"), append=False)
log.append(1, 2, 3, b"x")
log.close()
assert list(native.SnapshotLogReader(os.path.join(tmp, "n.bin"))) == [(1, 2, 3, b"x")]
class S(pw.Schema):
    word: str
def run_once(out, rules):
    class Words(pw.io.python.ConnectorSubject):
        supports_offsets = True
        def run(self):
            for i in range(int(self.offsets.get("pos", 0)), 6):
                self.next_with_offset("pos", i + 1, word="abc"[i % 3])
                self.commit()
    t = pw.io.python.read(Words(), schema=S, autocommit_duration_ms=None, persistent_id="w")
    pw.io.jsonlines.write(t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count()), out)
    chaos.activate(rules)
    pw.run(persistence_config=persistence.Config.simple_config(persistence.Backend.filesystem(os.path.join(tmp, "p")),
                                                               snapshot_interval_ms=1),
           recovery=pw.Recovery(max_restarts=2, backoff=pw.RetryPolicy(first_delay_ms=1, jitter_ms=0)),
           pipeline_depth=2, ingest_workers=2)
    chaos.deactivate()
    pw.clear_graph()
run_once(os.path.join(tmp, "a.jsonl"), [{"site": "persistence.append_data", "hit": 3, "action": "raise"}])
run_once(os.path.join(tmp, "b.jsonl"), [])
ingest.shutdown_stage()
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN + CLIENTS + ("click",))
print("BAD", bad)
"""


def test_port_persistence_recovery_and_pipeline_import_no_jax_flax_reference_or_click():
    """The modules of persistence, recovery, the epoch pipeline and the
    ingest stage imported, then a persisted, supervised, pipelined run with
    the ingest stage through a chaos crash, and its restart from the
    snapshot: nothing of JAX, the reference or ``click`` loads."""
    _run_probe(_DURABLE_PROBE)


_ELASTIC_PROBE = r"""
import sys, tempfile, time
before = set(sys.modules)
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch import elastic
from pathway_tpu_torch.elastic import config, controller, metrics
from pathway_tpu_torch.engine.persistence import EnginePersistence
from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer
from pathway_tpu_torch.ops.tiered_knn import TieredKnnIndex
from pathway_tpu_torch.parallel.mesh import resolve_mesh, set_device_pool
from pathway_tpu_torch.tenancy import TenantPackedIndex
set_device_pool(["cpu"] * 4)
vecs = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
p = EnginePersistence(pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(tempfile.mkdtemp())))
flat = pw.DeviceKnnIndex(8, reserved_space=16, device="cpu")
flat.add_batch_arrays(list(range(64)), vecs)
tier = TieredKnnIndex(8, reserved_space=32, mesh=resolve_mesh(2, device="cpu"), tiers="clusters=4,probe=2")
tier.add_batch_arrays(list(range(64)), vecs)
packed = TenantPackedIndex(8, reserved_space=32, mesh=resolve_mesh(2, device="cpu"))
packed.add_tenant_batch("t", list(range(64)), vecs)
handles = [elastic.register_handle(i) for i in (flat, tier, packed)]
t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
def wait(**_):
    deadline = time.monotonic() + 60
    while any(h.index.n_shards != 4 for h in handles) and time.monotonic() < deadline:
        time.sleep(0.01)
pw.io.subscribe(t, wait)
pw.run(mesh="auto", elastic="shards=4,interval=0.01")
assert [h.index.n_shards for h in handles] == [4, 4, 4], [h.index.n_shards for h in handles]
assert "pathway_elastic_generation 1" in "\n".join(MonitoringHttpServer._elastic_lines())
assert p.cluster_generation() == 1 and p.reshard_intent() is None
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN + CLIENTS + ("click",))
print("BAD", bad)
"""


def test_port_elastic_plane_imports_no_jax_flax_reference_or_click():
    """The elastic modules imported, then a run with ``mesh="auto"`` over a
    pool of CPU devices whose controller reshards a flat, a tiered and a
    tenant-packed index to its target, its generation made durable:
    nothing of JAX, the reference or ``click`` loads."""
    _run_probe(_ELASTIC_PROBE)


_OBJECT_STORE_PROBE = r"""
import sys
before = set(sys.modules)
import pathway_tpu_torch as pw
import pathway_tpu_torch.xpacks.llm
from pathway_tpu_torch.io import _object_store, airbyte, deltalake, gdrive, minio, pyfilesystem, s3, s3_csv
from pathway_tpu_torch.xpacks.connectors import sharepoint
from pathway_tpu_torch.xpacks.llm import openparse_utils, parsers
assert "LLMArgs" in dir(openparse_utils) and parsers.OpenParse
class Drive:
    sizes = {"big": 10}
    def list_objects(self):
        return [("a", "v1"), ("big", "v1")]
    def get_object(self, key):
        return b"alpha\n" if key == "a" else b"x" * 10
rows = pw.debug.table_to_dicts(pw.io.gdrive.read("f", mode="static", format="binary", object_size_limit=8,
                                                 _client=Drive()))[1]["data"]
assert sorted(rows.values()) == [b"", b"alpha\n"], rows
pw.clear_graph()
class File:
    path, size, created_at, modified_at = "/s/a.txt", 3, 1, 2
    def read(self):
        return b"one"
pw.set_license_key("enterprise-probe")
t = pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="D", mode="static",
                                         _context_factory=lambda: type("Ctx", (), {"list_files": lambda s, r, rec: [File()]})())
assert list(pw.debug.table_to_dicts(t)[1]["data"].values()) == [b"one"]
pw.clear_graph()
class Delta:
    def version(self):
        return 1
    def to_pylist(self):
        return [{"k": "x"}]
t = pw.io.deltalake.read("/lake", schema=pw.schema_from_types(k=str), mode="static", _table=Delta())
assert list(pw.debug.table_to_dicts(t)[1]["k"].values()) == ["x"]
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN + CLIENTS)
print("BAD", bad)
"""


def test_port_object_stores_import_no_jax_flax_reference_pydantic_or_clients():
    """``io/_object_store.py``, the object stores, Delta Lake, Airbyte,
    ``xpacks.connectors.sharepoint`` and ``xpacks.llm.openparse_utils``
    imported, then a Drive read with a size limit, a SharePoint read and a
    Delta Lake read on injected clients: nothing of JAX, the reference,
    ``pydantic`` or ``yaml``, and no client package, is imported."""
    _run_probe(_OBJECT_STORE_PROBE)


_STDLIB_PROBE = r"""
import sys
before = set(sys.modules)
import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.temporal import _joins, _window, temporal_behavior, time_utils
from pathway_tpu_torch.stdlib import ordered, statistical, temporal
from pathway_tpu_torch.internals import (export_import, interactive, iterate, row_transformer, sql, universes,
                                         yaml_loader)
DOCS = '''
  | t  | c | v
1 | 1  | a | 1.0
2 | 70 | b |
3 | 75 | a | 3.0
'''
def docs():
    pw.clear_graph()
    return pw.debug.table_from_markdown(DOCS)
t = docs()
w = t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=60)).reduce(start=pw.this._pw_window_start,
                                                                        n=pw.reducers.count())
assert sorted(pw.debug.table_to_dicts(w)[1]["n"].values()) == [1, 2]
t = docs()
s = pw.sql("SELECT c, COUNT(*) AS n FROM docs GROUP BY c", docs=t)
assert sorted(pw.debug.table_to_dicts(s)[1]["n"].values()) == [1, 2]
t = docs()
a = t.filter(pw.this.c == "a")
j = t.asof_join(a, t.t, a.t).select(v=t.v)
assert len(pw.debug.table_to_dicts(j)[0]) == 3
t = docs()
assert len(pw.debug.table_to_dicts(t.diff(pw.this.t, pw.this.t))[0]) == 3
t = docs()
assert sorted(pw.debug.table_to_dicts(t.interpolate(pw.this.t, pw.this.v))[1]["v"].values()) == [1.0, 1 + 2 * 69 / 74,
                                                                                               3.0]
t = docs()
it = pw.iterate(lambda x: x.select(v=pw.if_else(pw.this.v < 9, pw.this.v + 1, pw.this.v)), x=t.select(v=pw.this.t))
assert sorted(pw.debug.table_to_dicts(it)[1]["v"].values()) == [9, 70, 75]
t = docs()
@pw.transformer
class doubled:
    class rows(pw.ClassArg):
        t = pw.input_attribute()
        @pw.output_attribute
        def twice(self):
            return self.t * 2
assert sorted(pw.debug.table_to_dicts(doubled(rows=t).rows)[1]["twice"].values()) == [2, 140, 150]
t = docs()
live = t.live()
pw.run()
assert len(live) == 3
t = docs()
exported = pw.export_table(t)
pw.clear_graph()
assert len(pw.debug.table_to_dicts(pw.import_table(exported))[0]) == 3
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN)
print("BAD", bad)
"""


def test_port_temporal_stdlib_and_internals_extras_import_no_jax_flax_reference_or_yaml():
    """The temporal, ordered and statistical stdlib and the ``internals``
    extras (iterate, row transformers, SQL, export / import, the YAML
    loader, live tables, universes) imported, then a window, a SQL view,
    an asof join, ``diff``, ``interpolate``, an iterate fixpoint, a
    transformer, a live table and an export / import run: nothing of JAX,
    the reference or ``yaml`` is imported."""
    _run_probe(_STDLIB_PROBE)


_YAML_HIDDEN_PROBE = r"""
import sys
sys.modules["yaml"] = None  # an import of yaml now raises ImportError
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import yaml_loader
assert pw.load_yaml is yaml_loader.load_yaml
try:
    pw.load_yaml("a: 1")
except ImportError as e:
    assert "PyYAML" in str(e), e
    print("RAISED")
"""


_STDLIB_REST_PROBE = r"""
import sys
before = set(sys.modules)
import pathway_tpu_torch as pw
from pathway_tpu_torch import _graph_hooks, demo
from pathway_tpu_torch.debug.demos import demo_programs, rag_chunks, windowed_stats, word_counts
from pathway_tpu_torch.stdlib import graphs, stateful, utils, viz
from pathway_tpu_torch.stdlib.graphs import louvain_communities
from pathway_tpu_torch.stdlib.indexing import sorting
from pathway_tpu_torch.stdlib.ml import classifiers, datasets, hmm, smart_table_ops, utils as ml_utils
from pathway_tpu_torch.stdlib.ml.datasets import classification
from pathway_tpu_torch.stdlib.utils import async_transformer, bucketing, col, filtering, pandas_transformer
from pathway_tpu_torch.stdlib.viz import plotting, table_viz
assert len(demo_programs()) == 3
pw.clear_graph()
train, test = classification.load_mnist_sample(200, synthetic=True)
model = classifiers.knn_lsh_classifier_train(train, d=784, device="cpu")
acc = ml_utils.classifier_accuracy(classifiers.knn_lsh_classify(model, train, test, k=3), test)
assert sum(pw.debug.table_to_dicts(acc)[1]["cnt"].values()) == 20
KV = '''
  | k | v
1 | a | 3
2 | a | 9
3 | b | 4
'''
pw.clear_graph()
t = pw.debug.table_from_markdown(KV)
best = filtering.argmax_rows(t, t.k, what=t.v)
srt = sorting.sort_from_index(sorting.build_sorted_index(t.select(key=pw.this.v))["index"])
assert sorted(pw.debug.table_to_dicts(best)[1]["v"].values()) == [4, 9]
assert len(pw.debug.table_to_dicts(srt)[0]) == 3
pw.clear_graph()
class Out(pw.Schema):
    w: int
class Twice(pw.AsyncTransformer, output_schema=Out):
    async def invoke(self, k, v):
        return {"w": 2 * v}
t = pw.debug.table_from_markdown(KV)
assert sorted(pw.debug.table_to_dicts(Twice(input_table=t).successful)[1]["w"].values()) == [6, 8, 18]
pw.clear_graph()
assert "<table" in pw.debug.table_from_markdown(KV).show()._repr_html_()
pw.clear_graph()
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN)
print("BAD", bad)
"""


def test_port_stdlib_rest_and_demos_import_no_jax_flax_or_reference():
    """The rest of the stdlib (graphs, stateful, sorting, ``utils``, ``viz``,
    the ``ml`` classifiers, datasets, HMM, fuzzy joins and utils),
    ``pw.demo``, the demo programs and ``_graph_hooks`` imported, then a
    classifier over the synthetic MNIST sample, ``argmax_rows``, a sorted
    index, an ``AsyncTransformer`` and ``Table.show`` run: nothing of JAX or
    the reference is imported."""
    _run_probe(_STDLIB_REST_PROBE)


_ANALYSIS_PROBE = r"""
import io, os, sys, tempfile
before = set(sys.modules)
import pathway_tpu_torch as pw
from pathway_tpu_torch import analysis
from pathway_tpu_torch.analysis import diagnostics, engine_rules, graph_view, program, rules
from pathway_tpu_torch.analysis.deep import exactly_once, host_sync, recompile, resharding, targets
from pathway_tpu_torch.internals.graph_runner import GraphRunner
SRC = '''
import torch
import pathway_tpu_torch as pw
def embed(x, y):
    return tuple(torch.tensor([x, y]).cpu().tolist())
docs = pw.debug.table_from_rows(pw.schema_from_types(x=float, y=float), [(1.0, 0.0)])
docs = docs.select(emb=pw.apply_with_type(embed, pw.ANY, docs.x, docs.y))
index = pw.stdlib.ml.index.KNNIndex(docs.emb, docs, n_dimensions=2, reserved_space=16)
pw.io.null.write(index.get_nearest_items(docs.emb, k=2))
pw.run(decode="pages=64,page=16", recovery=True)
'''
path = os.path.join(tempfile.mkdtemp(), "prog.py")
with open(path, "w") as f:
    f.write(SRC)
out = io.StringIO()
assert program.analyze_program(path, as_json=True, deep=True, out=out) == 0
assert "PWL017" in out.getvalue() and "PWL023" in out.getvalue(), out.getvalue()
pw.clear_graph()
t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
runner = GraphRunner(n_workers=1)
runner.lower(t.select(y=pw.this.x + 1))
runner.capture(t.select(pw.this.x))
assert any(d.rule == "PWL006" for d in analysis.analyze(engine=runner.engine))
pw.clear_graph()
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN)
print("BAD", bad)
"""


def test_port_verifier_imports_no_jax_flax_or_reference():
    """Every module of ``analysis/`` imported, then ``analyze_program``
    with the deep pass over a program with a device index, a torch staging
    UDF and the decode plane, and the engine-level rule over a lowered
    graph: nothing of JAX, flax or the reference is imported."""
    _run_probe(_ANALYSIS_PROBE)


_NO_PANDAS_PROBE = r"""
import importlib, re, sys
import numpy as np
sys.path.insert(0, ".")
before = set(sys.modules)
import pathway_tpu_torch as pw
at_import = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in ("pandas", "bokeh"))
import chip_smoke
src = open("chip_smoke.py", encoding="utf-8").read()
for mod, names in re.findall(r"from (pathway_tpu_torch[\w.]*) import \(?([\w, ]+)", src):
    m = importlib.import_module(mod)
    for name in (n.split(" as ")[0].strip() for n in names.split(",")):
        if name and not hasattr(m, name):
            importlib.import_module(f"{mod}.{name}")
for mod in re.findall(r"^\s*import (pathway_tpu_torch[\w.]*)", src, re.M):
    importlib.import_module(mod)
pw.clear_graph()
class S(pw.Schema):
    data: np.ndarray
    label: str
docs = pw.debug.table_from_rows(S, list(zip(np.eye(4), "abab")))
model = pw.ml.classifiers.knn_lsh_classifier_train(docs, d=4, device="cpu")
got = pw.debug.table_to_dicts(pw.ml.classifiers.knn_lsh_classify(model, docs, docs, k=1))[1]["predicted_label"]
assert sorted(got.values()) == ["a", "a", "b", "b"]
chain = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in ("pandas", "bokeh"))
print("AT_IMPORT", at_import)
print("CHAIN", chain)
"""


def test_port_and_chip_smoke_import_chain_load_no_pandas_or_bokeh():
    """The card's machine has neither ``pandas`` nor ``bokeh``: ``import
    pathway_tpu_torch``, ``chip_smoke.py`` with every port module it
    imports, and ``kafka_path``'s classifier (``pw.ml.classifiers`` over a
    ``KNNIndex``) load neither; ``pw.viz`` and ``debug.table_to_pandas``
    import ``pandas`` only when called."""
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS_PROBE], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "AT_IMPORT []" in out.stdout and "CHAIN []" in out.stdout, out.stdout


def test_port_imports_without_yaml_and_load_yaml_raises_only_when_called():
    """With ``yaml`` hidden, ``import pathway_tpu_torch`` and the module of
    ``pw.load_yaml`` load; a call of ``pw.load_yaml`` raises an
    ``ImportError`` that names PyYAML."""
    out = subprocess.run([sys.executable, "-c", _YAML_HIDDEN_PROBE], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RAISED" in out.stdout, out.stdout


def test_elastic_reshard_on_the_card_never_lands_on_the_cpu(monkeypatch):
    """A reshard of an index on the card resolves its target on the cards
    (or the device pool) and raises, before touching anything, when fewer
    are visible: it never falls back to the CPU."""
    from pathway_tpu_torch.elastic import controller
    from pathway_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card_index = type("CardIndex", (), {"device": torch.device("cuda", 0)})()
    with pytest.raises(ValueError, match="needs 2 visible CUDA cards, found 1"):
        controller._resolve_target_mesh(2, card_index)
    prev = tmesh.set_device_pool(["cuda:0"] * 2)
    try:
        assert controller._resolve_target_mesh(2, card_index).data_devices() == [torch.device("cuda", 0)] * 2
        with pytest.raises(ValueError, match="device pool holds 2"):
            controller._resolve_target_mesh(4, card_index)
    finally:
        tmesh.set_device_pool(prev)
    cpu_index = type("CpuIndex", (), {"device": torch.device("cpu")})()
    assert controller._resolve_target_mesh(2, cpu_index).data_devices() == [torch.device("cpu")] * 2


def test_cli_help_loads_no_jax_flax_reference_or_click():
    """``python -m pathway_tpu_torch --help`` runs on argparse alone."""
    probe = (
        "import runpy, sys\nsys.argv = ['pathway_tpu_torch', '--help']\n"
        "try:\n    runpy.run_module('pathway_tpu_torch', run_name='__main__')\nexcept SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('click',))\nprint('BAD', bad)\n"
    )
    _run_probe(probe)


def test_slice_entry_points_raise_without_a_card(monkeypatch):
    """The tenant slab, the tiered index and the staging ring run on the
    card unless given the CPU, and raise without one."""
    from pathway_tpu_torch.engine.device_ring import DeviceRing
    from pathway_tpu_torch.ops.tiered_knn import TieredKnnIndex
    from pathway_tpu_torch.tenancy import TenantPackedIndex, shared_slab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TenantPackedIndex(4), lambda: shared_slab(4), lambda: TieredKnnIndex(4),
                 lambda: DeviceRing()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


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


_CLUSTER_PROBE = r"""
import json, os, sys
before = set(sys.modules)
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.io._connector import input_table_from_reader

class S(pw.Schema):
    word: str

def reader(ctx):
    for i in range(40):
        if i % ctx.n_processes == ctx.process_id:
            ctx.insert({"word": ["cat", "dog"][i % 2]}, offsets={"pos": i + 1})
    ctx.commit()

t = input_table_from_reader(S, reader, name="guard_src", parallel_readers=True, persistent_id="g",
                            supports_offsets=True, autocommit_duration_ms=50)
c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
pw.io.jsonlines.write(c, os.environ["GUARD_OUT"] + ".out")
pw.run(monitoring_level="none", cluster_lease_ms=3000, persistence_config=pw.persistence.Config.simple_config(
    pw.persistence.Backend.filesystem(os.environ["GUARD_OUT"] + ".store")))
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in FORBIDDEN + ("click",))
with open(os.environ["GUARD_OUT"] + "." + os.environ["PATHWAY_PROCESS_ID"], "w") as f:
    json.dump({"bad": bad, "cluster": "pathway_tpu_torch.parallel.multiprocess" in sys.modules}, f)
"""


def test_spawned_cluster_processes_import_no_jax_flax_reference_or_click(tmp_path):
    """``python -m pathway_tpu_torch spawn --processes 2`` runs a persisted,
    partitioned program as a coordinator and a worker: neither process
    imports anything of JAX, flax, the reference or ``click``."""
    import socket

    prog = tmp_path / "guard_cluster.py"
    prog.write_text(f"FORBIDDEN = {_FORBIDDEN_MODULES!r}\n" + _CLUSTER_PROBE)
    out = str(tmp_path / "guard")
    for attempt in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_")}
        env.update(GUARD_OUT=out, CUDA_VISIBLE_DEVICES="")
        r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "spawn", "--processes", "2", "--first-port",
                            str(port), str(prog)], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        if r.returncode == 0 or attempt == 2 or "ddress already in use" not in r.stderr:
            break
    assert r.returncode == 0, r.stderr[-3000:]
    for pid in (0, 1):
        with open(f"{out}.{pid}") as f:
            got = json.load(f)
        assert got == {"bad": [], "cluster": True}, (pid, got)


def _kind(obj) -> str:
    import inspect
    import types

    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return "value"


# the reference's ``models`` names it exports lazily, beside its ``__all__``
_LAZY_MODEL_NAMES = ("ContrastiveTrainer", "info_nce_loss", "CLIPEncoder", "CLIPConfig")


def _public_classes(mod) -> set:
    """The classes a module without ``__all__`` defines (not those it imports)."""
    import inspect

    return {n for n, v in vars(mod).items() if not n.startswith("_") and inspect.isclass(v)
            and v.__module__ == mod.__name__}


def _check_public_names():
    import pathway_tpu as jpw
    import pathway_tpu.io as jio
    import pathway_tpu.io.http as jhttp
    import pathway_tpu.models as jmodels
    import pathway_tpu.serving as jserving
    import pathway_tpu.xpacks as jxpacks
    import pathway_tpu.xpacks.connectors as jconnectors
    import pathway_tpu.xpacks.connectors.sharepoint as jsharepoint
    import pathway_tpu.xpacks.llm.embedders as jembedders
    import pathway_tpu.xpacks.llm.openparse_utils as jopenparse
    import pathway_tpu.xpacks.llm.parsers as jparsers
    import pathway_tpu_torch as tpw
    import pathway_tpu_torch.io as tio
    import pathway_tpu_torch.io.http as thttp
    import pathway_tpu_torch.models as tmodels
    import pathway_tpu_torch.serving as tserving
    import pathway_tpu_torch.xpacks as txpacks
    import pathway_tpu_torch.xpacks.connectors as tconnectors
    import pathway_tpu_torch.xpacks.connectors.sharepoint as tsharepoint
    import pathway_tpu_torch.xpacks.llm.embedders as tembedders
    import pathway_tpu_torch.xpacks.llm.openparse_utils as topenparse
    import pathway_tpu_torch.xpacks.llm.parsers as tparsers

    assert set(tpw.__all__) >= set(jpw.__all__)
    assert tio.__all__ == jio.__all__
    for sub in ("stdlib", "ml", "indexing"):
        assert getattr(tpw, sub).__all__ == getattr(jpw, sub).__all__, sub
    assert _public_classes(tembedders) == _public_classes(jembedders)
    for name in _public_classes(jembedders):
        assert issubclass(getattr(tembedders, name), tembedders.BaseEmbedder) == issubclass(
            getattr(jembedders, name), jembedders.BaseEmbedder), name
    assert set(topenparse.__all__) == set(jopenparse.__all__) and set(dir(topenparse)) >= set(jopenparse.__all__)
    assert tparsers.__all__ == jparsers.__all__ and _public_classes(tsharepoint) == _public_classes(jsharepoint)
    for jmod, tmod in ((jpw, tpw), (jmodels, tmodels), (jserving, tserving), (jhttp, thttp), (jio, tio),
                       (jxpacks, txpacks), (jconnectors, tconnectors), (jsharepoint, tsharepoint),
                       (jparsers, tparsers)):
        missing = sorted(n for n in jmod.__all__ if n not in tmod.__all__)
        assert not missing, (tmod.__name__, missing)
        for name in jmod.__all__:
            assert hasattr(tmod, name), (tmod.__name__, name)
            assert _kind(getattr(tmod, name)) == _kind(getattr(jmod, name)), (tmod.__name__, name)
    for name in _LAZY_MODEL_NAMES:
        assert name in tmodels.__all__ and _kind(getattr(tmodels, name)) == _kind(getattr(jmodels, name)), name
    # Python binds an imported subpackage on its parent; the port's host
    # helpers (``pathway_tpu_torch/utils/``) load before the stdlib ``utils``
    # that the name exports, so importing them later does not rebind it
    assert tpw.utils is sys.modules["pathway_tpu_torch.stdlib.utils"]


def test_public_names_match_the_reference():
    """Every name of the reference's ``__all__`` is in the port's, of the
    same kind (module, class, function or value), ``analysis`` included; the
    ``models``, ``serving``, ``io``, ``io.http``, ``xpacks``,
    ``xpacks.connectors`` (``sharepoint.read``) and ``xpacks.llm.parsers``
    packages export what the reference's do (``io`` exactly, the object
    stores included), ``xpacks.llm.openparse_utils`` names the reference's
    lazy names, and ``xpacks.llm.embedders`` defines the reference's
    embedder classes."""
    _check_public_names()
    from pathway_tpu_torch.native import NativeStore

    store = NativeStore()
    store[7] = {"a": 1}
    assert (len(store), store[7], store.pop(7), len(store)) == (1, {"a": 1}, {"a": 1}, 0)


def test_public_names_hold_after_the_host_helpers_are_imported():
    """The same check once ``pathway_tpu_torch.utils.uri`` is imported (the
    engine's persistence and the graph runner import the host helpers
    lazily, so an earlier test file on the same worker may have): ``pw.utils``
    is still the stdlib ``utils`` that ``__all__`` exports, not the host
    helpers' subpackage."""
    import pathway_tpu_torch as tpw
    import pathway_tpu_torch.utils.uri  # noqa: F401

    assert tpw.utils is sys.modules["pathway_tpu_torch.stdlib.utils"] and "utils" in tpw.__all__
    assert sys.modules["pathway_tpu_torch.utils"] is not tpw.utils
    _check_public_names()
