"""pathway_tpu_torch: the PyTorch/CUDA port of pathway_tpu.

A live dataflow framework whose device layer runs hand-written Hopper
kernels. Its users write the reference's surface:

    import pathway_tpu_torch as pw

    docs = pw.io.python.read(subject, schema=DocSchema)
    embedder = pw.xpacks.llm.embedders.SentenceTransformerEmbedder()
    index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(docs.text, dimensions=384, embedder=embedder))
    answers = index.query_as_of_now(queries.text, number_of_matches=10)
    pw.io.subscribe(answers, on_change)
    pw.run()

and the README's RAG document server:

    docs = pw.io.fs.read("./docs", format="binary", mode="streaming", with_metadata=True)
    server = pw.xpacks.llm.VectorStoreServer(
        docs,
        embedder=pw.xpacks.llm.embedders.SentenceTransformerEmbedder("all-MiniLM-L6-v2"),
        parser=pw.xpacks.llm.parsers.ParseUtf8(),
        splitter=pw.xpacks.llm.splitters.TokenCountSplitter(),
    )
    server.run_server(host="0.0.0.0", port=8765)  # POST /v1/retrieve

The engine (``engine/``, ``internals/``, ``io/``, ``debug``,
``reducers``) is host Python with C++ helpers (``native.py``: update
consolidation, row hashing, the batched WordPiece tokenizer). The device
path: host tokenizer -> ``SentenceEncoder`` (MiniLM-L6 encoder whose
layers run as hand-written Hopper kernels, with sequence-packed ingest
for long-tailed batches) -> ``DeviceKnnIndex`` (a device-resident slab
searched by a fused top-k kernel). The RAG answer plane builds on it:
``CrossEncoderScorer`` / ``DeviceReranker`` rerank, ``FusedRagPipeline``
runs embed -> retrieve -> rerank -> generate without a host round trip,
and ``DecodeEngine`` generates with continuous batching over a paged KV
pool. The REST endpoints (``io/http``) run on the standard library's
HTTP server. Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``. The package imports torch and numpy only.
"""

import datetime as _datetime

from . import debug, io, reducers, serving, stdlib, xpacks
from .decode import DecodeConfig, DecodeEngine, DecoderConfig
from .device import resolve_device
from .engine.value import Json, Pointer, PyObjectWrapper, ref_scalar, unsafe_make_pointer, wrap_py_object
from .internals import dtype as dt
from .internals import udfs
from .internals.dtype import ANY, BOOL, BYTES, DATE_TIME_NAIVE, DATE_TIME_UTC, DURATION, FLOAT, INT, STR
from .internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_fully_async,
    apply_with_type,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from .internals.parse_graph import G as parse_graph
from .internals.parse_graph import clear_graph
from .internals.run import RunResult, run, run_all
from .internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_builder,
    schema_from_dict,
    schema_from_types,
)
from .internals.table import GroupedTable, JoinMode, JoinResult, Table
from .internals.thisclass import left, right, this
from .internals.udfs import UDF, udf
from .models.encoder import EncoderConfig
from .models.reranker import DeviceReranker, as_reranker
from .models.sentence_encoder import CrossEncoderScorer, SentenceEncoder
from .ops.fused_rag import FusedRagPipeline
from .ops.knn import DeviceKnnIndex
from .stdlib import indexing, ml

DateTimeNaive = _datetime.datetime
DateTimeUtc = _datetime.datetime
Duration = _datetime.timedelta

__all__ = [
    "ANY",
    "BOOL",
    "BYTES",
    "ColumnDefinition",
    "ColumnExpression",
    "ColumnReference",
    "CrossEncoderScorer",
    "DATE_TIME_NAIVE",
    "DATE_TIME_UTC",
    "DURATION",
    "DateTimeNaive",
    "DateTimeUtc",
    "DecodeConfig",
    "DecodeEngine",
    "DecoderConfig",
    "DeviceKnnIndex",
    "DeviceReranker",
    "Duration",
    "EncoderConfig",
    "FLOAT",
    "FusedRagPipeline",
    "GroupedTable",
    "INT",
    "JoinMode",
    "JoinResult",
    "Json",
    "Pointer",
    "PyObjectWrapper",
    "RunResult",
    "STR",
    "Schema",
    "SentenceEncoder",
    "Table",
    "UDF",
    "apply",
    "apply_async",
    "apply_fully_async",
    "apply_with_type",
    "as_reranker",
    "cast",
    "clear_graph",
    "coalesce",
    "column_definition",
    "debug",
    "declare_type",
    "dt",
    "fill_error",
    "if_else",
    "indexing",
    "io",
    "left",
    "make_tuple",
    "ml",
    "parse_graph",
    "reducers",
    "ref_scalar",
    "require",
    "resolve_device",
    "right",
    "run",
    "run_all",
    "schema_builder",
    "schema_from_dict",
    "schema_from_types",
    "serving",
    "stdlib",
    "this",
    "udf",
    "udfs",
    "unsafe_make_pointer",
    "unwrap",
    "wrap_py_object",
    "xpacks",
]
