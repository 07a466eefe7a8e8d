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
HTTP server, behind the serving plane with ``serving=``. The observability
planes (``tracing``, ``freshness``, the chip-time and HBM ledgers with the
health watchdog, the flight recorder, ``/metrics`` and ``/status``) turn on
with ``pw.run(tracing=, chip_ledger=, freshness=, watchdog=,
with_http_server=)``; the run profiler, the metrics journal and the OTLP
exporter with ``profile=``, ``PATHWAY_JOURNAL_DIR`` and
``PATHWAY_TELEMETRY_SERVER``. Many tenants share one packed slab
(``tenancy``, ``pw.run(tenancy=)``), a tiered index keeps a corpus
larger than the card (``pw.run(index_tiers=)``), and the elastic plane
grows and shrinks a live index's mesh under traffic (``pw.elastic``,
``pw.run(elastic=, mesh="auto")``). Event-time windows and temporal joins
(``pw.temporal``), ``pw.sql``, ``pw.iterate`` and row transformers run on
the engine as the reference's do, and so does the rest of the stdlib:
graphs, sorted indexes, ``pw.utils`` (``AsyncTransformer``, ``unpack_col``),
the ``pw.ml`` classifiers (on the device index), fuzzy joins and HMMs,
``pw.viz`` (``Table.show`` / ``Table.plot``) and ``pw.demo``'s streams.
``pw.analysis`` verifies a graph before it runs (``pw.run(analysis=)``,
``python -m pathway_tpu_torch analyze [--deep]``). ``python -m
pathway_tpu_torch`` is the command line. Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``. The package imports torch and
numpy only.
"""

import datetime as _datetime

from . import (debug, decode, demo, elastic, engine, freshness, io, persistence, reducers, resilience, serving, stdlib,
               tenancy, tracing, xpacks)
from .decode import DecodeConfig, DecodeEngine, DecoderConfig
from .device import resolve_device
from .elastic import ElasticConfig
from .engine.value import Json, Pointer, PyObjectWrapper, ref_scalar, unsafe_make_pointer, wrap_py_object
from .internals import dtype as dt
from .internals import udfs
from .internals import udfs as asynchronous
from .internals import universes
from .internals.config import pathway_config, set_license_key, set_monitoring_config
from .internals.custom_reducers import BaseCustomAccumulator
from .internals.dtype import ANY, BOOL, BYTES, DATE_TIME_NAIVE, DATE_TIME_UTC, DURATION, FLOAT, INT, STR
from .internals.export_import import ExportedTable, export_table, import_table
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
from .internals.interactive import LiveTable
from .internals.iterate import iterate, iterate_universe
from .internals.licensing import License, LicenseError
from .internals.monitoring import MonitoringLevel
from .internals.parse_graph import G as parse_graph
from .internals.parse_graph import clear_graph
from .internals.row_transformer import ClassArg, attribute, input_attribute, method, output_attribute, transformer
from .internals.run import RunResult, run, run_all
from .internals.schema import (
    ColumnDefinition,
    Schema,
    SchemaProperties,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from .internals.sql import sql
from .internals.table import GroupedTable, JoinMode, JoinResult, Table
from .internals.table_slice import TableSlice
from .internals.telemetry import Telemetry
from .internals.thisclass import left, right, this
from .internals.udfs import UDF, UDFAsync, UDFSync, udf, udf_async
from .internals.yaml_loader import load_yaml
from .models.encoder import EncoderConfig
from .models.reranker import DeviceReranker, as_reranker
from .models.sentence_encoder import CrossEncoderScorer, SentenceEncoder
from .ops.fused_rag import FusedRagPipeline
from .ops.knn import DeviceKnnIndex
from .resilience import Recovery, RecoveryEscalated, RetryPolicy
from .serving import ServingConfig
# ``pw.utils`` is the stdlib package, as in the reference's ``__all__``; the
# engine's host helpers (``pathway_tpu_torch/utils/``) load before it, so a
# later import of them does not rebind the name
from . import utils as _host_helpers  # noqa: F401
from .stdlib import graphs, indexing, ml, ordered, statistical, stateful, temporal, utils, viz
from .stdlib import temporal as window
from . import analysis  # pw.analysis.analyze / suppress (the pre-run verifier)
from .stdlib.utils.async_transformer import AsyncTransformer
from .stdlib.utils.col import unpack_col
from .stdlib.utils.pandas_transformer import pandas_transformer
from .tenancy import TenancyConfig, TenantQuotas

DateTimeNaive = _datetime.datetime
DateTimeUtc = _datetime.datetime
Duration = _datetime.timedelta

# the reference's type aliases (upstream ``pathway/__init__.py``)
Type = dt.DType
TableLike = Joinable = Table
GroupedJoinResult = GroupedTable
AsofJoinResult = IntervalJoinResult = OuterJoinResult = WindowJoinResult = JoinResult


class PersistenceMode:
    """Upstream ``api.PersistenceMode`` names; the engine takes the same
    values as ``persistence_config.persistence_mode`` strings."""

    BATCH = "batch"
    PERSISTING = "persisting"
    OPERATOR_PERSISTING = "operator_persisting"
    SPEEDRUN_REPLAY = "speedrun_replay"


def assert_table_has_schema(table, schema, *, allow_superset: bool = True, ignore_primary_keys: bool = True) -> None:
    """Check at run time that ``table`` has the columns of ``schema`` with
    their dtypes (``ANY`` on either side passes: inference may widen)."""
    want = schema.dtypes()
    have = {n: c.dtype for n, c in table._columns.items()}
    missing = [n for n in want if n not in have]
    if missing:
        raise AssertionError(f"table lacks columns {missing}; has {list(have)}")
    if not allow_superset and set(have) != set(want):
        raise AssertionError(f"table has extra columns {sorted(set(have) - set(want))}")
    for n, wt in want.items():
        ht = have[n]
        if wt is ANY or ht is ANY:
            continue
        if dt.unoptionalize(ht) is not dt.unoptionalize(wt) and ht != wt:
            raise AssertionError(f"column {n!r} has dtype {ht}, schema wants {wt}")


def table_transformer(func=None, **kw):
    """Decorator of upstream Pathway; its run-time type check is advisory,
    so the function is returned as it is."""
    if func is None:
        return lambda f: f
    return func


def enable_interactive_mode() -> None:
    """Accepted as the reference accepts it: nothing to switch on."""


def join(left, other, *on, **kw):
    return left.join(other, *on, **kw)


def join_inner(left, other, *on, **kw):
    return left.join(other, *on, **kw)


def join_left(left, other, *on, **kw):
    return left.join_left(other, *on, **kw)


def join_right(left, other, *on, **kw):
    return left.join_right(other, *on, **kw)


def join_outer(left, other, *on, **kw):
    return left.join_outer(other, *on, **kw)


def groupby(table, *args, **kw):
    return table.groupby(*args, **kw)

__all__ = [
    "ANY",
    "analysis",
    "ClassArg",
    "LiveTable",
    "attribute",
    "input_attribute",
    "iterate",
    "iterate_universe",
    "load_yaml",
    "method",
    "output_attribute",
    "sql",
    "temporal",
    "transformer",
    "universes",
    "window",
    "AsyncTransformer",
    "demo",
    "unpack_col",
    "utils",
    "viz",
    "AsofJoinResult",
    "BaseCustomAccumulator",
    "GroupedJoinResult",
    "IntervalJoinResult",
    "Joinable",
    "MonitoringLevel",
    "OuterJoinResult",
    "SchemaProperties",
    "ServingConfig",
    "TableLike",
    "TableSlice",
    "Type",
    "UDFAsync",
    "UDFSync",
    "WindowJoinResult",
    "assert_table_has_schema",
    "asynchronous",
    "decode",
    "enable_interactive_mode",
    "engine",
    "groupby",
    "join",
    "join_inner",
    "join_left",
    "join_outer",
    "join_right",
    "pathway_config",
    "schema_from_csv",
    "schema_from_pandas",
    "set_license_key",
    "set_monitoring_config",
    "table_transformer",
    "udf_async",
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
    "ElasticConfig",
    "EncoderConfig",
    "FLOAT",
    "FusedRagPipeline",
    "GroupedTable",
    "INT",
    "JoinMode",
    "JoinResult",
    "Json",
    "License",
    "LicenseError",
    "Pointer",
    "PyObjectWrapper",
    "RunResult",
    "STR",
    "Schema",
    "SentenceEncoder",
    "Table",
    "Telemetry",
    "TenancyConfig",
    "TenantQuotas",
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
    "elastic",
    "fill_error",
    "freshness",
    "if_else",
    "indexing",
    "io",
    "left",
    "make_tuple",
    "ml",
    "parse_graph",
    "persistence",
    "PersistenceMode",
    "Recovery",
    "RecoveryEscalated",
    "RetryPolicy",
    "reducers",
    "ref_scalar",
    "require",
    "resilience",
    "resolve_device",
    "right",
    "run",
    "run_all",
    "schema_builder",
    "schema_from_dict",
    "schema_from_types",
    "serving",
    "stdlib",
    "tenancy",
    "this",
    "tracing",
    "udf",
    "udfs",
    "unsafe_make_pointer",
    "unwrap",
    "wrap_py_object",
    "xpacks",
]
