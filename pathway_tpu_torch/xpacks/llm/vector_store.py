"""VectorStoreServer / VectorStoreClient.

The port's copy of the reference's ``xpacks/llm/vector_store.py``
(upstream Pathway's python/pathway/xpacks/llm/vector_store.py:
VectorStoreServer :39, _build_graph :227, statistics_query :321,
inputs_query :388, retrieve_query :440, run_server :478,
VectorStoreClient :651). Pipeline: docs → parse → post-process → split →
embed (the port's encoder, kernel B1 on the card) → device KNN index
(top-k kernel B2); queries arrive via the REST connector and are answered
as of now. An embedder with ``encode_device`` feeds the index from the
card, with no host round trip.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Iterable

import numpy as np

from ... import reducers
from ...engine.value import Json
from ...internals import udfs
from ...internals.expression import coalesce
from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from ...internals.thisclass import this
from ...internals.udfs import UDF, udf
from ...stdlib.indexing.colnames import _SCORE
from ...stdlib.indexing.data_index import DataIndex
from ...stdlib.indexing.vector_document_index import (
    default_usearch_knn_document_index,
)
from ._utils import _coerce_sync, _unwrap_udf, coerce_async
from .parsers import ParseUtf8
from .splitters import null_splitter

logger = logging.getLogger(__name__)


def _as_batch_embedder(embedder) -> Callable[[list[str]], list[np.ndarray]]:
    """Adapt a UDF / plain callable embedder into texts->vectors,
    preserving UDF executor and cache policies."""
    if isinstance(embedder, UDF):
        return udfs.as_batch_callable(embedder)

    fn = _coerce_sync(embedder)

    def run_one_by_one(texts: list[str]):
        return [fn(t) for t in texts]

    return run_one_by_one


class VectorStoreServer:
    """Builds and serves a live document vector index."""

    def __init__(
        self,
        *docs: Table,
        embedder: UDF | Callable,
        parser: UDF | Callable | None = None,
        splitter: UDF | Callable | None = None,
        doc_post_processors: list[Callable] | None = None,
        index_factory=None,
    ):
        self.docs = list(docs)
        self.embedder = embedder
        self.parser = parser or ParseUtf8()
        self.splitter = splitter or null_splitter
        self.doc_post_processors = [
            _unwrap_udf(p) for p in (doc_post_processors or []) if p is not None
        ]
        self.index_factory = index_factory

        self._batch_embed = _as_batch_embedder(embedder)
        self.embedding_dimension = self._autodetect_dimension()
        logger.debug("embedder dimension: %d", self.embedding_dimension)
        self._graph = self._build_graph()

    def _autodetect_dimension(self) -> int:
        if isinstance(self.embedder, UDF) and hasattr(
            self.embedder, "get_embedding_dimension"
        ):
            try:
                return int(self.embedder.get_embedding_dimension())
            except Exception:  # fall through to probe
                pass
        vecs = self._batch_embed(["."])
        return len(np.asarray(vecs[0]).reshape(-1))

    # -- adapters (reference :93-206) --

    @classmethod
    def from_langchain_components(
        cls, *docs, embedder, parser=None, splitter=None, **kwargs
    ):
        """Build from LangChain embedder/splitter objects."""
        try:
            from langchain_core.documents import Document
        except ImportError as e:  # pragma: no cover
            raise ImportError("from_langchain_components requires langchain") from e

        generic_splitter = None
        if splitter is not None:
            generic_splitter = lambda x: [  # noqa: E731
                (doc.page_content, doc.metadata)
                for doc in splitter.split_documents([Document(page_content=x)])
            ]

        async def generic_embedder(x: str):
            res = await coerce_async(embedder.aembed_query)(x)
            return np.asarray(res)

        return cls(
            *docs,
            embedder=udf(generic_embedder),
            parser=parser,
            splitter=generic_splitter,
            **kwargs,
        )

    @classmethod
    def from_llamaindex_components(cls, *docs, transformations, parser=None, **kwargs):
        """Build from a LlamaIndex transformation pipeline whose last
        stage is an embedder."""
        try:
            from llama_index.core.ingestion.pipeline import run_transformations
            from llama_index.core.schema import BaseNode, MetadataMode, TextNode
        except ImportError as e:  # pragma: no cover
            raise ImportError("from_llamaindex_components requires llama-index") from e

        try:
            from llama_index.core.base.embeddings.base import BaseEmbedding
        except ImportError:  # pragma: no cover
            BaseEmbedding = None

        if not transformations:
            raise ValueError("transformations list cannot be empty")
        if BaseEmbedding is not None and not isinstance(
            transformations[-1], BaseEmbedding
        ):
            raise ValueError("last transformation must be an embedder")
        embedder_obj = transformations.pop()

        async def embedding_callable(x: str):
            embedding = await embedder_obj.aget_text_embedding(x)
            return np.asarray(embedding)

        def generic_transformer(x: str):
            starting_node = TextNode(text=x)
            final_nodes: list[BaseNode] = run_transformations(
                [starting_node], transformations
            )
            return [
                (node.get_content(metadata_mode=MetadataMode.NONE), node.metadata or {})
                for node in final_nodes
            ]

        return cls(
            *docs,
            embedder=udf(embedding_callable),
            parser=parser,
            splitter=generic_transformer,
            **kwargs,
        )

    def _clean_tables(self, docs: Iterable[Table]) -> list[Table]:
        out = []
        for table in docs:
            names = table.column_names()
            if "_metadata" not in names:
                table = table.with_columns(_metadata=Json({}))
            out.append(table.select(this.data, this._metadata))
        return out

    def _build_graph(self) -> dict:
        docs_s = self.docs
        if not docs_s:
            raise ValueError(
                "provide at least one data source, e.g. "
                "pw.io.fs.read('./docs', format='binary', mode='static', "
                "with_metadata=True)"
            )
        docs_s = self._clean_tables(docs_s)
        if len(docs_s) == 1:
            (docs,) = docs_s
        else:
            docs = docs_s[0].concat_reindex(*docs_s[1:])

        parser = self.parser
        parse_fn = coerce_async(parser)

        @udf
        async def parse_doc(data, metadata) -> list[Json]:
            rets = await parse_fn(data)
            meta = metadata.value if isinstance(metadata, Json) else (metadata or {})
            return [Json(dict(text=text, metadata={**meta, **m})) for text, m in rets]

        parsed_docs = docs.select(data=parse_doc(docs.data, docs._metadata)).flatten(
            this.data
        )

        post_processors = self.doc_post_processors

        @udf
        def post_proc_docs(data_json: Json) -> Json:
            data = data_json.value if isinstance(data_json, Json) else data_json
            text, metadata = data["text"], data["metadata"]
            for processor in post_processors:
                text, metadata = processor(text, metadata)
            return Json(dict(text=text, metadata=metadata))

        parsed_docs = parsed_docs.select(data=post_proc_docs(this.data))

        splitter = self.splitter
        split_fn = _coerce_sync(_unwrap_udf(splitter))

        @udf
        def split_doc(data_json: Json) -> list[Json]:
            data = data_json.value if isinstance(data_json, Json) else data_json
            text, metadata = data["text"], data["metadata"]
            rets = split_fn(text)
            return [
                Json(dict(text=text_chunk, metadata={**metadata, **m}))
                for text_chunk, m in rets
            ]

        chunked_docs = parsed_docs.select(data=split_doc(this.data)).flatten(this.data)
        chunked_docs = chunked_docs + chunked_docs.select(
            text=this.data["text"].as_str()
        )

        if self.index_factory is not None:
            factory = self.index_factory
            knn_index = factory.build_index(
                chunked_docs.text,
                chunked_docs,
                metadata_column=chunked_docs.data["metadata"],
            )
        else:
            # hand the index the original embedder object (not the
            # batch-callable adapter) so the factory can detect
            # encode_device and keep ingest embeddings on the device
            knn_index = default_usearch_knn_document_index(
                chunked_docs.text,
                chunked_docs,
                dimensions=self.embedding_dimension,
                metadata_column=chunked_docs.data["metadata"],
                embedder=self.embedder
                if hasattr(self.embedder, "encode_device")
                else self._batch_embed,
            )

        parsed_docs_stats = parsed_docs + parsed_docs.select(
            modified=this.data["metadata"]["modified_at"].as_int(),
            indexed=this.data["metadata"]["seen_at"].as_int(),
            path=this.data["metadata"]["path"].as_str(),
        )

        stats = parsed_docs_stats.reduce(
            count=reducers.count(),
            last_modified=reducers.max(this.modified),
            last_indexed=reducers.max(this.indexed),
            paths=reducers.tuple(this.path),
        )
        return {
            "docs": docs,
            "parsed_docs": parsed_docs,
            "chunked_docs": chunked_docs,
            "knn_index": knn_index,
            "stats": stats,
        }

    # -- query schemas (reference :311-440) --

    class StatisticsQuerySchema(Schema):
        pass

    class QueryResultSchema(Schema):
        result: Json

    class InputResultSchema(Schema):
        result: list

    class FilterSchema(Schema):
        metadata_filter: str | None = column_definition(
            default_value=None, description="JMESPath metadata filter"
        )
        filepath_globpattern: str | None = column_definition(
            default_value=None, description="Glob pattern for the file path"
        )

    InputsQuerySchema = FilterSchema

    class RetrieveQuerySchema(Schema):
        query: str = column_definition(
            description="Your query for the similarity search",
            example="TPU data processing framework",
        )
        k: int = column_definition(description="Number of documents to return", example=2)
        metadata_filter: str | None = column_definition(
            default_value=None, description="JMESPath metadata filter"
        )
        filepath_globpattern: str | None = column_definition(
            default_value=None, description="Glob pattern for the file path"
        )

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Fold metadata_filter + filepath_globpattern into one JMESPath
        expression (reference :359)."""
        from ._utils import combine_metadata_filters

        return combine_metadata_filters(queries)

    def statistics_query(self, info_queries: Table) -> Table:
        stats = self._graph["stats"]

        @udf
        def format_stats(count, last_modified, last_indexed) -> Json:
            if count is not None:
                response = {
                    "file_count": count,
                    "last_modified": last_modified,
                    "last_indexed": last_indexed,
                }
            else:
                response = {"file_count": 0, "last_modified": None, "last_indexed": None}
            return Json(response)

        info_results = info_queries.join_left(stats, id=info_queries.id).select(
            result=format_stats(stats.count, stats.last_modified, stats.last_indexed)
        )
        return info_results

    def inputs_query(self, input_queries: Table) -> Table:
        docs = self._graph["docs"]
        all_metas = docs.reduce(metadatas=reducers.tuple(this._metadata))
        input_queries = self.merge_filters(input_queries)

        @udf
        def format_inputs(metadatas, metadata_filter) -> list:
            from ...utils.jmespath_lite import compile_filter

            metadatas = list(metadatas) if metadatas is not None else []
            if metadata_filter:
                pred = compile_filter(metadata_filter)
                metadatas = [
                    m
                    for m in metadatas
                    if pred(m.value if isinstance(m, Json) else m)
                ]
            return metadatas

        input_results = input_queries.join_left(all_metas, id=input_queries.id).select(
            all_metas.metadatas, input_queries.metadata_filter
        )
        return input_results.select(
            result=format_inputs(this.metadatas, this.metadata_filter)
        )

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        knn_index: DataIndex = self._graph["knn_index"]
        retrieval_queries = self.merge_filters(retrieval_queries)

        index_reply = knn_index.query_as_of_now(
            retrieval_queries.query,
            number_of_matches=retrieval_queries.k,
            collapse_rows=True,
            metadata_filter=retrieval_queries.metadata_filter,
        )
        retrieval_results = retrieval_queries + index_reply.select(
            result=coalesce(index_reply.data, ()),
            score=coalesce(index_reply[_SCORE], ()),
        )

        @udf
        def format_results(docs, scores) -> Json:
            docs = docs or ()
            scores = scores or ()
            out = []
            for res, score in zip(docs, scores):
                val = res.value if isinstance(res, Json) else res
                if val is None:
                    continue
                out.append({**val, "dist": -float(score)})
            return Json(sorted(out, key=lambda d: d["dist"]))

        return retrieval_results.select(
            result=format_results(this.result, this.score)
        )

    @property
    def index(self) -> DataIndex:
        return self._graph["knn_index"]

    def run_server(
        self,
        host: str,
        port: int,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        serving=None,
        **kwargs,
    ):
        """Expose /v1/retrieve, /v1/statistics, /v1/inputs (reference
        :478-585) and run the pipeline (``threaded=True``: on a daemon
        thread, which is returned). The run, and with it the webserver,
        ends when the engine stops. ``serving=`` (a ``ServingConfig``) puts
        every endpoint behind the serving plane (``rest_connector``)."""
        from ...io.http import PathwayWebserver, rest_connector

        webserver = PathwayWebserver(host=host, port=port)

        retrieval_queries, retrieval_writer = rest_connector(
            webserver=webserver,
            route="/v1/retrieve",
            methods=["GET", "POST"],
            schema=self.RetrieveQuerySchema,
            delete_completed_queries=False,
            serving=serving,
        )
        retrieval_writer(self.retrieve_query(retrieval_queries))

        stats_queries, stats_writer = rest_connector(
            webserver=webserver,
            route="/v1/statistics",
            methods=["GET", "POST"],
            schema=self.StatisticsQuerySchema,
            delete_completed_queries=False,
            serving=serving,
        )
        stats_writer(self.statistics_query(stats_queries))

        inputs_queries, inputs_writer = rest_connector(
            webserver=webserver,
            route="/v1/inputs",
            methods=["GET", "POST"],
            schema=self.InputsQuerySchema,
            delete_completed_queries=False,
            serving=serving,
        )
        inputs_writer(self.inputs_query(inputs_queries))

        def run():
            from ...internals.run import run as pw_run

            pw_run(monitoring_level=None)

        if threaded:
            t = threading.Thread(target=run, daemon=True, name="vector_store_server")
            t.start()
            return t
        run()

    def __repr__(self):
        return f"VectorStoreServer({str(self._graph)})"


class SlidesVectorStoreServer(VectorStoreServer):
    """Slide-deck flavor: inputs_query reports page-level metadata
    (reference :588)."""

    excluded_response_metadata = ["b64_image"]

    def inputs_query(self, input_queries: Table) -> Table:
        docs = self._graph["parsed_docs"]

        @udf
        def _format_metadata(doc_json) -> Json:
            data = doc_json.value if isinstance(doc_json, Json) else doc_json
            meta = dict(data.get("metadata", {}))
            for k in SlidesVectorStoreServer.excluded_response_metadata:
                meta.pop(k, None)
            return Json(meta)

        metas = docs.select(meta=_format_metadata(this.data))
        all_metas = metas.reduce(metadatas=reducers.tuple(this.meta))

        @udf
        def format_inputs(metadatas) -> list:
            return list(metadatas) if metadatas is not None else []

        return input_queries.join_left(all_metas, id=input_queries.id).select(
            result=format_inputs(all_metas.metadatas)
        )

    parsed_documents_query = inputs_query


class VectorStoreClient:
    """HTTP client for a VectorStoreServer (reference :651)."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int | None = 15,
        additional_headers: dict | None = None,
    ):
        from ._http import derive_url

        self.url = derive_url(host, port, url)
        self.timeout = timeout
        self.additional_headers = additional_headers or {}

    def _post(self, path: str, payload: dict) -> object:
        from ._http import post_json

        return post_json(
            self.url + path,
            payload,
            self.additional_headers,
            timeout=self.timeout,
        )

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        data = {"query": query, "k": k}
        if metadata_filter is not None:
            data["metadata_filter"] = metadata_filter
        if filepath_globpattern is not None:
            data["filepath_globpattern"] = filepath_globpattern
        return self._post("/v1/retrieve", data)

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list:
        return self._post(
            "/v1/inputs",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )
