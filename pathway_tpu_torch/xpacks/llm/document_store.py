"""DocumentStore — index-factory-driven document pipeline.

The port's copy of the reference's ``xpacks/llm/document_store.py``
(upstream Pathway's python/pathway/xpacks/llm/document_store.py:
DocumentStore :32, parse_documents :233, split_docs :260,
build_pipeline :286, retrieve_query :426, SlidesDocumentStore :471).
Unlike VectorStoreServer (fixed usearch KNN), the retriever is supplied
as a DataIndexFactory, so BM25 / hybrid / brute-force / LSH retrievers
all plug in.
"""

from __future__ import annotations

import logging
from typing import Iterable

from ... import reducers
from ...engine.value import Json
from ...internals.expression import coalesce
from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from ...internals.thisclass import this
from ...internals.udfs import UDF, udf
from ...stdlib.indexing.colnames import _SCORE
from ...stdlib.indexing.data_index import DataIndex
from ._utils import _coerce_sync, _unwrap_udf, coerce_async
from .parsers import ParseUtf8
from .splitters import null_splitter

logger = logging.getLogger(__name__)


class DocumentStore:
    """Parse → post-process → split → retriever-index pipeline."""

    def __init__(
        self,
        *docs: Table,
        retriever_factory,
        parser: UDF | None = None,
        splitter: UDF | None = None,
        doc_post_processors: list | None = None,
    ):
        self.docs = list(docs)
        self.retriever_factory = retriever_factory
        self.parser = parser or ParseUtf8()
        self.splitter = splitter or null_splitter
        self.doc_post_processors = [
            _unwrap_udf(p) for p in (doc_post_processors or []) if p is not None
        ]
        self.build_pipeline()

    @classmethod
    def from_langchain_components(
        cls, *docs, retriever_factory, parser=None, splitter=None, **kwargs
    ):
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
        return cls(
            *docs,
            retriever_factory=retriever_factory,
            parser=parser,
            splitter=generic_splitter,
            **kwargs,
        )

    @classmethod
    def from_llamaindex_components(
        cls, *docs, retriever_factory, transformations, parser=None, **kwargs
    ):
        try:
            from llama_index.core.ingestion.pipeline import run_transformations
            from llama_index.core.schema import BaseNode, MetadataMode, TextNode
        except ImportError as e:  # pragma: no cover
            raise ImportError("from_llamaindex_components requires llama-index") from e

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
            retriever_factory=retriever_factory,
            parser=parser,
            splitter=generic_transformer,
            **kwargs,
        )

    def _clean_tables(self, docs: Table | Iterable[Table]) -> list[Table]:
        if isinstance(docs, Table):
            docs = [docs]
        out = []
        for table in docs:
            if "_metadata" not in table.column_names():
                table = table.with_columns(_metadata=Json({}))
            out.append(table.select(this.data, this._metadata))
        return out

    def parse_documents(self, input_docs: Table) -> Table:
        parse_fn = coerce_async(self.parser)

        @udf
        async def parse_doc(data, metadata) -> list[Json]:
            rets = await parse_fn(data)
            meta = metadata.value if isinstance(metadata, Json) else (metadata or {})
            return [Json(dict(text=text, metadata={**meta, **m})) for text, m in rets]

        return input_docs.select(data=parse_doc(this.data, this._metadata)).flatten(
            this.data
        )

    def post_process_docs(self, parsed_docs: Table) -> Table:
        post_processors = self.doc_post_processors

        @udf
        def post_proc_docs(data_json: Json) -> Json:
            data = data_json.value if isinstance(data_json, Json) else data_json
            text, metadata = data["text"], data["metadata"]
            for processor in post_processors:
                text, metadata = processor(text, metadata)
            return Json(dict(text=text, metadata=metadata))

        return parsed_docs.select(data=post_proc_docs(this.data))

    def split_docs(self, post_processed_docs: Table) -> Table:
        split_fn = _coerce_sync(_unwrap_udf(self.splitter))

        @udf
        def split_doc(data_json: Json) -> list[Json]:
            data = data_json.value if isinstance(data_json, Json) else data_json
            text, metadata = data["text"], data["metadata"]
            rets = split_fn(text)
            return [
                Json(dict(text=text_chunk, metadata={**metadata, **m}))
                for text_chunk, m in rets
            ]

        return post_processed_docs.select(data=split_doc(this.data)).flatten(this.data)

    def build_pipeline(self) -> None:
        docs_s = self._clean_tables(self.docs)
        if not docs_s:
            raise ValueError("provide at least one data source")
        if len(docs_s) == 1:
            (docs,) = docs_s
        else:
            docs = docs_s[0].concat_reindex(*docs_s[1:])
        self.input_docs = docs

        parsed_docs = self.parse_documents(docs)
        parsed_docs = self.post_process_docs(parsed_docs)
        chunked_docs = self.split_docs(parsed_docs)
        chunked_docs = chunked_docs + chunked_docs.select(
            text=this.data["text"].as_str()
        )
        self.parsed_docs = parsed_docs
        self.chunked_docs = chunked_docs

        self._retriever = self.retriever_factory.build_index(
            chunked_docs.text,
            chunked_docs,
            metadata_column=chunked_docs.data["metadata"],
        )

        stats_src = parsed_docs + parsed_docs.select(
            modified=this.data["metadata"]["modified_at"].as_int(),
            indexed=this.data["metadata"]["seen_at"].as_int(),
            path=this.data["metadata"]["path"].as_str(),
        )
        self.stats = stats_src.reduce(
            count=reducers.count(),
            last_modified=reducers.max(this.modified),
            last_indexed=reducers.max(this.indexed),
            paths=reducers.tuple(this.path),
        )

    # -- schemas --

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
        query: str = column_definition(description="Search query")
        k: int = column_definition(description="Number of documents", example=2)
        metadata_filter: str | None = column_definition(default_value=None)
        filepath_globpattern: str | None = column_definition(default_value=None)

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        from ._utils import combine_metadata_filters

        return combine_metadata_filters(queries)

    def statistics_query(self, info_queries: Table) -> Table:
        stats = self.stats

        @udf
        def format_stats(count, last_modified, last_indexed) -> Json:
            if count is not None:
                return Json(
                    {
                        "file_count": count,
                        "last_modified": last_modified,
                        "last_indexed": last_indexed,
                    }
                )
            return Json({"file_count": 0, "last_modified": None, "last_indexed": None})

        return info_queries.join_left(stats, id=info_queries.id).select(
            result=format_stats(stats.count, stats.last_modified, stats.last_indexed)
        )

    def inputs_query(self, input_queries: Table) -> Table:
        docs = self.input_docs
        all_metas = docs.reduce(metadatas=reducers.tuple(this._metadata))
        input_queries = self.merge_filters(input_queries)

        @udf
        def format_inputs(metadatas, metadata_filter) -> list:
            from ...utils.jmespath_lite import compile_filter

            metadatas = list(metadatas) if metadatas is not None else []
            if metadata_filter:
                pred = compile_filter(metadata_filter)
                metadatas = [
                    m for m in metadatas if pred(m.value if isinstance(m, Json) else m)
                ]
            return metadatas

        return (
            input_queries.join_left(all_metas, id=input_queries.id)
            .select(all_metas.metadatas, input_queries.metadata_filter)
            .select(result=format_inputs(this.metadatas, this.metadata_filter))
        )

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        retrieval_queries = self.merge_filters(retrieval_queries)
        index_reply = self._retriever.query_as_of_now(
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

        return retrieval_results.select(result=format_results(this.result, this.score))

    @property
    def index(self) -> DataIndex:
        return self._retriever


class SlidesDocumentStore(DocumentStore):
    """Slide-deck flavor reporting page-level parsed documents
    (reference document_store.py:471)."""

    excluded_response_metadata = ["b64_image"]

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        docs = self.parsed_docs

        @udf
        def _format_meta(doc_json) -> Json:
            data = doc_json.value if isinstance(doc_json, Json) else doc_json
            meta = dict(data.get("metadata", {}))
            for k in SlidesDocumentStore.excluded_response_metadata:
                meta.pop(k, None)
            return Json(meta)

        metas = docs.select(meta=_format_meta(this.data))
        all_metas = metas.reduce(metadatas=reducers.tuple(this.meta))

        @udf
        def format_inputs(metadatas) -> list:
            return list(metadatas) if metadatas is not None else []

        return parse_docs_queries.join_left(all_metas, id=parse_docs_queries.id).select(
            result=format_inputs(all_metas.metadatas)
        )
