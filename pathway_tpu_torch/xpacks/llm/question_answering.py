"""RAG question-answering apps.

The port's copy of the reference's ``xpacks/llm/question_answering.py``
(upstream Pathway's xpacks/llm/question_answering.py:
answer_with_geometric_rag_strategy :97, BaseContextProcessor :221,
BaseQuestionAnswerer :288, BaseRAGQuestionAnswerer :314,
AdaptiveRAGQuestionAnswerer :620, DeckRetriever :736, RAGClient :854).

The adaptive strategy grows the retrieved context geometrically (n,
n*factor, n*factor^2, ...) and asks the chat again until it stops answering
"no information", bounding the chat's cost logarithmically in the corpus
size. ``QARestServer`` / ``QASummaryRestServer`` (``servers.py``) serve
these apps over HTTP.
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from typing import Callable

from ...engine.value import Json
from ...internals.expression import ColumnExpression
from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from ...internals.thisclass import this
from ...internals.udfs import UDF, udf
from .document_store import DocumentStore
from .llms import BaseChat, prompt_chat_single_qa
from .prompts import (
    BasePromptTemplate,
    RAGFunctionPromptTemplate,
    RAGPromptTemplate,
    prompt_qa,
    prompt_qa_geometric_rag,
    prompt_summarize,
)
from .vector_store import VectorStoreServer

logger = logging.getLogger(__name__)

Doc = dict


def _limit_documents(documents: list[str], k: int) -> list[str]:
    return documents[:k]


def _extract_doc_list(docs) -> list[dict]:
    if isinstance(docs, Json):
        docs = docs.value
    out = []
    for d in docs or []:
        if isinstance(d, Json):
            d = d.value
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# Geometric (adaptive) RAG strategy (reference :97-220)
# ---------------------------------------------------------------------------

_NO_INFO_MARKERS = ("no information", "no information found")


def _is_no_information(answer: str | None) -> bool:
    return answer is None or any(m in str(answer).lower() for m in _NO_INFO_MARKERS)


def _strict_extract_answer(response: str) -> str:
    try:
        data = json.loads(response)
        return str(data.get("answer", response))
    except (ValueError, TypeError):
        return response


def answer_with_geometric_rag_strategy(
    questions: list[str],
    documents: list[list[str]],
    llm_chat_model: BaseChat | Callable,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
) -> list[str]:
    """Host-side batch variant: answer each question, retrying with
    geometrically more documents on 'no information' (reference :97)."""
    from ._utils import _coerce_sync, _unwrap_udf

    chat = _coerce_sync(_unwrap_udf(llm_chat_model))
    answers: list[str] = []
    for question, docs in zip(questions, documents):
        n = n_starting_documents
        answer = None
        for _ in range(max_iterations):
            context = "\n".join(_limit_documents(docs, n))
            prompt = prompt_qa_geometric_rag(
                context, question, strict_prompt=strict_prompt
            )
            raw = chat(Json([{"role": "user", "content": prompt}]))
            candidate = _strict_extract_answer(raw) if strict_prompt else raw
            if not _is_no_information(candidate):
                answer = candidate
                break
            if n >= len(docs):
                break
            n *= factor
        answers.append(answer if answer is not None else "No information found.")
    return answers


def answer_with_geometric_rag_strategy_from_index(
    questions: Table,
    index,
    documents_column: str | ColumnExpression,
    llm_chat_model: BaseChat,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    query_column: str | ColumnExpression | None = None,
    strict_prompt: bool = False,
) -> Table:
    """Dataflow variant: retrieve max_docs once, then run the geometric
    loop per row inside a UDF (reference :162)."""
    max_docs = n_starting_documents * factor ** (max_iterations - 1)
    col_name = (
        documents_column
        if isinstance(documents_column, str)
        else documents_column._name
    )
    query_ref = questions.query if query_column is None else query_column

    index_reply = index.query_as_of_now(
        query_ref, number_of_matches=max_docs, collapse_rows=True
    )
    with_docs = questions + index_reply.select(docs=index_reply[col_name])

    from ._utils import _coerce_sync, _unwrap_udf

    chat = _coerce_sync(_unwrap_udf(llm_chat_model))

    @udf
    def geometric_answer(question: str, docs) -> str:
        doc_texts = []
        for d in docs or ():
            if isinstance(d, Json):
                d = d.value
            if isinstance(d, dict):
                doc_texts.append(str(d.get("text", d)))
            else:
                doc_texts.append(str(d))
        return answer_with_geometric_rag_strategy(
            [question],
            [doc_texts],
            chat,
            n_starting_documents,
            factor,
            max_iterations,
            strict_prompt=strict_prompt,
        )[0]

    return with_docs.select(result=geometric_answer(this.query, this.docs))


# ---------------------------------------------------------------------------
# Context processors (reference :221-287)
# ---------------------------------------------------------------------------


class BaseContextProcessor(ABC):
    """Transforms retrieved docs into the LLM context string."""

    def maybe_unwrap_docs(self, docs):
        return _extract_doc_list(docs)

    def apply(self, docs) -> str:
        return self.docs_to_context(self.maybe_unwrap_docs(docs))

    @abstractmethod
    def docs_to_context(self, docs: list[dict]) -> str: ...

    def as_udf(self) -> UDF:
        return udf(self.apply)


class SimpleContextProcessor(BaseContextProcessor):
    """Keeps selected metadata fields, joins doc texts (reference :257)."""

    def __init__(self, context_metadata_keys: list[str] = ["path"], context_joiner: str = "\n\n"):
        self.context_metadata_keys = context_metadata_keys
        self.context_joiner = context_joiner

    def simplify_context_metadata(self, docs: list[dict]) -> list[dict]:
        out = []
        for doc in docs:
            meta = doc.get("metadata", {})
            if isinstance(meta, Json):
                meta = meta.value
            kept = {k: meta[k] for k in self.context_metadata_keys if k in meta}
            out.append({"text": doc.get("text", ""), "metadata": kept})
        return out

    def docs_to_context(self, docs: list[dict]) -> str:
        docs = self.simplify_context_metadata(docs)
        return self.context_joiner.join(
            f"text: {doc['text']}, metadata: {doc['metadata']}" for doc in docs
        )


# ---------------------------------------------------------------------------
# Question answerers (reference :288+)
# ---------------------------------------------------------------------------


class BaseQuestionAnswerer:
    AnswerQuerySchema: type[Schema] = Schema
    RetrieveQuerySchema: type[Schema] = Schema
    StatisticsQuerySchema: type[Schema] = Schema
    InputsQuerySchema: type[Schema] = Schema

    def answer_query(self, pw_ai_queries: Table) -> Table: ...

    def retrieve(self, retrieve_queries: Table) -> Table: ...

    def statistics(self, statistics_queries: Table) -> Table: ...

    def list_documents(self, list_documents_queries: Table) -> Table: ...


class SummaryQuestionAnswerer(BaseQuestionAnswerer):
    SummarizeQuerySchema: type[Schema] = Schema

    def summarize_query(self, summarize_queries: Table) -> Table: ...


class BaseRAGQuestionAnswerer(SummaryQuestionAnswerer):
    """Standard RAG app over a DocumentStore / VectorStoreServer
    (reference :314)."""

    def __init__(
        self,
        llm: BaseChat,
        indexer: DocumentStore | VectorStoreServer,
        *,
        default_llm_name: str | None = None,
        prompt_template: str | Callable | UDF | BasePromptTemplate = prompt_qa,
        summarize_template: UDF | Callable = prompt_summarize,
        search_topk: int = 6,
        context_processor: BaseContextProcessor | None = None,
    ):
        self.llm = llm
        self.indexer = indexer
        self.prompt_udf = self._get_prompt_udf(prompt_template)
        self.summarize_template = (
            summarize_template if isinstance(summarize_template, UDF) else udf(summarize_template)
        )
        self.search_topk = search_topk
        self.context_processor = context_processor or SimpleContextProcessor()
        self._init_schemas(default_llm_name)
        self.server = None
        self._pending_endpoints: list[tuple] = []

    def _get_prompt_udf(self, prompt_template) -> UDF:
        if isinstance(prompt_template, BasePromptTemplate):
            return prompt_template.as_udf()
        if isinstance(prompt_template, UDF):
            return RAGFunctionPromptTemplate(function_template=prompt_template).as_udf()
        if isinstance(prompt_template, str):
            return RAGPromptTemplate(template=prompt_template).as_udf()
        if callable(prompt_template):
            return udf(prompt_template)
        raise ValueError(f"invalid prompt_template: {prompt_template!r}")

    def _init_schemas(self, default_llm_name: str | None = None) -> None:
        class PWAIQuerySchema(Schema):
            prompt: str
            filters: str | None = column_definition(default_value=None)
            model: str | None = column_definition(default_value=default_llm_name)
            return_context_docs: bool | None = column_definition(default_value=False)

        class SummarizeQuerySchema(Schema):
            text_list: list
            model: str | None = column_definition(default_value=default_llm_name)

        self.AnswerQuerySchema = PWAIQuerySchema
        self.SummarizeQuerySchema = SummarizeQuerySchema
        self.RetrieveQuerySchema = self.indexer.RetrieveQuerySchema
        self.StatisticsQuerySchema = self.indexer.StatisticsQuerySchema
        self.InputsQuerySchema = self.indexer.InputsQuerySchema

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """prompt → retrieve docs → build context → LLM answer."""
        queries = pw_ai_queries.select(
            query=this.prompt,
            k=self.search_topk,
            metadata_filter=this.filters,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(queries)
        pw_ai_results = pw_ai_queries + retrieved.select(docs=this.result)

        context_udf = self.context_processor.as_udf()
        pw_ai_results = pw_ai_results.with_columns(
            context=context_udf(this.docs)
        )
        pw_ai_results = pw_ai_results.with_columns(
            rag_prompt=self.prompt_udf(this.context, this.prompt)
        )
        pw_ai_results = pw_ai_results.with_columns(
            response=self.llm(prompt_chat_single_qa(this.rag_prompt))
        )

        @udf
        def format_response(response, docs, return_context_docs) -> Json:
            out: dict = {"response": response}
            if return_context_docs:
                out["context_docs"] = _extract_doc_list(docs)
            return Json(out)

        return pw_ai_results.select(
            result=format_response(this.response, this.docs, this.return_context_docs)
        )

    # kept under the reference's old endpoint name
    def pw_ai_query(self, pw_ai_queries: Table) -> Table:
        return self.answer_query(pw_ai_queries)

    def summarize_query(self, summarize_queries: Table) -> Table:
        summarize_queries = summarize_queries.with_columns(
            prompt=self.summarize_template(this.text_list)
        )
        summarize_queries = summarize_queries.with_columns(
            response=self.llm(prompt_chat_single_qa(this.prompt))
        )
        return summarize_queries.select(result=this.response)

    def retrieve(self, retrieve_queries: Table) -> Table:
        return self.indexer.retrieve_query(retrieve_queries)

    def statistics(self, statistics_queries: Table) -> Table:
        return self.indexer.statistics_query(statistics_queries)

    def list_documents(self, list_documents_queries: Table) -> Table:
        return self.indexer.inputs_query(list_documents_queries)

    # -- serving (reference :527-617) --

    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        """Register the standard endpoints; run_server() starts it."""
        from .servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **rest_kwargs)
        for route, callable_fn, extra in self._pending_endpoints:
            self.server.serve_callable(route, callable_fn, **extra)
        self._pending_endpoints.clear()

    def serve_callable(self, route: str, schema: type[Schema] | None = None, **kwargs):
        """Decorator: expose a custom callable at `route` once the
        server is built (reference :558)."""

        def decorator(callable_fn):
            if self.server is None:
                self._pending_endpoints.append(
                    (route, callable_fn, {"schema": schema, **kwargs})
                )
            else:
                self.server.serve_callable(route, callable_fn, schema=schema, **kwargs)
            return callable_fn

        return decorator

    def run_server(self, *args, **kwargs):
        if self.server is None:
            raise ValueError("call build_server() first")
        return self.server.run(*args, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """RAG with geometric context growth (reference :620)."""

    def __init__(
        self,
        llm: BaseChat,
        indexer: DocumentStore | VectorStoreServer,
        *,
        default_llm_name: str | None = None,
        summarize_template: UDF | Callable = prompt_summarize,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
    ):
        super().__init__(
            llm,
            indexer,
            default_llm_name=default_llm_name,
            summarize_template=summarize_template,
        )
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, pw_ai_queries: Table) -> Table:
        queries = pw_ai_queries.select(
            query=this.prompt,
            k=self.n_starting_documents
            * self.factor ** (self.max_iterations - 1),
            metadata_filter=this.filters,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(queries)
        with_docs = pw_ai_queries + retrieved.select(docs=this.result)

        from ._utils import _coerce_sync, _unwrap_udf

        chat = _coerce_sync(_unwrap_udf(self.llm))
        n0, factor, iters, strict = (
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
            self.strict_prompt,
        )

        @udf
        def adaptive_answer(prompt: str, docs) -> Json:
            doc_list = _extract_doc_list(docs)
            texts = [str(d.get("text", d)) if isinstance(d, dict) else str(d) for d in doc_list]
            answer = answer_with_geometric_rag_strategy(
                [prompt], [texts], chat, n0, factor, iters, strict_prompt=strict
            )[0]
            return Json({"response": answer})

        return with_docs.select(result=adaptive_answer(this.prompt, this.docs))


class DeckRetriever(BaseQuestionAnswerer):
    """Slide-deck retrieval app (reference :736): answer_query returns
    the matched slides directly."""

    excluded_response_metadata = ["b64_image"]

    def __init__(self, indexer, *, search_topk: int = 6):
        self.indexer = indexer
        self.search_topk = search_topk
        self.server = None
        self._init_schemas()

    def _init_schemas(self) -> None:
        class PWAIQuerySchema(Schema):
            prompt: str
            filters: str | None = column_definition(default_value=None)

        self.AnswerQuerySchema = PWAIQuerySchema
        self.RetrieveQuerySchema = self.indexer.RetrieveQuerySchema
        self.StatisticsQuerySchema = self.indexer.StatisticsQuerySchema
        self.InputsQuerySchema = self.indexer.InputsQuerySchema

    def answer_query(self, pw_ai_queries: Table) -> Table:
        queries = pw_ai_queries.select(
            query=this.prompt,
            k=self.search_topk,
            metadata_filter=this.filters,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(queries)
        results = pw_ai_queries + retrieved.select(docs=this.result)

        @udf
        def _format_results(docs) -> Json:
            doc_list = _extract_doc_list(docs)
            for doc in doc_list:
                meta = doc.get("metadata", {})
                if isinstance(meta, dict):
                    for k in DeckRetriever.excluded_response_metadata:
                        meta.pop(k, None)
            return Json(doc_list)

        return results.select(result=_format_results(this.docs))

    def retrieve(self, retrieve_queries: Table) -> Table:
        return self.indexer.retrieve_query(retrieve_queries)

    def statistics(self, statistics_queries: Table) -> Table:
        return self.indexer.statistics_query(statistics_queries)

    def list_documents(self, list_documents_queries: Table) -> Table:
        return self.indexer.inputs_query(list_documents_queries)

    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        from .servers import QARestServer

        self.server = QARestServer(host, port, self, **rest_kwargs)

    def run_server(self, *args, **kwargs):
        if self.server is None:
            raise ValueError("call build_server() first")
        return self.server.run(*args, **kwargs)


def send_post_request(
    url: str, data: dict, headers: dict | None = None, timeout: int | None = None
):
    """POST json, raise on HTTP errors, return the decoded body
    (reference question_answering.py:846). Stdlib-only — no requests
    dependency."""
    from ._http import post_json

    return post_json(url, data, headers, timeout=timeout)


class RAGClient:
    """HTTP client for the RAG question-answering servers (reference
    question_answering.py:854): retrieval + stats ride the underlying
    VectorStoreClient, answers/summaries hit the QA routes.

    Args:
        host/port or url: where the server listens (exactly one form).
        timeout: per-request seconds, default 90.
        additional_headers: sent with every request.
        deadline_ms: per-request serving deadline propagated to the
            server via the ``X-Pathway-Deadline-Ms`` header; servers
            running with a ``ServingConfig`` shed the request with a
            typed 503 once the budget is exhausted.
    """

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int | None = 90,
        additional_headers: dict | None = None,
        deadline_ms: float | None = None,
    ):
        from ._http import derive_url
        from .vector_store import VectorStoreClient

        self.url = derive_url(host, port, url)
        self.timeout = timeout
        self.additional_headers = additional_headers or {}
        if deadline_ms is not None:
            from ...serving import DEADLINE_HEADER

            self.additional_headers.setdefault(DEADLINE_HEADER, str(deadline_ms))
        self.index_client = VectorStoreClient(
            url=self.url,
            timeout=self.timeout,
            additional_headers=self.additional_headers,
        )

    def retrieve(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ):
        """Closest documents for a query, straight off the index."""
        return self.index_client.query(
            query=query,
            k=k,
            metadata_filter=metadata_filter,
            filepath_globpattern=filepath_globpattern,
        )

    def statistics(self):
        """Indexed-corpus stats (/v1/statistics)."""
        return self.index_client.get_vectorstore_statistics()

    def pw_ai_answer(
        self,
        prompt: str,
        filters: str | None = None,
        model: str | None = None,
    ):
        """RAG answer for a prompt (POST /v1/pw_ai_answer)."""
        payload: dict = {"prompt": prompt}
        if filters:
            payload["filters"] = filters
        if model:
            payload["model"] = model
        return send_post_request(
            f"{self.url}/v1/pw_ai_answer",
            payload,
            self.additional_headers,
            timeout=self.timeout,
        )

    def pw_ai_summary(self, text_list: list[str], model: str | None = None):
        """Summarize texts (POST /v1/pw_ai_summary)."""
        payload: dict = {"text_list": text_list}
        if model:
            payload["model"] = model
        return send_post_request(
            f"{self.url}/v1/pw_ai_summary",
            payload,
            self.additional_headers,
            timeout=self.timeout,
        )

    def pw_list_documents(self, filters: str | None = None, keys: list | None = None):
        """Indexed documents' metadata (POST /v1/pw_list_documents);
        ``keys`` narrows each returned metadata dict to those fields,
        client-side, like the reference client."""
        payload: dict = {}
        if filters:
            payload["metadata_filter"] = filters
        docs = send_post_request(
            f"{self.url}/v1/pw_list_documents",
            payload,
            self.additional_headers,
            timeout=self.timeout,
        )
        if keys and isinstance(docs, list):
            docs = [
                {k: d[k] for k in keys if k in d} if isinstance(d, dict) else d
                for d in docs
            ]
        return docs
