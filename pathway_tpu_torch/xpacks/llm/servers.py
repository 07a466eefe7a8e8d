"""REST serving layer for document stores and QA apps.

The port's copy of the reference's ``xpacks/llm/servers.py`` (upstream
Pathway's python/pathway/xpacks/llm/servers.py: BaseRestServer :16,
DocumentStoreServer :92, QARestServer :140, QASummaryRestServer :193,
serve_callable :227). The QA servers take any question answerer with the
reference's query schemas and handlers; the reference's
``question_answering.py`` comes with ROADMAP Queue A item 2.
"""

from __future__ import annotations

import inspect
import logging
import threading
from typing import Callable

from ...internals.schema import Schema
from ...internals.table import Table
from ...internals.udfs import udf

logger = logging.getLogger(__name__)


class BaseRestServer:
    def __init__(self, host: str, port: int, serving=None, **rest_kwargs):
        """``serving=`` (the reference's serving plane) comes with ROADMAP
        Queue A item 3 and raises when an endpoint is served."""
        from ...io.http import PathwayWebserver

        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host=host, port=port)
        self.serving = serving
        self.rest_kwargs = rest_kwargs

    def serve(
        self,
        route: str,
        schema: type[Schema],
        handler: Callable[[Table], Table],
        documentation=None,  # EndpointDocumentation
        **additional_endpoint_kwargs,
    ) -> None:
        """Wire one endpoint: requests → handler table → responses."""
        from ...io.http import rest_connector

        additional_endpoint_kwargs.setdefault("serving", self.serving)
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            methods=["POST"],
            schema=schema,
            delete_completed_queries=False,
            documentation=documentation,
            **additional_endpoint_kwargs,
        )
        writer(handler(queries))

    def serve_callable(
        self,
        route: str,
        callable_fn: Callable,
        schema: type[Schema] | None = None,
        **kwargs,
    ) -> Callable:
        """Expose a plain (possibly async) python callable as an
        endpoint (reference servers.py:227): request fields become
        kwargs; the return value is the response."""
        if schema is None:
            from ...internals import dtype as dt
            from ...internals.schema import ColumnDefinition, schema_builder

            params = [
                p
                for p in inspect.signature(callable_fn).parameters.values()
                if p.name != "self"
            ]
            schema = schema_builder(
                {p.name: ColumnDefinition(dtype=dt.ANY) for p in params},
                name=f"{route}_schema",
            )
        names = list(schema.dtypes().keys())

        from ._utils import _coerce_sync

        fn = _coerce_sync(callable_fn)

        @udf
        def run_callable(*args):
            return fn(**dict(zip(names, args)))

        def handler(queries: Table) -> Table:
            return queries.select(
                result=run_callable(*[queries[n] for n in names])
            )

        self.serve(route, schema, handler, **kwargs)
        return callable_fn

    def run(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        terminate_on_error: bool = False,
        **run_kwargs,
    ):
        """Start the pipeline (and webserver). threaded=True runs in a
        daemon thread and returns it."""

        def _run():
            from ...internals.run import run as pw_run

            pw_run(monitoring_level=None, terminate_on_error=terminate_on_error)

        if threaded:
            t = threading.Thread(
                target=_run, daemon=True, name=f"rest_server:{self.port}"
            )
            t.start()
            return t
        _run()


def _docs(summary: str, tags: list[str], example: dict | None = None):
    from ...io.http import EndpointDocumentation, EndpointExamples

    examples = None
    if example is not None:
        examples = EndpointExamples().add_example("default", summary, example)
    return EndpointDocumentation(summary=summary, tags=tags, examples=examples)


class DocumentStoreServer(BaseRestServer):
    """Endpoints: /v1/retrieve, /v1/statistics, /v1/inputs
    (reference servers.py:92)."""

    def __init__(self, host: str, port: int, document_store, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.document_store = document_store
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
            documentation=_docs(
                "Retrieve the closest documents for a query",
                ["document-store"],
                {"query": "what is pathway", "k": 3},
            ),
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
            documentation=_docs("Index statistics", ["document-store"]),
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
            documentation=_docs("List indexed input documents", ["document-store"]),
        )


class QARestServer(BaseRestServer):
    """Endpoints: /v1/retrieve, /v1/statistics, /v1/pw_list_documents,
    /v1/pw_ai_answer (reference servers.py:140)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.rag_question_answerer = rag_question_answerer
        self.serve(
            "/v1/retrieve",
            rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
            documentation=_docs(
                "Retrieve the closest documents for a query",
                ["rag"],
                {"query": "what is pathway", "k": 3},
            ),
        )
        self.serve(
            "/v1/statistics",
            rag_question_answerer.StatisticsQuerySchema,
            rag_question_answerer.statistics,
            documentation=_docs("Index statistics", ["rag"]),
        )
        self.serve(
            "/v1/pw_list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
            documentation=_docs("List indexed input documents", ["rag"]),
        )
        self.serve(
            "/v1/pw_ai_answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
            documentation=_docs(
                "Answer a question over the indexed documents",
                ["rag"],
                {"prompt": "What is Pathway?"},
            ),
        )
        # v2-style alias
        self.serve(
            "/v2/answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
            documentation=_docs(
                "Answer a question over the indexed documents", ["rag"]
            ),
        )


class QASummaryRestServer(QARestServer):
    """Adds /v1/pw_ai_summary (reference servers.py:193)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
            documentation=_docs(
                "Summarize a list of texts",
                ["rag"],
                {"text_list": ["first text", "second text"]},
            ),
        )
        self.serve(
            "/v2/summarize",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
            documentation=_docs("Summarize a list of texts", ["rag"]),
        )
