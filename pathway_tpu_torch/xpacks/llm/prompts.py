"""Prompt templates and builders for RAG pipelines.

The port's copy of the reference's ``xpacks/llm/prompts.py`` (upstream
Pathway's python/pathway/xpacks/llm/prompts.py: BasePromptTemplate :11,
StringPromptTemplate :34, RAGPromptTemplate :61, prompt_qa :141,
prompt_qa_geometric_rag :194, prompt_citing_qa :268,
parse_cited_response :316, prompt_summarize :359, query rewrites :382+).
Prompt wording is our own.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

from ...internals.udfs import UDF, udf


@dataclass
class BasePromptTemplate(ABC):
    @abstractmethod
    def as_udf(self, **kwargs: Any) -> UDF: ...


@dataclass
class FunctionPromptTemplate(BasePromptTemplate):
    function_template: Callable | UDF

    def as_udf(self, **kwargs: Any) -> UDF:
        fn = self.function_template
        if isinstance(fn, UDF):
            return fn
        return udf(fn)


@dataclass
class StringPromptTemplate(BasePromptTemplate):
    """Template string formatted with str.format kwargs."""

    template: str

    def format(self, **kwargs: Any) -> str:
        return self.template.format(**kwargs)

    def as_udf(self, **defaults: Any) -> UDF:
        template = self.template

        def format_prompt(**kwargs) -> str:
            return template.format(**{**defaults, **kwargs})

        # common positional use: (context, query)
        def prompt_fn(context: str, query: str) -> str:
            return format_prompt(context=context, query=query)

        return udf(prompt_fn)


_RAG_PLACEHOLDERS = ("{context}", "{query}")


def _check_rag_template(template: str) -> None:
    for ph in _RAG_PLACEHOLDERS:
        if ph not in template:
            raise ValueError(
                f"RAG prompt template must contain the {ph} placeholder"
            )


@dataclass
class RAGPromptTemplate(StringPromptTemplate):
    """String template required to mention {context} and {query}."""

    def __post_init__(self):
        _check_rag_template(self.template)

    @classmethod
    def is_valid_rag_template(cls, template: str) -> str:
        _check_rag_template(template)
        return template


@dataclass
class RAGFunctionPromptTemplate(FunctionPromptTemplate):
    """Function template validated on a smoke call with context/query."""

    def __post_init__(self):
        fn = self.function_template
        probe = fn.func if isinstance(fn, UDF) else fn
        try:
            result = probe(context="<c>", query="<q>")
        except TypeError as e:
            raise ValueError(
                "RAG function prompt template must accept context= and query="
            ) from e
        if not isinstance(result, str):
            raise ValueError("RAG function prompt template must return str")

    @classmethod
    def is_valid_rag_template(cls, template: Callable | UDF) -> Callable | UDF:
        cls(function_template=template)
        return template


# ---------------------------------------------------------------------------
# Prompt builder functions
# ---------------------------------------------------------------------------


def prompt_short_qa(context: str, query: str, additional_rules: str = "") -> str:
    return (
        "Answer the question using only the documents provided below. "
        "Reply with as few words as possible and no full sentences. "
        "If the documents do not contain the answer, reply exactly "
        "'No information found.'"
        f"{additional_rules}\n\n"
        f"Documents:\n{context}\n\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_qa(
    context: str,
    query: str,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
) -> str:
    return (
        "You answer questions based strictly on the context documents "
        "below. Keep the answer short and factual. If the context does "
        f"not contain the answer, reply exactly '{information_not_found_response}'."
        f"{additional_rules}\n\n"
        f"Context:\n{context}\n\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_qa_geometric_rag(
    context: str,
    query: str,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
    strict_prompt: bool = False,
) -> str:
    """Prompt used by the adaptive-RAG strategy: must elicit an explicit
    no-information marker so the caller can retry with more context."""
    if strict_prompt:
        head = (
            "Use only the documents below to answer the question. "
            'Respond with JSON: {"answer": "<short answer>"} and nothing '
            'else. If the documents are insufficient, respond with '
            '{"answer": "No information found"}.'
        )
    else:
        head = (
            "Use only the documents below to answer the question in a "
            "few words. If the documents are insufficient, reply exactly "
            f"'{information_not_found_response}'."
        )
    return (
        f"{head}{additional_rules}\n\n"
        f"Documents:\n{context}\n\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_citing_qa(context: str, query: str, additional_rules: str = "") -> str:
    return (
        "Answer the question using only the numbered source documents "
        "below. After the answer, cite the ids of the sources you used "
        "in the form [id]. If there is no answer in the sources, reply "
        "'No information found.'"
        f"{additional_rules}\n\n"
        f"Sources:\n{context}\n\n"
        f"Question: {query}\nAnswer:"
    )


def parse_cited_response(response_text: str, docs: list[dict]) -> tuple[str, list[dict]]:
    """Split '<answer> [1][3]' into the answer and the cited docs.

    Citation ids are 1-based (sources are presented numbered from 1); a
    literal [0] switches to 0-based interpretation."""
    cited = re.findall(r"\[(\d+)\]", response_text)
    answer = re.sub(r"\s*\[\d+\]", "", response_text).strip()
    cited_ids = {int(c) for c in cited}
    if 0 not in cited_ids:
        cited_ids = {c - 1 for c in cited_ids}
    cited_docs = [d for i, d in enumerate(docs) if i in cited_ids]
    return answer, cited_docs


def prompt_summarize(text_list: list[str]) -> str:
    joined = "\n".join(text_list)
    return (
        "Summarize the following texts into a single short summary that "
        "covers the main points.\n\n"
        f"Texts:\n{joined}\n\nSummary:"
    )


def prompt_query_rewrite_hyde(query: str) -> str:
    return (
        "Write a short passage that plausibly answers the question "
        "below; it will be used for retrieval, so include likely "
        "keywords.\n\n"
        f"Question: {query}\nPassage:"
    )


def prompt_query_rewrite(query: str, *additional_args: str) -> str:
    extra = "\n".join(additional_args)
    return (
        "Rewrite the query below to be clearer and more effective for "
        "document retrieval. Return only the rewritten query."
        f"{(chr(10) + extra) if extra else ''}\n\n"
        f"Query: {query}\nRewritten query:"
    )


# vision-parsing prompts (reference prompts.py:435-447)
DEFAULT_JSON_TABLE_PARSE_PROMPT = (
    "Describe the table in the image as a JSON object, keeping every "
    "value, unit and metric; use clear column and row names. If the "
    "image holds no table, answer 'No table.'."
)

DEFAULT_MD_TABLE_PARSE_PROMPT = (
    "Describe the table in the image as a markdown table, keeping every "
    "value, unit and metric; use clear column and row names. If the "
    "image holds no table, answer 'No table.'."
)

DEFAULT_IMAGE_PARSE_PROMPT = (
    "Describe the image in detail. Spell out any text it contains, and "
    "keep tabular information formatted as a table."
)
