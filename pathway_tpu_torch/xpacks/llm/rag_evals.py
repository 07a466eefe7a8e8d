"""RAG quality evaluation harness.

The port's copy of the reference's ``xpacks/llm/rag_evals.py``: run a RAG
app over an evaluation set, score whether the right sources were retrieved
and whether answers carry the expected facts. The harness drives a
:class:`~pathway_tpu_torch.xpacks.llm.document_store.DocumentStore`
retrieval pipeline through the engine once and reports

- **hit rate @ k**: the fraction of questions whose expected source file
  appears in the top-k retrieved documents,
- **MRR**: the mean reciprocal rank of the expected source,
- **term coverage**: the fraction of each question's expected answer terms
  present in the produced answer (with the default extractive answerer,
  whether retrieval surfaced the needed facts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

from ...internals.schema import Schema, column_definition


class _EvalQuerySchema(Schema):
    query: str
    k: int
    metadata_filter: str | None = column_definition(default_value=None)
    filepath_globpattern: str | None = column_definition(default_value=None)


@dataclass(frozen=True)
class EvalCase:
    """One evaluation question.

    ``expected_file`` is matched as a substring of each retrieved
    document's metadata path.  ``answer_terms`` are facts the answer
    must mention (case-insensitive)."""

    question: str
    expected_file: str
    answer_terms: tuple[str, ...] = ()


@dataclass
class CaseOutcome:
    case: EvalCase
    retrieved_files: list[str]
    rank: int | None  # 1-based rank of the expected file; None = missed
    answer: str
    term_coverage: float

    @property
    def hit(self) -> bool:
        return self.rank is not None


@dataclass
class EvalReport:
    k: int
    outcomes: list[CaseOutcome] = field(default_factory=list)

    @property
    def n_cases(self) -> int:
        return len(self.outcomes)

    @property
    def hit_rate(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(o.hit for o in self.outcomes) / len(self.outcomes)

    @property
    def mrr(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(1.0 / o.rank for o in self.outcomes if o.rank) / len(self.outcomes)

    @property
    def term_coverage(self) -> float:
        scored = [o for o in self.outcomes if o.case.answer_terms]
        if not scored:
            return 1.0
        return sum(o.term_coverage for o in scored) / len(scored)

    def as_dict(self) -> dict:
        return {
            "n_cases": self.n_cases,
            "k": self.k,
            "hit_rate": round(self.hit_rate, 4),
            "mrr": round(self.mrr, 4),
            "term_coverage": round(self.term_coverage, 4),
            "misses": [o.case.question for o in self.outcomes if not o.hit],
        }


def _coverage(answer: str, terms: Sequence[str]) -> float:
    if not terms:
        return 1.0
    lowered = answer.lower()
    return sum(t.lower() in lowered for t in terms) / len(terms)


def extractive_answerer(question: str, contexts: list[str]) -> str:
    """Default answerer: the concatenated retrieved passages.  Term
    coverage then scores whether retrieval surfaced the needed facts."""
    return "\n".join(contexts)


def evaluate_document_store(
    store,
    cases: Iterable[EvalCase],
    *,
    k: int = 3,
    answerer: Callable[[str, list[str]], str] = extractive_answerer,
) -> EvalReport:
    """Run every case through ``store.retrieve_query`` in one engine
    pass and score the retrievals.  Consumes the current parse graph
    (like any ``pw.run``) — build the store, call this, read the report.
    """
    from ...debug import table_from_rows, table_to_dicts
    from ...internals.thisclass import this

    cases = list(cases)
    queries = table_from_rows(
        _EvalQuerySchema, [(c.question, k, None, None) for c in cases]
    )
    results = store.retrieve_query(queries)
    combined = queries.select(question=this.query) + results
    _, columns = table_to_dicts(combined)
    by_question: dict[str, list[dict]] = {}
    for key, question in columns["question"].items():
        raw = columns["result"][key]
        raw = raw.value if hasattr(raw, "value") else raw
        by_question[question] = list(raw or [])

    report = EvalReport(k=k)
    for case in cases:
        retrieved = by_question.get(case.question, [])
        files = [str((d.get("metadata") or {}).get("path", "")) for d in retrieved]
        texts = [str(d.get("text", "")) for d in retrieved]
        rank = None
        for pos, path in enumerate(files, start=1):
            if case.expected_file in path:
                rank = pos
                break
        answer = answerer(case.question, texts)
        report.outcomes.append(
            CaseOutcome(
                case=case,
                retrieved_files=files,
                rank=rank,
                answer=answer,
                term_coverage=_coverage(answer, case.answer_terms),
            )
        )
    return report
