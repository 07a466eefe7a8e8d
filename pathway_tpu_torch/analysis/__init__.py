"""pathway_tpu_torch.analysis — pre-execution graph verifier.

The port's copy of the reference's ``analysis`` package: the same rule
ids, severities, details, ordering, suppression, exit codes and JSON.

The pipeline exists as a declarative graph before a single row flows
(the "Python-described, Rust-executed" contract), so schema drift,
unbounded state, and shard-unsafe UDFs are all visible *statically*.
This package walks the parse graph (and optionally the lowered
EngineGraph) and reports findings as :class:`Diagnostic` records with
stable rule ids.

Three surfaces:

- library:  ``pathway_tpu_torch.analysis.analyze(graph) -> list[Diagnostic]``
- run gate: ``pw.run(analysis="strict" | "warn" | "deep" | "off")``
- CLI:      ``python -m pathway_tpu_torch analyze [--json] [--deep] program.py``

Per-table suppression::

    with pw.analysis.suppress("PWL002"):
        totals = stream.groupby(pw.this.user).reduce(...)  # accepted risk

    # or directly:
    pw.analysis.suppress("PWL003", table)
"""

from __future__ import annotations

from typing import Iterable

from .diagnostics import (
    Diagnostic,
    Severity,
    has_errors,
    render_human,
    render_json,
    sort_diagnostics,
)
from .engine_rules import analyze_engine
from .graph_view import GraphView
from .program import analyze_program
from .rules import DEEP_RULE_IDS, LOGICAL_RULES, RULES

__all__ = [
    "AnalysisError",
    "DEEP_RULE_IDS",
    "Diagnostic",
    "GraphView",
    "RULES",
    "Severity",
    "analyze",
    "analyze_engine",
    "analyze_program",
    "has_errors",
    "render_human",
    "render_json",
    "sort_diagnostics",
    "suppress",
]

_SUPPRESS_ATTR = "_analysis_suppressed"


class AnalysisError(Exception):
    """Raised by ``pw.run(analysis="strict")`` when the verifier finds
    error-severity diagnostics before graph replay starts."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = diagnostics
        errors = [d for d in diagnostics if d.severity is Severity.ERROR]
        super().__init__(
            f"analysis found {len(errors)} error(s) — not starting the run\n"
            + render_human(diagnostics)
        )


def _mark_suppressed(table, rules: set[str]) -> None:
    existing = getattr(table, _SUPPRESS_ATTR, None)
    if existing is None:
        existing = set()
        setattr(table, _SUPPRESS_ATTR, existing)
    existing.update(rules)


class suppress:
    """Suppress rule ids for specific tables.

    ``suppress("PWL003", table)`` marks one table immediately;
    ``with suppress("PWL003"): ...`` marks every table built inside the
    block. Diagnostics of those rules anchored to marked tables are
    dropped by :func:`analyze`.
    """

    def __init__(self, *args):
        self.rules: set[str] = set()
        tables = []
        for a in args:
            if isinstance(a, str):
                self.rules.add(a.upper())
            else:
                tables.append(a)
        unknown = sorted(r for r in self.rules if r not in RULES)
        if unknown:
            raise ValueError(f"unknown analysis rule id(s): {', '.join(unknown)}")
        if not self.rules:
            raise ValueError("suppress() needs at least one rule id")
        for t in tables:
            _mark_suppressed(t, self.rules)
        self._start: int | None = None

    def __enter__(self) -> "suppress":
        from ..internals.parse_graph import G

        self._start = len(G.tables)
        return self

    def __exit__(self, *exc) -> bool:
        from ..internals.parse_graph import G

        if self._start is not None:
            for t in G.tables[self._start:]:
                _mark_suppressed(t, self.rules)
        return False


def analyze(
    graph=None, *, engine=None, deep: bool = False, stats: dict | None = None
) -> list[Diagnostic]:
    """Run the whole rule pack over a parse graph (default: the global
    graph ``G``). Pass ``engine=`` a lowered ``EngineGraph`` to include
    the engine-level checks; ``deep=True`` adds the op-level pass
    (rules PWL017-PWL020, see :mod:`.deep`). Returns diagnostics in
    stable order with per-table suppressions applied; when ``stats`` is
    a dict, ``stats["suppressed"]`` is set to the number of findings
    the suppressions dropped."""
    view = GraphView(graph)
    diags: list[Diagnostic] = []
    for rule_fn in LOGICAL_RULES:
        diags.extend(rule_fn(view))
    if deep:
        from .deep import analyze_deep

        diags.extend(analyze_deep(view))
    if engine is not None:
        diags.extend(analyze_engine(engine))
    by_id = {t._id: t for t in view.tables}
    kept = []
    n_suppressed = 0
    for d in diags:
        t = by_id.get(d.table_id) if d.table_id is not None else None
        if t is not None and d.rule in getattr(t, _SUPPRESS_ATTR, ()):
            n_suppressed += 1
            continue
        kept.append(d)
    if stats is not None:
        stats["suppressed"] = n_suppressed
    return sort_diagnostics(kept)
