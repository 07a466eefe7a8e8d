"""Diagnostic records for the pre-execution graph verifier.

A :class:`Diagnostic` names one finding of one rule (``PWL001``…) at one
operator of the parse graph (or one lowered engine node).  The same
operator identity appears in runtime ``EngineError``s (node name/id +
build-time user frame, see ``engine/dataflow.py``), so a static finding
and the runtime failure it predicts cite the same source location.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from ..internals.trace import Frame

__all__ = [
    "Severity",
    "Diagnostic",
    "render_human",
    "render_json",
    "has_errors",
    "sort_diagnostics",
]


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    @property
    def rank(self) -> int:
        return {"error": 0, "warning": 1, "info": 2}[self.value]

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


@dataclass(frozen=True)
class Diagnostic:
    """One rule finding, anchored to an operator of the graph."""

    rule: str                    # stable id: "PWL002"
    severity: Severity
    message: str
    table: str | None = None     # table name the finding is about
    table_id: int | None = None
    op_kind: str | None = None   # logical op kind / engine node class
    trace: Frame | None = None   # user call site that built the operator
    detail: dict = field(default_factory=dict, compare=False)

    def as_dict(self) -> dict:
        out = {
            "rule": self.rule,
            "severity": self.severity.value,
            "message": self.message,
        }
        if self.table is not None:
            out["table"] = self.table
        if self.op_kind is not None:
            out["op"] = self.op_kind
        if self.trace is not None:
            out["location"] = {
                "file": self.trace.filename,
                "line": self.trace.line_number,
                "function": self.trace.function,
            }
        if self.detail:
            out["detail"] = _json_safe(dict(sorted(self.detail.items())))
        return out

    def render(self) -> str:
        where = ""
        if self.table is not None:
            where = f" [table {self.table!r}"
            if self.op_kind is not None:
                where += f", op {self.op_kind}"
            where += "]"
        elif self.op_kind is not None:
            where = f" [op {self.op_kind}]"
        loc = ""
        if self.trace is not None:
            src = (self.trace.line or "").strip()
            loc = (
                f"\n    at {self.trace.filename}:{self.trace.line_number},"
                f" in {self.trace.function}"
            )
            if src:
                loc += f"\n        {src}"
        return f"{self.rule} {self.severity.value}: {self.message}{where}{loc}"


def _json_safe(value):
    """Make a detail payload JSON-renderable: drop underscore-prefixed
    keys (graph-object anchors like an index spec's ``_table``) and
    stringify anything the json encoder cannot take, so a rule can put
    rich objects in ``detail`` without breaking ``--json`` output."""
    if isinstance(value, dict):
        return {
            k: _json_safe(v)
            for k, v in value.items()
            if not (isinstance(k, str) and k.startswith("_"))
        }
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if value is None or isinstance(value, (str, int, float, bool)):
        return value
    return type(value).__name__


def sort_diagnostics(diags: Iterable[Diagnostic]) -> list[Diagnostic]:
    """Stable presentation order: severity, then rule id, then location."""
    return sorted(
        diags,
        key=lambda d: (
            d.severity.rank,
            d.rule,
            d.table_id if d.table_id is not None else -1,
            d.message,
        ),
    )


def has_errors(diags: Iterable[Diagnostic]) -> bool:
    return any(d.severity is Severity.ERROR for d in diags)


def render_human(diags: Sequence[Diagnostic]) -> str:
    diags = sort_diagnostics(diags)
    if not diags:
        return "analysis: no findings"
    lines = [d.render() for d in diags]
    n_err = sum(d.severity is Severity.ERROR for d in diags)
    n_warn = sum(d.severity is Severity.WARNING for d in diags)
    n_info = len(diags) - n_err - n_warn
    lines.append(
        f"analysis: {n_err} error(s), {n_warn} warning(s), {n_info} info"
    )
    return "\n".join(lines)


def render_json(diags: Sequence[Diagnostic], *, suppressed: int = 0) -> str:
    """Machine-readable output; key order and diagnostic order are stable
    so the golden test in tests/test_analysis_rules.py can byte-compare.

    Diagnostics sort by (rule, node id, message) — not by severity — so
    a severity downgrade or a new unrelated rule does not reorder the
    whole CI diff; ``suppressed`` reports how many findings per-table
    suppressions dropped, keeping the summary stable across runs that
    only differ in suppression placement."""
    ordered = sorted(
        diags,
        key=lambda d: (
            d.rule,
            d.table_id if d.table_id is not None else -1,
            d.message,
        ),
    )
    payload = {
        "diagnostics": [d.as_dict() for d in ordered],
        "summary": {
            "error": sum(d.severity is Severity.ERROR for d in diags),
            "warning": sum(d.severity is Severity.WARNING for d in diags),
            "info": sum(d.severity is Severity.INFO for d in diags),
            "suppressed": int(suppressed),
        },
    }
    return json.dumps(payload, indent=2, sort_keys=True)
