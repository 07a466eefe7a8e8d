"""Error-log tables: route row-level failures to data instead of aborting.

Rebuild of upstream Pathway's python/pathway/internals/errors.py
(global_error_log/local_error_log) + the engine side Graph::error_log
(upstream Pathway's src/engine/graph.rs:983-992). With
``pw.run(terminate_on_error=False)`` a failing expression/UDF yields the
ERROR value for that row and appends (operator_id, message, trace) to
the active error-log tables; with the default ``True`` the run aborts on
first failure.
"""

from __future__ import annotations

import contextlib
from typing import Generator

from ..engine.value import Json
from .parse_graph import G
from .schema import Schema


class ErrorLogSchema(Schema):
    operator_id: int
    message: str
    trace: Json | None


def _make_error_log_table():
    from .table import Column, LogicalOp, Table
    from .universe import Universe

    # single source of truth: the table shape IS the public schema
    cols = {n: Column(t) for n, t in ErrorLogSchema.dtypes().items()}
    op = LogicalOp("error_log", [], {})
    return Table(cols, Universe(), op, name="error_log")


def global_error_log():
    """The run-wide error log table (errors from rows processed while no
    local_error_log() context is active)."""
    if not G.error_log_tables:
        G.error_log_tables.append(_make_error_log_table())
    return G.error_log_tables[0]


@contextlib.contextmanager
def local_error_log() -> Generator:
    """Context manager yielding a fresh error-log table. Divergence from
    the reference (which scopes logs to operators built inside the
    context): in this build every lowered error log receives all row
    errors of the run."""
    yield _make_error_log_table()


class DeadLetterSchema(Schema):
    """Shape of ``.failed`` dead-letter tables: the offending row's
    input values (JSON-rendered), plus the same (operator_id, message,
    trace) triple the error log carries."""

    args: Json | None
    operator_id: int
    message: str
    trace: Json | None


_dead_letter_seq = [0]


def new_dead_letter_id() -> int:
    """Fresh routing id tying one operator's failures to its ``.failed``
    table. Monotonic across clear_graph(): ids are only ever matched
    within one built program, so gaps are harmless."""
    _dead_letter_seq[0] += 1
    return _dead_letter_seq[0]


def dead_letter_table(dl_id: int, *, name: str = "dead_letter"):
    """A table fed by the engine's dead-letter sessions for ``dl_id`` —
    rows a UDF / AsyncTransformer failed on under
    ``on_error="dead_letter"``. Lowered via LogicalOp kind
    ``dead_letter`` (graph_runner._lower_dead_letter)."""
    from .table import Column, LogicalOp, Table
    from .universe import Universe

    cols = {n: Column(t) for n, t in DeadLetterSchema.dtypes().items()}
    op = LogicalOp("dead_letter", [], {"dl_id": dl_id})
    return Table(cols, Universe(), op, name=f"{name}_{dl_id}")
