"""Cross-graph table export/import.

Rebuild of upstream Pathway's src/engine/dataflow/export.rs (R32
ExportedTable) + Graph::export_table/import_table (graph.rs:630): run a
pipeline's subgraph to completion, capture its final state and update
stream, and re-import that as a static source in ANOTHER graph."""

from __future__ import annotations

from dataclasses import dataclass, field

from .table import Column, LogicalOp, Table
from .universe import Universe


@dataclass
class ExportedTable:
    """Frozen contents of a table from a finished (sub)run."""

    column_names: list[str]
    dtypes: list
    rows: dict[int, tuple]  # final state: key -> row
    stream: list[tuple[int, tuple, int, int]] = field(default_factory=list)


def export_table(table: Table) -> ExportedTable:
    """Execute the subgraph feeding ``table`` and freeze its contents
    (the exporting graph runs to completion, like the reference's
    ExportedTable handing a finished trace across scopes)."""
    from .graph_runner import GraphRunner

    runner = GraphRunner()
    cap, names = runner.capture(table)
    runner.run()
    dtypes = [c.dtype for c in table._columns.values()]
    return ExportedTable(
        column_names=list(names),
        dtypes=dtypes,
        rows=dict(cap.state),
        stream=list(cap.stream),
    )


def import_table(exported: ExportedTable, *, with_history: bool = False) -> Table:
    """Materialize an ExportedTable as a source in the CURRENT graph.
    ``with_history`` replays the full update stream at its original
    times instead of just the final state."""
    if with_history:
        records = list(exported.stream)
    else:
        records = [(k, row, 0, 1) for k, row in exported.rows.items()]
    cols = {n: Column(t) for n, t in zip(exported.column_names, exported.dtypes)}
    op = LogicalOp("static", [], {"rows": records})
    return Table(cols, Universe(), op, name="imported")
