"""Live table visualization (reference stdlib/viz/table_viz.py:1-165).

The reference renders through panel/tabulator; this container has no
panel/bokeh, so the same API renders dependency-light: pure-HTML
``_repr_html_`` for notebooks (auto-refreshing snapshot store fed by a
subscription for streaming graphs; immediate render for bounded ones)
with the reference's pointer/Json cell formatting."""

from __future__ import annotations

import html as _html
from typing import Any

from ...engine.value import Json, Pointer
from ...internals.parse_graph import G
from ...internals.table import Table


def _format_cell(x: Any, short_pointers: bool = True) -> str:
    if isinstance(x, Pointer):
        s = str(x)
        if len(s) > 8 and short_pointers:
            s = s[:8] + "..."
        return s
    if isinstance(x, Json):
        s = str(x)
        if len(s) > 64:
            s = s[:64] + " ..."
        return s
    return "" if x is None else str(x)


def _has_streaming_input(table: Table) -> bool:
    """Walk the operator DAG for connector sources (streaming graphs
    render live; bounded ones render immediately)."""
    seen: set[int] = set()
    stack = [table]
    while stack:
        t = stack.pop()
        if id(t) in seen:
            continue
        seen.add(id(t))
        op = getattr(t, "_op", None)
        if op is None:
            continue
        if op.kind == "connector":
            return True
        stack.extend(i for i in op.inputs if isinstance(i, Table))
    return False


class LiveTableView:
    """Returned by ``Table.show()``: renders the table's CURRENT state.
    For streaming graphs the view subscribes and keeps updating while
    ``pw.run()`` executes (the reference's auto-updating tabulator)."""

    def __init__(
        self,
        table: Table,
        *,
        snapshot: bool = True,
        include_id: bool = True,
        short_pointers: bool = True,
    ):
        self.table = table
        self.snapshot = snapshot
        self.include_id = include_id
        self.short_pointers = short_pointers
        self.names = table.column_names()
        self.rows: dict[Any, tuple] = {}
        self.changes: list[tuple] = []  # (key, row, time, diff)
        self.streaming = _has_streaming_input(table)
        if self.streaming:
            from ...io._subscribe import subscribe

            def on_change(key, row, time, is_addition):
                vals = tuple(row[n] for n in self.names)
                if is_addition:
                    self.rows[key] = vals
                else:
                    self.rows.pop(key, None)
                self.changes.append((key, vals, time, 1 if is_addition else -1))

            subscribe(self.table, on_change=on_change)
        else:
            from ...debug import _run_capture

            cap, names = _run_capture(table)
            self.names = names
            self.rows = dict(cap.state)
            self.changes = [
                (k, row, t, d) for k, row, t, d in getattr(cap, "stream", [])
            ]

    # -- renderers --

    def to_pandas(self):
        import pandas as pd

        keys = sorted(self.rows)
        data = {
            n: [self.rows[k][i] for k in keys] for i, n in enumerate(self.names)
        }
        if self.include_id:
            return pd.DataFrame(data, index=[Pointer(k) for k in keys])
        return pd.DataFrame(data)

    def _header_cols(self) -> list[str]:
        cols = (["id"] if self.include_id else []) + list(self.names)
        if not self.snapshot:
            cols += ["time", "diff"]
        return cols

    def _body_rows(self):
        if self.snapshot:
            for k in sorted(self.rows):
                yield ([Pointer(k)] if self.include_id else []) + list(self.rows[k])
        else:
            for k, row, t, d in self.changes:
                yield ([Pointer(k)] if self.include_id else []) + list(row) + [t, d]

    def _repr_html_(self) -> str:
        head = "".join(
            f"<th>{_html.escape(str(c))}</th>" for c in self._header_cols()
        )
        body = "".join(
            "<tr>"
            + "".join(
                f"<td>{_html.escape(_format_cell(v, self.short_pointers))}</td>"
                for v in row
            )
            + "</tr>"
            for row in self._body_rows()
        )
        note = (
            "<div style='color:#888;font-size:smaller'>live: updates while "
            "pw.run() executes</div>"
            if self.streaming
            else ""
        )
        return (
            f"{note}<table border='1'><thead><tr>{head}</tr></thead>"
            f"<tbody>{body}</tbody></table>"
        )

    def __repr__(self) -> str:
        cols = self._header_cols()
        lines = [" | ".join(str(c) for c in cols)]
        for row in self._body_rows():
            lines.append(
                " | ".join(_format_cell(v, self.short_pointers) for v in row)
            )
        return "\n".join(lines)


def show(
    self: Table,
    *,
    snapshot: bool = True,
    include_id: bool = True,
    short_pointers: bool = True,
    sorters=None,
) -> LiveTableView:
    """Display the table in a notebook (reference Table.show
    table_viz.py:26): immediate preview for bounded inputs,
    auto-updating during ``pw.run()`` for streaming ones."""
    return LiveTableView(
        self,
        snapshot=snapshot,
        include_id=include_id,
        short_pointers=short_pointers,
    )



