"""pw.stdlib.viz (reference stdlib/viz/): live table views + plotting.

Attaches ``Table.show`` / ``Table.plot`` (reference table_viz.py,
plotting.py). Unlike the reference, NO notebook repr hook is installed:
rendering a bare table must never run the graph or register
subscriptions as a side effect — call ``t.show()`` deliberately."""

from __future__ import annotations

from ...internals.table import Table
from .plotting import LivePlotView, plot
from .table_viz import LiveTableView, show


def table_viz(table: Table, **kwargs):
    """Back-compat helper: a pandas styler / view for notebook display."""
    view = LiveTableView(table)
    df = view.to_pandas()
    try:
        return df.style
    except Exception:
        return df


# explicit methods only: a bare `t` in a notebook must NOT run the
# graph or register subscriptions as a repr side effect — users call
# t.show() / t.plot() deliberately (they run/subscribe, documented)
Table.show = show
Table.plot = plot

__all__ = ["LivePlotView", "LiveTableView", "plot", "show", "table_viz"]
