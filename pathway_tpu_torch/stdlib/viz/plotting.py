"""Live plotting (reference stdlib/viz/plotting.py:1-138).

The reference builds bokeh plots in a panel Column; without bokeh in
the image, the same API drives any plotting callable: it receives a
bokeh ColumnDataSource when bokeh IS importable, else the snapshot
DataFrame — and the returned view renders via matplotlib/pandas in
notebooks, re-plotting as streaming updates land."""

from __future__ import annotations

from typing import Any, Callable

from ...internals.table import Table
from .table_viz import LiveTableView


class LivePlotView:
    def __init__(self, table: Table, plotting_function: Callable, sorting_col=None):
        self.view = LiveTableView(table, include_id=False)
        self.plotting_function = plotting_function
        self.sorting_col = sorting_col

    def _source(self):
        df = self.view.to_pandas()
        if self.sorting_col:
            df = df.sort_values(self.sorting_col)
        try:
            from bokeh.models import ColumnDataSource  # type: ignore

            return ColumnDataSource(df)
        except ImportError:
            return df

    def figure(self):
        src = self._source()
        if self.plotting_function is None:
            # back-compat default: pandas' own plot over the snapshot
            df = src if hasattr(src, "plot") else self.view.to_pandas()
            return df.plot()
        return self.plotting_function(src)

    def _repr_html_(self) -> str:
        fig = self.figure()
        # matplotlib figures/axes render to inline PNG
        mpl_fig = getattr(fig, "figure", fig)
        if hasattr(mpl_fig, "savefig"):
            import base64
            import io

            buf = io.BytesIO()
            mpl_fig.savefig(buf, format="png", bbox_inches="tight")
            data = base64.b64encode(buf.getvalue()).decode()
            return f"<img src='data:image/png;base64,{data}'/>"
        if hasattr(fig, "_repr_html_"):
            return fig._repr_html_()
        return self.view._repr_html_()


def plot(
    self: Table,
    plotting_function: Callable[[Any], Any] | None = None,
    sorting_col=None,
) -> LivePlotView:
    """Plot the table's contents (reference Table.plot plotting.py:35):
    ``plotting_function(source)`` gets a bokeh ColumnDataSource when
    bokeh is installed, else the pandas DataFrame snapshot."""
    return LivePlotView(self, plotting_function, sorting_col)
