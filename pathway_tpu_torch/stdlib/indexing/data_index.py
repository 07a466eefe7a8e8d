"""InnerIndex / DataIndex — the unified retriever API.

Rebuild of upstream Pathway's python/pathway/stdlib/indexing/data_index.py
(InnerIndex :206, DataIndex :278). An InnerIndex answers queries with
(id, score) tuples in the ``_pw_index_reply`` column; DataIndex augments
replies with columns from the data table. Unlike the reference — which
repacks via flatten + join in Python — the TPU build's external-index
operator returns the augmented columns directly (matched rows are
mirrored in-operator; see graph_runner._lower_external_index), so
``query``/``query_as_of_now`` here just configure that operator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ...internals import dtype as dt
from ...internals.expression import ColumnExpression, ColumnReference, smart_wrap
from ...internals.table import Column, LogicalOp, Table
from .colnames import _INDEX_REPLY, _SCORE


@dataclass(frozen=True)
class InnerIndex:
    """Abstract inner index over ``data_column`` with optional JMESPath
    ``metadata_column`` filtering (reference data_index.py:206)."""

    data_column: ColumnReference
    metadata_column: ColumnExpression | None = None

    # --- subclass protocol ---

    def _index_factory(self) -> Callable[[], Any]:
        """() -> engine-level index (add/remove/search_batch)."""
        raise NotImplementedError

    def _embed_fns(self) -> tuple[Callable | None, Callable | None]:
        """(data_embed, query_embed) batch callables or None."""
        return None, None

    def _index_spec(self) -> dict | None:
        """Static description of a device-backed index, or None."""
        return None

    # --- shared query building ---

    def _build_query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
        data_cols: list[str] | None = None,
        as_of_now: bool = True,
    ) -> Table:
        data_table = self.data_column._table
        query_table = query_column._table
        data_embed, query_embed = self._embed_fns()
        data_cols = data_cols or []
        params = {
            "index_factory": self._index_factory(),
            "data_payload": self.data_column,
            "data_metadata": self.metadata_column,
            "query_payload": query_column,
            "query_k": smart_wrap(number_of_matches),
            "query_filter": metadata_filter,
            "data_cols": data_cols,
            "data_embed": data_embed,
            "query_embed": query_embed,
            "asof_now": as_of_now,
        }
        op = LogicalOp("external_index", [query_table, data_table], params)
        cols = {n: Column(c.dtype) for n, c in query_table._columns.items()}
        cols[_INDEX_REPLY] = Column(dt.ANY)
        cols[_SCORE] = Column(dt.ANY)
        for n in data_cols:
            cols[f"_pw_data_{n}"] = Column(dt.ANY)
        result = Table(cols, query_table._universe, op, name="index_reply")
        spec = self._index_spec()
        if spec is not None:
            # the graph's record of its device indexes and their mesh
            # axes, made before anything is allocated
            from ...internals.parse_graph import G

            G.external_indexes.append(spec)
        return result

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """Fully incremental: answers update when the index changes."""
        return self._build_query(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
            as_of_now=False,
        )

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._build_query(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
            as_of_now=True,
        )


@dataclass
class DataIndex:
    """Augments inner-index replies with columns of ``data_table``
    (reference data_index.py:278). The returned table is keyed by the
    query table's ids; each data column holds a tuple of matched values
    (collapse_rows=True format) plus ``_pw_index_reply_score``."""

    data_table: Table
    inner_index: InnerIndex

    def _query(
        self,
        query_column: ColumnReference,
        number_of_matches,
        metadata_filter,
        as_of_now: bool,
        collapse_rows: bool = True,
    ) -> Table:
        data_cols = list(self.data_table._columns.keys())
        raw = self.inner_index._build_query(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
            data_cols=data_cols,
            as_of_now=as_of_now,
        )
        if not collapse_rows:
            # flat format (reference _extract_data_flat): one row per
            # match, query id in ``query_id``
            tmp = raw.select(query_id=raw.id, match=raw[_INDEX_REPLY])
            flat = tmp.flatten(tmp.match)
            ixed = self.data_table.ix(flat.match.get(0), optional=True)
            sel = {n: ixed[n] for n in data_cols}
            sel[_SCORE] = flat.match.get(1)
            sel["query_id"] = flat.query_id
            return flat.select(**sel)
        # collapsed: rename _pw_data_* back to plain data column names
        sel: dict[str, Any] = {}
        for n in data_cols:
            sel[n] = raw[f"_pw_data_{n}"]
        sel[_SCORE] = raw[_SCORE]
        sel[_INDEX_REPLY] = raw[_INDEX_REPLY]
        return raw.select(**sel)

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._query(
            query_column, number_of_matches, metadata_filter, False, collapse_rows
        )

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._query(
            query_column, number_of_matches, metadata_filter, True, collapse_rows
        )
