"""KNNIndex — the classic KNN retrieval API.

The port's copy of the reference's ``stdlib/ml/index.py`` (upstream
Pathway's stdlib/ml/index.py, KNNIndex :9). The upstream implementation
uses LSH bucketing with per-bucket numpy top-k; here it rides the
port's device-resident brute-force index (``ops/knn.DeviceKnnIndex``):
exact top-k (kernel B2 on the card), retraction-aware, with the LSH
tuning args accepted for API compatibility. ``rerank=`` orders each
query's hits with the port's cross-encoder (``models/reranker.as_reranker``).
``device``: ``None`` places the index on ``"cuda"``; ``"cpu"`` only when
asked.

Distance conventions match the reference: "euclidean" -> squared L2
distance, "cosine" -> 1 - cosine similarity.
"""

from __future__ import annotations

from typing import Literal

from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table
from ..indexing.colnames import _INDEX_REPLY, _SCORE
from ..indexing.nearest_neighbors import BruteForceKnn

DistanceTypes = Literal["euclidean", "cosine"]


class KNNIndex:
    def __init__(
        self,
        data_embedding: ColumnReference,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: DistanceTypes = "euclidean",
        metadata: ColumnExpression | None = None,
        reserved_space: int = 1024,
        mesh=None,
        tiers=None,
        tenant: str | None = None,
        rerank=None,
        rerank_column: str = "data",
        device=None,
    ):
        self.data = data
        self.distance_type = distance_type
        # optional on-device rerank stage (models/reranker.py): scores
        # retrieved candidates through the local cross-encoder instead
        # of an HTTP LLM xpack. The scorer builds lazily on the first
        # query, so declaring it here costs nothing at graph build.
        from ...models.reranker import as_reranker

        self.reranker = as_reranker(rerank)
        self.rerank_column = rerank_column
        metric = "l2" if distance_type == "euclidean" else "cos"
        # mesh= (None: the run-scoped mesh) shards the index over a mesh's
        # data axis; tiers= / tenant= raise in BruteForceKnn until their
        # planes are ported
        self.inner = BruteForceKnn(
            data_embedding,
            metadata,
            dimensions=n_dimensions,
            reserved_space=reserved_space,
            metric=metric,
            mesh=mesh,
            tiers=tiers,
            tenant=tenant,
            device=device,
        )

    def _get(
        self,
        query_embedding: ColumnReference,
        k,
        collapse_rows: bool,
        with_distances: bool,
        metadata_filter,
        as_of_now: bool,
        query_text: ColumnReference | None = None,
    ) -> Table:
        data_cols = list(self.data._columns.keys())
        raw = self.inner._build_query(
            query_embedding,
            number_of_matches=k,
            metadata_filter=metadata_filter,
            data_cols=data_cols,
            as_of_now=as_of_now,
        )
        if self.distance_type == "euclidean":
            to_dist = lambda scores: tuple(-s for s in scores)
        else:
            to_dist = lambda scores: tuple(1.0 - s for s in scores)
        from ... import apply_with_type
        from ...internals import dtype as dt

        if collapse_rows:
            sel = {n: raw[f"_pw_data_{n}"] for n in data_cols}
            if with_distances:
                sel["dist"] = apply_with_type(to_dist, dt.ANY, raw[_SCORE])
            if (
                self.reranker is not None
                and query_text is not None
                and self.rerank_column in data_cols
            ):
                # device rerank stage: one permutation per query row
                # (descending cross-encoder score), applied to every
                # result column so rows stay aligned
                reranker = self.reranker
                order = apply_with_type(
                    lambda q, docs: reranker.order(q, docs),
                    dt.ANY,
                    query_text,
                    sel[self.rerank_column],
                )
                permute = lambda t, o: tuple(t[i] for i in o)
                sel = {
                    n: apply_with_type(permute, dt.ANY, expr, order)
                    for n, expr in sel.items()
                }
            return raw.select(**sel)
        # flat format: one row per match, query_id column
        tmp = raw.select(query_id=raw.id, match=raw[_INDEX_REPLY])
        flat = tmp.flatten(tmp.match)
        match = flat.match
        ixed = self.data.ix(match.get(0), optional=True)
        sel = {n: ixed[n] for n in data_cols}
        if with_distances:
            if self.distance_type == "euclidean":
                sel["dist"] = apply_with_type(lambda m: -m[1], dt.FLOAT, match)
            else:
                sel["dist"] = apply_with_type(lambda m: 1.0 - m[1], dt.FLOAT, match)
        sel["query_id"] = flat.query_id
        return flat.select(**sel)

    def get_nearest_items(
        self,
        query_embedding: ColumnReference,
        k: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
        query_text: ColumnReference | None = None,
    ) -> Table:
        """Incremental: results update as better documents arrive.
        ``query_text`` (the raw query string column) enables the
        on-device rerank stage when the index was built with
        ``rerank=``."""
        return self._get(
            query_embedding,
            k,
            collapse_rows,
            with_distances,
            metadata_filter,
            False,
            query_text=query_text,
        )

    def get_nearest_items_asof_now(
        self,
        query_embedding: ColumnReference,
        k: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
        query_text: ColumnReference | None = None,
    ) -> Table:
        """Answers reflect the index as of query arrival; never updated."""
        return self._get(
            query_embedding,
            k,
            collapse_rows,
            with_distances,
            metadata_filter,
            True,
            query_text=query_text,
        )
