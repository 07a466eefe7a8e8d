"""KNN/LSH classifiers.

Rebuild of upstream Pathway's python/pathway/stdlib/ml/classifiers/
(_knn_lsh.py knn_lsh_classifier_train :64, knn_lsh_classify; _lsh.py
random-projection bucketers :97). The training function returns a query
closure like the reference's; retrieval rides the device KNN index
(exact top-k) rather than host LSH buckets — the LSH tuning parameters
are accepted for API compatibility.
"""

from __future__ import annotations

from collections import Counter
from typing import Literal

from ....internals.expression import ColumnExpression
from ....internals.table import Table

DistanceTypes = Literal["euclidean", "cosine"]


def knn_lsh_classifier_train(
    data: Table,
    L: int = 20,
    d: int | None = None,
    M: int = 10,
    A: float = 10.0,
    type: DistanceTypes = "euclidean",
    device=None,
):
    """data: table with columns ``data`` (embedding) and optional
    ``metadata``. Returns queryfn(queries, k, with_distances=False,
    metadata_filter=None) -> collapsed knn table (reference
    _knn_lsh.py:64). ``device`` places the index as ``KNNIndex`` does:
    ``None`` on the card, ``"cpu"`` only when asked."""
    from ..index import KNNIndex

    metadata = data.metadata if "metadata" in data._columns else None
    index = KNNIndex(
        data.data,
        data,
        n_dimensions=d or 0,
        n_or=L,
        n_and=M,
        bucket_length=A,
        distance_type=type,
        metadata=metadata,
        device=device,
    )

    def query_fn(
        queries: Table,
        k: int = 3,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return index.get_nearest_items(
            queries.data,
            k=k,
            with_distances=with_distances,
            metadata_filter=metadata_filter,
        )

    return query_fn


def knn_lsh_generic_classifier_train(
    data: Table, lsh_projection=None, distance_function=None, k: int = 3, device=None
):
    """Generic variant — same query closure as knn_lsh_classifier_train
    (custom projections collapse to exact search on device)."""
    return knn_lsh_classifier_train(data, device=device)


def knn_lsh_classify(knn_model, data_labels: Table, queries: Table, k: int = 3) -> Table:
    """Majority-vote classification over the k nearest neighbors
    (reference _knn_lsh.py knn_lsh_classify)."""
    from .... import apply_with_type
    from ....internals import dtype as dt

    labeled = knn_model(queries, k)

    def majority(labels):
        labels = [l for l in (labels or ()) if l is not None]
        if not labels:
            return None
        return Counter(labels).most_common(1)[0][0]

    return labeled.select(
        predicted_label=apply_with_type(majority, dt.ANY, labeled.label)
    )
