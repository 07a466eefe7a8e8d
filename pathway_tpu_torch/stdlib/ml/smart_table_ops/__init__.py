"""Fuzzy joins: match rows across tables by shared weighted features.

API-parity rebuild of
upstream Pathway's python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py
(fuzzy_match :265, fuzzy_match_tables :106, fuzzy_self_match :249,
smart_fuzzy_match :199, schemas :14-33, enums :43-97) with a different
matching engine: instead of the reference's iterate-based incremental
bucket algorithm, pair scores are computed with relational ops (feature
join + groupby sum) and the final one-to-one assignment runs as a
greedy maximum-weight matching inside one global reduce — recomputed
per delta batch, which keeps incremental semantics (retractions just
rescore) without nested iteration.
"""

from __future__ import annotations

import math
from enum import IntEnum, auto
from typing import Any

from .... import reducers
from ....engine.value import Pointer
from ....internals.expression import ColumnReference, apply
from ....internals.schema import Schema
from ....internals.table import Table
from ....internals.thisclass import this


class Node(Schema):
    pass


class Feature(Schema):
    weight: float
    normalization_type: int


class Edge(Schema):
    node: Pointer
    feature: Pointer
    weight: float


class JoinResult(Schema):
    left: Pointer
    right: Pointer
    weight: float


def _tokenize(obj: Any):
    return tuple(str(obj).lower().split())


def _letters(obj: Any):
    return tuple(c for c in str(obj).lower() if c.isalnum())


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = auto()
    TOKENIZE = auto()
    LETTERS = auto()

    @property
    def generate(self):
        if self == FuzzyJoinFeatureGeneration.LETTERS:
            return _letters
        return _tokenize


def _discrete_weight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1 / (2 ** math.ceil(math.log2(cnt)))


def _discrete_logweight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1 / math.ceil(math.log2(cnt + 1))


def _none(cnt: float) -> float:
    return cnt


class FuzzyJoinNormalization(IntEnum):
    WEIGHT = auto()
    LOGWEIGHT = auto()
    NONE = auto()

    @property
    def normalize(self):
        if self == FuzzyJoinNormalization.WEIGHT:
            return _discrete_weight
        if self == FuzzyJoinNormalization.LOGWEIGHT:
            return _discrete_logweight
        return _none


_NORM_BY_TYPE = {
    int(FuzzyJoinNormalization.WEIGHT): _discrete_weight,
    int(FuzzyJoinNormalization.LOGWEIGHT): _discrete_logweight,
    int(FuzzyJoinNormalization.NONE): _none,
}


def _greedy_matching(pairs) -> tuple:
    """Greedy maximum-weight one-to-one matching over (left, right,
    weight) tuples: heaviest pair first, each node used once. The
    assignment step of the reference's fuzzy join, as plain code."""
    used_l: set = set()
    used_r: set = set()
    out = []
    for left, right, weight in sorted(
        pairs, key=lambda p: (-p[2], repr(p[0]), repr(p[1]))
    ):
        if left in used_l or right in used_r or weight <= 0:
            continue
        used_l.add(left)
        used_r.add(right)
        out.append((left, right, weight))
    return tuple(out)


def _score_pairs(el: Table, er: Table, fweights: Table, symmetric: bool) -> Table:
    """(left, right, weight) pair scores: join edge sets on shared
    feature, weight each shared feature (edge weights × feature weight),
    sum per pair. el/er columns: (node, feature, w); fweights columns:
    (feature, fw)."""
    pairs = el.join_inner(er, el.feature == er.feature).select(
        left=el.node,
        right=er.node,
        feature=el.feature,
        pw_=el.w * er.w,
    )
    if symmetric:
        pairs = pairs.filter(
            apply(lambda l, r: int(l) < int(r), this.left, this.right)
        )
    contrib = pairs.join_inner(fweights, pairs.feature == fweights.feature).select(
        left=pairs.left, right=pairs.right, c=pairs.pw_ * fweights.fw
    )
    return contrib.groupby(this.left, this.right).reduce(
        left=this.left, right=this.right, weight=reducers.sum(this.c)
    )


def _match_from_scores(scores: Table) -> Table:
    """scores: (left, right, weight) → one-to-one greedy assignment."""
    agg = scores.reduce(
        ms=reducers.tuple(
            apply(lambda l, r, w: (l, r, w), this.left, this.right, this.weight)
        )
    )
    flat = agg.select(ms=apply(_greedy_matching, this.ms)).flatten(this.ms)
    return flat.select(
        left=apply(lambda m: m[0], this.ms),
        right=apply(lambda m: m[1], this.ms),
        weight=apply(lambda m: float(m[2]), this.ms),
    )


def _fuzzy_match(
    edges_left: Table,
    edges_right: Table,
    features: Table,
    symmetric: bool,
    by_hand_match: Table | None = None,
) -> Table:
    el = edges_left.select(node=this.node, feature=this.feature, w=this.weight)
    er = edges_right.select(node=this.node, feature=this.feature, w=this.weight)
    if by_hand_match is not None:
        # nodes already matched by hand don't participate (anti-join)
        el = _without_nodes(el, by_hand_match.select(node=this.left))
        er = _without_nodes(er, by_hand_match.select(node=this.right))
    all_edges = el if symmetric else el.concat_reindex(er)
    cnt = all_edges.groupby(this.feature).reduce(
        feature=this.feature, cnt=reducers.count()
    )
    fweights = features.join_inner(cnt, features.id == cnt.feature).select(
        feature=cnt.feature,
        fw=apply(
            lambda w, ntype, c: w * _NORM_BY_TYPE[int(ntype)](c),
            features.weight,
            features.normalization_type,
            cnt.cnt,
        ),
    )
    scores = _score_pairs(el, er, fweights, symmetric)
    res = _match_from_scores(scores)
    if by_hand_match is not None:
        res = res.concat_reindex(
            by_hand_match.select(left=this.left, right=this.right, weight=this.weight)
        )
    return res


def _without_nodes(edges: Table, banned: Table) -> Table:
    """Anti-join: keep edges whose node is not in banned.node."""
    flagged = edges.join_left(banned, edges.node == banned.node).select(
        node=edges.node, feature=edges.feature, w=edges.w, banned=banned.node
    )
    return flagged.filter(apply(lambda b: b is None, this.banned)).select(
        node=this.node, feature=this.feature, w=this.w
    )


def fuzzy_self_match(
    edges: Table, features: Table, by_hand_match: Table | None = None, **kw
) -> Table:
    return _fuzzy_match(edges, edges, features, symmetric=True, by_hand_match=by_hand_match)


def fuzzy_match(
    edges_left: Table,
    edges_right: Table,
    features: Table,
    by_hand_match: Table | None = None,
    **kw,
) -> Table:
    return _fuzzy_match(
        edges_left, edges_right, features, symmetric=False, by_hand_match=by_hand_match
    )


def fuzzy_match_with_hint(
    edges_left: Table,
    edges_right: Table,
    features: Table,
    by_hand_match: Table,
    **kw,
) -> Table:
    return _fuzzy_match(
        edges_left, edges_right, features, symmetric=False, by_hand_match=by_hand_match
    )


def _edges_from_column(col: ColumnReference, generate) -> Table:
    """(node, tok) edges: one row per generated feature token."""
    tab = col._table
    return tab.select(tok=apply(generate, col)).flatten(this.tok, origin_id="node")


def _fuzzy_match_columns(
    left_col: ColumnReference,
    right_col: ColumnReference,
    normalization: FuzzyJoinNormalization,
    feature_generation: FuzzyJoinFeatureGeneration,
    symmetric: bool,
) -> Table:
    """Column-level fuzzy match on token strings (high-level path: the
    feature table is implicit, keyed by token)."""
    gen = feature_generation.generate
    norm = normalization.normalize
    el = _edges_from_column(left_col, gen).select(
        node=this.node, feature=this.tok, w=1.0
    )
    # symmetric: alias the same edge set so the self-join sees two tables
    er = (
        el.select(node=this.node, feature=this.feature, w=this.w)
        if symmetric
        else _edges_from_column(right_col, gen).select(
            node=this.node, feature=this.tok, w=1.0
        )
    )
    all_edges = el if symmetric else el.concat_reindex(er)
    cnt = all_edges.groupby(this.feature).reduce(
        feature=this.feature, cnt=reducers.count()
    )
    normw = cnt.select(feature=this.feature, fw=apply(norm, this.cnt))
    return _match_from_scores(_score_pairs(el, er, normw, symmetric))


def smart_fuzzy_match(
    left_col: ColumnReference,
    right_col: ColumnReference,
    *,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    **kw,
) -> Table:
    """Fuzzy match two text columns (reference smart_fuzzy_match :199)."""
    symmetric = (
        left_col._table is right_col._table and left_col._name == right_col._name
    )
    res = _fuzzy_match_columns(
        left_col, right_col, normalization, feature_generation, symmetric
    )
    if by_hand_match is not None:
        res = res.concat_reindex(
            by_hand_match.select(left=this.left, right=this.right, weight=this.weight)
        )
    return res


def _concat_columns_table(table: Table, projection: dict[str, str]) -> Table:
    names = list(projection.keys()) if projection else list(table.column_names())
    return table.select(
        desc=apply(lambda *args: " ".join(str(a) for a in args), *[table[n] for n in names])
    )


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    left_projection: dict[str, str] | None = None,
    right_projection: dict[str, str] | None = None,
) -> Table:
    """Fuzzy match rows of two tables by the text of their columns
    (reference fuzzy_match_tables :106). Returns (left, right, weight)
    with the original row ids as Pointers."""
    left_desc = _concat_columns_table(left_table, left_projection or {})
    right_desc = _concat_columns_table(right_table, right_projection or {})
    res = smart_fuzzy_match(
        left_desc.desc,
        right_desc.desc,
        by_hand_match=by_hand_match,
        normalization=normalization,
        feature_generation=feature_generation,
    )
    return res


__all__ = [
    "Edge",
    "Feature",
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "JoinResult",
    "Node",
    "fuzzy_match",
    "fuzzy_match_tables",
    "fuzzy_match_with_hint",
    "fuzzy_self_match",
    "smart_fuzzy_match",
]
