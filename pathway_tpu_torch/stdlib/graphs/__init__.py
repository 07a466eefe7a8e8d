"""Graph algorithms (reference stdlib/graphs/: bellman_ford, louvain,
pagerank). Implemented over pw.iterate fixpoints."""

from __future__ import annotations

from dataclasses import dataclass

from ...internals.table import Table


@dataclass
class Graph:
    """Vertex/edge pair (reference stdlib/graphs/common.py)."""

    V: Table
    E: Table


@dataclass
class WeightedGraph(Graph):
    """Weighted (multi)graph: WE has columns (u, v, weight), directed-
    doubled for undirected graphs (reference stdlib/graphs/graph.py
    WeightedGraph :121)."""

    WE: Table

    @staticmethod
    def from_vertices_and_weighted_edges(V: Table, WE: Table) -> "WeightedGraph":
        return WeightedGraph(V=V, E=WE, WE=WE)


def pagerank(edges: Table, steps: int = 5, damping: float = 0.85) -> Table:
    """PageRank over an edge table with columns (u, v): returns table
    keyed by vertex with column `rank` (scaled int, like the reference
    stdlib/graphs/pagerank.py)."""
    import pathway_tpu_torch as pw

    vertices_u = edges.select(v=edges.u)
    vertices_v = edges.select(v=edges.v)
    vertices = (
        vertices_u.concat_reindex(vertices_v)
        .groupby(pw.this.v)
        .reduce(v=pw.this.v)
        .with_id_from(pw.this.v)
    )
    degs = edges.groupby(edges.u).reduce(u=edges.u, degree=pw.reducers.count())
    degs = degs.with_id_from(pw.this.u)

    ranks = vertices.select(rank=1000)
    for _ in range(steps):
        contribs = edges.select(
            v=edges.v,
            flow=ranks.ix_ref(edges.u).rank // degs.ix_ref(edges.u).degree,
        )
        inflow = contribs.groupby(contribs.v).reduce(
            v=contribs.v, total=pw.reducers.sum(contribs.flow)
        ).with_id_from(pw.this.v)
        ranks = vertices.select(
            rank=pw.coalesce(inflow.ix_ref(vertices.v, optional=True).total, 0) * 5 // 6
            + 150,
        )
    return ranks


def bellman_ford(vertices: Table, edges: Table, iteration_limit: int = 50) -> Table:
    """Single-source shortest paths. vertices: (is_source: bool) or
    (dist_from_source...); edges: (u: Pointer, v: Pointer, dist: float).
    Returns per-vertex dist_from_source."""
    import math

    import pathway_tpu_torch as pw

    init = vertices.select(
        dist_from_source=pw.if_else(vertices.is_source, 0.0, math.inf)
    )

    def step(state: Table) -> Table:
        relaxed = edges.select(
            v=edges.v,
            dist=state.ix(edges.u).dist_from_source + edges.dist,
        )
        best = relaxed.groupby(relaxed.v).reduce(
            v=relaxed.v, dist=pw.reducers.min(relaxed.dist)
        ).with_id_from(pw.this.v)
        return state.select(
            dist_from_source=pw.apply_with_type(
                min,
                float,
                state.dist_from_source,
                pw.coalesce(
                    best.ix_ref(state.id, optional=True).dist, math.inf
                ),
            )
        )

    return pw.iterate(
        lambda state: step(state), iteration_limit=iteration_limit, state=init
    )


from . import louvain_communities
from .louvain_communities import exact_modularity, louvain_level

__all__ = [
    "Cluster",
    "Clustering",
    "Edge",
    "Graph",
    "Vertex",
    "Weight",
    "WeightedGraph",
    "bellman_ford",
    "exact_modularity",
    "louvain_communities",
    "louvain_level",
    "pagerank",
]

# typed building blocks for graph pipelines (reference
# stdlib/graphs/common.py:10-41): extend these schemas with your own
# columns; Edge/Clustering columns are row POINTERS into vertex tables
from ...internals.schema import Schema as _Schema
from ...internals import dtype as _dt


class Vertex(_Schema):
    pass


class Edge(_Schema):
    """An edge holds pointers to its endpoint vertex rows."""

    u: _dt.Pointer
    v: _dt.Pointer


class Weight(_Schema):
    """Weight mixin for Vertex/Edge extensions."""

    weight: float


class Cluster(Vertex):
    pass


class Clustering(_Schema):
    """Membership relation: vertex (row id) belongs to cluster ``c``."""

    c: _dt.Pointer
