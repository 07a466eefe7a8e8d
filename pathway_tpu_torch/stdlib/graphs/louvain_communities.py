"""Louvain community detection.

Rebuild of upstream Pathway's python/pathway/stdlib/graphs/louvain_communities/
(impl.py: _propose_clusters :18, _one_step :154, _louvain_level :225,
louvain_communities_fixed_iterations :288, exact_modularity :340),
re-expressed over this engine's multi-table ``pw.iterate``.

Semantics: undirected weighted graphs arrive as a directed-doubled edge
table (an undirected {u, v} is rows (u, v) and (v, u), as in the
reference). One LEVEL repeatedly (a) proposes, per vertex, the adjacent
cluster maximizing the Louvain modularity gain
``2*w(u,C) - deg(u) * (2*degsum(C) + deg(u)) / total``, and (b) applies
a parallel-safe subset of the proposed moves — an independent set in
the cluster graph chosen by hash-random priorities, so no cluster takes
part in two simultaneous moves — until no vertex wants to move.
``louvain_communities`` stacks levels by contracting each clustering
into a weighted cluster graph.
"""

from __future__ import annotations

from ...engine.value import ref_scalar


def _hash_priority(x, iteration: int) -> int:
    return int(ref_scalar("louvain", x, iteration))


def propose_clusters(edges, clustering):
    """Per vertex, the adjacent cluster maximizing the modularity gain
    (including the option of staying put). Returns a table keyed by
    vertex with columns (u, c, gain)."""
    import pathway_tpu_torch as pw
    from ..utils.filtering import argmax_rows

    # deg(u) = sum of incident edge weights (directed-doubled)
    degrees = (
        edges.groupby(pw.this.u)
        .reduce(u=pw.this.u, degree=pw.reducers.sum(pw.this.weight))
        .with_id(pw.this.u)
    )
    # degsum(C) = sum of member degrees
    memb = clustering.select(c=pw.this.c, degree=degrees.ix(pw.this.id).degree)
    cluster_deg = (
        memb.groupby(pw.this.c)
        .reduce(c=pw.this.c, degsum=pw.reducers.sum(pw.this.degree))
        .with_id(pw.this.c)
    )

    # w(u, C) = total weight from u into cluster C (self-edges halved:
    # contraction counts each loop twice, as in the reference)
    to_cluster = edges.select(
        u=pw.this.u,
        vc=clustering.ix(pw.this.v).c,
        w=pw.if_else(pw.this.u == pw.this.v, pw.this.weight / 2, pw.this.weight * 1.0),
    )
    agg = (
        to_cluster.groupby(pw.this.u, pw.this.vc)
        .reduce(u=pw.this.u, vc=pw.this.vc, w=pw.reducers.sum(pw.this.w))
    )

    def gain_fn(w, degree, penalty, total):
        return 2.0 * w - degree * (2.0 * penalty + degree) / total

    uc = clustering.ix(agg.u).c
    moving = agg.select(
        u=pw.this.u,
        c=pw.this.vc,
        gain=pw.apply(
            gain_fn,
            pw.this.w,
            degrees.ix(pw.this.u).degree,
            # staying: u's own degree leaves its cluster's degsum
            pw.if_else(
                pw.this.vc == uc,
                cluster_deg.ix(pw.this.vc).degsum
                - degrees.ix(pw.this.u).degree,
                cluster_deg.ix(pw.this.vc).degsum + 0.0,
            ),
            clustering.ix(pw.this.u).total_weight,
        ),
    )
    return argmax_rows(moving, moving.u, what=moving.gain)


def one_step(edges, clustering, iteration: int):
    """Apply a parallel-safe subset of the proposed moves (reference
    _one_step: independent set via random priorities — no cluster is on
    both sides of two applied moves)."""
    import pathway_tpu_torch as pw
    from ..utils.filtering import argmax_rows

    best = propose_clusters(edges, clustering)
    moves = best.filter(best.c != clustering.ix(best.u).c).select(
        u=pw.this.u,
        uc=clustering.ix(pw.this.u).c,
        vc=pw.this.c,
        r=pw.apply(_hash_priority, pw.this.u, iteration),
    )
    # max priority per touched cluster (either side)
    out_p = moves.select(c=pw.this.uc, r=pw.this.r)
    in_p = moves.select(c=pw.this.vc, r=pw.this.r)
    all_p = out_p.concat_reindex(in_p)
    cluster_max = (
        argmax_rows(all_p, all_p.c, what=all_p.r)
        .select(c=pw.this.c, r=pw.this.r)
        .with_id(pw.this.c)
    )
    safe = moves.filter(
        (moves.r == cluster_max.ix(moves.uc).r)
        & (moves.r == cluster_max.ix(moves.vc).r)
    )
    delta = safe.select(
        v=pw.this.u,
        c=pw.this.vc,
        total_weight=clustering.ix(pw.this.u).total_weight,
    ).with_id(pw.this.v)
    moved = clustering.select(
        c=pw.coalesce(delta.ix(clustering.id, optional=True).c, pw.this.c),
        total_weight=pw.this.total_weight,
    )
    return moved


def louvain_level(G, iteration_limit: int | None = 100):
    """One Louvain level: move vertices until none improves modularity
    (reference _louvain_level — the pw.iterate fixpoint over
    (clustering, WE))."""
    import pathway_tpu_torch as pw

    counter = [0]

    def step(clustering, WE):
        counter[0] += 1
        return dict(clustering=one_step(WE, clustering, counter[0]))

    init = G.V.select(c=pw.this.id, total_weight=pw.this.total_weight)
    return pw.iterate(
        step,
        iteration_limit=iteration_limit,
        clustering=init,
        WE=G.WE,
    ).clustering


def louvain_communities(G, levels: int = 1, iteration_limit: int | None = 100):
    """Multi-level Louvain: run a level, contract clusters into a
    weighted cluster graph, repeat. Returns the flattened clustering —
    a table keyed by ORIGINAL vertex with column ``c`` (the top-level
    community id)."""
    import pathway_tpu_torch as pw

    assignment = G.V.select(c=pw.this.id)  # vertex -> current cluster
    current = G
    for _lvl in range(levels):
        clustering = louvain_level(current, iteration_limit)
        # flatten: vertex -> its cluster's (possibly moved) cluster
        assignment = assignment.select(
            c=clustering.ix(pw.this.c).c,
        )
        current = contracted_graph(current, clustering)
    return assignment


def contracted_graph(G, clustering):
    """Contract a clustering into the weighted cluster graph (reference
    Graph.contracted_to_weighted_simple_graph): cluster ids become
    vertices, edge weights sum per (cu, cv)."""
    import pathway_tpu_torch as pw

    from . import WeightedGraph

    e = G.WE.select(
        u=clustering.ix(pw.this.u).c,
        v=clustering.ix(pw.this.v).c,
        weight=pw.this.weight * 1.0,
    )
    we = (
        e.groupby(pw.this.u, pw.this.v)
        .reduce(u=pw.this.u, v=pw.this.v, weight=pw.reducers.sum(pw.this.weight))
    )
    v = (
        clustering.groupby(pw.this.c)
        .reduce(c=pw.this.c, total_weight=pw.reducers.any(pw.this.total_weight))
        .with_id(pw.this.c)
        .select(total_weight=pw.this.total_weight)
    )
    return WeightedGraph(V=v, E=we, WE=we)


def exact_modularity(G, clustering, round_digits: int = 16) -> float:
    """Q = sum_C (internal(C)/total - (degsum(C)/total)^2) over the
    directed-doubled edge multiset (reference exact_modularity :340).
    Runs the graph and returns a float (test helper)."""
    import pathway_tpu_torch as pw
    from ...internals.graph_runner import GraphRunner

    degrees = (
        G.WE.groupby(pw.this.u)
        .reduce(u=pw.this.u, degree=pw.reducers.sum(pw.this.weight))
        .with_id(pw.this.u)
    )
    cu = clustering.ix(G.WE.u).c
    cv = clustering.ix(G.WE.v).c
    internal = G.WE.filter(cu == cv).select(
        c=clustering.ix(pw.this.u).c, w=pw.this.weight * 1.0
    )
    per_cluster_internal = internal.groupby(pw.this.c).reduce(
        c=pw.this.c, inside=pw.reducers.sum(pw.this.w)
    ).with_id(pw.this.c)
    memb = clustering.select(c=pw.this.c, degree=degrees.ix(pw.this.id).degree)
    per_cluster_deg = memb.groupby(pw.this.c).reduce(
        c=pw.this.c, degsum=pw.reducers.sum(pw.this.degree)
    )
    stats = per_cluster_deg.select(
        inside=pw.coalesce(
            per_cluster_internal.ix(pw.this.c, optional=True).inside, 0.0
        ),
        degsum=pw.this.degsum,
    )
    total_t = G.WE.reduce(total=pw.reducers.sum(pw.this.weight))
    runner = GraphRunner()
    cap_s, names_s = runner.capture(stats)
    cap_t, names_t = runner.capture(total_t)
    runner.run()
    if not cap_t.state:
        return 0.0  # edgeless graph: modularity is 0 by convention
    total = next(iter(cap_t.state.values()))[0]
    if not total:
        return 0.0
    q = 0.0
    for row in cap_s.state.values():
        inside, degsum = row[names_s.index("inside")], row[names_s.index("degsum")]
        q += inside / total - (degsum / total) ** 2
    return round(q, round_digits)
