"""Hidden Markov Model decoding as a stateful reducer.

Rebuild of upstream Pathway's python/pathway/stdlib/ml/hmm.py
(create_hmm_reducer :11): Viterbi decoding over a stream of
observations. The HMM is a networkx DiGraph whose nodes carry
``calc_emission_log_ppb(observation)``, edges ``log_transition_ppb``,
and optionally ``graph.graph['start_nodes']`` restricting the initial
state (first observation scores emission-only, like the reference).

Engine note: this engine's stateful reducers recompute a group from its
accumulated values each epoch, so the decode is a fresh O(n·S·E)
forward pass per update batch (not the reference's O(1) online step);
``beam_size`` prunes states per step and ``num_results_kept`` trims the
returned path.
"""

from __future__ import annotations

from typing import Any

from ...reducers import udf_reducer, BaseCustomAccumulator


def create_hmm_reducer(
    graph: Any, beam_size: int | None = None, num_results_kept: int | None = None
):
    """Build a reducer decoding the HMM over the aggregated observation
    stream. Use with ``windowby``/``groupby`` + ``reduce``; feed the
    observation column (ordering follows processing order, matching the
    reference's stream semantics)."""
    states = list(graph.nodes)
    start_nodes = list(graph.graph.get("start_nodes", states))
    emit_fns = {s: graph.nodes[s]["calc_emission_log_ppb"] for s in states}
    in_edges = {
        s: [(u, data["log_transition_ppb"]) for u, _v, data in graph.in_edges(s, data=True)]
        for s in states
    }

    class HmmAccumulator(BaseCustomAccumulator):
        def __init__(self, observations: tuple):
            self.observations = observations

        @classmethod
        def from_row(cls, row):
            return cls((row[0],))

        def update(self, other: "HmmAccumulator") -> None:
            self.observations = self.observations + other.observations

        def compute_result(self):
            # Viterbi forward pass over the accumulated observations
            scores: dict[Any, float] = {}
            back: list[dict[Any, Any]] = []
            started = False
            for obs in self.observations:
                nxt: dict[Any, float] = {}
                choice: dict[Any, Any] = {}
                if not started:
                    # initial distribution: start states, emission-only
                    for s in start_nodes:
                        emit = emit_fns[s](obs)
                        if emit is not None:
                            nxt[s] = emit
                            choice[s] = None
                else:
                    for s in states:
                        emit = emit_fns[s](obs)
                        if emit is None:
                            continue
                        best, best_prev = None, None
                        for prev, log_t in in_edges[s]:
                            if prev not in scores:
                                continue
                            cand = scores[prev] + log_t + emit
                            if best is None or cand > best:
                                best, best_prev = cand, prev
                        if best is not None:
                            nxt[s] = best
                            choice[s] = best_prev
                if not nxt:
                    continue  # unexplainable observation: skip
                if beam_size is not None and len(nxt) > beam_size:
                    kept = sorted(nxt, key=nxt.get, reverse=True)[:beam_size]
                    nxt = {s: nxt[s] for s in kept}
                    choice = {s: choice[s] for s in kept}
                scores = nxt
                back.append(choice)
                started = True
            if not back:
                return ()
            cur = max(scores, key=scores.get)
            path = [cur]
            for choice in reversed(back[1:]):
                cur = choice.get(cur)
                if cur is None:
                    break
                path.append(cur)
            path.reverse()
            if num_results_kept is not None:
                path = path[-num_results_kept:]
            return tuple(path)

    return udf_reducer(HmmAccumulator)
