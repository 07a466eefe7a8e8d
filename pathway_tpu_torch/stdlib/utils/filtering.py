"""Keep one winning row per group (behavior parity: reference
stdlib/utils/filtering.py argmax_rows/argmin_rows)."""

from __future__ import annotations


def _winner_rows(table, on, what, pick_reducer):
    """Shared core: reduce each ``on``-group to the id of its winning
    row (by ``pick_reducer`` over ``what``), re-key the winners table by
    those ids, and restrict the source onto it — the result carries the
    ORIGINAL rows (all columns, original ids), one per group."""
    import pathway_tpu_torch as pw

    winners = (
        table.groupby(*on)
        .reduce(_pw_winner=pick_reducer(what))
        .with_id(pw.this._pw_winner)
        .promise_universe_is_subset_of(table)
    )
    return table.restrict(winners)


def argmax_rows(table, *on, what):
    """Per ``on``-group, the full row maximizing ``what``."""
    import pathway_tpu_torch as pw

    return _winner_rows(table, on, what, pw.reducers.argmax)


def argmin_rows(table, *on, what):
    """Per ``on``-group, the full row minimizing ``what``."""
    import pathway_tpu_torch as pw

    return _winner_rows(table, on, what, pw.reducers.argmin)
