"""ML helper utilities (reference stdlib/ml/utils.py:
classifier_accuracy :13, _predict_asof_now :33)."""

from __future__ import annotations

import functools
from typing import Callable

from ...internals.expression import ColumnReference
from ...internals.table import Table
from ...internals.thisclass import this


def classifier_accuracy(predicted_labels: Table, exact_labels: Table) -> Table:
    """Tally how many predictions match the ground truth.

    ``predicted_labels`` (column ``predicted_label``) must be keyed by a
    subset of ``exact_labels``'s keys (column ``label``). Returns a
    two-row table: ``value`` (True/False match) and ``cnt``.
    """
    from ... import reducers, universes

    universes.promise_is_subset_of(predicted_labels, exact_labels)
    paired = predicted_labels.select(
        predicted_label=predicted_labels.predicted_label,
        label=exact_labels.restrict(predicted_labels).label,
    )
    scored = paired.select(
        *[ColumnReference(paired, n) for n in paired._columns],
        match=paired.label == paired.predicted_label,
    )
    return scored.groupby(this.match).reduce(
        cnt=reducers.count(), value=this.match
    )


def _predict_asof_now(
    prediction_function: Callable, with_queries_universe: bool = False
) -> Callable:
    """Wrap a query->result pipeline builder so each query is answered
    once, against the model state as of its arrival.

    In this engine the as-of-now freeze lives in the index/join operators
    themselves (AsofNowJoin, ExternalIndexNode ``as_of_now``), so the
    wrapper's job is universe bookkeeping: pass ColumnReference args
    through a dedicated query table and, with ``with_queries_universe``,
    re-key the result onto the caller's table. The reference additionally
    forgets each query row after answering
    (utils.py:33 ``_forget_immediately``) — a memory, not semantics,
    difference; our frozen operators never revisit answered queries.
    """

    @functools.wraps(prediction_function)
    def wrapper(*args, **kwargs):
        refs = [a for a in list(args) + list(kwargs.values()) if isinstance(a, ColumnReference)]
        if not refs:
            raise ValueError(
                "at least one argument of a _predict_asof_now pipeline "
                "must be a column reference"
            )
        table = refs[0]._table
        result = prediction_function(*args, **kwargs)
        if with_queries_universe:
            result = result.with_universe_of(table)
        return result

    return wrapper
