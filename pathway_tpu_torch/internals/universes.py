"""Declaring relations between keysets (universes).

Rebuild of upstream Pathway's python/pathway/universes.py +
internals/universes.py (promise_are_pairwise_disjoint :13,
promise_is_subset_of :49, promise_are_equal :83). These record user
promises in the universe solver; in this build the engine re-verifies
keyed operations at runtime (e.g. concat key collisions), so the
promises primarily unlock the static same-universe check used by
``+``/``with_columns``. Delegates to the Table promise methods so both
surfaces stay in sync."""

from __future__ import annotations


def promise_are_pairwise_disjoint(self, *others) -> None:
    """Promise the tables' key sets never overlap. Concat verifies
    collisions at runtime regardless."""
    for o in others:
        self.promise_universes_are_disjoint(o)


def promise_is_subset_of(self, *others) -> None:
    """Promise self's keys are a subset of each other table's keys."""
    for o in others:
        self.promise_universe_is_subset_of(o)


def promise_are_equal(self, *others) -> None:
    """Promise the tables share exactly the same key set: they (and
    same-universe projections of them, e.g. ``select``) become valid
    operands for ``+``. Subset-universe derivations (``filter``) stay
    distinct — filtering genuinely changes the key set."""
    for o in others:
        self.promise_universes_are_equal(o)


__all__ = [
    "promise_are_pairwise_disjoint",
    "promise_are_equal",
    "promise_is_subset_of",
]
