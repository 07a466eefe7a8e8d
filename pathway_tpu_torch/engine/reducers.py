"""Engine-side reducer implementations.

Rebuild of upstream Pathway's src/engine/reduce.rs (enum Reducer :22-38,
SemigroupReducerImpl :40, ReducerImpl :50). Two tiers, like the reference:

- semigroup reducers (count/sum) keep O(1) incremental state and update on
  both insert and retract without touching other group members;
- general reducers recompute from the group's current values when the group
  is touched in an epoch (the reference replays the differential
  arrangement; we scan the group's keyed state dict).

Numeric recomputation is vectorized with numpy where the group is large.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np

from .value import ERROR, Error


class Reducer:
    """Base reducer. `compute(values)` derives the output from all current
    argument-rows of a group; semigroup reducers override the incremental
    hooks instead."""

    #: semigroup reducers support O(1) add/retract
    is_semigroup = False
    name = "reducer"
    #: analysis registry (pathway_tpu.analysis rule PWL003): commutative/
    #: associative reducers produce the same result regardless of the
    #: order updates arrive in, so merging partial aggregates across
    #: shards is safe. Order- or processing-time-sensitive reducers
    #: override these with False and are flagged by the verifier when
    #: used in a sharded groupby.
    commutative = True
    associative = True

    def compute(self, values: Iterable[tuple]) -> Any:
        raise NotImplementedError

    # semigroup API
    def init_state(self) -> Any:
        return None

    def add(self, state: Any, args: tuple, diff: int) -> Any:
        raise NotImplementedError

    def extract(self, state: Any) -> Any:
        raise NotImplementedError


class CountReducer(Reducer):
    is_semigroup = True
    name = "count"

    def init_state(self):
        return 0

    def add(self, state, args, diff):
        return state + diff

    def extract(self, state):
        return state

    def compute(self, values):
        return sum(1 for _ in values)

    def fold_batch(self, states, cols, inv, diffs):
        # diffs=None means every row is a +1 insert
        if diffs is None:
            acc = np.bincount(inv, minlength=len(states))
        else:
            acc = np.zeros(len(states), np.int64)
            np.add.at(acc, inv, diffs)
        for j, c in enumerate(acc.tolist()):
            states[j] = states[j] + c


class SumReducer(Reducer):
    """Int/Float/Array sum (reference IntSum/FloatSum/ArraySum)."""

    is_semigroup = True
    name = "sum"

    def init_state(self):
        return None

    def add(self, state, args, diff):
        v = args[0]
        if v is None:
            return state
        if isinstance(v, Error):
            return ERROR
        if isinstance(state, Error):
            return state
        contrib = v * diff if not isinstance(v, np.ndarray) else v * diff
        if state is None:
            return contrib
        return state + contrib

    def extract(self, state):
        return 0 if state is None else state

    def compute(self, values):
        state = None
        for args in values:
            state = self.add(state, args, 1)
        return self.extract(state)

    def fold_batch(self, states, cols, inv, diffs):
        # cols are typed by construction (no None/Error); float sums
        # accumulate in row order like the per-row path
        v = cols[0]
        if v.dtype.kind == "b":
            v = v.astype(np.int64)
        n = len(inv)
        if v.dtype.kind == "i" and n:
            # the per-row path sums with python bignums; only use the
            # int64 accumulator when overflow is provably impossible
            # python-int abs: np.abs(INT64_MIN) wraps negative
            amax = max(abs(int(v.max())), abs(int(v.min())))
            dmax = 1 if diffs is None else max(1, int(np.abs(diffs).max()))
            if amax and amax > (2**62) // (n * dmax):
                vals = v.tolist()
                dl = None if diffs is None else diffs.tolist()
                accs = [0] * len(states)
                for i, j in enumerate(inv.tolist()):
                    accs[j] += vals[i] if dl is None else vals[i] * dl[i]
                for j, c in enumerate(accs):
                    s = states[j]
                    if isinstance(s, Error):
                        continue
                    states[j] = c if s is None else s + c
                return
        contrib = v if diffs is None else v * diffs
        acc = np.zeros(len(states), contrib.dtype)
        np.add.at(acc, inv, contrib)
        for j, c in enumerate(acc.tolist()):
            s = states[j]
            if isinstance(s, Error):
                continue
            states[j] = c if s is None else s + c


class MinReducer(Reducer):
    name = "min"

    def compute(self, values):
        vs = [a[0] for a in values if a[0] is not None]
        if not vs:
            return None
        if any(isinstance(v, Error) for v in vs):
            return ERROR
        return min(vs)


class MaxReducer(Reducer):
    name = "max"

    def compute(self, values):
        vs = [a[0] for a in values if a[0] is not None]
        if not vs:
            return None
        if any(isinstance(v, Error) for v in vs):
            return ERROR
        return max(vs)


def _safe_lt(a, b) -> bool:
    try:
        return a < b
    except TypeError:
        return repr(a) < repr(b)


class ArgMinReducer(Reducer):
    """args = (cmp_value, payload); returns payload of the min cmp_value,
    ties broken by the smaller payload for determinism (reduce.rs ArgMin)."""

    name = "argmin"

    def compute(self, values):
        best = None
        for cmp_v, payload in values:
            if cmp_v is None:
                continue
            if (
                best is None
                or _safe_lt(cmp_v, best[0])
                or (not _safe_lt(best[0], cmp_v) and _safe_lt(payload, best[1]))
            ):
                best = (cmp_v, payload)
        return None if best is None else best[1]


class ArgMaxReducer(Reducer):
    name = "argmax"

    def compute(self, values):
        best = None
        for cmp_v, payload in values:
            if cmp_v is None:
                continue
            if (
                best is None
                or _safe_lt(best[0], cmp_v)
                or (not _safe_lt(cmp_v, best[0]) and _safe_lt(payload, best[1]))
            ):
                best = (cmp_v, payload)
        return None if best is None else best[1]


class UniqueReducer(Reducer):
    """All values in the group must be equal; ERROR otherwise
    (reduce.rs Unique)."""

    name = "unique"

    def compute(self, values):
        result = _SENTINEL = object()
        first = True
        for (v,) in values:
            if first:
                result = v
                first = False
            elif not _values_eq(result, v):
                return ERROR
        return None if first else result


class AnyReducer(Reducer):
    """An arbitrary-but-deterministic element (reduce.rs Any): the min by
    canonical order."""

    name = "any"

    def compute(self, values):
        best = None
        have = False
        for (v,) in values:
            if not have or _canon_lt(v, best):
                best = v
                have = True
        return best if have else None


class SortedTupleReducer(Reducer):
    name = "sorted_tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def compute(self, values):
        vs = [v for (v,) in values if not (self.skip_nones and v is None)]
        try:
            vs.sort()
        except TypeError:
            vs.sort(key=repr)
        return tuple(vs)


class TupleReducer(Reducer):
    """Tuple in insertion-order; ties resolved by a sort key column
    (reference Tuple reducer sorts by original row order/instance)."""

    name = "tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def compute(self, values):
        # args = (sort_key, value)
        items = [(k, v) for k, v in values if not (self.skip_nones and v is None)]
        try:
            items.sort(key=lambda kv: kv[0])
        except TypeError:
            items.sort(key=lambda kv: repr(kv[0]))
        return tuple(v for _, v in items)


class NdarrayReducer(Reducer):
    name = "ndarray"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def compute(self, values):
        items = [(k, v) for k, v in values if not (self.skip_nones and v is None)]
        try:
            items.sort(key=lambda kv: kv[0])
        except TypeError:
            items.sort(key=lambda kv: repr(kv[0]))
        vs = [v for _, v in items]
        if not vs:
            return np.array([])
        return np.array(vs)


class AvgReducer(Reducer):
    is_semigroup = True
    name = "avg"

    def init_state(self):
        return (0.0, 0)

    def add(self, state, args, diff):
        if isinstance(state, Error):
            return state
        v = args[0]
        if v is None:
            return state
        if isinstance(v, Error):
            return ERROR
        s, n = state
        return (s + v * diff, n + diff)

    def extract(self, state):
        if isinstance(state, Error):
            return ERROR
        s, n = state
        return None if n == 0 else s / n

    def compute(self, values):
        state = self.init_state()
        for args in values:
            state = self.add(state, args, 1)
        return self.extract(state)

    def fold_batch(self, states, cols, inv, diffs):
        v = cols[0]
        if v.dtype.kind == "b":
            v = v.astype(np.int64)
        contrib = v if diffs is None else v * diffs
        sacc = np.zeros(len(states), np.float64)
        np.add.at(sacc, inv, contrib)
        if diffs is None:
            nacc = np.bincount(inv, minlength=len(states))
        else:
            nacc = np.zeros(len(states), np.int64)
            np.add.at(nacc, inv, diffs)
        for j in range(len(states)):
            st = states[j]
            if isinstance(st, Error):
                continue
            s, n = st
            states[j] = (s + sacc[j].item(), n + int(nacc[j]))


class GroupColReducer(Reducer):
    """Reducer backing a grouping column in reduce() output. Within a
    group every argument equals the group value (it is part of the group
    key), which makes "pick any" a semigroup: keep the latest inserted
    value; retractions never change it (remaining rows carry the same
    value, and empty groups are deleted by the node)."""

    is_semigroup = True
    name = "group_col"

    def init_state(self):
        return None

    def add(self, state, args, diff):
        if diff > 0:
            return args[0]
        return state

    def extract(self, state):
        return state

    def compute(self, values):
        for (v,) in values:
            return v
        return None

    def fold_batch(self, states, cols, inv, diffs):
        v = cols[0]
        if diffs is None or bool((diffs > 0).all()):
            tmp = np.empty(len(states), v.dtype)
            tmp[inv] = v  # last write per group wins
            vals = tmp.tolist()
            for j in range(len(states)):
                states[j] = vals[j]
            return
        # mixed batch: last INSERTED value per group, via one stable sort
        pos_idx = np.flatnonzero(diffs > 0)
        if not len(pos_idx):
            return
        sub_inv = inv[pos_idx]
        order = np.argsort(sub_inv, kind="stable")
        sorted_inv = sub_inv[order]
        last = np.flatnonzero(
            np.r_[sorted_inv[1:] != sorted_inv[:-1], True]
        )
        for b in last.tolist():
            states[int(sorted_inv[b])] = v[pos_idx[order[b]]].item()


class EarliestReducer(Reducer):
    """Value from the earliest processing time (reduce.rs Earliest).
    args = (time, value); retained across retractions of later values."""

    name = "earliest"
    needs_time = True
    # result depends on per-shard processing-time order
    commutative = False

    def compute(self, values):
        best = None
        for t, v in values:
            if best is None or t < best[0]:
                best = (t, v)
        return None if best is None else best[1]


class LatestReducer(Reducer):
    name = "latest"
    needs_time = True
    # result depends on per-shard processing-time order
    commutative = False

    def compute(self, values):
        best = None
        for t, v in values:
            if best is None or t >= best[0]:
                best = (t, v)
        return None if best is None else best[1]


class StatefulReducer(Reducer):
    """User-provided combine function over the group's values
    (pw.reducers.udf_reducer / stateful_many analog — simplified to
    recompute-from-scratch semantics)."""

    name = "stateful"
    # user combine fn: no algebraic guarantees
    commutative = False
    associative = False

    def __init__(self, fn: Callable[[list], Any]):
        self.fn = fn

    def compute(self, values):
        return self.fn([v[0] if len(v) == 1 else v for v in values])


def _values_eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (
            isinstance(a, np.ndarray)
            and isinstance(b, np.ndarray)
            and a.shape == b.shape
            and bool(np.array_equal(a, b))
        )
    return a == b


def _canon_lt(a, b):
    try:
        return a < b
    except TypeError:
        return repr(a) < repr(b)
