"""Sorted-index oracles: treap index, prev/next from a tree, and
non-None neighbor retrieval.

Rebuild of upstream Pathway's python/pathway/stdlib/indexing/sorting.py
(``build_sorted_index`` :92 — treap keyed by column, prioritized by id
hash; ``sort_from_index`` :137 — prev/next pointers via tree walk;
``retrieve_prev_next_values`` :196 — nearest row with a non-None value
along the prev/next order).

The reference grows the treap through ``pw.iterate`` fixpoints so each
step is a differential operator. Here the whole per-instance group is
(re)built in one vectorized host pass per epoch — under this engine's
totally-ordered bulk-synchronous epochs that is both simpler and
faster (construction from the sorted order is O(n) with a stack), and
retraction-correctness falls out of the groupby/flatten operators'
own incrementality: any change to an instance recomputes exactly that
instance's tree.
"""

from __future__ import annotations

import hashlib
from typing import Any, TypedDict

import pathway_tpu_torch as pw
from ... import reducers
from ...internals import thisclass
from ...internals.expression import ColumnReference
from ...internals.table import Table


class SortedIndex(TypedDict):
    """Shape of ``build_sorted_index``'s result (reference
    sorting.py:85): ``index`` — one row per node with left/right/parent
    pointers; ``oracle`` — the root per instance."""

    index: Table
    oracle: Table


def hash(val) -> int:
    """Deterministic i64 fingerprint (reference sorting.py:14)."""
    digest = hashlib.blake2b(
        int(val).to_bytes(16, "little", signed=True), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little", signed=True)


def _build_treap(items) -> tuple:
    """items: ((id, key), ...) -> ((id, key, left, right, parent), ...).

    Cartesian tree: in-order = key order, heap order = min id-hash on
    top (the reference's treap, sorting.py:53-80, built here directly
    from the sorted order with a stack instead of iterated rounds)."""
    rows = [(key, hash(int(node)), node) for node, key in items]
    rows.sort(key=lambda r: (r[0], r[1], int(r[2])))
    n = len(rows)
    left = [None] * n
    right = [None] * n
    parent = [None] * n
    stack: list[int] = []
    for i in range(n):
        last = None
        while stack and rows[stack[-1]][1] > rows[i][1]:
            last = stack.pop()
        if last is not None:
            left[i] = last
            parent[last] = i
        if stack:
            right[stack[-1]] = i
            parent[i] = stack[-1]
        stack.append(i)
    ids = [r[2] for r in rows]
    return tuple(
        (
            ids[i],
            rows[i][0],
            ids[left[i]] if left[i] is not None else None,
            ids[right[i]] if right[i] is not None else None,
            ids[parent[i]] if parent[i] is not None else None,
        )
        for i in range(n)
    )


def build_sorted_index(nodes: Table, instance: ColumnReference | None = None) -> dict:
    """Treap per instance, sorted by ``key`` (reference
    sorting.py:92-131). ``nodes`` needs a ``key`` column and optionally
    an ``instance`` column. Returns ``{"index": Table[key, left, right,
    parent, instance], "oracle": Table[root, instance]}`` with the
    index keyed by the original node ids and the oracle keyed by
    instance (``ix_ref``-addressable)."""
    cols = nodes.column_names()
    if instance is not None:
        inst_expr: Any = instance
    elif "instance" in cols:
        inst_expr = nodes.instance
    else:
        inst_expr = 0
    packed = nodes.select(
        instance=inst_expr,
        packed=pw.apply_with_type(
            lambda i, k: (i, k), pw.ANY, thisclass.this.id, nodes.key
        ),
    )
    g = packed.groupby(thisclass.this.instance).reduce(
        thisclass.this.instance,
        items=reducers.tuple(thisclass.this.packed),
    )
    trees = g.select(
        thisclass.this.instance,
        rows=pw.apply_with_type(_build_treap, pw.ANY, thisclass.this.items),
    )
    flat = trees.flatten(thisclass.this.rows)
    index = flat.select(
        node=pw.apply_with_type(lambda r: r[0], pw.ANY, thisclass.this.rows),
        key=pw.apply_with_type(lambda r: r[1], pw.ANY, thisclass.this.rows),
        left=pw.apply_with_type(lambda r: r[2], pw.ANY, thisclass.this.rows),
        right=pw.apply_with_type(lambda r: r[3], pw.ANY, thisclass.this.rows),
        parent=pw.apply_with_type(lambda r: r[4], pw.ANY, thisclass.this.rows),
        instance=thisclass.this.instance,
    ).with_id(thisclass.this.node)
    index = index.select(
        thisclass.this.key,
        thisclass.this.left,
        thisclass.this.right,
        thisclass.this.parent,
        thisclass.this.instance,
    ).with_universe_of(nodes)
    oracle = trees.select(
        thisclass.this.instance,
        root=pw.apply_with_type(
            lambda rows: next((r[0] for r in rows if r[4] is None), None),
            pw.ANY,
            thisclass.this.rows,
        ),
    )
    return {"index": index, "oracle": oracle}


def _prev_next_from_tree(items) -> tuple:
    """items: ((id, left, right, parent), ...) -> ((id, prev, next), ...)
    by in-order traversal of each root's tree (reference
    sort_from_index :137-171, leftmost/rightmost pointer chasing)."""
    node = {r[0]: r for r in items}
    out = []
    roots = [r[0] for r in items if r[3] is None or r[3] not in node]
    for root in roots:
        order: list = []
        stack: list = []
        cur = root
        while stack or cur is not None:
            while cur is not None:
                stack.append(cur)
                cur = node[cur][1] if node[cur][1] in node else None
            cur = stack.pop()
            order.append(cur)
            cur = node[cur][2] if node[cur][2] in node else None
        for i, nid in enumerate(order):
            out.append(
                (
                    nid,
                    order[i - 1] if i > 0 else None,
                    order[i + 1] if i + 1 < len(order) else None,
                )
            )
    return tuple(out)


def sort_from_index(index: Table, oracle: Table | None = None) -> Table:
    """prev/next pointers in key order from a left/right/parent tree
    (reference sorting.py:137). Grouped per instance when the index
    carries one, so a change re-traverses only its own tree.

    ``oracle`` is accepted for reference-signature parity only — the
    traversal finds roots from the parent pointers itself (the
    reference's sort_from_index ignores its oracle too)."""
    inst = (
        index.instance if "instance" in index.column_names() else 0
    )
    packed = index.select(
        one=inst,
        packed=pw.apply_with_type(
            lambda i, l, r, p: (i, l, r, p),
            pw.ANY,
            thisclass.this.id,
            index.left,
            index.right,
            index.parent,
        ),
    )
    g = packed.groupby(thisclass.this.one).reduce(
        items=reducers.tuple(thisclass.this.packed)
    )
    rows = g.select(
        rows=pw.apply_with_type(_prev_next_from_tree, pw.ANY, thisclass.this.items)
    )
    flat = rows.flatten(thisclass.this.rows)
    return (
        flat.select(
            node=pw.apply_with_type(lambda r: r[0], pw.ANY, thisclass.this.rows),
            prev=pw.apply_with_type(lambda r: r[1], pw.ANY, thisclass.this.rows),
            next=pw.apply_with_type(lambda r: r[2], pw.ANY, thisclass.this.rows),
        )
        .with_id(thisclass.this.node)
        .select(thisclass.this.prev, thisclass.this.next)
        .with_universe_of(index)
    )


def _chase_values(items) -> tuple:
    """items: ((id, prev, next, value), ...) ->
    ((id, prev_value_ptr, next_value_ptr), ...): per row the nearest id
    (SELF-inclusive, like the reference's ``require(id, value)`` seed,
    sorting.py:219-223) whose value is non-None, along prev / next."""
    node = {r[0]: r for r in items}

    def chase(start, direction):
        seen = set()
        cur = start
        while cur is not None and cur in node and cur not in seen:
            seen.add(cur)
            if node[cur][3] is not None:
                return cur
            cur = node[cur][direction]
        return None

    return tuple((r[0], chase(r[0], 1), chase(r[0], 2)) for r in items)


def retrieve_prev_next_values(ordered_table: Table, value: ColumnReference | None = None) -> Table:
    """For each row, the id of the first row with a non-None value
    along the prev order (``prev_value``) and the next order
    (``next_value``) — reference sorting.py:196-230."""
    val = value if value is not None else ordered_table.value
    inst = (
        ordered_table.instance
        if "instance" in ordered_table.column_names()
        else 0
    )
    packed = ordered_table.select(
        one=inst,
        packed=pw.apply_with_type(
            lambda i, p, n, v: (i, p, n, v),
            pw.ANY,
            thisclass.this.id,
            ordered_table.prev,
            ordered_table.next,
            val,
        ),
    )
    g = packed.groupby(thisclass.this.one).reduce(
        items=reducers.tuple(thisclass.this.packed)
    )
    rows = g.select(
        rows=pw.apply_with_type(_chase_values, pw.ANY, thisclass.this.items)
    )
    flat = rows.flatten(thisclass.this.rows)
    return (
        flat.select(
            node=pw.apply_with_type(lambda r: r[0], pw.ANY, thisclass.this.rows),
            prev_value=pw.apply_with_type(lambda r: r[1], pw.ANY, thisclass.this.rows),
            next_value=pw.apply_with_type(lambda r: r[2], pw.ANY, thisclass.this.rows),
        )
        .with_id(thisclass.this.node)
        .select(thisclass.this.prev_value, thisclass.this.next_value)
        .with_universe_of(ordered_table)
    )
