"""Universes: key-set identities of tables.

Rebuild of upstream Pathway's python/pathway/internals/universe.py +
universe_solver.py. Tracks subset/equality relations between key sets so
operations like update_cells / with_universe_of can be validated at graph
build time."""

from __future__ import annotations

import itertools

_ids = itertools.count()


class Universe:
    __slots__ = ("id",)

    def __init__(self):
        self.id = next(_ids)

    def subset(self) -> "Universe":
        u = Universe()
        universe_solver.register_subset(u, self)
        return u

    def superset(self) -> "Universe":
        u = Universe()
        universe_solver.register_subset(self, u)
        return u

    def __repr__(self):
        return f"Universe({self.id})"


class UniverseSolver:
    """Union-find for equality + transitive subset closure."""

    def __init__(self):
        self.parent: dict[int, int] = {}
        self.subsets: dict[int, set[int]] = {}  # child root -> parent roots

    def _find(self, uid: int) -> int:
        p = self.parent.get(uid, uid)
        if p == uid:
            return uid
        root = self._find(p)
        self.parent[uid] = root
        return root

    def register_as_equal(self, a: Universe, b: Universe) -> None:
        ra, rb = self._find(a.id), self._find(b.id)
        if ra != rb:
            self.parent[ra] = rb
            self.subsets.setdefault(rb, set()).update(self.subsets.pop(ra, set()))

    def register_subset(self, child: Universe, parent: Universe) -> None:
        rc, rp = self._find(child.id), self._find(parent.id)
        self.subsets.setdefault(rc, set()).add(rp)

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self._find(a.id) == self._find(b.id)

    def query_is_subset(self, child: Universe, parent: Universe) -> bool:
        rc, rp = self._find(child.id), self._find(parent.id)
        if rc == rp:
            return True
        seen = set()
        stack = [rc]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in self.subsets.get(cur, ()):  # resolve roots lazily
                nxt = self._find(nxt)
                if nxt == rp:
                    return True
                stack.append(nxt)
        return False


universe_solver = UniverseSolver()
