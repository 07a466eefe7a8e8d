"""Tenant-packed device slabs: many small indexes, one slab.

The port's copy of the reference's ``tenancy/packed.py``. A
:class:`TenantPackedIndex` is a :class:`~..ops.knn.DeviceKnnIndex` whose
rows belong to many tenants at once. The device state is the parent's
``[capacity, dim]`` matrix / validity / bias plus one int32
*tenant-routing column* aligned with the slab (4 bytes a row). The
parent's scatter, growth and top-k dispatch (kernel B2 on a card, both of
its regimes) serve every tenant: 10k tiny tenants share one slab and one
launch per search.

Layout: each tenant owns contiguous *extents* of slab rows, granted with
per-tenant doubling (grant ``max(short, rows_so_far)`` rows, at least
``_MIN_EXTENT``) from a bump pointer, so a tenant's rows stay adjacent.
Keys are namespaced ``(tenant, key)`` internally, so tenants can reuse
each other's key space. A tenant's HBM quota (``TenantQuotas.hbm_bytes``)
is enforced at grant time, and every tenant's segment bytes are booked
under the ``index.tenant`` ledger account (owner ``"<index>/<tenant>"``;
the ungranted remainder books under ``"<index>/__unassigned__"``, so the
account reconciles *exactly* against ``index.hot``).

Queries mask by tenant id: one ``torch.where`` pass on the slab's device
turns the routing column into ``valid & (tenant_col == tid)`` and the
matching bias (masked rows get B2's empty-row bias), and the pair is handed
to the parent's search for that call only (``DeviceKnnIndex.search_batch(
mask=)``). Nothing shared is swapped, so concurrent searches of different
tenants cannot see each other's mask. Masked rows score exactly like empty
rows, which is what makes a tenant's results equal a private index's over
the same rows.

Cold tenants demote *wholesale* to a host store on a hit-decay schedule:
every ``demote_every`` searches the per-tenant hit counters decay by
``decay``; a tenant falling below ``demote_below`` moves its rows to host
numpy, frees its extents for reuse, and serves later queries from an exact
host scan. Two queries while cold promote the tenant back into the slab.

On a mesh (``mesh=``) the slab is the parent's sharded slab: extents are
carved from the shard with the most room left (one never spans two
shards), the routing column lives beside each shard's slab, and the
tenant mask reaches B2's per-shard passes as one validity and bias a
shard. The elastic reshard (``spawn_like``, ``reshard_*``) moves the
tenants one by one in registration order: a hot tenant's rows as the slab
holds them, a cold tenant's host store followed by a marker that demotes
it again on the target, so extents re-grant and cold tenants stay cold.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np
import torch

from ..freshness.plane import FRESHNESS
from ..internals import flight_recorder
from ..ops.knn import DeviceKnnIndex, _apply_filter
from ..ops.knn_topk import NEG as _PNEG
from .config import TenancyConfig, TenantQuotas, active_tenancy
from .metrics import TENANCY_METRICS

#: smallest extent ever granted — keeps the 1-doc-per-tenant worst case
#: from fragmenting the slab into single-row segments
_MIN_EXTENT = 8

#: raw hits while cold that promote a tenant back into the slab
_PROMOTE_HITS = 2


def tenant_mask(valid: torch.Tensor, bias: torch.Tensor, tenant_col: torch.Tensor, tid: int):
    """The slab's validity and bias restricted to tenant ``tid``: one pass
    on the slab's device; masked rows get B2's empty-row bias."""
    keep = valid & (tenant_col == tid)
    return keep, torch.where(keep, bias, _PNEG)


class TenantOverBudget(RuntimeError):
    """A tenant's extent grant would exceed its ``hbm_bytes`` quota."""

    def __init__(self, tenant: str, need_bytes: int, budget_bytes: int):
        self.tenant = tenant
        self.need_bytes = int(need_bytes)
        self.budget_bytes = int(budget_bytes)
        super().__init__(
            f"tenant {tenant!r} needs {need_bytes} HBM bytes but its quota "
            f"is {budget_bytes}"
        )


class TenantPackedIndex(DeviceKnnIndex):
    """Many tenants' vectors packed into one device slab (see module
    docstring). Keys are namespaced ``(tenant, key)`` tuples; use the
    ``*_tenant`` methods or a :class:`TenantView`."""

    def __init__(
        self,
        dim: int,
        metric: str = "cos",
        reserved_space: int = 1024,
        mesh=None,
        name: str | None = None,
        config: TenancyConfig | None = None,
        device=None,
    ):
        super().__init__(dim, metric=metric, reserved_space=reserved_space, name=name, device=device, mesh=mesh)
        self._config = config
        # rows are granted per tenant, not from the shard lists
        self._free_shard = [[] for _ in range(self.n_shards)]
        self._docs_shard = [0] * self.n_shards
        self._tenant_host = np.full((self.capacity,), -1, np.int32)
        self._dev_tenant: list[torch.Tensor] | None = None  # the routing column, a tensor a shard
        self._tenant_dirty = True
        self._tid: dict[str, int] = {}
        self._tenant_free: dict[str, list[int]] = {}
        self._tenant_rows: dict[str, int] = {}
        self._segments: dict[str, list[list[int]]] = {}  # [start, size]
        self._free_extents: list[tuple[int, int]] = []  # demoted tenants' rows
        self._bump = [0] * self.n_shards  # next ungranted local row of each shard
        self._hits: dict[str, float] = {}
        self._cold: dict[str, dict] = {}
        self._search_count = 0
        # ledger bookkeeping: only touched tenants re-book, unless the
        # slab's allocation changed under every tenant
        self._touched: set[str] = set()
        self._booked_alloc = -1
        self._seg_rows = 0

    # -- config --

    def _cfg(self) -> TenancyConfig | None:
        return self._config if self._config is not None else active_tenancy()

    def _quota_for(self, tenant: str) -> TenantQuotas | None:
        cfg = self._cfg()
        return cfg.quota_for(tenant) if cfg is not None else None

    @staticmethod
    def _tenant_of_key(key) -> str:
        if not (isinstance(key, tuple) and len(key) == 2):
            raise TypeError(
                "TenantPackedIndex keys are namespaced (tenant, key) tuples; "
                "use add_tenant/add_tenant_batch or a TenantView"
            )
        return str(key[0])

    # -- segment allocation --

    def _alloc_slots(self, keys) -> list[int]:
        by_tenant: dict[str, int] = {}
        for k in keys:
            t = self._tenant_of_key(k)
            by_tenant[t] = by_tenant.get(t, 0) + 1
        for t, need in by_tenant.items():
            self._ensure_rows(t, need)
        out = []
        for k in keys:
            t = self._tenant_of_key(k)
            slot = self._tenant_free[t].pop()
            self._tenant_host[slot] = self._tid[t]
            self._docs_shard[slot // self.shard_capacity] += 1
            out.append(slot)
        self._touched.update(by_tenant)
        self._tenant_dirty = True
        return out

    def _live_docs_shard(self) -> list[int]:
        return list(self._docs_shard)

    def _ensure_rows(self, tenant: str, need: int) -> None:
        """Grow ``tenant``'s free pool to at least ``need`` slots,
        granting a doubled extent (quota-clamped) when short."""
        if tenant not in self._tid:
            self._tid[tenant] = len(self._tid)
            self._tenant_free.setdefault(tenant, [])
            self._tenant_rows.setdefault(tenant, 0)
            self._segments.setdefault(tenant, [])
        short = need - len(self._tenant_free[tenant])
        if short <= 0:
            return
        rows = self._tenant_rows[tenant]
        grant = max(short, max(_MIN_EXTENT, rows))  # per-tenant doubling
        quota = self._quota_for(tenant)
        if quota is not None and quota.hbm_bytes is not None:
            from ..internals.ledger import hot_row_bytes

            max_rows = quota.hbm_bytes // hot_row_bytes(self.dim)
            if rows + short > max_rows:
                raise TenantOverBudget(tenant, (rows + short) * hot_row_bytes(self.dim), quota.hbm_bytes)
            grant = min(grant, max_rows - rows)
        granted = 0
        while granted < short or grant > 0:
            ext = self._carve(grant if grant > 0 else short - granted)
            if ext is None:
                self._grow()
                continue
            start, size = ext
            self._segments[tenant].append([start, size])
            self._tenant_rows[tenant] += size
            self._seg_rows += size
            # LIFO with low slots first, matching the parent's order
            self._tenant_free[tenant].extend(range(start + size - 1, start - 1, -1))
            granted += size
            grant -= size
            flight_recorder.record(
                "tenant.grant", index=self.name, tenant=tenant, rows=size, start=start,
                total_rows=self._tenant_rows[tenant],
            )

    def _carve(self, want: int) -> tuple[int, int] | None:
        """Take up to ``want`` contiguous rows: freed extents (demoted
        tenants) first, then the bump tail of the shard with the most room;
        None = slab full."""
        for i, (start, size) in enumerate(self._free_extents):
            if size >= want:
                rest = (start + want, size - want)
                if rest[1]:
                    self._free_extents[i] = rest
                else:
                    del self._free_extents[i]
                return (start, want)
        if self._free_extents:
            i = max(range(len(self._free_extents)), key=lambda j: self._free_extents[j][1])
            return self._free_extents.pop(i)
        s = min(range(self.n_shards), key=lambda j: self._bump[j])
        room = self.shard_capacity - self._bump[s]
        if room <= 0:
            return None
        take = min(want, room)
        start = s * self.shard_capacity + self._bump[s]
        self._bump[s] += take
        return (start, take)

    # -- growth (parent doubling + tenant column / extent remap) --

    def _grow(self) -> None:
        super()._grow()
        self._free_shard = [[] for _ in range(self.n_shards)]
        if self.n_shards == 1:
            pad = self.capacity - len(self._tenant_host)
            self._tenant_host = np.concatenate([self._tenant_host, np.full((pad,), -1, np.int32)])
        self._tenant_dirty = True
        self._publish_metrics()

    def _remap_grow(self, old: int) -> None:
        super()._remap_grow(old)
        S, new = self.n_shards, self.shard_capacity
        col = self._tenant_host.reshape(S, old)
        self._tenant_host = np.concatenate([col, np.full((S, old), -1, np.int32)], axis=1).reshape(self.capacity)

        def remap(g: int) -> int:
            return (g // old) * new + g % old

        # extents never span a shard boundary, so a remapped extent stays
        # contiguous (the same local offset, a doubled shard base)
        self._tenant_free = {t: [remap(g) for g in free] for t, free in self._tenant_free.items()}
        self._segments = {t: [[remap(s0), size] for s0, size in segs] for t, segs in self._segments.items()}
        self._free_extents = [(remap(s0), size) for s0, size in self._free_extents]

    def _upload_full(self) -> None:
        super()._upload_full()
        self._publish_metrics()  # the slab's bytes are on the card now

    # -- updates --

    def add_tenant(self, tenant: str, key, vector, metadata=None) -> None:
        vec = np.asarray(vector, np.float32).reshape(-1)
        self.add_tenant_batch(tenant, [key], vec[None, :], [metadata])

    def add_tenant_batch(self, tenant: str, keys, vectors, metadatas=None) -> None:
        tenant = str(tenant)
        if tenant in self._cold:
            self._promote(tenant)  # re-pack before the new rows land
        self.add_batch_arrays([(tenant, k) for k in keys], vectors, metadatas)

    def add_batch_device(self, keys, dev_vectors, metadatas=None) -> None:
        # rows are granted per tenant on the host, so device-resident
        # vectors take the host path
        n = len(keys)
        if n == 0:
            return
        self.add_batch_arrays(keys, dev_vectors[:n].float().cpu().numpy(), metadatas)

    def remove_tenant(self, tenant: str, key) -> None:
        self.remove((str(tenant), key))

    def remove(self, key) -> None:
        self._check_fence()
        slot = self._slot_of.pop(key, None)
        if slot is None:
            self._cold_remove(key)
            return
        tenant = self._tenant_of_key(key)
        self._valid_host[slot] = False
        self._keys[slot] = None
        self._meta.pop(key, None)
        shard = slot // self.shard_capacity
        self._docs_shard[shard] -= 1
        # the slot stays reserved to its tenant's segment
        self._tenant_free[tenant].append(slot)
        self._touched.add(tenant)
        if not self._full:
            self._pending[slot] = None
        FRESHNESS.note_index_add(self, (shard,))
        self._publish_metrics()

    def _cold_remove(self, key) -> None:
        if not (isinstance(key, tuple) and len(key) == 2):
            return
        tenant = str(key[0])
        store = self._cold.get(tenant)
        if store is None or key[1] not in store["index_of"]:
            return
        pos = store["index_of"].pop(key[1])
        store["keys"].pop(pos)
        store["vecs"] = np.delete(store["vecs"], pos, axis=0)
        store["meta"].pop(key[1], None)
        store["index_of"] = {k: i for i, k in enumerate(store["keys"])}
        self._touched.add(tenant)
        self._publish_metrics()

    # -- search --

    def search_tenant_batch(
        self,
        tenant: str,
        queries,
        k: int,
        filter_fns: list[Callable | None] | None = None,
    ) -> list[list[tuple[Any, float]]]:
        """Per-tenant top-k: the parent's search over the slab under the
        tenant's mask."""
        tenant = str(tenant)
        q = queries if isinstance(queries, torch.Tensor) else np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        TENANCY_METRICS.record_search(tenant, len(q))
        # per-tenant staleness attribution (the parent's search records
        # the untagged answer bound)
        FRESHNESS.observe_answer(self, tenant=tenant)
        self._note_hit(tenant)
        self._maybe_sweep(exclude=tenant)
        if tenant in self._cold:
            if isinstance(q, torch.Tensor):
                q = q.float().cpu().numpy()
            return self._cold_search(tenant, q, k, filter_fns)
        live = self.tenant_docs(tenant)
        if len(q) == 0 or live == 0:
            return [[] for _ in range(len(q))]
        tid = self._tid[tenant]

        def mask():
            self._sync_tenant_column()
            masks = [tenant_mask(valid, bias, col, tid) for (_, valid, bias), col in zip(self._slab, self._dev_tenant)]
            return masks[0] if self.n_shards == 1 else masks

        rows = DeviceKnnIndex.search_batch(self, q, k, filter_fns, mask=mask, live=live)
        return [[(key[1], score) for key, score in row] for row in rows]

    def _sync_tenant_column(self) -> None:
        """The routing column beside each shard's slab, on its device."""
        c = self.shard_capacity
        if self._dev_tenant is not None and not self._tenant_dirty and int(self._dev_tenant[0].shape[0]) == c:
            return
        self._dev_tenant = [
            torch.from_numpy(self._tenant_host[s * c : (s + 1) * c]).to(dev, copy=True)
            for s, dev in enumerate(self.shard_devices)
        ]
        self._tenant_dirty = False

    # -- hit decay / cold demotion --

    def _note_hit(self, tenant: str) -> None:
        self._hits[tenant] = self._hits.get(tenant, 0.0) + 1.0
        store = self._cold.get(tenant)
        if store is not None:
            store["hits"] += 1
            if store["hits"] >= _PROMOTE_HITS:
                self._promote(tenant)

    def _maybe_sweep(self, exclude: str | None = None) -> None:
        cfg = self._cfg()
        if cfg is None or cfg.demote_every <= 0:
            return
        self._search_count += 1
        if self._search_count % cfg.demote_every:
            return
        for t in list(self._tid):
            if t == exclude or t in self._cold:
                continue
            self._hits[t] = self._hits.get(t, 0.0) * cfg.decay
            if self._hits[t] < cfg.demote_below and self.tenant_docs(t) > 0:
                self._demote(t)

    def _demote(self, tenant: str) -> None:
        """Move every one of ``tenant``'s rows to a host store and free
        its extents for other tenants to reuse."""
        self._refresh_host()
        keys: list[Any] = []
        vecs: list[np.ndarray] = []
        meta: dict[Any, Any] = {}
        for start, size in self._segments.get(tenant, ()):
            for slot in range(start, start + size):
                nk = self._keys[slot]
                if nk is not None:
                    keys.append(nk[1])
                    vecs.append(self._host[slot].copy())
                    if nk in self._meta:
                        meta[nk[1]] = self._meta.pop(nk)
                    self._slot_of.pop(nk, None)
                    self._docs_shard[slot // self.shard_capacity] -= 1
                    self._keys[slot] = None
                    self._valid_host[slot] = False
                    if not self._full:
                        self._pending[slot] = None
                self._tenant_host[slot] = -1
        self._free_extents.extend((start, size) for start, size in self._segments.get(tenant, ()))
        self._seg_rows -= self._tenant_rows.get(tenant, 0)
        self._segments[tenant] = []
        self._tenant_rows[tenant] = 0
        self._tenant_free[tenant] = []
        self._cold[tenant] = {
            "keys": keys,
            "vecs": np.asarray(vecs, np.float32) if vecs else np.zeros((0, self.dim), np.float32),
            "meta": meta,
            "index_of": {k: i for i, k in enumerate(keys)},
            "hits": 0,
        }
        self._tenant_dirty = True
        self._touched.add(tenant)
        flight_recorder.record("tenant.demote", index=self.name, tenant=tenant, docs=len(keys))
        self._publish_metrics()

    def _promote(self, tenant: str) -> None:
        store = self._cold.pop(tenant)
        self._hits[tenant] = 1.0
        if store["keys"]:
            metas = [store["meta"].get(k) for k in store["keys"]]
            # cos vectors were stored normalised; normalising them again on
            # the way back in is a no-op up to float rounding
            self.add_tenant_batch(tenant, store["keys"], store["vecs"], metas)
        self._touched.add(tenant)
        flight_recorder.record("tenant.promote", index=self.name, tenant=tenant, docs=len(store["keys"]))
        self._publish_metrics()

    def _cold_search(self, tenant, q, k, filter_fns):
        """Exact host scan over a demoted tenant's store — same score
        formulas as the device paths."""
        store = self._cold[tenant]
        vecs, keys = store["vecs"], store["keys"]
        if not len(keys) or not len(q):
            return [[] for _ in range(len(q))]
        if self.metric == "cos":
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.maximum(norms, 1e-12)
        if self.metric == "l2":
            sq = np.sum(vecs * vecs, axis=1)
            qq = np.sum(q * q, axis=1, keepdims=True)
            scores = 2.0 * (q @ vecs.T) - sq[None, :] - qq
        else:
            scores = q @ vecs.T
        out = []
        for i in range(len(q)):
            order = np.argsort(-scores[i], kind="stable")
            flt = filter_fns[i] if filter_fns is not None else None
            row = []
            for j in order:
                key = keys[int(j)]
                if flt is not None and not _apply_filter(flt, store["meta"].get(key)):
                    continue
                row.append((key, float(scores[i][int(j)])))
                if len(row) >= k:
                    break
            out.append(row)
        return out

    # -- elastic reshard protocol (elastic/controller.py drives) --

    def spawn_like(self, mesh, reserved_space: int | None = None):
        """An EMPTY packed slab with this one's tenancy config on a target
        mesh; extent grants replay as tenants land again."""
        return TenantPackedIndex(
            self.dim, metric=self.metric, reserved_space=int(reserved_space) if reserved_space else 64, mesh=mesh,
            name=self.name, config=self._config, device=self.device,
        )

    def reshard_export_chunks(self, chunk_rows: int):
        """Migration stream, tenant by tenant in registration order: a hot
        tenant's live rows from the slab (slot order, as the slab holds
        them: the import does not normalise them again), a cold tenant's
        host-store rows followed by a ``tenant_cold`` marker, so the target
        demotes it back to exactly a host store."""
        step = max(1, int(chunk_rows))
        for tenant in list(self._tid):
            if tenant in self._cold:
                store = self._cold[tenant]
                keys = list(store["keys"])
                for i in range(0, len(keys), step):
                    batch = [k for k in keys[i : i + step] if k in store["index_of"]]
                    if not batch:
                        continue
                    idx = [store["index_of"][k] for k in batch]
                    yield {"kind": "tenant_rows", "tenant": tenant, "keys": batch, "vecs": store["vecs"][idx].copy(),
                           "metas": [store["meta"].get(k) for k in batch]}
                yield {"kind": "tenant_cold", "tenant": tenant, "keys": []}
                continue
            slots = sorted(
                slot for start, size in self._segments.get(tenant, ()) for slot in range(start, start + size)
                if self._keys[slot] is not None
            )
            for i in range(0, len(slots), step):
                batch = [slot for slot in slots[i : i + step] if self._keys[slot] is not None]
                if not batch:
                    continue
                ns_keys = [self._keys[slot] for slot in batch]
                yield {"kind": "tenant_rows", "tenant": tenant, "keys": [nk[1] for nk in ns_keys],
                       "vecs": self._rows_at(np.asarray(batch, np.int64)),
                       "metas": [self._meta.get(nk) for nk in ns_keys]}

    def reshard_import_chunk(self, chunk: dict) -> None:
        kind = chunk.get("kind")
        tenant = str(chunk.get("tenant", ""))
        if kind == "tenant_rows":
            self._import_raw = True
            try:
                self.add_tenant_batch(tenant, chunk["keys"], chunk["vecs"], chunk["metas"])
            finally:
                self._import_raw = False
            return
        if kind == "tenant_cold":
            self._ensure_rows(tenant, 0)  # register the tenant id
            if tenant not in self._cold:
                self._demote(tenant)
            return
        raise ValueError(f"packed index cannot import chunk kind {kind!r}")

    # -- introspection / accounting --

    def view(self, tenant: str) -> "TenantView":
        """One tenant's duck-typed index API over this slab."""
        return TenantView(self, tenant)

    def tenants(self) -> list[str]:
        return list(self._tid)

    def tenant_docs(self, tenant: str) -> int:
        tenant = str(tenant)
        if tenant in self._cold:
            return len(self._cold[tenant]["keys"])
        return self._tenant_rows.get(tenant, 0) - len(self._tenant_free.get(tenant, ()))

    def tenant_is_cold(self, tenant: str) -> bool:
        return str(tenant) in self._cold

    def _publish_metrics(self) -> None:
        super()._publish_metrics()
        self._publish_tenants()

    def _publish_tenants(self) -> None:
        """Book the touched tenants' segment bytes under the
        ``index.tenant`` ledger account (every tenant's when the slab's
        allocation changed), plus the ungranted remainder under
        ``__unassigned__`` so the account sums exactly to ``index.hot``,
        and feed the per-tenant registry."""
        from ..internals.ledger import LEDGER, hot_row_bytes

        row_b = hot_row_bytes(self.dim)
        alloc = 0 if self._slab is None else sum(t.element_size() * t.numel() for part in self._slab for t in part)
        if alloc != self._booked_alloc:
            self._touched.update(self._tid)
            self._booked_alloc = alloc
        touched, self._touched = self._touched, set()
        for t in touched:
            rows = self._tenant_rows.get(t, 0)
            docs = rows - len(self._tenant_free.get(t, ()))
            owner = f"{self.name}/{t}"
            if rows and alloc:
                LEDGER.update("index.tenant", owner, rows * row_b, used_bytes=docs * row_b)
            else:
                LEDGER.drop("index.tenant", owner)
            TENANCY_METRICS.set_index(
                t, docs=self.tenant_docs(t), hbm_bytes=rows * row_b if alloc else 0, cold=t in self._cold
            )
        spare = f"{self.name}/__unassigned__"
        if alloc and self.capacity > self._seg_rows:
            LEDGER.update("index.tenant", spare, (self.capacity - self._seg_rows) * row_b, used_bytes=0)
        else:
            LEDGER.drop("index.tenant", spare)


class TenantView:
    """One tenant's duck-typed index API over a shared packed slab —
    what ``stdlib`` hands the engine when ``tenant=`` is set. Strips the
    ``(tenant, key)`` namespacing both ways."""

    def __init__(self, packed: TenantPackedIndex, tenant: str):
        self.packed = packed
        self.tenant = str(tenant)

    @property
    def dim(self) -> int:
        return self.packed.dim

    @property
    def metric(self) -> str:
        return self.packed.metric

    def __len__(self) -> int:
        return self.packed.tenant_docs(self.tenant)

    def add(self, key, vector, metadata=None) -> None:
        self.packed.add_tenant(self.tenant, key, vector, metadata)

    def add_batch(self, items: list[tuple]) -> None:
        if not items:
            return
        keys = [k for k, _, _ in items]
        vectors = np.asarray([np.asarray(p, np.float32).reshape(-1) for _, p, _ in items])
        self.packed.add_tenant_batch(self.tenant, keys, vectors, [m for _, _, m in items])

    def add_batch_arrays(self, keys, vectors, metadatas=None) -> None:
        self.packed.add_tenant_batch(self.tenant, keys, vectors, metadatas)

    def remove(self, key) -> None:
        self.packed.remove_tenant(self.tenant, key)

    def search_batch(self, queries, k, filter_fns=None):
        return self.packed.search_tenant_batch(self.tenant, queries, k, filter_fns)

    def search_one(self, query, k: int, filter_fn: Callable | None = None):
        return self.search_batch(
            np.asarray(query, np.float32)[None, :], k, [filter_fn] if filter_fn is not None else None
        )[0]


# ---------------------------------------------------------------------------
# process-wide slab registry: every (dim, metric, device or mesh) combination
# shares ONE packed slab, so 10k tenants with the same geometry share one
# device allocation and one launch per search

_SLAB_LOCK = threading.Lock()
_SLABS: dict[tuple, TenantPackedIndex] = {}


def shared_slab(
    dim: int,
    metric: str = "cos",
    reserved_space: int = 1024,
    mesh=None,
    config: TenancyConfig | None = None,
    device=None,
) -> TenantPackedIndex:
    """The shared slab of this geometry and placement (made on first use):
    one a device without a mesh, one a mesh on a mesh."""
    from ..device import resolve_device

    dev = resolve_device(device) if mesh is None else None
    key = (int(dim), str(metric), str(dev) if mesh is None else mesh)
    with _SLAB_LOCK:
        slab = _SLABS.get(key)
        if slab is None:
            slab = TenantPackedIndex(
                dim, metric=metric, reserved_space=reserved_space, name=f"tenant-slab-{dim}-{metric}",
                config=config, device=dev, mesh=mesh,
            )
            _SLABS[key] = slab
        return slab


def reset_slabs() -> None:
    """Drop the slab registry (tests)."""
    with _SLAB_LOCK:
        _SLABS.clear()
