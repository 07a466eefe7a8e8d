"""Device-resident brute-force KNN index, on one device or over a mesh.

Port of ``pathway_tpu/ops/knn.py::DeviceKnnIndex``. A capacity-doubling
``[capacity, dim]`` float32 slab, a validity mask and a score bias live on
the device; a host mirror keeps keys, metadata and (lazily) the rows.
add/remove stage on the host and sync before the next search;
``add_batch_device`` scatters embeddings that never visit the host.
Updates run as in-place tensor ops (the reference donates and replaces its
arrays; here the slab is mutated where it lies).

Search at fetch <= 64 on a CUDA slab runs the fused top-k kernel
(``ops/knn_topk.py``, kernel B2); wider fetches and CPU slabs use the
plain score matrix + :func:`_topk_lower_index`, which orders exact ties by
ascending slot as the reference's ``lax.top_k`` does.
``cos`` rows are normalised on add and queries on search; ``l2`` scores
are ``-|q - x|^2``; dead slots never surface.

Mesh scale-out (``mesh=``, a ``parallel.sharding.DeviceMesh``, or
``pw.run(mesh=...)`` through the stdlib factories): the index becomes one
logical index sharded over the mesh's ``data`` axis. Its global slot range
``[0, n_shards * shard_capacity)`` is split contiguously; shard ``s``'s
slab, mask and bias live on ``mesh.data_devices()[s]``. Keys route to
their shard by the engine's key rule (``engine.value.shard_of``), each
shard keeps its own free list, and growth doubles every shard's slab in
place, so global slot ``g`` moves to ``(g // c) * 2c + g % c``. Search at
fetch <= 64 on CUDA runs ``knn_topk_sharded`` (B2 per shard, one
cross-shard merge); otherwise a per-shard plain top-k re-based to global
slots and one top-k over the ``[q, n_shards * k]`` candidates. The
reference replicates the index over the mesh's ``model`` axis; that
changes no answer, so the port places shard ``s`` on ``devices[s][0]``
only. ``mesh=None`` is the single-device index. The elastic reshard
(``spawn_like``, ``reshard_*``) raises until that plane is ported.

Left for later slices: freshness, index metrics, the HBM ledger, tracing,
the flight recorder and chip-time accounting.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch

from ..device import as_current, resolve_device
from ..parallel.sharding import CLUSTER_ITEM
from .knn_topk import NEG as _PNEG
from .knn_topk import KERNEL_MAX_K, knn_topk, knn_topk_sharded

_NEG = -3.0e38

_NAME_SEQ = itertools.count()


class StaleGeneration(RuntimeError):
    """Write rejected: this index belongs to a fenced (pre-reshard)
    generation; retry through the live handle."""

    def __init__(self, name: str, generation: int):
        super().__init__(
            f"index {name!r} is fenced at generation {generation}: a newer "
            "generation serves now; retry through the live handle"
        )
        self.index_name = name
        self.generation = generation


def _shard_of_key(key, n_shards: int) -> int:
    """Owning shard of an index key: the engine's key hash (low bits mod
    n), so an index over the mesh and a table over workers agree."""
    if n_shards <= 1:
        return 0
    from ..engine.value import ref_scalar, shard_of

    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return shard_of(int(key), n_shards)
    return shard_of(int(ref_scalar(key)), n_shards)


def _topk_lower_index(scores: torch.Tensor, k: int):
    """Top-k along dim 1, best first, with exactly equal scores in
    ascending index order (the k-th boundary included), as ``lax.top_k``
    orders them; ``torch.topk`` makes no such promise.

    Exact without a full sort: each score maps to an int32 that orders as
    the float does (-0.0 folded into +0.0), widened to int64 with the
    complement of its index in the low 32 bits. The keys are then unique,
    so one ``torch.topk`` over them has no ties to order."""
    s = scores.float() + 0.0  # -0.0 + 0.0 == +0.0
    bits = s.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key.mul_(1 << 32).add_(
        (0xFFFFFFFF - torch.arange(s.shape[1], device=s.device, dtype=torch.int64))[None, :]
    )
    _, idx = torch.topk(key, k, dim=1)
    del key
    return scores.gather(1, idx), idx


def _topk_dot(matrix, valid, queries, k):
    # cos: rows pre-normalised so cosine == dot; ip: raw dot
    scores = queries @ matrix.T
    scores = torch.where(valid[None, :], scores, _NEG)
    return _topk_lower_index(scores, k)


def _topk_l2(matrix, valid, queries, k):
    # -||q - x||^2 = 2 q.x - ||x||^2 - ||q||^2
    sq = (matrix * matrix).sum(dim=1)
    scores = 2.0 * (queries @ matrix.T) - sq[None, :]
    scores = torch.where(valid[None, :], scores, _NEG)
    neg_d2, idx = _topk_lower_index(scores, k)
    qq = (queries * queries).sum(dim=1, keepdim=True)
    return neg_d2 - qq, idx


def _topk_fn(metric: str) -> Callable:
    """Plain score matrix + top-k for one metric."""
    return {"cos": _topk_dot, "ip": _topk_dot, "l2": _topk_l2}[metric]


def _pallas_eligible(metric: str, k: int, device: torch.device) -> bool:
    """The fused top-k kernel serves a CUDA slab at fetch <= 64 (the
    reference switches at the same width)."""
    return device.type == "cuda" and k <= KERNEL_MAX_K


def _pallas_bias(metric: str, matrix, valid):
    """Validity (+ L2 -|doc|^2) bias of the fused kernel."""
    b = torch.where(valid, 0.0, _PNEG).to(torch.float32)
    if metric == "l2":
        b = b - (matrix * matrix).sum(dim=1)
    return b


def _l2_shift(metric: str, vals, queries):
    """The kernels score L2 as ``2 q.x - |x|^2``; subtract ``|q|^2`` from
    the live entries."""
    if metric != "l2":
        return vals
    qq = (queries * queries).sum(dim=1, keepdim=True)
    return torch.where(vals > _PNEG / 2, vals - qq, vals)


def _pallas_topk(metric: str, matrix, valid, queries, k: int, bias=None):
    if bias is None:
        bias = _pallas_bias(metric, matrix, valid)
    factor = 2.0 if metric == "l2" else 1.0
    vals, idx = knn_topk(queries.contiguous(), matrix, k=k, bias=bias, factor=factor)
    return _l2_shift(metric, vals, queries), idx


def _k_bucket(k: int) -> int:
    b = 8
    while b < k:
        b *= 2
    return b


def _take(t: torch.Tensor, sel) -> torch.Tensor:
    return t if isinstance(sel, slice) else t.index_select(0, torch.as_tensor(sel, device=t.device))


class DeviceKnnIndex:
    """Growable device slab (one per shard on a mesh) + host-side key and
    metadata mirror."""

    def __init__(
        self,
        dim: int,
        metric: str = "cos",  # "cos" | "l2" | "ip"
        reserved_space: int = 1024,
        name: str | None = None,
        device=None,
        mesh=None,
    ):
        if metric not in ("cos", "l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        self.mesh = mesh
        devices = mesh.data_devices() if mesh is not None else [device]
        self.shard_devices = [resolve_device(d) for d in devices]
        self.device = self.shard_devices[0]
        self.n_shards = len(self.shard_devices)
        self.dim = dim
        self.metric = metric
        self.name = name if name is not None else f"knn{next(_NAME_SEQ)}"
        # one logical slot range [0, n_shards * shard_capacity), split
        # contiguously: shard s holds [s * c, (s + 1) * c)
        self.shard_capacity = -(-max(64, int(reserved_space)) // self.n_shards)
        self.capacity = self.n_shards * self.shard_capacity
        self._host = np.zeros((self.capacity, dim), np.float32)
        self._valid_host = np.zeros((self.capacity,), bool)
        self._keys: list[Any] = [None] * self.capacity
        self._slot_of: dict[Any, int] = {}
        self._meta: dict[Any, Any] = {}
        c = self.shard_capacity
        # per-shard free lists, low slots first
        self._free_shard: list[list[int]] = [
            list(range((s + 1) * c - 1, s * c - 1, -1)) for s in range(self.n_shards)
        ]
        self._full = True  # device needs a full host upload
        self._host_stale = False  # device rows newer than host mirror
        self._pending: dict[int, np.ndarray | None] = {}  # slot -> vec | tombstone
        self._slab: list[list[torch.Tensor]] | None = None  # per shard [matrix, valid, bias]
        self._encoder = None
        self.generation = 0
        self._fenced = False

    def __len__(self) -> int:
        return len(self._slot_of)

    # the single slab of an index without a mesh
    @property
    def _dev_matrix(self) -> torch.Tensor | None:
        return self._shard_part(0)

    @property
    def _dev_valid(self) -> torch.Tensor | None:
        return self._shard_part(1)

    @property
    def _dev_bias(self) -> torch.Tensor | None:
        return self._shard_part(2)

    def _shard_part(self, part: int) -> torch.Tensor | None:
        if self.n_shards != 1:
            raise AttributeError("a mesh index holds one slab per shard (_slab)")
        return None if self._slab is None else self._slab[0][part]

    def _check_fence(self) -> None:
        if self._fenced:
            raise StaleGeneration(self.name, self.generation)

    def fence(self, generation: int | None = None) -> None:
        """Freeze this index as a dead generation: later writes raise
        :class:`StaleGeneration`; reads still work."""
        self._fenced = True
        if generation is not None:
            self.generation = max(self.generation, int(generation))

    def _alloc_slots(self, keys) -> list[int]:
        """Route every key to its shard, grow until each shard can hold its
        share, then pop: growth remaps the global slots of a mesh index, so
        it comes before any slot of this batch is handed out."""
        if self.n_shards == 1:
            while len(self._free_shard[0]) < len(keys):
                self._grow()
            free = self._free_shard[0]
            return [free.pop() for _ in keys]
        shards = np.fromiter((_shard_of_key(k, self.n_shards) for k in keys), np.int64, len(keys))
        need = np.bincount(shards, minlength=self.n_shards)
        while any(len(self._free_shard[s]) < need[s] for s in range(self.n_shards)):
            self._grow()
        free = self._free_shard
        return [free[s].pop() for s in shards.tolist()]

    def _live_docs_shard(self) -> list[int]:
        """Live rows per shard, from the validity mask."""
        v = self._valid_host.reshape(self.n_shards, self.shard_capacity)
        return [int(n) for n in v.sum(axis=1)]

    # --- updates (engine diff protocol) ---

    def add(self, key, vector, metadata=None) -> None:
        vec = np.asarray(vector, np.float32).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(f"index dim {self.dim}, got vector dim {vec.shape[0]}")
        self.add_batch_arrays([key], vec[None, :], [metadata])

    def add_batch(self, items: list[tuple]) -> None:
        """``items``: ``(key, vector, metadata)`` triples."""
        if not items:
            return
        keys = [k for k, _, _ in items]
        vectors = np.asarray([np.asarray(p, np.float32).reshape(-1) for _, p, _ in items])
        self.add_batch_arrays(keys, vectors, [m for _, _, m in items])

    def add_batch_arrays(self, keys, vectors, metadatas=None) -> None:
        """Bulk insert from host arrays: one vectorised staging write."""
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] vectors, got {vecs.shape}")
        if len(keys) != len(vecs):
            raise ValueError("keys/vectors length mismatch")
        self._check_fence()
        for key in keys:
            if key in self._slot_of:
                self.remove(key)
        slots = self._alloc_slots(keys)
        if self.metric == "cos":
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs / np.maximum(norms, 1e-12)
        sl = np.asarray(slots)
        self._host[sl] = vecs
        self._valid_host[sl] = True
        for i, (slot, key) in enumerate(zip(slots, keys)):
            self._keys[slot] = key
            self._slot_of[key] = slot
            if metadatas is not None and metadatas[i] is not None:
                self._meta[key] = metadatas[i]
        if not self._full:
            for i, slot in enumerate(slots):
                self._pending[slot] = vecs[i]

    def add_batch_device(self, keys, dev_vectors: torch.Tensor, metadatas=None) -> None:
        """Bulk insert of embeddings already on the index's (first) device
        (e.g. ``SentenceEncoder.encode_device`` output): the vectors never
        visit the host; on a mesh each shard's rows go to its device with
        one ``index_select`` and one copy. ``dev_vectors`` may have more
        rows than ``keys``; the extra rows drop."""
        n = len(keys)
        if n == 0:
            return
        self._check_fence()
        if dev_vectors.device != self.device:
            raise ValueError(f"dev_vectors on {dev_vectors.device}, index on {self.device}")
        if self._full or self._slab is None:
            if not self._slot_of and not self._pending:
                # cold start on an empty index: make the slabs on the devices
                c = self.shard_capacity
                self._slab = [self._empty(dev, c) for dev in self.shard_devices]
                self._full = False
                self._pending.clear()
            else:
                self._upload_full()
        for key in keys:
            if key in self._slot_of:
                self.remove(key)
        alloc = self._alloc_slots(keys)
        self._flush_pending()
        self._scatter_dev(np.asarray(alloc, np.int64), dev_vectors[:n])
        self._valid_host[np.asarray(alloc)] = True
        self._host_stale = True
        for i, (slot, key) in enumerate(zip(alloc, keys)):
            self._keys[slot] = key
            self._slot_of[key] = slot
            if metadatas is not None and metadatas[i] is not None:
                self._meta[key] = metadatas[i]

    def remove(self, key) -> None:
        self._check_fence()
        slot = self._slot_of.pop(key, None)
        if slot is None:
            return
        self._valid_host[slot] = False
        self._keys[slot] = None
        self._meta.pop(key, None)
        self._free_shard[slot // self.shard_capacity].append(slot)
        if not self._full:
            self._pending[slot] = None

    # --- elastic reshard protocol: not ported ---

    def spawn_like(self, mesh, reserved_space: int | None = None):
        raise NotImplementedError(f"DeviceKnnIndex.spawn_like needs {CLUSTER_ITEM}")

    def reshard_export_chunks(self, chunk_rows: int):
        raise NotImplementedError(f"DeviceKnnIndex.reshard_export_chunks needs {CLUSTER_ITEM}")

    def reshard_import_chunk(self, chunk: dict) -> None:
        raise NotImplementedError(f"DeviceKnnIndex.reshard_import_chunk needs {CLUSTER_ITEM}")

    def reshard_finish(self) -> None:
        raise NotImplementedError(f"DeviceKnnIndex.reshard_finish needs {CLUSTER_ITEM}")

    # --- device slabs ---

    def _empty(self, device: torch.device, rows: int) -> list[torch.Tensor]:
        return [
            torch.zeros((rows, self.dim), dtype=torch.float32, device=device),
            torch.zeros((rows,), dtype=torch.bool, device=device),
            torch.full((rows,), _PNEG, dtype=torch.float32, device=device),
        ]

    def _grow(self) -> None:
        old = self.shard_capacity
        self.shard_capacity *= 2
        self.capacity = self.n_shards * self.shard_capacity
        if self.n_shards == 1:
            self._host = np.concatenate([self._host, np.zeros((old, self.dim), np.float32)])
            self._valid_host = np.concatenate([self._valid_host, np.zeros((old,), bool)])
            self._keys.extend([None] * old)
            self._free_shard[0].extend(range(self.capacity - 1, old - 1, -1))
        else:
            self._remap_grow(old)
        if self._slab is not None and not self._full:
            # double every resident slab in place on its device: a shard's
            # rows keep their local positions, so staged updates (remapped
            # above) stay valid
            for part in self._slab:
                grown = self._empty(part[0].device, self.shard_capacity)
                for new, cur in zip(grown, part):
                    new[:old] = cur
                part[:] = grown

    def _remap_grow(self, old: int) -> None:
        """Host mirror of the sharded growth: widen every shard from ``old``
        to ``2 * old`` rows; global slot g -> (g // old) * 2 old + g % old."""
        S, new = self.n_shards, self.shard_capacity
        host = self._host.reshape(S, old, self.dim)
        self._host = np.concatenate([host, np.zeros((S, old, self.dim), np.float32)], axis=1).reshape(
            self.capacity, self.dim
        )
        valid = self._valid_host.reshape(S, old)
        self._valid_host = np.concatenate([valid, np.zeros((S, old), bool)], axis=1).reshape(self.capacity)

        def remap(g: int) -> int:
            return (g // old) * new + g % old

        keys: list[Any] = [None] * self.capacity
        for g, key in enumerate(self._keys):
            if key is not None:
                keys[remap(g)] = key
        self._keys = keys
        self._slot_of = {k: remap(g) for k, g in self._slot_of.items()}
        self._pending = {remap(g): vec for g, vec in self._pending.items()}
        self._free_shard = [[remap(g) for g in free] for free in self._free_shard]
        for s in range(S):
            # new rows join each shard's LIFO free list low slots first, as
            # the single-shard growth extends its list
            self._free_shard[s].extend(range((s + 1) * new - 1, s * new + old - 1, -1))

    def _refresh_host(self) -> None:
        """Pull device-resident rows into the host mirror, overlaying
        host-staged pending updates (newer than the device copy)."""
        if not self._host_stale or self._slab is None:
            return
        c = self.shard_capacity
        for s, part in enumerate(self._slab):
            self._host[s * c : (s + 1) * c] = part[0].cpu().numpy()
        for slot, vec in self._pending.items():
            if vec is not None:
                self._host[slot] = vec
        self._host_stale = False

    def _upload_full(self) -> None:
        self._refresh_host()
        c = self.shard_capacity
        self._slab = []
        for s, dev in enumerate(self.shard_devices):
            # copies, also on the CPU: the slab is mutated in place and must
            # not alias the host mirror
            m = torch.from_numpy(self._host[s * c : (s + 1) * c]).to(dev, copy=True)
            v = torch.from_numpy(self._valid_host[s * c : (s + 1) * c]).to(dev, copy=True)
            self._slab.append([m, v, _pallas_bias(self.metric, m, v)])
        self._full = False
        self._pending.clear()

    def _sync(self) -> None:
        if self._full or self._slab is None:
            self._upload_full()
            return
        if not self._pending:
            return
        if len(self._pending) > self.capacity // 2 and not self._host_stale:
            # bulk churn past half the index: one upload beats scatters
            self._upload_full()
            return
        self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        slots = np.fromiter(self._pending.keys(), np.int64, len(self._pending))
        vecs = list(self._pending.values())
        self._pending.clear()
        if all(v is None for v in vecs):
            # tombstone-only flush: only the slot ids cross to the device
            self._scatter_tomb(slots)
            return
        rows = np.zeros((len(vecs), self.dim), np.float32)
        for i, v in enumerate(vecs):
            if v is not None:
                rows[i] = v
        self._scatter(slots, rows, np.array([v is not None for v in vecs]))

    def _by_shard(self, slots: np.ndarray):
        """(shard, the positions in ``slots`` it owns, their local slots)
        for every shard that ``slots`` touch."""
        if self.n_shards == 1:
            yield 0, slice(None), slots
            return
        owner = slots // self.shard_capacity
        for s in np.unique(owner).tolist():
            sel = np.nonzero(owner == s)[0]
            yield s, sel, slots[sel] - s * self.shard_capacity

    def _scatter(self, slots: np.ndarray, rows: np.ndarray, flags: np.ndarray) -> None:
        """Write staged rows (flags True) and tombstones (flags False) into
        the owning shards' slabs, validity and bias, in place."""
        for s, sel, local in self._by_shard(slots):
            matrix, valid, bias = self._slab[s]
            dev = matrix.device
            sl = torch.as_tensor(local, dtype=torch.long, device=dev)
            rows_d = torch.from_numpy(rows[sel]).to(dev)
            live = torch.from_numpy(flags[sel]).to(dev)
            matrix[sl] = rows_d
            valid[sl] = live
            b = torch.where(live, 0.0, _PNEG).to(torch.float32)
            if self.metric == "l2":
                b = torch.where(live, b - (rows_d * rows_d).sum(dim=1), b)
            bias[sl] = b

    def _scatter_dev(self, slots: np.ndarray, vecs: torch.Tensor) -> None:
        """Write device-resident rows into the owning shards' slabs in place
        (normalised for cos, their -|x|^2 bias for l2)."""
        vecs = vecs.to(torch.float32)
        if self.metric == "cos":
            norms = torch.sqrt((vecs * vecs).sum(dim=1, keepdim=True))
            vecs = vecs / torch.clamp(norms, min=1e-12)
        for s, sel, local in self._by_shard(slots):
            matrix, valid, bias = self._slab[s]
            dev = matrix.device
            rows = _take(vecs, sel).to(dev)
            sl = torch.as_tensor(local, dtype=torch.long, device=dev)
            matrix[sl] = rows
            valid[sl] = True
            bias[sl] = -(rows * rows).sum(dim=1) if self.metric == "l2" else 0.0

    def _scatter_tomb(self, slots: np.ndarray) -> None:
        for s, _, local in self._by_shard(slots):
            _, valid, bias = self._slab[s]
            sl = torch.as_tensor(local, dtype=torch.long, device=valid.device)
            valid[sl] = False
            bias[sl] = _PNEG

    # --- search ---

    def _queries(self, queries) -> torch.Tensor:
        """Queries -> [q, dim] f32 on the index's device, normalised for cos.
        Host arrays are normalised on the host, device tensors on the device."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
            if q.dim() == 1:
                q = q[None, :]
            if self.metric == "cos":
                q = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True), min=1e-12)
            return q.contiguous()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric == "cos":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(np.ascontiguousarray(q)).to(self.device)

    def _device_topk(self, q: torch.Tensor, fetch: int):
        if self.n_shards == 1:
            matrix, valid, bias = self._slab[0]
            if _pallas_eligible(self.metric, fetch, self.device):
                return _pallas_topk(self.metric, matrix, valid, q, fetch, bias=bias)
            return _topk_fn(self.metric)(matrix, valid, q, fetch)
        if _pallas_eligible(self.metric, fetch, self.device):
            vals, idx = knn_topk_sharded(
                q.contiguous(), [p[0] for p in self._slab], [p[2] for p in self._slab], k=fetch,
                factor=2.0 if self.metric == "l2" else 1.0,
            )
            return _l2_shift(self.metric, vals, q), idx
        return self._sharded_topk(q, fetch)

    def _sharded_topk(self, q: torch.Tensor, fetch: int):
        """The plain two-phase search over the shards: each shard's top
        ``min(fetch, rows)`` re-based to global slots, then one top-k over
        the shard-major ``[q, n_shards * k_local]`` candidates (ties to the
        lower global slot); for L2, ``-|q|^2`` after the top-k, on every
        entry, as the reference's ``merge_topk`` does."""
        rows = self.shard_capacity
        k_local = min(fetch, rows)
        l2 = self.metric == "l2"
        # queries out to every device first, results back last: a copy between
        # cards between two shards' work would run the shards one by one
        on_device = {dev: q.to(dev) for dev in set(self.shard_devices)}
        local = []
        for s, (matrix, valid, _) in enumerate(self._slab):
            with as_current(matrix.device):
                scores = on_device[matrix.device] @ matrix.T
                if l2:
                    scores = 2.0 * scores - (matrix * matrix).sum(dim=1)[None, :]
                scores = torch.where(valid[None, :], scores, _NEG)
                v, i = _topk_lower_index(scores, k_local)
            local.append((v, i + s * rows))
        vals = torch.cat([v.to(self.device) for v, _ in local], dim=1)
        v, pos = _topk_lower_index(vals, min(fetch, self.n_shards * k_local))
        gi = torch.cat([i.to(self.device) for _, i in local], dim=1).gather(1, pos)
        if l2:
            v = v - (q * q).sum(dim=1, keepdim=True)
        return v, gi

    def search_batch(
        self,
        queries,
        k: int,
        filter_fns: list[Callable | None] | None = None,
    ) -> list[list[tuple[Any, float]]]:
        """queries [q, dim] (host array or device tensor) -> per query a
        list of (key, score), best first (score: cosine similarity, inner
        product, or negative squared L2). ``filter_fns[i]`` filters
        candidate metadata; over-fetch + host filter with exponential refill."""
        if len(self._slot_of) == 0 or len(queries) == 0:
            return [[] for _ in range(len(queries))]
        q = self._queries(queries)
        self._sync()

        def dispatch(todo, fetch):
            rows = q if len(todo) == q.shape[0] else q[torch.as_tensor(todo, device=self.device)]
            return self._device_topk(rows, fetch)

        return self._assemble(q.shape[0], k, filter_fns, dispatch)

    def _assemble(self, q_n, k, filter_fns, dispatch):
        """Run ``dispatch(todo, fetch)`` for the outstanding queries, map
        slots to keys, apply metadata filters, and refetch exponentially
        deeper when filters starve a query."""
        need_filter = filter_fns is not None and any(f is not None for f in filter_fns)
        fetch = min(_k_bucket(4 * k if need_filter else k), self.capacity)
        results: list[list[tuple[Any, float]] | None] = [None] * q_n
        todo = list(range(q_n))
        while todo:
            scores, idx = dispatch(todo, fetch)
            scores = scores.cpu().numpy()
            idx = idx.cpu().numpy()
            next_todo = []
            for row, qi in enumerate(todo):
                flt = filter_fns[qi] if filter_fns is not None else None
                out: list[tuple[Any, float]] = []
                for s, slot in zip(scores[row], idx[row]):
                    if s <= _NEG / 2:
                        break
                    key = self._keys[slot]
                    if key is None:
                        continue
                    if flt is not None and not _apply_filter(flt, self._meta.get(key)):
                        continue
                    out.append((key, float(s)))
                    if len(out) == k:
                        break
                results[qi] = out
                if len(out) < min(k, len(self._slot_of)) and fetch < self.capacity:
                    next_todo.append(qi)  # filters ate too many candidates
            if next_todo:
                fetch = min(fetch * 4, self.capacity)
                todo = next_todo
            else:
                todo = []
        return [r if r is not None else [] for r in results]

    def search_dispatch(self, queries, k: int):
        """Async half of a search: normalise, sync the index and launch the
        device top-k; returns device (scores, slots) without waiting."""
        q = self._queries(queries)
        self._sync()
        return self._device_topk(q, min(_k_bucket(k), self.capacity))

    def search_resolve(self, scores, idx, k: int) -> list[list[tuple[Any, float]]]:
        """Blocking half of ``search_dispatch``: slots -> (key, score)."""
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        out = []
        for qi in range(scores.shape[0]):
            row = []
            for slot, score in zip(idx[qi], scores[qi]):
                key = self._keys[int(slot)] if 0 <= int(slot) < len(self._keys) else None
                if key is not None:
                    row.append((key, float(score)))
                if len(row) == k:
                    break
            out.append(row)
        return out

    # --- text query path ---

    def attach_encoder(self, encoder) -> None:
        """Enable ``search_texts_batch``: ``encoder`` is a SentenceEncoder
        on this index's device."""
        self._encoder = encoder

    def search_texts_batch(
        self,
        texts: list[str],
        k: int,
        filter_fns: list[Callable | None] | None = None,
    ) -> list[list[tuple[Any, float]]]:
        """Raw text queries -> (key, score) lists: tokenize, encode through
        the whole-layer path, then the index's own top-k on the device
        embeddings (the fused kernel B2 on a CUDA slab at fetch <= 64, else
        the plain product + tie-ordered top-k); nothing visits the host
        before the (score, slot) pairs."""
        from ..models.batching import DEFAULT_SEQ_BUCKETS, bucket
        from .fused_layer import encoder_forward, use_fused_encoder

        enc = self._encoder
        if len(self._slot_of) == 0 or len(texts) == 0:
            return [[] for _ in range(len(texts))]
        if enc is None:
            raise RuntimeError("search_texts_batch requires attach_encoder()")
        texts = ["" if t is None else str(t) for t in texts]
        ids_mat, lens = enc.tokenizer.batch_encode_matrix(texts, enc.max_seq_len)
        self._sync()
        n = len(texts)
        L = min(bucket(int(lens.max()), DEFAULT_SEQ_BUCKETS), ids_mat.shape[1])
        qb = _k_bucket(n)
        ids = np.zeros((qb, L), np.int32)
        ids[:n] = ids_mat[:, :L]
        lens_p = np.zeros((qb,), np.int32)
        lens_p[:n] = lens
        ids_d = torch.from_numpy(ids).to(self.device)
        lens_d = torch.from_numpy(lens_p).to(self.device)
        mask = torch.arange(L, device=self.device)[None, :] < lens_d[:, None]
        with torch.no_grad():
            if use_fused_encoder(enc.cfg, L):
                emb = encoder_forward(enc.params, enc.cfg, ids_d, mask, lens=lens_d)
            else:
                emb = enc.module(ids_d, mask)
        emb = emb[:n].float().contiguous()  # unit rows: |emb| = 1

        def dispatch(todo, fetch):
            rows = emb if len(todo) == n else emb[torch.as_tensor(todo, device=self.device)]
            return self._device_topk(rows.contiguous(), min(fetch, self.capacity))

        return self._assemble(n, k, filter_fns, dispatch)

    def search_one(self, query, k: int, filter_fn: Callable | None = None):
        return self.search_batch(np.asarray(query)[None, :], k, [filter_fn])[0]


def _apply_filter(flt: Callable, metadata) -> bool:
    try:
        return bool(flt(metadata))
    except Exception:
        return False
