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
only. ``mesh=None`` is the single-device index.

The elastic reshard protocol (``spawn_like``, ``reshard_export_chunks``,
``reshard_import_chunk``, ``reshard_finish``; ``elastic/controller.py``
drives it) moves the live rows to an empty index on another mesh in
bounded chunks through the host. The export reads each chunk's rows from
the slabs when the host mirror is stale (rows added on the device), so a
reshard copies every row off the card once and never the whole slab per
chunk; the import lands the rows as they are (cos rows are not normalised
again), so the new generation's rows equal the old ones byte for byte.
``fence`` freezes a dead generation: its writes raise
:class:`StaleGeneration`, its reads still serve.

The observability planes hook in at the reference's sites: every add and
remove publishes the index's per-shard counts to ``INDEX_METRICS``, its
device bytes to the HBM ledger (``index.hot``) and the touched shards to
the freshness plane; every search runs under an ``index_search`` span,
books its top-k under the chip ledger's ``index.search`` (on a mesh the
cross-shard merge under ``index.merge``, with ``index_local_topk`` /
``index_merge`` spans and the merge histogram), records an
``index.search`` flight-recorder event and the answer's staleness bound.
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from ..device import as_current, resolve_device
from ..freshness.plane import FRESHNESS
from ..internals import flight_recorder
from ..internals.chip_ledger import CHIP_LEDGER
from ..internals.profiler import wrap_jit
from ..tracing import current_trace, record_span, tracing_enabled
from ..tracing import span as _trace_span
from .index_metrics import INDEX_METRICS
from .knn_topk import NEG as _PNEG
from .knn_topk import KERNEL_MAX_K, knn_topk, merge_shard_candidates, shard_candidates

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


def _shards_of_keys(keys, n_shards: int) -> np.ndarray:
    """``_shard_of_key`` of every key in bulk: integer keys (row pointers
    included) take the key rule without a Python call each."""
    if n_shards <= 1:
        return np.zeros(len(keys), np.int64)
    if all(isinstance(k, (int, np.integer)) and not isinstance(k, bool) for k in keys):
        from ..engine.value import SHARD_MASK

        return np.fromiter((int(k) & SHARD_MASK for k in keys), np.int64, len(keys)) % n_shards
    return np.fromiter((_shard_of_key(k, n_shards) for k in keys), np.int64, len(keys))


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


def _dispatch_topk(metric: str, matrix, valid, queries, k: int, bias=None):
    """One device's top-k as the index dispatches it: the fused kernel (B2)
    on a CUDA slab at fetch <= 64, else the plain score matrix + top-k."""
    if _pallas_eligible(metric, k, matrix.device):
        return _pallas_topk(metric, matrix, valid, queries, k, bias=bias)
    return _topk_fn(metric)(matrix, valid, queries, k)


def _k_bucket(k: int) -> int:
    b = 8
    while b < k:
        b *= 2
    return b


def k_bucket_ladder(k_max: int) -> tuple[int, ...]:
    """Every fetch width the pow2 k-bucketing can produce up to
    ``k_max`` — the dispatch-geometry ladder of the top-k search. A
    dynamic per-row ``number_of_matches`` walks this ladder instead of
    dispatching per distinct k; the deep verifier (PWL018) counts it."""
    out = []
    b = 8
    while b < max(8, int(k_max)):
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


def deep_trace_spec(spec: dict) -> dict:
    """The search callable a device-backed index spec's node dispatches,
    for the deep verifier's op trace (analysis.deep, PWL017), with tiny
    arguments on the ``meta`` device: the traced ops do not depend on the
    capacity, and nothing is computed or allocated. On ``meta`` (or CPU)
    tensors the callable takes the plain top-k; on CUDA tensors at fetch
    <= 64 it launches B2."""
    dim = max(1, int(spec.get("dimensions") or 1))
    metric = spec.get("metric", "cos")
    if metric not in ("cos", "ip", "l2"):
        metric = "cos"
    cap, nq, k = 64, 8, 8
    args = (
        torch.empty((cap, dim), dtype=torch.float32, device="meta"),
        torch.empty((cap,), dtype=torch.bool, device="meta"),
        torch.empty((nq, dim), dtype=torch.float32, device="meta"),
    )
    return {
        "name": f"knn.search[{metric},d={dim}]",
        "fn": lambda matrix, valid, queries: _dispatch_topk(metric, matrix, valid, queries, k),
        "args": args,
    }


def deep_compile_profile(spec: dict, mesh_axes: dict | None = None) -> dict:
    """Predicted distinct dispatch geometries of one device-backed index
    (analysis.deep, PWL018), with the reference's arithmetic: scatter,
    grow and empty-slab once per capacity, the top-k search once per
    (capacity, fetch bucket). A literal ``query_k`` pins one fetch bucket;
    a dynamic (per-row) k walks the pow2 ladder up to capacity. Sharding
    divides the per-shard capacity but does not multiply geometries (every
    shard runs the same one). The kernels themselves are built once, by
    ``ops/_build.py``, whatever the geometry."""
    cap = max(1, int(spec.get("reserved_space") or 1))
    ndata = int((mesh_axes or {}).get("data", 1) or 1)
    per_shard = max(1, -(-cap // ndata))
    if spec.get("query_k_dynamic"):
        k_ladder = k_bucket_ladder(per_shard)
    else:
        k_ladder = (_k_bucket(int(spec.get("query_k") or 3)),)
    # scatter + grow + empty-slab families once each per capacity; the
    # search family once per fetch bucket
    base = 3
    compiles = base + len(k_ladder)
    if spec.get("tiers"):
        # hot + cold tier each own a search family (cold adds the
        # cluster-probe gather); scatter stays on the hot tier
        compiles += 1 + len(k_ladder)
    return {
        "compiles": compiles,
        "detail": {
            "per_shard_capacity": per_shard,
            "k_buckets": list(k_ladder),
            "kernel_families": base,
            "tiered": bool(spec.get("tiers")),
        },
        "unbucketed": [],
    }


def _take(t: torch.Tensor, sel) -> torch.Tensor:
    return t if isinstance(sel, slice) else t.index_select(0, torch.as_tensor(sel, device=t.device))


def _ledger_drop(name: str) -> None:
    from ..internals.ledger import LEDGER

    LEDGER.drop("index.hot", name)


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
        # an index that is dropped (a crashed run's, say) gives its HBM
        # ledger booking back with its slab (a fenced generation hands it to
        # the next one, which books under the same name)
        self._ledger_finalizer = weakref.finalize(self, _ledger_drop, self.name)
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
        # elastic reshard plumbing: the cluster generation that owns this
        # index, whether its writes are fenced (a post-cutover zombie
        # guard), and whether adds take rows as they are (migration chunks
        # carry rows normalised at their first add)
        self.generation = 0
        self._fenced = False
        self._import_raw = False
        self._host_pulls = 0  # whole-slab copies into the host mirror
        self._last_merge_s: float | None = None

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
            from ..elastic.metrics import ELASTIC_METRICS

            ELASTIC_METRICS.record_fenced_write()
            flight_recorder.record("elastic.fenced_write", index=self.name, generation=self.generation)
            raise StaleGeneration(self.name, self.generation)

    def fence(self, generation: int | None = None) -> None:
        """Freeze this index as a dead generation: later writes raise
        :class:`StaleGeneration`; reads still work (the cutover's dual-answer
        window reads the old generation). Its HBM ledger booking now belongs
        to the generation that took its name, so dropping this index no
        longer drops it."""
        self._fenced = True
        self._ledger_finalizer.detach()
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
        shards = _shards_of_keys(keys, self.n_shards)
        need = np.bincount(shards, minlength=self.n_shards)
        while any(len(self._free_shard[s]) < need[s] for s in range(self.n_shards)):
            self._grow()
        free = self._free_shard
        return [free[s].pop() for s in shards.tolist()]

    def _live_docs_shard(self) -> list[int]:
        """Live rows per shard: a shard's slots less its free ones (every
        add and remove publishes it, so it must not scan the mask)."""
        return [self.shard_capacity - len(free) for free in self._free_shard]

    def _publish_metrics(self) -> None:
        INDEX_METRICS.update_index(self.name, self._live_docs_shard(), self.shard_capacity)
        self._ledger_update()

    def _ledger_update(self) -> None:
        """Report this index's live device allocation to the HBM ledger,
        exact from the slabs' bytes; ``used`` is the occupied-slot fraction,
        so the ledger's fragmentation gauge reads reserved-but-empty rows."""
        from ..internals.ledger import LEDGER

        if self._slab is None:
            LEDGER.drop("index.hot", self.name)
            return
        alloc = sum(t.element_size() * t.numel() for part in self._slab for t in part)
        used = int(alloc * len(self._slot_of) / max(1, self.capacity))
        LEDGER.update("index.hot", self.name, alloc, used_bytes=used)

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
        if self.metric == "cos" and not self._import_raw:
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
        FRESHNESS.note_index_add(self, {s // self.shard_capacity for s in slots})
        self._publish_metrics()

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
        FRESHNESS.note_index_add(self, {s // self.shard_capacity for s in alloc})
        self._publish_metrics()

    def remove(self, key) -> None:
        self._check_fence()
        slot = self._slot_of.pop(key, None)
        if slot is None:
            return
        self._valid_host[slot] = False
        self._keys[slot] = None
        self._meta.pop(key, None)
        shard = slot // self.shard_capacity
        self._free_shard[shard].append(slot)
        if not self._full:
            self._pending[slot] = None
        FRESHNESS.note_index_add(self, (shard,))
        self._publish_metrics()

    # --- elastic reshard protocol (elastic/controller.py drives) ---

    def spawn_like(self, mesh, reserved_space: int | None = None):
        """An EMPTY index with this one's schema on a target mesh (``None``:
        this index's first device), the destination of a live reshard. It
        starts small unless told otherwise: imports grow it shard by shard,
        as the reference's target grows."""
        return DeviceKnnIndex(
            self.dim, metric=self.metric, reserved_space=int(reserved_space) if reserved_space else 64,
            name=self.name, device=self.device, mesh=mesh,
        )

    def reshard_export_chunks(self, chunk_rows: int):
        """Yield this index's live rows in chunks of at most ``chunk_rows``,
        in slot order. The key list is snapshotted at the first chunk; rows
        removed between chunks are skipped (the delta replay carries the
        removal), rows re-added keep their snapshot value here and are
        overwritten by the replay, so the target converges to the source's
        final state."""
        # the snapshot is taken under the caller's lock: a sort of the slots
        # in numpy, not of a million tuples in Python
        owned = list(self._slot_of)
        order = np.argsort(np.fromiter(self._slot_of.values(), np.int64, len(owned)), kind="stable")
        keys = [owned[i] for i in order.tolist()]
        step = max(1, int(chunk_rows))
        for i in range(0, len(keys), step):
            batch = [k for k in keys[i : i + step] if k in self._slot_of]
            if not batch:
                continue
            slots = np.fromiter((self._slot_of[k] for k in batch), np.int64, len(batch))
            yield {"kind": "rows", "keys": batch, "vecs": self._rows_at(slots),
                   "metas": [self._meta.get(k) for k in batch]}

    def _rows_at(self, slots: np.ndarray) -> np.ndarray:
        """The rows at ``slots`` as the index holds them: the host mirror
        when it is current, else the slabs' rows (copied chunk by chunk,
        never the whole slab) overlaid with host-staged updates."""
        if not self._host_stale or self._slab is None:
            return self._host[slots]
        out = np.empty((len(slots), self.dim), np.float32)
        for s, sel, local in self._by_shard(slots):
            matrix = self._slab[s][0]
            out[sel] = matrix.index_select(0, torch.as_tensor(local, device=matrix.device)).cpu().numpy()
        for i, slot in enumerate(slots.tolist()):
            vec = self._pending.get(slot)
            if vec is not None:
                out[i] = vec
        return out

    def reshard_import_chunk(self, chunk: dict) -> None:
        """Land one exported chunk. Its rows were normalised at their first
        add; the import must not normalise them again, or the transplant
        stops being bit-exact."""
        if chunk.get("kind") != "rows":
            raise ValueError(f"flat index cannot import chunk kind {chunk.get('kind')!r}")
        self._import_raw = True
        try:
            self.add_batch_arrays(chunk["keys"], chunk["vecs"], chunk["metas"])
        finally:
            self._import_raw = False

    def reshard_finish(self) -> None:
        """Every chunk landed: commit the staged rows to the slabs (the
        barrier before the cutover waits for them) and book them."""
        self._sync()
        self._publish_metrics()

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

        def remap(g: np.ndarray) -> list[int]:
            return ((g // old) * new + g % old).tolist()

        # every map rebuilt in bulk: a target index that grows from 64 rows to
        # millions during a reshard remaps at each doubling
        keys: list[Any] = []
        for s in range(S):
            keys += self._keys[s * old : (s + 1) * old]
            keys += [None] * old
        self._keys = keys
        self._slot_of = dict(zip(self._slot_of, remap(np.fromiter(self._slot_of.values(), np.int64,
                                                                  len(self._slot_of)))))
        self._pending = dict(zip(remap(np.fromiter(self._pending, np.int64, len(self._pending))),
                                 self._pending.values()))
        self._free_shard = [remap(np.asarray(free, np.int64)) for free in self._free_shard]
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
        self._host_pulls += 1

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

    def _device_topk(self, q: torch.Tensor, fetch: int, mask=None):
        """Top-``fetch`` (scores, slots) of ``q`` over the slab. ``mask``
        replaces the slab's validity and bias for this call only: a
        ``(valid, bias)`` pair shaped like the slab's own, or on a mesh one
        such pair a shard."""
        if self.n_shards == 1:
            # one dispatch: the chip ledger (when on) books it, waiting for
            # the card to read its timing events
            matrix, valid, bias = self._slab[0]
            if mask is not None:
                valid, bias = mask
            with CHIP_LEDGER.timed("index.search", device=self.device):
                return _dispatch_topk(self.metric, matrix, valid, q, fetch, bias=bias)
        return self._sharded_topk(q, fetch, mask)

    # the run profiler's build / execute split of each top-k dispatch (wrapped
    # on the class: a wrapper on the instance would hold the index in a
    # reference cycle, which only a full collection frees)
    _device_topk = wrap_jit("knn.topk", _device_topk)

    def _sharded_topk(self, q: torch.Tensor, fetch: int, mask=None):
        """The two-phase search over the shards (under ``mask``, one
        ``(valid, bias)`` pair a shard, when given): each shard's top
        ``min(fetch, rows)`` re-based to global slots, then one top-k over
        the shard-major ``[q, n_shards * k_local]`` candidates (ties to the
        lower global slot); for L2, ``-|q|^2`` after the top-k, on every
        entry, as the reference's ``merge_topk`` does. At fetch <= 64 on the
        cards the phases are ``knn_topk_sharded``'s kernels (B2 per shard,
        then ``knn_topk_sharded_merge``), else plain PyTorch.

        The phases are timed apart (the merge into
        ``pathway_index_merge_seconds``) when the index metrics, a bound
        request trace or the chip ledger want them, as the reference's
        sharded search is: the first phase is waited for before the merge
        starts."""
        traced = tracing_enabled() and current_trace() is not None
        timing = INDEX_METRICS.active() or traced or CHIP_LEDGER.on()
        kernel = _pallas_eligible(self.metric, fetch, self.device)
        rows = self.shard_capacity
        k_local = fetch if kernel else min(fetch, rows)
        l0 = time.monotonic()
        with CHIP_LEDGER.timed("index.search", device=self.shard_devices):
            if kernel:
                biases = [p[2] for p in self._slab] if mask is None else [m[1] for m in mask]
                cand = shard_candidates(
                    q.contiguous(), [p[0] for p in self._slab], biases, k=fetch,
                    factor=2.0 if self.metric == "l2" else 1.0,
                )
            else:
                cand = self._local_topk(q, k_local, mask)
            if timing:
                _sync_cards(self.shard_devices)
        m0 = time.monotonic()
        if timing and traced:
            record_span("index_local_topk", start_mono=l0, end_mono=m0, shards=self.n_shards, k_local=k_local)
        k_final = min(fetch, self.n_shards * k_local)
        with CHIP_LEDGER.timed("index.merge", device=self.device):
            if kernel:
                v, gi = merge_shard_candidates(*cand, fetch)
                v = _l2_shift(self.metric, v, q)
            else:
                v, gi = self._merge_local(q, cand, k_final)
            if timing:
                _sync_cards([self.device])
        if timing:
            self._last_merge_s = time.monotonic() - m0
            INDEX_METRICS.observe_merge(self._last_merge_s)
            if traced:
                record_span("index_merge", start_mono=m0, end_mono=time.monotonic(), shards=self.n_shards,
                            k=k_final)
        return v, gi

    def _local_topk(self, q: torch.Tensor, k_local: int, mask=None):
        """Plain first phase: each shard's top ``k_local``, re-based to
        global slots."""
        rows = self.shard_capacity
        l2 = self.metric == "l2"
        # queries out to every device first, results back last: a copy between
        # cards between two shards' work would run the shards one by one
        on_device = {dev: q.to(dev) for dev in set(self.shard_devices)}
        local = []
        for s, (matrix, valid, _) in enumerate(self._slab):
            if mask is not None:
                valid = mask[s][0]
            with as_current(matrix.device):
                scores = on_device[matrix.device] @ matrix.T
                if l2:
                    scores = 2.0 * scores - (matrix * matrix).sum(dim=1)[None, :]
                scores = torch.where(valid[None, :], scores, _NEG)
                v, i = _topk_lower_index(scores, k_local)
            local.append((v, i + s * rows))
        return local

    def _merge_local(self, q: torch.Tensor, local, k_final: int):
        """Plain second phase: one top-k over the shard-major candidates."""
        vals = torch.cat([v.to(self.device) for v, _ in local], dim=1)
        v, pos = _topk_lower_index(vals, k_final)
        gi = torch.cat([i.to(self.device) for _, i in local], dim=1).gather(1, pos)
        if self.metric == "l2":
            v = v - (q * q).sum(dim=1, keepdim=True)
        return v, gi

    def search_batch(
        self,
        queries,
        k: int,
        filter_fns: list[Callable | None] | None = None,
        *,
        mask: Callable | None = None,
        live: int | None = None,
    ) -> list[list[tuple[Any, float]]]:
        """queries [q, dim] (host array or device tensor) -> per query a
        list of (key, score), best first (score: cosine similarity, inner
        product, or negative squared L2). ``filter_fns[i]`` filters
        candidate metadata; over-fetch + host filter with exponential refill.

        ``mask``, called after the index syncs, returns a ``(valid, bias)``
        pair (on a mesh, one a shard) that replaces the slab's own for this
        search only, and ``live`` counts the rows it keeps (the tenant
        slab's per-tenant view); masked rows score as empty rows do."""
        if len(self._slot_of) == 0 or len(queries) == 0:
            return [[] for _ in range(len(queries))]
        q = self._queries(queries)
        self._sync()
        override = mask() if mask is not None else None

        def dispatch(todo, fetch):
            rows = q if len(todo) == q.shape[0] else q[torch.as_tensor(todo, device=self.device)]
            return self._device_topk(rows, fetch, override)

        with _trace_span("index_search", index=self.name, queries=q.shape[0], k=k, shards=self.n_shards):
            out = self._assemble(q.shape[0], k, filter_fns, dispatch, live)
        self._record_search(q.shape[0], k)
        return out

    def _record_search(self, n_queries: int, k: int) -> None:
        merge_s = self._last_merge_s
        # every answer served off this index carries the staleness bound
        # now - min(visible watermark over its shards)
        FRESHNESS.observe_answer(self)
        INDEX_METRICS.record_search(self.name, n_queries)
        flight_recorder.record(
            "index.search", index=self.name, queries=n_queries, k=k, shards=self.n_shards,
            merge_ms=round(merge_s * 1e3, 4) if merge_s is not None else 0.0,
        )
        self._last_merge_s = None

    def _assemble(self, q_n, k, filter_fns, dispatch, live=None):
        """Run ``dispatch(todo, fetch)`` for the outstanding queries, map
        slots to keys, apply metadata filters, and refetch exponentially
        deeper when filters starve a query (of at most ``live`` rows, by
        default every row of the index)."""
        live = len(self._slot_of) if live is None else live
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
                if len(out) < min(k, live) and fetch < self.capacity:
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
        with torch.no_grad(), CHIP_LEDGER.timed("encode", device=self.device):
            if use_fused_encoder(enc.cfg, L):
                emb = encoder_forward(enc.params, enc.cfg, ids_d, mask, lens=lens_d)
            else:
                emb = enc.module(ids_d, mask)
        emb = emb[:n].float().contiguous()  # unit rows: |emb| = 1

        def dispatch(todo, fetch):
            rows = emb if len(todo) == n else emb[torch.as_tensor(todo, device=self.device)]
            return self._device_topk(rows.contiguous(), min(fetch, self.capacity))

        with _trace_span("index_search", index=self.name, queries=n, k=k, shards=self.n_shards):
            out = self._assemble(n, k, filter_fns, dispatch)
        self._record_search(n, k)
        return out

    def search_one(self, query, k: int, filter_fn: Callable | None = None):
        return self.search_batch(np.asarray(query)[None, :], k, [filter_fn])[0]


def _sync_cards(devices) -> None:
    """Wait for the work queued on each CUDA device (nothing on the CPU)."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _apply_filter(flt: Callable, metadata) -> bool:
    try:
        return bool(flt(metadata))
    except Exception:
        return False
