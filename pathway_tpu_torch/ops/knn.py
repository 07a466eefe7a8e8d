"""Device-resident brute-force KNN index, single device.

Port of ``pathway_tpu/ops/knn.py::DeviceKnnIndex`` (the part without a
mesh). A capacity-doubling ``[capacity, dim]`` float32 slab, a validity
mask and a score bias live on the device; a host mirror keeps keys,
metadata and (lazily) the rows. add/remove stage on the host and sync
before the next search; ``add_batch_device`` scatters embeddings that
never visit the host. Updates run as in-place tensor ops (the reference
donates and replaces its arrays; here the slab is mutated where it lies).

Search at fetch <= 64 on a CUDA slab runs the fused top-k kernel
(``ops/knn_topk.py``, kernel B2); wider fetches and CPU slabs use the
plain score matrix + :func:`_topk_lower_index`, which orders exact ties by
ascending slot as the reference's ``lax.top_k`` does.
``cos`` rows are normalised on add and queries on search; ``l2`` scores
are ``-|q - x|^2``; dead slots never surface.

Left for later slices: the mesh, freshness, index metrics, the HBM
ledger, tracing, the flight recorder, chip-time accounting and the
elastic reshard export/import.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from .knn_topk import NEG as _PNEG
from .knn_topk import KERNEL_MAX_K, knn_topk

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


def _pallas_topk(metric: str, matrix, valid, queries, k: int, bias=None):
    if bias is None:
        bias = _pallas_bias(metric, matrix, valid)
    factor = 2.0 if metric == "l2" else 1.0
    vals, idx = knn_topk(queries.contiguous(), matrix, k=k, bias=bias, factor=factor)
    if metric == "l2":
        qq = (queries * queries).sum(dim=1, keepdim=True)
        vals = torch.where(vals > _PNEG / 2, vals - qq, vals)
    return vals, idx


def _k_bucket(k: int) -> int:
    b = 8
    while b < k:
        b *= 2
    return b


class DeviceKnnIndex:
    """Growable device slab + host-side key/metadata mirror."""

    def __init__(
        self,
        dim: int,
        metric: str = "cos",  # "cos" | "l2" | "ip"
        reserved_space: int = 1024,
        name: str | None = None,
        device=None,
    ):
        if metric not in ("cos", "l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.name = name if name is not None else f"knn{next(_NAME_SEQ)}"
        self.capacity = max(64, int(reserved_space))
        self._host = np.zeros((self.capacity, dim), np.float32)
        self._valid_host = np.zeros((self.capacity,), bool)
        self._keys: list[Any] = [None] * self.capacity
        self._slot_of: dict[Any, int] = {}
        self._meta: dict[Any, Any] = {}
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))  # low slots first
        self._full = True  # device needs a full host upload
        self._host_stale = False  # device rows newer than host mirror
        self._pending: dict[int, np.ndarray | None] = {}  # slot -> vec | tombstone
        self._dev_matrix: torch.Tensor | None = None
        self._dev_valid: torch.Tensor | None = None
        self._dev_bias: torch.Tensor | None = None
        self._encoder = None
        self.generation = 0
        self._fenced = False

    def __len__(self) -> int:
        return len(self._slot_of)

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
        while len(self._free) < len(keys):
            self._grow()
        return [self._free.pop() for _ in keys]

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
        """Bulk insert of embeddings already on the index's device (e.g.
        ``SentenceEncoder.encode_device`` output): one scatter, the
        vectors never visit the host. ``dev_vectors`` may have more rows
        than ``keys``; the extra rows drop."""
        n = len(keys)
        if n == 0:
            return
        self._check_fence()
        if dev_vectors.device != self.device:
            raise ValueError(f"dev_vectors on {dev_vectors.device}, index on {self.device}")
        if self._full or self._dev_matrix is None:
            if not self._slot_of and not self._pending:
                # cold start on an empty index: make the slab on the device
                self._dev_matrix, self._dev_valid, self._dev_bias = self._empty(self.capacity)
                self._full = False
                self._pending.clear()
            else:
                self._upload_full()
        for key in keys:
            if key in self._slot_of:
                self.remove(key)
        alloc = self._alloc_slots(keys)
        self._flush_pending()
        self._scatter_dev(alloc, dev_vectors[:n])
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
        self._free.append(slot)
        if not self._full:
            self._pending[slot] = None

    # --- device slab ---

    def _empty(self, cap: int):
        return (
            torch.zeros((cap, self.dim), dtype=torch.float32, device=self.device),
            torch.zeros((cap,), dtype=torch.bool, device=self.device),
            torch.full((cap,), _PNEG, dtype=torch.float32, device=self.device),
        )

    def _grow(self) -> None:
        old = self.capacity
        self.capacity *= 2
        self._host = np.concatenate([self._host, np.zeros((old, self.dim), np.float32)])
        self._valid_host = np.concatenate([self._valid_host, np.zeros((old,), bool)])
        self._keys.extend([None] * old)
        self._free.extend(range(self.capacity - 1, old - 1, -1))
        if self._dev_matrix is not None and not self._full:
            # double the resident slab on the device; pending slot updates
            # stay valid (old slots keep their positions)
            m, v, b = self._empty(self.capacity)
            m[:old] = self._dev_matrix
            v[:old] = self._dev_valid
            b[:old] = self._dev_bias
            self._dev_matrix, self._dev_valid, self._dev_bias = m, v, b

    def _refresh_host(self) -> None:
        """Pull device-resident rows into the host mirror, overlaying
        host-staged pending updates (newer than the device copy)."""
        if not self._host_stale or self._dev_matrix is None:
            return
        fetched = self._dev_matrix.cpu().numpy()[: len(self._host)]
        self._host[: len(fetched)] = fetched
        for slot, vec in self._pending.items():
            if vec is not None:
                self._host[slot] = vec
        self._host_stale = False

    def _upload_full(self) -> None:
        self._refresh_host()
        # copies, also on the CPU: the slab is mutated in place and must not
        # alias the host mirror
        self._dev_matrix = torch.from_numpy(self._host).to(self.device, copy=True)
        self._dev_valid = torch.from_numpy(self._valid_host).to(self.device, copy=True)
        self._dev_bias = _pallas_bias(self.metric, self._dev_matrix, self._dev_valid)
        self._full = False
        self._pending.clear()

    def _sync(self) -> None:
        if self._full or self._dev_matrix is None:
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

    def _scatter(self, slots: np.ndarray, rows: np.ndarray, flags: np.ndarray) -> None:
        """Write staged rows (flags True) and tombstones (flags False) into
        the slab, its validity and its bias, in place."""
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        rows_d = torch.from_numpy(rows).to(self.device)
        live = torch.from_numpy(flags).to(self.device)
        self._dev_matrix[sl] = rows_d
        self._dev_valid[sl] = live
        b = torch.where(live, 0.0, _PNEG).to(torch.float32)
        if self.metric == "l2":
            b = torch.where(live, b - (rows_d * rows_d).sum(dim=1), b)
        self._dev_bias[sl] = b

    def _scatter_dev(self, slots: list[int], vecs: torch.Tensor) -> None:
        """Write device-resident rows into the slab in place (normalised
        for cos, their -|x|^2 bias for l2)."""
        vecs = vecs.to(torch.float32)
        if self.metric == "cos":
            norms = torch.sqrt((vecs * vecs).sum(dim=1, keepdim=True))
            vecs = vecs / torch.clamp(norms, min=1e-12)
        sl = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=self.device)
        self._dev_matrix[sl] = vecs
        self._dev_valid[sl] = True
        self._dev_bias[sl] = -(vecs * vecs).sum(dim=1) if self.metric == "l2" else 0.0

    def _scatter_tomb(self, slots: np.ndarray) -> None:
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self._dev_valid[sl] = False
        self._dev_bias[sl] = _PNEG

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
        if _pallas_eligible(self.metric, fetch, self.device):
            return _pallas_topk(
                self.metric, self._dev_matrix, self._dev_valid, q, fetch, bias=self._dev_bias
            )
        return _topk_fn(self.metric)(self._dev_matrix, self._dev_valid, q, fetch)

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
