"""Two-tier online KNN index: a device-resident hot tier over a
host-memory cold tier, for corpora beyond one card's memory budget.

The port's copy of the reference's ``ops/tiered_knn.py``. Every vector
lives in a host-side cold store (int8 scale-per-vector by default, f32
optional); the hot tier is a :class:`~.knn.DeviceKnnIndex` (kernel B2 on a
card) acting as a cache over the hottest clusters. Cluster assignment
happens online at ingest (mini-batch k-means over the first
``n_clusters`` seeds, on the host); promotion and demotion are driven by
per-cluster hit counts decayed each rebalance sweep.

Query path: the hot top-k is dispatched first (the hot path never waits
on tiering work), then the centroid probe runs on the host over the small
``[n_clusters, dim]`` table. The probed clusters' cold rows (int8 codes
and scales, or f32 rows) are gathered on the host, staged through a
:class:`~..engine.device_ring.DeviceRing` slot (pinned buffer, copy on a
side stream), dequantised and rescored on the card with one
``torch.matmul`` on the same score scale as the flat index, and each
query's best cold candidates (``_topk_lower_index``: ties to the earlier
candidate) are merged with the resolved hot candidates on the host. Keys
present in both tiers (the crash window mid-promotion) dedup at merge with
the hot copy winning, so a killed promotion can never surface a vector
twice or lose one: the cold store is authoritative until the hot insert
lands.

When every document is hot-resident the search delegates wholesale to
``DeviceKnnIndex.search_batch``, so it equals the flat index exactly.

Snapshots: ``tier_state()`` captures the centroid table, per-key cluster
assignment, hit counters, and the exact hot-resident key set;
``restore_tier_state`` + ``finish_tier_restore`` replay them around a
re-add (the engine's index node does, restoring from an operator
snapshot).

On a mesh (``mesh=``) the hot tier is a sharded ``DeviceKnnIndex``: keys
route to their shard by the engine's key rule, each shard's free slots
gate its hot inserts and promotions, and the cold counts are kept per
shard. The reference stages the cold rows replicated over the mesh, so
every device computes the same scores; the port stages them onto the
first shard's device and scores them there, once, which gives the same
answers. The elastic reshard (``spawn_like``, ``reshard_*``) streams one
tier-state chunk, then every document's cold bytes as stored, then the
hot rows as the hot slab holds them, so a resharded index keeps its hot
and cold membership and answers byte for byte as before.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..internals.ledger import (  # noqa: F401  (re-exported; the shared
    _DEFAULT_HBM_BYTES,  # footprint model lives in internals/ledger.py)
    cold_row_bytes,
    default_hbm_bytes,
    hot_row_bytes,
    parse_bytes,
)
from .knn import _NEG, DeviceKnnIndex, _apply_filter, _shard_of_key, _topk_lower_index

_COLD_DTYPES = ("int8", "f32")
_HOT_DTYPES = ("f32", "int8")


@dataclass(frozen=True)
class TierConfig:
    """Knobs for the two-tier index. ``hot_rows == 0`` derives the hot
    tier size from ``hbm_bytes`` (default: ``PATHWAY_HBM_BYTES``, else the
    card's memory as the HBM ledger reads it)."""

    hot_rows: int = 0
    hbm_bytes: int | None = None
    n_clusters: int = 64
    n_probe: int = 8
    cold_dtype: str = "int8"
    hot_dtype: str = "f32"
    promote_every: int = 64
    decay: float = 0.5

    def __post_init__(self):
        if self.cold_dtype not in _COLD_DTYPES:
            raise ValueError(
                f"index tiers: cold dtype {self.cold_dtype!r}: expected one of {_COLD_DTYPES}"
            )
        if self.hot_dtype not in _HOT_DTYPES:
            raise ValueError(
                f"index tiers: hot dtype {self.hot_dtype!r}: expected one of {_HOT_DTYPES}"
            )
        if self.n_clusters < 1 or self.n_probe < 1:
            raise ValueError("index tiers: n_clusters and n_probe must be >= 1")
        if self.hot_rows < 0 or self.promote_every < 1:
            raise ValueError(
                "index tiers: hot_rows must be >= 0 and promote_every >= 1"
            )
        if self.hbm_bytes is not None and self.hbm_bytes <= 0:
            raise ValueError("index tiers: hbm_bytes must be positive")
        if not (0.0 < self.decay <= 1.0):
            raise ValueError("index tiers: decay must be in (0, 1]")

    def resolve_hot_rows(self, dim: int, n_shards: int = 1) -> int:
        """Total hot-tier rows across the mesh: explicit ``hot_rows``,
        else the per-device HBM budget divided by the slab row cost."""
        if self.hot_rows > 0:
            return self.hot_rows
        budget = self.hbm_bytes if self.hbm_bytes is not None else default_hbm_bytes()
        per_dev = max(1, budget // hot_row_bytes(dim, self.hot_dtype))
        return max(64, int(per_dev) * max(1, n_shards))

    def as_dict(self) -> dict:
        return {
            "hot_rows": self.hot_rows,
            "hbm_bytes": self.hbm_bytes,
            "n_clusters": self.n_clusters,
            "n_probe": self.n_probe,
            "cold_dtype": self.cold_dtype,
            "hot_dtype": self.hot_dtype,
            "promote_every": self.promote_every,
            "decay": self.decay,
        }


def deep_tier_profile(cfg) -> dict | None:
    """Static tier-plane metadata for the deep verifier (analysis.deep,
    PWL018), the reference's: the dispatch-relevant knobs of the two-tier
    index. The cold tier adds two families on top of the hot-tier search —
    the cluster-probe gather and the cold rescore — each keyed on the
    (n_clusters, n_probe, cold_dtype) geometry, so the bucket space is one
    entry per configured geometry, not per corpus size."""
    if cfg is None:
        return None
    d = cfg if isinstance(cfg, dict) else cfg.as_dict()
    return {
        "n_clusters": int(d.get("n_clusters") or 64),
        "n_probe": int(d.get("n_probe") or 8),
        "hot_dtype": d.get("hot_dtype", "f32"),
        "cold_dtype": d.get("cold_dtype", "int8"),
        "extra_kernel_families": 2,
    }


_SPEC_KEYS = {
    "hot": "hot_rows",
    "hot_rows": "hot_rows",
    "hbm": "hbm_bytes",
    "hbm_bytes": "hbm_bytes",
    "clusters": "n_clusters",
    "n_clusters": "n_clusters",
    "probe": "n_probe",
    "n_probe": "n_probe",
    "cold": "cold_dtype",
    "cold_dtype": "cold_dtype",
    "hot_dtype": "hot_dtype",
    "promote": "promote_every",
    "promote_every": "promote_every",
    "decay": "decay",
}


def parse_tier_spec(spec: Any) -> TierConfig | None:
    """Spec parsing (mirrors parse_mesh_spec): accepts None,
    a TierConfig, an int (hot rows), a dict of knob names, or a string
    like ``"hot=4096,clusters=64,probe=8,cold=int8,hbm=4G"``. Raises
    ValueError on malformed input; ``"off"``/``""`` -> None."""
    if spec is None:
        return None
    if isinstance(spec, TierConfig):
        return spec
    if isinstance(spec, bool):
        return TierConfig() if spec else None
    if isinstance(spec, int):
        return TierConfig(hot_rows=spec)
    if isinstance(spec, dict):
        kw: dict[str, Any] = {}
        for k, v in spec.items():
            field = _SPEC_KEYS.get(str(k))
            if field is None:
                raise ValueError(f"index tiers: unknown knob {k!r}")
            kw[field] = v
        return TierConfig(**_coerce(kw))
    if isinstance(spec, str):
        s = spec.strip()
        if not s or s.lower() in ("off", "none", "0", "false"):
            return None
        if s.lower() in ("on", "true", "auto"):
            return TierConfig()
        kw = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"index tiers: bad spec part {part!r}")
            k, _, v = part.partition("=")
            field = _SPEC_KEYS.get(k.strip())
            if field is None:
                raise ValueError(f"index tiers: unknown knob {k.strip()!r}")
            kw[field] = v.strip()
        return TierConfig(**_coerce(kw))
    raise ValueError(f"index tiers: cannot parse spec of type {type(spec).__name__}")


def _coerce(kw: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for field, v in kw.items():
        if field in ("cold_dtype", "hot_dtype"):
            out[field] = str(v)
        elif field == "decay":
            out[field] = float(v)
        elif field == "hbm_bytes":
            out[field] = parse_bytes(v)
        else:
            try:
                out[field] = int(v)
            except (TypeError, ValueError):
                raise ValueError(f"index tiers: bad value {v!r} for {field}") from None
    return out


# ---------------------------------------------------------------------------
# run-scoped active config (mirrors parallel/mesh.py's active mesh)

_tier_lock = threading.Lock()
_active_tiers: TierConfig | None = None
_env_tier_cache: tuple[str, TierConfig | None] | None = None


def active_tiers() -> TierConfig | None:
    """The tier config indexes built inside pw.run(index_tiers=) should
    pick up: the run-scoped config first, then PATHWAY_INDEX_TIERS."""
    global _env_tier_cache
    with _tier_lock:
        if _active_tiers is not None:
            return _active_tiers
    raw = os.environ.get("PATHWAY_INDEX_TIERS", "")
    if not raw:
        return None
    with _tier_lock:
        if _env_tier_cache is not None and _env_tier_cache[0] == raw:
            return _env_tier_cache[1]
    try:
        cfg = parse_tier_spec(raw)
    except ValueError:
        cfg = None
    with _tier_lock:
        _env_tier_cache = (raw, cfg)
    return cfg


def set_active_tiers(cfg: TierConfig | None) -> None:
    global _active_tiers
    with _tier_lock:
        _active_tiers = cfg


@contextmanager
def use_tiers(spec: Any):
    prev = _active_tiers
    set_active_tiers(parse_tier_spec(spec))
    try:
        yield
    finally:
        set_active_tiers(prev)


# ---------------------------------------------------------------------------
# int8 scale-per-vector quantization

def quantize_int8(vecs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 [n, dim] -> (int8 [n, dim], f32 [n] scale) with
    scale = max|v| per vector; v̂ = q * scale / 127."""
    vecs = np.asarray(vecs, np.float32)
    scale = np.max(np.abs(vecs), axis=1)
    safe = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(vecs * (127.0 / safe[:, None])), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * (np.asarray(scale, np.float32)[:, None] / 127.0)


class ColdStore:
    """Host-memory slab of quantized vectors with LIFO slot reuse —
    the same free-list discipline as the device slabs."""

    def __init__(self, dim: int, dtype: str = "int8", capacity: int = 1024):
        self.dim = dim
        self.dtype = dtype
        self.capacity = max(64, int(capacity))
        if dtype == "int8":
            self._q = np.zeros((self.capacity, dim), np.int8)
            self._scale = np.zeros((self.capacity,), np.float32)
        else:
            self._f = np.zeros((self.capacity, dim), np.float32)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.rows = 0

    @property
    def bytes_per_row(self) -> int:
        return cold_row_bytes(self.dim, self.dtype)

    def _grow(self) -> None:
        old = self.capacity
        self.capacity = old * 2
        if self.dtype == "int8":
            q = np.zeros((self.capacity, self.dim), np.int8)
            q[:old] = self._q
            self._q = q
            s = np.zeros((self.capacity,), np.float32)
            s[:old] = self._scale
            self._scale = s
        else:
            f = np.zeros((self.capacity, self.dim), np.float32)
            f[:old] = self._f
            self._f = f
        self._free.extend(range(self.capacity - 1, old - 1, -1))

    def put(self, vecs: np.ndarray) -> np.ndarray:
        vecs = np.asarray(vecs, np.float32)
        n = len(vecs)
        while len(self._free) < n:
            self._grow()
        slots = np.array([self._free.pop() for _ in range(n)], np.int64)
        if self.dtype == "int8":
            q, scale = quantize_int8(vecs)
            self._q[slots] = q
            self._scale[slots] = scale
        else:
            self._f[slots] = vecs
        self.rows += n
        return slots

    def erase(self, slots) -> None:
        for s in slots:
            self._free.append(int(s))
        self.rows -= len(slots)

    def fetch(self, slots) -> np.ndarray:
        sl = np.asarray(slots, np.int64)
        if self.dtype == "int8":
            return dequantize_int8(self._q[sl], self._scale[sl])
        return self._f[sl].copy()

    def export_rows(self, slots) -> dict:
        """The stored bytes of ``slots`` for an elastic migration chunk, not
        a dequantised view: quantising a dequantised vector again is not an
        identity in general, so the codes and scales (or f32 rows) move as
        they are and cold scores stay bit-identical across a reshard."""
        sl = np.asarray(slots, np.int64)
        if self.dtype == "int8":
            return {"dtype": "int8", "q": self._q[sl].copy(), "scale": self._scale[sl].copy()}
        return {"dtype": self.dtype, "f": self._f[sl].copy()}

    def import_rows(self, payload: dict) -> np.ndarray:
        """Land an :meth:`export_rows` payload byte for byte; returns the
        slots the rows were placed in."""
        if payload.get("dtype") != self.dtype:
            raise ValueError(f"cold store dtype mismatch: {payload.get('dtype')!r} vs {self.dtype!r}")
        n = len(payload["q" if self.dtype == "int8" else "f"])
        while len(self._free) < n:
            self._grow()
        slots = np.array([self._free.pop() for _ in range(n)], np.int64)
        if self.dtype == "int8":
            self._q[slots] = payload["q"]
            self._scale[slots] = payload["scale"]
        else:
            self._f[slots] = payload["f"]
        self.rows += n
        return slots


# ---------------------------------------------------------------------------
# cold rescoring (on the card, on the flat index's score scale)


def cold_scores(metric: str, q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """``[q, m]`` scores of ``docs`` for ``q``, as the flat index scores
    them: a dot product for cos / ip; ``-|q - x|^2`` for l2."""
    s = q @ docs.T
    if metric == "l2":
        # matches _topk_l2: -||q-x||^2 = 2 q.x - ||x||^2 - ||q||^2
        s = 2.0 * s - (docs * docs).sum(dim=1)[None, :] - (q * q).sum(dim=1, keepdim=True)
    return s


class TieredKnnIndex:
    """Hot ``DeviceKnnIndex`` cache over an authoritative host
    ``ColdStore``, presenting the same add/remove/search_batch protocol
    the engine duck-types. See the module docstring for the design."""

    is_tiered = True

    def __init__(
        self,
        dim: int,
        metric: str = "cos",
        reserved_space: int = 1024,
        tiers: Any = None,
        mesh: Any = None,
        name: str | None = None,
        device=None,
    ):
        from .knn import _NAME_SEQ

        cfg = parse_tier_spec(tiers)
        if cfg is None:
            cfg = TierConfig()
        self.tiers = cfg
        self.dim = int(dim)
        self.metric = metric
        self.mesh = mesh
        self.name = name if name is not None else f"knn{next(_NAME_SEQ)}"
        n_shards = int(mesh.shape["data"]) if mesh is not None else 1
        if cfg.hot_rows > 0:
            hot_rows = cfg.hot_rows
        else:
            # budget-derived hot tier, capped by the caller's reserved
            # space: the hot slab is a device cache sized to the SMALLER
            # of what the budget allows and what the corpus expects
            hot_rows = min(max(64, int(reserved_space)), cfg.resolve_hot_rows(self.dim, n_shards))
        # the hot tier carries the logical index name: its flight events
        # and search records ARE this index's, and the tiered
        # _publish_metrics below replaces its accounting with both tiers'
        self.hot = DeviceKnnIndex(dim, metric, reserved_space=hot_rows, name=self.name, device=device, mesh=mesh)
        self.hot._publish_metrics = self._publish_metrics
        self.device = self.hot.device
        self.n_shards = self.hot.n_shards

        C = cfg.n_clusters
        self._cold = ColdStore(self.dim, cfg.cold_dtype)
        self._centroids = np.zeros((C, self.dim), np.float32)
        self._centroid_n = np.zeros((C,), np.int64)
        self._n_centroids = 0
        self._hits = np.zeros((C,), np.float64)
        self._cluster_of: dict[Any, int] = {}
        self._members: list[set] = [set() for _ in range(C)]
        self._cold_keys: list[set] = [set() for _ in range(C)]  # not hot-resident
        # per-cluster (keys, cold slots) of _cold_keys, rebuilt when dirty
        self._cold_cache: dict[int, tuple[list, np.ndarray]] = {}
        self._cold_slot: dict[Any, int] = {}
        self._meta: dict[Any, Any] = {}
        self._cold_docs_shard = [0] * self.n_shards
        self._cold_total = 0
        self._searches_since_rebalance = 0
        self._promotions = 0
        self._demotions = 0
        self._cold_ring = None
        self._encoder = None
        # snapshot-restore staging: exact assignment + hot set replay
        self._restore_assign: dict[Any, int] | None = None
        self._restore_hot: list | None = None
        self.generation = 0

    # -- sizing ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._cluster_of)

    @property
    def capacity(self) -> int:
        return self.hot.capacity

    @property
    def shard_capacity(self) -> int:
        return self.hot.shard_capacity

    def hot_docs(self) -> int:
        return len(self.hot._slot_of)

    def cold_docs(self) -> int:
        return self._cold_total

    # -- cold listing -------------------------------------------------------

    def _cold_add(self, c: int, key) -> None:
        self._cold_keys[c].add(key)
        self._cold_cache.pop(c, None)

    def _cold_discard(self, c: int, key) -> None:
        self._cold_keys[c].discard(key)
        self._cold_cache.pop(c, None)

    def _cold_listing(self, c: int) -> tuple[list, np.ndarray]:
        """Cluster ``c``'s cold keys in the set's order and their cold-store
        slots."""
        hit = self._cold_cache.get(c)
        if hit is None:
            keys = list(self._cold_keys[c])
            slots = np.fromiter((self._cold_slot[k] for k in keys), np.int64, len(keys))
            hit = self._cold_cache[c] = (keys, slots)
        return hit

    # -- metrics -----------------------------------------------------------

    def _publish_metrics(self) -> None:
        from .index_metrics import INDEX_METRICS

        hrb = hot_row_bytes(self.dim, self.tiers.hot_dtype)
        crb = self._cold.bytes_per_row
        hot_shard = self.hot._live_docs_shard()
        INDEX_METRICS.update_index(
            self.name,
            hot_shard,
            self.hot.shard_capacity,
            cold_docs_shard=list(self._cold_docs_shard),
            hot_bytes_shard=[int(d) * hrb for d in hot_shard],
            cold_bytes_shard=[int(d) * crb for d in self._cold_docs_shard],
        )
        # this method replaces the hot tier's publish hook: keep its HBM
        # ledger account (bytes + used fraction) current here instead
        self.hot._ledger_update()

    # -- cluster assignment ------------------------------------------------

    def _assign_batch(self, vecs: np.ndarray) -> np.ndarray:
        """Online mini-batch k-means: the first n_clusters vectors seed
        centroids; later batches take the nearest centroid and shift it
        toward the batch mean weighted by assignment counts."""
        n = len(vecs)
        C = self.tiers.n_clusters
        out = np.empty(n, np.int64)
        i = 0
        while self._n_centroids < C and i < n:
            c = self._n_centroids
            self._centroids[c] = vecs[i]
            self._centroid_n[c] = 1
            self._n_centroids += 1
            out[i] = c
            i += 1
        if i < n:
            rest = vecs[i:]
            cents = self._centroids[: self._n_centroids]
            if self.metric == "l2":
                s = 2.0 * (rest @ cents.T) - np.sum(cents * cents, axis=1)[None, :]
            else:
                s = rest @ cents.T
            a = np.argmax(s, axis=1)
            out[i:] = a
            for c in np.unique(a):
                mask = a == c
                m = int(mask.sum())
                nc = int(self._centroid_n[c])
                self._centroids[c] += (rest[mask].mean(axis=0) - self._centroids[c]) * (m / (nc + m))
                self._centroid_n[c] = nc + m
        return out

    def _assign_keys(self, keys: list, vecs: np.ndarray) -> np.ndarray:
        if self._restore_assign is None:
            return self._assign_batch(vecs)
        # snapshot replay: exact assignment, no centroid drift
        out = np.empty(len(keys), np.int64)
        missing: list[int] = []
        for i, key in enumerate(keys):
            c = self._restore_assign.get(key)
            if c is None:
                missing.append(i)
            else:
                out[i] = c
        if missing:
            out[missing] = self._assign_batch(vecs[missing])
        return out

    def _hot_vectors(self, vecs: np.ndarray) -> np.ndarray:
        if self.tiers.hot_dtype == "int8":
            return dequantize_int8(*quantize_int8(vecs))
        return vecs

    # -- mutation ----------------------------------------------------------

    def add(self, key, vector, metadata=None) -> None:
        vec = np.asarray(vector, np.float32).reshape(1, -1)
        self.add_batch_arrays([key], vec, [metadata])

    def add_batch(self, items: list[tuple]) -> None:
        if not items:
            return
        keys = [k for k, _, _ in items]
        vecs = np.stack([np.asarray(p, np.float32).reshape(-1) for _, p, _ in items])
        self.add_batch_arrays(keys, vecs, [m for _, _, m in items])

    def add_batch_device(self, keys, dev_vectors, metadatas=None) -> None:
        """Device-resident ingest lands in the authoritative host cold
        store first, so the encoder output is pulled once; hot placement
        then follows the normal policy."""
        keys = list(keys)
        if not keys:
            return
        vecs = dev_vectors[: len(keys)].float().cpu().numpy()
        self.add_batch_arrays(keys, vecs, metadatas)

    def add_batch_arrays(self, keys, vectors, metadatas=None) -> None:
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"index {self.name}: expected dim {self.dim}, got {vecs.shape[1]}")
        self.hot._check_fence()  # fenced generation: reject cold-landing writes too
        for key in keys:
            if key in self._cluster_of:
                self.remove(key)
        # the raw vectors go to the HOT tier untouched — it normalises
        # exactly like the flat index, keeping the fits-hot path equal to
        # it; the normalised copy feeds assignment + cold
        if self.metric == "cos":
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            unit = vecs / np.maximum(norms, 1e-12)
        else:
            unit = vecs
        clusters = self._assign_keys(list(keys), unit)
        slots = self._cold.put(unit)
        restoring = self._restore_assign is not None
        free = [len(f) for f in self.hot._free_shard]
        cap_before = self.hot.shard_capacity
        hot_keys: list = []
        hot_idx: list[int] = []
        for i, key in enumerate(keys):
            c = int(clusters[i])
            self._cluster_of[key] = c
            self._members[c].add(key)
            self._cold_slot[key] = int(slots[i])
            if metadatas is not None and metadatas[i] is not None:
                self._meta[key] = metadatas[i]
            sh = _shard_of_key(key, self.n_shards)
            # fresh inserts go hot while their shard has room (a brand-new
            # doc is as hot as it gets); during snapshot replay everything
            # lands cold and the recorded hot set is promoted afterward
            if not restoring and free[sh] > 0:
                free[sh] -= 1
                hot_keys.append(key)
                hot_idx.append(i)
            else:
                self._cold_add(c, key)
                self._cold_docs_shard[sh] += 1
                self._cold_total += 1
        if hot_keys:
            hv = vecs[hot_idx] if self.tiers.hot_dtype != "int8" else self._hot_vectors(unit[hot_idx])
            self.hot.add_batch_arrays(hot_keys, hv, [self._meta.get(k) for k in hot_keys])
        else:
            self._publish_metrics()
        if cap_before != self.hot.shard_capacity:
            # inserts are gated on free slots: the hot slab (sized to the
            # memory budget) must never take the grow path
            raise RuntimeError(f"index {self.name}: the hot tier grew past its budget")

    def remove(self, key) -> None:
        self.hot._check_fence()
        c = self._cluster_of.pop(key, None)
        if c is None:
            return
        self._members[c].discard(key)
        slot = self._cold_slot.pop(key, None)
        if slot is not None:
            self._cold.erase([slot])
        self._meta.pop(key, None)
        if key in self.hot._slot_of:
            self.hot.remove(key)  # publishes via the tiered override
        else:
            self._cold_discard(c, key)
            self._cold_docs_shard[_shard_of_key(key, self.n_shards)] -= 1
            self._cold_total -= 1
            self._publish_metrics()

    # -- search ------------------------------------------------------------

    def attach_encoder(self, encoder) -> None:
        self._encoder = encoder
        self.hot.attach_encoder(encoder)

    def search_texts_batch(self, texts, k, filter_fns=None):
        """Text queries: when everything is hot the hot index's text path
        runs untouched; with cold docs live, encode then run the tiered
        vector search (the hot slab alone cannot see demoted vectors)."""
        if self._cold_total == 0:
            return self.hot.search_texts_batch(texts, k, filter_fns)
        enc = self._encoder
        if enc is None:
            raise RuntimeError("search_texts_batch requires attach_encoder()")
        texts = ["" if t is None else str(t) for t in texts]
        return self.search_batch(np.asarray(enc.encode(texts)), k, filter_fns)

    def search_batch(self, queries, k: int, filter_fns=None):
        nq = len(queries)
        if nq == 0:
            return []
        if len(self._cluster_of) == 0:
            return [[] for _ in range(nq)]
        if self._cold_total == 0:
            # every doc hot-resident: delegate wholesale, equal to the flat
            # index (it records its own search metrics)
            out = self.hot.search_batch(queries, k, filter_fns)
            self._note_results(out, record=False)
            return out
        q = queries.float().cpu().numpy() if isinstance(queries, torch.Tensor) else np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric == "cos":
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.maximum(norms, 1e-12)
        fetch = 4 * k if filter_fns else k
        out, cold_fetch_s = self._tiered_search(q, k, fetch, filter_fns)
        self._record_tiered_search(nq, k, cold_fetch_s)
        self._note_results(out, record=True)
        return out

    def _tiered_search(self, q, k, fetch, filter_fns):
        """One tiered pass: hot dispatch, host centroid probe, cold
        gather / stage / rescore on the card, host merge."""
        from ..tracing import record_span

        nq = len(q)
        # 1. the hot path dispatches FIRST and never waits on tiering work
        h0 = time.monotonic()
        hot_disp = None
        if len(self.hot._slot_of):
            hot_disp = self.hot.search_dispatch(q, fetch)
        # 2. probe centroids host-side (a small [q, C] product)
        p0 = time.monotonic()
        probed = self._probe(q)
        # 3. the cold candidates of every probed cluster
        need = sorted({int(c) for row in probed for c in row if self._cold_keys[int(c)]})
        cand_keys: list = []
        slot_parts = []
        for c in need:
            keys, slots = self._cold_listing(c)
            cand_keys.extend(keys)
            slot_parts.append(slots)
        record_span("tier_cold_probe", start_mono=p0, end_mono=time.monotonic(), clusters=len(need))
        cold = None
        cold_fetch_s = 0.0
        filtered = bool(filter_fns) and any(f is not None for f in filter_fns)
        if cand_keys:
            from ..internals.chip_ledger import CHIP_LEDGER

            t0 = time.perf_counter()
            with CHIP_LEDGER.timed("index.tier", device=self.device) if CHIP_LEDGER.on() else nullcontext():
                cold = self._cold_candidates(q, cand_keys, np.concatenate(slot_parts), k, filtered)
            cold_fetch_s = time.perf_counter() - t0
        # 4. resolve the hot candidates (the blocking half)
        hot_lists = [[] for _ in range(nq)]
        if hot_disp is not None:
            hs, hi = hot_disp
            hot_lists = self.hot.search_resolve(hs, hi, int(hs.shape[1]))
            # the hot span covers dispatch -> resolve (the async half
            # overlaps the probe / gather work above by design)
            record_span("tier_hot", start_mono=h0, end_mono=time.monotonic(), hot_docs=len(self.hot._slot_of))
        # 5. merge per query: hot wins dedup; filters apply to both tiers
        out = []
        for qi in range(nq):
            flt = filter_fns[qi] if filter_fns else None
            row: list[tuple[Any, float]] = []
            for key, score in hot_lists[qi]:
                if score <= _NEG / 2:
                    break
                if flt is not None and not flt(self._meta.get(key)):
                    continue
                row.append((key, float(score)))
            if cold is not None:
                row.extend(cold(qi, flt))
            row.sort(key=lambda t: -t[1])
            out.append(row[:k])
        return out, cold_fetch_s

    def _cold_candidates(self, q, cand_keys, slots, k, filtered):
        """Stage the candidates' cold rows through the ring, rescore them on
        the card and return ``cold(qi, flt)``: query ``qi``'s cold entries
        that can reach its top-k, in score order (ties to the earlier
        candidate). Keys that are also hot-resident (mid-promotion) are
        left out: the hot copy wins."""
        from ..tracing import record_span

        g0 = time.monotonic()
        m = len(cand_keys)
        if self._cold.dtype == "int8":
            payload = [self._cold._q[slots], self._cold._scale[slots]]
        else:
            payload = [self._cold._f[slots]]
        g1 = time.monotonic()
        record_span("tier_cold_gather", start_mono=g0, end_mono=g1, candidates=m)
        scores = self._cold_score(q, payload)
        hot_res = self.hot._slot_of
        dup = np.fromiter((key in hot_res for key in cand_keys), bool, m)
        if dup.any():
            scores[:, torch.from_numpy(dup).to(scores.device)] = _NEG
        if filtered:
            host = scores.cpu().numpy()
            top_v = top_i = None
        else:
            top_v, top_i = _topk_lower_index(scores, min(k, m))
            top_v, top_i = top_v.cpu().numpy(), top_i.cpu().numpy()
            host = None
        record_span("tier_cold_rescore", start_mono=g1, end_mono=time.monotonic(), candidates=m)
        meta = self._meta

        def cold(qi, flt):
            if host is None:
                return [(cand_keys[j], float(v)) for v, j in zip(top_v[qi], top_i[qi]) if v > _NEG / 2]
            return [
                (key, float(host[qi, j]))
                for j, key in enumerate(cand_keys)
                if not dup[j] and (flt is None or flt(meta.get(key)))
            ]

        return cold

    def _cold_score(self, q: np.ndarray, payload: list[np.ndarray]) -> torch.Tensor:
        """``[q, m]`` scores of the staged cold rows (int8 codes and scales,
        dequantised on the card, or f32 rows), through the ring."""
        from ..device import as_current

        ring = self._stage_ring()
        handles = ring.stage(payload)
        with as_current(self.device):
            if len(handles) == 2:
                codes, scale = handles
                docs = codes.to(torch.float32) * (scale / 127.0)[:, None]
            else:
                docs = handles[0]
            qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(self.device)
            scores = cold_scores(self.metric, qd, docs)
        ring.retire(handles)
        return scores

    def _stage_ring(self):
        # on a mesh the ring stages onto the first shard's device, where the
        # rows are scored once (module docstring)
        if self._cold_ring is None:
            from ..engine.device_ring import DeviceRing

            self._cold_ring = DeviceRing(depth=2, name=f"{self.name}.cold", device=self.device)
        return self._cold_ring

    def _probe(self, q: np.ndarray) -> np.ndarray:
        C = self._n_centroids
        if C == 0:
            return np.empty((len(q), 0), np.int64)
        cents = self._centroids[:C]
        if self.metric == "l2":
            s = 2.0 * (q @ cents.T) - np.sum(cents * cents, axis=1)[None, :]
        else:
            s = q @ cents.T
        p = min(self.tiers.n_probe, C)
        if p >= C:
            return np.tile(np.arange(C, dtype=np.int64), (len(q), 1))
        return np.argpartition(-s, p - 1, axis=1)[:, :p].astype(np.int64)

    def _record_tiered_search(self, nq: int, k: int, cold_fetch_s: float) -> None:
        from ..internals import flight_recorder
        from .index_metrics import INDEX_METRICS

        INDEX_METRICS.record_search(self.name, nq)
        if cold_fetch_s > 0.0:
            INDEX_METRICS.observe_cold_fetch(cold_fetch_s)
        flight_recorder.record(
            "index.search", index=self.name, queries=nq, k=k, shards=self.n_shards, merge_ms=0.0,
            cold_fetch_ms=round(cold_fetch_s * 1e3, 4),
        )

    def _note_results(self, results, record: bool) -> None:
        """Demand signal: bump per-cluster hit counters from result keys
        and (tiered path) the hot/cold result split for the hit ratio."""
        hot_n = 0
        cold_n = 0
        hot_res = self.hot._slot_of
        for row in results:
            for key, _ in row:
                c = self._cluster_of.get(key)
                if c is not None:
                    self._hits[c] += 1.0
                if key in hot_res:
                    hot_n += 1
                else:
                    cold_n += 1
        if record and (hot_n or cold_n):
            from .index_metrics import INDEX_METRICS

            INDEX_METRICS.record_tier_hits(self.name, hot_n, cold_n)
        self._searches_since_rebalance += 1
        if self._searches_since_rebalance >= self.tiers.promote_every:
            self.maybe_rebalance(force=True)

    # -- promotion / demotion ---------------------------------------------

    def maybe_rebalance(self, force: bool = False) -> bool:
        """Hit-driven tier rebalance: promote the hottest cold clusters
        onto the card, demoting colder hot clusters when the slab is full.
        Throttled to every ``promote_every`` searches unless forced."""
        if not force and self._searches_since_rebalance < self.tiers.promote_every:
            return False
        self._searches_since_rebalance = 0
        C = self._n_centroids
        if C == 0:
            return False
        cold_cands = [c for c in range(C) if self._cold_keys[c] and self._hits[c] > 0]
        cold_cands.sort(key=lambda c: -self._hits[c])
        hot_cands = [c for c in range(C) if len(self._members[c]) > len(self._cold_keys[c])]
        hot_cands.sort(key=lambda c: self._hits[c])  # coldest first
        free_total = sum(len(f) for f in self.hot._free_shard)
        changed = False
        for c in cold_cands:
            need = len(self._cold_keys[c])
            while free_total < need and hot_cands:
                d = hot_cands[0]
                if self._hits[d] >= self._hits[c] or d == c:
                    break
                hot_cands.pop(0)
                freed = self._demote_cluster(d)
                free_total += freed
                changed = changed or freed > 0
            if free_total <= 0:
                break
            moved = self._promote_cluster(c)
            free_total -= moved
            changed = changed or moved > 0
        self._hits *= self.tiers.decay
        if changed:
            self._record_rebalance()
        return changed

    def _promote_cluster(self, c: int) -> int:
        """Move cluster ``c``'s cold members into the hot slab, in two
        chunks with a chaos site before each — a promotion killed between
        chunks leaves keys hot-resident AND still listed cold; search
        dedups (hot wins) and the cold entry is cleared on retry, so
        nothing is lost or duplicated."""
        from ..freshness.plane import FRESHNESS
        from ..resilience import chaos

        free = [len(f) for f in self.hot._free_shard]
        keys: list = []
        for key in list(self._cold_keys[c]):
            sh = _shard_of_key(key, self.n_shards)
            if free[sh] > 0:
                free[sh] -= 1
                keys.append(key)
        if not keys:
            return 0
        moved = 0
        t0 = time.perf_counter()
        touched: set[int] = set()
        half = max(1, len(keys) // 2)
        for chunk in (keys[:half], keys[half:]):
            if not chunk:
                continue
            chaos.inject("index.tier.promote")
            vecs = self._hot_vectors(self._cold.fetch([self._cold_slot[key] for key in chunk]))
            self.hot.add_batch_arrays(chunk, vecs, [self._meta.get(key) for key in chunk])
            for key in chunk:
                sh = _shard_of_key(key, self.n_shards)
                touched.add(sh)
                self._cold_discard(c, key)
                self._cold_docs_shard[sh] -= 1
                self._cold_total -= 1
            moved += len(chunk)
        self._promotions += 1
        # promotion-completion watermark: the promoted cluster is fully
        # hot-resident now; the wall spent is off-hot-path lag accrual
        FRESHNESS.accrue("promotion", time.perf_counter() - t0)
        FRESHNESS.note_index_add(self, touched)
        self._tier_event("index.tier.promote", c, moved)
        return moved

    def _demote_cluster(self, c: int) -> int:
        """Evict cluster ``c``'s hot members; vectors already live in the
        cold store, so demotion moves no data. The cold listing is re-added
        BEFORE the hot remove: a crash between the two leaves a dedup-able
        duplicate, never a lost vector."""
        hot_keys = [key for key in self._members[c] if key in self.hot._slot_of]
        for key in hot_keys:
            self._cold_add(c, key)
            self._cold_docs_shard[_shard_of_key(key, self.n_shards)] += 1
            self._cold_total += 1
            self.hot.remove(key)
        if hot_keys:
            self._demotions += 1
            self._tier_event("index.tier.demote", c, len(hot_keys))
        return len(hot_keys)

    def force_demote(self, clusters=None) -> int:
        """Test/bench hook: demote the given clusters (default: all)."""
        if clusters is None:
            clusters = range(self._n_centroids)
        moved = 0
        for c in clusters:
            moved += self._demote_cluster(int(c))
        if moved:
            self._record_rebalance()
        return moved

    def _tier_event(self, event: str, cluster: int, moved: int) -> None:
        from ..internals import flight_recorder
        from .index_metrics import INDEX_METRICS

        INDEX_METRICS.record_tier_events(
            self.name,
            promotions=1 if event.endswith("promote") else 0,
            demotions=1 if event.endswith("demote") else 0,
        )
        flight_recorder.record(
            event, index=self.name, cluster=int(cluster), moved=int(moved), hot_docs=self.hot_docs(),
            cold_docs=self.cold_docs(),
        )

    def _record_rebalance(self) -> None:
        """index.rebalance accounts BOTH tiers: a shard whose corpus is
        merely demoted reports its full doc count, not zero."""
        from ..internals import flight_recorder

        hot_shard = self.hot._live_docs_shard()
        flight_recorder.record(
            "index.rebalance",
            index=self.name,
            shards=self.n_shards,
            shard_capacity=self.hot.shard_capacity,
            docs=[int(h) + int(cd) for h, cd in zip(hot_shard, self._cold_docs_shard)],
            docs_hot=[int(h) for h in hot_shard],
            docs_cold=[int(cd) for cd in self._cold_docs_shard],
        )
        self._publish_metrics()

    # -- snapshots ---------------------------------------------------------

    def tier_state(self) -> dict:
        """Everything recovery needs to restore the EXACT tier layout:
        centroid table + counts, per-key cluster assignment, decayed hit
        counters, and the hot-resident key set."""
        n = self._n_centroids
        return {
            "version": 1,
            "config": self.tiers.as_dict(),
            "centroids": self._centroids[:n].copy(),
            "centroid_n": self._centroid_n[:n].copy(),
            "cluster_of": dict(self._cluster_of),
            "hot_keys": [k for k in self._cluster_of if k in self.hot._slot_of],
            "hits": self._hits.copy(),
        }

    def restore_tier_state(self, state: dict) -> None:
        """Install snapshot assignment BEFORE the rows are re-added:
        replayed adds land cold with their exact recorded cluster, then
        ``finish_tier_restore`` promotes the recorded hot set."""
        cents = np.asarray(state["centroids"], np.float32)
        n = min(len(cents), self.tiers.n_clusters)
        self._centroids[:n] = cents[:n]
        self._centroid_n[:n] = np.asarray(state["centroid_n"])[:n]
        self._n_centroids = n
        hits = np.asarray(state.get("hits", ()), np.float64)
        m = min(len(hits), len(self._hits))
        self._hits[:m] = hits[:m]
        self._restore_assign = dict(state["cluster_of"])
        self._restore_hot = list(state["hot_keys"])

    def finish_tier_restore(self) -> None:
        """Promote exactly the snapshotted hot set from the cold store and
        leave restore mode. Idempotent; safe without a snapshot."""
        hot_keys = self._restore_hot or []
        self._restore_assign = None
        self._restore_hot = None
        todo = [key for key in hot_keys if key in self._cluster_of and key not in self.hot._slot_of]
        free = [len(f) for f in self.hot._free_shard]
        fit: list = []
        for key in todo:
            sh = _shard_of_key(key, self.n_shards)
            if free[sh] > 0:
                free[sh] -= 1
                fit.append(key)
        if fit:
            vecs = self._hot_vectors(self._cold.fetch([self._cold_slot[key] for key in fit]))
            self.hot.add_batch_arrays(fit, vecs, [self._meta.get(key) for key in fit])
            for key in fit:
                c = self._cluster_of[key]
                if key in self._cold_keys[c]:
                    self._cold_discard(c, key)
                    self._cold_docs_shard[_shard_of_key(key, self.n_shards)] -= 1
                    self._cold_total -= 1
        self._publish_metrics()

    # -- elastic reshard protocol (elastic/controller.py drives) -----------

    def fence(self, generation: int | None = None) -> None:
        """Freeze this index as a dead generation (writes raise
        ``StaleGeneration``; reads still serve)."""
        self.hot.fence(generation)
        if generation is not None:
            self.generation = max(self.generation, int(generation))

    def spawn_like(self, mesh, reserved_space: int | None = None):
        """An EMPTY tiered index with this one's tier config on a target
        mesh. The hot slab re-derives from the same budget (an explicit
        ``hot_rows`` carries over; a budget-derived size re-splits over the
        new shard count)."""
        return TieredKnnIndex(
            self.dim, metric=self.metric,
            reserved_space=int(reserved_space) if reserved_space else self.hot.capacity,
            tiers=self.tiers, mesh=mesh, name=self.name, device=self.device,
        )

    def reshard_export_chunks(self, chunk_rows: int):
        """Migration stream: one tier-state chunk (assignment, centroids,
        hits, hot set), then every doc's cold payload as stored bytes in
        bounded chunks, then the hot-resident rows as the hot slab holds
        them (normalised, or dequantised int8). Raw transplant on both tiers
        keeps a resharded tiered index score-bit-identical to one that never
        moved."""
        yield {"kind": "tier_state", "state": self.tier_state()}
        step = max(1, int(chunk_rows))
        keys = list(self._cluster_of)
        for i in range(0, len(keys), step):
            batch = [k for k in keys[i : i + step] if k in self._cluster_of]
            if not batch:
                continue
            yield {
                "kind": "tier_rows", "keys": batch,
                "payload": self._cold.export_rows([self._cold_slot[k] for k in batch]),
                "metas": [self._meta.get(k) for k in batch],
            }
        hot_keys = [k for k, _ in sorted(self.hot._slot_of.items(), key=lambda kv: kv[1])]
        for i in range(0, len(hot_keys), step):
            batch = [k for k in hot_keys[i : i + step] if k in self._cluster_of and k in self.hot._slot_of]
            if not batch:
                continue
            slots = np.fromiter((self.hot._slot_of[k] for k in batch), np.int64, len(batch))
            yield {"kind": "tier_hot", "keys": batch, "vecs": self.hot._rows_at(slots),
                   "metas": [self._meta.get(k) for k in batch]}

    def reshard_import_chunk(self, chunk: dict) -> None:
        kind = chunk.get("kind")
        if kind == "tier_state":
            self.restore_tier_state(chunk["state"])
            return
        if kind == "tier_rows":
            assign = self._restore_assign or {}
            keys = chunk["keys"]
            for key in keys:
                if key in self._cluster_of:
                    self.remove(key)
            slots = self._cold.import_rows(chunk["payload"])
            metas = chunk["metas"]
            for i, key in enumerate(keys):
                c = int(assign.get(key, 0))
                self._cluster_of[key] = c
                self._members[c].add(key)
                self._cold_slot[key] = int(slots[i])
                self._cold_add(c, key)
                # shard routing under the TARGET shard count
                self._cold_docs_shard[_shard_of_key(key, self.n_shards)] += 1
                self._cold_total += 1
                if metas[i] is not None:
                    self._meta[key] = metas[i]
            self._publish_metrics()
            return
        if kind == "tier_hot":
            # promote exactly the source's hot rows, as the hot slab holds
            # them (the import bypasses normalisation); the hot slab grows
            # per shard on demand, so the whole hot set transplants and hot
            # and cold membership is preserved exactly
            fit: list = []
            fit_idx: list[int] = []
            for i, key in enumerate(chunk["keys"]):
                if key not in self._cluster_of or key in self.hot._slot_of:
                    continue
                fit.append(key)
                fit_idx.append(i)
            if fit:
                self.hot.reshard_import_chunk({
                    "kind": "rows", "keys": fit, "vecs": np.asarray(chunk["vecs"])[fit_idx],
                    "metas": [self._meta.get(k) for k in fit],
                })
                for key in fit:
                    c = self._cluster_of[key]
                    if key in self._cold_keys[c]:
                        self._cold_discard(c, key)
                        self._cold_docs_shard[_shard_of_key(key, self.n_shards)] -= 1
                        self._cold_total -= 1
                self._publish_metrics()
            return
        raise ValueError(f"tiered index cannot import chunk kind {kind!r}")

    def reshard_finish(self) -> None:
        """Leave restore mode (the hot promotion already happened through
        the ``tier_hot`` chunks, byte-exact) and commit the hot slab."""
        if self._restore_hot is not None:
            self._restore_hot = [k for k in self._restore_hot if k not in self.hot._slot_of]
        self.finish_tier_restore()
        self.hot._sync()
        self._publish_metrics()
