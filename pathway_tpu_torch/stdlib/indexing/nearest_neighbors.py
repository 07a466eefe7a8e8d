"""KNN inner indexes + factories.

The port's copy of the reference's ``stdlib/indexing/nearest_neighbors.py``
(upstream Pathway's stdlib/indexing/nearest_neighbors.py: USearchKnn :65,
BruteForceKnn :170, LshKnn :262, factories :407-554).

``BruteForceKnn`` and ``UsearchKnn`` run on the port's device-resident
brute-force index (``ops/knn.DeviceKnnIndex``, top-k kernel B2 on the
card). An embedder with ``encode_device`` feeds the index straight from
the card (the engine routes a tensor batch to ``add_batch_device``), and
one that exposes its encoder takes the fused text-query path
(``search_texts_batch``). ``LshKnn`` keeps a host LSH tier
(random-projection bucketing). ``device``: ``None`` places the index on
its encoder's device when its embedder has one, else on ``"cuda"``;
``"cpu"`` only when asked. ``mesh``: the device-backed indexes shard over
the mesh's data axis (``DeviceKnnIndex(mesh=)``); it resolves when the
graph is lowered, the explicit ``mesh=`` first (a spec on the CPU when
``device="cpu"``), else ``parallel.mesh.active_mesh()`` (``pw.run(mesh=)``
or ``PATHWAY_MESH``). ``LshKnn`` keeps its host tier on a mesh, as the
reference does. ``tenant``: the index becomes one tenant's segment of the
shared ``tenancy.TenantPackedIndex`` slab of its geometry
(``shared_slab``); it takes precedence over ``tiers``, which makes the
index a ``ops.tiered_knn.TieredKnnIndex`` (the explicit spec first, else
``pw.run(index_tiers=)`` / ``PATHWAY_INDEX_TIERS``). Both resolve when the
graph is lowered, on a mesh too: the tenant slab of a mesh is shared by the
indexes of that mesh, and a tiered index shards its hot tier over it.
``LshKnn`` ignores them, as the reference's does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ...internals.expression import ColumnExpression, ColumnReference
from ...ops.knn import DeviceKnnIndex, _k_bucket as _pow2_bucket
from ...ops.tiered_knn import TieredKnnIndex, active_tiers, parse_tier_spec
from ...parallel.mesh import active_mesh, parse_mesh_spec, resolve_mesh
from .data_index import InnerIndex
from .retrievers import InnerIndexFactory


class BruteForceKnnMetricKind:
    COS = "cos"
    L2SQ = "l2"


class USearchMetricKind:
    COS = "cos"
    L2SQ = "l2"
    IP = "ip"


def _as_vector(payload) -> np.ndarray:
    if isinstance(payload, np.ndarray):
        return payload.astype(np.float32, copy=False)
    return np.asarray(list(payload), np.float32)


def normalize_embedder(embedder: Callable | None) -> Callable | None:
    """Adapt an embedder (pw UDF or plain batch callable) into a batch
    callable texts -> vectors, keeping UDF executor/cache policies."""
    if embedder is None:
        return None
    from ...internals.udfs import as_batch_callable

    return as_batch_callable(embedder)


class _VectorPayloadIndex(DeviceKnnIndex):
    """DeviceKnnIndex accepting tuple/list/ndarray payloads — and raw
    text payloads when a fused encoder is attached (single-dispatch
    tokenize->encode->score->top-k query path)."""

    def add(self, key, payload, metadata=None):
        super().add(key, _as_vector(payload), metadata)

    def search_batch(self, payloads, k, filter_fns=None):
        if not len(payloads):
            return []
        if getattr(self, "_encoder", None) is not None:
            probe = next((p for p in payloads if p is not None), None)
            if probe is None or isinstance(probe, str):
                # fused config: queries arrive as raw text (None -> "")
                return self.search_texts_batch(
                    ["" if p is None else p for p in payloads], k, filter_fns
                )
        q = np.stack([_as_vector(p) for p in payloads])
        return super().search_batch(q, k, filter_fns)


class _TieredPayloadIndex(TieredKnnIndex):
    """TieredKnnIndex with the same payload coercion + text-query routing
    as :class:`_VectorPayloadIndex`."""

    def add(self, key, payload, metadata=None):
        super().add(key, _as_vector(payload), metadata)

    def search_batch(self, payloads, k, filter_fns=None):
        if not len(payloads):
            return []
        if self._encoder is not None:
            probe = next((p for p in payloads if p is not None), None)
            if probe is None or isinstance(probe, str):
                return self.search_texts_batch(["" if p is None else p for p in payloads], k, filter_fns)
        q = np.stack([_as_vector(p) for p in payloads])
        return super().search_batch(q, k, filter_fns)


class _TenantPayloadView:
    """One tenant's slice of a shared ``TenantPackedIndex`` slab, with the
    same payload coercion as :class:`_VectorPayloadIndex` — what
    ``tenant=`` hands the engine instead of a private index."""

    def __init__(self, view):
        self._view = view
        self._encoder = None

    def attach_encoder(self, encoder) -> None:
        """Text queries (the fused query configuration) embed through
        ``encoder`` before the tenant's search."""
        self._encoder = encoder

    @property
    def dim(self):
        return self._view.dim

    @property
    def metric(self):
        return self._view.metric

    def __len__(self):
        return len(self._view)

    def add(self, key, payload, metadata=None):
        self._view.add(key, _as_vector(payload), metadata)

    def add_batch(self, items):
        self._view.add_batch([(k, _as_vector(p), m) for k, p, m in items])

    def add_batch_arrays(self, keys, vectors, metadatas=None):
        self._view.add_batch_arrays(keys, vectors, metadatas)

    def add_batch_device(self, keys, dev_vectors, metadatas=None):
        self._view.add_batch_arrays(keys, dev_vectors[: len(keys)].float().cpu().numpy(), metadatas)

    def remove(self, key):
        self._view.remove(key)

    def search_batch(self, payloads, k, filter_fns=None):
        if not len(payloads):
            return []
        probe = next((p for p in payloads if p is not None), None)
        if self._encoder is not None and (probe is None or isinstance(probe, str)):
            q = np.asarray(self._encoder.encode(["" if p is None else str(p) for p in payloads]), np.float32)
        else:
            q = np.stack([_as_vector(p) for p in payloads])
        return self._view.search_batch(q, k, filter_fns)

    def search_one(self, payload, k, filter_fn=None):
        return self.search_batch([payload], k, [filter_fn] if filter_fn is not None else None)[0]


def fused_query_encoder(embedder) -> Any | None:
    """The SentenceEncoder behind ``embedder`` when its internals
    (module/params/tokenizer) are exposed for the fused query path."""
    enc = getattr(embedder, "_encoder", embedder)
    if all(hasattr(enc, a) for a in ("module", "params", "tokenizer", "max_seq_len")):
        return enc
    return None


@dataclass(frozen=True)
class AbstractKnn(InnerIndex):
    dimensions: int = 0
    reserved_space: int = 1024
    metric: str = "cos"
    embedder: Callable | None = None
    #: explicit DeviceMesh (or spec accepted by parallel.mesh.resolve_mesh);
    #: None defers to the run-scoped mesh from ``pw.run(mesh=...)`` /
    #: ``PATHWAY_MESH`` at lowering time
    mesh: Any = None
    #: explicit tier spec (TierConfig / dict / str accepted by
    #: ops.tiered_knn.parse_tier_spec); None defers to the run-scoped
    #: config from ``pw.run(index_tiers=...)`` / ``PATHWAY_INDEX_TIERS``
    tiers: Any = None
    #: tenant id: this index becomes one tenant's segment of the shared
    #: ``TenantPackedIndex`` slab for its (dimensions, metric, device)
    #: geometry. Takes precedence over ``tiers`` (the slab manages its own
    #: residency by cold-tenant demotion).
    tenant: str | None = None
    #: device of the index slab: None -> "cuda" (resolve_device); "cpu"
    #: only when asked
    device: Any = None

    # device-index classes (DeviceKnnIndex-backed) opt in to the
    # HBM-resident ingest + fused text-query paths; host-side tiers
    # (LshKnn) must keep the embed-on-host contract
    _device_backed = False

    def _embed_fns(self):
        if self.embedder is None:
            return None, None
        embed = normalize_embedder(self.embedder)

        def batch_embed(payloads):
            texts = [p if isinstance(p, str) else str(p) for p in payloads]
            vecs = embed(texts)
            return [np.asarray(v, np.float32) for v in vecs]

        if self._device_backed and hasattr(self.embedder, "encode_device"):
            # ingest path stays on the card: the encoder's output feeds
            # the index scatter directly (engine _index_add routes device
            # tensors to add_batch_device); batches pad to bucket sizes,
            # as the reference pads them for its compiled programs
            enc = self.embedder
            import inspect

            try:
                _has_pad = "pad_to" in inspect.signature(enc.encode_device).parameters
            except (TypeError, ValueError):
                _has_pad = False

            def data_embed(payloads):
                texts = [p if isinstance(p, str) else str(p) for p in payloads]
                if _has_pad:
                    return enc.encode_device(texts, pad_to=_pow2_bucket(len(texts)))
                return enc.encode_device(texts)

            if fused_query_encoder(self.embedder) is not None:
                # queries stay raw text: the index runs the fused
                # single-dispatch tokenize->encode->score->top-k path
                return data_embed, None

            return data_embed, batch_embed

        return batch_embed, batch_embed

    def _index_spec(self) -> dict | None:
        """The graph's description of a device-backed index, the reference's
        fields and values: enough to estimate its device footprint,
        compile-bucket space and placement without building it. The mesh is
        parsed without touching a device (an unparseable spec gives None)."""
        if not self._device_backed:
            return None
        mesh_axes = None
        if self.mesh is not None:
            try:
                mesh_axes = parse_mesh_spec(self.mesh)
            except (ValueError, TypeError):
                mesh_axes = None
        encoder = None
        enc = fused_query_encoder(self.embedder) if self.embedder is not None else None
        if enc is not None:
            encoder = {
                "max_seq_len": int(getattr(enc, "max_seq_len", 256) or 256),
                "max_batch": int(getattr(enc, "max_batch", 1024) or 1024),
                "hidden": int(getattr(getattr(enc, "cfg", None), "hidden_size", 0) or 0),
            }
        return {
            "kind": type(self).__name__,
            "dimensions": int(self.dimensions),
            "reserved_space": int(self.reserved_space),
            "metric": self.metric,
            "device_backed": True,
            "mesh": self.mesh is not None,
            "mesh_axes": mesh_axes,
            "tiers": self.tiers is not None,
            "tier_spec": self.tiers if isinstance(self.tiers, (dict, str)) else None,
            "tenant": self.tenant,
            "encoder": encoder,
        }

    def _make_device_index(self):
        dim, metric, res = self.dimensions, self.metric, self.reserved_space
        enc = fused_query_encoder(self.embedder) if self.embedder else None
        # an index fed by an encoder lives on the encoder's device
        device = self.device if self.device is not None or enc is None else enc.device
        mesh_spec = self.mesh
        tier_spec = self.tiers
        tenant = self.tenant

        def make():
            # the mesh and the tiers resolve here, when the graph is lowered
            # inside pw.run, so retrievers built before the run pick up
            # pw.run(mesh=..., index_tiers=...) / PATHWAY_MESH /
            # PATHWAY_INDEX_TIERS
            mesh = resolve_mesh(mesh_spec, device=device) if mesh_spec is not None else active_mesh(device=device)
            if tenant is not None:
                from ...tenancy import shared_slab

                slab = shared_slab(dim, metric=metric, reserved_space=max(64, res), mesh=mesh, device=device)
                view = _TenantPayloadView(slab.view(tenant))
                if enc is not None:
                    view.attach_encoder(enc)
                return view
            tiers = parse_tier_spec(tier_spec) if tier_spec is not None else active_tiers()
            if tiers is not None:
                idx: Any = _TieredPayloadIndex(
                    dim=dim, metric=metric, reserved_space=max(64, res), tiers=tiers, mesh=mesh, device=device
                )
            else:
                idx = _VectorPayloadIndex(dim=dim, metric=metric, reserved_space=max(64, res), device=device,
                                          mesh=mesh)
            if enc is not None:
                idx.attach_encoder(enc)
            return idx

        return make


@dataclass(frozen=True)
class BruteForceKnn(AbstractKnn):
    """Exhaustive KNN on a device-resident matrix (reference
    BruteForceKnn :170 / Rust brute_force_knn_integration.rs:22)."""

    auxiliary_space: int = 0
    _device_backed = True

    def _index_factory(self):
        return self._make_device_index()


@dataclass(frozen=True)
class UsearchKnn(AbstractKnn):
    """API-parity with the reference's USearch HNSW tier (:65). Backed
    by the same device brute-force scan — see module docstring."""

    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0
    _device_backed = True

    def _index_factory(self):
        return self._make_device_index()


class _LshIndex:
    """Random-projection LSH buckets; candidates scored exactly on host
    (reference stdlib/ml/classifiers/_lsh.py:97 bucketer + _knn_lsh.py)."""

    def __init__(self, dim: int, metric: str, n_or: int = 8, n_and: int = 6, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.dim = dim
        self.metric = metric
        self.planes = rng.normal(size=(n_or, n_and, dim)).astype(np.float32)
        self.n_or = n_or
        self.buckets: list[dict[int, set]] = [dict() for _ in range(n_or)]
        self.vectors: dict[Any, np.ndarray] = {}
        self.meta: dict[Any, Any] = {}

    def _codes(self, vec: np.ndarray) -> list[int]:
        bits = (self.planes @ vec) > 0  # [n_or, n_and]
        return [int.from_bytes(np.packbits(b).tobytes(), "big") for b in bits]

    def add(self, key, payload, metadata=None):
        vec = _as_vector(payload)
        if self.metric == "cos":
            n = np.linalg.norm(vec)
            if n > 0:
                vec = vec / n
        self.vectors[key] = vec
        if metadata is not None:
            self.meta[key] = metadata
        for t, code in enumerate(self._codes(vec)):
            self.buckets[t].setdefault(code, set()).add(key)

    def remove(self, key):
        vec = self.vectors.pop(key, None)
        self.meta.pop(key, None)
        if vec is None:
            return
        for t, code in enumerate(self._codes(vec)):
            b = self.buckets[t].get(code)
            if b is not None:
                b.discard(key)

    def search_batch(self, payloads, k, filter_fns=None):
        out = []
        for i, p in enumerate(payloads):
            vec = _as_vector(p)
            if self.metric == "cos":
                n = np.linalg.norm(vec)
                if n > 0:
                    vec = vec / n
            cands: set = set()
            for t, code in enumerate(self._codes(vec)):
                cands |= self.buckets[t].get(code, set())
            flt = filter_fns[i] if filter_fns else None
            scored = []
            for key in cands:
                if flt is not None:
                    try:
                        if not flt(self.meta.get(key)):
                            continue
                    except Exception:
                        continue
                v = self.vectors[key]
                if self.metric == "cos":
                    s = float(vec @ v)
                else:
                    d = vec - v
                    s = -float(d @ d)
                scored.append((key, s))
            scored.sort(key=lambda kv: -kv[1])
            out.append(scored[:k])
        return out


@dataclass(frozen=True)
class LshKnn(AbstractKnn):
    """LSH-bucketed approximate KNN (reference LshKnn :262): a host index,
    which ignores a mesh, as the reference's does."""

    bucket_length: float = 4.0
    n_or: int = 8
    n_and: int = 6

    def _index_factory(self):
        dim, metric = self.dimensions, self.metric
        n_or, n_and = self.n_or, self.n_and
        return lambda: _LshIndex(dim, metric, n_or=n_or, n_and=n_and)


# ---------------- factories (reference :407-554) ----------------


@dataclass
class KnnIndexFactory(InnerIndexFactory):
    dimensions: int = 0
    reserved_space: int = 1024
    metric: str = "cos"
    embedder: Callable | None = None
    mesh: Any = None  # explicit DeviceMesh/spec; None -> run-scoped mesh
    tiers: Any = None  # explicit tier spec; None -> run-scoped tiers
    tenant: str | None = None  # tenant id -> shared packed slab segment
    device: Any = None  # None -> "cuda"; "cpu" only when asked

    def _get_embed_dimensions(self) -> int:
        if self.dimensions:
            return self.dimensions
        assert self.embedder is not None, "need dimensions or an embedder"
        probe = np.asarray(normalize_embedder(self.embedder)(["."]))
        return int(probe.shape[-1])


@dataclass
class BruteForceKnnFactory(KnnIndexFactory):
    auxiliary_space: int = 0

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=self._get_embed_dimensions(),
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            mesh=self.mesh,
            tiers=self.tiers,
            tenant=self.tenant,
            device=self.device,
        )


@dataclass
class UsearchKnnFactory(KnnIndexFactory):
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return UsearchKnn(
            data_column,
            metadata_column,
            dimensions=self._get_embed_dimensions(),
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            mesh=self.mesh,
            tiers=self.tiers,
            tenant=self.tenant,
            device=self.device,
        )


@dataclass
class LshKnnFactory(KnnIndexFactory):
    bucket_length: float = 4.0
    n_or: int = 8
    n_and: int = 6

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return LshKnn(
            data_column,
            metadata_column,
            dimensions=self._get_embed_dimensions(),
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            n_or=self.n_or,
            n_and=self.n_and,
        )
