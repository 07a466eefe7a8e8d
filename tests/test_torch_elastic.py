"""The port's elastic reshard plane against the JAX package, on the CPU
(``tests/test_elastic.py``'s forty cases, one counterpart each): spec
parsing, the serve-through handle (delta log, dual-window dedup),
migration of the flat, tiered (f32 and int8 cold tiers) and tenant-packed
indexes, writes and removes during a migration, fencing, chaos raises at
every boundary, the durable reshard intent and SIGKILL recovery in child
processes, every controller watermark, admission's degrade and
``Retry-After``, the ``/metrics`` lines, the flight events and the span.
Two more hold the plane under a multi-process cluster: a reshard advances
a registered coordinator's generation by one and a frame of the old
generation is then fenced (both packages), and a live 2-process run of the
port reshards mid-stream with no regroup and its twin's answers.

Both packages get the same numpy rows and the same meshes: the
reference's come from the eight forced host devices ``tests/conftest.py``
sets, the port's from ``resolve_mesh(n, device="cpu")`` with the device
pool of ``parallel/mesh.py`` set to eight CPU devices (its counterpart of
the forced devices). Within the port a resharded index answers exactly as
its never-resharded twin and holds the same rows byte for byte, as the
reference's tests assert of the reference. Across the packages keys are
equal and scores agree within 1e-5 (each framework normalises cos rows in
its own order). The tests with a writer or remover thread run both
packages and hold each to the reference's invariants (the interleaving is
not deterministic). The reference's timing gates are not copied."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.elastic as jel
import pathway_tpu.elastic.controller as jctl
import pathway_tpu.engine.persistence as jpers
import pathway_tpu.ops.knn as jknn
import pathway_tpu.ops.tiered_knn as jtk
import pathway_tpu.parallel.mesh as jmesh
import pathway_tpu.resilience.chaos as jchaos
import pathway_tpu.resilience.cluster as jcluster
import pathway_tpu.tenancy.packed as jpacked
import pathway_tpu_torch as tpw
import pathway_tpu_torch.elastic as tel
import pathway_tpu_torch.elastic.controller as tctl
import pathway_tpu_torch.engine.persistence as tpers
import pathway_tpu_torch.ops.knn as tknn
import pathway_tpu_torch.ops.tiered_knn as ttk
import pathway_tpu_torch.parallel.mesh as tmesh
import pathway_tpu_torch.resilience.chaos as tchaos
import pathway_tpu_torch.resilience.cluster as tcluster
import pathway_tpu_torch.tenancy.packed as tpacked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5

J = types.SimpleNamespace(
    name="jax", pw=jpw, el=jel, ctl=jctl, pers=jpers, knn=jknn, tk=jtk, packed=jpacked, chaos=jchaos,
    cluster=jcluster, mesh=lambda n: jmesh.resolve_mesh(n), dev={},
)
T = types.SimpleNamespace(
    name="torch", pw=tpw, el=tel, ctl=tctl, pers=tpers, knn=tknn, tk=ttk, packed=tpacked, chaos=tchaos,
    cluster=tcluster, mesh=lambda n: tmesh.resolve_mesh(n, device="cpu"), dev={"device": "cpu"},
)


def _mod(P, rel: str):
    import importlib

    return importlib.import_module(f"{P.pw.__name__}.{rel}")


def _reset(P) -> None:
    P.el.reset_registry()
    P.el.ELASTIC_METRICS.reset()
    P.chaos.deactivate()
    tracing = _mod(P, "tracing")
    _mod(P, "tracing.store").TRACE_STORE.reset()
    tracing.TRACING_METRICS.reset()


@pytest.fixture(autouse=True)
def _elastic_clean_state():
    prev_pool = tmesh.set_device_pool(["cpu"] * 8)
    for P in (J, T):
        _reset(P)
    yield
    for P in (J, T):
        _reset(P)
    tmesh.set_device_pool(prev_pool)


def _rows(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(n)]
    return keys, rng.normal(size=(n, dim)).astype("float32")


def _queries(n, dim, seed=99):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype("float32")


def _same(got, want) -> None:
    """Port answers against the reference's: keys exact, scores at 1e-5."""
    assert [[k for k, _ in row] for row in got] == [[k for k, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=SCORE_TOL, atol=SCORE_TOL)


def _flat_rows(index) -> dict:
    """Every live key's row as the port's index holds it now (pulled from
    the slabs when the host mirror is stale)."""
    items = sorted(index._slot_of.items(), key=lambda kv: kv[1])
    slots = np.asarray([s for _, s in items], np.int64)
    rows = index._rows_at(slots) if len(slots) else np.zeros((0, index.dim), np.float32)
    return {k: rows[i].tobytes() for i, (k, _) in enumerate(items)}


def _snapshot(P) -> dict:
    snap = dict(P.el.ELASTIC_METRICS.snapshot())
    snap.pop("last_mttr_s")
    return snap


def _built_handle(P, n=150, dim=8, seed=9):
    keys, vecs = _rows(n, dim, seed=seed)
    idx = P.knn.DeviceKnnIndex(dim, mesh=P.mesh(2), reserved_space=64)
    idx.add_batch_arrays(keys, vecs)
    return P.el.register_handle(idx)


# ---------------------------------------------------------------------------
# config parsing


_SPECS = [None, "off", "", False, True, "on", "auto", 4, "4", "min=2,max=8,chunk=512,hbm_frac=0.85",
          {"shards": 4, "cooldown_s": 5}, "auto,stranded_frac=0.5", "oom_warn_s=30,interval=0.25,cooldown=2"]


def test_parse_elastic_spec_forms():
    for spec in _SPECS:
        got, want = tel.parse_elastic_spec(spec), jel.parse_elastic_spec(spec)
        assert (got is None) == (want is None), spec
        if got is not None:
            assert got.as_dict() == want.as_dict(), spec
    assert tel.parse_elastic_spec(True) == tel.ElasticConfig()
    assert tel.parse_elastic_spec("4") == tel.ElasticConfig(shards=4)
    roundtrip = tel.parse_elastic_spec(tel.ElasticConfig(oom_warn_s=30))
    assert roundtrip.oom_warn_s == 30
    d = tel.ElasticConfig(hbm_frac=0.9).as_dict()
    assert d == jel.ElasticConfig(hbm_frac=0.9).as_dict() and d["max_shards"] == 8


def test_parse_elastic_spec_rejects_malformed():
    for P in (J, T):
        for bad in ("wat", "shards=x", "nope=1", {"nope": 1}, 3.5, [4]):
            with pytest.raises(ValueError):
                P.el.parse_elastic_spec(bad)
        for kw in (dict(shards=0), dict(min_shards=4, max_shards=2), dict(hbm_frac=1.5), dict(chunk_rows=0),
                   dict(cooldown_s=-1), dict(interval_s=0)):
            with pytest.raises(ValueError):
                P.el.ElasticConfig(**kw)


def test_watermarks_armed():
    for kw in ({}, dict(shards=4), dict(auto=True), dict(hbm_frac=0.8), dict(oom_warn_s=60),
               dict(stranded_frac=0.5)):
        got = tel.ElasticConfig(**kw).watermarks_armed()
        assert got == jel.ElasticConfig(**kw).watermarks_armed(), kw
        assert got == (bool(kw) and kw != dict(shards=4))


def test_mesh_auto_spec(monkeypatch):
    axes = tmesh.parse_mesh_spec("auto")
    assert axes == jmesh.parse_mesh_spec("auto") and axes.get("auto") and axes["data"] == 1
    # every visible device on the data axis: the reference sees its eight
    # forced host devices, the port its pool of eight CPU devices
    mesh = tmesh.resolve_mesh(axes)
    assert mesh.shape == {"data": 8, "model": 1} == dict(jmesh.resolve_mesh(axes).shape)
    assert mesh.data_devices() == [tmesh.torch.device("cpu")] * 8
    # without a pool, "auto" on the CPU is the one CPU device, and on the
    # cards every card (none here: it raises rather than fall back)
    tmesh.set_device_pool(None)
    assert tmesh.resolve_mesh("auto", device="cpu").shape == {"data": 1, "model": 1}
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="visible CUDA cards"):
        tmesh.resolve_mesh("auto")


# ---------------------------------------------------------------------------
# dedup merge


def test_dedup_rows_new_generation_wins():
    new = [[("a", 0.9), ("b", 0.5)]]
    old = [[("a", 0.7), ("c", 0.6)]]
    for k in (3, 2, 1):
        assert tctl._dedup_rows(new, old, k) == jctl._dedup_rows(new, old, k)
    rows, dropped = tctl._dedup_rows(new, old, 3)
    assert rows == [[("a", 0.9), ("c", 0.6), ("b", 0.5)]] and dropped == 1


# ---------------------------------------------------------------------------
# migration, all three index families


def _flat_script(P):
    keys, vecs = _rows(300, 16)
    q = _queries(7, 16)
    base = P.knn.DeviceKnnIndex(16, mesh=P.mesh(2), reserved_space=64)
    base.add_batch_arrays(keys, vecs)
    ref = base.search_batch(q, 5)
    idx = P.knn.DeviceKnnIndex(16, mesh=P.mesh(2), reserved_space=64)
    idx.add_batch_arrays(keys, vecs)
    h = P.el.register_handle(idx)
    out = {"ref": ref, "summaries": [], "answers": [], "base": base, "h": h}
    for to in (4, 2, 1):
        s = P.el.reshard(to, chunk_rows=64)
        assert s["to_shards"] == to and s["rows_migrated"] == 300 and s["indexes"] == 1 and s["mttr_s"] > 0
        out["summaries"].append({k: v for k, v in s.items() if k != "mttr_s"})
        assert h.index.n_shards == to
        out["answers"].append(h.search_batch(q, 5))
    out["snap"] = _snapshot(P)
    return out


def test_reshard_flat_grow_shrink_byte_identical():
    got, want = _flat_script(T), _flat_script(J)
    assert got["summaries"] == want["summaries"]
    assert got["summaries"][0]["from_shards"] == 2 and got["summaries"][0]["generation"] == 1
    assert got["snap"] == want["snap"] and got["snap"]["generation"] == 3 and got["snap"]["migration"] is None
    base_rows = _flat_rows(got["base"])
    for answers, ref_answers in zip(got["answers"], want["answers"]):
        assert answers == got["ref"]  # the port, against its never-resharded self: exact
        _same(answers, ref_answers)
    # the rows moved byte for byte
    assert _flat_rows(got["h"].index) == base_rows
    _same(got["ref"], want["ref"])


def _tier_cfg(P, cold):
    return P.tk.TierConfig(cold_dtype=cold, n_clusters=8, n_probe=3)


def _tiered_script(P, cold):
    keys, vecs = _rows(400, 16, seed=1)
    q = _queries(5, 16)

    def build():
        idx = P.tk.TieredKnnIndex(16, mesh=P.mesh(2), reserved_space=128, tiers=_tier_cfg(P, cold))
        idx.add_batch_arrays(keys, vecs)
        return idx

    base = build()
    ref = base.search_batch(q, 5)
    h = P.el.register_handle(build())
    out = {"ref": ref, "answers": [], "hot": sorted(base.hot._slot_of), "cold_total": base._cold_total}
    for to in (4, 2):
        P.el.reshard(to, chunk_rows=64)
        out["answers"].append(h.search_batch(q, 5))
        # hot and cold membership transplant exactly
        assert sorted(h.index.hot._slot_of) == out["hot"] and h.index._cold_total == base._cold_total
        assert h.index.n_shards == to and sum(h.index._cold_docs_shard) == base._cold_total
    out["base"], out["h"] = base, h
    return out


@pytest.mark.parametrize("cold", ["f32", "int8"])
def test_reshard_tiered_byte_identical(cold):
    got, want = _tiered_script(T, cold), _tiered_script(J, cold)
    assert got["hot"] == want["hot"] and got["cold_total"] == want["cold_total"] > 0
    _same(got["ref"], want["ref"])
    for answers, ref_answers in zip(got["answers"], want["answers"]):
        assert answers == got["ref"]
        _same(answers, ref_answers)
    base, new = got["base"], got["h"].index
    assert _flat_rows(new.hot) == _flat_rows(base.hot)
    # the cold bytes moved as stored (codes and scales, or f32 rows)
    for key, slot in base._cold_slot.items():
        a = base._cold.export_rows([slot])
        b = new._cold.export_rows([new._cold_slot[key]])
        assert all(np.array_equal(a[f], b[f]) for f in a if f != "dtype"), key


def _packed_script(P):
    keys, vecs = _rows(120, 16, seed=2)
    q = _queries(5, 16)
    tenants = ("alpha", "beta", "gamma")

    def build():
        idx = P.packed.TenantPackedIndex(16, mesh=P.mesh(2), reserved_space=256)
        for t in tenants:
            idx.add_tenant_batch(t, [f"{t}-{k}" for k in keys], vecs)
        return idx

    base = build()
    refs = {t: base.search_tenant_batch(t, q, 5) for t in tenants}
    h = P.el.register_handle(build())
    answers = []
    for to in (4, 2):
        P.el.reshard(to, chunk_rows=64)
        answers.append({t: h.search_tenant_batch(t, q, 5) for t in tenants})
        assert h.index.n_shards == to
        assert {t: h.index.tenant_docs(t) for t in tenants} == {t: 120 for t in tenants}
    return refs, answers, base, h


def test_reshard_packed_byte_identical():
    got_refs, got, base, h = _packed_script(T)
    want_refs, want, _, _ = _packed_script(J)
    for t in got_refs:
        _same(got_refs[t], want_refs[t])
        for step in range(2):
            assert got[step][t] == got_refs[t]
            _same(got[step][t], want[step][t])
    assert _flat_rows(h.index) == _flat_rows(base)
    # extents re-granted whole on the target, one shard each
    for t, segs in h.index._segments.items():
        for start, size in segs:
            assert start // h.index.shard_capacity == (start + size - 1) // h.index.shard_capacity, (t, segs)


def _cold_tenant_script(P):
    keys, vecs = _rows(80, 8, seed=3)
    idx = P.packed.TenantPackedIndex(8, mesh=P.mesh(2), reserved_space=128)
    idx.add_tenant_batch("hot", [f"h-{k}" for k in keys], vecs)
    idx.add_tenant_batch("cold", [f"c-{k}" for k in keys], vecs)
    idx._demote("cold")
    q = _queries(3, 8)
    ref_hot = idx.search_tenant_batch("hot", q, 4)
    ref_cold = idx.search_tenant_batch("cold", q, 4)
    cold_vecs = idx._cold["cold"]["vecs"].copy()
    h = P.el.register_handle(idx)
    P.el.reshard(4, chunk_rows=32)
    assert "cold" in h.index._cold and "hot" not in h.index._cold
    assert np.array_equal(h.index._cold["cold"]["vecs"], cold_vecs)
    got_hot, got_cold = h.search_tenant_batch("hot", q, 4), h.search_tenant_batch("cold", q, 4)
    assert got_hot == ref_hot and got_cold == ref_cold
    return got_hot, got_cold


def test_reshard_packed_cold_tenant_stays_cold():
    got, want = _cold_tenant_script(T), _cold_tenant_script(J)
    for g, w in zip(got, want):
        _same(g, w)


def _multi_script(P):
    keys, vecs = _rows(100, 8, seed=4)
    a = P.knn.DeviceKnnIndex(8, mesh=P.mesh(2), reserved_space=64)
    a.add_batch_arrays(keys, vecs)
    b = P.tk.TieredKnnIndex(8, mesh=P.mesh(2), reserved_space=64)
    b.add_batch_arrays(keys, vecs)
    ha, hb = P.el.register_handle(a), P.el.register_handle(b)
    summary = P.el.reshard(4, chunk_rows=32)
    assert summary["indexes"] == 2
    assert ha.generation == hb.generation == summary["generation"]
    assert ha.index.n_shards == hb.index.n_shards == 4
    return summary["rows_migrated"], summary["generation"]


def test_reshard_multiple_indexes_one_generation():
    # 100 flat rows, the tiered index's 100 cold payloads and its 64 hot rows
    assert _multi_script(T) == _multi_script(J) == (264, 1)


def _noop_script(P):
    keys, vecs = _rows(20, 8)
    idx = P.knn.DeviceKnnIndex(8, mesh=P.mesh(2), reserved_space=32)
    idx.add_batch_arrays(keys, vecs)
    P.el.register_handle(idx)
    summary = P.el.reshard(2)
    assert summary["indexes"] == 0 and summary["rows_migrated"] == 0
    with pytest.raises(ValueError):
        P.el.reshard(0)
    P.el.reset_registry()
    empty = P.el.reshard(4)
    assert empty["indexes"] == 0
    return summary, empty


def test_reshard_noop_and_validation():
    assert _noop_script(T) == _noop_script(J)


def test_register_handle_idempotent_and_weakref():
    for P in (J, T):
        idx = P.knn.DeviceKnnIndex(8, reserved_space=16, **P.dev)
        h = P.el.register_handle(idx)
        assert P.el.register_handle(h) is h
        assert P.el.handles() == [h]
        assert P.el.current_shards() == 1
        del h
        assert P.el.handles() == []


def test_handle_delegates_like_an_index():
    keys, vecs = _rows(10, 8)
    for P in (J, T):
        idx = P.knn.DeviceKnnIndex(8, reserved_space=16, **P.dev)
        h = P.el.register_handle(idx)
        h.add_batch_arrays(keys, vecs)
        assert len(h) == 10 and h.dim == 8  # __getattr__ delegation
        h.remove("k0")
        assert len(h) == 9 and h.index is idx
    # a single-device index reshards onto a CPU mesh and back onto its device
    h = T.el.handles()[0]
    T.el.reshard(2, chunk_rows=4)
    assert h.index.n_shards == 2 and {str(d) for d in h.index.shard_devices} == {"cpu"}
    T.el.reshard(1, chunk_rows=4)
    assert h.index.n_shards == 1 and h.index.device.type == "cpu" and len(h) == 9


# ---------------------------------------------------------------------------
# writes under migration + fencing


def _writes_script(P):
    keys, vecs = _rows(200, 8, seed=5)
    idx = P.knn.DeviceKnnIndex(8, mesh=P.mesh(2), reserved_space=64)
    idx.add_batch_arrays(keys, vecs)
    h = P.el.register_handle(idx)
    stop = threading.Event()
    wrote = []

    def writer():
        rng = np.random.default_rng(6)
        i = 0
        while not stop.is_set() and i < 400:
            h.add(f"w{i}", rng.normal(size=(8,)).astype("float32"))
            wrote.append(f"w{i}")
            i += 1
            time.sleep(0.0005)

    t = threading.Thread(target=writer)
    t.start()
    try:
        P.el.reshard(4, chunk_rows=16)
    finally:
        stop.set()
        t.join()
    # every write before or racing the reshard's return is in the new generation
    missing = [k for k in wrote if k not in h.index._slot_of]
    assert not missing, f"dropped writes: {missing[:5]}"
    assert len(h.index) == 200 + len(wrote) and h.index.n_shards == 4
    return wrote, h


def test_writes_during_migration_survive_cutover():
    for P in (J, T):
        _writes_script(P)
        _reset(P)
    # the rows the writer added through the handle equal a fresh add's
    wrote, h = _writes_script(T)
    rng = np.random.default_rng(6)
    twin = tknn.DeviceKnnIndex(8, reserved_space=64, device="cpu")
    twin.add_batch_arrays(wrote, rng.normal(size=(len(wrote), 8)).astype("float32"))
    got = _flat_rows(h.index)
    assert all(got[k] == v for k, v in _flat_rows(twin).items())


def _removes_script(P):
    keys, vecs = _rows(400, 8, seed=21)
    idx = P.knn.DeviceKnnIndex(8, mesh=P.mesh(2), reserved_space=64)
    idx.add_batch_arrays(keys, vecs)
    h = P.el.register_handle(idx)
    errors: list[BaseException] = []

    def remover():
        for _ in range(3):
            for i in range(200):
                try:
                    h.remove(f"k{i}")
                except BaseException as exc:  # pragma: no cover
                    errors.append(exc)
                    return

    t = threading.Thread(target=remover)
    t.start()
    try:
        summary = P.el.reshard(4, chunk_rows=16)
    finally:
        t.join(timeout=30.0)
    assert not errors, f"writer died: {errors[0]!r}"
    assert summary["to_shards"] == 4 and len(h) == 200
    got = {k for row in h.search_batch(_queries(4, 8), 200) for k, _ in row}
    assert not {f"k{i}" for i in range(200)} & got
    return h.search_batch(_queries(4, 8), 10)


def test_removes_during_migration_do_not_abort():
    # once every remove has landed, both packages hold the same 200 rows
    _same(_removes_script(T), _removes_script(J))


def _fence_script(P):
    h = _built_handle(P, n=50, seed=7)
    old = h.index
    P.el.reshard(4, chunk_rows=32)
    with pytest.raises(P.knn.StaleGeneration):
        old.add_batch_arrays(["zz"], np.zeros((1, 8), dtype="float32"))
    with pytest.raises(P.knn.StaleGeneration):
        old.remove("k0")
    # reads against the fenced generation still work (drain in flight)
    reads = old.search_batch(_queries(1, 8), 3)
    assert reads and old.generation == h.generation == 1
    return P.el.ELASTIC_METRICS.snapshot()["fenced_writes_total"], reads


def test_fence_raises_stale_generation():
    (got_n, got), (want_n, want) = _fence_script(T), _fence_script(J)
    assert got_n == want_n == 2
    _same(got, want)
    h = _built_handle(T, n=8, seed=1)
    with pytest.raises(tknn.StaleGeneration):
        old = h.index
        T.el.reshard(4, chunk_rows=32)
        old.add_batch_device(["zz"], tknn.torch.zeros((1, 8)))


def _fence_tiered_script(P):
    keys, vecs = _rows(60, 8, seed=8)
    idx = P.tk.TieredKnnIndex(8, mesh=P.mesh(2), reserved_space=32)
    idx.add_batch_arrays(keys, vecs)
    h = P.el.register_handle(idx)
    old = h.index
    P.el.reshard(4, chunk_rows=32)
    with pytest.raises(P.knn.StaleGeneration):
        old.add_batch_arrays(["zz"], np.zeros((1, 8), dtype="float32"))
    # dual-serve window dedups; after end_cutover the handle serves new only
    assert h._dual is None
    q = _queries(2, 8)
    h._dual = old  # the cutover window
    rows = h.search_batch(q, 4)
    h._dual = None
    assert all(len(r) <= 4 for r in rows)
    keys_seen = [k for row in rows for k, _ in row]
    assert len(keys_seen) == len(set(keys_seen)), "double answer leaked"
    return rows, P.el.ELASTIC_METRICS.snapshot()["dedup_dropped_total"]


def test_fence_tiered_and_dedup_window():
    (got, got_dropped), (want, want_dropped) = _fence_tiered_script(T), _fence_tiered_script(J)
    _same(got, want)
    assert got_dropped == want_dropped == 8


# ---------------------------------------------------------------------------
# chaos at every boundary


def _chaos_chunks_script(P):
    h = _built_handle(P)
    q = _queries(4, 8)
    ref = h.search_batch(q, 5)
    n_chunks = -(-150 // 32)
    for hit in range(1, n_chunks + 1):
        P.chaos.activate([{"site": "elastic.migrate_chunk", "action": "raise", "hit": hit}])
        with pytest.raises(P.chaos.ChaosInjected):
            P.el.reshard(4, chunk_rows=32)
        P.chaos.deactivate()
        # rollback: the old generation untouched, still serving, not migrating
        assert h.index.n_shards == 2 and h.search_batch(q, 5) == ref
        assert not h._migrating and h._dual is None
    assert P.el.ELASTIC_METRICS.snapshot()["rollbacks_total"] == n_chunks
    # a retried reshard completes byte-identically
    P.el.reshard(4, chunk_rows=32)
    assert h.index.n_shards == 4 and h.search_batch(q, 5) == ref
    return ref, _snapshot(P)


def test_chaos_raise_at_every_chunk_boundary():
    (got, got_snap), (want, want_snap) = _chaos_chunks_script(T), _chaos_chunks_script(J)
    _same(got, want)
    assert got_snap == want_snap


def _chaos_cutover_script(P):
    h = _built_handle(P, seed=10)
    q = _queries(4, 8)
    ref = h.search_batch(q, 5)
    P.chaos.activate([{"site": "elastic.cutover", "action": "raise"}])
    with pytest.raises(P.chaos.ChaosInjected):
        P.el.reshard(4, chunk_rows=32)
    P.chaos.deactivate()
    assert h.index.n_shards == 2 and h.search_batch(q, 5) == ref
    P.el.reshard(4, chunk_rows=32)
    assert h.search_batch(q, 5) == ref
    return ref


def test_chaos_raise_at_cutover_rolls_back():
    _same(_chaos_cutover_script(T), _chaos_cutover_script(J))


def test_chaos_raise_during_abort_does_not_mask():
    for P in (J, T):
        h = _built_handle(P, seed=11)
        P.chaos.activate([{"site": "elastic.cutover", "action": "raise"},
                          {"site": "elastic.abort", "action": "raise"}])
        with pytest.raises(P.chaos.ChaosInjected, match="elastic.cutover"):
            P.el.reshard(4, chunk_rows=32)
        P.chaos.deactivate()
        assert h.index.n_shards == 2 and not h._migrating
    assert {"elastic.migrate_chunk", "elastic.cutover", "elastic.abort"} <= set(tchaos.registered_sites("elastic"))


# ---------------------------------------------------------------------------
# durable intent + SIGKILL recovery (child processes)


def _mk_persistence(P, root):
    backend = P.pw.persistence.Backend.filesystem(str(root))
    return P.pers.EnginePersistence(P.pw.persistence.Config.simple_config(backend))


def test_reshard_intent_roundtrip(tmp_path):
    for P in (J, T):
        root = tmp_path / P.name
        p = _mk_persistence(P, root)
        assert p.reshard_intent() is None
        p.record_reshard_intent(4, 7)
        assert p.reshard_intent() == (4, 7)
        p.record_reshard_intent(2, 9)  # a single-record log: the last wins
        p.close()
        p2 = _mk_persistence(P, root)
        assert p2.reshard_intent() == (2, 9)
        p2.clear_reshard_intent()
        assert p2.reshard_intent() is None
        p2.close()
        assert _mk_persistence(P, root).reshard_intent() is None


def test_reshard_clears_intent_and_bumps_generation(tmp_path):
    out = []
    for P in (J, T):
        p = _mk_persistence(P, tmp_path / P.name)
        P.el.register_persistence(p)
        h = _built_handle(P, n=60, seed=12)
        gen0 = p.cluster_generation()
        summary = P.el.reshard(4, chunk_rows=32)
        assert summary["generation"] == p.cluster_generation() == h.generation == gen0 + 1
        assert p.reshard_intent() is None
        out.append((gen0, summary["rows_migrated"]))
    assert out[0] == out[1]


def test_rollback_clears_intent(tmp_path):
    for P in (J, T):
        p = _mk_persistence(P, tmp_path / P.name)
        P.el.register_persistence(p)
        h = _built_handle(P, n=60, seed=13)
        P.chaos.activate([{"site": "elastic.cutover", "action": "raise"}])
        with pytest.raises(P.chaos.ChaosInjected):
            P.el.reshard(4, chunk_rows=32)
        P.chaos.deactivate()
        assert p.reshard_intent() is None and h.index.n_shards == 2


def _recover_script(P, root):
    p = _mk_persistence(P, root)
    P.el.register_persistence(p)
    h = _built_handle(P, n=60, seed=14)
    q = _queries(3, 8)
    ref = h.search_batch(q, 4)
    # a crash that left the intent behind
    p.record_reshard_intent(4, p.cluster_generation() + 1)
    out = P.el.recover_pending_reshard(complete=True)
    assert out is not None and out["to_shards"] == 4 and out["rows_migrated"] == 60
    assert h.index.n_shards == 4 and h.search_batch(q, 4) == ref
    assert p.reshard_intent() is None
    assert P.el.recover_pending_reshard() is None  # idempotent: nothing pends
    return ref


def test_recover_pending_reshard_completes(tmp_path):
    _same(_recover_script(T, tmp_path / "t"), _recover_script(J, tmp_path / "j"))


def test_recover_pending_reshard_rollback(tmp_path):
    for P in (J, T):
        p = _mk_persistence(P, tmp_path / P.name)
        P.el.register_persistence(p)
        h = _built_handle(P, n=40, seed=15)
        p.record_reshard_intent(4, p.cluster_generation() + 1)
        assert P.el.recover_pending_reshard(complete=False) is None
        assert h.index.n_shards == 2 and p.reshard_intent() is None  # formally rolled back
        assert P.el.ELASTIC_METRICS.snapshot()["rollbacks_total"] == 1


ELASTIC_KILL_PROGRAM = textwrap.dedent(
    """
    import json, os
    import numpy as np
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import elastic
    from pathway_tpu_torch.engine.persistence import EnginePersistence
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.parallel.mesh import resolve_mesh

    backend = pw.persistence.Backend.filesystem(os.environ["EL_STORE"])
    p = EnginePersistence(pw.persistence.Config.simple_config(backend))
    rng = np.random.default_rng(42)
    keys = [f"k{i}" for i in range(120)]
    vecs = rng.normal(size=(120, 8)).astype("float32")
    q = rng.normal(size=(4, 8)).astype("float32")
    idx = DeviceKnnIndex(8, mesh=resolve_mesh(2, device="cpu"), reserved_space=64)
    idx.add_batch_arrays(keys, vecs)
    h = elastic.register_handle(idx)
    out = {}
    if os.environ["EL_PHASE"] == "crash":
        elastic.reshard(4, chunk_rows=32)  # the chaos kill fires mid-migration
        out = {"unreachable": True}
    else:
        # the restart: the index rebuilt (re-added above), the intent resolved
        out["intent"] = p.reshard_intent()
        out["recovered"] = elastic.recover_pending_reshard(complete=True) is not None
        out["n_shards"] = h.index.n_shards
        out["results"] = h.search_batch(q, 5)
        out["generation"] = h.generation
    with open(os.environ["EL_OUT"], "w") as f:
        json.dump(out, f)
    """
)


@pytest.mark.parametrize(
    "site,hit", [("elastic.migrate_chunk", 1), ("elastic.migrate_chunk", 3), ("elastic.cutover", 1)]
)
def test_sigkill_at_boundary_recovers_byte_identical(tmp_path, site, hit):
    """A chaos SIGKILL at a chunk or cutover boundary; a restarted process
    finds the durable intent and completes the reshard, answering as an
    index that was never killed (the never-resharded port index exactly,
    the reference's within the tolerance)."""
    prog = tmp_path / "prog.py"
    prog.write_text(ELASTIC_KILL_PROGRAM)
    env = dict(os.environ, EL_STORE=str(tmp_path / "pstore"), EL_OUT=str(tmp_path / "out.json"),
               CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    crash = subprocess.run([sys.executable, str(prog)], timeout=240, capture_output=True, text=True,
                           env=dict(env, EL_PHASE="crash",
                                    PATHWAY_CHAOS=json.dumps([{"site": site, "action": "kill", "hit": hit}])))
    assert crash.returncode == -signal.SIGKILL, crash.stderr[-2000:]
    assert not (tmp_path / "out.json").exists()
    subprocess.run([sys.executable, str(prog)], env=dict(env, EL_PHASE="recover"), check=True, timeout=240)
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["intent"] is not None and out["intent"][0] == 4, "durable intent lost in the crash"
    assert out["recovered"] and out["n_shards"] == 4 and out["generation"] == out["intent"][1] + 1
    rng = np.random.default_rng(42)
    keys = [f"k{i}" for i in range(120)]
    vecs = rng.normal(size=(120, 8)).astype("float32")
    q = rng.normal(size=(4, 8)).astype("float32")
    got = [[(k, s) for k, s in row] for row in out["results"]]
    for P in (T, J):
        ref_idx = P.knn.DeviceKnnIndex(8, mesh=P.mesh(2), reserved_space=64)
        ref_idx.add_batch_arrays(keys, vecs)
        ref = ref_idx.search_batch(q, 5)
        if P is T:
            assert got == [[(k, s) for k, s in row] for row in ref]
        else:
            _same(got, ref)


# ---------------------------------------------------------------------------
# watermark controller


def _ledger_snapshots(P, monkeypatch, *readings, budget=1000, stranded=None):
    ledger = _mod(P, "internals.ledger")
    it = iter(readings) if len(readings) > 1 else None

    def snap():
        return {"total_bytes": next(it) if it is not None else readings[0], "budget_bytes": budget}

    monkeypatch.setattr(ledger.LEDGER, "snapshot", snap)
    if stranded is not None:
        chip = _mod(P, "internals.chip_ledger")
        monkeypatch.setattr(chip.CHIP_LEDGER, "snapshot", lambda *a, **k: {"stranded_fraction": stranded})


def test_controller_fixed_target_reshards_once():
    for P in (J, T):
        h = _built_handle(P, n=60, seed=16)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(shards=4, cooldown_s=0, chunk_rows=32))
        assert ctl.evaluate_once() == "target" and h.index.n_shards == 4
        assert ctl.evaluate_once() is None  # at the target now


def test_controller_hbm_watermark_grows(monkeypatch):
    for P in (J, T):
        h = _built_handle(P, n=60, seed=17)
        _ledger_snapshots(P, monkeypatch, 950)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(hbm_frac=0.9, cooldown_s=0, chunk_rows=32))
        assert ctl.evaluate_once() == "hbm_watermark" and h.index.n_shards == 4
    assert T.el.ELASTIC_METRICS.snapshot()["reshards"] == {"hbm_watermark": 1}


def test_controller_time_to_oom_grows(monkeypatch):
    for P in (J, T):
        h = _built_handle(P, n=60, seed=18)
        _ledger_snapshots(P, monkeypatch, 100, 500_000, budget=1_000_000)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(oom_warn_s=10_000.0, cooldown_s=0, chunk_rows=32))
        assert ctl.evaluate_once() is None  # the first sample only primes the rate
        assert ctl.evaluate_once() == "time_to_oom" and h.index.n_shards == 4


def test_controller_stranded_shrinks(monkeypatch):
    for P in (J, T):
        h = _built_handle(P, n=60, seed=19)
        _ledger_snapshots(P, monkeypatch, 10, stranded=0.9)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(stranded_frac=0.5, cooldown_s=0, chunk_rows=32))
        assert ctl.evaluate_once() == "stranded_chip_time" and h.index.n_shards == 1
    assert T.el.handles()[0].index.device.type == "cpu"


def test_controller_auto_shrinks_on_low_footprint(monkeypatch):
    for P in (J, T):
        h = _built_handle(P, n=60, seed=20)
        _ledger_snapshots(P, monkeypatch, 1)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(auto=True, cooldown_s=0, chunk_rows=32))
        assert ctl.evaluate_once() == "footprint_shrunk" and h.index.n_shards == 1


def test_controller_cooldown_throttles(monkeypatch):
    for P in (J, T):
        h = _built_handle(P, n=40, seed=21)
        _ledger_snapshots(P, monkeypatch, 950)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(hbm_frac=0.9, max_shards=8, cooldown_s=3600, chunk_rows=32))
        assert ctl.evaluate_once() == "hbm_watermark" and h.index.n_shards == 4
        assert ctl.evaluate_once() is None  # the cooldown holds the second grow


def test_controller_idle_without_handles():
    for P in (J, T):
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(auto=True))
        assert ctl.evaluate_once() is None
        ctl.start()
        ctl.start()  # idempotent
        time.sleep(0.05)
        ctl.stop()
        assert ctl._thread is None


def test_controller_reshard_failure_is_contained(monkeypatch):
    from pathway_tpu_torch.internals import flight_recorder

    for P in (J, T):
        h = _built_handle(P, n=40, seed=22)
        ctl = P.ctl.ElasticController(P.el.ElasticConfig(shards=4, cooldown_s=0))
        monkeypatch.setattr(P.ctl, "reshard", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        assert ctl.evaluate_once() is None  # swallowed, recorded, no raise
        assert h.index.n_shards == 2
    assert any(e.get("kind") == "elastic.reshard_failed" for e in flight_recorder.RECORDER.events())
    # a target the cards cannot hold raises before any state is touched
    monkeypatch.undo()
    h = _built_handle(T, n=40, seed=22)
    tmesh.set_device_pool(["cpu"] * 2)
    with pytest.raises(ValueError, match="device pool holds 2"):
        T.el.reshard(4)
    assert h.index.n_shards == 2 and not h._migrating and not T.el.ELASTIC_METRICS.active()


# ---------------------------------------------------------------------------
# admission + Retry-After


def _retry_after_script(P):
    ch = P.cluster.ClusterHealth()
    out = [ch.retry_after_s()]  # the constant fallback
    ch.mark_down([0], eta_s=5.0)  # a declared ETA decays with elapsed time
    ra = ch.retry_after_s()
    assert 4.0 < ra <= 5.0
    ch.mark_all_up()
    ch.mark_down([0])  # the learned outage length while down without an ETA
    ra = ch.retry_after_s()
    assert 0.1 <= ra <= 1.0
    ch.mark_all_up()
    ch.set_eta_source(lambda: 7.5)  # a live ETA source wins over everything
    out.append(ch.retry_after_s())
    ch.set_eta_source(lambda: None)  # the source declines: the fallback
    assert ch.retry_after_s() >= 0.1
    return out


def test_retry_after_precedence():
    assert _retry_after_script(T) == _retry_after_script(J) == [1.0, 7.5]


def test_retry_after_uses_migration_eta():
    for P in (J, T):
        ch = P.cluster.ClusterHealth()
        ch.set_eta_source(P.el.ELASTIC_METRICS.migration_eta_s)
        P.el.ELASTIC_METRICS.migration_begin(10, 2, 4)
        for _ in range(5):
            P.el.ELASTIC_METRICS.record_chunk(10)
        assert ch.retry_after_s() >= 0.1  # five chunks left at the observed pace
        P.el.ELASTIC_METRICS.record_cutover(1, 0.5, "test")
        assert P.el.ELASTIC_METRICS.migration_eta_s() is None


def test_admission_degrades_during_migration():
    for P in (J, T):
        serving = _mod(P, "serving")
        ac = serving.admission.AdmissionController(serving.ServingConfig(shed="degrade", max_queue=8))
        P.el.ELASTIC_METRICS.migration_begin(4, 2, 4)
        try:
            ticket = ac.admit()
            assert ticket.degraded, "a migration in flight must degrade, not reject"
            ac.release(ticket)
        finally:
            P.el.ELASTIC_METRICS.record_cutover(1, 0.1, "test")
        ticket = ac.admit()
        assert not ticket.degraded
        ac.release(ticket)
    # the port's full queue during a migration answers with the migration ETA
    serving = _mod(T, "serving")
    ac = serving.admission.AdmissionController(serving.ServingConfig(shed="degrade", max_queue=1))
    prev = tcluster.CLUSTER_HEALTH._eta_source
    tcluster.CLUSTER_HEALTH.set_eta_source(lambda: 3.25)
    T.el.ELASTIC_METRICS.migration_begin(4, 2, 4)
    try:
        held = ac.admit()
        with pytest.raises(serving.QueueFull) as exc:
            ac.admit()
        assert exc.value.retry_after_s == 3.25
        ac.release(held)
    finally:
        tcluster.CLUSTER_HEALTH._eta_source = prev
        T.el.ELASTIC_METRICS.record_cutover(1, 0.1, "test")


# ---------------------------------------------------------------------------
# metrics / status surfaces


def _scrape_script(P):
    monitoring = _mod(P, "internals.http_monitoring")
    assert not P.el.ELASTIC_METRICS.active() and monitoring.MonitoringHttpServer._elastic_lines() == []
    h = _built_handle(P, n=40, seed=23)
    P.el.reshard(4, chunk_rows=32)
    assert h.index.n_shards == 4 and P.el.ELASTIC_METRICS.active()
    lines = monitoring.MonitoringHttpServer._elastic_lines()
    return [ln for ln in lines if not ln.startswith("pathway_elastic_last_mttr_seconds")]


def test_elastic_metrics_scrape_appears_after_first_reshard():
    got = _scrape_script(T)
    assert got == _scrape_script(J)
    body = "\n".join(got)
    for name in ("pathway_elastic_reshards_total", "pathway_elastic_cutovers_total", "pathway_elastic_generation"):
        assert name in body
    assert 'reason="manual"' in body
    # /status carries the same registry's block, and /metrics the same lines
    from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer
    from pathway_tpu_torch.internals.monitoring import StatsMonitor

    server = MonitoringHttpServer(StatsMonitor(), port=0)
    assert json.loads(server._status())["elastic"] == T.el.ELASTIC_METRICS.snapshot()
    assert "pathway_elastic_rows_migrated_total 40" in server._prometheus()


def test_flight_events_for_reshard():
    kinds = {}
    for P in (J, T):
        fr = _mod(P, "internals.flight_recorder")
        fr.RECORDER.clear()
        h = _built_handle(P, n=40, seed=24)
        P.el.reshard(4, chunk_rows=32)
        assert h.index.n_shards == 4
        kinds[P.name] = [e.get("kind") for e in fr.RECORDER.events() if str(e.get("kind")).startswith("elastic.")]
    assert kinds["torch"] == kinds["jax"]
    assert {"elastic.reshard_begin", "elastic.cutover", "elastic.reshard_done"} <= set(kinds["torch"])


def test_reshard_span_recorded():
    for P in (J, T):
        store = _mod(P, "tracing.store")
        prev = store.set_tracing_enabled(True)
        store.TRACE_STORE.reset()
        try:
            h = _built_handle(P, n=40, seed=25)
            P.el.reshard(4, chunk_rows=32)
            assert h.index.n_shards == 4
            spans = [s for s in store.TRACE_STORE.recent_spans() if s.get("stage") == "elastic.reshard"]
            assert spans, "no elastic.reshard span"
            attrs = spans[-1]["attrs"]
            assert (attrs["from_shards"], attrs["to_shards"], attrs["generation"], attrs["reason"]) == (
                2, 4, 1, "manual")
        finally:
            store.set_tracing_enabled(prev)
            store.TRACE_STORE.reset()


# ---------------------------------------------------------------------------
# the elastic plane and a multi-process cluster


def _cluster_fence_script(P, root, monkeypatch):
    """Form a 2-process ``CoordinatorCluster`` in this process against a
    hand-driven worker socket, reshard a registered index, then send one
    frame stamped with the old generation and one with the new."""
    import socket

    mp = _mod(P, "parallel.multiprocess")
    monkeypatch.setenv("PATHWAY_CLUSTER_TOKEN", "elastic-cluster-test")
    P.el.register_persistence(_mk_persistence(P, root))
    h = _built_handle(P, n=60, seed=26)
    engine = _mod(P, "internals.graph_runner").GraphRunner().engine
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    box = {}

    def form():
        box["cluster"] = mp.CoordinatorCluster([engine], processes=2, first_port=port, accept_timeout=30.0, lease_ms=0)

    former = threading.Thread(target=form)
    former.start()
    deadline = time.monotonic() + 30
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
            break
        except OSError:
            assert time.monotonic() < deadline, "the coordinator never listened"
            time.sleep(0.05)
    try:
        mp._send_json(sock, {"op": "hello", "pid": 1, "threads": 1, "sig": mp._graph_sig(engine),
                             "token": "elastic-cluster-test", "replay_frontier": -1, "gen": 0})
        welcome = mp._recv_json(sock)
        former.join(timeout=30)
        cluster = box["cluster"]
        gen0 = cluster.generation
        summary = P.el.reshard(4, chunk_rows=32)
        gen1 = cluster.generation
        metrics = P.cluster.CLUSTER_METRICS
        mp._send(sock, {"op": "reply", "gen": gen0, "seq": 1})  # a frame of the old generation
        with pytest.raises(P.cluster.WorkerLost, match="stale generation"):
            cluster._recv_worker(1)
        fenced = metrics.snapshot()["fenced_writes_total"]
        mp._send(sock, {"op": "ok", "gen": gen1, "seq": 2})
        accepted = cluster._recv_worker(1)["op"]
        cluster._close_conns(None)
    finally:
        sock.close()
        P.cluster.CLUSTER_METRICS.reset()
    assert h.index.n_shards == 4
    return [welcome["op"], welcome["gen"], gen0, gen1, summary["generation"], fenced, accepted]


def test_reshard_under_a_registered_cluster_advances_its_generation(tmp_path, monkeypatch):
    """A coordinator registers with the elastic plane at formation; a
    reshard's cutover advances the live cluster's generation by one, and a
    frame stamped with the old generation is then fenced (the sender is
    retired as a zombie) while one of the new generation is accepted, as in
    the reference."""
    got = _cluster_fence_script(T, tmp_path / "torch", monkeypatch)
    assert got == _cluster_fence_script(J, tmp_path / "jax", monkeypatch)
    assert got == ["welcome", 0, 0, 1, 1, 1, "ok"]


CLUSTER_RESHARD_PROGRAM = textwrap.dedent(
    """
    import json, os, threading
    import numpy as np
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.parallel.mesh import set_device_pool
    from pathway_tpu_torch.resilience.cluster import CLUSTER_METRICS

    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    NPROC = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    N, PER, RESHARD_AT = 96, 8, int(os.environ["RESHARD_AT"])
    set_device_pool(["cpu"] * 2)
    vecs = np.random.default_rng(5).normal(size=(N, 8)).astype(np.float32)
    h = pw.elastic.register_handle(pw.DeviceKnnIndex(8, reserved_space=128, metric="cos", device="cpu"))
    cv = threading.Condition()
    state = {"rows": 0, "pending": [], "gen": []}

    class Docs(pw.io.python.ConnectorSubject):
        def run(self):
            for b in range(0, N, PER):
                for i in range(b, b + PER):
                    self.next(doc_id=i, v=tuple(float(x) for x in vecs[i]))
                self.commit()
                with cv:
                    while state["rows"] < b + PER and not self._ctx.wait_stopped(0):
                        cv.wait(0.05)

    class S(pw.Schema):
        doc_id: int
        v: tuple

    docs = pw.io.python.read(Docs(), schema=S, autocommit_duration_ms=None)
    keyed = docs.groupby(pw.this.doc_id).reduce(pw.this.doc_id, v=pw.reducers.any(pw.this.v))
    embedded = keyed.select(pw.this.doc_id, v=pw.apply(lambda v: tuple(2.0 * x for x in v), pw.this.v))

    def on_row(key, row, time, is_addition):
        state["pending"].append((row["doc_id"], row["v"]))

    def on_epoch_end(time):
        batch, state["pending"] = state["pending"], []
        if batch:
            h.add_batch_arrays([k for k, _ in batch], np.asarray([v for _, v in batch], np.float32))
        if 0 < RESHARD_AT <= state["rows"] + len(batch) and not state["gen"]:
            state["gen"].append(CLUSTER_METRICS.snapshot()["generation"])
            pw.elastic.reshard(2, chunk_rows=16)
            state["gen"].append(CLUSTER_METRICS.snapshot()["generation"])
        with cv:
            state["rows"] += len(batch)
            cv.notify_all()

    pw.io.subscribe(embedded, on_row, on_time_end=on_epoch_end)
    pw.run(monitoring_level="none", persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.environ["STORE"])))
    if PID == 0:
        hits = h.search_batch(vecs[:12] * 2.0, 5)
        snap = CLUSTER_METRICS.snapshot()
        with open(os.environ["OUT"], "w") as f:
            json.dump({"hits": [[[int(k), float(s)] for k, s in row] for row in hits], "gen": state["gen"],
                       "shards": h.index.n_shards, "rows": len(h), "final_gen": snap["generation"],
                       "fenced": snap["fenced_writes_total"], "partial": snap["partial_restarts_total"]}, f)
    """
)


def _cluster_reshard_run(tmp_path, tag: str, processes: int, reshard_at: int) -> dict:
    import socket

    prog = tmp_path / "cluster_reshard.py"
    prog.write_text(CLUSTER_RESHARD_PROGRAM)
    for attempt in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_")}
        env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), PATHWAY_PROCESSES=str(processes),
                   PATHWAY_FIRST_PORT=str(port), PATHWAY_CLUSTER_TOKEN="elastic-cluster-test",
                   PATHWAY_CLUSTER_LEASE_MS="2000", PATHWAY_FLIGHT_RECORDER_DIR=str(tmp_path / "blackbox"),
                   RESHARD_AT=str(reshard_at), STORE=str(tmp_path / f"store_{tag}"),
                   OUT=str(tmp_path / f"{tag}.json"))
        procs = [subprocess.Popen([sys.executable, str(prog)], env={**env, "PATHWAY_PROCESS_ID": str(pid)},
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for pid in range(processes)]
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=180)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if all(p.returncode == 0 for p in procs):
            with open(tmp_path / f"{tag}.json") as f:
                return json.load(f)
        if attempt == 2 or "ddress already in use" not in errs[0]:
            raise AssertionError("\n".join(f"rc={p.returncode}\n{e[-3000:]}" for p, e in zip(procs, errs)))
    raise AssertionError("unreachable")


def test_reshard_inside_a_live_two_process_run(tmp_path):
    """Process 0 of a live 2-process run reshards its registered index
    1 -> 2 once half the documents are in (the worker embeds its key
    shards meanwhile): the cluster's generation goes 0 -> 1 at the cutover,
    the worker adopts it, so no frame is fenced and no partial restart
    happens, and the answers equal a single-process twin's that never
    resharded (keys exact, scores at 1e-5)."""
    twin = _cluster_reshard_run(tmp_path, "twin", 1, 0)
    got = _cluster_reshard_run(tmp_path, "cluster", 2, 48)
    assert got["gen"] == [0, 1] and got["final_gen"] == 1
    assert (got["fenced"], got["partial"]) == (0, 0)
    assert (got["shards"], got["rows"]) == (2, 96) and (twin["shards"], twin["rows"]) == (1, 96)
    assert [[k for k, _ in r] for r in got["hits"]] == [[k for k, _ in r] for r in twin["hits"]]
    for g, w in zip(got["hits"], twin["hits"]):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=SCORE_TOL, atol=SCORE_TOL)
    assert [r[0][0] for r in got["hits"]] == list(range(12))
