"""The port's mesh index against the JAX package, on the CPU: the port's
meshes are lists of CPU devices (``resolve_mesh(n, device="cpu")``), the
reference's the eight virtual CPU devices of ``tests/conftest.py``.

* ``knn_topk_sharded`` (the port's plain version, which its wrapper takes
  for CPU shards) against ``pathway_tpu.ops.pallas_knn.knn_topk_sharded`` in
  interpret mode on an 8-device mesh;
* ``DeviceKnnIndex(mesh=)`` against the reference's mesh index and the
  port's unsharded index: churn, growth from 64 rows a shard (the slot
  remap: both packages hand out the same global slots), ``add_batch_device``,
  ``search_dispatch``/``search_resolve``, filtered search with refill;
* mesh specs, ``make_mesh``'s choice of the model axis, the run-scoped mesh.

Ids are compared exactly and scores at 1e-5, never bitwise: the reference's
own shard-local sums round differently from its unsharded scan in the last
place (``tests/test_mesh_index.py``'s bitwise comparisons fail for that alone).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import pathway_tpu_torch as tpw
from pathway_tpu.ops.knn import DeviceKnnIndex as JIndex
from pathway_tpu.ops.pallas_knn import knn_topk_sharded as jknn_topk_sharded
from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu.parallel.sharding import make_mesh as jmake_mesh
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.ops.knn import DeviceKnnIndex as TIndex
from pathway_tpu_torch.ops.knn_topk import NEG, knn_topk_reference, knn_topk_sharded
from pathway_tpu_torch.parallel import mesh as tmesh
from pathway_tpu_torch.parallel.sharding import DeviceMesh, host_mesh_from_env, make_mesh

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clear_port_graph():
    tpw.clear_graph()
    yield
    tpw.clear_graph()


def _cpu_mesh(n=8):
    return tmesh.resolve_mesh(n, device="cpu")


# ------------------------------------------------------- knn_topk_sharded


def _sharded_case(case):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(7, 32)).astype(np.float32)
    d = rng.normal(size=(1024, 32)).astype(np.float32)
    valid = np.ones(1024, bool)
    factor = 1.0
    if case == "few_live":  # fewer live rows than k, spread over three shards
        valid[:] = False
        valid[[3, 300, 301, 900]] = True
    else:
        valid[5] = valid[700] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    if case == "l2":
        factor = 2.0
        bias = bias - (d * d).sum(axis=1)
    return q, d, bias.astype(np.float32), factor


@pytest.mark.parametrize("case", ["cos", "l2", "few_live"])
def test_knn_topk_sharded_matches_reference_kernel(case):
    q, d, bias, factor = _sharded_case(case)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    dd = jax.device_put(d, NamedSharding(mesh, P("data", None)))
    bb = jax.device_put(bias, NamedSharding(mesh, P("data")))
    jv, ji = jknn_topk_sharded(jnp.asarray(q), dd, bb, k=9, mesh=mesh, factor=factor, block_q=8, block_n=64,
                               interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    shards = list(torch.from_numpy(d).chunk(8))
    tv, ti = knn_topk_sharded(torch.from_numpy(q), shards, list(torch.from_numpy(bias).chunk(8)), k=9, factor=factor)
    tv, ti = tv.numpy(), ti.numpy()
    live = jv > NEG / 2
    np.testing.assert_array_equal(tv > NEG / 2, live)
    np.testing.assert_array_equal(ti[live], ji[live])
    np.testing.assert_allclose(tv[live], jv[live], **TOL)
    # the dead tail: (NEG, -1) in the port (the reference repeats real rows there)
    assert (tv[~live] == NEG).all() and (ti[~live] == -1).all()
    if case == "few_live":
        assert live.sum(axis=1).tolist() == [4] * 7
    # and the same as one unsharded top-k over the whole slab
    rv, ri = knn_topk_reference(torch.from_numpy(q), torch.from_numpy(d), k=9, bias=torch.from_numpy(bias),
                                factor=factor)
    np.testing.assert_array_equal(ti, ri.numpy())
    np.testing.assert_allclose(tv, rv.numpy(), **TOL)


def test_knn_topk_sharded_ties_go_to_the_lower_global_row():
    """Equal rows in every shard: the shard-major order decides, as
    ``lax.top_k`` over the shard-major concatenation does."""
    d = torch.ones(4 * 16, 8)
    tv, ti = knn_topk_sharded(torch.ones(2, 8), list(d.chunk(4)), list(torch.zeros(64).chunk(4)), k=20)
    assert ti.tolist() == [list(range(20))] * 2 and (tv == 8.0).all()
    with pytest.raises(ValueError, match="equal length"):
        knn_topk_sharded(torch.ones(1, 8), [d[:16], d[:8]], [torch.zeros(16), torch.zeros(8)], k=4)


# ---------------------------------------------------------- the mesh index


def _triple(metric, reserved=512):
    """(port mesh index, reference mesh index, port unsharded index)."""
    return (
        TIndex(dim=16, metric=metric, reserved_space=reserved, mesh=_cpu_mesh()),
        JIndex(dim=16, metric=metric, reserved_space=reserved, mesh=jmesh.resolve_mesh(8)),
        TIndex(dim=16, metric=metric, reserved_space=reserved, device="cpu"),
    )


def _assert_same(got, want):
    assert [[k for k, _ in row] for row in got] == [[k for k, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], **TOL)


@pytest.mark.parametrize("metric", ["cos", "l2", "ip"])
def test_mesh_index_under_churn_and_growth(metric):
    """Adds (with searches between them, so growth happens on resident
    slabs), removes and re-adds through growth from 64 rows a shard: the
    port hands out the reference's global slots and answers as both the
    reference's mesh index and its own unsharded index do."""
    rng = np.random.default_rng(7)
    tm, jm, tu = _triple(metric)
    assert tm.shard_capacity == jm.shard_capacity == 64
    vecs = rng.normal(size=(1200, 16)).astype(np.float32)
    probe = rng.normal(size=(2, 16)).astype(np.float32)
    for i in range(1200):
        for idx in (tm, jm, tu):
            idx.add(i, vecs[i], {"i": i})
        if i % 150 == 0:
            for idx in (tm, jm, tu):
                idx.search_batch(probe, 3)
    for i in range(0, 1200, 3):
        for idx in (tm, jm, tu):
            idx.remove(i)
    for i in range(0, 1200, 6):
        for idx in (tm, jm, tu):
            idx.add(i, np.roll(vecs[i], 1), {"i": i})
    assert tm.shard_capacity == jm.shard_capacity > 64  # grew on the device
    assert tm._slot_of == jm._slot_of
    assert tm._live_docs_shard() == jm._live_docs_shard()
    assert [len(f) for f in tm._free_shard] == [len(f) for f in jm._free_shard]
    queries = rng.normal(size=(9, 16)).astype(np.float32)
    want = jm.search_batch(queries, 5)
    _assert_same(tm.search_batch(queries, 5), want)
    _assert_same(tu.search_batch(queries, 5), want)
    # a fetch wider than a shard's row count: the merge still yields the global top-k
    _assert_same(tm.search_batch(queries, 100), jm.search_batch(queries, 100))


def test_mesh_index_add_batch_device_and_dispatch_resolve():
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(40, 16)).astype(np.float32)
    tm, jm, _ = _triple("l2", reserved=64)
    tm.add_batch_device(list(range(40)), torch.from_numpy(vecs))
    jm.add_batch_device(list(range(40)), jnp.asarray(vecs))
    assert tm._slot_of == jm._slot_of
    queries = rng.normal(size=(6, 16)).astype(np.float32)
    _assert_same(tm.search_batch(queries, 7), jm.search_batch(queries, 7))
    scores, slots = tm.search_dispatch(queries, 4)
    assert isinstance(scores, torch.Tensor) and scores.shape == (6, 8)
    js, jx = jm.search_dispatch(queries, 4)
    _assert_same(tm.search_resolve(scores, slots, 4), jm.search_resolve(js, jx, 4))
    with pytest.raises(ValueError, match="dev_vectors"):
        tm.add_batch_device([0], torch.zeros(1, 16, device="meta"))


def test_mesh_index_filtered_search_refills():
    """A filter that keeps one document in ten starves the first fetch
    (4k); the refill fetches four times deeper, on the mesh as unsharded."""
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(400, 16)).astype(np.float32)
    tm, jm, tu = _triple("cos")
    for idx in (tm, jm, tu):
        idx.add_batch_arrays(list(range(400)), vecs, [{"i": i} for i in range(400)])
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    flt = [lambda m: m["i"] % 10 == 0] * 5
    want = jm.search_batch(queries, 6, flt)
    assert all(len(r) == 6 and all(k % 10 == 0 for k, _ in r) for r in want)
    _assert_same(tm.search_batch(queries, 6, flt), want)
    _assert_same(tu.search_batch(queries, 6, flt), want)


def test_mesh_index_reshard_raises_by_name():
    idx = TIndex(dim=4, mesh=_cpu_mesh(2))
    for call in (lambda: idx.spawn_like(_cpu_mesh(4)), lambda: idx.reshard_export_chunks(8),
                 lambda: idx.reshard_import_chunk({"kind": "rows"}), idx.reshard_finish):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 5"):
            call()


# ------------------------------------------------------------- mesh specs


def test_parse_mesh_spec_forms_match_reference():
    for spec in (None, "", 8, "8", "4x2", "data=4,model=2", "data=2;model=1", {"data": 2}, " 2x4 ", "auto"):
        assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec), spec
    assert tmesh.parse_mesh_spec(_cpu_mesh(8)) == jmesh.parse_mesh_spec(jmesh.resolve_mesh(8)) == {
        "data": 8, "model": 1}
    for bad in (0, -2, "axis=3", True, 3.5, {"data": 0}):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_spec(bad)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_picks_the_reference_model_axis(n):
    assert make_mesh(devices=["cpu"] * n).shape == dict(jmake_mesh(n_devices=n).shape)
    assert make_mesh(devices=["cpu"] * n, heads=2).shape == dict(jmake_mesh(n_devices=n, heads=2).shape)


def test_resolve_mesh_places_specs_on_cards_or_the_cpu(monkeypatch):
    mesh = tmesh.resolve_mesh("4x2", device="cpu")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.data_devices() == [torch.device("cpu")] * 4
    assert tmesh.resolve_mesh(mesh) is mesh and tmesh.resolve_mesh(None) is None
    # one explicit list may name a device more than once: 4 shards on one card
    four = make_mesh(devices=["cuda:0"] * 4, model_parallel=1)
    assert four.data_devices() == [torch.device("cuda", 0)] * 4 and hash(four) == hash(DeviceMesh([["cuda:0"]] * 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 visible CUDA cards, found 1"):
        tmesh.resolve_mesh(4)
    assert tmesh.resolve_mesh(1).data_devices() == [torch.device("cuda", 0)]
    with pytest.raises(NotImplementedError, match="elastic"):
        tmesh.resolve_mesh("auto")
    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="multi-process"):
        host_mesh_from_env()


def test_active_mesh_env_is_cached_per_placement(monkeypatch):
    monkeypatch.setenv("PATHWAY_MESH", "data=2")
    first = tmesh.active_mesh(device="cpu")
    assert first.shape == {"data": 2, "model": 1} and tmesh.active_mesh(device="cpu") is first
    with tmesh.use_mesh(_cpu_mesh(4)) as inner:
        assert tmesh.active_mesh(device="cpu") is inner
    assert tmesh.active_mesh(device="cpu") is first


def _one_row_run(**run_kwargs):
    t = tpw.debug.table_from_markdown("""
      | a
    1 | 1
    """)
    seen = []
    tpw.io.subscribe(t, lambda key, row, time, is_addition: seen.append(row["a"]))
    tpw.run(**run_kwargs)
    return seen


def test_use_mesh_survives_a_plain_run_and_the_run_mesh_does_not_leak():
    outer, run_mesh = _cpu_mesh(2), _cpu_mesh(4)
    with tmesh.use_mesh(outer):
        assert _one_row_run() == [1] and tmesh.active_mesh() is outer
        assert _one_row_run(mesh=run_mesh) == [1] and tmesh.active_mesh() is outer
    assert tmesh.active_mesh() is None
    assert _one_row_run(mesh=run_mesh) == [1] and tmesh.active_mesh() is None
    assert TG.run_context["mesh_axes"] == {"data": 4, "model": 1}


def test_pathway_mesh_env_reaches_the_run_context(monkeypatch):
    monkeypatch.setenv("PATHWAY_MESH", "4x2")
    assert _one_row_run() == [1]
    assert TG.run_context["mesh_axes"] == {"data": 4, "model": 2}
    monkeypatch.setenv("PATHWAY_MESH", "axis=3")  # malformed: None here, the resolve raises
    assert _one_row_run() == [1] and TG.run_context["mesh_axes"] is None
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.active_mesh()


def test_index_description_carries_the_mesh_axes():
    t = tpw.debug.table_from_rows(schema=tpw.schema_from_types(v=tuple), rows=[((1.0, 0.0),)])
    tpw.indexing.DataIndex(t, tpw.indexing.BruteForceKnn(t.v, dimensions=2, mesh="4x2", device="cpu")).query(t.v)
    (spec,) = TG.external_indexes
    assert spec == {"kind": "BruteForceKnn", "mesh_axes": {"data": 4, "model": 2}}
