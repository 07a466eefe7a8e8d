"""The port's two-tier index (a device hot tier over a host cold tier)
against the JAX package, on the CPU: spec parsing, the footprint model,
int8 quantisation, the cold store, equality with the flat index when
everything is hot, churn equivalence at full recall, the int8 recall floor
under forced demotion, promotion, snapshot and restore of the tier
assignment, a chaos kill mid-promotion, the tier metrics, and the
``pw.run(index_tiers=)`` / ``PATHWAY_INDEX_TIERS`` wiring
(``tests/test_tiered_index.py``'s cases).

Tolerances: keys, counts, configs and quantised codes equal; f32 scores
within 1e-5 (rtol and atol); the all-hot index equals the port's flat index
exactly; recall@10 at least the reference's 0.95 floor."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu.ops.index_metrics as j_im
import pathway_tpu.ops.knn as j_knn
import pathway_tpu.ops.tiered_knn as j_tk
import pathway_tpu_torch as tpw
import pathway_tpu_torch.ops.index_metrics as t_im
import pathway_tpu_torch.ops.knn as t_knn
import pathway_tpu_torch.ops.tiered_knn as t_tk
from pathway_tpu_torch.internals import flight_recorder as t_fr
from pathway_tpu_torch.resilience import chaos as t_chaos

J = types.SimpleNamespace(tk=j_tk, knn=j_knn, im=j_im, dev={})
T = types.SimpleNamespace(tk=t_tk, knn=t_knn, im=t_im, dev={"device": "cpu"})


@pytest.fixture(autouse=True)
def _reset_index_plane():
    yield
    for P in (J, T):
        P.im.INDEX_METRICS.reset()
    t_fr.RECORDER.clear()
    t_chaos.deactivate()


def _clustered(rng, n_docs, dim=32, n_centers=64, n_queries=16):
    """Cluster structure with rank gaps above the int8 noise floor."""
    centers = rng.normal(size=(n_centers, dim)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_centers, size=n_docs)
    vecs = (centers[assign] + rng.normal(size=(n_docs, dim))).astype(np.float32)
    qs = (centers[rng.integers(0, n_centers, size=n_queries)] + rng.normal(size=(n_queries, dim))).astype(np.float32)
    return vecs, qs


def _full_recall_cfg(P, **kw):
    """Settings where tiering can lose nothing: exact f32 cold vectors
    and every cluster probed."""
    kw.setdefault("n_clusters", 8)
    kw.setdefault("n_probe", 8)
    kw.setdefault("cold_dtype", "f32")
    return P.tk.TierConfig(**kw)


def _tiered(P, dim=16, metric="cos", reserved_space=64, tiers=None, **kw):
    return P.tk.TieredKnnIndex(dim=dim, metric=metric, reserved_space=reserved_space, tiers=tiers, **kw, **P.dev)


def _assert_rows_close(got, want):
    assert [[k for k, _ in row] for row in got] == [[k for k, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ specs, footprint


_SPECS = [None, "off", False, True, "on", "auto", "hot=4096,clusters=32,probe=8,cold=int8,hbm=4G", 4096,
          {"hot_rows": 16}, "hot=8,clusters=4,probe=4,cold=f32,promote=3,decay=0.25"]


@pytest.mark.parametrize("spec", _SPECS, ids=range(len(_SPECS)))
def test_parse_tier_spec_forms(spec):
    got, want = t_tk.parse_tier_spec(spec), j_tk.parse_tier_spec(spec)
    assert (got is None and want is None) or got.as_dict() == want.as_dict()


@pytest.mark.parametrize("bad", ["hot=", "nope=3", "hot=-1", 3.5, {"n_probe": 0}])
def test_parse_tier_spec_rejects_malformed(bad):
    for P in (J, T):
        with pytest.raises(ValueError):
            P.tk.parse_tier_spec(bad)


def test_footprint_math(monkeypatch):
    for P in (J, T):
        assert P.tk.hot_row_bytes(384, "f32") == 384 * 4 + 5
        assert P.tk.cold_row_bytes(384, "int8") == 384 + 4
        assert P.tk.cold_row_bytes(384, "f32") == 384 * 4
        assert P.tk.TierConfig(hbm_bytes=P.tk.hot_row_bytes(384) * 1000).resolve_hot_rows(384) == 1000
    # the default budget is the card's memory (a stand-in torch.cuda
    # reports an H100's), not the reference's 16 GiB
    monkeypatch.delenv("PATHWAY_HBM_BYTES", raising=False)
    fake = types.SimpleNamespace(
        is_available=lambda: True,
        get_device_properties=lambda i: types.SimpleNamespace(total_memory=85_017_493_504),
    )
    monkeypatch.setattr(torch, "cuda", fake)
    assert t_tk.TierConfig().resolve_hot_rows(384) == 85_017_493_504 // t_tk.hot_row_bytes(384)


def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 48)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q, scale = t_tk.quantize_int8(v)
    jq, jscale = j_tk.quantize_int8(v)
    assert q.dtype == np.int8 and (q == jq).all() and (scale == jscale).all()
    back = t_tk.dequantize_int8(q, scale)
    assert (back == j_tk.dequantize_int8(jq, jscale)).all()
    assert float(np.abs(back - v).max()) <= float(scale.max()) / 127.0 + 1e-7


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_cold_store_put_fetch_erase_grow(dtype):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(10, 8)).astype(np.float32)
    outs = []
    for P in (J, T):
        store = P.tk.ColdStore(dim=8, dtype=dtype, capacity=4)
        slots = store.put(v)  # grows past the initial capacity
        fetched = store.fetch(slots)
        store.erase(slots[:5])
        again = store.put(v[:5])
        outs.append((slots.tolist(), fetched, sorted(map(int, again)), store.rows, store.capacity))
    assert outs[1][0] == outs[0][0] and outs[1][2:] == outs[0][2:]
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    if dtype == "f32":
        np.testing.assert_allclose(outs[1][1], v, atol=1e-6)
    assert set(outs[1][2]) == set(outs[1][0][:5])


# ----------------------------------------------------------- flat equivalence


@pytest.mark.parametrize("nq", [7, 40], ids=["stream-regime", "tc-regime"])
@pytest.mark.parametrize("metric", ["cos", "l2", "ip"])
def test_fits_hot_bit_identical_to_flat(metric, nq):
    """When the corpus fits in the hot tier the tiered index IS the flat
    index: the same keys and scores as the port's flat index exactly, and
    the reference's within 1e-5."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(60, 16)).astype(np.float32)
    q = rng.normal(size=(nq, 16)).astype(np.float32)
    outs = []
    for P in (J, T):
        flat = P.knn.DeviceKnnIndex(dim=16, metric=metric, reserved_space=64, **P.dev)
        tier = _tiered(P, metric=metric, tiers=_full_recall_cfg(P))
        for i in range(60):
            flat.add(i, vecs[i], {"i": i})
            tier.add(i, vecs[i], {"i": i})
        assert tier.cold_docs() == 0
        rt = tier.search_batch(q, 5)
        assert rt == flat.search_batch(q, 5)
        outs.append(rt)
    _assert_rows_close(outs[1], outs[0])


def _churn(P, metric):
    rng = np.random.default_rng(4)
    n = 160
    vecs, qs = _clustered(rng, n, dim=16, n_centers=12, n_queries=9)
    flat = P.knn.DeviceKnnIndex(dim=16, metric=metric, reserved_space=64, **P.dev)
    tier = _tiered(P, metric=metric, tiers=_full_recall_cfg(P, hot_rows=64))
    for i in range(n):
        flat.add(i, vecs[i])
        tier.add(i, vecs[i])
    for i in range(0, n, 3):  # retract every third key, re-add some rotated
        flat.remove(i)
        tier.remove(i)
    for i in range(0, n, 6):
        flat.add(i, np.roll(vecs[i], 1))
        tier.add(i, np.roll(vecs[i], 1))
    assert len(flat) == len(tier)
    tier.force_demote()
    assert tier.hot_docs() == 0 and tier.cold_docs() == len(flat)
    return flat.search_batch(qs, 5), tier.search_batch(qs, 5)


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_churn_equivalence_at_full_recall(metric):
    """Adds, removes, re-adds and a forced demotion of every cluster: at
    full-recall settings the tiered answers match flat brute force, and the
    reference's tiered answers."""
    rf, rt = _churn(T, metric)
    for row_f, row_t in zip(rf, rt):
        sf = np.asarray([s for _, s in row_f])
        np.testing.assert_allclose([s for _, s in row_t], sf, rtol=1e-5, atol=1e-5)
        if not np.isclose(sf[:-1], sf[1:]).any():
            assert [k for k, _ in row_f] == [k for k, _ in row_t]
    _assert_rows_close(rt, _churn(J, metric)[1])


def _recall(P):
    rng = np.random.default_rng(5)
    vecs, qs = _clustered(rng, 4000, dim=96, n_centers=128, n_queries=32)
    keys = list(range(len(vecs)))
    flat = P.knn.DeviceKnnIndex(dim=96, metric="cos", reserved_space=4096, **P.dev)
    flat.add_batch_arrays(keys, vecs)
    truth = [set(k for k, _ in row) for row in flat.search_batch(qs, 10)]
    tier = _tiered(P, dim=96, reserved_space=4096, tiers=P.tk.TierConfig(n_clusters=16, n_probe=12, cold_dtype="int8"))
    tier.add_batch_arrays(keys, vecs)
    tier.force_demote()
    assert tier.hot_docs() == 0 and tier.cold_docs() == 4000
    got = tier.search_batch(qs, 10)
    return float(np.mean([len(truth[i] & {k for k, _ in got[i]}) / 10 for i in range(len(qs))])), got


def test_recall_floor_under_forced_demotion_int8():
    """Everything demoted to the int8 cold tier (dequantised and rescored
    on the index's device): recall@10 against exact flat brute force stays
    at or above the 0.95 floor, and the answers equal the reference's."""
    recall, got = _recall(T)
    assert recall >= 0.95, f"recall@10 {recall:.3f} under forced demotion"
    jrecall, want = _recall(J)
    assert recall == jrecall
    _assert_rows_close(got, want)


def _promotion(P):
    rng = np.random.default_rng(6)
    vecs, qs = _clustered(rng, 120, dim=16, n_centers=6, n_queries=4)
    tier = _tiered(P, reserved_space=128, tiers=_full_recall_cfg(P, n_clusters=6, n_probe=6, promote_every=4))
    tier.add_batch_arrays(list(range(120)), vecs)
    tier.force_demote()
    cold = tier.cold_docs()
    for _ in range(12):
        tier.search_batch(qs, 5)
    tier.maybe_rebalance(force=True)
    snap = P.im.INDEX_METRICS.snapshot()["indexes"][tier.name]["tiers"]
    return [cold, tier.hot_docs(), tier.cold_docs(), snap["promotions"], snap["demotions"]]


def test_promotion_restores_hot_residency():
    """After force_demote, queries hitting cold clusters drive the
    rebalance loop to promote them back while the slab has room."""
    got = _promotion(T)
    assert got == _promotion(J)
    assert got[0] == 120 and got[1] > 0 and got[3] >= 1 and got[4] >= 1


# ---------------------------------------------------------- snapshot / restore


def _snapshot(P):
    rng = np.random.default_rng(8)
    vecs, qs = _clustered(rng, 90, dim=16, n_centers=8, n_queries=5)
    src = _tiered(P, reserved_space=48, tiers=_full_recall_cfg(P, hot_rows=48))
    src.add_batch_arrays(list(range(90)), vecs, [{"i": i} for i in range(90)])
    src.force_demote([0, 1])  # mixed residency
    ref = src.search_batch(qs, 5)
    dst = _tiered(P, reserved_space=48, tiers=_full_recall_cfg(P, hot_rows=48))
    dst.restore_tier_state(src.tier_state())
    # the restore order: bulk re-add, then the tier fixup
    dst.add_batch_arrays(list(range(90)), vecs, [{"i": i} for i in range(90)])
    dst.finish_tier_restore()
    assert dict(dst._cluster_of) == dict(src._cluster_of)
    assert set(dst.hot._slot_of) == set(src.hot._slot_of)
    assert dst.cold_docs() == src.cold_docs()
    got = dst.search_batch(qs, 5)
    _assert_rows_close(got, ref)
    return sorted(src.hot._slot_of), src.cold_docs(), got


def test_snapshot_restore_preserves_tier_assignment():
    hot, cold, got = _snapshot(T)
    jhot, jcold, want = _snapshot(J)
    assert (hot, cold) == (jhot, jcold)
    _assert_rows_close(got, want)


# ------------------------------------------------------------------- chaos


def test_chaos_mid_promotion_no_loss_no_dups():
    """Kill the promotion between its two hot-insert chunks: every key stays
    findable exactly once (the cold listing is cleared only after the hot
    copy lands, and the merge dedups hot-resident keys)."""
    rng = np.random.default_rng(9)
    vecs, qs = _clustered(rng, 100, dim=16, n_centers=4, n_queries=4)
    tier = _tiered(T, reserved_space=128, tiers=_full_recall_cfg(T, n_clusters=4, n_probe=4))
    tier.add_batch_arrays(list(range(100)), vecs)
    tier.force_demote()
    for _ in range(8):
        tier.search_batch(qs, 5)
    assert "index.tier.promote" in t_chaos.registered_sites("index")
    t_chaos.activate([{"site": "index.tier.promote", "hit": 2, "action": "raise"}])
    try:
        with pytest.raises(t_chaos.ChaosInjected):
            tier.maybe_rebalance(force=True)
    finally:
        t_chaos.deactivate()
    assert 0 < tier.hot_docs() < 100, "chaos window missed the promotion"
    got = tier.search_batch(np.asarray(vecs, np.float32), 1)
    assert sorted(row[0][0] for row in got if row) == list(range(100))
    seen: set = set()
    for row in tier.search_batch(qs, 100):
        keys = [k for k, _ in row]
        assert len(keys) == len(set(keys)), "duplicate key in one answer"
        seen.update(keys)
    assert seen == set(range(100))
    tier.maybe_rebalance(force=True)  # completes the torn promotion
    assert tier.hot_docs() + tier.cold_docs() == 100


# -------------------------------------------------------------- metrics, ring


def test_flat_metrics_stream_untouched():
    from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer

    rng = np.random.default_rng(10)
    idx = t_knn.DeviceKnnIndex(dim=8, metric="cos", reserved_space=32, name="flatonly", device="cpu")
    for i in range(10):
        idx.add(i, rng.normal(size=8).astype(np.float32))
    idx.search_batch(rng.normal(size=(2, 8)).astype(np.float32), 3)
    assert not t_im.INDEX_METRICS.tiered_active()
    text = "\n".join(MonitoringHttpServer._index_lines())
    assert "pathway_index_docs" in text and "pathway_index_tier" not in text
    assert "tiers" not in t_im.INDEX_METRICS.snapshot()["indexes"]["flatonly"]


def _tier_metrics(P):
    rng = np.random.default_rng(11)
    vecs, qs = _clustered(rng, 80, dim=16, n_centers=4, n_queries=3)
    tier = _tiered(P, reserved_space=96, tiers=_full_recall_cfg(P, n_clusters=4, n_probe=4), name="tiered")
    tier.add_batch_arrays(list(range(80)), vecs)
    tier.force_demote()
    tier.search_batch(qs, 5)
    snap = P.im.INDEX_METRICS.snapshot()
    tiers = dict(snap["indexes"]["tiered"]["tiers"])
    return snap, tiers


def test_tier_metrics_rendered_and_imbalance_counts_cold():
    from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer

    snap, tiers = _tier_metrics(T)
    assert tiers["hot_docs"] == 0 and tiers["cold_docs"] == 80 and tiers["demotions"] >= 1
    assert tiers["cold_bytes"] == 80 * t_tk.cold_row_bytes(16, "f32")
    assert 0.0 <= tiers["hot_hit_ratio"] <= 1.0
    assert snap["cold_fetch_seconds"]["count"] >= 1
    # the docs gauge and the imbalance count BOTH tiers
    assert snap["indexes"]["tiered"]["docs"] == 80 and tiers["cold_docs_shard"] == [80]
    jsnap, jtiers = _tier_metrics(J)
    assert tiers == jtiers
    text = "\n".join(MonitoringHttpServer._index_lines())
    for needle in ('pathway_index_tier_docs{index="tiered",shard="0",tier="cold"}', "pathway_index_tier_bytes",
                   "pathway_index_tier_promotions_total", "pathway_index_tier_demotions_total",
                   "pathway_index_tier_hot_hit_ratio", "pathway_index_tier_cold_fetch_seconds_bucket"):
        assert needle in text
    events = t_fr.RECORDER.events()
    assert "index.tier.demote" in [e["kind"] for e in events]
    reb = [e for e in events if e["kind"] == "index.rebalance"]
    assert reb and reb[-1]["docs"] == [80] and reb[-1]["docs_cold"] == [80] and reb[-1]["docs_hot"] == [0]


@pytest.mark.parametrize("cold_dtype", ["f32", "int8"])
def test_cold_rescore_through_the_ring_equals_a_plain_product(cold_dtype, monkeypatch):
    """Every cold rescore, staged through the DeviceRing, equals the plain
    product of the same rows copied afresh; the ring reuses its two slots."""
    rng = np.random.default_rng(14)
    vecs, qs = _clustered(rng, 200, dim=16, n_centers=8, n_queries=6)
    tier = _tiered(T, reserved_space=64, tiers=T.tk.TierConfig(n_clusters=8, n_probe=3, cold_dtype=cold_dtype,
                                                               hot_rows=64))
    tier.add_batch_arrays(list(range(200)), vecs)
    checked = []
    real = tier._cold_score

    def checked_score(q, payload):
        got = real(q, payload)
        fresh = [torch.from_numpy(np.array(a, copy=True)) for a in payload]
        docs = fresh[0].float() * (fresh[1] / 127.0)[:, None] if len(fresh) == 2 else fresh[0]
        want = t_tk.cold_scores("cos", torch.from_numpy(np.ascontiguousarray(q, np.float32)), docs)
        checked.append(bool(torch.equal(got, want)))
        return got

    monkeypatch.setattr(tier, "_cold_score", checked_score)
    for i in range(4):
        tier.search_batch(qs[i: i + 2], 5)
    stats = tier._cold_ring.stats()
    assert checked == [True] * 4 and stats["staged"] == 4 and stats["donated"] > 0 and stats["high_water"] <= 2


def _mesh_tier_script(P, mesh_of, cold):
    rng = np.random.default_rng(31)
    vecs, qs = _clustered(rng, 300, dim=16, n_centers=12, n_queries=6)
    tier = P.tk.TieredKnnIndex(dim=16, reserved_space=96, mesh=mesh_of(2),
                               tiers=P.tk.TierConfig(n_clusters=8, n_probe=4, cold_dtype=cold, promote_every=4))
    tier.add_batch_arrays(list(range(300)), vecs)
    for key in range(0, 300, 7):
        tier.remove(key)
    answers = [tier.search_batch(qs, 5) for _ in range(5)]  # a rebalance runs after the fourth search
    layout = [tier.n_shards, sorted(tier.hot._slot_of), tier._cold_docs_shard, tier._cold_total,
              tier.hot._live_docs_shard()]
    chunks = list(tier.reshard_export_chunks(64))
    target = tier.spawn_like(mesh_of(4))
    for chunk in chunks:
        target.reshard_import_chunk(chunk)
    target.reshard_finish()
    with pytest.raises(ValueError, match="cannot import chunk kind"):
        target.reshard_import_chunk({"kind": "rows"})
    moved = [target.n_shards, sorted(target.hot._slot_of), target._cold_total, sum(target._cold_docs_shard),
             [c["kind"] for c in chunks]]
    return answers, layout, moved, target.search_batch(qs, 5), tier


def test_tiered_index_on_a_mesh_and_reshard_name_item_5():
    """The tiered index on a mesh and its reshard protocol (both raised
    before the elastic plane was ported): per-shard hot admission, cold
    counts a shard and the rebalance on a 2-device mesh as the reference's;
    the exported tier state, cold payloads and hot rows rebuild an index on
    4 devices with the same hot set that answers as the source."""
    from pathway_tpu.parallel.mesh import resolve_mesh as jresolve
    from pathway_tpu_torch.parallel.mesh import resolve_mesh as tresolve

    for cold in ("f32", "int8"):
        got, got_layout, got_moved, got_after, tsrc = _mesh_tier_script(T, lambda n: tresolve(n, device="cpu"),
                                                                         cold)
        want, want_layout, want_moved, want_after, _ = _mesh_tier_script(J, jresolve, cold)
        assert got_layout == want_layout and got_moved == want_moved and got_layout[0] == 2
        assert got_moved[1] == got_layout[1] and got_moved[2] == got_layout[3] > 0
        for g, w in zip(got + [got_after], want + [want_after]):
            _assert_rows_close(g, w)
        qs = _clustered(np.random.default_rng(31), 300, dim=16, n_centers=12, n_queries=6)[1]
        assert got_after == tsrc.search_batch(qs, 5)


# ------------------------------------------------------------- pw.run wiring


def _knn_pipeline(pw, docs_v, qs_v, reserved=32, **kw):
    if pw is tpw:
        from pathway_tpu_torch.stdlib.ml.index import KNNIndex

        kw["device"] = "cpu"
    else:
        from pathway_tpu.stdlib.ml.index import KNNIndex
    docs = pw.debug.table_from_rows(pw.schema_from_types(i=int), [(i,) for i in range(len(docs_v))])
    docs = docs.select(docs.i, emb=pw.apply_with_type(lambda i: tuple(map(float, docs_v[i])), pw.ANY, docs.i))
    queries = pw.debug.table_from_rows(pw.schema_from_types(i=int), [(i,) for i in range(len(qs_v))])
    queries = queries.select(emb=pw.apply_with_type(lambda i: tuple(map(float, qs_v[i])), pw.ANY, queries.i))
    index = KNNIndex(docs.emb, docs, n_dimensions=16, reserved_space=reserved, **kw)
    return index.get_nearest_items(queries.emb, k=3, collapse_rows=True, with_distances=True)


def _collect(pw, res, **run_kwargs):
    rows = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[int(key)] = (tuple(row["i"]), tuple(row["dist"]))

    pw.io.subscribe(res, on_change=on_change)
    pw.run(**run_kwargs)
    pw.clear_graph()
    return rows


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0]
        np.testing.assert_allclose(a[k][1], b[k][1], rtol=1e-5, atol=1e-5)


def test_pw_run_index_tiers_end_to_end():
    """pw.run(index_tiers=...) serves the flat run's answers with no query
    API change, and the run-scoped config does not leak."""
    rng = np.random.default_rng(12)
    docs_v = rng.normal(size=(20, 16)).astype(np.float32)
    qs_v = rng.normal(size=(5, 16)).astype(np.float32)
    jpw.clear_graph()
    tpw.clear_graph()
    out_flat = _collect(tpw, _knn_pipeline(tpw, docs_v, qs_v))
    out_tier = _collect(tpw, _knn_pipeline(tpw, docs_v, qs_v), index_tiers="hot=64,clusters=4,probe=4")
    assert t_tk.active_tiers() is None, "run-scoped tier config leaked"
    assert out_tier == out_flat and len(out_tier) == 5
    _close(out_tier, _collect(jpw, _knn_pipeline(jpw, docs_v, qs_v), index_tiers="hot=64,clusters=4,probe=4"))


def test_pathway_index_tiers_env_and_run_context(monkeypatch):
    """A hot tier smaller than the corpus (PATHWAY_INDEX_TIERS): the
    overflow serves from the f32 cold tier at full probe, the answers equal
    the flat run's, and the run context carries the knobs."""
    rng = np.random.default_rng(13)
    docs_v = rng.normal(size=(20, 16)).astype(np.float32)
    qs_v = rng.normal(size=(4, 16)).astype(np.float32)
    tpw.clear_graph()
    out_flat = _collect(tpw, _knn_pipeline(tpw, docs_v, qs_v))
    monkeypatch.setenv("PATHWAY_INDEX_TIERS", "hot=8,clusters=4,probe=4,cold=f32")
    res = _knn_pipeline(tpw, docs_v, qs_v)
    rows = {}
    tpw.io.subscribe(res, on_change=lambda key, row, time, is_addition: is_addition and rows.__setitem__(
        int(key), tuple(row["i"])))
    tpw.run()
    from pathway_tpu_torch.internals.parse_graph import G

    assert G.run_context["index_tiers"]["n_probe"] == 4
    tpw.clear_graph()
    assert rows == {k: v[0] for k, v in out_flat.items()}
