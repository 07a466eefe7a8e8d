"""The port's tenancy plane against the JAX package, on the CPU: spec
parsing, the tenant-packed slab (segments, growth, the tenant mask, the
HBM quota, cold demotion and promotion, ledger reconciliation), per-tenant
admission gates, weighted deficit round-robin batching, and the
activity-gated per-tenant metric surfaces (``tests/test_tenancy.py``'s
cases). Each script runs on both packages with the same seeded numpy
inputs and their outcomes are compared.

Tolerances: keys, counts, bytes, configs, statuses and rendered text
equal; f32 scores within 1e-5 (a tenant's search against a private index
of the same package is equal exactly on the CPU: the same plain top-k over
the same rows)."""

from __future__ import annotations

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import pathway_tpu.internals.http_monitoring as j_http
import pathway_tpu.internals.ledger as j_ledger
import pathway_tpu.internals.monitoring as j_mon
import pathway_tpu.ops.index_metrics as j_im
import pathway_tpu.ops.knn as j_knn
import pathway_tpu.serving as j_sv
import pathway_tpu.tenancy.config as j_cfg
import pathway_tpu.tenancy.metrics as j_met
import pathway_tpu.tenancy.packed as j_packed
import pathway_tpu_torch.internals.http_monitoring as t_http
import pathway_tpu_torch.internals.ledger as t_ledger
import pathway_tpu_torch.internals.monitoring as t_mon
import pathway_tpu_torch.ops.index_metrics as t_im
import pathway_tpu_torch.ops.knn as t_knn
import pathway_tpu_torch.serving as t_sv
import pathway_tpu_torch.tenancy.config as t_cfg
import pathway_tpu_torch.tenancy.metrics as t_met
import pathway_tpu_torch.tenancy.packed as t_packed

J = SimpleNamespace(cfg=j_cfg, met=j_met, packed=j_packed, knn=j_knn, ledger=j_ledger, im=j_im, sv=j_sv, http=j_http,
                    mon=j_mon, dev={})
T = SimpleNamespace(cfg=t_cfg, met=t_met, packed=t_packed, knn=t_knn, ledger=t_ledger, im=t_im, sv=t_sv, http=t_http,
                    mon=t_mon, dev={"device": "cpu"})
BOTH = pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])


def _reset():
    for P in (J, T):
        P.cfg.set_active_tenancy(None)
        P.met.TENANCY_METRICS.reset()
        P.ledger.LEDGER.reset()
        P.im.INDEX_METRICS.reset()
        P.packed.reset_slabs()


@pytest.fixture(autouse=True)
def _clean_registries(monkeypatch):
    monkeypatch.delenv("PATHWAY_TENANCY", raising=False)
    monkeypatch.delenv("PATHWAY_METRIC_TENANTS", raising=False)
    _reset()
    yield
    _reset()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _packed(P, dim=8, reserved_space=64, **kw):
    return P.packed.TenantPackedIndex(dim, reserved_space=reserved_space, **kw, **P.dev)


def _assert_rows_close(got, want):
    assert [[k for k, _ in row] for row in got] == [[k for k, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- spec parsing


_SPECS = [
    None, False, "off", "", True, "on",
    "qps=50,burst=4,inflight=2,hbm=64M,weight=2,floor_k=3,demote_every=16,decay=0.25,demote_below=0.1",
    {"quotas": {"acme": {"qps": 5, "rate": 5}, "big": "weight=3"}, "default": {"inflight": 4}, "demote_every": 8},
    {"qps": 9},
]


def _parse(P, spec):
    cfg = P.cfg.parse_tenancy_spec(spec)
    return None if cfg is None else cfg.as_dict()


@pytest.mark.parametrize("spec", _SPECS, ids=range(len(_SPECS)))
def test_parse_tenancy_spec_forms(spec):
    assert _parse(T, spec) == _parse(J, spec)
    cfg = T.cfg.parse_tenancy_spec(T.cfg.TenancyConfig(default=T.cfg.TenantQuotas(weight=2.0)))
    assert T.cfg.parse_tenancy_spec(cfg) is cfg
    q = T.cfg.TenantQuotas(weight=2.0)
    assert T.cfg.parse_quota_spec(q) is q and T.cfg.parse_quota_spec(None) is None


@pytest.mark.parametrize("spec", ["zps=1", "qps", {"default": {"qps": 1}, "qps": 2}, 3.5])
def test_parse_tenancy_spec_rejects_malformed(spec):
    for P in (J, T):
        with pytest.raises(ValueError):
            P.cfg.parse_tenancy_spec(spec)
    for bad in ({"nope": 1}, "inflight=many"):
        with pytest.raises(ValueError):
            T.cfg.parse_quota_spec(bad)


@BOTH
def test_quota_validation(P):
    for bad in (dict(qps=0.0), dict(qps=-1.0), dict(burst=0), dict(max_inflight=0), dict(hbm_bytes=0),
                dict(weight=0.0), dict(min_top_k=0)):
        with pytest.raises(ValueError):
            P.cfg.TenantQuotas(**bad)
    for bad in (dict(demote_every=-1), dict(decay=0.0), dict(decay=1.5)):
        with pytest.raises(ValueError):
            P.cfg.TenancyConfig(**bad)


@BOTH
def test_quota_for_falls_back_to_default(P):
    named = P.cfg.TenantQuotas(qps=1.0)
    dflt = P.cfg.TenantQuotas(weight=2.0)
    cfg = P.cfg.TenancyConfig(quotas={"acme": named}, default=dflt)
    assert cfg.quota_for("acme") is named and cfg.quota_for("anyone") is dflt
    assert P.cfg.TenancyConfig().quota_for("anyone") is None
    assert P.cfg.TENANT_HEADER == "X-Pathway-Tenant"


@BOTH
def test_active_tenancy_precedence(P, monkeypatch):
    assert P.cfg.active_tenancy() is None
    monkeypatch.setenv("PATHWAY_TENANCY", "qps=7,weight=2")
    assert P.cfg.active_tenancy().default.qps == 7.0
    run_cfg = P.cfg.TenancyConfig(default=P.cfg.TenantQuotas(qps=3.0))
    P.cfg.set_active_tenancy(run_cfg)
    assert P.cfg.active_tenancy() is run_cfg  # the run-scoped config wins
    P.cfg.set_active_tenancy(None)
    assert P.cfg.active_tenancy().default.qps == 7.0
    monkeypatch.setenv("PATHWAY_TENANCY", "zps=1")
    assert P.cfg.active_tenancy() is None  # malformed reads as no tenancy
    # the serving plane's lookup follows the same precedence
    assert not T.sv.admission.tenancy_active()
    with T.cfg.use_tenancy(True):
        assert T.sv.admission.tenancy_active()


@BOTH
def test_use_tenancy_context_manager(P):
    with P.cfg.use_tenancy("inflight=3"):
        assert P.cfg.active_tenancy().default.max_inflight == 3
        with P.cfg.use_tenancy(None):
            assert P.cfg.active_tenancy() is None
        assert P.cfg.active_tenancy().default.max_inflight == 3
    assert P.cfg.active_tenancy() is None


# ------------------------------------------------------- tenant-packed slab


def _segments_script(P):
    idx = _packed(P)
    rng = _rng(1)
    idx.add_tenant_batch("a", [0, 1, 2], rng.standard_normal((3, 8)))
    (start, size), = idx._segments["a"]
    extent = [int(t) for t in idx._tenant_host[start: start + size]]
    out = [idx._tenant_rows["a"], idx.tenant_docs("a"), idx._live_docs_shard(), size,
           extent.count(idx._tid["a"]), extent.count(-1)]
    idx.remove_tenant("a", 1)
    rows_before = idx._tenant_rows["a"]
    out += [idx.tenant_docs("a"), idx._live_docs_shard()]
    idx.add_tenant("a", 9, rng.standard_normal(8))
    out += [idx._tenant_rows["a"] == rows_before, idx.tenant_docs("a")]
    return out


def test_packed_segments_grant_min_extent_and_count_live_docs():
    got = _segments_script(T)
    assert got == _segments_script(J)
    assert got[:6] == [T.packed._MIN_EXTENT, 3, [3], T.packed._MIN_EXTENT, 3, T.packed._MIN_EXTENT - 3]


def test_packed_remove_returns_slot_to_tenant_segment():
    got = _segments_script(T)
    assert got[6:] == [2, [2], True, 3]


def _growth_script(P):
    idx = _packed(P, reserved_space=16)
    rng = _rng(3)
    vecs = {t: rng.standard_normal((20, 8)).astype(np.float32) for t in ("a", "b")}
    for i in range(20):
        for t in ("a", "b"):
            idx.add_tenant(t, i, vecs[t][i])
    out = [idx.capacity]
    for t in ("a", "b"):
        rows = [r for start, size in idx._segments[t] for r in range(start, start + size)]
        assert all(0 <= r < idx.capacity for r in rows) and len(rows) == len(set(rows))
        out.append((idx.tenant_docs(t), sorted(idx._segments[t])))
        out.append([row[0][0] for row in idx.search_tenant_batch(t, vecs[t][:4], 1)])
    return out


def test_packed_growth_remaps_segments_and_keeps_results():
    got = _growth_script(T)
    assert got == _growth_script(J)
    assert got[0] >= 40 and got[2] == [0, 1, 2, 3] and got[4] == [0, 1, 2, 3]


@pytest.mark.parametrize("nq", [6, 40], ids=["stream-regime", "tc-regime"])
@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_masked_search_bit_identical_to_private_index(nq, metric):
    """A tenant's search equals a private index over the same rows, in the
    query counts of both of B2's regimes (at most 16 queries: the stream
    pass; above: the tensor-core pass), and equals the reference's."""
    dim, res, k = 16, 128, 5
    outs = {}
    for P in (J, T):
        rng = _rng(4)
        slab = _packed(P, dim=dim, reserved_space=res, metric=metric)
        solo = P.knn.DeviceKnnIndex(dim, metric=metric, reserved_space=res, **P.dev)
        corpora = {t: rng.standard_normal((20, dim)).astype(np.float32) for t in ("a", "b", "c")}
        for i in range(20):  # interleaved adds: the tenants' rows mix in the slab
            for t in ("a", "b", "c"):
                slab.add_tenant(t, f"{t}{i}", corpora[t][i])
        solo.add_batch_arrays([f"b{i}" for i in range(20)], corpora["b"])
        q = rng.standard_normal((nq, dim)).astype(np.float32)
        got = slab.search_tenant_batch("b", q, k)
        assert got == solo.search_batch(q, k)  # keys and scores, exactly
        outs[P is T] = got
    _assert_rows_close(outs[True], outs[False])


@BOTH
def test_search_never_crosses_tenants(P):
    idx = _packed(P)
    rng = _rng(5)
    for t in ("a", "b"):
        idx.add_tenant_batch(t, [f"{t}{i}" for i in range(10)], rng.standard_normal((10, 8)))
    rows = idx.search_tenant_batch("a", rng.standard_normal((4, 8)), 10)
    keys = {key for row in rows for key, _ in row}
    assert keys and all(k.startswith("a") for k in keys)
    # an empty tenant gets empty rows, not other tenants' docs
    assert idx.search_tenant_batch("ghost", rng.standard_normal((2, 8)), 3) == [[], []]


def _quota_script(P):
    budget = 10 * P.ledger.hot_row_bytes(8)  # 10 rows
    cfg = P.cfg.TenancyConfig(quotas={"small": P.cfg.TenantQuotas(hbm_bytes=budget)})
    idx = _packed(P, config=cfg)
    rng = _rng(6)
    idx.add_tenant_batch("small", list(range(8)), rng.standard_normal((8, 8)))
    with pytest.raises(P.packed.TenantOverBudget) as exc:
        idx.add_tenant_batch("small", [100, 101, 102], rng.standard_normal((3, 8)))
    idx.add_tenant_batch("big", list(range(20)), rng.standard_normal((20, 8)))
    return [exc.value.tenant, exc.value.budget_bytes, exc.value.need_bytes, idx.tenant_docs("big")]


def test_hbm_quota_enforced_at_grant_time():
    got = _quota_script(T)
    assert got == _quota_script(J)
    assert got[0] == "small" and got[2] > got[1] and got[3] == 20


def _demotion_script(P):
    # idle's one warm-up hit decays 1.0 -> 0.5 on the first sweep, below 0.6
    cfg = P.cfg.TenancyConfig(demote_every=2, demote_below=0.6)
    idx = _packed(P, config=cfg)
    rng = _rng(7)
    vecs = {t: rng.standard_normal((6, 8)).astype(np.float32) for t in ("hot", "idle")}
    for t in ("hot", "idle"):
        idx.add_tenant_batch(t, list(range(6)), vecs[t])
    q = rng.standard_normal((1, 8)).astype(np.float32)
    want = idx.search_tenant_batch("idle", q, 3)
    idx.search_tenant_batch("hot", q, 3)
    idx.search_tenant_batch("hot", q, 3)
    out = [idx.tenant_is_cold("idle"), idx.tenant_docs("idle"), idx._tenant_rows["idle"], bool(idx._free_extents)]
    cold = idx.search_tenant_batch("idle", q, 3)  # the exact host scan
    out.append(idx.tenant_is_cold("idle"))
    back = idx.search_tenant_batch("idle", q, 3)  # the second hit promoted it
    out.append(idx.tenant_is_cold("idle"))
    return out, want, cold, back


def test_cold_demotion_and_promotion_cycle():
    (got, want, cold, back), (ref, rwant, rcold, rback) = _demotion_script(T), _demotion_script(J)
    assert got == ref == [True, 6, 0, True, True, False]
    _assert_rows_close(cold, want)
    _assert_rows_close(back, want)
    _assert_rows_close(cold, rcold)
    _assert_rows_close(back, rback)


@BOTH
def test_packed_keys_must_be_tenant_namespaced(P):
    idx = _packed(P)
    with pytest.raises(TypeError):
        idx.add_batch_arrays(["bare-key"], np.zeros((1, 8), np.float32))


def _churn_script(P):
    idx = _packed(P, dim=16)
    rng = _rng(8)
    for t in ("a", "b", "c"):
        idx.add_tenant_batch(t, [f"{t}{i}" for i in range(12)], rng.standard_normal((12, 16)))
    q = rng.standard_normal((1, 16)).astype(np.float32)
    idx.search_tenant_batch("a", q, 3)  # materialise the device slab
    for i in range(6):
        idx.remove_tenant("a", f"a{i}")
    idx._demote("b")
    idx.add_tenant_batch("c", [f"c{i}" for i in range(12, 40)], rng.standard_normal((28, 16)))
    idx.search_tenant_batch("c", q, 3)  # re-sync after growth
    idx._publish_metrics()
    acc = P.ledger.LEDGER.accounts()
    row_b = P.ledger.hot_row_bytes(idx.dim)
    rows = P.ledger.LEDGER._rows
    spare = rows[("index.tenant", f"{idx.name}/__unassigned__")][0]
    named = sum(idx._tenant_rows.values()) * row_b
    snap = P.met.TENANCY_METRICS.snapshot()["tenants"]
    return [acc["index.tenant"]["bytes"], acc["index.hot"]["bytes"], idx.capacity * row_b, named + spare,
            ("index.tenant", f"{idx.name}/b") in rows, snap["b"]["cold"], snap["b"]["hbm_bytes"], snap["a"]["docs"],
            snap["c"]["hbm_bytes"] == idx._tenant_rows["c"] * row_b]


def test_ledger_reconciles_tenant_account_with_hot_under_churn():
    got = _churn_script(T)
    assert got[0] == got[1] == got[2] == got[3]  # index.tenant sums exactly to index.hot
    assert got[4:] == [False, True, 0, 6, True]
    assert got == _churn_script(J)


@BOTH
def test_shared_slab_registry_is_per_geometry(P):
    a = P.packed.shared_slab(16, metric="cos", **P.dev)
    b = P.packed.shared_slab(16, metric="cos", reserved_space=4096, **P.dev)
    c = P.packed.shared_slab(16, metric="l2", **P.dev)
    assert a is b and a is not c
    P.packed.reset_slabs()
    assert P.packed.shared_slab(16, metric="cos", **P.dev) is not a


def _view_script(P):
    idx = _packed(P)
    rng = _rng(9)
    view = idx.view("acme")
    view.add("k0", rng.standard_normal(8))
    view.add_batch([(f"k{i}", rng.standard_normal(8), {"i": i}) for i in (1, 2)])
    out = [len(view), view.dim, view.metric == idx.metric]
    out.append(sorted(k for k, _ in view.search_one(rng.standard_normal(8), 3)))
    view.remove("k1")
    return out + [len(view), idx.tenant_docs("acme")]


def test_tenant_view_strips_namespacing():
    got = _view_script(T)
    assert got == _view_script(J) == [3, 8, True, ["k0", "k1", "k2"], 2, 2]


def test_stdlib_tenant_kwarg_routes_to_shared_slab():
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn, _TenantPayloadView

    ia = BruteForceKnn(None, dimensions=8, reserved_space=64, tenant="a", device="cpu")._index_factory()()
    ib = BruteForceKnn(None, dimensions=8, reserved_space=64, tenant="b", device="cpu")._index_factory()()
    assert isinstance(ia, _TenantPayloadView)
    assert ia._view.packed is ib._view.packed  # one slab
    rng = _rng(10)
    ia.add("x", rng.standard_normal(8))
    ib.add("y", rng.standard_normal(8))
    assert len(ia) == 1 and len(ib) == 1
    assert [k for k, _ in ia.search_batch(rng.standard_normal((1, 8)), 5)[0]] == ["x"]
    assert BruteForceKnn(None, dimensions=8, tenant="a")._index_spec()["tenant"] == "a"


def _mesh_slab_script(P, mesh):
    idx = P.packed.TenantPackedIndex(8, reserved_space=64, mesh=mesh)
    rng = _rng(21)
    for t, n in (("a", 5), ("b", 40), ("c", 3), ("d", 70)):  # grants past 64 rows: the sharded growth remaps
        idx.add_tenant_batch(t, list(range(n)), rng.standard_normal((n, 8)))
    idx.remove_tenant("b", 7)
    idx._demote("c")
    q = rng.standard_normal((3, 8))
    answers = {t: idx.search_tenant_batch(t, q, 4) for t in ("a", "b", "c", "d")}
    layout = [idx.n_shards, idx.shard_capacity, idx._live_docs_shard(), {t: sorted(map(tuple, s))
              for t, s in idx._segments.items()}, list(idx._bump), idx.tenant_is_cold("c")]
    return answers, layout


def test_tenant_slab_on_a_mesh_names_item_5():
    """The tenant-packed slab on a mesh (it raised before the elastic plane
    was ported): extents carved per shard, the sharded growth's remap, the
    tenant mask as one validity and bias a shard, a cold tenant, and the
    stdlib's ``tenant=`` sharing one slab a mesh; the same layout and
    answers as the reference's slab on its 2-device mesh."""
    from pathway_tpu.parallel.mesh import resolve_mesh as jresolve
    from pathway_tpu_torch.parallel.mesh import resolve_mesh as tresolve
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn

    got, got_layout = _mesh_slab_script(T, tresolve(2, device="cpu"))
    want, want_layout = _mesh_slab_script(J, jresolve(2))
    assert got_layout == want_layout and got_layout[0] == 2
    for t in want:
        _assert_rows_close(got[t], want[t])
    mesh = tresolve(2, device="cpu")
    ia = BruteForceKnn(None, dimensions=8, reserved_space=64, tenant="a", device="cpu", mesh=mesh)._index_factory()()
    ib = BruteForceKnn(None, dimensions=8, reserved_space=64, tenant="b", device="cpu", mesh=mesh)._index_factory()()
    assert ia._view.packed is ib._view.packed and ia._view.packed.n_shards == 2
    rng = _rng(10)
    ia.add("x", rng.standard_normal(8))
    ib.add("y", rng.standard_normal(8))
    assert [k for k, _ in ia.search_batch(rng.standard_normal((1, 8)), 5)[0]] == ["x"]


# ------------------------------------------------------- fair-share admission


def _controller(P, **cfg_kw):
    cfg_kw.setdefault("max_queue", 100)
    return P.sv.AdmissionController(P.sv.ServingConfig(**cfg_kw), metrics=P.sv.ServingMetrics())


def _qps_script(P):
    with P.cfg.use_tenancy({"quotas": {"noisy": {"qps": 1000, "burst": 2}}}):
        ctl = _controller(P)
        for _ in range(2):
            ctl.admit(P.sv.Deadline(60_000), tenant="noisy")
        with pytest.raises(P.sv.TenantRateLimited) as exc:
            ctl.admit(P.sv.Deadline(60_000), tenant="noisy")
        ctl.admit(P.sv.Deadline(60_000), tenant="quiet")  # unquota'd tenants ride through
        snap = P.met.TENANCY_METRICS.snapshot()["tenants"]
    e = exc.value
    return [isinstance(e, P.sv.RateLimited), e.status, e.reason, e.tenant, e.retry_after_s >= 0.0,
            snap["noisy"]["shed"], snap["noisy"]["admitted"], snap["quiet"]["admitted"]]


def _frozen_buckets(monkeypatch):
    """Bind both packages' tenant buckets to a clock that never moves: at
    1,000 QPS a millisecond between the second and third admits refills a
    token, and the third admit would pass on a slow host."""
    import pathway_tpu.serving.admission as j_adm
    import pathway_tpu_torch.serving.admission as t_adm

    for mod in (j_adm, t_adm):
        real = mod.TokenBucket
        frozen = type("FrozenTokenBucket", (real,), {
            "__init__": lambda self, qps, burst, *, clock=None, _real=real: _real.__init__(
                self, qps, burst, clock=lambda: 1000.0),
        })
        monkeypatch.setattr(mod, "TokenBucket", frozen)


def test_tenant_qps_bucket_sheds_typed_429(monkeypatch):
    _frozen_buckets(monkeypatch)
    got = _qps_script(T)
    assert got == _qps_script(J)
    assert got == [True, 429, "tenant_rate_limited", "noisy", True, {"tenant_rate_limited": 1}, 2, 1]


def _inflight_script(P):
    out = []
    with P.cfg.use_tenancy({"default": {"inflight": 2}}):
        ctl = _controller(P)
        t1 = ctl.admit(P.sv.Deadline(60_000), tenant="acme")
        ctl.admit(P.sv.Deadline(60_000), tenant="acme")
        with pytest.raises(P.sv.TenantRateLimited):
            ctl.admit(P.sv.Deadline(60_000), tenant="acme")
        out.append(P.met.TENANCY_METRICS.snapshot()["tenants"]["acme"]["inflight"])
        ctl.release(t1)
        ctl.admit(P.sv.Deadline(60_000), tenant="acme")  # the slot was freed
        out.append(P.met.TENANCY_METRICS.snapshot()["tenants"]["acme"]["inflight"])
    return out


def test_tenant_inflight_cap_and_release():
    assert _inflight_script(T) == _inflight_script(J) == [2, 2]


@BOTH
def test_untenanted_admission_ignores_tenancy_state(P):
    with P.cfg.use_tenancy({"default": {"qps": 0.001, "burst": 1, "inflight": 1}}):
        ctl = _controller(P)
        for _ in range(5):
            ctl.release(ctl.admit(P.sv.Deadline(60_000)))
    assert not P.met.TENANCY_METRICS.active()


# ------------------------------------------------ weighted deficit round-robin


def _batcher(P, batch_max=8):
    b = P.sv.AdaptiveBatcher(lambda items: None, config=P.sv.ServingConfig(batch_max=batch_max, batch_window_ms=0.0),
                             metrics=P.sv.ServingMetrics())
    # a sentinel worker, so submit() never starts the drain thread: these
    # scripts drive _take_batch() directly
    b._thread = threading.current_thread()
    return b


def _wdrr_script(P):
    b = _batcher(P)
    with P.cfg.use_tenancy({"quotas": {"heavy": {"weight": 3}, "light": {"weight": 1}}}):
        for i in range(12):
            b.submit(("heavy", i), P.sv.Deadline(60_000), tenant="heavy")
        for i in range(12):
            b.submit(("light", i), P.sv.Deadline(60_000), tenant="light")
        items, _, _, tenants = b._take_batch()
    return [items, tenants, b.pending()]


def test_wdrr_drains_tenants_by_quota_weight():
    got = _wdrr_script(T)
    assert [list(i) for i in got[0]] == [list(i) for i in _wdrr_script(J)[0]]
    assert got[1].count("heavy") == 6 and got[1].count("light") == 2 and got[2] == 16


def _legacy_script(P):
    b = _batcher(P)
    for i in range(4):
        b.submit(("none", i), P.sv.Deadline(60_000))
    for i in range(4):
        b.submit(("t", i), P.sv.Deadline(60_000), tenant="t")
    items, _, _, tenants = b._take_batch()
    return [items, tenants]


def test_wdrr_interleaves_legacy_heap_as_anonymous_tenant():
    got = _legacy_script(T)
    assert got == _legacy_script(J)
    assert got[1].count(None) == 4 and got[1].count("t") == 4


@BOTH
def test_untenanted_batcher_keeps_legacy_single_heap(P):
    b = _batcher(P, batch_max=4)
    for i in range(4):
        b.submit(i, P.sv.Deadline(60_000))
    assert not b._tenant_heaps and not b._rr
    items, _, _, tenants = b._take_batch()
    assert items == [0, 1, 2, 3] and tenants == [None] * 4


@BOTH
def test_wdrr_drops_expired_without_charging_deficit(P):
    b = _batcher(P)
    with P.cfg.use_tenancy(True):
        for i in range(3):
            b.submit(("dead", i), P.sv.Deadline(-1.0), tenant="dead")
        b.submit(("live", 0), P.sv.Deadline(60_000), tenant="live")
        items, _, _, tenants = b._take_batch()
    assert items == [("live", 0)] and tenants == ["live"] and b.dropped_expired_total == 3


# ------------------------------------------------------------ metric surfaces


@BOTH
def test_metric_tenants_knob(P, monkeypatch):
    assert P.met.metric_tenants() == 50
    for raw, want in (("3", 3), ("garbage", 50), ("0", 50)):
        monkeypatch.setenv("PATHWAY_METRIC_TENANTS", raw)
        assert P.met.metric_tenants() == want


def _fold_script(P):
    for i in range(4):
        P.met.TENANCY_METRICS.record_admit(f"t{i}")
    P.met.TENANCY_METRICS.record_shed("t2", "tenant_rate_limited")
    P.met.TENANCY_METRICS.record_shed("t3", "tenant_rate_limited")
    P.met.TENANCY_METRICS.add_chip_seconds("t3", 0.5)
    P.met.TENANCY_METRICS.set_index("t2", docs=7, hbm_bytes=100)
    return P.met.TENANCY_METRICS.snapshot()


def test_snapshot_folds_overflow_tenants_into_other(monkeypatch):
    monkeypatch.setenv("PATHWAY_METRIC_TENANTS", "2")
    got = _fold_script(T)
    assert got == _fold_script(J)
    assert set(got["tenants"]) == {"t0", "t1", "other"} and got["folded"] == 2
    assert got["tenants"]["other"]["shed"] == {"tenant_rate_limited": 2}


def test_prometheus_renders_folded_other_series(monkeypatch):
    monkeypatch.setenv("PATHWAY_METRIC_TENANTS", "2")
    texts = []
    for P in (J, T):
        for i in range(5):
            P.met.TENANCY_METRICS.record_admit(f"t{i}")
        P.met.TENANCY_METRICS.record_shed("t4", "tenant_rate_limited")
        texts.append("\n".join(P.http.MonitoringHttpServer._tenancy_lines()))
    assert texts[1] == texts[0]
    assert 'pathway_serving_tenant_admitted_total{tenant="other"} 3' in texts[1]
    assert 'tenant="t4"' not in texts[1] and "pathway_tenant_folded 3" in texts[1]


def test_tenancy_off_scrape_and_status_byte_identical():
    mon = T.mon.StatsMonitor()
    # the input / output latency gauges are wall-clock relative: pin them
    mon.input_latency_ms = lambda now=None: 0
    mon.output_latency_ms = lambda now=None: 0
    srv = T.http.MonitoringHttpServer(mon, port=0)
    quiet_prom, quiet_status = srv._prometheus(), srv._status()
    assert "pathway_tenant" not in quiet_prom and "tenants" not in json.loads(quiet_status)
    T.met.TENANCY_METRICS.record_admit("acme")
    assert "pathway_tenant_count" in srv._prometheus()
    assert json.loads(srv._status())["tenants"]["tenants"]["acme"]["admitted"] == 1
    T.met.TENANCY_METRICS.reset()
    assert srv._prometheus() == quiet_prom and srv._status() == quiet_status


def test_doctor_verdict_carries_tenant_rows():
    texts = []
    for P in (J, T):
        wd = P.ledger.HealthWatchdog()
        assert wd.verdict()["tenants"] is None
        assert "tenants:" not in P.ledger.render_verdict(wd.verdict())
        P.met.TENANCY_METRICS.record_admit("acme")
        P.met.TENANCY_METRICS.set_index("acme", docs=3, hbm_bytes=2048)
        v = wd.verdict()
        assert v["tenants"]["tenants"]["acme"]["docs"] == 3
        texts.append([line for line in P.ledger.render_verdict(v).splitlines() if "tenant" in line or "acme" in line])
    assert texts[1] == texts[0] and "tenants: 1 active" in texts[1][0]


def _imbalance_script(P):
    idx = _packed(P)
    rng = _rng(11)
    idx.add_tenant_batch("a", [0, 1, 2], rng.standard_normal((3, 8)))
    idx._publish_metrics()
    out = [idx._tenant_rows["a"], P.im.INDEX_METRICS.indexes[idx.name]["docs_shard"]]
    idx.remove_tenant("a", 0)
    idx._publish_metrics()
    return out + [P.im.INDEX_METRICS.indexes[idx.name]["docs_shard"]]


def test_imbalance_counts_live_rows_not_granted_extents():
    assert _imbalance_script(T) == _imbalance_script(J) == [T.packed._MIN_EXTENT, [3], [2]]


@BOTH
def test_live_docs_shard_matches_valid_mask_on_plain_index(P):
    idx = P.knn.DeviceKnnIndex(8, reserved_space=32, **P.dev)
    rng = _rng(12)
    idx.add_batch_arrays(list(range(5)), rng.standard_normal((5, 8)))
    assert idx._live_docs_shard() == [5]
    idx.remove(3)
    assert idx._live_docs_shard() == [4]
