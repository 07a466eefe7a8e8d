"""The port's index-plane metrics registry against the JAX package's, on
the CPU: the same per-shard counts, searches, merge times and tier events
give equal snapshots and equal ``pathway_index_*`` lines on ``/metrics``.

Tolerances: every value equal."""

from __future__ import annotations

import copy

import pytest

from pathway_tpu.internals import http_monitoring as jhm
from pathway_tpu.internals.ledger import LEDGER as JLEDGER
from pathway_tpu.ops import index_metrics as jim
from pathway_tpu_torch.internals import http_monitoring as thm
from pathway_tpu_torch.internals.ledger import LEDGER as TLEDGER
from pathway_tpu_torch.ops import index_metrics as tim


# the HBM ledger's state (``internals/ledger.DeviceLedger``)
_LEDGER_FIELDS = ("_rows", "_high", "_high_total", "_touched")


@pytest.fixture(autouse=True)
def _restore_hbm_ledgers():
    """Both packages' HBM ledgers as each test found them: a ledger left
    active by one package alone would add ``pathway_worker_hbm_bytes`` to
    that package's ``/metrics`` only, in a later file on the same worker."""
    saved = [(led, {f: copy.deepcopy(getattr(led, f)) for f in _LEDGER_FIELDS}) for led in (JLEDGER, TLEDGER)]
    yield
    for led, fields in saved:
        with led._lock:
            for f, v in fields.items():
                setattr(led, f, v)


SCRIPTS = {
    "flat": [("update", "knn0", [5, 0, 3, 8], 16), ("search", "knn0", 4), ("search", "knn0", 1),
             ("merge", 0.0003), ("merge", 0.02), ("merge", 2.0)],
    "two_indexes": [("update", "a", [1], 64), ("update", "b", [10, 10], 8), ("search", "b", 7),
                    ("update", "a", [2], 64), ("search", "a", 2)],
    "tiers": [("update_tiers", "t", [4, 4], 8, [10, 2], [100, 100], [40, 8]), ("tier_events", "t", 3, 1),
              ("tier_hits", "t", 9, 3), ("cold", 0.004), ("search", "t", 12)],
    "search_before_update": [("search", "late", 3), ("update", "late", [0, 2, 1], 4)],
}


def _play(mod, script):
    m = mod.IndexMetrics()
    for op, *args in script:
        if op == "update":
            m.update_index(*args)
        elif op == "update_tiers":
            name, docs, cap, cold, hot_b, cold_b = args
            m.update_index(name, docs, cap, cold_docs_shard=cold, hot_bytes_shard=hot_b, cold_bytes_shard=cold_b)
        elif op == "search":
            m.record_search(*args)
        elif op == "merge":
            m.observe_merge(*args)
        elif op == "tier_events":
            m.record_tier_events(args[0], promotions=args[1], demotions=args[2])
        elif op == "tier_hits":
            m.record_tier_hits(*args)
        elif op == "cold":
            m.observe_cold_fetch(*args)
    return m


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_snapshot_matches_the_reference(name):
    want, got = _play(jim, SCRIPTS[name]), _play(tim, SCRIPTS[name])
    assert got.snapshot() == want.snapshot()
    assert (got.active(), got.tiered_active()) == (want.active(), want.tiered_active())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_metrics_lines_match_the_reference(monkeypatch, name):
    monkeypatch.setattr(jim, "INDEX_METRICS", _play(jim, SCRIPTS[name]))
    monkeypatch.setattr(tim, "INDEX_METRICS", _play(tim, SCRIPTS[name]))
    assert thm.MonitoringHttpServer._index_lines("") == jhm.MonitoringHttpServer._index_lines("")


@pytest.mark.parametrize("docs", [[0], [3, 3, 3], [10, 0], [1, 2, 3, 4]])
def test_imbalance_matches_the_reference(docs):
    assert tim.IndexMetrics.imbalance(docs) == jim.IndexMetrics.imbalance(docs)


@pytest.mark.parametrize("seed", [0, 1])
def test_index_publishes_like_the_reference(monkeypatch, seed):
    """The same adds, removes (past a growth) and searches on each package's
    ``DeviceKnnIndex`` publish equal ``INDEX_METRICS`` entries; the port's
    live counts, kept from its free lists, equal its validity mask's."""
    import numpy as np

    from pathway_tpu.ops import knn as jknn
    from pathway_tpu_torch.ops import knn as tknn

    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    removed = rng.permutation(150)[:40].tolist()
    entries = []
    for mod, knn, kw in ((jim, jknn, {}), (tim, tknn, {"device": "cpu"})):
        metrics = mod.IndexMetrics()
        monkeypatch.setattr(mod, "INDEX_METRICS", metrics)
        monkeypatch.setattr(knn, "INDEX_METRICS", metrics, raising=False)
        index = knn.DeviceKnnIndex(dim=16, reserved_space=64, name="twin", **kw)
        index.add_batch([(i, vecs[i], None) for i in range(150)])
        for key in removed:
            index.remove(int(key))
        index.add_batch([(i, vecs[i], None) for i in range(150, 200)])
        index.search_batch(vecs[:3], 5)
        entries.append(metrics.snapshot()["indexes"]["twin"])
        if knn is tknn:
            mask = index._valid_host.reshape(index.n_shards, index.shard_capacity).sum(axis=1).tolist()
            assert index._live_docs_shard() == mask == [160]
    assert entries[1] == entries[0]
