"""Kernel B2 (fused KNN top-k) and ``DeviceKnnIndex`` of the PyTorch port
against the JAX package, on the CPU. ``knn_topk_reference`` (the plain
version the port's wrapper takes for CPU tensors) is held to the Pallas
kernel in interpret mode; the index is driven through the same add/remove
churn as the JAX ``DeviceKnnIndex``.

Tolerances: scores rtol 1e-5 (f32 sums in another order), indices and
keys equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn as jknn
from pathway_tpu.ops.pallas_knn import NEG as JNEG
from pathway_tpu.ops.pallas_knn import knn_topk as jknn_topk
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops.knn_topk import NEG, knn_topk, knn_topk_reference, topk_agreement


def _run_both(q, d, k, bias=None, factor=1.0, block_n=256):
    jv, ji = jknn_topk(q, d, k=k, bias=bias, factor=factor, block_q=8, block_n=block_n, interpret=True)
    tb = torch.from_numpy(bias) if bias is not None else None
    tv, ti = knn_topk(torch.from_numpy(q), torch.from_numpy(d), k=k, bias=tb, factor=factor)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _check(jv, ji, tv, ti):
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)


def test_constants_match():
    assert NEG == JNEG and tknn._NEG == jknn._NEG


def test_dot_topk_matches_kernel():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(13, 32)).astype(np.float32)
    d = rng.normal(size=(700, 32)).astype(np.float32)
    _check(*_run_both(q, d, 5))


def test_bias_masks_dead_slots():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    d = rng.normal(size=(100, 16)).astype(np.float32)
    valid = np.ones(100, bool)
    valid[::3] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    jv, ji, tv, ti = _run_both(q, d, 8, bias=bias, block_n=64)
    _check(jv, ji, tv, ti)
    assert not set(ti.ravel().tolist()) & set(np.nonzero(~valid)[0].tolist())


def test_l2_bias_and_factor():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    d = rng.normal(size=(300, 24)).astype(np.float32)
    bias = -(d * d).sum(axis=1).astype(np.float32)
    _check(*_run_both(q, d, 4, bias=bias, factor=2.0, block_n=128))


def test_k_beyond_live_docs_gives_minus_one():
    """k = 40 over 37 docs: padding never surfaces, the tail is (NEG, -1)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    d = -np.abs(rng.normal(size=(37, 8))).astype(np.float32)
    jv, ji, tv, ti = _run_both(q, d, 40, block_n=64)
    _check(jv, ji, tv, ti)
    assert (ti[:, 37:] == -1).all() and (tv[:, 37:] == NEG).all()


def test_exact_ties_go_to_lower_index():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(8, 16)).astype(np.float32)
    d = np.concatenate([base, base, base])  # every score appears three times
    q = rng.normal(size=(5, 16)).astype(np.float32)
    jv, ji, tv, ti = _run_both(q, d, 9, block_n=8)
    _check(jv, ji, tv, ti)
    best = np.argmax(q @ base.T, axis=1)
    assert (ti[:, 0] == best).all() and (ti[:, 1] == best + 8).all() and (ti[:, 2] == best + 16).all()


def test_k128_matches_kernel_fori_merge():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    d = rng.normal(size=(900, 16)).astype(np.float32)
    _check(*_run_both(q, d, 128))


def test_topk_agreement_accepts_boundary_ties_only():
    v = torch.tensor([[3.0, 2.0, 1.0]])
    assert topk_agreement(v, torch.tensor([[0, 1, 2]]), v, torch.tensor([[0, 1, 3]]), atol=1e-5)[1]
    assert not topk_agreement(v, torch.tensor([[0, 1, 2]]), v + 0.1, torch.tensor([[0, 1, 2]]), atol=1e-5)[1]
    far = torch.tensor([[3.0, 2.0, 1.0]]), torch.tensor([[3.0, 2.5, 1.0]])
    assert not topk_agreement(far[0], torch.tensor([[0, 5, 2]]), far[1], torch.tensor([[0, 1, 2]]), atol=1e-5)[1]


def _churn(index, rng, n=120, dim=16):
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    for i in range(n // 2):
        index.add(f"k{i}", vecs[i], metadata={"i": i})
    index.add_batch_arrays([f"k{i}" for i in range(n // 2, n)], vecs[n // 2 :], [{"i": i} for i in range(n // 2, n)])
    for i in range(0, n, 9):
        index.remove(f"k{i}")
    index.add("k3", vecs[5] + 0.25)  # re-add replaces
    return vecs


def _compare(expected, got, rtol=1e-5):
    assert len(expected) == len(got)
    for e_row, g_row in zip(expected, got):
        assert [k for k, _ in e_row] == [k for k, _ in g_row]
        np.testing.assert_allclose([s for _, s in e_row], [s for _, s in g_row], rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("metric", ["cos", "l2", "ip"])
def test_index_churn_parity(metric):
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    ji = jknn.DeviceKnnIndex(dim=16, metric=metric, reserved_space=64)
    ti = tknn.DeviceKnnIndex(dim=16, metric=metric, reserved_space=64, device="cpu")
    _churn(ji, rng_j)
    _churn(ti, rng_t)  # 120 rows into 64: capacity grows twice
    assert ti.capacity == ji.capacity == 128 and len(ti) == len(ji)
    q = np.random.default_rng(8).normal(size=(4, 16)).astype(np.float32)
    _compare(ji.search_batch(q, 5), ti.search_batch(q, 5))
    flt = [lambda m: m["i"] % 2 == 0] * 4  # filters starve the first fetch
    _compare(ji.search_batch(q, 6, flt), ti.search_batch(q, 6, flt))
    # churn after the first sync goes through the pending scatter path
    ji.remove("k1")
    ti.remove("k1")
    ji.add("new", q[0])
    ti.add("new", q[0])
    _compare(ji.search_batch(q, 7), ti.search_batch(q, 7))
    jv, jx = ji.search_dispatch(q, 3)
    tv, tx = ti.search_dispatch(q, 3)
    _compare(ji.search_resolve(jv, jx, 3), ti.search_resolve(tv, tx, 3))
    _compare([ji.search_one(q[1], 4)], [ti.search_one(q[1], 4)])


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_index_kernel_route_matches_pallas_formula(metric):
    """The fused route (_pallas_topk) on both sides, the JAX kernel in
    interpret mode: the same (key, score) lists as the plain route."""
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(50, 16)).astype(np.float32)
    ji = jknn.DeviceKnnIndex(dim=16, metric=metric)
    ti = tknn.DeviceKnnIndex(dim=16, metric=metric, device="cpu")
    for i, v in enumerate(vecs):
        ji.add(f"k{i}", v)
        ti.add(f"k{i}", v)
    ji.remove("k7")
    ti.remove("k7")
    q = rng.normal(size=(2, 16)).astype(np.float32)
    if metric == "cos":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    ji._sync()
    ti._sync()
    jv, jx = jknn._pallas_topk(metric, ji._dev_matrix, ji._dev_valid, q, 8)
    tv, tx = tknn._pallas_topk(metric, ti._dev_matrix, ti._dev_valid, torch.from_numpy(q), 8)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cos", "l2", "ip"])
def test_add_batch_device_parity_with_growth(metric):
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(150, 24)).astype(np.float32)
    ji = jknn.DeviceKnnIndex(dim=24, metric=metric, reserved_space=64)
    ti = tknn.DeviceKnnIndex(dim=24, metric=metric, reserved_space=64, device="cpu")
    keys = [f"d{i}" for i in range(100)]
    # 8 pad rows past the keys drop, as for bucket-padded encoder output
    ji.add_batch_device(keys, jnp.asarray(vecs[:108]))
    ti.add_batch_device(keys, torch.from_numpy(vecs[:108]))
    ji.add_batch_device([f"e{i}" for i in range(50)], jnp.asarray(vecs[100:]))  # grows past 128
    ti.add_batch_device([f"e{i}" for i in range(50)], torch.from_numpy(vecs[100:]))
    ji.remove("d3")
    ti.remove("d3")
    assert ti.capacity == ji.capacity == 256
    q = rng.normal(size=(3, 24)).astype(np.float32)
    _compare(ji.search_batch(q, 10), ti.search_batch(q, 10))
    _compare(ji.search_batch(q, 100), ti.search_batch(q, 100))  # fetch 128: plain top-k route


def test_fence_rejects_writes():
    ti = tknn.DeviceKnnIndex(dim=4, device="cpu")
    ti.add("a", np.ones(4))
    ti.fence(3)
    with pytest.raises(tknn.StaleGeneration):
        ti.add("b", np.ones(4))
    assert ti.search_batch(np.ones((1, 4)), 1)[0][0][0] == "a"


def test_k_bucket_matches_reference():
    for k in (1, 8, 9, 40, 64, 65, 1000):
        assert tknn._k_bucket(k) == jknn._k_bucket(k)


def test_reference_pads_past_doc_count():
    v, i = knn_topk_reference(torch.ones(2, 4), torch.ones(3, 4), k=5)
    assert v.shape == (2, 5) and (i[:, 3:] == -1).all() and (v[:, 3:] == NEG).all()
    assert i[:, :3].tolist() == [[0, 1, 2], [0, 1, 2]]


@pytest.mark.parametrize("metric", ["cos", "l2"])
@pytest.mark.parametrize("k", [5, 70], ids=["fetch8", "fetch128"])
def test_exact_ties_keep_reference_key_order(metric, k):
    """Duplicated vectors score exactly equal; ``lax.top_k`` puts the lower
    slot first, also where the tie group straddles the fetch boundary
    (12 copies at fetch 8, 90 copies at fetch 128)."""
    rng = np.random.default_rng(12)
    base = rng.normal(size=(3000, 16)).astype(np.float32)
    dup = [rng.normal(size=16).astype(np.float32) for _ in range(2)]
    slots = rng.permutation(3000)
    base[slots[:12]] = dup[0]
    base[slots[12:102]] = dup[1]
    keys = [f"k{i}" for i in range(3000)]
    ji = jknn.DeviceKnnIndex(dim=16, metric=metric, reserved_space=4096)
    ti = tknn.DeviceKnnIndex(dim=16, metric=metric, reserved_space=4096, device="cpu")
    ji.add_batch_arrays(keys, base)
    ti.add_batch_arrays(keys, base)
    q = np.stack(dup)
    want, got = ji.search_batch(q, k), ti.search_batch(q, k)
    assert [[key for key, _ in r] for r in got] == [[key for key, _ in r] for r in want]
    ranks = {key: int(key[1:]) for key in keys}
    assert [ranks[key] for key, _ in got[0][: min(k, 12)]] == sorted(int(s) for s in slots[:12])[: min(k, 12)]


def test_topk_lower_index_matches_stable_sort():
    rng = np.random.default_rng(13)
    scores = torch.from_numpy(rng.integers(-3, 4, size=(6, 500)).astype(np.float32))
    scores[0, ::2] = -0.0  # -0.0 and 0.0 tie, as they do under lax.top_k
    scores[1] = NEG
    for k in (1, 7, 64, 200):
        vals, idx = tknn._topk_lower_index(scores, k)
        sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
        assert torch.equal(idx, si[:, :k]) and torch.equal(vals, sv[:, :k])


# ---------------------------------------------------------------- B2 launch plan and small-q parity


@pytest.mark.parametrize("nd", [1, 63, 64, 65, 1 << 20])
@pytest.mark.parametrize("nq", [1, 2, 16, 17, 64, 256, 512])
def test_launch_plan_covers_every_tile_once(nq, nd):
    """The wrapper's plan at 132 SMs: the streaming kernel up to
    ``SMALL_Q_MAX`` queries, the tensor-core kernel above; every doc tile
    lies in exactly one split and no split is empty."""
    from pathway_tpu_torch.ops.knn_topk import SMALL_Q_MAX, launch_plan

    plan = launch_plan(nq, nd, 132)
    assert plan.regime == ("stream" if nq <= SMALL_Q_MAX else "tc")
    tiles = max(1, -(-nd // plan.tile))
    # split s scores tiles [s * tiles_per_split, min((s + 1) * tiles_per_split, tiles)), as the kernels do
    ranges = [range(s * plan.tiles_per_split, min((s + 1) * plan.tiles_per_split, tiles)) for s in range(plan.splits)]
    assert [t for r in ranges for t in r] == list(range(tiles))  # each tile once, in split order
    assert all(len(r) > 0 for r in ranges)
    blocks = plan.splits * (1 if plan.regime == "stream" else -(-nq // 64))
    assert blocks <= max(132, -(-nq // 64))  # about one block per SM: no more than a wave
    if plan.regime == "stream":
        assert 2 <= plan.stages <= 4
        assert plan.splits <= min(132, tiles)


def test_launch_plan_routes_wide_rows_and_rejects_unknown_regimes():
    from pathway_tpu_torch.ops.knn_topk import launch_plan

    assert launch_plan(1, 1000, 132, dim=384).regime == "stream"
    assert launch_plan(16, 1000, 132, dim=8192).regime == "tc"  # 16 queries' rows and a 2-deep ring do not fit
    assert launch_plan(2, 1000, 132, regime="tc").regime == "tc"
    assert launch_plan(70, 1000, 132, dim=50).regime == "stream"  # TMA needs rows of a multiple of 16 bytes
    assert launch_plan(17, 1000, 132, regime="stream").regime == "stream"  # 16 queries a launch
    with pytest.raises(ValueError, match="multiples of 4"):
        launch_plan(70, 1000, 132, dim=50, regime="tc")
    with pytest.raises(ValueError, match="multiples of 4"):  # too wide for the ring, odd for TMA
        launch_plan(1, 1000, 132, dim=50_001)
    with pytest.raises(ValueError, match="cannot hold"):
        launch_plan(1, 1000, 132, dim=50_001, regime="stream")
    with pytest.raises(ValueError, match="unknown"):
        launch_plan(1, 1000, 132, regime="simt")


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("metric", ["cos", "l2"])
@pytest.mark.parametrize("nq", [1, 16])
def test_small_q_matches_kernel_with_ties_and_dead_slots(nq, metric, k):
    """The streaming regime's shapes (one query, and 16 at the boundary)
    through the plain version and the Pallas kernel in interpret mode:
    dead slots never surface, duplicated doc rows tie exactly and go to
    the lower index."""
    rng = np.random.default_rng(20 + nq + k)
    d = rng.normal(size=(300, 24)).astype(np.float32)
    d[200:210] = d[3]  # ten exact copies of doc 3
    q = rng.normal(size=(nq, 24)).astype(np.float32)
    q[0] = d[3]
    if metric == "cos":
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.ones(300, bool)
    valid[::7] = False
    valid[3] = valid[200:210] = True
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    factor = 1.0
    if metric == "l2":
        bias = (bias - (d * d).sum(axis=1)).astype(np.float32)
        factor = 2.0
    jv, ji, tv, ti = _run_both(q, d, k, bias=bias, factor=factor, block_n=128)
    _check(jv, ji, tv, ti)
    assert not set(ti.ravel().tolist()) & set(np.nonzero(~valid)[0].tolist())
    assert ti[0, :11].tolist() == [3, *range(200, 210)]  # the tie group in ascending index order
