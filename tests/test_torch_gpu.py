"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card, at the main path's widths (MiniLM-L6: d 384, 12
heads of 32, FFN 1536; the decoder: d 256, 4 heads of 64) and at the other
head dims (64, 128, 256, and others zero-padded to the next of these),
LayerNorm widths (256 to 768, multiples of 512 from 1024 up staged, any
other width zero-padded to the next of these), attention at S past 512,
paged decode attention at head dims past 256 (column tiles) and
GEMM K and N that are not multiples of 8 (zero-padded to 8) the kernels
take. Every test here needs a CUDA device and skips
inside its fixture when there is none; run them on the card with
``pytest -m gpu tests/test_torch_*.py``.

Tolerances: kernel and plain version sum in different orders in f32, so
bf16 outputs may differ by one bf16 rounding step (rtol 1.6e-2, the
default bf16 tolerance of torch.testing, with atol 1e-2); f32 outputs by
1e-4; top-k scores by 1e-5 relative, indices equal up to near-ties."""

from __future__ import annotations

import math

import pytest
import torch

pytestmark = pytest.mark.gpu

BF16 = dict(rtol=1.6e-2, atol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize(
    "m,n,k,act",
    [
        (4096 + 37, 1152, 384, False), (4096 + 37, 1536, 384, True), (4096 + 37, 384, 384, False),
        # M from one token (the single-query embed is 32) to the main path's 1024 x 160, ragged M tails
        (1, 1152, 384, False), (17, 1536, 384, True), (32, 1152, 384, False), (64, 384, 384, False),
        (129, 1152, 384, False), (163_840, 1152, 384, False), (163_840, 1536, 384, True),
        # K deeper than the ring, and K not a multiple of the 64-deep stage (TMA zero-fills the tail)
        (4096 + 37, 384, 1536, False), (129, 1536, 1536, True), (4096 + 37, 1152, 40, False), (17, 384, 40, True),
    ],
)
def test_gemm_bias_act_matches_plain(cuda, m, n, k, act):
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_layer import gemm_bias_act, gemm_bias_act_reference

    g = _gen(m * 7 + n + k)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (0.05 * torch.randn(n, k, device=cuda, generator=g)).bfloat16()
    b = 0.1 * torch.randn(n, device=cuda, generator=g)
    before = _build.LAUNCHES["gemm_bias_act"]
    got = gemm_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gemm_bias_act"] == before + 1
    torch.testing.assert_close(got.float(), gemm_bias_act_reference(x, w, b, act).float(), **BF16)


@pytest.mark.parametrize("k,res_f32", [(384, False), (1536, True)])
def test_gemm_residual_layernorm_matches_plain(cuda, k, res_f32):
    from pathway_tpu_torch.ops.fused_layer import (
        gemm_bias_residual_layernorm,
        gemm_bias_residual_layernorm_reference,
    )

    g = _gen(k)
    m, n = 4096 + 19, 384
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (0.05 * torch.randn(n, k, device=cuda, generator=g)).bfloat16()
    b = 0.1 * torch.randn(n, device=cuda, generator=g)
    r = torch.randn(m, n, device=cuda, generator=g)
    r = r if res_f32 else r.bfloat16()
    gamma = 1.0 + 0.1 * torch.randn(n, device=cuda, generator=g)
    beta = 0.1 * torch.randn(n, device=cuda, generator=g)
    yf, yb = gemm_bias_residual_layernorm(x, w, b, r, gamma, beta, 1e-12)
    rf, rb = gemm_bias_residual_layernorm_reference(x, w, b, r, gamma, beta, 1e-12)
    torch.testing.assert_close(yf, rf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(yb.float(), rb.float(), **BF16)


@pytest.mark.parametrize("b,s,zero_empty", [(64, 160, True), (48, 128, False), (4, 512, False), (9, 37, True),
                                            (4, 1024, False), (3, 700, True), (2, 2100, False)])
def test_masked_attention_matches_plain(cuda, b, s, zero_empty):
    from pathway_tpu_torch.ops.fused_attention import masked_attention, masked_attention_reference

    g = _gen(s)
    qkv = torch.randn(b, s, 3 * 384, device=cuda, generator=g).bfloat16()
    lens = torch.randint(s // 2, s + 1, (b,), device=cuda, generator=g)
    lens[0] = 0  # a fully masked row
    lens[-1] = s
    mask = torch.arange(s, device=cuda)[None, :] < lens[:, None]
    got = masked_attention(qkv, mask, 12, zero_empty)
    want = masked_attention_reference(qkv, mask, 12, zero_empty)
    assert torch.isfinite(got.float()).all()
    # every query row, padded ones included
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    if zero_empty:
        assert (got[0] == 0).all()
    else:  # a fully masked row averages V uniformly
        mean_v = qkv[0, :, 2 * 384 :].float().mean(dim=0).expand(s, -1)
        torch.testing.assert_close(got[0].float(), mean_v, **BF16)


@pytest.mark.parametrize("zero_empty", [True, False])
@pytest.mark.parametrize("s", [1, 37, 128, 160, 512, 1024])
@pytest.mark.parametrize("hd", [32, 64, 128, 48])
def test_masked_attention_head_dims_match_plain(cuda, hd, s, zero_empty):
    """Every query row against the plain version, with a length-0 sequence,
    a scattered (non-prefix) mask and a full one; 48 runs zero-padded to 64."""
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_attention import masked_attention, masked_attention_reference

    heads, b = 4, 6
    g = _gen(hd * 1000 + s)
    qkv = torch.randn(b, s, 3 * heads * hd, device=cuda, generator=g).bfloat16()
    lens = torch.randint(0, s + 1, (b,), device=cuda, generator=g)
    lens[0], lens[-1] = 0, s
    mask = torch.arange(s, device=cuda)[None, :] < lens[:, None]
    mask[1] = torch.rand(s, device=cuda, generator=g) < 0.5
    before = _build.LAUNCHES["masked_attention"]
    got = masked_attention(qkv, mask, heads, zero_empty)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["masked_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), masked_attention_reference(qkv, mask, heads, zero_empty).float(), **BF16)
    if zero_empty:
        assert (got[0] == 0).all()
    else:  # a fully masked row averages V uniformly
        mean_v = qkv[0, :, 2 * heads * hd :].float().mean(dim=0).expand(s, -1)
        torch.testing.assert_close(got[0].float(), mean_v, **BF16)


def _ln_case(cuda, m, n, k, res_f32, seed):
    g = _gen(seed)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (0.05 * torch.randn(n, k, device=cuda, generator=g)).bfloat16()
    b = 0.1 * torch.randn(n, device=cuda, generator=g)
    r = 1.0 + torch.randn(m, n, device=cuda, generator=g)  # a mean away from 0
    r = r if res_f32 else r.bfloat16()
    gamma = 1.0 + 0.1 * torch.randn(n, device=cuda, generator=g)
    beta = 0.1 * torch.randn(n, device=cuda, generator=g)
    return x, w, b, r, gamma, beta


def _check_ln(cuda, m, n, k, res_f32, out_f32):
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_layer import (
        gemm_bias_residual_layernorm,
        gemm_bias_residual_layernorm_reference,
    )

    args = _ln_case(cuda, m, n, k, res_f32, seed=m * 7 + n + k)
    before = _build.LAUNCHES["gemm_bias_residual_layernorm"]
    yf, yb = gemm_bias_residual_layernorm(*args, 1e-12, out_f32=out_f32)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gemm_bias_residual_layernorm"] == before + 1
    rf, rb = gemm_bias_residual_layernorm_reference(*args, 1e-12, out_f32=True)
    assert (yf is None) == (not out_f32)
    if out_f32:
        torch.testing.assert_close(yf, rf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(yb.float(), rb.float(), **BF16)


@pytest.mark.parametrize("res_f32,out_f32", [(False, False), (True, True)])
@pytest.mark.parametrize("k", [40, 384, 1536])
@pytest.mark.parametrize("m", [1, 17, 129, 4096 + 19])
@pytest.mark.parametrize("n", [256, 384, 512, 768, 1024, 1536, 2048])
def test_gemm_residual_layernorm_widths_match_plain(cuda, n, m, k, res_f32, out_f32):
    """Every LayerNorm width, M tails (one row, part of a 64- or 128-row
    tile, many tiles per persistent block) and K tails (40: one zero-filled
    stage), with a bf16 or an f32 residual."""
    _check_ln(cuda, m, n, k, res_f32, out_f32)


@pytest.mark.parametrize("res_f32", [False, True])
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("n", [384, 1024, 1536])
def test_gemm_residual_layernorm_outputs_and_residuals(cuda, n, res_f32, out_f32):
    _check_ln(cuda, 129, n, 384, res_f32, out_f32)


@pytest.mark.parametrize("hd", [64, 128, 48, 256, 160])
def test_segment_attention_head_dims_match_plain(cuda, hd):
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_attention import segment_attention, segment_attention_reference

    rows, s, heads = 16, 512, 4
    g = _gen(hd)
    qkv = torch.randn(rows, s, 3 * heads * hd, device=cuda, generator=g).bfloat16()
    seg = _packed_segments(hd, rows, s, 64, 256, cuda)
    seg[-1] = -1  # an all-padding row
    before = _build.LAUNCHES["segment_attention"]
    got = segment_attention(qkv, seg, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["segment_attention"] == before + 1
    want = segment_attention_reference(qkv, seg, heads)
    live = seg >= 0
    torch.testing.assert_close(got[live].float(), want[live].float(), **BF16)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("metric,k", [("cos", 16), ("cos", 64), ("l2", 10), ("cos", 1)])
def test_knn_topk_matches_plain(cuda, metric, k):
    from pathway_tpu_torch.ops.knn import _pallas_bias
    from pathway_tpu_torch.ops.knn_topk import NEG, knn_topk, knn_topk_reference, topk_agreement

    g = _gen(k)
    n, d = 200_003, 384
    docs = torch.nn.functional.normalize(torch.randn(n, d, device=cuda, generator=g), dim=1)
    docs[100:110] = docs[5]  # exact ties
    valid = torch.rand(n, device=cuda, generator=g) > 0.1
    q = torch.nn.functional.normalize(torch.randn(77, d, device=cuda, generator=g), dim=1)
    q[0] = docs[5]
    bias = _pallas_bias(metric, docs, valid)
    factor = 2.0 if metric == "l2" else 1.0
    vals, idx = knn_topk(q, docs, k=k, bias=bias, factor=factor)
    rv, ri = knn_topk_reference(q, docs, k=k, bias=bias, factor=factor)
    share, ok = topk_agreement(vals, idx, rv, ri, atol=1e-5, rtol=1e-5)
    assert ok, share
    dead = (~valid).nonzero().flatten()
    assert not set(idx.flatten().tolist()) & set(dead.tolist())
    assert (vals > NEG / 2).all()


def test_knn_topk_fewer_live_docs_than_k(cuda):
    from pathway_tpu_torch.ops.knn_topk import NEG, knn_topk, knn_topk_reference

    g = _gen(3)
    docs = torch.randn(5000, 64, device=cuda, generator=g)
    bias = torch.full((5000,), NEG, device=cuda)
    bias[[7, 4000, 4999]] = 0.0
    q = torch.randn(3, 64, device=cuda, generator=g)
    vals, idx = knn_topk(q, docs, k=40, bias=bias)
    rv, ri = knn_topk_reference(q, docs, k=40, bias=bias)
    assert torch.equal(idx, ri)
    torch.testing.assert_close(vals, rv, rtol=1e-5, atol=1e-5)
    assert (idx[:, 3:] == -1).all() and (vals[:, 3:] == NEG).all()


def _knn_case(cuda, nq, metric, seed, n=70_001, d=384):
    """``n`` docs (not a multiple of either kernel's tile), 10 % dead, ten
    exact copies of doc 5 (a tie group straddling k), query 0 on doc 5."""
    from pathway_tpu_torch.ops.knn import _pallas_bias

    g = _gen(seed)
    docs = torch.nn.functional.normalize(torch.randn(n, d, device=cuda, generator=g), dim=1)
    docs[60_000:60_010] = docs[5]
    valid = torch.rand(n, device=cuda, generator=g) > 0.1
    valid[5] = True
    valid[60_000:60_010] = True
    q = torch.nn.functional.normalize(torch.randn(nq, d, device=cuda, generator=g), dim=1)
    q[0] = docs[5]
    return q, docs, valid, _pallas_bias(metric, docs, valid), 2.0 if metric == "l2" else 1.0


@pytest.mark.parametrize("metric", ["cos", "l2"])
@pytest.mark.parametrize("k", [1, 16, 33, 64])
@pytest.mark.parametrize(
    "nq,regime",
    [(1, "stream"), (5, "stream"), (16, "stream"), (1, "tc"), (16, "tc"), (17, "tc"), (64, "tc"), (256, "tc")],
)
def test_knn_topk_regimes_match_plain(cuda, nq, regime, k, metric):
    """Both partial passes (the streaming kernel up to 16 queries, the
    3xTF32 tensor-core kernel at any count) against the plain version; the
    launch counters rise for the partial pass and the merge."""
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import NEG, knn_topk, knn_topk_reference, topk_agreement

    q, docs, valid, bias, factor = _knn_case(cuda, nq, metric, nq * 100 + k)
    before = dict(_build.LAUNCHES)
    vals, idx = knn_topk(q, docs, k=k, bias=bias, factor=factor, regime=regime)
    torch.cuda.synchronize()
    for key in (f"knn_topk_{regime}", "knn_topk_merge"):
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1, key
    rv, ri = knn_topk_reference(q, docs, k=k, bias=bias, factor=factor)
    share, ok = topk_agreement(vals, idx, rv, ri, atol=1e-5, rtol=1e-5)
    assert ok, share
    assert not set(idx.flatten().tolist()) & set((~valid).nonzero().flatten().tolist())
    assert (vals > NEG / 2).all()
    # the exact copies of doc 5 score alike and come in ascending index order
    assert idx[0, : min(k, 11)].tolist() == [5, *range(60_000, 60_010)][: min(k, 11)]


@pytest.mark.parametrize(
    "regime,nq,dim",
    [("stream", 3, 64), ("stream", 16, 64), ("tc", 3, 64), ("tc", 70, 64), ("stream", 3, 50), ("stream", 40, 50)],
)
def test_knn_topk_regimes_fewer_live_docs_than_k(cuda, regime, nq, dim):
    """Three live docs among 5,000 at k 40: the tail is (NEG, -1); a width
    not a multiple of 4 takes the streaming kernel's 4-byte copies, 16
    queries a launch."""
    from pathway_tpu_torch.ops.knn_topk import NEG, knn_topk, knn_topk_reference

    g = _gen(nq + dim)
    docs = torch.randn(5000, dim, device=cuda, generator=g)
    bias = torch.full((5000,), NEG, device=cuda)
    bias[[7, 4000, 4999]] = 0.0
    q = torch.randn(nq, dim, device=cuda, generator=g)
    vals, idx = knn_topk(q, docs, k=40, bias=bias, regime=regime)
    rv, ri = knn_topk_reference(q, docs, k=40, bias=bias)
    assert torch.equal(idx, ri)
    torch.testing.assert_close(vals, rv, rtol=1e-5, atol=1e-5)
    assert (idx[:, 3:] == -1).all() and (vals[:, 3:] == NEG).all()


def _shard_case(cuda, nq, metric, n_shards, rows=40_000, d=384, seed=0):
    """``n_shards`` x ``rows`` docs (views of one slab on the card), 10 % dead,
    exact copies of doc 5 in the last shard (a tie group across shards)."""
    from pathway_tpu_torch.ops.knn import _pallas_bias

    g = _gen(seed + nq + n_shards)
    n = n_shards * rows
    docs = torch.nn.functional.normalize(torch.randn(n, d, device=cuda, generator=g), dim=1)
    docs[n - 10 :] = docs[5]
    valid = torch.rand(n, device=cuda, generator=g) > 0.1
    valid[5] = True
    valid[n - 10 :] = True
    q = torch.nn.functional.normalize(torch.randn(nq, d, device=cuda, generator=g), dim=1)
    q[0] = docs[5]
    bias = _pallas_bias(metric, docs, valid)
    return q, docs, bias, list(docs.split(rows)), list(bias.split(rows)), 2.0 if metric == "l2" else 1.0


@pytest.mark.parametrize("metric", ["cos", "l2"])
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("nq,regime", [(1, "stream"), (16, "stream"), (70, "tc")])
def test_knn_topk_sharded_matches_plain(cuda, nq, regime, n_shards, metric):
    """Shards on one card: each runs its partial pass and its merge with a
    base, then one cross-shard merge; the result equals the plain version and
    one unsharded top-k, ties across shards to the lower global row."""
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import (
        knn_topk_reference, knn_topk_sharded, knn_topk_sharded_reference, topk_agreement,
    )

    k = 16
    q, docs, bias, doc_shards, bias_shards, factor = _shard_case(cuda, nq, metric, n_shards)
    before = dict(_build.LAUNCHES)
    vals, idx = knn_topk_sharded(q, doc_shards, bias_shards, k=k, factor=factor, regime=regime)
    torch.cuda.synchronize()
    for key, n in ((f"knn_topk_{regime}", n_shards), ("knn_topk_merge", n_shards), ("knn_topk_sharded_merge", 1)):
        assert _build.LAUNCHES[key] == before.get(key, 0) + n, key
    after = dict(_build.LAUNCHES)
    plain = (knn_topk_sharded_reference(q, doc_shards, bias_shards, k=k, factor=factor),
             knn_topk_reference(q, docs, k=k, bias=bias, factor=factor))
    assert dict(_build.LAUNCHES) == after  # the plain versions launch no kernel
    for rv, ri in plain:
        share, ok = topk_agreement(vals, idx, rv, ri, atol=1e-5, rtol=1e-5)
        assert ok, share
    n = docs.shape[0]
    assert idx[0, :11].tolist() == [5, *range(n - 10, n)]


def test_knn_topk_merge_shifts_by_base(cuda):
    """The single-shard merge with a base: live ids shift, dead ones stay -1."""
    from pathway_tpu_torch.ops.knn_topk import NEG, _topk_into, knn_topk

    g = _gen(11)
    docs = torch.randn(5000, 64, device=cuda, generator=g)
    bias = torch.full((5000,), NEG, device=cuda)
    bias[[7, 4000, 4999]] = 0.0
    q = torch.randn(3, 64, device=cuda, generator=g)
    want_s, want_i = knn_topk(q, docs, k=8, bias=bias)
    out_s = torch.empty((3, 2, 8), device=cuda)
    out_i = torch.empty((3, 2, 8), dtype=torch.int32, device=cuda)
    _topk_into(q, docs, bias, k=8, factor=1.0, regime=None, out_s=out_s[:, 1], out_i=out_i[:, 1], base=123_456)
    torch.cuda.synchronize()
    assert torch.equal(out_s[:, 1], want_s)
    assert torch.equal(out_i[:, 1], torch.where(want_i >= 0, want_i + 123_456, -1))
    assert (out_i[:, 1, 3:] == -1).all()


def test_knn_topk_sharded_across_cards(cuda):
    """One shard a card: another card's result reaches the first by a peer
    copy ordered against the first card's stream."""
    from pathway_tpu_torch.ops.knn_topk import knn_topk_reference, knn_topk_sharded, topk_agreement

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA cards")
    q, docs, bias, doc_shards, bias_shards, _ = _shard_case(cuda, 5, "cos", n_cards)
    moved = [t.to(f"cuda:{s}") for s, t in enumerate(doc_shards)]
    moved_b = [t.to(f"cuda:{s}") for s, t in enumerate(bias_shards)]
    vals, idx = knn_topk_sharded(q, moved, moved_b, k=16)
    assert vals.device == docs.device
    rv, ri = knn_topk_reference(q, docs, k=16, bias=bias)
    assert topk_agreement(vals, idx, rv, ri, atol=1e-5, rtol=1e-5)[1]


def test_mesh_index_on_one_card_equals_unsharded(cuda):
    """``DeviceKnnIndex`` over 4 shards of one card (the kernel path at
    fetch <= 64, the plain two-phase search above) against the unsharded
    index, holding the same keys and rows."""
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.knn_topk import topk_agreement
    from pathway_tpu_torch.parallel.sharding import make_mesh

    g = _gen(21)
    mesh = make_mesh(devices=[cuda] * 4, model_parallel=1)
    sharded = DeviceKnnIndex(dim=384, metric="cos", reserved_space=1 << 16, mesh=mesh)
    plain = DeviceKnnIndex(dim=384, metric="cos", reserved_space=1 << 16, device=cuda)
    vecs = torch.randn(50_000, 384, device=cuda, generator=g)
    for idx in (sharded, plain):
        idx.add_batch_device(list(range(50_000)), vecs)
        for key in range(0, 50_000, 100):
            idx.remove(key)
    queries = vecs[1:400:7]
    for k in (10, 100):
        a, b = sharded.search_batch(queries, k), plain.search_batch(queries, k)
        hits = [torch.tensor([[hit[j] for hit in row] for row in res], dtype=torch.float64)
                for res in (a, b) for j in (1, 0)]
        share, ok = topk_agreement(*hits, atol=1e-5, rtol=1e-5)
        assert ok, share


def test_encoder_forward_kernels_match_plain(cuda):
    import dataclasses

    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_layer import encoder_forward

    cfg = EncoderConfig.minilm_l6()
    params = {k: v.to(cuda) for k, v in init_params(cfg, seed=0).items()}
    g = _gen(0)
    b, s = 96, 160
    ids = torch.randint(999, 29000, (b, s), device=cuda, generator=g, dtype=torch.int32)
    lens = torch.randint(80, s + 1, (b,), device=cuda, generator=g, dtype=torch.int32)
    lens[-5:] = 0
    mask = torch.arange(s, device=cuda)[None, :] < lens[:, None]
    _build.reset_launches()
    got = encoder_forward(params, cfg, ids, mask, lens=lens)
    assert _build.LAUNCHES["masked_attention"] == cfg.num_layers
    assert _build.LAUNCHES["gemm_bias_act"] == 2 * cfg.num_layers
    assert _build.LAUNCHES["gemm_bias_residual_layernorm"] == 2 * cfg.num_layers
    want = encoder_forward(params, dataclasses.replace(cfg, layer_impl="plain"), ids, mask, lens=lens)
    assert torch.isfinite(got).all()
    assert (got[-5:] == 0).all()
    err = (got - want).abs().max().item()
    cos = (got[:-5] * want[:-5]).sum(dim=1).min().item()
    assert err < 3e-2 and cos > 0.999, (err, cos)


def test_index_search_kernel_matches_plain_path(cuda):
    import numpy as np

    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    rng = np.random.default_rng(0)
    for metric in ("cos", "l2", "ip"):
        index = DeviceKnnIndex(dim=48, metric=metric, reserved_space=512, device="cuda")
        index.add_batch_arrays([f"k{i}" for i in range(3000)], rng.normal(size=(3000, 48)))
        for i in range(0, 3000, 7):
            index.remove(f"k{i}")
        q = rng.normal(size=(9, 48)).astype(np.float32)
        got = index.search_batch(q, 10)  # kernel (fetch 16)
        wide = index.search_batch(q, 100)  # torch.topk (fetch 128)
        for g_row, w_row in zip(got, wide):
            assert [key for key, _ in g_row] == [key for key, _ in w_row[:10]]
            assert math.isclose(g_row[0][1], w_row[0][1], rel_tol=1e-5, abs_tol=1e-5)


def _packed_segments(g, rows, length, lo, hi, device):
    """Segment ids of ``rows`` rows of ``length`` tokens filled back to back
    with chunks of lo..hi tokens (ids unique across rows), -1 in the tail."""
    seg = torch.full((rows, length), -1, dtype=torch.int32)
    sizes = torch.randint(lo, hi + 1, (rows * (length // lo + 1),), generator=torch.Generator().manual_seed(g))
    k = 0
    for r in range(rows):
        off, s = 0, 0
        while s < 8 and off + int(sizes[k]) <= length:
            seg[r, off : off + int(sizes[k])] = r * 8 + s
            off += int(sizes[k])
            s += 1
            k += 1
    return seg.to(device)


@pytest.mark.parametrize(
    "rows,s,lo,hi",
    [
        (64, 512, 64, 256),  # the packed ingest's rows
        (7, 512, 0, 0),  # ids scattered through the row: the kernel is exact for any ids
        (5, 37, 5, 20),  # S not a multiple of the 64-key tile
        (6, 100, 10, 40),
        (3, 512, 512, 512),  # one 512-token segment per row
        (8, 512, 20, 90),  # short segments that straddle 64-key tiles
        (6, 1024, 64, 256),  # rows past 512 tokens
        (4, 1030, 0, 0),
        (2, 3000, 300, 900),
    ],
)
def test_segment_attention_matches_plain(cuda, rows, s, lo, hi):
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_attention import segment_attention, segment_attention_reference

    g = _gen(rows * 1000 + s)
    qkv = torch.randn(rows, s, 3 * 384, device=cuda, generator=g).bfloat16()
    if lo:
        seg = _packed_segments(rows, rows, s, lo, hi, cuda)
    else:  # non-contiguous ids, -1 mixed in
        seg = torch.randint(-1, 5, (rows, s), device=cuda, generator=g, dtype=torch.int32)
        seg = torch.where(seg >= 0, seg + 5 * torch.arange(rows, device=cuda, dtype=torch.int32)[:, None], seg)
    seg[-1] = -1  # an all-padding row
    before = _build.LAUNCHES["segment_attention"]
    got = segment_attention(qkv, seg, 12)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["segment_attention"] == before + 1
    want = segment_attention_reference(qkv, seg, 12)
    assert torch.isfinite(got.float()).all()
    live = seg >= 0
    torch.testing.assert_close(got[live].float(), want[live].float(), **BF16)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("hd", [64, 32, 128])
def test_paged_decode_attention_matches_plain(cuda, hd):
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    g = _gen(hd)
    lanes, d, n_pages, page, pps = 8, 256, 512, 16, 10
    q = torch.randn(lanes, d, device=cuda, generator=g)
    kp = torch.randn(n_pages, page, d, device=cuda, generator=g)
    vp = torch.randn(n_pages, page, d, device=cuda, generator=g)
    tables = torch.stack([torch.randperm(n_pages, device=cuda, generator=g)[:pps] for _ in range(lanes)]).int()
    tables[1, :4] = tables[0, :4]  # shared prefix pages
    tables[2, -1] = n_pages + 3  # out of range: clamped, and past the length
    lens = torch.randint(1, pps * page + 1, (lanes,), device=cuda, generator=g, dtype=torch.int32)
    lens[2] = (pps - 1) * page
    lens[3] = 0
    before = _build.LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, kp, vp, tables, lens, n_heads=d // hd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    want = paged_attention_reference(q, kp, vp, tables, lens, n_heads=d // hd)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got[3] == 0).all()


def test_encoder_forward_at_head_dim_64_matches_plain(cuda):
    """BERT-base width (d 768, 12 heads of 64, FFN 3072), two layers: the
    whole-layer kernels against their plain versions."""
    import dataclasses

    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_layer import encoder_forward

    cfg = EncoderConfig(hidden_size=768, num_layers=2, num_heads=12, intermediate_size=3072)
    params = {k: v.to(cuda) for k, v in init_params(cfg, seed=0).items()}
    g = _gen(1)
    b, s = 32, 128
    ids = torch.randint(999, 29000, (b, s), device=cuda, generator=g, dtype=torch.int32)
    lens = torch.randint(1, s + 1, (b,), device=cuda, generator=g, dtype=torch.int32)
    lens[-2:] = 0
    mask = torch.arange(s, device=cuda)[None, :] < lens[:, None]
    _build.reset_launches()
    got = encoder_forward(params, cfg, ids, mask, lens=lens)
    assert _build.LAUNCHES["masked_attention"] == cfg.num_layers
    assert _build.LAUNCHES["gemm_bias_residual_layernorm"] == 2 * cfg.num_layers
    want = encoder_forward(params, dataclasses.replace(cfg, layer_impl="plain"), ids, mask, lens=lens)
    assert torch.isfinite(got).all() and (got[-2:] == 0).all()
    err = (got - want).abs().max().item()
    cos = (got[:-2] * want[:-2]).sum(dim=1).min().item()
    assert err < 3e-2 and cos > 0.999, (err, cos)


@pytest.mark.parametrize("page,pps", [(16, 10), (16, 2), (48, 5), (100, 3)])
@pytest.mark.parametrize("hd", [32, 48, 64, 128, 256, 50, 260, 320, 512, 1024])
def test_paged_decode_attention_head_dims_and_splits_match_plain(cuda, hd, page, pps):
    """Every head dim up to 256 (50: rows of 4-byte copies), one split or
    several, pages larger than a split: lengths 0, 1, a page boundary and
    the full context, an out-of-range entry past the length; the split
    kernel launches once and the combine once when the context spans more
    than one split."""
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.paged_attention import (
        decode_split_plan,
        paged_attention_reference,
        paged_decode_attention,
    )

    heads, lanes, n_pages = 2, 6, 64
    d = heads * hd
    g = _gen(hd * 1000 + page + pps)
    q = torch.randn(lanes, d, device=cuda, generator=g)
    kp = torch.randn(n_pages, page, d, device=cuda, generator=g)
    vp = torch.randn(n_pages, page, d, device=cuda, generator=g)
    tables = torch.stack([torch.randperm(n_pages, device=cuda, generator=g)[:pps] for _ in range(lanes)]).int()
    tables[1, : pps // 2] = tables[0, : pps // 2]  # shared prefix pages
    lens = torch.tensor([0, 1, page, pps * page, pps * page - 1, (pps - 1) * page], dtype=torch.int32, device=cuda)
    tables[5, -1] = n_pages + 3  # out of range: clamped, and past the length
    before = dict(_build.LAUNCHES)
    got = paged_decode_attention(q, kp, vp, tables, lens, n_heads=heads)
    torch.cuda.synchronize()
    _, splits = decode_split_plan(pps, page)
    assert _build.LAUNCHES["paged_decode_attention"] == before.get("paged_decode_attention", 0) + 1
    assert _build.LAUNCHES["paged_decode_combine"] == before.get("paged_decode_combine", 0) + (splits > 1)
    want = paged_attention_reference(q, kp, vp, tables, lens, n_heads=heads)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got[0] == 0).all()


# ---- geometry repairs: widths the kernels take only zero-padded


@pytest.mark.parametrize(
    "m,n,k,act",
    [(129, 1152, 36, False), (4096 + 37, 100, 384, True), (17, 30, 12, False), (1, 1000, 1003, True)],
)
def test_gemm_bias_act_unaligned_k_and_n_match_plain(cuda, m, n, k, act):
    """K or N not a multiple of 8: the wrapper pads to one and slices back,
    one launch, the weight padded once."""
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import fused_layer as fl

    g = _gen(m + n * 3 + k)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (0.05 * torch.randn(n, k, device=cuda, generator=g)).bfloat16()
    b = 0.1 * torch.randn(n, device=cuda, generator=g)
    before = _build.LAUNCHES["gemm_bias_act"]
    got = fl.gemm_bias_act(x, w, b, act)
    again = fl.gemm_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gemm_bias_act"] == before + 2
    assert got.shape == (m, n) and got.is_contiguous() and torch.equal(got, again)
    assert sum(key[0] == id(w) for key in fl._PADDED) == 1
    torch.testing.assert_close(got.float(), fl.gemm_bias_act_reference(x, w, b, act).float(), **BF16)


@pytest.mark.parametrize("res_f32,out_f32", [(False, False), (True, True)])
@pytest.mark.parametrize("k", [40, 36, 384])
@pytest.mark.parametrize("m", [17, 4096 + 19])
@pytest.mark.parametrize("n", [8, 128, 200, 312, 640, 776, 1000, 1020, 1032, 1800])
def test_gemm_residual_layernorm_padded_widths_match_plain(cuda, n, m, k, res_f32, out_f32):
    """Widths outside the kernel's five, run at the next one with the pad
    columns left out of the statistics (776-1020: the two-chunk width), and
    K not a multiple of 8 (36); the residual's rows have a mean away from 0."""
    _check_ln(cuda, m, n, k, res_f32, out_f32)


@pytest.mark.parametrize("zero_empty", [True, False])
@pytest.mark.parametrize("s", [37, 160, 512, 1024])
@pytest.mark.parametrize("hd", [256, 192, 130])
def test_masked_attention_head_dims_over_128_match_plain(cuda, hd, s, zero_empty):
    """The head-dim-256 kernel (Q read from shared memory at each key tile),
    and 129-255 zero-padded to it."""
    test_masked_attention_head_dims_match_plain(cuda, hd, s, zero_empty)


@pytest.mark.parametrize("hidden,heads,ffn", [(128, 2, 512), (312, 12, 1200), (512, 2, 2048)])
def test_encoder_forward_at_public_small_widths_matches_plain(cuda, hidden, heads, ffn):
    """Widths of public small checkpoints: bert-tiny (d 128, 2 heads of 64,
    LayerNorm padded to 256), TinyBERT-4L-312 (d 312, 12 heads of 26 padded
    to 32, LayerNorm padded to 384) and d 512 at 2 heads of 256."""
    import dataclasses

    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_layer import encoder_forward, prepare_params

    cfg = EncoderConfig(hidden_size=hidden, num_layers=2, num_heads=heads, intermediate_size=ffn)
    params = prepare_params({k: v.to(cuda) for k, v in init_params(cfg, seed=0).items()}, cfg)
    g = _gen(hidden)
    b, s = 32, 128
    ids = torch.randint(999, 29000, (b, s), device=cuda, generator=g, dtype=torch.int32)
    lens = torch.randint(1, s + 1, (b,), device=cuda, generator=g, dtype=torch.int32)
    lens[-2:] = 0
    mask = torch.arange(s, device=cuda)[None, :] < lens[:, None]
    _build.reset_launches()
    got = encoder_forward(params, cfg, ids, mask, lens=lens)
    assert _build.LAUNCHES["masked_attention"] == cfg.num_layers
    assert _build.LAUNCHES["gemm_bias_residual_layernorm"] == 2 * cfg.num_layers
    want = encoder_forward(params, dataclasses.replace(cfg, layer_impl="plain"), ids, mask, lens=lens)
    assert got.shape == (b, hidden) and torch.isfinite(got).all() and (got[-2:] == 0).all()
    err = (got - want).abs().max().item()
    cos = (got[:-2] * want[:-2]).sum(dim=1).min().item()
    assert err < 3e-2 and cos > 0.999, (err, cos)


def test_rag_server_on_the_card_answers_as_the_library_path(cuda, tmp_path, monkeypatch):
    """The README's RAG server (``pw.io.fs.read`` -> ``ParseUtf8`` ->
    ``TokenCountSplitter`` -> ``SentenceTransformerEmbedder`` at MiniLM-L6
    width, seeded -> ``VectorStoreServer.run_server``) over a tiny folder on
    the card: one ``/v1/retrieve`` answer equals the library path's hits
    (``encode_device`` -> ``add_batch_device`` -> ``search_texts_batch`` on
    the same chunk texts in the same batch), scores within 1e-5."""
    import json
    import socket
    import urllib.request

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
    words = "river stone cloud light apple graph epoch delta kappa sigma tau omega".split()
    g = torch.Generator().manual_seed(3)
    for i in range(4):
        text = ". ".join(" ".join(words[j] for j in torch.randint(0, len(words), (8,), generator=g).tolist())
                         for _ in range(3 + i)) + "."
        (tmp_path / f"d{i}.txt").write_text(text)
    embedder = pw.xpacks.llm.embedders.SentenceTransformerEmbedder()
    batches, adds = [], []
    real_encode, real_add = embedder.encode_device, DeviceKnnIndex.add_batch_device

    def encode_device(texts, pad_to=None):
        batches.append((list(texts), pad_to))
        return real_encode(texts, pad_to=pad_to)

    def add_batch_device(self, keys, vecs, metas=None):
        adds.append((list(keys), [m.value if hasattr(m, "value") else m for m in metas]))
        return real_add(self, keys, vecs, metas)

    runners = []
    real_init = GraphRunner.__init__

    def recording_init(self, *a, **k):
        real_init(self, *a, **k)
        runners.append(self)

    monkeypatch.setattr(embedder, "encode_device", encode_device)
    monkeypatch.setattr(DeviceKnnIndex, "add_batch_device", add_batch_device)
    monkeypatch.setattr(GraphRunner, "__init__", recording_init)
    pw.clear_graph()
    docs = pw.io.fs.read(str(tmp_path), format="binary", mode="streaming", with_metadata=True)
    server = pw.xpacks.llm.VectorStoreServer(docs, embedder=embedder, parser=pw.xpacks.llm.parsers.ParseUtf8(),
                                             splitter=pw.xpacks.llm.splitters.TokenCountSplitter(max_tokens=20))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def post(path, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    _build.reset_launches()
    run = server.run_server(host="127.0.0.1", port=port, threaded=True)
    try:
        for _ in range(1200):
            try:
                if post("/v1/statistics", {})["file_count"] == 4:
                    break
            except OSError:
                pass
            torch.cuda.synchronize()
        query = batches[0][0][1]
        got = post("/v1/retrieve", {"query": query, "k": 3})
    finally:
        runners[-1].engine.stop()
        run.join(timeout=60)
        pw.clear_graph()
    assert not run.is_alive()
    assert len(batches) == len(adds) == 1 and _build.LAUNCHES["knn_topk_stream"] >= 1
    assert _build.LAUNCHES["gemm_bias_act"] >= 1 and _build.LAUNCHES["masked_attention"] >= 1
    texts, pad_to = batches[0]
    keys, metas = adds[0]
    lib = DeviceKnnIndex(dim=embedder.get_embedding_dimension(), metric="cos", reserved_space=64, device=cuda)
    real_add(lib, keys, real_encode(texts, pad_to=pad_to))
    lib.attach_encoder(embedder._encoder)
    want = lib.search_texts_batch([query], 3)[0]
    by_key = {k: (m["path"], t) for k, t, m in zip(keys, texts, metas)}
    assert [(h["metadata"]["path"], h["text"]) for h in got] == [by_key[k] for k, _ in want]
    assert got[0]["text"] == query
    for h, (_, score) in zip(got, want):
        assert abs(h["dist"] + score) <= 1e-5
