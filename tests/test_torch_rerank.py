"""``CrossEncoderHead``, ``CrossEncoderScorer``, ``DeviceReranker`` and
``as_reranker`` of the PyTorch port against the JAX package, on the CPU,
with the JAX package's cross-encoder weights bridged through
``weights.py``.

Tolerances: float32 scores within 1e-4 (the same math summed in another
order), bf16 scores within 3e-2 of their scale; permutations equal (float32
geometry, where no two scores lie within rounding of each other)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.models import reranker as jrr
from pathway_tpu.models.encoder import CrossEncoderHead as JHead
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.encoder import init_params as jinit
from pathway_tpu.models.sentence_encoder import CrossEncoderScorer as JScorer
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch.models import reranker as trr
from pathway_tpu_torch.models.encoder import CrossEncoderHead, init_cross_encoder_params
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.sentence_encoder import CrossEncoderScorer
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_cross_encoder_params, to_jax_cross_encoder_params

TINY = dict(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=128)
WORDS = [f"w{i}" for i in range(200)]


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _scorers(dtype="float32"):
    jcfg = JCfg.cross_encoder_l6(**TINY, dtype=getattr(jnp, dtype))
    tcfg = TCfg.cross_encoder_l6(**TINY, dtype=getattr(torch, dtype))
    js = JScorer(config=jcfg, checkpoint_dir="/nonexistent", max_seq_len=64, max_batch=8)
    js.tokenizer = JTok(vocab_size=TINY["vocab_size"])
    ts = CrossEncoderScorer(config=tcfg, max_seq_len=64, max_batch=8, device="cpu",
                            params=from_jax_cross_encoder_params(_tree(js.params)))
    ts.tokenizer = TTok(vocab_size=TINY["vocab_size"])
    return js, ts


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    text = lambda lo, hi: " ".join(rng.choice(WORDS, rng.integers(lo, hi + 1)))  # noqa: E731
    return [(text(2, 8), text(5, 60)) for _ in range(n)]


def test_cross_encoder_weight_bridge_round_trip_is_exact():
    cfg = JCfg.cross_encoder_l6(**TINY)
    tree = _tree(jinit(JHead(cfg), cfg))
    sd = from_jax_cross_encoder_params(tree)
    assert sd["classifier.weight"].shape == (1, TINY["hidden_size"])
    assert set(sd) == set(CrossEncoderHead(TCfg.cross_encoder_l6(**TINY)).state_dict())
    back = to_jax_cross_encoder_params(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(leaf, flat_b[path]) and leaf.dtype == flat_b[path].dtype, path
    init = init_cross_encoder_params(TCfg.cross_encoder_l6(**TINY), seed=3)
    assert set(init) == set(sd) and torch.equal(init["classifier.bias"], torch.zeros(1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encoder_head_matches_flax_apply(dtype):
    jcfg = JCfg.cross_encoder_l6(**TINY, dtype=getattr(jnp, dtype))
    head = JHead(jcfg)
    params = jinit(head, jcfg)
    module = CrossEncoderHead(TCfg.cross_encoder_l6(**TINY, dtype=getattr(torch, dtype)))
    module.load_state_dict(from_jax_cross_encoder_params(_tree(params)))
    rng = np.random.default_rng(4)
    ids = rng.integers(5, 2000, (6, 40)).astype(np.int32)
    lens = np.array([40, 33, 20, 9, 3, 1])
    mask = np.arange(40)[None, :] < lens[:, None]
    tt = ((np.arange(40)[None, :] >= lens[:, None] // 2) & mask).astype(np.int32)
    ref = np.asarray(head.apply(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt)))
    with torch.no_grad():
        got = module(*map(torch.from_numpy, (ids, mask, tt))).numpy()
    assert got.shape == (6,) and got.dtype == np.float32
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert np.abs(ref - got).max() < tol * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scorer_scores_match_jax(dtype):
    js, ts = _scorers(dtype)
    pairs = _pairs(5, 19)  # more than max_batch: several sorted groups
    ref, got = js.score(pairs), ts.score(pairs)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert got.shape == (19,) and np.abs(ref - got).max() < tol * max(1.0, float(np.abs(ref).max()))
    assert ts.score([]).shape == (0,) and ts([pairs[0]]).shape == (1,)


def test_reranker_order_and_rerank_match_jax():
    js, ts = _scorers()
    jr, tr = jrr.DeviceReranker(scorer=js), trr.DeviceReranker(scorer=ts)
    rng = np.random.default_rng(6)
    for _ in range(4):
        query = " ".join(rng.choice(WORDS, 5))
        docs = [" ".join(rng.choice(WORDS, rng.integers(5, 40))) for _ in range(9)]
        assert tr.order(query, docs) == jr.order(query, docs)
        got, want = tr.rerank(query, docs, k=4), jr.rerank(query, docs, k=4)
        assert [d for d, _ in got] == [d for d, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-4, atol=1e-4)
    assert tr.order("q", ["only"]) == jr.order("q", ["only"]) == (0,)
    assert tr.score([]) == []


def test_reranker_builds_its_scorer_lazily():
    # the default (hashed) tokenizer needs the full vocabulary
    r = trr.DeviceReranker(config=TCfg.cross_encoder_l6(**{**TINY, "vocab_size": 30522}), device="cpu", max_seq_len=32)
    assert r._scorer is None
    assert len(r.rerank("a b", ["c d", "e f g"])) == 2
    assert isinstance(r.scorer, CrossEncoderScorer) and r.scorer.max_seq_len == 32


class _Duck:
    def score(self, pairs):
        return [0.0] * len(pairs)


@pytest.mark.parametrize(
    "spec",
    [None, False, "off", "none", "false", "", True, "on", "true", "auto", "device", "  Device ",
     "cross-encoder/ms-marco-MiniLM-L-6-v2", {"max_seq_len": 32}, "duck", "passthrough", 3.5],
)
def test_as_reranker_coercions_match_jax(spec):
    if spec == "duck":
        spec = _Duck()
    if spec == "passthrough":
        for mod in (jrr, trr):
            r = mod.DeviceReranker(max_batch=4)
            assert mod.as_reranker(r) is r
        return
    if spec == 3.5:
        for mod in (jrr, trr):
            with pytest.raises(ValueError, match="cannot coerce"):
                mod.as_reranker(spec)
        return
    want, got = jrr.as_reranker(spec), trr.as_reranker(spec)
    assert (want is None) == (got is None)
    if got is not None:
        assert isinstance(got, trr.DeviceReranker)
        assert got._scorer_kwargs == want._scorer_kwargs
        assert (got._scorer is spec) == (want._scorer is spec)
