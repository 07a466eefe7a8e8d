"""The decode extensions of the port against the JAX package, on the CPU:
the prefix cache, chunked prefill, speculative steps (layer-skip draft and
prompt lookup), sampled decode, the spec parser and the run-scoped config.
Both packages get the same seeded decoder weights (the JAX
``init_decoder_params`` through ``weights.py``); the JAX engine runs with
``impl="xla"``, as its own tests run it on the CPU.

Tolerances: token streams equal; the chunk, verify and draft math within
f32 1e-5 of the reference's; ``_sample_token`` and ``_prompt_lookup``
exactly equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.decode import DECODE_METRICS as JMETRICS
from pathway_tpu.decode import DecodeConfig as JDecodeConfig
from pathway_tpu.decode import DecodeEngine as JEngine
from pathway_tpu.decode import DecoderConfig as JDecoderConfig
from pathway_tpu.decode import PrefixCache as JPrefixCache
from pathway_tpu.decode import engine as jeng
from pathway_tpu.decode import init_decoder_params as jinit_decoder
from pathway_tpu.decode import parse_decode_spec as jparse
from pathway_tpu.ops.paged_attention import PagedKvPool as JPool
from pathway_tpu_torch.decode import DECODE_METRICS, DecodeConfig, DecodeEngine, DecoderConfig, PrefixCache
from pathway_tpu_torch.decode import config as tconfig
from pathway_tpu_torch.decode import engine as teng
from pathway_tpu_torch.decode import parse_decode_spec
from pathway_tpu_torch.ops.paged_attention import PagedKvPool
from pathway_tpu_torch.weights import from_jax_decoder_params

GEOM = dict(vocab_size=2048, hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64, max_position=96)
POOL = dict(pages=96, page_size=4, lanes=4, max_new_tokens=8, degrade_max_new_tokens=2, max_seq=80)
JPARAMS = jinit_decoder(JDecoderConfig(**GEOM), seed=0)
PARAMS = from_jax_decoder_params(JPARAMS)
_RNG = np.random.default_rng(0)
SHARED = [int(t) for t in _RNG.integers(0, 2048, 13)]
PROMPTS = [[int(t) for t in _RNG.integers(0, 2048, n)] for n in (5, 9, 3, 30)]
PROMPTS += [SHARED + [5], SHARED + [7, 9], SHARED + [7, 9], [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3]]
SAMPLED = dict(temperature=0.7, top_k=5, top_p=0.9, seed=11)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    DECODE_METRICS.reset()
    JMETRICS.reset()
    yield
    DECODE_METRICS.reset()
    JMETRICS.reset()


def _engine(**over) -> DecodeEngine:
    return DecodeEngine(DecoderConfig(**GEOM), DecodeConfig(**{**POOL, **over}), params=PARAMS, device="cpu")


def _jengine(**over):
    return JEngine(JDecoderConfig(**GEOM), JDecodeConfig(**{**POOL, "impl": "xla", **over}), params=JPARAMS)


# ----------------------------------------------------------- streams vs JAX


@pytest.mark.parametrize(
    "over",
    [
        dict(prefix_cache=True),
        dict(prefill_chunk=4),
        dict(prefill_chunk=8),
        dict(prefill_chunk=8, prefix_cache=True),
        dict(spec_tokens=3, draft_layers=1),
        dict(spec_tokens=4, draft_ngram=2),
        dict(spec_tokens=3, draft_layers=1, prefix_cache=True, prefill_chunk=3),
        SAMPLED,
        dict(SAMPLED, seed=12),
    ],
    ids=["cache", "chunk4", "chunk8", "chunk8_cache", "spec_layer_skip", "spec_ngram", "spec_cache_chunk",
         "sampled_seed11", "sampled_seed12"],
)
def test_streams_equal_the_jax_engine(over):
    """Token for token, in every configuration; the greedy ones also equal
    the plain greedy engine (the extensions change no token)."""
    got = _engine(**over).generate(PROMPTS)
    assert got == _jengine(**over).generate(PROMPTS)
    if "temperature" not in over:
        assert got == _engine().generate(PROMPTS)


def test_cache_and_spec_record_their_metrics_like_the_reference():
    _engine(prefix_cache=True, spec_tokens=3, draft_layers=1).generate(PROMPTS)
    _jengine(prefix_cache=True, spec_tokens=3, draft_layers=1).generate(PROMPTS)
    mine, ref = DECODE_METRICS.snapshot(), JMETRICS.snapshot()
    for key in ("tokens_total", "prefill_total", "steps_total", "queries_total", "prefix_hit_pages_total",
                "prefix_miss_pages_total", "prefix_cached_pages", "prefix_hit_ratio", "spec_proposed_total",
                "spec_accepted_total", "spec_acceptance_rate", "kv_pages_in_use"):
        assert mine[key] == ref[key], key
    assert mine["prefix_hit_pages_total"] > 0 and mine["spec_proposed_total"] > 0


def test_sampled_decode_is_the_same_alone_and_batched_and_per_seed():
    together = _engine(**SAMPLED).generate(PROMPTS[:4])
    alone = [_engine(**SAMPLED).generate([p])[0] for p in PROMPTS[:4]]
    assert together == alone == _engine(**SAMPLED).generate(PROMPTS[:4])
    assert together != _engine(**{**SAMPLED, "seed": 12}).generate(PROMPTS[:4])
    assert together != _engine().generate(PROMPTS[:4])


def test_long_chunked_prefill_interleaves_with_decode_ticks():
    """A prompt longer than several chunks prefills chunk by chunk while a
    short lane keeps decoding, and both streams equal the reference's."""
    long = [(3 * i + 1) % 2048 for i in range(60)]
    eng = _engine(prefill_chunk=4)
    short = eng.submit(PROMPTS[0])
    eng.step()
    before = len(short.tokens)
    lng = eng.submit(long)
    interleaved = False
    while eng.busy() and not lng.done.is_set():
        eng.step()
        if any(ln is not None and ln.prefilling for ln in eng._lanes) and len(short.tokens) > before:
            interleaved = True
    eng.drain()
    assert interleaved
    assert [short.result(), lng.result()] == _jengine().generate([PROMPTS[0], long])


def test_prefix_cache_books_shared_pages_once_and_drains_to_the_cache():
    eng = _engine(prefix_cache=True, lanes=2)
    a, b = SHARED + [5], SHARED + [7]
    eng.generate([a])
    warm = eng.pool.pages_in_use
    assert warm == eng.cache.cached_pages == 3  # (14 - 1) // 4 full pages
    eng.submit(a)
    eng.submit(b)
    eng.step()
    cold = _engine(lanes=2)
    cold.submit(a)
    cold.submit(b)
    cold.step()
    assert cold.pool.pages_in_use - eng.pool.pages_in_use == 3  # the shared pages are booked once
    eng.drain()
    assert eng.pool.pages_in_use == eng.cache.cached_pages


def test_prefix_cache_reclaims_under_pool_pressure_like_the_reference():
    over = dict(prefix_cache=True, pages=8, lanes=1, max_seq=32)
    t, j = _engine(**over), _jengine(**over)
    for e in (t, j):
        e.generate([SHARED[:9] + [5]])
    assert t.cache.cached_pages == j.cache.cached_pages > 0
    assert t.generate([[7] * 13]) == j.generate([[7] * 13]) == _engine().generate([[7] * 13])


# -------------------------------------------------------------- model math


def _pool_case(seed, layers=3, n_pages=24, page_size=4, d=32):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((layers, n_pages, page_size, d)).astype(np.float32)
    pv = rng.standard_normal((layers, n_pages, page_size, d)).astype(np.float32)
    return pk, pv


@pytest.mark.parametrize("start,count,m", [(0, 5, 8), (8, 4, 4), (12, 3, 8), (4, 8, 8)])
def test_chunk_prefill_math_matches_the_reference(start, count, m):
    pk, pv = _pool_case(start + count)
    rng = np.random.default_rng(m)
    page_ids = np.array([3, 7, 1, 11, 5, 9, 24, 24], np.int32)  # the tail: sentinel entries
    ids = np.zeros(m, np.int32)
    ids[:count] = rng.integers(0, 2048, count)
    jk, jv, jlog = jeng._chunk_prefill_math(
        JPARAMS, JDecoderConfig(**GEOM), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(page_ids), jnp.asarray(ids),
        jnp.int32(start), jnp.int32(count), page_size=4,
    )
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tparams = teng.params_to(PARAMS, "cpu")
    tlog = teng._chunk_prefill_math(tparams, DecoderConfig(**GEOM), tk, tv, torch.from_numpy(page_ids),
                                    torch.from_numpy(ids), start, count, page_size=4)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def _verify_case(seed):
    rng = np.random.default_rng(seed)
    tables = np.full((4, 6), 24, np.int32)
    tables[0, :4] = [3, 7, 1, 11]
    tables[1, :2] = [5, 9]
    tables[2, :6] = [0, 2, 4, 6, 8, 10]  # a lane near its span's end: rows past it drop
    lens = np.array([9, 6, 22, 0], np.int32)  # lane 3 dead
    toks = rng.integers(0, 2048, 4).astype(np.int32)
    drafts = rng.integers(0, 2048, (3, 4)).astype(np.int32)
    return tables, lens, toks, drafts


@pytest.mark.parametrize("seed", [0, 1])
def test_verify_and_draft_math_match_the_reference(seed):
    pk, pv = _pool_case(40 + seed)
    tables, lens, toks, drafts = _verify_case(seed)
    j = _jengine(spec_tokens=3, draft_layers=1, max_seq=24)
    jargs = (JPARAMS, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(toks))
    jtargets, jk, jv = j._verify_fn()(*jargs, jnp.asarray(drafts))
    jdrafts = j._draft_fn()(*jargs)
    tparams = teng.params_to(PARAMS, "cpu")
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    t = [torch.from_numpy(a).long() for a in (tables, lens, toks, drafts)]
    inputs = torch.cat([t[2][None], t[3][:-1]], dim=0).T
    ttargets = teng._verify_math(tparams, DecoderConfig(**GEOM), tk, tv, t[0], t[1], inputs, page_size=4)
    np.testing.assert_array_equal(ttargets.numpy(), np.asarray(jtargets))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    pk2, pv2 = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tdrafts = teng._draft_math(tparams, DecoderConfig(**GEOM), pk2, pv2, t[0], t[1], t[2], page_size=4,
                               spec_tokens=3, draft_layers=1)
    np.testing.assert_array_equal(tdrafts.numpy(), np.asarray(jdrafts))
    assert torch.equal(pk2, torch.from_numpy(pk))  # the draft writes no pool row


@pytest.mark.parametrize("seed", range(6))
def test_sample_token_and_prompt_lookup_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(2048).astype(np.float32)
    logits[[5, 9]] = logits.max()  # a tie at the top: stable order
    for cfg in (DecodeConfig(**SAMPLED), DecodeConfig(temperature=1.3, top_k=0, top_p=0.5, seed=seed),
                DecodeConfig(temperature=0.2, top_k=1, seed=3)):
        key = teng._sample_key(cfg.seed, PROMPTS[seed])
        assert key == jeng._sample_key(cfg.seed, PROMPTS[seed])
        for pos in range(8):
            assert teng._sample_token(logits, cfg, key, pos) == jeng._sample_token(logits, cfg, key, pos)
    hist = [int(t) for t in rng.integers(0, 6, 40)]
    for n, k in ((1, 3), (2, 4), (3, 2), (5, 5)):
        for cut in (1, 2, 7, 40):
            assert teng._prompt_lookup(hist[:cut], n, k) == jeng._prompt_lookup(hist[:cut], n, k)
    assert teng._prompt_lookup([], 2, 3) == jeng._prompt_lookup([], 2, 3)


# ------------------------------------------------------------ prefix cache


def _caches(n_pages=16, version=""):
    tp = PagedKvPool(layers=1, dim=8, n_pages=n_pages, page_size=4, device="cpu")
    jp = JPool(layers=1, dim=8, n_pages=n_pages, page_size=4)
    return (tp, PrefixCache(tp, page_size=4, model_version=version)), (jp, JPrefixCache(jp, page_size=4,
                                                                                          model_version=version))


def _script_chain_walk(pool, cache):
    a = list(range(20))
    pages = pool.alloc(4)
    out = [cache.publish(a, pages, len(a)), cache.lookup(a[:6] + [77] * 14), cache.lookup(a),
           cache.publish(a, pages, len(a)), cache.cached_pages]
    return out + [pool.refcount(p) for p in pages] + [pool.pages_in_use]


def _script_versions(pool, cache):
    prompt = list(range(12))
    pages = pool.alloc(2)
    cache.publish(prompt, pages, len(prompt))
    other = PrefixCache if isinstance(pool, PagedKvPool) else JPrefixCache
    return [other(pool, page_size=4, model_version="v2").lookup(prompt), cache.lookup(prompt), cache.lookup([1] * 8)]


def _script_lru_reclaim(pool, cache):
    old, new = list(range(9)), [50 + i for i in range(9)]
    p_old, p_new = pool.alloc(2), pool.alloc(2)
    cache.publish(old, p_old, 9)
    cache.publish(new, p_new, 9)
    pool.free(p_old)
    pool.free(p_new)
    hit = cache.lookup(new)
    pool.free(hit)
    out = [cache.reclaim(2), cache.lookup(old), cache.lookup(new), cache.cached_pages]
    return out + [pool.pages_in_use]


def _script_interior_and_held(pool, cache):
    prompt = list(range(13))
    pages = pool.alloc(3)
    cache.publish(prompt, pages, len(prompt))
    held = cache.reclaim(10)  # the publisher still holds its pages
    pool.free(pages)
    out = [held, cache.reclaim(1), cache.lookup(prompt)]
    pool.free(out[-1])
    return out + [cache.reclaim(10), cache.cached_pages, pool.pages_in_use]


def _script_book_once_and_clear(pool, cache):
    a, b = list(range(13)), [30 + i for i in range(9)]
    pa, pb = pool.alloc(4), pool.alloc(2)
    cache.publish(a, pa, 13)
    cache.publish(b, pb, 9)
    base = pool.pages_in_use
    holds = [cache.lookup(a) for _ in range(5)]
    out = [base, pool.pages_in_use, holds[0]]
    for h in holds:
        pool.free(h)
    pool.free(pb)
    return out + [cache.clear(), cache.cached_pages, pool.pages_in_use]


@pytest.mark.parametrize("script", [_script_chain_walk, _script_versions, _script_lru_reclaim,
                                    _script_interior_and_held, _script_book_once_and_clear],
                         ids=lambda f: f.__name__[8:])
def test_prefix_cache_follows_the_reference(script):
    """``tests/test_prefix_cache.py``'s cases, run on both packages' caches
    over their own pools: every return value and refcount equal."""
    (tp, tc), (jp, jc) = _caches()
    assert script(tp, tc) == script(jp, jc)


# --------------------------------------------------- spec parser, run config


@pytest.mark.parametrize(
    "spec",
    [None, False, 0, "off", True, "auto", 128, "pages=128, page=8, max_new=32, rerank=off",
     {"pages": 16, "batch": 2, "impl": "XLA"}, "cache=1,spec=4,draft=1,chunk=8,draft_weights=32M", "spec=4,ngram=2",
     "temp=0.5,top_k=10,top_p=0.9,seed=3", "hbm=2G,degrade=4", "pagez=4", "pages", "impl=cuda", 3.5,
     "spec=4,temp=0.5", "max_new=4,degrade=8", "hbm=lots", {"cache": "no", "chunk": "16"}],
)
def test_parse_decode_spec_accepts_and_rejects_like_the_reference(spec):
    try:
        want = jparse(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as err:
            parse_decode_spec(spec)
        assert str(err.value) == str(exc)
        return
    got = parse_decode_spec(spec)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.as_dict() == want.as_dict()


def _one_row_run(**kw):
    tpw.clear_graph()
    t = tpw.debug.table_from_markdown("""
      | a
    1 | 1
    """)
    seen = []
    G = tpw.internals.parse_graph.G
    tpw.io.subscribe(t, lambda **_: seen.append((tconfig.active_decode(), G.run_context["decode"])))
    tpw.run(**kw)
    tpw.clear_graph()
    return seen


def test_run_decode_installs_the_config_for_the_run_only(monkeypatch):
    monkeypatch.delenv("PATHWAY_DECODE", raising=False)
    ((inside, ctx),) = _one_row_run(decode="pages=32,page=8,cache=on,chunk=16")
    assert inside == parse_decode_spec("pages=32,page=8,cache=on,chunk=16")
    assert ctx == inside.as_dict()
    assert tconfig.active_decode() is None  # cleared after the run
    with tconfig.use_decode("pages=8,page=4,max_seq=16"):
        ((inside, _),) = _one_row_run(decode={"pages": 16})
        assert inside.pages == 16
        assert tconfig.active_decode().pages == 8  # the run's config does not leak
    with pytest.raises(ValueError, match="unknown spec key"):
        _one_row_run(decode="pagez=3")


def test_pathway_decode_env_is_read_when_an_engine_is_built(monkeypatch):
    monkeypatch.setenv("PATHWAY_DECODE", "pages=48,page=4,lanes=2,max_new=3,degrade=1,max_seq=40,cache=on")
    ((inside, ctx),) = _one_row_run()
    assert inside.pages == 48 and ctx["prefix_cache"] is True
    eng = DecodeEngine(DecoderConfig(**GEOM), params=PARAMS, device="cpu")
    assert eng.config == tconfig.active_decode() and eng.cache is not None
    assert eng.generate(PROMPTS[:2]) == JEngine(JDecoderConfig(**GEOM), params=JPARAMS).generate(PROMPTS[:2])
    monkeypatch.setenv("PATHWAY_DECODE", "not a spec !!")
    assert tconfig.active_decode() is None and jpw.decode.active_decode() is None
