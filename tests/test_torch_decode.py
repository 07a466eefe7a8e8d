"""Kernel B5's plain version, ``PagedKvPool``, the decoder math and the
``DecodeEngine`` of the PyTorch port against the JAX package, on the CPU.
Both packages get the same numpy inputs and the same decoder weights (the
JAX ``init_decoder_params`` through ``weights.py``).

Tolerances: attention outputs f32 1e-5 (the same f32 math summed in
another order); token streams equal."""

from __future__ import annotations

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.decode import DecodeConfig as JDecodeConfig
from pathway_tpu.decode import DecodeEngine as JEngine
from pathway_tpu.decode import DecoderConfig as JDecoderConfig
from pathway_tpu.decode import decode_greedy as jdecode_greedy
from pathway_tpu.decode import init_decoder_params as jinit_decoder
from pathway_tpu.ops import paged_attention as jpa
from pathway_tpu_torch.decode import DecodeConfig, DecodeEngine, DecoderConfig, decode_greedy, init_decoder_params
from pathway_tpu_torch.ops import paged_attention as tpa
from pathway_tpu_torch.weights import from_jax_decoder_params, to_jax_decoder_params

GEOM = dict(vocab_size=97, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, max_position=64)
POOL = dict(pages=64, page_size=4, lanes=4, max_new_tokens=6, degrade_max_new_tokens=2, max_seq=48)
JPARAMS = jinit_decoder(JDecoderConfig(**GEOM), seed=0)
PARAMS = from_jax_decoder_params(JPARAMS)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8], [9, 9], [31, 41, 5, 92, 6, 53, 5, 89, 79, 3]]


def _engine(**over) -> DecodeEngine:
    return DecodeEngine(DecoderConfig(**GEOM), DecodeConfig(**{**POOL, "impl": "auto", **over}), params=PARAMS,
                        device="cpu")


# ---------------------------------------------------------------- kernel B5


def _paged_case(seed, b=5, n_pages=20, page_size=4, pps=6, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page_size, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page_size, d)).astype(np.float32)
    tables = np.stack([rng.permutation(n_pages)[:pps] for _ in range(b)]).astype(np.int32)  # shuffled
    lens = rng.integers(1, pps * page_size + 1, b).astype(np.int32)
    lens[1] = 0  # an empty row
    tables[2, :3] = tables[3, :3]  # aliased prefix pages
    tables[2, 3:] = tables[3, 3:][::-1]  # past the shared prefix, private pages
    lens[2] = lens[3] = 3 * page_size
    q[2] = q[3]
    tables[4, pps - 1] = n_pages + 7  # out of range past the length: clamped, never read
    lens[4] = (pps - 1) * page_size
    return q, kp, vp, tables, lens


def _both(q, kp, vp, tables, lens, h):
    want = np.asarray(jpa.paged_attention_reference(*map(jnp.asarray, (q, kp, vp, tables, lens)), n_heads=h))
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    return want, tpa.paged_decode_attention(*t, n_heads=h).numpy(), tpa.paged_attention_reference(*t, n_heads=h).numpy()


@pytest.mark.parametrize("seed,h", [(0, 2), (1, 4), (2, 1)])
def test_paged_attention_plain_matches_jax_reference(seed, h):
    q, kp, vp, tables, lens = _paged_case(seed)
    want, got, plain = _both(q, kp, vp, tables, lens, h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, plain)  # a CPU tensor takes the plain version
    assert (got[1] == 0).all()  # length 0: exact zeros
    np.testing.assert_array_equal(got[2], got[3])  # a shared page reads the same bytes in both tables


@pytest.mark.parametrize("hd,h", [(48, 2), (256, 1), (256, 2)])
def test_paged_attention_wide_heads_match_jax_reference(hd, h):
    """Head dims the CUDA kernel now takes beyond 32 / 64 / 128, through the
    same cases: an empty row, aliased pages, an out-of-range entry past the
    length."""
    q, kp, vp, tables, lens = _paged_case(10 + hd + h, d=hd * h)
    want, got, plain = _both(q, kp, vp, tables, lens, h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, plain)
    assert (got[1] == 0).all()
    np.testing.assert_array_equal(got[2], got[3])


@pytest.mark.parametrize("page_size,pps", [(16, 10), (4, 6), (48, 5), (100, 3)])
@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 160])
def test_decode_split_plan_visits_every_live_position_once(length, page_size, pps):
    """The context split of the CUDA kernel: every position below the
    length is read by exactly one split, none past it; a page of at most 64
    positions lies within one split."""
    chunk, splits = tpa.decode_split_plan(pps, page_size)
    assert chunk <= 64 and (splits - 1) * chunk < pps * page_size <= splits * chunk
    live = min(length, pps * page_size)
    # split s reads positions [s * chunk, min((s + 1) * chunk, length)), as the kernel does
    ranges = [range(s * chunk, max(s * chunk, min((s + 1) * chunk, live))) for s in range(splits)]
    assert sorted(j for r in ranges for j in r) == list(range(live))
    if page_size <= 64:
        owner = {}
        for s, r in enumerate(ranges):
            for j in r:
                assert owner.setdefault(j // page_size, s) == s
        assert sorted(owner) == list(range(tpa.pages_for(live, page_size)))


def test_paged_attention_head_dim_limit_names_it(monkeypatch):
    t = [torch.zeros(2, 514), torch.zeros(3, 4, 514), torch.zeros(3, 4, 514), torch.zeros(2, 2, dtype=torch.int32),
         torch.ones(2, dtype=torch.int32)]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="up to 256"):
        tpa.paged_decode_attention(*t, n_heads=2)


def test_dense_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    k = rng.standard_normal((4, 10, 24)).astype(np.float32)
    v = rng.standard_normal((4, 10, 24)).astype(np.float32)
    lens = np.array([10, 3, 0, 1], np.int32)
    want = np.asarray(jpa.dense_decode_attention(*map(jnp.asarray, (q, k, v, lens)), n_heads=3))
    got = tpa.dense_decode_attention(*map(torch.from_numpy, (q, k, v, lens)), n_heads=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[2] == 0).all()
    assert tpa.pages_for(17, 4) == jpa.pages_for(17, 4) == 5 and tpa.pages_for(0, 4) == 0


def test_paged_kv_pool_semantics_match_jax():
    jp = jpa.PagedKvPool(layers=2, dim=8, n_pages=6, page_size=4)
    tp = tpa.PagedKvPool(layers=2, dim=8, n_pages=6, page_size=4, device="cpu")
    assert tuple(tp.k.shape) == tuple(jp.k.shape) == (2, 6, 4, 8) and tp.pool_bytes == jp.pool_bytes
    assert tp.sentinel == jp.sentinel == 6
    for pool in (jp, tp):
        a = pool.alloc(4)
        assert pool.alloc(3) is None and pool.pages_in_use == 4  # never a partial grant
        pool.share(a[:2])
        pool.free(a)
        assert pool.pages_in_use == 2 and pool.refcount(a[0]) == 1
        pool.free(a[:2])
        with pytest.raises(ValueError, match="double free"):
            pool.free([a[0]])
        with pytest.raises(ValueError, match="not in the pool"):
            pool.free([99])
        with pytest.raises(ValueError, match="unallocated"):
            pool.share([5])
    assert jp.alloc(6) == tp.alloc(6)  # same LIFO order


# ---------------------------------------------------------------- weights


def test_decoder_weight_bridge_round_trip_is_exact():
    back = to_jax_decoder_params(PARAMS)
    for key in ("tok", "pos", "lnf_s", "lnf_b"):
        assert np.array_equal(back[key], np.asarray(JPARAMS[key]))
    for lj, lb in zip(JPARAMS["layers"], back["layers"]):
        for key, val in lj.items():
            assert np.array_equal(lb[key], np.asarray(val)) and lb[key].dtype == np.float32, key


# ---------------------------------------------------------------- decoder math


def test_decode_greedy_matches_jax():
    cfg_j, cfg_t = JDecoderConfig(**GEOM), DecoderConfig(**GEOM)
    ids = np.zeros((len(PROMPTS), 16), np.int32)
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, : len(p)] = p
    want = [np.asarray(jdecode_greedy(JPARAMS, cfg_j, jnp.asarray(ids[i]), jnp.int32(lens[i]), 7))
            for i in range(len(PROMPTS))]
    got = decode_greedy(PARAMS, cfg_t, torch.from_numpy(ids), torch.from_numpy(lens), 7).numpy()
    assert got.tolist() == [w.tolist() for w in want]
    one = decode_greedy(PARAMS, cfg_t, torch.from_numpy(ids[:1]), torch.from_numpy(lens[:1]), 1)
    assert one.tolist() == [[want[0][0]]]


# ---------------------------------------------------------------- engine


def test_engine_streams_match_jax_engine_and_decode_greedy():
    jeng = JEngine(JDecoderConfig(**GEOM), JDecodeConfig(**POOL, impl="xla"), params=JPARAMS)
    want = jeng.generate(PROMPTS)
    eng = _engine()
    got = eng.generate(PROMPTS)
    assert got == want
    assert eng.pool.pages_in_use == 0 and not eng.busy() and eng.steps == POOL["max_new_tokens"] - 1
    for prompt, stream in zip(PROMPTS, got):
        ids = torch.zeros((1, 16), dtype=torch.int64)
        ids[0, : len(prompt)] = torch.tensor(prompt)
        ref = decode_greedy(PARAMS, DecoderConfig(**GEOM), ids, torch.tensor([len(prompt)]), POOL["max_new_tokens"])
        assert stream == ref[0].tolist()


def test_batching_is_invisible_and_queues_past_the_lanes():
    prompts = [[(7 * i + j) % 97 for j in range(3 + i % 5)] for i in range(11)]
    eng = _engine(lanes=2, pages=24)
    streams = eng.generate(prompts)
    assert all(len(s) == POOL["max_new_tokens"] for s in streams)
    alone = [_engine().generate([p])[0] for p in prompts]
    assert streams == alone
    assert eng.pool.pages_in_use == 0


def test_degraded_clamps_max_new_and_ticket_validation():
    eng = _engine()
    t = eng.submit(PROMPTS[0], degraded=True)
    eng.drain()
    assert len(t.result()) == POOL["degrade_max_new_tokens"] and t.skip_rerank
    with pytest.raises(ValueError, match="empty prompt"):
        eng.make_ticket([])
    with pytest.raises(ValueError, match="context limit"):
        eng.make_ticket(list(range(60)))


def test_mid_stream_deadline_preempts_and_frees_pages():
    eng = _engine()
    victim = eng.submit(PROMPTS[0], deadline=types.SimpleNamespace(expires_at=time.monotonic() + 3600))
    others = [eng.submit(p) for p in PROMPTS[1:]]
    eng.step()
    eng.step()
    held = eng.pool.pages_in_use
    victim.deadline.expires_at = time.monotonic() - 1.0  # expires mid-stream
    eng.step()
    assert victim.preempted and victim.done.is_set()
    assert 0 < len(victim.result()) < POOL["max_new_tokens"]
    assert eng.pool.pages_in_use < held
    eng.drain()
    assert eng.pool.pages_in_use == 0
    for prompt, t in zip(PROMPTS[1:], others):
        assert not t.preempted and t.result() == _engine().generate([prompt])[0]


@pytest.mark.parametrize(
    "field,value",
    [("prefix_cache", True), ("prefill_chunk", 8), ("spec_tokens", 2), ("temperature", 0.7)],
)
def test_extension_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        _engine(**{field: value})


def test_paged_impl_needs_a_card_and_config_validation_matches_jax():
    with pytest.raises(ValueError, match="CUDA"):
        _engine(impl="paged")
    for bad in (dict(pages=0), dict(max_new_tokens=4, degrade_max_new_tokens=8), dict(impl="cuda"),
                dict(max_seq=2, page_size=4), dict(top_p=0.0), dict(spec_tokens=2, temperature=0.5)):
        with pytest.raises(ValueError) as jerr:
            JDecodeConfig(**bad)
        with pytest.raises(ValueError) as terr:
            DecodeConfig(**bad)
        assert str(terr.value) == str(jerr.value)
    c = DecodeConfig(pages=512, page_size=16, max_seq=160)
    assert c.pages_per_seq() == JDecodeConfig(pages=512, page_size=16, max_seq=160).pages_per_seq() == 10
    assert c.pool_bytes(4, 256) == JDecodeConfig(pages=512, page_size=16).pool_bytes(4, 256)
    assert c.as_dict() == JDecodeConfig(pages=512, page_size=16, max_seq=160).as_dict()
    with pytest.raises(ValueError, match="HBM budget"):
        _engine(pages=1 << 22, page_size=64, max_seq=64, hbm_bytes=1 << 20)


def test_port_init_decoder_params_is_seeded():
    a, b = init_decoder_params(DecoderConfig(**GEOM), seed=3), init_decoder_params(DecoderConfig(**GEOM), seed=3)
    assert torch.equal(a["tok"], b["tok"]) and torch.equal(a["layers"][1]["w2"], b["layers"][1]["w2"])
    assert a["layers"][0]["wqkv"].shape == (16, 48)
