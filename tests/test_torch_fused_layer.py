"""Kernel B1 (the whole encoder layer) of the PyTorch port against the JAX
package, on the CPU: the same numpy inputs from a seed and the same
weights (through ``pathway_tpu_torch.weights``) go through
``pathway_tpu.ops.fused_layer`` (its Pallas kernel in interpret mode) and
through the port's plain versions.

Tolerances: bf16 working dtype, max abs error < 3e-2 and min cosine >
0.999 (the bound the JAX package holds between its own kernel and
module); float32 working dtype, < 1e-4. Only live tokens are compared at
the layer level: padded query rows are unconstrained but must be finite."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.models.batching import DEFAULT_SEQ_BUCKETS
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.encoder import TextEncoder as JTextEncoder
from pathway_tpu.models.encoder import init_params as jinit
from pathway_tpu.ops import fused_layer as jfl
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.ops import fused_layer as tfl
from pathway_tpu_torch.weights import from_jax_params

TINY = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=512)


def _pair(f32: bool = False, **kw):
    jcfg = JCfg(**kw, **({"dtype": jnp.float32} if f32 else {}))
    tcfg = TCfg(**kw, **({"dtype": torch.float32} if f32 else {}))
    params = jinit(JTextEncoder(jcfg), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    return jcfg, tcfg, params, from_jax_params(tree)


@pytest.fixture(scope="module")
def tiny():
    return _pair(**TINY)


@pytest.fixture(scope="module")
def tiny_f32():
    return _pair(f32=True, **TINY)


def _inputs(rng, b, s, vocab, zero_last=True):
    ids = rng.integers(5, vocab - 1, (b, s)).astype(np.int32)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    if zero_last:
        lens[-1] = 0  # all-padding row in the tail (length-sorted contract)
    mask = np.arange(s)[None, :] < lens[:, None]
    return ids, lens, mask


def _both(pair, ids, lens, mask):
    jcfg, tcfg, jparams, tparams = pair
    got_j = np.asarray(
        jfl.encoder_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), lens=jnp.asarray(lens), interpret=True)
    )
    got_t = tfl.encoder_forward(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), lens=torch.from_numpy(lens)
    ).numpy()
    return got_j, got_t


@pytest.mark.parametrize("s", list(DEFAULT_SEQ_BUCKETS))
def test_encoder_every_bucket_with_all_padding_row(tiny, s):
    rng = np.random.default_rng(s)
    b = jfl._pack_rows(s) + 2  # spills into a second, partly dead block
    ids, lens, mask = _inputs(rng, b, s, TINY["vocab_size"])
    ref, got = _both(tiny, ids, lens, mask)
    live = lens > 0
    err = np.abs(ref[live] - got[live]).max()
    cos = (ref[live] * got[live]).sum(axis=1).min()
    assert err < 3e-2 and cos > 0.999, (s, err, cos)
    assert np.all(got[~live] == 0.0), "all-padding row must embed to exactly zero"


@pytest.mark.parametrize("s", [16, 64, 160])
def test_encoder_float32_matches_tightly(tiny_f32, s):
    rng = np.random.default_rng(100 + s)
    ids, lens, mask = _inputs(rng, 5, s, TINY["vocab_size"])
    ref, got = _both(tiny_f32, ids, lens, mask)
    live = lens > 0
    assert np.abs(ref[live] - got[live]).max() < 1e-4
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize("s", [32, 160])
def test_layer_tokens_match_on_live_tokens(tiny, s):
    """One layer over packed tokens: fused_layer_tokens_reference vs the
    Pallas kernel in interpret mode, live tokens only."""
    jcfg, tcfg, jparams, tparams = tiny
    rng = np.random.default_rng(7 + s)
    b = 2 * jfl._pack_rows(s) + 1
    x = rng.normal(size=(b, s, TINY["hidden_size"])).astype(np.float32)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    lens[-1] = 0
    mask = np.arange(s)[None, :] < lens[:, None]
    jtok, jlens, b0 = jfl.pack_tokens(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask), jnp.asarray(lens))
    jl = meta.unbox(jparams)["params"]["layer_0"]
    ref = jfl.fused_layer_tokens(jtok, jlens, jl, n_heads=2, seq=s, eps=jcfg.layer_norm_eps, interpret=True)
    ref = np.asarray(jfl.unpack_tokens(ref, b0, s).astype(jnp.float32))
    ttok, tlens, tb0 = tfl.pack_tokens(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask), torch.from_numpy(lens))
    assert torch.equal(tlens, torch.from_numpy(np.array(jlens)))
    out = tfl.fused_layer_tokens_reference(
        ttok, tlens, tfl.layer_params(tparams, 0), n_heads=2, seq=s, eps=tcfg.layer_norm_eps
    )
    got = tfl.unpack_tokens(out, tb0, s).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(ref[mask] - got[mask]).max() < 3e-2


def test_cls_pooling(tiny):
    kw = dict(TINY, pooling="cls", normalize=False)
    pair = _pair(**kw)
    rng = np.random.default_rng(0)
    ids, lens, mask = _inputs(rng, 4, 32, TINY["vocab_size"], zero_last=False)
    ref, got = _both(pair, ids, lens, mask)
    # cls outputs are unnormalised: bound the error by the output scale
    assert np.abs(ref - got).max() < 3e-2 * max(1.0, np.abs(ref).max())
    rn = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    gn = got / np.linalg.norm(got, axis=1, keepdims=True)
    assert (rn * gn).sum(axis=1).min() > 0.999


def test_minilm_width_b2_s32():
    pair = _pair()  # EncoderConfig defaults: MiniLM-L6 geometry
    rng = np.random.default_rng(1)
    ids, lens, mask = _inputs(rng, 2, 32, 30522, zero_last=False)
    ids[:] = rng.integers(999, 29000, ids.shape)
    ref, got = _both(pair, ids, lens, mask)
    assert np.abs(ref - got).max() < 3e-2
    assert (ref * got).sum(axis=1).min() > 0.999


def test_pack_unpack_roundtrip_and_block_lens():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 32, 8)).astype(np.float32))
    mask = torch.ones(5, 32, dtype=torch.bool)
    tokens, lens, b0 = tfl.pack_tokens(x, mask)
    assert tokens.shape[0] % (256 // 32 * 32) == 0
    assert lens.shape[1] == 256 // 32 and int(lens[0, 0]) == 32
    assert torch.equal(tfl.unpack_tokens(tokens, b0, 32), x)


def test_dispatch_gates_and_flops_match_reference():
    jcfg, tcfg = JCfg.minilm_l6(), TCfg.minilm_l6()
    for s in (16, 160, 512, 1024):
        assert tfl.use_fused_encoder(tcfg, s) == jfl.supports_fused_encoder(jcfg, s)
        assert tfl.encoder_flops_per_token(tcfg, s) == jfl.encoder_flops_per_token(jcfg, s)
    assert tfl.use_fused_encoder(tcfg, 160)
    assert not tfl.use_fused_encoder(tcfg, 1024)
    with pytest.raises(ValueError):
        tfl.fused_layer_tokens(
            torch.zeros(16, 64), torch.zeros(1, 16, dtype=torch.int32), {}, n_heads=2, seq=16, eps=1e-12,
            impl="kernel",
        )
    assert dataclasses.replace(tcfg, layer_impl="plain").layer_impl == "plain"


def test_prepared_params_change_no_result(tiny):
    """Weights cast once by ``prepare_params`` give bit-identical encoder
    outputs to casting them at every call, and the module cast for
    inference leaves the module's outputs bit-identical."""
    from pathway_tpu_torch.models.encoder import TextEncoder

    _, tcfg, _, tparams = tiny
    prepared = tfl.prepare_params(tparams, tcfg)
    assert prepared["layers.0.attention.qkv.weight"].dtype == tcfg.dtype
    assert prepared["tok_embed.weight"].dtype == tcfg.dtype
    assert prepared["layers.0.attention.qkv.bias"].dtype == torch.float32
    assert prepared["layers.1.ln_mlp.weight"].dtype == torch.float32
    rng = np.random.default_rng(3)
    ids, lens, mask = (torch.from_numpy(a) for a in _inputs(rng, 6, 32, TINY["vocab_size"]))
    want = tfl.encoder_forward(tparams, tcfg, ids, mask, lens=lens)
    assert torch.equal(tfl.encoder_forward(prepared, tcfg, ids, mask, lens=lens), want)
    assert torch.equal(tfl.encoder_forward(prepared, tcfg, ids, mask), want)
    module = TextEncoder(tcfg)
    module.load_state_dict(tparams)
    with torch.no_grad():
        before = module(ids, mask)
        after = module.cast_for_inference()(ids, mask)
    assert module.layers[0].mlp_in.weight.dtype == tcfg.dtype
    assert module.ln_embed.weight.dtype == torch.float32
    assert torch.equal(before, after)


@pytest.mark.parametrize("hidden,heads", [(128, 2), (96, 2)], ids=["hd64", "hd48"])
def test_encoder_head_dims_other_than_32(hidden, heads):
    """The whole encoder at head dim 64 (a kernel's own) and 48 (zero-padded
    to 64 on the card), against the Pallas layer kernel in interpret mode.
    The port's seeded weights go to the JAX side through ``weights.py``."""
    from pathway_tpu_torch.models.encoder import init_params as tinit
    from pathway_tpu_torch.weights import to_jax_params

    kw = dict(TINY, hidden_size=hidden, num_heads=heads, intermediate_size=2 * hidden, num_layers=1)
    tcfg = TCfg(**kw)
    tparams = tinit(tcfg, seed=hidden)
    pair = (JCfg(**kw), tcfg, to_jax_params(tparams), tparams)
    rng = np.random.default_rng(hidden)
    ids, lens, mask = _inputs(rng, 3, 16, TINY["vocab_size"])
    ref, got = _both(pair, ids, lens, mask)
    live = lens > 0
    assert np.abs(ref[live] - got[live]).max() < 3e-2
    assert (ref[live] * got[live]).sum(axis=1).min() > 0.999
    assert np.all(got[~live] == 0.0)
