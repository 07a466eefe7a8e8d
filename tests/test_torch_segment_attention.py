"""Kernel B4 (sequence-packed attention) and the packed ``TextEncoder``
forward of the PyTorch port against the JAX package, on the CPU. The same
numpy inputs go through ``pathway_tpu.ops.fused_attention._packed_call``
(its Pallas kernel in interpret mode), its plain ``_xla_packed_reference``
and the port's ``segment_attention_reference`` (what the port's wrapper
takes for a CPU tensor).

Tolerances, on live query rows (segment >= 0; rows of -1 are padding that
no caller reads, and the port writes zeros there): bf16 ctx within 5e-2,
the bound the JAX package holds between its kernel and its reference;
float32 within 1e-5; packed token states within 3e-2 times their scale."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.encoder import TextEncoder as JTextEncoder
from pathway_tpu.models.encoder import init_params as jinit
from pathway_tpu.ops.fused_attention import _packed_call, _xla_packed_reference
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.encoder import TextEncoder
from pathway_tpu_torch.ops import fused_attention as tfa
from pathway_tpu_torch.weights import from_jax_params


def _segments(rng, b, s, lo, hi):
    """Rows filled back to back with chunks of lo..hi tokens, at most 8 per
    row, ids unique across rows (row * 8 + slot), -1 in each row's tail."""
    seg = np.full((b, s), -1, np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        off = 0
        for slot in range(8):
            n = int(rng.integers(lo, hi + 1))
            if off + n > s:
                break
            seg[r, off : off + n] = r * 8 + slot
            pos[r, off : off + n] = np.arange(n)
            off += n
    return seg, pos


def _case(b, s, d, seed, dtype=np.float32, lo=5, hi=40):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * d)).astype(dtype)
    seg, _ = _segments(rng, b, s, lo, hi)
    return qkv, seg


@pytest.mark.parametrize("b,s,h,d", [(5, 64, 4, 128), (2, 512, 12, 384), (3, 128, 2, 64)])
def test_segment_attention_matches_pallas_interpret(b, s, h, d):
    qkv, seg = _case(b, s, d, seed=s, lo=s // 16, hi=s // 3)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(_packed_call(jq, jnp.asarray(seg), h, True).astype(jnp.float32))
    got = tfa.segment_attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(seg), h).float().numpy()
    live = (seg >= 0)[:, :, None]
    assert np.isfinite(got).all()
    assert np.max(np.abs(ref - got) * live) < 5e-2
    assert (got[seg < 0] == 0).all()  # padding rows: zeros, never NaN


@pytest.mark.parametrize("b,s,h,d", [(4, 96, 4, 128), (2, 256, 12, 384)])
def test_segment_attention_reference_matches_xla_packed_reference(b, s, h, d):
    qkv, seg = _case(b, s, d, seed=1)
    live = (seg >= 0)[:, :, None]
    # float32: the same function up to summation order
    ref = np.asarray(_xla_packed_reference(jnp.asarray(qkv), jnp.asarray(seg), h))
    got = tfa.segment_attention_reference(torch.from_numpy(qkv), torch.from_numpy(seg), h).numpy()
    assert np.max(np.abs(ref - got) * live) < 1e-5
    # bf16: the reference rounds its scores to bf16, the port keeps them f32
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref16 = np.asarray(_xla_packed_reference(jq, jnp.asarray(seg), h).astype(jnp.float32))
    got16 = tfa.segment_attention_reference(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(seg), h)
    assert np.max(np.abs(ref16 - got16.float().numpy()) * live) < 5e-2


def test_ids_need_not_be_contiguous_and_pad_rows_are_finite():
    """The mask is seg_q == seg_k (the TPU kernel's rule): ids scattered
    through a row give the same result as the dense masked reference."""
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((2, 48, 3 * 64)).astype(np.float32)
    seg = rng.integers(-1, 3, (2, 48)).astype(np.int32)
    got = tfa.segment_attention(torch.from_numpy(qkv), torch.from_numpy(seg), 2).numpy()
    ref = np.asarray(_xla_packed_reference(jnp.asarray(qkv), jnp.asarray(seg), 2))
    live = (seg >= 0)[:, :, None]
    assert np.isfinite(got).all() and (got[seg < 0] == 0).all()
    assert np.max(np.abs(ref - got) * live) < 1e-5


def test_attention_dispatches_segment_ids():
    qkv, seg = _case(2, 32, 64, seed=7)
    tq, ts = torch.from_numpy(qkv), torch.from_numpy(seg)
    want = tfa.segment_attention_reference(tq, ts, 2)
    for impl in ("auto", "plain"):  # a CPU tensor takes the plain version, never raises
        assert torch.equal(tfa.attention(tq, None, n_heads=2, impl=impl, segment_ids=ts), want)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.attention(tq, None, n_heads=2, impl="kernel", segment_ids=ts)
    # key_mask is ignored in packed mode
    assert torch.equal(tfa.attention(tq, torch.zeros(2, 32, dtype=torch.bool), n_heads=2, segment_ids=ts), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_text_encoder_matches_flax_apply(dtype):
    kw = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=128)
    jcfg = JCfg(**kw, dtype=getattr(jnp, dtype))
    tcfg = TCfg(**kw, dtype=getattr(torch, dtype))
    jm = JTextEncoder(jcfg)
    params = jinit(jm, jcfg)
    module = TextEncoder(tcfg)
    module.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, meta.unbox(params))))
    rng = np.random.default_rng(9)
    seg, pos = _segments(rng, 3, 128, 10, 50)
    ids = np.where(seg >= 0, rng.integers(5, 999, seg.shape), 0).astype(np.int32)
    mask = seg >= 0
    ref = np.asarray(
        jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), position_ids=jnp.asarray(pos),
                 segment_ids=jnp.asarray(seg)).astype(jnp.float32)
    )
    with torch.no_grad():
        got = module(torch.from_numpy(ids), torch.from_numpy(mask), position_ids=torch.from_numpy(pos),
                     segment_ids=torch.from_numpy(seg)).float().numpy()
    assert got.shape == (3, 128, 64)  # a packed call returns token states
    live = mask[:, :, None]
    scale = max(1.0, float(np.abs(ref * live).max()))
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert np.max(np.abs(ref - got) * live) < tol * scale


@pytest.mark.parametrize("h,d", [(2, 128), (2, 96), (1, 128)], ids=["hd64", "hd48", "hd128"])
def test_head_dims_other_than_32_match_the_reference(h, d):
    """Head dims the CUDA kernel takes (64, 128) or zero-pads (48): the
    plain version against ``_packed_call`` in interpret mode (bf16, live
    rows within 5e-2) and against ``_xla_packed_reference`` in float32
    (1e-5)."""
    qkv, seg = _case(3, 64, d, seed=d + h, lo=4, hi=24)
    live = (seg >= 0)[:, :, None]
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(_packed_call(jq, jnp.asarray(seg), h, True).astype(jnp.float32))
    got = tfa.segment_attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(seg), h).float().numpy()
    assert np.isfinite(got).all() and (got[seg < 0] == 0).all()
    assert np.max(np.abs(ref - got) * live) < 5e-2
    ref32 = np.asarray(_xla_packed_reference(jnp.asarray(qkv), jnp.asarray(seg), h))
    got32 = tfa.segment_attention_reference(torch.from_numpy(qkv), torch.from_numpy(seg), h).numpy()
    assert np.max(np.abs(ref32 - got32) * live) < 1e-5
