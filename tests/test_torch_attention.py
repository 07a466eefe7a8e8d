"""Kernel B3 (masked multi-head attention) and the TextEncoder module of
the PyTorch port against the JAX package, on the CPU. The same numpy
inputs from a seed go through ``pathway_tpu.ops.fused_attention.attention``
(its Pallas kernel in interpret mode, and its plain ``_xla_reference``) and
through the port's plain versions; the module comparison feeds the flax
``TextEncoder`` weights to the port's through ``weights.py``.

Tolerances: bf16 ctx within 5e-2 on live query rows (the bound the JAX
package holds between its kernel and its reference), 1e-5 in float32;
module embeddings within 3e-2 with min cosine > 0.999."""

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
from pathway_tpu.ops.fused_attention import _xla_reference
from pathway_tpu.ops.fused_attention import attention as jattention
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.encoder import TextEncoder
from pathway_tpu_torch.ops import fused_attention as tfa
from pathway_tpu_torch.weights import from_jax_params


def _case(b, s, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * d)).astype(dtype)
    mask = np.ones((b, s), bool)
    mask[0, s // 2 :] = False
    mask[-1, :] = False  # every key of the last row masked
    if b > 2:
        mask[1, 1:] = False
    return qkv, mask


@pytest.mark.parametrize("b,s,h,d", [(10, 32, 12, 384), (7, 48, 4, 128), (3, 200, 8, 256), (4, 16, 2, 64)])
def test_masked_attention_matches_pallas_interpret(b, s, h, d):
    qkv, mask = _case(b, s, d, seed=s)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(jattention(jq, jnp.asarray(mask), n_heads=h, impl="interpret").astype(jnp.float32))
    tq = torch.from_numpy(qkv).bfloat16()
    got = tfa.attention(tq, torch.from_numpy(mask), n_heads=h).float().numpy()
    assert np.isfinite(got).all()
    live = mask[:, :, None]
    assert np.max(np.abs(ref - got) * live) < 5e-2
    # the fully masked row averages V uniformly on both sides, never NaN
    assert np.abs(ref[-1] - got[-1]).max() < 5e-2


@pytest.mark.parametrize("b,s,h,d", [(6, 32, 12, 384), (3, 64, 4, 128)])
def test_attention_reference_matches_xla_reference(b, s, h, d):
    qkv, mask = _case(b, s, d, seed=1)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(_xla_reference(jq, jnp.asarray(mask), h).astype(jnp.float32))
    got = tfa.attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask), n_heads=h, impl="plain")
    got = got.float().numpy()
    live = mask[:, :, None]
    assert np.max(np.abs(ref - got) * live) < 5e-2
    assert np.abs(ref[-1] - got[-1]).max() < 5e-2  # fully masked row: uniform average


def test_float32_kernel_twin_matches_xla_reference_tightly():
    qkv, mask = _case(5, 24, 64, seed=2)
    ref = np.asarray(_xla_reference(jnp.asarray(qkv), jnp.asarray(mask), 4))
    got = tfa.masked_attention_reference(torch.from_numpy(qkv), torch.from_numpy(mask), 4).numpy()
    live = mask[:, :, None]
    assert np.max(np.abs(ref - got) * live) < 1e-5
    assert np.abs(ref[-1] - got[-1]).max() < 1e-5


def test_zero_empty_writes_zeros_for_empty_sequences():
    qkv, mask = _case(4, 16, 32)
    out = tfa.masked_attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask), 2, zero_empty=True)
    assert (out[-1] == 0).all() and not (out[0] == 0).all()


def test_cpu_kernel_impl_raises_and_packing_is_next_slice():
    """``impl="kernel"`` needs a card; packing (kernel B4, ported in the
    second slice) dispatches to its plain version on a CPU tensor."""
    qkv, mask = _case(2, 16, 32)
    with pytest.raises(ValueError):
        tfa.attention(torch.from_numpy(qkv), torch.from_numpy(mask), n_heads=2, impl="kernel")
    seg = torch.zeros(2, 16, dtype=torch.int32)
    got = tfa.attention(torch.from_numpy(qkv), torch.from_numpy(mask), n_heads=2, segment_ids=seg)
    assert torch.equal(got, tfa.segment_attention_reference(torch.from_numpy(qkv), seg, 2))


@pytest.mark.parametrize(
    "kw",
    [
        dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=64),
        dict(vocab_size=1000, hidden_size=64, num_layers=1, num_heads=4, intermediate_size=128,
             max_position=64, pooling="cls", normalize=False),
        {},  # MiniLM-L6
    ],
    ids=["tiny-mean", "tiny-cls", "minilm"],
)
def test_text_encoder_module_matches_flax_apply(kw):
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jm = JTextEncoder(jcfg)
    params = jinit(jm, jcfg)
    module = TextEncoder(tcfg)
    module.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, meta.unbox(params))))
    rng = np.random.default_rng(3)
    b, s = 4, 32
    ids = rng.integers(5, jcfg.vocab_size - 1, (b, s)).astype(np.int32)
    lens = np.array([32, 17, 5, 1])
    mask = np.arange(s)[None, :] < lens[:, None]
    ref = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = module(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        toks = module(torch.from_numpy(ids), torch.from_numpy(mask), return_tokens=True)
    assert toks.shape == (b, s, jcfg.hidden_size)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(ref - got).max() < 3e-2 * scale
    rn = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    gn = got / np.linalg.norm(got, axis=1, keepdims=True)
    assert (rn * gn).sum(axis=1).min() > 0.999


@pytest.mark.parametrize("h,d", [(2, 128), (2, 96), (1, 128)], ids=["hd64", "hd48", "hd128"])
def test_head_dims_other_than_32_match_the_reference(h, d):
    """Head dims the CUDA kernel takes (64, 128) or zero-pads (48): the
    plain version against the Pallas kernel in interpret mode (bf16, live
    rows and the fully masked row within 5e-2) and against ``_xla_reference``
    in float32 (1e-5)."""
    qkv, mask = _case(3, 40, d, seed=d + h)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(jattention(jq, jnp.asarray(mask), n_heads=h, impl="interpret").astype(jnp.float32))
    got = tfa.attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask), n_heads=h).float().numpy()
    live = mask[:, :, None]
    assert np.isfinite(got).all()
    assert np.max(np.abs(ref - got) * live) < 5e-2
    assert np.abs(ref[-1] - got[-1]).max() < 5e-2
    ref32 = np.asarray(_xla_reference(jnp.asarray(qkv), jnp.asarray(mask), h))
    got32 = tfa.masked_attention_reference(torch.from_numpy(qkv), torch.from_numpy(mask), h).numpy()
    assert np.max(np.abs(ref32 - got32) * live) < 1e-5
