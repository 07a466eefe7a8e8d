"""The port's widened kernel limits against the JAX package, on the CPU:
attention at S above 512 (the reference's ``attention`` takes its XLA chain
there), LayerNorm rows wider than 1024 (the reference's layer takes any
width) and paged decode attention at head dims above 256 (the reference's
Pallas kernel has no limit; its plain reference is compared here). The CUDA
kernels behind the same wrappers are held to these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: f32 plain versions within 1e-5 of the reference (the same
math summed in another order); bf16 ctx within 5e-2 on live rows, the bound
``tests/test_torch_attention.py`` holds; LayerNorm f32 within 1e-4 at width
1536 (a longer row sum)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import fused_layer as jfl
from pathway_tpu.ops.fused_attention import _xla_packed_reference, _xla_reference
from pathway_tpu.ops.fused_attention import attention as jattention
from pathway_tpu_torch.ops import fused_attention as tfa
from pathway_tpu_torch.ops import fused_layer as tfl


def _masked_case(b, s, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * d)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    lens[0] = s
    mask = np.arange(s)[None, :] < lens[:, None]
    mask[-1, :] = False  # every key of the last row masked
    return qkv, mask


@pytest.mark.parametrize("s", [513, 1024])
def test_masked_attention_plain_over_512_matches_xla_chain(s):
    """f32: the plain version against the reference's XLA chain, tightly;
    bf16: ``attention`` (the kernel's wrapper) against the reference's
    ``attention``, which takes its XLA chain at S > 512."""
    qkv, mask = _masked_case(3, s, 64, seed=s)
    want = np.asarray(_xla_reference(jnp.asarray(qkv), jnp.asarray(mask), 2))
    got = tfa.masked_attention_reference(torch.from_numpy(qkv), torch.from_numpy(mask), 2).numpy()
    live = mask[:, :, None] | ~mask.any(axis=1)[:, None, None]
    assert np.max(np.abs(want - got) * live) < 1e-5
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(jattention(jq, jnp.asarray(mask), n_heads=2).astype(jnp.float32))
    out = tfa.attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask), n_heads=2).float().numpy()
    assert np.isfinite(out).all() and np.max(np.abs(ref - out) * live) < 5e-2


@pytest.mark.parametrize("s", [513, 1024])
def test_segment_attention_plain_over_512_matches_xla_chain(s):
    """Segments of 40-300 tokens packed back to back into rows of S tokens,
    -1 padding at the tail."""
    rng = np.random.default_rng(7 + s)
    b, d, h = 2, 64, 2
    qkv = rng.standard_normal((b, s, 3 * d)).astype(np.float32)
    seg = np.full((b, s), -1, np.int32)
    nxt = 0
    for r in range(b):
        at = 0
        while at < s - 40:
            n = min(int(rng.integers(40, 300)), s - 40 - at)
            seg[r, at:at + n] = nxt
            nxt, at = nxt + 1, at + n
    want = np.asarray(_xla_packed_reference(jnp.asarray(qkv), jnp.asarray(seg), h))
    got = tfa.segment_attention_reference(torch.from_numpy(qkv), torch.from_numpy(seg), h).numpy()
    live = (seg >= 0)[:, :, None]
    assert np.max(np.abs(want - got) * live) < 1e-5 and (got[seg < 0] == 0).all()
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ref = np.asarray(jattention(jq, None, n_heads=h, segment_ids=jnp.asarray(seg)).astype(jnp.float32))
    out = tfa.attention(torch.from_numpy(qkv).bfloat16(), None, n_heads=h,
                        segment_ids=torch.from_numpy(seg)).float().numpy()
    assert np.max(np.abs(ref - out) * live) < 5e-2


@pytest.mark.parametrize("n,k", [(1536, 1536), (1032, 64)])
def test_layernorm_rows_over_1024_match_the_reference_layer(n, k):
    """``LN(residual + x @ w.T + b)`` at widths past the register-resident
    ones (1536 staged as is, 1032 padded to 1536 on the card), against the
    reference layer's own LayerNorm."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((5, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    b, r = rng.standard_normal(n).astype(np.float32), rng.standard_normal((5, n)).astype(np.float32)
    gam, bet = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)
    v = jnp.asarray(r) + (jnp.asarray(x) @ jnp.asarray(w).T + jnp.asarray(b))
    want = np.asarray(jfl._ln(v, jnp.asarray(gam)[None], jnp.asarray(bet)[None], 1e-12))
    t = [torch.from_numpy(a) for a in (x, w, b, r, gam, bet)]
    got_f32, got_low = tfl.gemm_bias_residual_layernorm(*t, 1e-12)
    np.testing.assert_allclose(got_f32.numpy(), want, rtol=1e-4, atol=1e-4)
    assert tfl._ln_width(n) == 1536 and tfl._ln_staged(1536)
