"""The port's ring attention and sequence-parallel encoding held against the
JAX package's, on an 8-shard CPU device pool.

The cases of ``tests/test_long_context.py``: ``ring_attention`` over eight
shards against plain full attention (rtol / atol 2e-5) and against the
reference's ring; ``ring_encode`` against the reference's ``ring_encode``
and against the one-device ``TextEncoder`` forward (3e-4), with a ragged
mask and with a sequence of 128 over eight shards, the reference's
weights carried over with ``weights.from_jax_params``. Then the port's
``shard_map`` itself (lockstep collectives, errors, grad mode) and
``ring_encode``'s checks and cache.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta
from jax.sharding import PartitionSpec as P

from pathway_tpu.models.encoder import EncoderConfig as JEncoderConfig
from pathway_tpu.models.encoder import TextEncoder as JTextEncoder
from pathway_tpu.models.encoder import init_params as jinit_params
from pathway_tpu.models.long_context import ring_attention as jring_attention
from pathway_tpu.models.long_context import ring_encode as jring_encode
from pathway_tpu.parallel.sharding import make_mesh as jmake_mesh
from pathway_tpu.parallel.sharding import shard_map as jshard_map
from pathway_tpu_torch.models import long_context
from pathway_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from pathway_tpu_torch.models.long_context import ring_attention, ring_encode
from pathway_tpu_torch.parallel.mesh import resolve_mesh, set_device_pool
from pathway_tpu_torch.parallel.sharding import make_mesh, shard_map
from pathway_tpu_torch.weights import from_jax_params

GEOMETRY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position=128,
                pooling="mean")
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
ENCODE_TOL = dict(rtol=3e-4, atol=3e-4)
SPLIT = (None, None, "data")


@pytest.fixture(autouse=True)
def pool8():
    """Eight CPU devices stand in for the reference's eight virtual ones."""
    prev = set_device_pool(["cpu"] * 8)
    yield resolve_mesh(8, device="cpu")
    set_device_pool(prev)


@pytest.fixture(scope="module")
def weights():
    """(reference config, reference params, port config, port state dict)."""
    jcfg = JEncoderConfig(**GEOMETRY, dtype=jnp.float32)
    params = jinit_params(JTextEncoder(jcfg), jcfg)
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, meta.unbox(params)))
    return jcfg, params, EncoderConfig(**GEOMETRY, dtype=torch.float32), sd


def _full_attention(q, k, v, mask):
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    scores = np.where(mask[:, None, None, :], scores, np.finfo(np.float32).min)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


def test_ring_attention_matches_full_attention_and_the_reference(pool8):
    rng = np.random.default_rng(0)
    B, H, S, D = 2, 4, 64, 16
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), bool)
    mask[:, 50:] = False  # ragged tail: the last shard's block is fully masked
    ringed = shard_map(lambda ax, q, k, v, m: ring_attention(q, k, v, m, ax), mesh=pool8,
                       in_specs=(SPLIT, SPLIT, SPLIT, (None, "data")), out_specs=SPLIT)(
        *map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(ringed, _full_attention(q, k, v, mask), **ATTN_TOL)
    want = jax.jit(jshard_map(lambda q, k, v, m: jring_attention(q, k, v, m, "data"), mesh=jmake_mesh(model_parallel=1),
                              in_specs=(P(*SPLIT),) * 3 + (P(None, "data"),), out_specs=P(*SPLIT),
                              check_vma=False))(q, k, v, mask)
    np.testing.assert_allclose(ringed, np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("batch,seq,ragged", [(2, 64, True), (1, 128, False)])
def test_ring_encode_matches_the_reference_and_one_device(weights, pool8, batch, seq, ragged):
    jcfg, params, cfg, sd = weights
    rng = np.random.default_rng(seq)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), bool)
    if ragged:
        mask[1, 40:] = False
    got = ring_encode(sd, cfg, ids, mask, pool8, axis="data")
    assert got.shape == (batch, cfg.hidden_size) and got.dtype == torch.float32
    want = jring_encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask), jmake_mesh(model_parallel=1), axis="data")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENCODE_TOL)
    one = TextEncoder(cfg)
    one.load_state_dict(sd)
    with torch.no_grad():
        direct = one(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got.numpy(), direct, **ENCODE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(JTextEncoder(jcfg).apply(params, ids, mask)), **ENCODE_TOL)


def test_ring_encode_over_a_pool_spec_and_its_cache(weights, pool8):
    _jcfg, _params, cfg, sd = weights
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 64))
    mask = np.ones((1, 64), bool)
    a = ring_encode(sd, cfg, ids, mask, 8)  # the spec resolves on the pool
    n = len(long_context._RING_FNS)
    b = ring_encode(sd, cfg, torch.from_numpy(ids), torch.from_numpy(mask), pool8)
    assert len(long_context._RING_FNS) == n  # one prepared forward per (config, mesh, axis)
    assert torch.equal(a, b)
    c = ring_encode(sd, cfg, ids, mask, make_mesh(devices=["cpu"] * 4, model_parallel=1))
    np.testing.assert_allclose(c.numpy(), a.numpy(), **ENCODE_TOL)


def test_ring_encode_bf16_stays_close_to_f32(weights, pool8):
    _jcfg, _params, cfg, sd = weights
    import dataclasses

    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64))
    mask = np.ones((2, 64), bool)
    mask[0, 10:] = False
    f32 = ring_encode(sd, cfg, ids, mask, pool8)
    bf16 = ring_encode(sd, dataclasses.replace(cfg, dtype=torch.bfloat16), ids, mask, pool8)
    assert torch.nn.functional.cosine_similarity(f32, bf16).min() > 0.999


def test_ring_encode_checks_its_shapes(weights, pool8):
    _jcfg, _params, cfg, sd = weights
    with pytest.raises(ValueError, match="sequence 60 must divide across 8 shards"):
        ring_encode(sd, cfg, np.zeros((1, 60), np.int64), np.ones((1, 60), bool), pool8)
    with pytest.raises(ValueError, match="sequence length 256 exceeds max_position 128; raise "
                                         "EncoderConfig.max_position for long-context encoding"):
        ring_encode(sd, cfg, np.zeros((1, 256), np.int64), np.ones((1, 256), bool), pool8)


def test_shard_map_collectives_run_in_lockstep(pool8):
    x = torch.arange(16.0).reshape(2, 8)

    def body(ax, t):
        assert ax.size == 8 and ax.axis_index() == ax.index and t.shape == (2, 1)
        total = ax.psum(t.sum())
        nxt, prev = ax.ppermute(t), ax.ppermute(t, shift=-1)
        return total.expand(1), nxt, prev, torch.full((1, 1), float(ax.axis_index()))

    total, nxt, prev, idx = shard_map(body, mesh=pool8, in_specs=((None, "data"),),
                                      out_specs=((), (None, "data"), (None, "data"), (None, "data")))(x)
    assert total.item() == x.sum().item()
    assert torch.equal(nxt, torch.roll(x, 1, dims=1)) and torch.equal(prev, torch.roll(x, -1, dims=1))
    assert idx.flatten().tolist() == list(range(8))


def test_shard_map_raises_a_shard_error_and_keeps_grad_mode(pool8):
    def failing(ax, t):
        if ax.axis_index() == 3:
            raise RuntimeError("shard 3 failed")
        return ax.psum(t)  # the other shards wait here until the failure releases them

    with pytest.raises(RuntimeError, match="shard 3 failed"):
        shard_map(failing, mesh=pool8, in_specs=((),), out_specs=())(torch.ones(2))
    modes = shard_map(lambda ax, t: torch.tensor([torch.is_grad_enabled()]), mesh=pool8, in_specs=((),),
                      out_specs=(("data",)))
    with torch.no_grad():
        assert not modes(torch.ones(1)).any()
    assert modes(torch.ones(1)).all()
    with pytest.raises(ValueError, match="names another mesh axis"):
        shard_map(lambda ax, t: t, mesh=pool8, in_specs=(("model",),), out_specs=())
