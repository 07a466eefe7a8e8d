"""Long-context encoding: ring attention over a sequence-sharded mesh.

Port of ``pathway_tpu/models/long_context.py``. A document longer than one
device's attention window is encoded with its sequence axis split over a
mesh axis: every layer is local to a shard but attention, whose K/V blocks
rotate one hop around the ring per step, accumulating exact softmax
attention with the numerically stable online update (the ring attention
recipe). The reference writes it as a ``shard_map`` with ``lax.ppermute``;
the port writes it against its own ``parallel/sharding.shard_map``, whose
shards run in lockstep, each on its own thread and device: a rotation is a
``.to(next_device)``, a no-op on a pooled mesh whose shards share one card
and a peer copy across cards. The reference runs no Pallas kernel here,
and the ring's math is plain PyTorch in f32.

API:
  ring_attention(q, k, v, mask, ax)  -- inside a shard_map body
  ring_encode(params, cfg, ids, mask, mesh, axis)  -- the whole encoder's
      sequence-parallel forward, one long document per batch row
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import resolve_mesh
from ..parallel.sharding import DeviceMesh, ShardAxis, axis_devices, shard_map
from .encoder import _norm


def _online_block(q, k_blk, v_blk, mask_blk, acc, m, l, scale):
    """One flash-attention style accumulation step.

    q: [B, H, Sq, d]   k_blk/v_blk: [B, H, Sk, d]   mask_blk: [B, Sk]
    acc: [B, H, Sq, d] running weighted values; m/l: [B, H, Sq] running
    max / normaliser (all f32)."""
    keep = mask_blk[:, None, None, :]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
    scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a fully masked block (and the first block of a fully masked row)
    # keeps m at finfo.min: the correction is exp(0) = 1 and every p is 0
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None]).masked_fill(~keep, 0.0)
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
    return acc_new, m_new, l_new


def ring_attention(q, k, v, mask, ax: ShardAxis):
    """Exact attention with the KV sequence sharded over ``ax``'s mesh axis.

    Call inside a ``shard_map`` body. q/k/v: [B, H, S_local, d] (this
    shard's slice of the sequence); mask: [B, S_local] bool. Each of the N
    steps attends q against the K/V block it holds, then rotates K/V and the
    mask one hop around the ring: N-1 rotations, the last one's result would
    be discarded. Returns [B, H, S_local, d] in q's dtype."""
    n = ax.size
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], torch.finfo(torch.float32).min, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    qf = q.float()
    k_blk, v_blk, mask_blk = k, v, mask.bool()
    for i in range(n):
        acc, m, l = _online_block(qf, k_blk.float(), v_blk.float(), mask_blk, acc, m, l, scale)
        if i < n - 1:
            k_blk, v_blk, mask_blk = ax.ppermute((k_blk, v_blk, mask_blk))
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.to(q.dtype)


def _sp_encoder_forward(ax: ShardAxis, params, ids, mask, cfg):
    """Sequence-parallel TextEncoder forward over one shard (one long
    document per batch row): everything is local but attention, which rings,
    and the pool's sums. ``params``: a TextEncoder state dict."""
    dev, dt = ax.device, cfg.dtype
    d, h = cfg.hidden_size, cfg.num_heads
    hd = d // h

    def w(name):
        return params[name].to(dev)

    def dense(x, name):
        return nn.functional.linear(x, w(name + ".weight").to(dt), w(name + ".bias").to(dt))

    # local embedding lookup; positions are global offsets
    s_local = ids.shape[1]
    pos = ax.axis_index() * s_local + torch.arange(s_local, device=dev)
    x = nn.functional.embedding(ids.long(), w("tok_embed.weight"))
    x = x + w("pos_embed.weight")[pos][None, :, :]
    if "type_embed.weight" in params:
        x = x + w("type_embed.weight")[0][None, None, :]
    x = _norm(x, w("ln_embed.weight"), w("ln_embed.bias"), cfg.layer_norm_eps, dt)
    mask = mask.bool()
    B = x.shape[0]
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}."
        q, k, v = dense(x, pre + "attention.qkv").split(d, dim=-1)
        q, k, v = (t.reshape(B, s_local, h, hd).transpose(1, 2) for t in (q, k, v))
        ctx = ring_attention(q, k, v, mask, ax).transpose(1, 2).reshape(B, s_local, d)
        a = dense(ctx, pre + "attention.out")
        x = _norm(x + a, w(pre + "ln_att.weight"), w(pre + "ln_att.bias"), cfg.layer_norm_eps, dt)
        mlp = nn.functional.gelu(dense(x, pre + "mlp_in"), approximate="tanh")
        mlp = dense(mlp, pre + "mlp_out")
        x = _norm(x + mlp, w(pre + "ln_mlp.weight"), w(pre + "ln_mlp.bias"), cfg.layer_norm_eps, dt)
    # masked mean pool: local partial sums, then a sum over the shards
    mf = mask[:, :, None].float()
    total, cnt = ax.psum(((x.float() * mf).sum(dim=1), mf.sum(dim=1)))
    pooled = total / torch.clamp(cnt, min=1e-9)
    if cfg.normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled


# the prepared sequence-parallel forward per (config, mesh devices, axis):
# the reference caches its jitted shard_map the same way
_RING_FNS: dict = {}
_RING_LOCK = threading.Lock()


def ring_encode(params, cfg, ids, mask, mesh, axis: str = "data") -> torch.Tensor:
    """Encode [B, S] token ids with S split over ``axis`` of ``mesh`` (S
    must divide by the axis size). ``params``: a TextEncoder state dict (the
    reference's weights through ``weights.from_jax_params``); ``mesh``: a
    ``DeviceMesh`` or a spec ``parallel/mesh.resolve_mesh`` resolves (on the
    device pool when one is set). Returns the [B, hidden] f32 pooled
    embeddings on the axis's first device."""
    if not isinstance(mesh, DeviceMesh):
        mesh = resolve_mesh(mesh)
    n = mesh.shape[axis]
    B, S = ids.shape
    if S % n:
        raise ValueError(f"sequence {S} must divide across {n} shards")
    if S > cfg.max_position:
        # an embedding lookup past the table would fail, or read another row
        raise ValueError(
            f"sequence length {S} exceeds max_position {cfg.max_position}; "
            "raise EncoderConfig.max_position for long-context encoding"
        )
    ids = torch.as_tensor(np.asarray(ids) if not isinstance(ids, torch.Tensor) else ids)
    mask = torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor) else mask)
    key = (repr(cfg), tuple(axis_devices(mesh, axis)), tuple(mesh.shape.items()), axis)
    with _RING_LOCK:
        fn = _RING_FNS.get(key)
        if fn is None:
            fn = _RING_FNS[key] = shard_map(
                lambda ax, p, i, m: _sp_encoder_forward(ax, p, i, m, cfg),
                mesh=mesh,
                in_specs=(None, (None, axis), (None, axis)),
                out_specs=(),
                axis=axis,
            )
    with torch.no_grad():
        return fn(params, ids, mask)
