"""Multi-head self-attention on fused qkv with a key-padding mask.

Port of ``pathway_tpu/ops/fused_attention.py`` (kernel B3, ``_fused_call``
/ ``_kernel``). On the TPU the kernel packs several short sequences into
one 256/512-row block and masks the cross-sequence tiles with
``BLOCK_OFF`` to keep its 128-wide matrix unit fed. On Hopper
``masked_attention`` (``csrc/masked_attention.cu``) gives each
(sequence, head, query tile) its own block, so no cross-sequence work
exists and ``BLOCK_OFF`` is kept only as the reference's constant. The
same kernel serves the attention step of the whole-layer path
(``ops/fused_layer.py``), which builds the key mask from lengths.

Padded keys get the finite additive ``KEY_OFF``: a row whose keys are all
masked averages V uniformly and never gives NaN.

Sequence packing (kernel B4, ``_packed_call`` / ``_seg_kernel``): with
``segment_ids`` several chunks share one row and a token attends exactly
the tokens that carry its id; ``segment_attention``
(``csrc/segment_attention.cu``) gives each (row, head, 64-query tile) a
block that walks only the key tiles whose id range can match, with an
online softmax in registers (FlashAttention-2 style). Query rows with id
-1 are padding that no caller reads: the kernel and its plain version
write zeros there.
"""

from __future__ import annotations

import math

import torch

from . import _build

BLOCK_OFF = -1.0e30  # additive bias outside the block diagonal (TPU packing)
KEY_OFF = -1.0e9  # additive bias on padded keys

_HEAD_DIMS = (32,)  # head dims the kernel is built for (MiniLM)


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)  # [b, h, s, hd]


def attention_reference(qkv: torch.Tensor, key_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The plain attention chain, the counterpart of the reference's
    ``_xla_reference``: scores in the working dtype, masked keys at the
    dtype's minimum, f32 softmax, probabilities in the working dtype."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    dt = qkv.dtype
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(d, dim=-1))
    scores = (q.float() @ k.float().transpose(-1, -2)).to(dt) / math.sqrt(hd)
    scores = scores.masked_fill(~key_mask.bool()[:, None, None, :], torch.finfo(dt).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    ctx = (probs.float() @ v.float()).to(dt)
    return ctx.transpose(1, 2).reshape(b, s, d)


def masked_attention_reference(
    qkv: torch.Tensor, key_mask: torch.Tensor, n_heads: int, zero_empty: bool = False
) -> torch.Tensor:
    """Plain version of the ``masked_attention`` kernel, with its rounding
    points: f32 scores, additive KEY_OFF on padded keys, f32 softmax,
    probabilities rounded to the working dtype, f32 P.V, ctx in the
    working dtype. ``zero_empty``: a sequence with no live key gives 0."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    dt = qkv.dtype
    q, k, v = (_split_heads(t, n_heads).float() for t in qkv.split(d, dim=-1))
    live = key_mask.bool()
    kb = torch.where(live, 0.0, KEY_OFF).to(torch.float32)
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd)) + kb[:, None, None, :]
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    ctx = (probs.float() @ v).transpose(1, 2).reshape(b, s, d)
    if zero_empty:
        ctx = torch.where(live.any(dim=1)[:, None, None], ctx, 0.0)
    return ctx.to(dt)


def masked_attention(
    qkv: torch.Tensor, key_mask: torch.Tensor, n_heads: int, zero_empty: bool = False
) -> torch.Tensor:
    """qkv [B, S, 3D] (q | k | v, heads minor within each), key_mask
    [B, S] bool -> ctx [B, S, D]. CUDA tensors launch the kernel (bf16,
    head dim 32, S <= 512) or raise; CPU tensors take
    :func:`masked_attention_reference`."""
    if not qkv.is_cuda:
        return masked_attention_reference(qkv, key_mask, n_heads, zero_empty)
    _build.require(qkv, dtype=torch.bfloat16, ndim=3, name="qkv")
    b, s, three_d = qkv.shape
    d = three_d // 3
    if three_d % 3 or d % n_heads or d % 8:
        raise ValueError(f"qkv width {three_d} does not split into 3 x {n_heads} heads")
    hd = d // n_heads
    if hd not in _HEAD_DIMS or s > 512:
        raise ValueError(f"masked_attention takes head dim {_HEAD_DIMS} and S <= 512, got {hd}, {s}")
    if tuple(key_mask.shape) != (b, s) or key_mask.device != qkv.device:
        raise ValueError(f"key_mask must be [{b}, {s}] on {qkv.device}")
    mask = key_mask.contiguous()
    mask = mask.view(torch.uint8) if mask.dtype == torch.bool else mask.to(torch.uint8)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or s == 0:
        return out
    err = _build.library("masked_attention.cu").pt_masked_attention(
        qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), b, s, d, hd,
        1.0 / math.sqrt(hd), int(zero_empty), _build.stream_handle(qkv),
    )
    _build.check(err, "masked_attention")
    _build.LAUNCHES["masked_attention"] += 1
    return out


def segment_attention_reference(qkv: torch.Tensor, segment_ids: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain version of the ``segment_attention`` kernel, with its rounding
    points: f32 scores, keys of other segments excluded, f32 softmax,
    probabilities rounded to the working dtype, f32 P.V, ctx in the working
    dtype; query rows with segment -1 give 0."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    dt = qkv.dtype
    q, k, v = (_split_heads(t, n_heads).float() for t in qkv.split(d, dim=-1))
    seg = segment_ids.to(torch.int32)
    same = seg[:, None, :, None] == seg[:, None, None, :]  # a -1 row matches itself: no NaN
    scores = ((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))).masked_fill(~same, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = (probs.float() @ v).transpose(1, 2).reshape(b, s, d)
    return torch.where((seg >= 0)[:, :, None], ctx, 0.0).to(dt)


def segment_attention_operands(qkv, segment_ids, n_heads: int) -> tuple[int, int, int, int]:
    """The kernel's operand checks -> (b, s, d, head dim). Raises
    ValueError on what the kernel does not take: a dtype, rank or layout
    other than contiguous bf16 [B, S, 3D], a head dim other than 32, S >
    512, or segment ids of another shape or device."""
    _build.require(qkv, dtype=torch.bfloat16, ndim=3, name="qkv")
    b, s, three_d = qkv.shape
    d = three_d // 3
    if three_d % 3 or d % n_heads or d % 8:
        raise ValueError(f"qkv width {three_d} does not split into 3 x {n_heads} heads")
    hd = d // n_heads
    if hd not in _HEAD_DIMS or s > 512:
        raise ValueError(f"segment_attention takes head dim {_HEAD_DIMS} and S <= 512, got {hd}, {s}")
    if tuple(segment_ids.shape) != (b, s) or segment_ids.device != qkv.device:
        raise ValueError(f"segment_ids must be [{b}, {s}] on {qkv.device}")
    return b, s, d, hd


def segment_attention(qkv: torch.Tensor, segment_ids: torch.Tensor, n_heads: int) -> torch.Tensor:
    """qkv [B, S, 3D], segment_ids [B, S] int (-1 = padding) -> ctx [B, S, D].
    CUDA tensors launch the kernel (bf16, head dim 32, S <= 512) or raise;
    CPU tensors take :func:`segment_attention_reference`."""
    if not qkv.is_cuda:
        return segment_attention_reference(qkv, segment_ids, n_heads)
    b, s, d, hd = segment_attention_operands(qkv, segment_ids, n_heads)
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or s == 0:
        return out
    err = _build.library("segment_attention.cu").pt_segment_attention(
        qkv.data_ptr(), seg.data_ptr(), out.data_ptr(), b, s, d, hd, 1.0 / math.sqrt(hd),
        _build.stream_handle(qkv),
    )
    _build.check(err, "segment_attention")
    _build.LAUNCHES["segment_attention"] += 1
    return out


def attention(
    qkv: torch.Tensor,
    key_mask: torch.Tensor,
    *,
    n_heads: int,
    impl: str = "auto",
    segment_ids=None,
) -> torch.Tensor:
    """Multi-head self-attention on fused qkv -> ctx [B, S, D].

    impl: "auto" (the kernel on a CUDA tensor, its plain version on a CPU
    tensor), "kernel" (CUDA only; raises on a CPU tensor), or "plain"
    (:func:`attention_reference`, or :func:`segment_attention_reference`
    when packed, on any device).

    ``segment_ids`` [B, S] int: SEQUENCE PACKING, kernel B4. A token
    attends exactly the tokens with its segment id (-1 marks padding);
    ``key_mask`` is ignored in this mode."""
    if impl == "kernel" and not qkv.is_cuda:
        raise ValueError("attention impl='kernel' needs a CUDA tensor")
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if segment_ids is not None:
        if impl == "plain":
            return segment_attention_reference(qkv, segment_ids, n_heads)
        return segment_attention(qkv, segment_ids, n_heads)
    if impl == "plain":
        return attention_reference(qkv, key_mask, n_heads)
    return masked_attention(qkv, key_mask, n_heads)
