"""Multi-head self-attention on fused qkv with a key-padding mask.

Port of ``pathway_tpu/ops/fused_attention.py`` (kernel B3, ``_fused_call``
/ ``_kernel``). On the TPU the kernel packs several short sequences into
one 256/512-row block and masks the cross-sequence tiles with
``BLOCK_OFF`` to keep its 128-wide matrix unit fed. On Hopper
``masked_attention`` (``csrc/masked_attention.cu``) gives each
(sequence, head, query tile) its own block, so no cross-sequence work
exists and ``BLOCK_OFF`` is kept only as the reference's constant. The
same kernel serves the attention step of the whole-layer path
(``ops/fused_layer.py``), which builds the key mask from lengths; key
tiles with no live key are skipped.

Padded keys get the finite additive ``KEY_OFF``: a row whose keys are all
masked averages V uniformly and never gives NaN.

Sequence packing (kernel B4, ``_packed_call`` / ``_seg_kernel``): with
``segment_ids`` several chunks share one row and a token attends exactly
the tokens that carry its id; ``segment_attention``
(``csrc/segment_attention.cu``) gives each (row, head, 64-query tile) a
block that walks only the key tiles whose id range can match. Query rows
with id -1 are padding that no caller reads: the kernel and its plain
version write zeros there.

Both kernels run the same FlashAttention-2 loop (``csrc/flash_tile.cuh``:
an online softmax in registers, P rounded to bf16 before normalisation),
templated on head dims 32, 64, 128 and 256; the wrappers zero-pad any
other head dim up to 256 to the next of these.
"""

from __future__ import annotations

import math

import torch

from . import _build

BLOCK_OFF = -1.0e30  # additive bias outside the block diagonal (TPU packing)
KEY_OFF = -1.0e9  # additive bias on padded keys

_HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernels are built for
_MAX_HEAD_DIM = _HEAD_DIMS[-1]  # any other head dim up to this is zero-padded to the next one
_MAX_S = 512


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


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """f32 softmax of ``scores`` times V at the kernels' rounding point:
    ``exp(s - max)`` rounded to the working dtype before normalisation, P.V
    in f32, divided by the f32 sum of the unrounded exponentials."""
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return (e.to(dt).float() @ v) / e.sum(dim=-1, keepdim=True)


def masked_attention_reference(
    qkv: torch.Tensor, key_mask: torch.Tensor, n_heads: int, zero_empty: bool = False
) -> torch.Tensor:
    """Plain version of the ``masked_attention`` kernel, with its rounding
    points: f32 scores, additive KEY_OFF on padded keys, f32 softmax
    statistics, probabilities rounded to the working dtype before
    normalisation, f32 P.V, ctx in the working dtype. ``zero_empty``: a
    sequence with no live key gives 0."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    dt = qkv.dtype
    q, k, v = (_split_heads(t, n_heads).float() for t in qkv.split(d, dim=-1))
    live = key_mask.bool()
    kb = torch.where(live, 0.0, KEY_OFF).to(torch.float32)
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd)) + kb[:, None, None, :]
    ctx = _softmax_pv(scores, v, dt).transpose(1, 2).reshape(b, s, d)
    if zero_empty:
        ctx = torch.where(live.any(dim=1)[:, None, None], ctx, 0.0)
    return ctx.to(dt)


def _attention_operands(qkv, other, n_heads: int, name: str, other_name: str) -> tuple[int, int, int, int, int]:
    """The attention kernels' operand checks -> (b, s, d, head dim, the
    kernel's head dim). Raises ValueError on what they do not take: a
    dtype, rank or layout other than contiguous bf16 [B, S, 3D], a width
    that does not split into heads, a head dim over 256, S > 512, or a
    ``other`` of another shape or device."""
    _build.require(qkv, dtype=torch.bfloat16, ndim=3, name="qkv")
    b, s, three_d = qkv.shape
    d = three_d // 3
    if three_d % 3 or d % n_heads:
        raise ValueError(f"qkv width {three_d} does not split into 3 x {n_heads} heads")
    hd = d // n_heads
    if hd > _MAX_HEAD_DIM or s > _MAX_S:
        raise ValueError(
            f"{name} takes head dims up to {_MAX_HEAD_DIM} (kernels for {_HEAD_DIMS}, others zero-padded "
            f"to the next) and S <= {_MAX_S}, got head dim {hd}, S {s}"
        )
    if tuple(other.shape) != (b, s) or other.device != qkv.device:
        raise ValueError(f"{other_name} must be [{b}, {s}] on {qkv.device}")
    return b, s, d, hd, next(k for k in _HEAD_DIMS if k >= hd)


def masked_attention_operands(qkv, key_mask, n_heads: int) -> tuple[int, int, int, int, int]:
    """:func:`_attention_operands` of ``masked_attention``."""
    return _attention_operands(qkv, key_mask, n_heads, "masked_attention", "key_mask")


def segment_attention_operands(qkv, segment_ids, n_heads: int) -> tuple[int, int, int, int, int]:
    """:func:`_attention_operands` of ``segment_attention``."""
    return _attention_operands(qkv, segment_ids, n_heads, "segment_attention", "segment_ids")


def _pad_heads(qkv: torch.Tensor, n_heads: int, hd: int, hdp: int) -> torch.Tensor:
    """qkv [B, S, 3 * H * hd] -> [B, S, 3 * H * hdp], each head's q, k and v
    zero-padded: zero columns change neither q.k nor the kept columns of
    the output."""
    if hdp == hd:
        return qkv
    b, s, _ = qkv.shape
    x = torch.nn.functional.pad(qkv.view(b, s, 3, n_heads, hd), (0, hdp - hd))
    return x.reshape(b, s, 3 * n_heads * hdp)


def _unpad_heads(out: torch.Tensor, n_heads: int, hd: int, hdp: int) -> torch.Tensor:
    if hdp == hd:
        return out
    b, s, _ = out.shape
    return out.view(b, s, n_heads, hdp)[..., :hd].reshape(b, s, n_heads * hd)


def _launch(source: str, entry: str, qkv, other, n_heads: int, hd: int, hdp: int, *extra) -> torch.Tensor:
    """Run one attention kernel on (zero-padded) heads; ``other`` is the
    mask or the segment ids, ``extra`` the entry point's trailing ints."""
    b, s, _ = qkv.shape
    x = _pad_heads(qkv, n_heads, hd, hdp)
    out = torch.empty((b, s, n_heads * hdp), dtype=qkv.dtype, device=qkv.device)
    if b and s:
        err = getattr(_build.library(source), entry)(
            x.data_ptr(), other.data_ptr(), out.data_ptr(), b, s, n_heads * hdp, hdp, 1.0 / math.sqrt(hd),
            *extra, _build.stream_handle(qkv),
        )
        _build.check(err, entry[3:])
        _build.LAUNCHES[entry[3:]] += 1
    return _unpad_heads(out, n_heads, hd, hdp)


def masked_attention(
    qkv: torch.Tensor, key_mask: torch.Tensor, n_heads: int, zero_empty: bool = False
) -> torch.Tensor:
    """qkv [B, S, 3D] (q | k | v, heads minor within each), key_mask
    [B, S] bool -> ctx [B, S, D]. CUDA tensors launch the kernel (bf16,
    head dim up to 256, S <= 512) or raise; CPU tensors take
    :func:`masked_attention_reference`."""
    if not qkv.is_cuda:
        return masked_attention_reference(qkv, key_mask, n_heads, zero_empty)
    _, _, _, hd, hdp = masked_attention_operands(qkv, key_mask, n_heads)
    mask = key_mask.contiguous()
    mask = mask.view(torch.uint8) if mask.dtype == torch.bool else mask.to(torch.uint8)
    return _launch("masked_attention.cu", "pt_masked_attention", qkv, mask, n_heads, hd, hdp, int(zero_empty))


def segment_attention_reference(qkv: torch.Tensor, segment_ids: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain version of the ``segment_attention`` kernel, with its rounding
    points: f32 scores, keys of other segments excluded, f32 softmax
    statistics, probabilities rounded to the working dtype before
    normalisation, f32 P.V, ctx in the working dtype; query rows with
    segment -1 give 0."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    dt = qkv.dtype
    q, k, v = (_split_heads(t, n_heads).float() for t in qkv.split(d, dim=-1))
    seg = segment_ids.to(torch.int32)
    same = seg[:, None, :, None] == seg[:, None, None, :]  # a -1 row matches itself: no NaN
    scores = ((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))).masked_fill(~same, float("-inf"))
    ctx = _softmax_pv(scores, v, dt).transpose(1, 2).reshape(b, s, d)
    return torch.where((seg >= 0)[:, :, None], ctx, 0.0).to(dt)


def segment_attention(qkv: torch.Tensor, segment_ids: torch.Tensor, n_heads: int) -> torch.Tensor:
    """qkv [B, S, 3D], segment_ids [B, S] int (-1 = padding) -> ctx [B, S, D].
    CUDA tensors launch the kernel (bf16, head dim up to 256, S <= 512) or
    raise; CPU tensors take :func:`segment_attention_reference`."""
    if not qkv.is_cuda:
        return segment_attention_reference(qkv, segment_ids, n_heads)
    _, _, _, hd, hdp = segment_attention_operands(qkv, segment_ids, n_heads)
    seg = segment_ids.to(torch.int32).contiguous()
    return _launch("segment_attention.cu", "pt_segment_attention", qkv, seg, n_heads, hd, hdp)


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
