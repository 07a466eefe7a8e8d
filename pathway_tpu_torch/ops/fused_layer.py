"""One whole encoder layer per call, and the encoder forward built on it.

Port of ``pathway_tpu/ops/fused_layer.py`` (kernel B1,
``fused_layer_tokens`` / ``_layer_kernel``):

    x -> qkv proj -> ragged per-sequence attention -> out proj
      -> +residual, LayerNorm -> FFN (tanh-GELU, f32 accumulation)
      -> +residual, LayerNorm

The TPU kernel keeps one layer's weights (about 3.5 MB in bf16 at MiniLM
width) resident in VMEM for a whole block of packed tokens. A Hopper
block has at most 227 KB of shared memory, so the layer runs as three
hand-written kernels (``csrc/gemm_epilogue.cu``, ``csrc/masked_attention.cu``):

1. ``gemm_bias_act``: qkv projection (N = 3d) and ``mlp_in`` with GELU;
2. ``masked_attention``: per (sequence, head, query tile), keys at or past
   the sequence's length masked, a length-0 sequence writes zeros;
3. ``gemm_bias_residual_layernorm``: out projection + residual + LN1 and
   ``mlp_out`` + residual + LN2 on the same TMA + wgmma mainloop, with an
   output tile that spans whole rows (N in ``_LN_WIDTHS``), so the row
   statistics come from the accumulators; rows of 1024 columns and more
   (multiples of 512) pass through f32 device memory in chunks of 512.

Attention takes head dims up to 256 (``ops/fused_attention.py``).

The kernels load rows with a 16-byte stride (K and N multiples of 8) and
the LayerNorm kernel is built for the widths in ``_LN_WIDTHS`` and the
staged multiples of 512 from 1024 up. The wrappers take any other K and N
by zero padding: a parameter (weight, bias, gamma, beta) is padded once, when
``prepare_params`` lays it out or at its first use, and kept beside it; an
activation is padded per call; the result is sliced back. Zero columns of
K add nothing to a product, and the LayerNorm kernel leaves columns past
the true width out of the row's statistics.

Rounding points follow the TPU kernel: qkv rounded to bf16 after its bias;
ctx in bf16; ``att`` stays f32 into ``LN1(x + att)``; ``h1`` stays f32 as
the residual of LN2 and only its bf16 copy feeds ``mlp_in``; the GELU
output is rounded to bf16 before ``mlp_out``; LayerNorm is
``mean((x - mu)^2)`` in f32. The kernels have no backward (the
reference gives ``fused_layer_tokens`` none): their wrappers raise when
grad is enabled and an operand requires it. ``encoder_forward`` is
differentiable as the reference's is: its backward recomputes through the
``TextEncoder`` module.

The packed-token layout (``pack_tokens`` / ``block_lens`` /
``_pack_rows``) is kept so a layer's inputs can be laid out as the
reference's are; ``encoder_forward`` does not pack: the Hopper kernels take
the [B*S, d] rows and per-sequence lengths as they are.
"""

from __future__ import annotations

import math
import threading
import weakref

import torch

from . import _build
from .fused_attention import masked_attention, masked_attention_reference

# row widths the LayerNorm-epilogue kernel holds in registers: the decoder
# (256), MiniLM (384), BERT-small (512), BERT-base (768)
_LN_WIDTHS = (256, 384, 512, 768)
# wider rows (BERT-large's 1024 and up) are staged: multiples of this chunk,
# their rows pass through f32 device memory before the LayerNorm
_LN_CHUNK = 512


def _pack_rows(s: int) -> int:
    """Sequences packed per token block in the reference's layout."""
    if s <= 128:
        return max(1, 256 // s)
    if s < 256:
        return max(1, 512 // s)
    return 1


def block_lens(lens: torch.Tensor, s: int) -> torch.Tensor:
    """Per-row real lengths [B] -> per-block [bp, p] int32 (rows padded
    with zero-length sequences)."""
    p = _pack_rows(s)
    lens = lens.to(torch.int32)
    pad = (-lens.shape[0]) % p
    if pad:
        lens = torch.cat([lens, lens.new_zeros(pad)])
    return lens.reshape(-1, p)


def pack_tokens(x: torch.Tensor, key_mask: torch.Tensor, lens: torch.Tensor | None = None):
    """[B, S, d] -> packed [bp*rows, d] tokens + [bp, p] lengths + B."""
    b, s, d = x.shape
    p = _pack_rows(s)
    pad = (-b) % p
    if lens is None:
        lens = key_mask.to(torch.int32).sum(dim=1)
    if pad:
        x = torch.cat([x, x.new_zeros(pad, s, d)])
    return x.reshape(-1, d), block_lens(lens, s), b


def unpack_tokens(tokens: torch.Tensor, b: int, s: int) -> torch.Tensor:
    return tokens.reshape(-1, s, tokens.shape[1])[:b]


_PADDED: dict[tuple, tuple] = {}  # (id(param), shape) -> (weakref to param, its version, padded copy)
_PAD_LOCK = threading.Lock()


def _pad_to(t: torch.Tensor, shape: tuple[int, ...], *, keep: bool = False) -> torch.Tensor:
    """``t`` zero-padded at the end of each dim to ``shape``. ``keep``: ``t``
    is a parameter, so the copy is made once and kept while ``t`` lives and
    is not written to."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    key = (id(t), shape)
    if keep:
        hit = _PADDED.get(key)
        if hit is not None and hit[0]() is t and hit[1] == t._version:
            return hit[2]
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    if keep:
        with _PAD_LOCK:
            _PADDED[key] = (weakref.ref(t, lambda _, key=key: _PADDED.pop(key, None)), t._version, out)
    return out


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def _ln_width(n: int) -> int:
    """The LayerNorm kernel's width for a row of ``n`` columns: the next of
    ``_LN_WIDTHS``, past them the next staged multiple of 512."""
    for width in _LN_WIDTHS:
        if width >= n:
            return width
    return -(-n // _LN_CHUNK) * _LN_CHUNK


def _ln_staged(n: int) -> bool:
    """Whether the kernel stages rows of width ``n`` in f32 device memory."""
    return n > _LN_WIDTHS[-1]


def _gelu_tanh(x32: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x32 * (1.0 + torch.tanh(c * (x32 + 0.044715 * x32**3)))


def _ln(x32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


# --------------------------------------------------------------- kernel 1


def gemm_bias_act_reference(x, w, b, act: bool = False):
    """Plain version: ``act(x @ w.T + b)`` in f32, rounded to x's dtype."""
    y = x.float() @ w.float().T + b.float()
    if act:
        y = _gelu_tanh(y)
    return y.to(x.dtype)


def gemm_bias_act_operands(x, w, b) -> tuple[int, int, int]:
    """The kernel's operand checks -> (m, n, k). Raises ValueError on a
    dtype, rank, layout, shape or device the kernel does not take: K and N
    must be multiples of 8 (the 16-byte row strides of its TMA loads and
    store), and w and b must lie on x's device."""
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"gemm_bias_act operands must all lie on {x.device}")
    _build.require(x, dtype=torch.bfloat16, ndim=2, name="x")
    _build.require(w, dtype=torch.bfloat16, ndim=2, name="w")
    _build.require(b, dtype=torch.float32, ndim=1, name="b")
    m, k = x.shape
    n = w.shape[0]
    if w.shape[1] != k or b.shape[0] != n or k % 8 or n % 8:
        raise ValueError(f"gemm_bias_act shapes x{tuple(x.shape)} w{tuple(w.shape)} b{tuple(b.shape)}")
    return m, n, k


def gemm_bias_act(x, w, b, act: bool = False):
    """x [M, K] bf16, w [N, K] bf16, b [N] f32 -> act(x w^T + b) [M, N]
    bf16. CUDA tensors launch the kernel or raise; CPU tensors take the
    plain version. K or N not a multiple of 8 runs zero-padded to one. Has
    no backward: raises RuntimeError when grad is enabled and an operand
    requires it."""
    _build.no_backward("gemm_bias_act", x, w, b)
    if not x.is_cuda:
        return gemm_bias_act_reference(x, w, b, act)
    n_true, k_true = w.shape[0], x.shape[-1]
    if x.dim() == 2 and w.dim() == 2 and (k_true % 8 or n_true % 8):
        kp, np_ = _up8(k_true), _up8(n_true)
        y = gemm_bias_act(
            _pad_to(x, (x.shape[0], kp)), _pad_to(w, (np_, kp), keep=True),
            _pad_to(b, (np_,), keep=True), act,
        )
        return y[:, :n_true].contiguous()
    m, n, k = gemm_bias_act_operands(x, w, b)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    err = _build.library("gemm_epilogue.cu").pt_gemm_bias_act(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k, int(act), _build.stream_handle(x),
    )
    _build.check(err, "gemm_bias_act")
    _build.LAUNCHES["gemm_bias_act"] += 1
    return y


# --------------------------------------------------------------- kernel 2


def gemm_bias_residual_layernorm_reference(x, w, b, residual, gamma, beta, eps: float, *, out_f32: bool = True):
    """Plain version: ``LN(residual + x @ w.T + b)`` in f32 -> (f32 or
    None, its copy in x's dtype)."""
    y = _ln(residual.float() + (x.float() @ w.float().T + b.float()), gamma, beta, eps)
    return (y if out_f32 else None), y.to(x.dtype)


def gemm_bias_residual_layernorm_operands(x, w, b, residual, gamma, beta) -> tuple[int, int, int]:
    """The kernel's operand checks -> (m, n, k). Raises ValueError on a
    dtype, rank, layout, shape or device the kernel does not take: N must
    be one of ``_LN_WIDTHS`` or a multiple of 512 from 1024 up, and K a
    multiple of 8 (the 16-byte row stride of its TMA loads)."""
    if any(t.device != x.device for t in (w, b, residual, gamma, beta)):
        raise ValueError(f"gemm_bias_residual_layernorm operands must all lie on {x.device}")
    _build.require(x, dtype=torch.bfloat16, ndim=2, name="x")
    _build.require(w, dtype=torch.bfloat16, ndim=2, name="w")
    if residual.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"residual must be bf16 or f32, got {residual.dtype}")
    _build.require(residual, dtype=residual.dtype, ndim=2, name="residual")
    for t, nm in ((b, "b"), (gamma, "gamma"), (beta, "beta")):
        _build.require(t, dtype=torch.float32, ndim=1, name=nm)
    m, k = x.shape
    n = w.shape[0]
    if (
        w.shape[1] != k
        or tuple(residual.shape) != (m, n)
        or any(t.shape[0] != n for t in (b, gamma, beta))
        or k % 8
        or _ln_width(n) != n
    ):
        raise ValueError(
            f"gemm_bias_residual_layernorm shapes x{tuple(x.shape)} w{tuple(w.shape)} "
            f"residual{tuple(residual.shape)}; N must be one of {_LN_WIDTHS} or a multiple of "
            f"{_LN_CHUNK} from 1024 up, and K a multiple of 8"
        )
    return m, n, k


def gemm_bias_residual_layernorm(x, w, b, residual, gamma, beta, eps: float, *, out_f32: bool = True):
    """x [M, K] bf16, w [N, K] bf16, residual [M, N] bf16 or f32, b/gamma/
    beta [N] f32 -> (LN f32 [M, N] or None, its bf16 copy). CUDA tensors
    launch the kernel (any N: a width the kernel does not take and a K not
    a multiple of 8 run zero-padded) or raise; CPU tensors take the plain
    version. ``out_f32``: also return the f32 rows (the next residual); at
    a staged width (1024 and up) the kernel stages the rows there either
    way. Has no backward, as :func:`gemm_bias_act`."""
    _build.no_backward("gemm_bias_residual_layernorm", x, w, b, residual, gamma, beta)
    if not x.is_cuda:
        return gemm_bias_residual_layernorm_reference(x, w, b, residual, gamma, beta, eps, out_f32=out_f32)
    n_true = w.shape[0]
    if x.dim() == 2 and w.dim() == 2 and residual.dim() == 2 and (x.shape[1] % 8 or _ln_width(n_true) != n_true):
        kp, np_ = _up8(x.shape[1]), _ln_width(n_true)
        vec = lambda t: _pad_to(t, (np_,), keep=True)  # noqa: E731
        x = _pad_to(x, (x.shape[0], kp))
        w = _pad_to(w, (np_, kp), keep=True)
        b, gamma, beta = vec(b), vec(gamma), vec(beta)
        residual = _pad_to(residual, (residual.shape[0], np_))
    m, n, k = gemm_bias_residual_layernorm_operands(x, w, b, residual, gamma, beta)
    yf = torch.empty((m, n), dtype=torch.float32, device=x.device) if out_f32 or _ln_staged(n) else None
    yb = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        err = _build.library("gemm_epilogue.cu").pt_gemm_bias_residual_layernorm(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), residual.data_ptr(),
            int(residual.dtype == torch.float32), gamma.data_ptr(), beta.data_ptr(),
            yf.data_ptr() if yf is not None else None, yb.data_ptr(),
            m, n, n_true, k, float(eps), _build.stream_handle(x),
        )
        _build.check(err, "gemm_bias_residual_layernorm")
        _build.LAUNCHES["gemm_bias_residual_layernorm"] += 1
    if n != n_true:
        yf = yf[:, :n_true].contiguous() if out_f32 else None
        yb = yb[:, :n_true].contiguous()
    return (yf if out_f32 else None), yb


# ------------------------------------------------------------ whole layer

_LAYER_KEYS = (
    "attention.qkv.weight", "attention.qkv.bias", "attention.out.weight",
    "attention.out.bias", "ln_att.weight", "ln_att.bias", "mlp_in.weight",
    "mlp_in.bias", "mlp_out.weight", "mlp_out.bias", "ln_mlp.weight", "ln_mlp.bias",
)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights out of a TextEncoder state dict."""
    pre = f"layers.{i}."
    return {key: params[pre + key] for key in _LAYER_KEYS}


def _lens_mask(lens: torch.Tensor, seq: int) -> torch.Tensor:
    return torch.arange(seq, device=lens.device)[None, :] < lens.reshape(-1)[:, None]


def _layer(tokens, key_mask, lp, n_heads, seq, eps, gemm, gemm_ln, attn):
    """One layer; ``.to()`` is a no-op for weights from ``prepare_params``."""
    dt = tokens.dtype
    d = tokens.shape[1]
    w = lambda key: lp[key].to(dt).contiguous()  # noqa: E731
    f = lambda key: lp[key].to(torch.float32).contiguous()  # noqa: E731
    qkv = gemm(tokens, w("attention.qkv.weight"), f("attention.qkv.bias"), False)
    ctx = attn(qkv.view(-1, seq, 3 * d), key_mask, n_heads, True).view(-1, d)
    h1, h1_low = gemm_ln(
        ctx, w("attention.out.weight"), f("attention.out.bias"), tokens,
        f("ln_att.weight"), f("ln_att.bias"), eps, out_f32=True,
    )
    mid = gemm(h1_low, w("mlp_in.weight"), f("mlp_in.bias"), True)
    _, out = gemm_ln(
        mid, w("mlp_out.weight"), f("mlp_out.bias"), h1,
        f("ln_mlp.weight"), f("ln_mlp.bias"), eps, out_f32=False,
    )
    return out


def _layer_fns(impl: str, tokens: torch.Tensor):
    """The (gemm, gemm_ln, attention) functions ``impl`` selects."""
    if impl == "plain":
        return gemm_bias_act_reference, gemm_bias_residual_layernorm_reference, masked_attention_reference
    if impl == "kernel" and not tokens.is_cuda:
        raise ValueError("layer impl='kernel' needs a CUDA tensor")
    if impl not in ("auto", "kernel"):
        raise ValueError(f"unknown layer impl {impl!r}")
    return gemm_bias_act, gemm_bias_residual_layernorm, masked_attention


def fused_layer_tokens_reference(tokens, lens, layer_params: dict, *, n_heads: int, seq: int, eps: float):
    """Plain version of one layer over tokens [n*seq, d] with the lengths
    of their n sequences (any shape, e.g. [B] or [bp, p] from
    ``pack_tokens``), at the kernels' rounding points."""
    fns = _layer_fns("plain", tokens)
    return _layer(tokens, _lens_mask(lens, seq), layer_params, n_heads, seq, eps, *fns)


def fused_layer_tokens(
    tokens, lens, layer_params: dict, *, n_heads: int, seq: int, eps: float, impl: str = "auto"
):
    """One encoder layer over tokens [n*seq, d] with the lengths of their
    n sequences ([B] or [bp, p]). impl: "auto" (kernels on CUDA tensors,
    plain versions on CPU tensors), "kernel" (CUDA only), or "plain"
    (plain versions on any device)."""
    fns = _layer_fns(impl, tokens)
    return _layer(tokens.contiguous(), _lens_mask(lens, seq), layer_params, n_heads, seq, eps, *fns)


_WORKING_DTYPE_KEYS = ("tok_embed.weight", "pos_embed.weight", "type_embed.weight") + tuple(
    k for k in _LAYER_KEYS if k.endswith(".weight") and not k.startswith("ln_")
)


def prepare_params(params: dict, cfg) -> dict:
    """A TextEncoder state dict laid out for ``encoder_forward``: embeddings
    and projection weights cast to ``cfg.dtype`` once, biases and LayerNorm
    in f32, all contiguous, so the forward makes no cast per call. Values
    are those the forward would cast to anyway. On a CUDA device the
    layers' parameters that the kernels take only zero-padded (a width
    outside ``_LN_WIDTHS``, K or N not a multiple of 8) are padded here,
    once."""
    out = {}
    for name, t in params.items():
        key = name.split(".", 2)[-1] if name.startswith("layers.") else name
        dt = cfg.dtype if key in _WORKING_DTYPE_KEYS else torch.float32
        out[name] = t.to(dt).contiguous()
    if any(t.is_cuda for t in out.values()) and cfg.dtype == torch.bfloat16:
        if "attention.qkv.weight" in out:  # one layer's parameters (``layer_params``)
            _pad_layer(out)
        for i in range(cfg.num_layers):
            if f"layers.{i}.attention.qkv.weight" in out:
                _pad_layer(layer_params(out, i))
    return out


def _pad_layer(lp: dict) -> None:
    """Pad one layer's parameters as its kernel calls will ask for them."""
    for proj in ("attention.qkv", "mlp_in"):
        n, k = lp[proj + ".weight"].shape
        _pad_to(lp[proj + ".weight"], (_up8(n), _up8(k)), keep=True)
        _pad_to(lp[proj + ".bias"], (_up8(n),), keep=True)
    for proj, ln in (("attention.out", "ln_att"), ("mlp_out", "ln_mlp")):
        n, k = lp[proj + ".weight"].shape
        width = _ln_width(n)
        _pad_to(lp[proj + ".weight"], (width, _up8(k)), keep=True)
        for key in (proj + ".bias", ln + ".weight", ln + ".bias"):
            _pad_to(lp[key], (width,), keep=True)


# ------------------------------------------------------------ the encoder


class _EncoderForward(torch.autograd.Function):
    """``encoder_forward`` with the reference's ``_encoder_forward`` vjp: the
    forward as called (the whole-layer kernels on a card), the backward
    recomputed through the ``TextEncoder`` module on the same state-dict
    tensors, so every gradient has its tensor's shape (never a padded one)."""

    @staticmethod
    def forward(ctx, cfg, ids, mask, lens, names, *tensors):
        ctx.cfg, ctx.names = cfg, names
        ctx.save_for_backward(ids, mask, *tensors)
        return _encoder_forward(dict(zip(names, tensors)), cfg, ids, mask, lens)

    @staticmethod
    def backward(ctx, g):
        from ..models.encoder import TextEncoder

        ids, mask, *tensors = ctx.saved_tensors
        with torch.device("meta"):
            module = TextEncoder(ctx.cfg)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, ctx.needs_input_grad[5:])]
            out = torch.func.functional_call(module, dict(zip(ctx.names, leaves)), (ids, mask))
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if t.requires_grad else None for t in leaves)


def encoder_forward(params: dict, cfg, ids, mask, *, lens=None):
    """TextEncoder forward (embeddings -> one whole-layer call per layer ->
    pooling) off a TextEncoder state dict (best from ``prepare_params``).
    ``lens`` [B] (per-row real lengths) skips the mask reduction; ``mask``
    must be prefix-contiguous either way. Differentiable: with grad enabled
    and a state-dict tensor that requires it, the backward recomputes
    through the ``TextEncoder`` module and returns a gradient for every
    such tensor, at its shape."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in params.values()):
        names = tuple(params)
        return _EncoderForward.apply(cfg, ids, mask, lens, names, *(params[n] for n in names))
    return _encoder_forward(params, cfg, ids, mask, lens)


def _encoder_forward(params: dict, cfg, ids, mask, lens):
    dt = cfg.dtype
    b, s = ids.shape
    emb = lambda key: params[key].to(dt)  # noqa: E731
    x = torch.nn.functional.embedding(ids, emb("tok_embed.weight"))
    x = x + emb("pos_embed.weight")[None, :s]
    if cfg.type_vocab_size:
        x = x + emb("type_embed.weight")[0][None, None, :]
    x = _ln(x.float(), params["ln_embed.weight"], params["ln_embed.bias"], cfg.layer_norm_eps).to(dt)
    key_mask = mask.bool() if lens is None else _lens_mask(lens, s)
    fns = _layer_fns(cfg.layer_impl, x)
    tokens = x.reshape(-1, x.shape[-1])
    for i in range(cfg.num_layers):
        tokens = _layer(
            tokens, key_mask, layer_params(params, i), cfg.num_heads, s, cfg.layer_norm_eps, *fns
        )
    x = tokens.view(b, s, -1)
    if cfg.pooling == "cls":
        pooled = x[:, 0].float()
    else:
        m = mask[:, :, None].to(x.dtype)
        pooled = ((x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)).float()
    if cfg.normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled


def encoder_flops_per_token(cfg, seq: int) -> float:
    """Dense forward FLOPs per token at padded length ``seq`` (multiply-add = 2)."""
    return encoder_flops(cfg, 1, seq)


def encoder_flops(cfg, tokens: int, attn_pairs: int) -> float:
    """Forward FLOPs of ``tokens`` tokens whose attention scores
    ``attn_pairs`` (query, key) pairs: the qkv, output and FFN GEMMs per
    token, QK^T and PV per pair (multiply-add = 2)."""
    d, interm, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    per_token = 2 * d * 3 * d + 2 * d * d + 2 * 2 * d * interm
    return float(layers * (tokens * per_token + 2 * 2 * d * attn_pairs))


def use_fused_encoder(cfg, seq_len: int) -> bool:
    """The dispatch decision of every encode path: the whole-layer path
    whenever the geometry fits (the reference's ``supports_fused_encoder``).
    Whether its layers run as kernels or as their plain versions is
    ``cfg.layer_impl`` and the tensors' device."""
    return cfg.hidden_size % cfg.num_heads == 0 and seq_len <= 512 and cfg.pooling in ("mean", "cls")
