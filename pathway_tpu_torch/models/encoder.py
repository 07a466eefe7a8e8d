"""BERT-style transformer encoder as PyTorch modules.

Port of ``pathway_tpu/models/encoder.py``: ``EncoderConfig`` and the
``SelfAttention`` / ``EncoderLayer`` / ``TextEncoder`` / ``CrossEncoderHead``
modules, with the same names and state layout (``weights.py`` maps the
reference's flax trees onto these modules' state dicts and back).
Parameters are kept in float32 and cast to ``cfg.dtype`` where they are
used, as flax does with ``dtype=bf16`` modules. The attention step is
``ops/fused_attention``: kernel B3 on CUDA tensors, or kernel B4 when the
call is sequence-packed (``position_ids`` + ``segment_ids``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops.fused_attention import attention

# logical axis names of the parameters (mapped to mesh axes by
# parallel/sharding.LOGICAL_RULES: embed -> None, heads/mlp -> "model")
EMBED = "embed"
HEADS = "heads"
MLP = "mlp"
VOCAB = "vocab"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    # pooling: "mean" (sentence-transformers MiniLM), "cls" (cross-encoder)
    pooling: str = "mean"
    normalize: bool = True
    # "auto": the kernel on CUDA tensors, the plain version on CPU tensors;
    # "kernel": CUDA only; "plain": the plain version on any device
    attention_impl: str = "auto"
    layer_impl: str = "auto"

    @classmethod
    def minilm_l6(cls, **kw) -> "EncoderConfig":
        """all-MiniLM-L6-v2 geometry."""
        return cls(**kw)

    @classmethod
    def minilm_l12(cls, **kw) -> "EncoderConfig":
        return cls(num_layers=12, **kw)

    @classmethod
    def cross_encoder_l6(cls, **kw) -> "EncoderConfig":
        kw.setdefault("pooling", "cls")
        kw.setdefault("normalize", False)
        return cls(**kw)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return nn.functional.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    """Statistics in f32, output in ``dtype`` (flax LayerNorm with dtype)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * weight + bias).to(dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    return _norm(x, ln.weight, ln.bias, ln.eps, dtype)


def pool(x: torch.Tensor, mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """Token states [B, S, d] -> f32 sentence embeddings: the CLS state or
    the masked mean, L2-normalised when ``cfg.normalize``."""
    if cfg.pooling == "cls":
        pooled = x[:, 0]
    else:  # masked mean pooling (sentence-transformers default)
        m = mask[:, :, None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    pooled = pooled.float()
    if cfg.normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        # QKV fused into one projection: concatenated q | k | v
        self.qkv = nn.Linear(d, 3 * d)
        self.out = nn.Linear(d, d)

    def forward(self, x, mask, segment_ids=None):
        cfg = self.cfg
        qkv = _linear(x, self.qkv, cfg.dtype)
        ctx = attention(
            qkv.contiguous(), mask, n_heads=cfg.num_heads, impl=cfg.attention_impl, segment_ids=segment_ids
        )
        return _linear(ctx, self.out, cfg.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.ln_att = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln_mlp = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask, segment_ids=None):
        dt = self.cfg.dtype
        a = self.attention(x, mask, segment_ids)
        x = _layer_norm(x + a, self.ln_att, dt)
        m = nn.functional.gelu(_linear(x, self.mlp_in, dt), approximate="tanh")
        m = _linear(m, self.mlp_out, dt)
        return _layer_norm(x + m, self.ln_mlp, dt)


class TextEncoder(nn.Module):
    """Token ids -> pooled sentence embedding (or token states)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.tok_embed = nn.Embedding(cfg.vocab_size, d)
        self.pos_embed = nn.Embedding(cfg.max_position, d)
        self.type_embed = nn.Embedding(cfg.type_vocab_size, d) if cfg.type_vocab_size else None
        self.ln_embed = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        ids,
        mask,
        token_type_ids=None,
        return_tokens: bool = False,
        position_ids=None,
        segment_ids=None,
    ):
        """``position_ids``/``segment_ids`` [B, S] enable SEQUENCE PACKING:
        several chunks share one row, positions restart per chunk and
        attention stays inside each segment (kernel B4). A packed call
        returns token states; the caller pools per segment."""
        cfg = self.cfg
        dt = cfg.dtype
        ids = ids.long()
        # rows are looked up, then cast (the values of a cast table's rows):
        # a table's gradient then sums its tokens' rows in the table's f32,
        # through the embedding backward's segment sums (an index_put
        # backward serialises the many tokens that share one type id)
        emb = nn.functional.embedding
        x = emb(ids, self.tok_embed.weight).to(dt)
        pos = self.pos_embed.weight
        x = x + (emb(position_ids.long(), pos) if position_ids is not None else pos[: ids.shape[1]][None]).to(dt)
        if self.type_embed is not None:
            tt = token_type_ids.long() if token_type_ids is not None else torch.zeros_like(ids)
            x = x + emb(tt, self.type_embed.weight).to(dt)
        x = _layer_norm(x, self.ln_embed, dt)
        mask = mask.bool()
        for layer in self.layers:
            x = layer(x, mask, segment_ids)
        if return_tokens or segment_ids is not None:
            return x
        return pool(x, mask, cfg)

    def cast_for_inference(self) -> "TextEncoder":
        """Store the embedding and projection parameters in ``cfg.dtype``
        (LayerNorm stays f32). The forward casts them to ``cfg.dtype`` at
        every use, so its results do not change and those casts become
        no-ops."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.to(self.cfg.dtype)
        return self


class CrossEncoderHead(nn.Module):
    """(query, doc) pair -> relevance score: the TextEncoder's token
    states, the CLS state in f32, an f32 ``Linear(d, 1)``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, 1)

    def forward(self, ids, mask, token_type_ids):
        x = self.encoder(ids, mask, token_type_ids, return_tokens=True)
        cls = x[:, 0].float()
        w, b = self.classifier.weight.float(), self.classifier.bias.float()
        return nn.functional.linear(cls, w, b)[:, 0]

    def cast_for_inference(self) -> "CrossEncoderHead":
        """The encoder's weights in ``cfg.dtype`` (the classifier stays f32);
        results do not change."""
        self.encoder.cast_for_inference()
        return self


def _is_layer_norm(name: str) -> bool:
    return name.split(".")[-2].startswith("ln_")


# the reference's Dense kernel_axes ([in, out]) read in the port's [out, in]
# weight layout, and its token embedding's (vocab, embed)
_LOGICAL_AXES = {
    "attention.qkv.weight": (HEADS, EMBED),
    "attention.out.weight": (EMBED, HEADS),
    "mlp_in.weight": (MLP, EMBED),
    "mlp_out.weight": (EMBED, MLP),
    "tok_embed.weight": (VOCAB, EMBED),
}


def param_logical_axes(model: nn.Module, cfg: EncoderConfig) -> dict[str, tuple]:
    """State-dict name -> logical axes of each dimension (a name or None),
    the counterpart of the reference's ``nn.get_partition_spec`` tree: the
    projections' heads / mlp axes and the token embedding's vocab axis; every
    other parameter (biases, LayerNorm, position and type embeddings, the
    cross-encoder's classifier) has none, an empty tuple."""
    return {
        name: next((axes for key, axes in _LOGICAL_AXES.items() if f".{name}".endswith(f".{key}")), ())
        for name in model.state_dict()
    }


def init_params(cfg: EncoderConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded float32 weights for the port's own runs, as a TextEncoder
    state dict on the CPU: normal(0.02) kernels and embeddings, zero
    biases, LayerNorm scale 1 and bias 0."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in TextEncoder(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        if _is_layer_norm(name):
            out[name] = (torch.ones if name.endswith("weight") else torch.zeros)(shape)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape)
        else:
            out[name] = torch.empty(shape).normal_(0.0, 0.02, generator=gen)
    return out


def init_cross_encoder_params(cfg: EncoderConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded float32 weights as a CrossEncoderHead state dict on the CPU:
    the encoder's from :func:`init_params`, a normal(0.02) classifier with
    a zero bias."""
    out = {f"encoder.{k}": v for k, v in init_params(cfg, seed).items()}
    gen = torch.Generator().manual_seed(seed + 1)
    out["classifier.weight"] = torch.empty(1, cfg.hidden_size).normal_(0.0, 0.02, generator=gen)
    out["classifier.bias"] = torch.zeros(1)
    return out
