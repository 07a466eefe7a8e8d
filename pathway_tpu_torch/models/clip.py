"""CLIP ViT-B/32 image + text dual encoder for multimodal RAG, as PyTorch
modules.

Port of ``pathway_tpu/models/clip.py``. Vision tower: ViT-B/32 (patchify
as one matrix product, 12 layers, width 768); text tower: a causal
transformer (width 512, 8 heads, vocab 49,408, context 77); a joint
512-d embedding space, L2-normalised. The reference runs no Pallas kernel
here (its attention is plain einsums), and neither does the port: the
towers are plain PyTorch. The image embeddings feed the device index
(``encode_image_device`` -> ``DeviceKnnIndex.add_batch_device``), whose
top-k is kernel B2.

Where flax's defaults differ from PyTorch's, the port keeps flax's:

* the patches are flattened in ``(p, p, 3)`` order (a reshape and
  transpose of the ``[B, H, W, 3]`` image), not ``nn.Conv2d``'s
  ``(3, p, p)``; ``weights.from_jax_clip_params`` carries the projection
  over as it is;
* LayerNorm's epsilon is 1e-6, its statistics are taken in f32 as
  ``mean(x^2) - mean(x)^2`` and its output is cast to the model's dtype;
* ``Linear`` weights are kept in f32 and cast to the dtype at use (flax's
  ``param_dtype``), the class token and position tables in the dtype
  itself (flax's ``self.param(..., cfg.dtype)``);
* attention scores are computed in the dtype, masked with its
  ``finfo.min`` and soft-maxed in f32; the activation is QuickGELU,
  ``y * sigmoid(1.702 y)``;
* the text tower is causal and key-masked, and pools at
  ``max(mask.sum - 1, 0)``.

Images travel to the card as flat uint8 rows: ``rgb`` (3 bytes a pixel) or
``yuv420`` (1.5 bytes a pixel, BT.601 full range, 2x2-pooled chroma; the
default). The host packs (``_pack_yuv420``, numpy, byte-identical to the
reference's); the card dequantises or rebuilds RGB in PyTorch before the
tower, as the reference does inside its jit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .batching import bucket, chunks
from .tokenizer import WordPieceTokenizer

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512
    dtype: Any = torch.bfloat16


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics (fast variance),
    f32 scale and bias, the result cast to ``dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight.float()
    return ((x32 - mu) * mul + ln.bias.float()).to(dtype)


class _Block(nn.Module):
    """Pre-LN transformer block: attention, then a QuickGELU MLP."""

    def __init__(self, width: int, heads: int, dtype, causal: bool = False):
        super().__init__()
        self.width, self.heads, self.dtype, self.causal = width, heads, dtype, causal
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.qkv = nn.Linear(width, 3 * width)
        self.attn_out = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_in = nn.Linear(width, 4 * width)
        self.mlp_out = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        d, h, dt = self.width, self.heads, self.dtype
        hd = d // h
        B, n = x.shape[0], x.shape[1]
        y = _layer_norm(x, self.ln_1, dt)
        q, k, v = _dense(y, self.qkv, dt).split(d, dim=-1)
        q, k, v = (t.reshape(B, n, h, hd) for t in (q, k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        low = torch.finfo(scores.dtype).min
        if self.causal:
            keep = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~keep[None, None], low)
        if mask is not None:
            scores = scores.masked_fill(~mask.bool()[:, None, None, :], low)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, n, d)
        x = x + _dense(ctx, self.attn_out, dt)
        y = _dense(_layer_norm(x, self.ln_2, dt), self.mlp_in, dt)
        y = y * torch.sigmoid(1.702 * y)  # QuickGELU (CLIP)
        return x + _dense(y, self.mlp_out, dt)


class VisionTower(nn.Module):
    """[B, H, W, 3] f32 images in [0, 1] -> [B, embed_dim] (not normalised)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        p, w = cfg.patch_size, cfg.vision_width
        n = (cfg.image_size // p) ** 2
        self.patch_proj = nn.Linear(p * p * 3, w, bias=False)
        self.cls = nn.Parameter(torch.zeros(1, 1, w, dtype=cfg.dtype))
        self.pos = nn.Parameter(torch.zeros(1, n + 1, w, dtype=cfg.dtype))
        self.ln_pre = nn.LayerNorm(w, eps=LN_EPS)
        self.blocks = nn.ModuleList(_Block(w, cfg.vision_heads, cfg.dtype) for _ in range(cfg.vision_layers))
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.proj = nn.Linear(w, cfg.embed_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt, p, w = cfg.dtype, cfg.patch_size, cfg.vision_width
        B, H, W, _ = images.shape
        n = (H // p) * (W // p)
        # patchify in the reference's (p, p, 3) flatten order -> one matrix product
        x = images.reshape(B, H // p, p, W // p, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, n, p * p * 3)
        x = _dense(x, self.patch_proj, dt)
        x = torch.cat([self.cls.to(dt).expand(B, 1, w), x], dim=1)
        x = _layer_norm(x + self.pos.to(dt), self.ln_pre, dt)
        for block in self.blocks:
            x = block(x)
        x = _layer_norm(x[:, 0], self.ln_post, dt)
        return _dense(x, self.proj, dt)


class CLIPTextTower(nn.Module):
    """[B, context] token ids + key mask -> [B, embed_dim] (not normalised)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.text_width
        self.tok = nn.Embedding(cfg.vocab_size, w)
        self.pos = nn.Parameter(torch.zeros(1, cfg.context_length, w, dtype=cfg.dtype))
        self.blocks = nn.ModuleList(
            _Block(w, cfg.text_heads, cfg.dtype, causal=True) for _ in range(cfg.text_layers)
        )
        self.ln_final = nn.LayerNorm(w, eps=LN_EPS)
        self.proj = nn.Linear(w, cfg.embed_dim, bias=False)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        mask = mask.bool()
        x = nn.functional.embedding(ids.long(), self.tok.weight).to(dt)
        x = x + self.pos[:, : ids.shape[1]].to(dt)
        for block in self.blocks:
            x = block(x, mask)
        x = _layer_norm(x, self.ln_final, dt)
        # pool at the last real token (CLIP takes the EOT position)
        last = torch.clamp(mask.sum(dim=1) - 1, min=0)
        x = x[torch.arange(x.shape[0], device=x.device), last]
        return _dense(x, self.proj, dt)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def init_clip_params(cfg: CLIPConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded weights for the port's own runs, as a ``vision.`` / ``text.``
    state dict on the CPU: flax's initialisers in kind (LeCun-normal
    projections, zero biases, unit LayerNorm, fan-in-normal token table,
    normal(0.02) class token, normal(0.01) positions), drawn from a
    ``torch.Generator``. They are not the reference's numbers: tests carry
    the reference's weights over with ``weights.from_jax_clip_params``."""
    with torch.device("meta"):
        shapes = {
            **{f"vision.{k}": (v.shape, v.dtype) for k, v in VisionTower(cfg).state_dict().items()},
            **{f"text.{k}": (v.shape, v.dtype) for k, v in CLIPTextTower(cfg).state_dict().items()},
        }
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, dtype) in shapes.items():
        leaf = name.split(".")[-1]
        if ".ln_" in name:
            out[name] = (torch.ones if leaf == "weight" else torch.zeros)(shape)
        elif leaf == "bias":
            out[name] = torch.zeros(shape)
        elif leaf == "cls":
            out[name] = torch.empty(shape).normal_(0.0, 0.02, generator=gen).to(dtype)
        elif leaf == "pos":
            out[name] = torch.empty(shape).normal_(0.0, 0.01, generator=gen).to(dtype)
        else:  # Linear [out, in] and the token table [vocab, width]: fan-in normal
            fan_in = shape[1]
            out[name] = torch.empty(shape).normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
    return out


class CLIPEncoder:
    """Host-facing wrapper: ``encode_text(list[str])``, ``encode_image(ndarray)``
    and ``encode_image_device(ndarray)`` on ``device`` (the card unless the
    caller asks for the CPU)."""

    _BATCH_BUCKETS = (1, 8, 16, 32, 64, 128, 256)

    #: image wire format: "yuv420" (the default: half the host->device
    #: bytes, chroma at half resolution like the JPEGs CLIP trains on) or
    #: "rgb" (exact u8 RGB rows)
    transport: str = "yuv420"

    #: test hook: when set to a list, the staged loop appends "pack:i" /
    #: "stage:i" / "dispatch:i" / "complete:i" markers, so the pack-ahead
    #: order can be asserted without a device clock
    _pipeline_events: list | None = None

    def __init__(self, config: CLIPConfig | None = None, seed: int = 0, max_batch: int = 256, device=None):
        self.cfg = config or CLIPConfig()
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.vision = VisionTower(self.cfg)
        self.text = CLIPTextTower(self.cfg)
        self.load_state_dict(init_clip_params(self.cfg, seed))
        self.tokenizer = WordPieceTokenizer(vocab_size=self.cfg.vocab_size)
        # the 2-deep staging ring of image uploads (built on the first
        # _image_batches call)
        self._ring = None

    @property
    def dim(self) -> int:
        return self.cfg.embed_dim

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {
            **{f"vision.{k}": v for k, v in self.vision.state_dict().items()},
            **{f"text.{k}": v for k, v in self.text.state_dict().items()},
        }

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a ``vision.`` / ``text.`` state dict (``init_clip_params``,
        ``weights.from_jax_clip_params``) and put the towers on the device."""
        for prefix, tower in (("vision.", self.vision), ("text.", self.text)):
            part = {k[len(prefix) :]: v for k, v in state_dict.items() if k.startswith(prefix)}
            tower.load_state_dict(part)
            tower.to(self.device).eval().requires_grad_(False)

    # -- the device side of the two wires --

    def _vfwd_u8(self, flat: torch.Tensor) -> torch.Tensor:
        """Flat RGB u8 rows -> normalised image embeddings (dequantised on
        the device)."""
        H = self.cfg.image_size
        with torch.no_grad():
            im = flat.reshape(-1, H, H, 3).float() / 255.0
            return _normalize(self.vision(im))

    def _vfwd_yuv420(self, flat: torch.Tensor) -> torch.Tensor:
        """Flat Y | U | V rows -> normalised image embeddings: the chroma is
        upsampled 2x2 and converted back to RGB on the device."""
        H = self.cfg.image_size
        half = (H // 2) * (H // 2)
        with torch.no_grad():
            n = flat.shape[0]
            y = flat[:, : H * H].reshape(n, H, H).float()
            u = flat[:, H * H : H * H + half].reshape(n, H // 2, H // 2).float() - 128.0
            v = flat[:, H * H + half :].reshape(n, H // 2, H // 2).float() - 128.0
            u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            r = y + 1.402 * v
            g = y - 0.344136 * u - 0.714136 * v
            b = y + 1.772 * u
            im = torch.clamp(torch.stack([r, g, b], dim=-1) / 255.0, 0.0, 1.0)
            return _normalize(self.vision(im))

    def _tfwd(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return _normalize(self.text(ids, mask))

    # -- the host side --

    #: images a ``_pack_yuv420`` step converts: every pixel's arithmetic is
    #: the reference's, so the bytes do not depend on it, but a few images'
    #: f32 planes stay in the cache where a whole batch's would not
    _PACK_CHUNK = 4

    @classmethod
    def _pack_yuv420(cls, batch_u8: np.ndarray) -> np.ndarray:
        """[n, H, W, 3] u8 RGB -> flat [n, H*W*3/2] u8 (Y | U | V),
        BT.601 full-range, 2x2 mean-pooled chroma; byte-identical to the
        reference's, which converts the whole batch at once."""
        step = cls._PACK_CHUNK
        if len(batch_u8) <= step:
            return cls._pack_yuv420_chunk(batch_u8)
        return np.concatenate([cls._pack_yuv420_chunk(batch_u8[i : i + step]) for i in range(0, len(batch_u8), step)])

    @staticmethod
    def _pack_yuv420_chunk(batch_u8: np.ndarray) -> np.ndarray:
        f = batch_u8.astype(np.float32)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        n, hh, ww = y.shape
        u = u.reshape(n, hh // 2, 2, ww // 2, 2).mean(axis=(2, 4))
        v = v.reshape(n, hh // 2, 2, ww // 2, 2).mean(axis=(2, 4))

        def q(a):
            return np.clip(a + 0.5, 0, 255).astype(np.uint8).reshape(n, -1)

        return np.concatenate([q(y), q(u), q(v)], axis=1)

    def _note(self, tag: str) -> None:
        ev = self._pipeline_events
        if ev is not None:
            ev.append(tag)

    def _pack_image_batch(self, batch):
        """Host-side prep of one batch: quantise to uint8 (error <= 1/510 on
        [0, 1] inputs) and pack to flat wire rows at the padded bucket size.
        Returns (rows, flat u8, the device forward for the wire)."""
        n = len(batch)
        if np.asarray(batch).dtype != np.uint8:
            batch = np.clip(np.asarray(batch, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        else:
            batch = np.asarray(batch)
        if self.transport == "yuv420":
            flat = self._pack_yuv420(batch)
            fwd = self._vfwd_yuv420
        else:
            flat = batch.reshape(n, -1)
            fwd = self._vfwd_u8
        B = bucket(n, self._BATCH_BUCKETS)
        if B > n:
            flat = np.concatenate([flat, np.zeros((B - n, flat.shape[1]), np.uint8)])
        return n, flat, fwd

    def _image_batches(self, images):
        """Dispatch every image batch without a sync between them, staged one
        batch ahead: pack(i+1) runs between stage(i), the non-blocking copy
        into the 2-deep ``DeviceRing``, and the dispatch of batch i's
        tower, so host packing overlaps the previous batch's copy and
        compute. ``max_batch`` caps a batch (values above the largest
        bucket clamp to it). With an ingest stage active and more than one
        batch, the packing of every batch runs on the stage's workers while
        this thread stages and dispatches strictly in batch order, so the
        result is byte-identical to the inline loop at any worker count."""
        step = min(self.max_batch, self._BATCH_BUCKETS[-1])
        spans = list(range(0, len(images), step))
        if not spans:
            return []
        if self._ring is None:
            from ..engine.device_ring import DeviceRing

            self._ring = DeviceRing(depth=2, name="clip.image", device=self.device)
        from ..ingest import stage as ingest_stage

        st = ingest_stage.get_stage()
        pending = []
        if st is not None and len(spans) > 1:
            packed = st.map_ordered(lambda lo: self._pack_image_batch(images[lo : lo + step]), spans)
            for i, (n, flat, fwd) in enumerate(packed):
                self._note(f"stage:{i}")
                (flat_dev,) = self._ring.stage([flat])
                self._note(f"dispatch:{i}")
                emb = fwd(flat_dev)
                self._ring.retire([flat_dev])
                pending.append((n, emb))
            return pending
        self._note("pack:0")
        nxt = self._pack_image_batch(images[spans[0] : spans[0] + step])
        for i, lo in enumerate(spans):
            n, flat, fwd = nxt
            self._note(f"stage:{i}")
            (flat_dev,) = self._ring.stage([flat])  # non-blocking copy
            if i + 1 < len(spans):
                # pack the next batch while this one's copy is in flight and
                # before its compute is dispatched
                self._note(f"pack:{i + 1}")
                nxt = self._pack_image_batch(images[spans[i + 1] : spans[i + 1] + step])
            self._note(f"dispatch:{i}")
            emb = fwd(flat_dev)
            self._ring.retire([flat_dev])  # the slot is reusable once the tower has read it
            pending.append((n, emb))
        return pending

    def encode_image(self, images: np.ndarray) -> np.ndarray:
        """images: [n, H, W, 3] float in [0, 1] or uint8 in [0, 255] (the
        host resizes and crops) -> [n, dim] f32 numpy."""
        pending = self._image_batches(images)
        if not pending:
            return np.zeros((0, self.dim), np.float32)
        out = []
        for i, (n, emb) in enumerate(pending):
            out.append(emb[:n].cpu().numpy())
            self._note(f"complete:{i}")
        return np.concatenate(out)

    def encode_image_device(self, images: np.ndarray) -> torch.Tensor:
        """images -> [n, dim] f32 embeddings on the device: they feed the
        device index without a host bounce, as
        ``SentenceEncoder.encode_device`` does."""
        pending = self._image_batches(images)
        if not pending:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        return torch.cat([emb[:n] for n, emb in pending])

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """texts -> [n, dim] f32 numpy: hashed word pieces padded to the
        context length; a padding row attends to its first position."""
        L = self.cfg.context_length
        out = np.empty((len(texts), self.dim), np.float32)
        for group in chunks(list(range(len(texts))), self.max_batch):
            ids = np.zeros((len(group), L), np.int64)
            mask = np.zeros((len(group), L), bool)
            for j, i in enumerate(group):
                toks = self.tokenizer.encode(texts[i] or "", L)
                ids[j, : len(toks)] = toks
                mask[j, : len(toks)] = True
            B = bucket(len(group), self._BATCH_BUCKETS)
            if B > len(group):
                ids = np.concatenate([ids, np.zeros((B - len(group), L), np.int64)])
                mask = np.concatenate([mask, np.zeros((B - len(group), L), bool)])
                mask[len(group) :, 0] = True
            emb = self._tfwd(torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))
            out[np.asarray(group)] = emb[: len(group)].cpu().numpy()
        return out
