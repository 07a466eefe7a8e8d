"""SentenceEncoder: batched text -> L2-normalised embeddings [n, hidden].

Port of ``pathway_tpu/models/sentence_encoder.py::SentenceEncoder``
(single device). Host side, unchanged from the reference: tokenize, sort
rows by length, split into groups, pad each group to its own seq bucket,
ship ids as int16 while ``vocab_size < 32768``. Device side: every group
runs ``ops/fused_layer.encoder_forward`` (kernel B1 on CUDA: three
hand-written kernels per layer) with the key mask built on the device from
the lengths; ``encode_tokens`` runs the ``TextEncoder`` module, whose
attention is kernel B3.

The reference's donated device ring for the id/length uploads becomes a
pinned host tensor and a ``non_blocking`` copy. Sequence packing
(``_pack_segments``, kernel B4) and the mesh path come with later slices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fused_layer import encoder_forward, prepare_params, use_fused_encoder
from .batching import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    bucket,
    chunks,
    pad_token_batch,
)
from .encoder import EncoderConfig, TextEncoder, init_params
from .tokenizer import default_tokenizer


class SentenceEncoder:
    """Batched text -> L2-normalised embeddings [n, hidden]."""

    def __init__(
        self,
        model: str = "all-MiniLM-L6-v2",
        *,
        config: EncoderConfig | None = None,
        checkpoint_dir: str | None = None,
        max_seq_len: int = 256,
        max_batch: int = 1024,
        seed: int = 0,
        device=None,
        params: dict | None = None,
    ):
        """``params``: a TextEncoder state dict (e.g. from
        ``weights.from_jax_params``); default: ``init_params(config, seed)``.
        ``checkpoint_dir`` supplies ``vocab.txt`` for the tokenizer."""
        if config is None:
            config = EncoderConfig.minilm_l12() if "l12" in model.lower() else EncoderConfig.minilm_l6()
        self.device = resolve_device(device)
        self.cfg = config
        self.model_name = model
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        self.module = TextEncoder(config)
        self.module.load_state_dict(params if params is not None else init_params(config, seed))
        self.module.to(self.device).eval()
        # the whole-layer path's weights, cast once (biases stay f32 there)
        self.params = prepare_params(self.module.state_dict(), config)
        self.module.cast_for_inference()
        self.tokenizer = default_tokenizer(checkpoint_dir)

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

    def _wire(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on CUDA through a pinned buffer
        and a non_blocking copy, so the upload overlaps device work."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _run_padded(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return self.module(self._wire(ids), self._wire(mask))

    def encode_tokens(self, toks: Sequence[list[int]]) -> np.ndarray:
        """Embed pre-tokenized sequences through the TextEncoder module."""
        if not len(toks):
            return np.zeros((0, self.dim), np.float32)
        order = sorted(range(len(toks)), key=lambda i: len(toks[i]))
        pending = []
        for group in chunks(order, self.max_batch):
            ids, mask, _, n = pad_token_batch(
                [toks[i] for i in group], pad_id=self.tokenizer.pad_id, max_batch=self.max_batch
            )
            pending.append((group, n, self._run_padded(ids, mask)))
        out = np.empty((len(toks), self.dim), np.float32)
        for group, n, emb in pending:
            out[np.asarray(group)] = emb[:n].float().cpu().numpy()
        return out

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        texts = ["" if t is None else str(t) for t in texts]
        return self._encode_matrix(*self._tokenize_matrix(texts))

    def _tokenize_matrix(self, texts):
        return self.tokenizer.batch_encode_matrix(texts, self.max_seq_len)

    def _matrix_groups(self, ids_mat: np.ndarray, lens: np.ndarray):
        """Bucketed dispatch straight from the tokenizer's padded ids
        matrix. Returns [(group_indices, n_real, device_embeddings)]."""
        n = len(lens)
        order = np.argsort(lens, kind="stable")  # dense length buckets
        batch = self.max_batch
        pending = []
        for start in range(0, n, batch):
            group = order[start : start + batch]
            L = min(bucket(int(lens[group].max()), DEFAULT_SEQ_BUCKETS), ids_mat.shape[1])
            ng = len(group)
            ids = np.take(ids_mat[:, :L], group, axis=0)
            if ng < batch:
                bb = tuple(b for b in DEFAULT_BATCH_BUCKETS if b < batch) + (batch,)
                B = max(bucket(ng, bb), ng)
                if B > ng:
                    ids = np.pad(ids, ((0, B - ng), (0, 0)))
            ln = np.zeros((ids.shape[0],), np.int32)
            ln[:ng] = lens[group]
            pending.append((group, ng, self._run_group(ids, ln)))
        return pending

    def _run_group(self, ids: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """The one group forward: (B, L) ids + lengths, mask built on the
        device. Shared by _matrix_groups and _pack_uniform."""
        wire = np.int16 if self.cfg.vocab_size < 32768 else np.int32
        ids_dev = self._wire(ids.astype(wire, copy=False))
        lens_dev = self._wire(lens.astype(np.int32, copy=False))
        with torch.no_grad():
            mask = torch.arange(ids_dev.shape[1], device=self.device)[None, :] < lens_dev[:, None]
            ids32 = ids_dev.to(torch.int32)
            if use_fused_encoder(self.cfg, ids_dev.shape[1]):
                return encoder_forward(self.params, self.cfg, ids32, mask, lens=lens_dev)
            return self.module(ids32, mask)

    def _encode_matrix(self, ids_mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
        out = np.empty((len(lens), self.dim), np.float32)
        for group, ng, emb in self._matrix_groups(ids_mat, lens):
            out[group] = emb[:ng].float().cpu().numpy()
        return out

    def encode_device(self, texts: Sequence[str], pad_to: int | None = None) -> torch.Tensor:
        """texts -> embeddings as a device-resident [n, dim] f32 tensor in
        input order (``pad_to``: [pad_to, dim], extra rows zero), for the
        device KNN index: the embeddings never visit the host."""
        if not len(texts):
            return torch.zeros((pad_to or 0, self.dim), dtype=torch.float32, device=self.device)
        texts = ["" if t is None else str(t) for t in texts]
        if pad_to is None and len(texts) >= 4 * self.max_batch:
            # split large batches in half: the first half's device work
            # runs while the second half tokenizes on the host
            mid = (len(texts) // 2 // self.max_batch) * self.max_batch
            if mid and len(texts) - mid >= 2 * self.max_batch:
                first = self.encode_device(texts[:mid])
                second = self.encode_device(texts[mid:])
                return torch.cat([first, second], dim=0)
        return self._dispatch_tokenized(texts, self._tokenize_matrix(texts), pad_to)

    def encode_device_many(self, batches, pad_to: int | None = None) -> list:
        """Staged multi-batch dispatch: batch i+1 tokenizes on the host while
        batch i's device work is in flight. One device tensor per batch."""
        batches = [["" if t is None else str(t) for t in b] for b in batches]
        if len(batches) < 2:
            return [self.encode_device(b, pad_to=pad_to) for b in batches]
        prepared = self._tokenize_matrix(batches[0])
        out = []
        for i, texts in enumerate(batches):
            m = prepared
            out.append(self._dispatch_tokenized(texts, m, pad_to))
            if i + 1 < len(batches):
                prepared = self._tokenize_matrix(batches[i + 1])
        return out

    def _dispatch_tokenized(self, texts, m, pad_to: int | None = None) -> torch.Tensor:
        """Device tail of :meth:`encode_device`. The reference tries its
        segment packer (``_pack_segments``) first and takes these paths when
        it declines; the packer comes with a later slice, so this goes
        straight to ``_pack_uniform`` and then ``_matrix_groups``."""
        ids_mat, lens = m
        n_out = pad_to or len(lens)
        packed = self._pack_uniform(ids_mat, lens)
        if packed is None:
            pending = self._matrix_groups(ids_mat, lens)
            embs = torch.cat([emb[:ng] for _, ng, emb in pending], dim=0)
            order = np.concatenate([group for group, _, _ in pending])
        else:
            order, embs = packed
        out = torch.zeros((n_out, self.dim), dtype=torch.float32, device=self.device)
        keep = order < n_out
        rows = torch.as_tensor(order[keep], dtype=torch.long, device=self.device)
        src = embs if keep.all() else embs[torch.as_tensor(np.nonzero(keep)[0], device=self.device)]
        out[rows] = src.float()
        return out

    def _pack_uniform(self, ids_mat: np.ndarray, lens: np.ndarray):
        """Length-sorted fast path: rows sort by length once and split into
        max_batch groups, each padded to its own seq bucket; the groups
        dispatch back to back and stay on the device."""
        if self.cfg.vocab_size >= 32768:
            return None
        n = len(lens)
        B = self.max_batch
        if n < 2 * B or n % B:
            return None
        order = np.argsort(lens, kind="stable")
        G = n // B
        ln = lens[order].reshape(G, B).astype(np.int32)
        parts = []
        for g in range(G):
            grp = order[g * B : (g + 1) * B]
            # sorted ascending, so the group's last row holds its max
            Lg = min(bucket(int(ln[g, -1]), DEFAULT_SEQ_BUCKETS), ids_mat.shape[1])
            ids_g = np.take(ids_mat[:, :Lg], grp, axis=0).astype(np.int16)
            parts.append(self._run_group(ids_g, ln[g]))
        return order, torch.cat(parts, dim=0)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
