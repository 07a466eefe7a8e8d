"""SentenceEncoder: batched text -> L2-normalised embeddings [n, hidden].

Port of ``pathway_tpu/models/sentence_encoder.py::SentenceEncoder``
(single device). Host side, unchanged from the reference: tokenize, sort
rows by length, split into groups, pad each group to its own seq bucket,
ship ids as int16 while ``vocab_size < 32768``. Device side: every group
runs ``ops/fused_layer.encoder_forward`` (kernel B1 on CUDA: three
hand-written kernels per layer) with the key mask built on the device from
the lengths; ``encode_tokens`` runs the ``TextEncoder`` module, whose
attention is kernel B3.

Sequence packing (``_pack_segments``): when a batch is long-tailed enough
that bucketed padding would waste most of the tokens, chunks are packed
back to back into 512-token rows with per-chunk positions and segment ids,
run through the ``TextEncoder`` module (kernel B4 for attention) and
mean-pooled per segment; ``_dispatch_tokenized`` tries it first, as the
reference does. ``CrossEncoderScorer`` scores (query, doc) text pairs
through ``CrossEncoderHead`` (kernel B3).

The reference's donated device ring for the id/length uploads becomes a
pinned host tensor and a ``non_blocking`` copy.

Data-parallel embedding (``mesh=``, a ``parallel.sharding.DeviceMesh`` or a
spec): one copy of the module's parameters on each data device, all made
from the same state dict. Rows are padded to a multiple of the data axis and
split contiguously over the data devices, as ``P("data")`` splits them, and
run the module path (``TextEncoder``, attention B3) as the reference's mesh
path does, not the whole-layer path; every device's launches are issued
before any result is read, and the embeddings are gathered on the first
data device. Batches round down to a multiple of the data axis; the
packers step aside. The reference replicates over the mesh's ``model``
axis, which changes no answer; the port uses ``devices[s][0]``.

With the chip ledger on, every encoder forward (grouped, packed or the
module path; on a mesh one booking over its cards) books its device time
under ``encode``; both models report their weights to the HBM ledger.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..device import as_current, resolve_device
from ..internals.chip_ledger import CHIP_LEDGER
from ..internals.profiler import ENCODER_KERNEL_STATS, wrap_jit
from ..ops.fused_layer import encoder_flops, encoder_forward, prepare_params, use_fused_encoder
from ..parallel.mesh import resolve_mesh
from ..weights import load_hf_weights
from .batching import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    bucket,
    chunks,
    effective_max_batch,
    pad_token_batch,
)
from .encoder import CrossEncoderHead, EncoderConfig, TextEncoder, init_cross_encoder_params, init_params
from .tokenizer import default_tokenizer


def _init_or_checkpoint(init: dict, checkpoint_dir: str | None) -> dict:
    """``init`` with a local HF checkpoint's weights laid over it, as the
    reference's constructors load one: a directory without a checkpoint, or
    one that lacks a name, leaves ``init`` as it is."""
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        try:
            return load_hf_weights(init, checkpoint_dir)
        except (FileNotFoundError, KeyError):
            pass
    return init


def shelf_pack(lens: np.ndarray, row_len: int, max_segs: int):
    """Shelf packing of chunks into rows, in descending length order (the
    same as first-fit here, since lengths only shrink): a chunk opens a new
    row when it would overflow ``row_len`` tokens or ``max_segs`` chunks.
    Returns (chunk order, their lengths, and the row, token offset and slot
    in its row of each, all in that order)."""
    n = len(lens)
    order = np.argsort(lens, kind="stable")[::-1].astype(np.int64)
    lns = lens[order].astype(np.int64)
    row_of = np.empty(n, np.int64)
    off_of = np.empty(n, np.int64)
    slot_of = np.empty(n, np.int64)
    r = off = s_i = 0
    for j in range(n):
        ln = int(lns[j])
        if off + ln > row_len or s_i == max_segs:
            r += 1
            off = 0
            s_i = 0
        row_of[j] = r
        off_of[j] = off
        slot_of[j] = s_i
        off += ln
        s_i += 1
    return order, lns, row_of, off_of, slot_of


def _record_dispatch(cfg, rows: int, seq: int, real_tokens: int, attn_pairs: int) -> None:
    """One encoder dispatch's geometry for the encode MFU and pad-waste
    statistics (``internals/profiler.ENCODER_KERNEL_STATS``)."""
    computed = rows * seq
    ENCODER_KERNEL_STATS.record_dispatch(
        seq=seq, batch=rows, real_tokens=real_tokens, computed_tokens=computed,
        flops=encoder_flops(cfg, computed, attn_pairs),
    )


def _book_weights(owner: str, module) -> None:
    """Report a model's weights to the HBM ledger's ``weights`` account."""
    from ..internals.ledger import LEDGER, pytree_nbytes

    LEDGER.update("weights", owner, pytree_nbytes(list(module.parameters())))


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
        mesh=None,
    ):
        """``params``: a TextEncoder state dict (e.g. from
        ``weights.from_jax_params``); without it, ``init_params(config,
        seed)`` overlaid with a local HF checkpoint in ``checkpoint_dir`` (or
        ``PATHWAY_TPU_CKPT``) when it holds one. That directory also
        supplies ``vocab.txt`` for the tokenizer. ``mesh``: embed
        data-parallel over its data devices (a spec resolves on the cards,
        or on the CPU with ``device="cpu"``); ``self.device`` is then the
        first data device."""
        if config is None:
            config = EncoderConfig.minilm_l12() if "l12" in model.lower() else EncoderConfig.minilm_l6()
        self.mesh = resolve_mesh(mesh, device=device)
        self._data_devices = [resolve_device(d) for d in (self.mesh.data_devices() if self.mesh else [device])]
        self.device = self._data_devices[0]
        self.cfg = config
        self.model_name = model
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        self.module = TextEncoder(config)
        checkpoint_dir = checkpoint_dir or os.environ.get("PATHWAY_TPU_CKPT")
        self.module.load_state_dict(params if params is not None else _init_or_checkpoint(
            init_params(config, seed), checkpoint_dir))
        self.module.to(self.device).eval()
        # the whole-layer path's weights, cast once (biases stay f32 there)
        self.params = prepare_params(self.module.state_dict(), config)
        self.module.cast_for_inference()
        # one module a data device, each made from the same state dict and
        # cast as the first one is
        self._replicas = {self.device: self.module}
        for dev in self._data_devices[1:]:
            if dev not in self._replicas:
                replica = TextEncoder(config).cast_for_inference()
                replica.load_state_dict(self.module.state_dict())
                self._replicas[dev] = replica.to(dev).eval()
        self.tokenizer = default_tokenizer(checkpoint_dir)
        _book_weights(f"encoder:{model}", self.module)
        # the run profiler's build / execute split of each forward
        self._run_group = wrap_jit("sentence_encoder.fwd_group", self._run_group)
        self._run_packed = wrap_jit("sentence_encoder.fwd_packed", self._run_packed)
        self._run_padded = wrap_jit("sentence_encoder.fwd", self._run_padded)
        self._geometries: set[tuple[int, int]] = set()  # (rows, seq) of every _run_padded dispatch

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

    def dispatch_geometry_count(self) -> int:
        """Distinct (rows, seq) geometries ``_run_padded`` has dispatched —
        the port's counterpart of the reference's ``jit_cache_size`` (the
        forward jit's cache entries): the ground truth the deep verifier's
        predictor (``models.batching.predict_compile_keys`` / PWL018) is
        held to in the bucket-sweep test."""
        return len(self._geometries)

    def predict_compile_keys(self, lengths) -> set[tuple[int, int]]:
        """The (rows, seq) geometries ``encode_tokens`` would dispatch for a
        workload of token ``lengths`` at this encoder's geometry."""
        from .batching import predict_compile_keys

        return predict_compile_keys(lengths, max_batch=self.max_batch, mesh_ndata=len(self._data_devices))

    def _wire(self, arr: np.ndarray, device: torch.device | None = None) -> torch.Tensor:
        """Host array -> device tensor; on CUDA through a pinned buffer
        and a non_blocking copy, so the upload overlaps device work."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def _run_padded(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """The module path over (B, L) ids and their mask. On a mesh the rows
        pad to a multiple of the data axis and split contiguously over the
        data devices; every device's forward is issued before any is read,
        and the embeddings gather on the first data device."""
        self._geometries.add(tuple(ids.shape))
        if self.mesh is None:
            with torch.no_grad(), CHIP_LEDGER.timed("encode", device=self.device):
                return self.module(self._wire(ids), self._wire(mask))
        n = len(self._data_devices)
        pad = (-ids.shape[0]) % n
        if pad:
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), bool)])
        per = ids.shape[0] // n
        outs = []
        with torch.no_grad(), CHIP_LEDGER.timed("encode", device=self._data_devices):
            for s, dev in enumerate(self._data_devices):
                rows = slice(s * per, (s + 1) * per)
                with as_current(dev):
                    outs.append(self._replicas[dev](self._wire(ids[rows], dev), self._wire(mask[rows], dev)))
        return torch.cat([o.to(self.device) for o in outs], dim=0)

    def encode_tokens(self, toks: Sequence[list[int]]) -> np.ndarray:
        """Embed pre-tokenized sequences through the TextEncoder module."""
        if not len(toks):
            return np.zeros((0, self.dim), np.float32)
        order = sorted(range(len(toks)), key=lambda i: len(toks[i]))
        batch = effective_max_batch(self.max_batch, len(self._data_devices))
        pending = []
        for group in chunks(order, batch):
            ids, mask, _, n = pad_token_batch(
                [toks[i] for i in group], pad_id=self.tokenizer.pad_id, max_batch=batch
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
        """Tokenize through the host-ingest stage when one is configured
        (``PATHWAY_INGEST_WORKERS`` / ``pw.run(ingest_workers=)``), else
        inline. The values are the same either way: the stage runs the
        native tokenizer's GIL-free shard calls on its workers and records
        the short / long split of the rows for the sequence buckets."""
        from ..ingest import stage as ingest_stage

        st = ingest_stage.get_stage()
        m = self.tokenizer.batch_encode_matrix(texts, self.max_seq_len, stage=st)
        if st is not None:
            from .batching import DEFAULT_SEQ_BUCKETS, bucket

            # short = fits the sequence bucket at half this encoder's window
            threshold = bucket(max(1, self.max_seq_len // 2), DEFAULT_SEQ_BUCKETS)
            ingest_stage.route_by_length(m[1].tolist(), threshold)
        return m

    def _matrix_groups(self, ids_mat: np.ndarray, lens: np.ndarray):
        """Bucketed dispatch straight from the tokenizer's padded ids
        matrix. Returns [(group_indices, n_real, device_embeddings)]."""
        n = len(lens)
        order = np.argsort(lens, kind="stable")  # dense length buckets
        batch = effective_max_batch(self.max_batch, len(self._data_devices))
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
            if self.mesh is None:
                pending.append((group, ng, self._run_group(ids, ln)))
            else:  # the reference's mesh path: the module over a host-built mask
                mask = np.arange(ids.shape[1])[None, :] < ln[:, None]
                pending.append((group, ng, self._run_padded(ids, mask)))
        return pending

    def _run_group(self, ids: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """The one group forward: (B, L) ids + lengths, mask built on the
        device. Shared by _matrix_groups and _pack_uniform."""
        wire = np.int16 if self.cfg.vocab_size < 32768 else np.int32
        ids_dev = self._wire(ids.astype(wire, copy=False))
        lens_dev = self._wire(lens.astype(np.int32, copy=False))
        with torch.no_grad(), CHIP_LEDGER.timed("encode", device=self.device):
            mask = torch.arange(ids_dev.shape[1], device=self.device)[None, :] < lens_dev[:, None]
            ids32 = ids_dev.to(torch.int32)
            if use_fused_encoder(self.cfg, ids_dev.shape[1]):
                out = encoder_forward(self.params, self.cfg, ids32, mask, lens=lens_dev)
            else:
                out = self.module(ids32, mask)
        rows, seq = ids.shape
        # every row of the dispatch is computed (the GEMMs run them all),
        # attention over every (query, key) pair of a row
        _record_dispatch(self.cfg, rows, seq, int(lens.sum()), rows * seq * seq)
        return out

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
        """Device tail of :meth:`encode_device`: the segment packer first,
        then ``_pack_uniform``, then ``_matrix_groups``, as the reference
        tries them."""
        ids_mat, lens = m
        n_out = pad_to or len(lens)
        packed = self._pack_segments(ids_mat, lens)
        if packed is None:
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

    #: packed-row geometry: chunks concatenate back to back into rows of
    #: PACK_L tokens, at most PACK_SEGS chunks per row; at most PACK_ROWS
    #: rows per forward
    PACK_L = 512
    PACK_SEGS = 8
    PACK_ROWS = 1024

    def _pack_segments(self, ids_mat: np.ndarray, lens: np.ndarray):
        """SEQUENCE PACKING: concatenate chunks back to back into PACK_L-token
        rows with per-chunk positions and segment ids (attention stays
        inside a segment: kernel B4), and mean-pool per segment on the
        device. Returns (slot -> chunk map, [R * PACK_SEGS, dim] embeddings)
        or None when packing would not pay; the engage and decline rules and
        the shelf packing are the reference's. The R real rows run in groups
        of at most PACK_ROWS (the reference pads to a multiple of PACK_ROWS
        for its fixed scan shape). Pooling is a segment sum with
        ``index_add_`` in f32."""
        if self.mesh is not None or self.cfg.vocab_size >= 32768:
            return None
        if not self.cfg.normalize or self.cfg.pooling != "mean":
            return None  # packed pooling bakes mean + normalize in
        n = len(lens)
        L, SEGS, ROWS = self.PACK_L, self.PACK_SEGS, self.PACK_ROWS
        if self.cfg.max_position < L:
            return None
        if int(lens.max()) > L:
            return None  # a chunk longer than a row would overflow it
        # short chunks would need many segments per row; the bucketed paths
        # handle those with bounded pad waste
        if n < 512 or float(lens.mean()) < L / SEGS:
            return None
        # engage only when the bucketed paths would spend over 55 % of their
        # tokens on padding
        sorted_lens = np.sort(lens)
        B = self.max_batch
        bucketed_tokens = sum(
            len(g) * bucket(int(g[-1]), DEFAULT_SEQ_BUCKETS)
            for g in (sorted_lens[i : i + B] for i in range(0, n, B))
        )
        if float(lens.sum()) / max(bucketed_tokens, 1) > 0.45:
            return None
        order, lns, row_of, off_of, slot_of = shelf_pack(lens, L, SEGS)
        R = int(row_of[-1]) + 1
        ids = np.zeros((R * L,), np.int16)
        pos = np.zeros((R * L,), np.int16)
        seg = np.full((R * L,), -1, np.int32)
        # slot (row, seg_in_row) -> chunk index; empty slots point one past
        # the real chunks, so the final scatter drops them
        slot_to_chunk = np.full((R * SEGS,), n, np.int64)
        counts = np.zeros((R * SEGS,), np.float32)
        slot_index = row_of * SEGS + slot_of
        slot_to_chunk[slot_index] = order
        counts[slot_index] = lns
        total = int(lns.sum())
        within = np.arange(total) - np.repeat(np.cumsum(lns) - lns, lns)
        flat_pos = np.repeat(row_of * L + off_of, lns) + within
        ids[flat_pos] = ids_mat[np.repeat(order, lns), within]
        pos[flat_pos] = within.astype(np.int16)
        seg[flat_pos] = np.repeat(slot_index, lns).astype(np.int32)
        ids, pos, seg = ids.reshape(R, L), pos.reshape(R, L), seg.reshape(R, L)
        embs = torch.empty((R * SEGS, self.dim), dtype=torch.float32, device=self.device)
        for r0 in range(0, R, ROWS):
            r1 = min(R, r0 + ROWS)
            local = np.where(seg[r0:r1] >= 0, seg[r0:r1] - r0 * SEGS, -1).astype(np.int32)
            embs[r0 * SEGS : r1 * SEGS] = self._run_packed(ids[r0:r1], pos[r0:r1], local, counts[r0 * SEGS : r1 * SEGS])
        return slot_to_chunk, embs

    def _run_packed(self, ids: np.ndarray, pos: np.ndarray, seg: np.ndarray, counts: np.ndarray) -> torch.Tensor:
        """One packed forward over [rows, PACK_L] (segment ids local to these
        rows) -> per-slot embeddings [rows * PACK_SEGS, dim], mean-pooled and
        L2-normalised; empty slots give zeros."""
        slots = counts.shape[0]
        ids_d, pos_d, seg_d, counts_d = (self._wire(a) for a in (ids, pos, seg, counts))
        with torch.no_grad(), CHIP_LEDGER.timed("encode", device=self.device):
            toks = self.module(ids_d, seg_d >= 0, position_ids=pos_d, segment_ids=seg_d)
            # padding tokens sum into one extra row, dropped below
            dest = torch.where(seg_d >= 0, seg_d, slots).reshape(-1).long()
            sums = torch.zeros((slots + 1, self.dim), dtype=torch.float32, device=self.device)
            sums.index_add_(0, dest, toks.reshape(-1, self.dim).float())
            pooled = sums[:slots] / torch.clamp(counts_d, min=1.0)[:, None]
            out = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
        # the GEMMs compute every packed position, B4 attends within segments
        real = np.asarray(counts, np.int64)
        _record_dispatch(self.cfg, ids.shape[0], ids.shape[1], int(real.sum()), int((real * real).sum()))
        return out

    def _pack_uniform(self, ids_mat: np.ndarray, lens: np.ndarray):
        """Length-sorted fast path: rows sort by length once and split into
        max_batch groups, each padded to its own seq bucket; the groups
        dispatch back to back and stay on the device."""
        if self.mesh is not None or self.cfg.vocab_size >= 32768:
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


class CrossEncoderScorer:
    """Batched (query, doc) text pairs -> relevance scores [n], through
    ``CrossEncoderHead`` (cross_encoder_l6 geometry: CLS pooling, no
    normalisation); its attention is kernel B3 on CUDA tensors."""

    def __init__(
        self,
        model: str = "ms-marco-MiniLM-L-6-v2",
        *,
        config: EncoderConfig | None = None,
        checkpoint_dir: str | None = None,
        max_seq_len: int = 256,
        max_batch: int = 256,
        seed: int = 0,
        device=None,
        params: dict | None = None,
    ):
        """``params``: a CrossEncoderHead state dict (e.g. from
        ``weights.from_jax_cross_encoder_params``); without it,
        ``init_cross_encoder_params(config, seed)`` overlaid with a local HF
        checkpoint in ``checkpoint_dir`` (or ``PATHWAY_TPU_XENC_CKPT``) when
        it holds one. That directory also supplies ``vocab.txt`` for the
        tokenizer."""
        self.device = resolve_device(device)
        self.cfg = config or EncoderConfig.cross_encoder_l6()
        self.model_name = model
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        self.module = CrossEncoderHead(self.cfg)
        checkpoint_dir = checkpoint_dir or os.environ.get("PATHWAY_TPU_XENC_CKPT")
        self.module.load_state_dict(params if params is not None else _init_or_checkpoint(
            init_cross_encoder_params(self.cfg, seed), checkpoint_dir))
        self.module.to(self.device).eval()
        self.module.cast_for_inference()
        self.tokenizer = default_tokenizer(checkpoint_dir)
        _book_weights(f"reranker:{model}", self.module)

    def score(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        if not len(pairs):
            return np.zeros((0,), np.float32)
        enc = [self.tokenizer.encode_pair(a or "", b or "", self.max_seq_len) for a, b in pairs]
        toks = [e[0] for e in enc]
        tts = [e[1] for e in enc]
        order = sorted(range(len(toks)), key=lambda i: len(toks[i]))
        pending = []
        for group in chunks(order, self.max_batch):
            ids, mask, tt, n = pad_token_batch(
                [toks[i] for i in group],
                pad_id=self.tokenizer.pad_id,
                max_batch=self.max_batch,
                token_type_lists=[tts[i] for i in group],
            )
            with torch.no_grad():
                scores = self.module(*(torch.from_numpy(a).to(self.device) for a in (ids, mask, tt)))
            pending.append((group, n, scores))
        out = np.empty((len(toks),), np.float32)
        for group, n, scores in pending:
            out[np.asarray(group)] = scores[:n].cpu().numpy()
        return out

    def __call__(self, pairs):
        return self.score(pairs)
