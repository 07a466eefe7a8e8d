"""The adaptive-RAG query pipeline, with no host round trip between stages.

Port of ``pathway_tpu/ops/fused_rag.py::FusedRagPipeline``. The JAX
package runs a query batch as one jit; here it is a chain of launches on
the card that never waits for the host in between:

  query ids up -> query embed (``TextEncoder`` module, kernel B3) -> score
  against the device-resident doc matrix -> retrieve top-k -> gather the
  candidates' doc TOKENS from a device-resident store -> build the
  cross-encoder pairs -> cross-encoder forward (B3) -> final top-k ->
  (slots, scores) down

and ``answer_batch`` splices the query and its top document's tokens into
a prompt and runs ``decode.engine.decode_greedy`` on the card, so only the
generated tokens come down besides. What decides results is the
reference's: ``min(_k_bucket(k_retrieve), capacity)`` candidates are
reranked; the l2 score is ``2 q.m - |m|^2 - 1``; retrieval misses score
``_NEG`` and stay dead after reranking; ties go to the lower index
(``_topk_lower_index``); the token-type and pair-mask rules; the answer
prompt ``q ids ++ top doc tokens`` cut to ``max_position - max_new``, a
query with no hit generating from the query alone. Query rows are not
padded to a k-bucket (that shape exists for XLA's compile cache only).
With the chip ledger on, a query batch's chain books its device time under
the composite ``rag.fused`` account (the reference books its one fused
call there). While the freshness plane is live, every ``answer_batch`` row
carries ``freshness_ms``, the retrieval's staleness bound.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..freshness.plane import FRESHNESS
from ..internals.chip_ledger import CHIP_LEDGER
from ..models.batching import DEFAULT_SEQ_BUCKETS, bucket
from .knn import DeviceKnnIndex, _k_bucket, _topk_lower_index

_NEG = -3.0e38

#: cross-encoder pairs per forward: bounds the activations of a large batch
_PAIR_CHUNK = 4096


def _splice(head: torch.Tensor, head_lens: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """``head`` [..., Lq] with ``tail`` [..., Ld] written over it from each
    row's ``head_lens`` on -> [..., Lq + Ld] (zeros past ``head``), as
    ``lax.dynamic_update_slice`` at ``head_lens`` does."""
    lq, ld = head.shape[-1], tail.shape[-1]
    out = torch.cat([head, head.new_zeros(head.shape[:-1] + (ld,))], dim=-1)
    rel = torch.arange(lq + ld, device=head.device) - head_lens.unsqueeze(-1)
    from_tail = (rel >= 0) & (rel < ld)
    picked = tail.gather(-1, rel.clamp(0, ld - 1).expand(out.shape))
    return torch.where(from_tail, picked, out)


class FusedRagPipeline:
    """Docs in, answers out, no host round trip inside a query batch.

    ``encoder``: a SentenceEncoder. ``cross``: a CrossEncoderScorer (or a
    DeviceReranker, whose scorer is taken), or None to skip reranking.
    The index, the token store and the decoder live on the encoder's
    device."""

    def __init__(
        self,
        encoder,
        cross=None,
        *,
        metric: str = "cos",
        reserved_space: int = 1024,
        doc_seq_len: int = 128,
        decoder=None,
    ):
        self.enc = encoder
        self.device = encoder.device
        if cross is not None and not hasattr(cross, "module"):
            scorer = getattr(cross, "scorer", None)
            if scorer is None or not hasattr(scorer, "module"):
                raise TypeError(f"cross must be a CrossEncoderScorer or DeviceReranker, got {type(cross).__name__}")
            cross = scorer
        self.cross = cross
        self.doc_seq = doc_seq_len
        self.index = DeviceKnnIndex(dim=encoder.dim, metric=metric, reserved_space=reserved_space, device=self.device)
        self.texts: dict[Any, str] = {}
        self._pad = encoder.tokenizer.pad_id
        self._tok_host = np.full((self.index.capacity, doc_seq_len), self._pad, np.int32)
        self._len_host = np.zeros((self.index.capacity,), np.int32)
        self._tok_dev: torch.Tensor | None = None
        self._len_dev: torch.Tensor | None = None
        self._tok_full = True
        self._tok_pending: dict[int, tuple[np.ndarray, int]] = {}
        self._dec_params = None
        self._dec_cfg = None
        if decoder is not None:
            self.set_decoder(decoder)

    def set_decoder(self, decoder, *, seed: int = 0) -> None:
        """Attach the generate stage: a ``DecoderConfig`` (weights from
        ``seed``), a ``(params, config)`` tuple, a ``{"params", "config"}``
        dict, a ``DecodeEngine`` (shares its weights), or ``True`` for the
        default geometry."""
        from ..decode.engine import DecoderConfig, init_decoder_params, params_to

        if decoder is True:
            decoder = DecoderConfig()
        if isinstance(decoder, DecoderConfig):
            cfg, params = decoder, init_decoder_params(decoder, seed=seed)
        elif isinstance(decoder, tuple) and len(decoder) == 2:
            params, cfg = decoder
        elif isinstance(decoder, dict):
            cfg = decoder["config"]
            params = decoder.get("params")
            if params is None:
                params = init_decoder_params(cfg, seed=seed)
        elif hasattr(decoder, "params") and hasattr(decoder, "model_cfg"):
            params, cfg = decoder.params, decoder.model_cfg
        else:
            raise TypeError(
                f"decoder: cannot coerce {type(decoder).__name__} "
                "(want DecoderConfig, (params, config), dict, or DecodeEngine)"
            )
        self._dec_cfg = cfg
        self._dec_params = params_to(params, self.device)

    # ---- ingest ----

    def _doc_row(self, text: str) -> tuple[np.ndarray, int]:
        # doc part of a cross-encoder pair: wordpieces + [SEP]
        ids = self.enc.tokenizer.encode(text, self.doc_seq)[1:]  # drop [CLS]
        row = np.full((self.doc_seq,), self._pad, np.int32)
        row[: len(ids)] = ids
        return row, len(ids)

    def add_docs(self, keys: Sequence[Any], texts: Sequence[str]) -> None:
        embs = self.enc.encode_device(list(texts))
        self.index.add_batch_device(list(keys), embs)
        if self.index.capacity != len(self._tok_host):
            grown = np.full((self.index.capacity, self.doc_seq), self._pad, np.int32)
            grown[: len(self._tok_host)] = self._tok_host
            self._tok_host = grown
            self._len_host = np.concatenate(
                [self._len_host, np.zeros((self.index.capacity - len(self._len_host),), np.int32)]
            )
            self._tok_full = True  # the device store re-uploads at the new capacity
        for key, text in zip(keys, texts):
            self.texts[key] = text
            slot = self.index._slot_of[key]
            row, n = self._doc_row(text)
            self._tok_host[slot] = row
            self._len_host[slot] = n
            if not self._tok_full:
                self._tok_pending[slot] = (row, n)

    def remove_docs(self, keys: Sequence[Any]) -> None:
        for key in keys:
            self.index.remove(key)
            self.texts.pop(key, None)
        # token rows of freed slots are dead weight until overwritten

    def __len__(self) -> int:
        return len(self.index)

    # ---- device token store ----

    def _sync_tokens(self) -> None:
        if self._tok_full or self._tok_dev is None:
            self._tok_dev = torch.from_numpy(self._tok_host).to(self.device, copy=True)
            self._len_dev = torch.from_numpy(self._len_host).to(self.device, copy=True)
            self._tok_full = False
            self._tok_pending.clear()
            return
        if not self._tok_pending:
            return
        slots = torch.as_tensor(np.fromiter(self._tok_pending, np.int64), device=self.device)
        rows = np.stack([row for row, _ in self._tok_pending.values()])
        ns = np.array([n for _, n in self._tok_pending.values()], np.int32)
        self._tok_dev[slots] = torch.from_numpy(rows).to(self.device)
        self._len_dev[slots] = torch.from_numpy(ns).to(self.device)
        self._tok_pending.clear()

    # ---- query ----

    def _padded_queries(self, texts: Sequence[str], k_retrieve: int):
        """Tokenize a query batch, sync the device stores -> (ids [n, L],
        lens [n]) on the device and ``kr``."""
        ids_mat, lens = self.enc.tokenizer.batch_encode_matrix(texts, self.enc.max_seq_len)
        self.index._sync()
        self._sync_tokens()
        L = min(bucket(int(lens.max()), DEFAULT_SEQ_BUCKETS), ids_mat.shape[1])
        ids = torch.from_numpy(np.ascontiguousarray(ids_mat[:, :L])).to(self.device)
        kr = min(_k_bucket(k_retrieve), self.index.capacity)
        return ids, torch.from_numpy(lens.astype(np.int64)).to(self.device), kr

    def _cross_scores(self, q_ids, q_lens, ridx) -> torch.Tensor:
        """Cross-encoder scores [nq, kr] of each query against its retrieved
        candidates, pairs built on the device from the token store."""
        d_toks = self._tok_dev[ridx].long()  # [nq, kr, Ld]
        d_lens = self._len_dev[ridx].long()
        nq, kr = ridx.shape
        lq = q_ids.shape[1]
        pair = _splice(q_ids.long()[:, None, :].expand(nq, kr, lq), q_lens[:, None].expand(nq, kr), d_toks)
        pos = torch.arange(pair.shape[-1], device=self.device)[None, None, :]
        tt = (pos >= q_lens[:, None, None]).long().expand_as(pair)
        pmask = pos < (q_lens[:, None] + d_lens)[:, :, None]
        flat = lambda x: x.reshape(nq * kr, -1)  # noqa: E731
        pair, tt, pmask = flat(pair), flat(tt), flat(pmask)
        parts = [
            self.cross.module(pair[i : i + _PAIR_CHUNK], pmask[i : i + _PAIR_CHUNK], tt[i : i + _PAIR_CHUNK])
            for i in range(0, nq * kr, _PAIR_CHUNK)
        ]
        return torch.cat(parts).reshape(nq, kr)

    def _fused(self, q_ids, q_lens, kr: int, kf: int, use_cross: bool = True):
        """encode -> retrieve -> (rerank): (final slots, final scores,
        retrieved slots, retrieval scores), all on the device."""
        with torch.no_grad():
            qmask = torch.arange(q_ids.shape[1], device=self.device)[None, :] < q_lens[:, None]
            emb = self.enc.module(q_ids, qmask)  # [nq, dim], L2-normalised
            matrix = self.index._dev_matrix
            scores = emb @ matrix.T
            if self.index.metric == "l2":
                scores = 2.0 * scores - (matrix * matrix).sum(dim=1)[None, :] - 1.0
            scores = torch.where(self.index._dev_valid[None, :], scores, _NEG)
            rvals, ridx = _topk_lower_index(scores, kr)
            if self.cross is None or not use_cross:
                return ridx, rvals, ridx, rvals
            cs = self._cross_scores(q_ids, q_lens, ridx)
            # only reranked hits that were real retrievals stay alive
            cs = torch.where(rvals > _NEG / 2, cs.float(), _NEG)
            fvals, fidx = _topk_lower_index(cs, kf)
            return ridx.gather(1, fidx), fvals, ridx, rvals

    def _dispatch(self, texts: Sequence[str], k: int, k_retrieve: int):
        """Tokenize and launch the chain; device (slots, scores), not waited for."""
        texts = ["" if t is None else str(t) for t in texts]
        ids, lens, kr = self._padded_queries(texts, k_retrieve)
        # the chain spans embed -> retrieve -> rerank, so it books under the
        # composite ``rag.fused`` account; the booking waits for the card,
        # which costs ``query_async`` its overlap: accounting is opt-in
        with CHIP_LEDGER.timed("rag.fused", device=self.index.device):
            fslots, fvals, _, _ = self._fused(ids, lens, kr, min(k, kr))
        return fslots, fvals

    def _hits(self, slots_row, vals_row, k: int) -> list[tuple[Any, float]]:
        hits: list[tuple[Any, float]] = []
        for slot, val in zip(slots_row, vals_row):
            if val <= _NEG / 2:
                continue
            key = self.index._keys[int(slot)]
            if key is not None:
                hits.append((key, float(val)))
        return hits[:k]

    def query_batch(self, texts: Sequence[str], k: int = 5, k_retrieve: int = 20) -> list[list[tuple[Any, float]]]:
        """Per query a list of (key, score): reranked when a cross-encoder is
        configured, else raw retrieval scores."""
        if not len(texts) or len(self.index) == 0:
            return [[] for _ in texts]
        fslots, fvals = self._dispatch(texts, k, k_retrieve)
        fslots, fvals = fslots.cpu().numpy(), fvals.cpu().numpy()
        return [self._hits(fslots[qi], fvals[qi], k) for qi in range(len(texts))]

    def query(self, text: str, k: int = 5, k_retrieve: int = 20):
        return self.query_batch([text], k, k_retrieve)[0]

    def query_async(self, text: str, k: int = 5, k_retrieve: int = 20):
        """Launch one query and return the device (slots, scores) without
        waiting; ``resolve`` maps them to keys."""
        return self._dispatch([text], k, k_retrieve)

    def resolve(self, fslots, fvals, k: int = 5) -> list[tuple[Any, float]]:
        return self._hits(torch.as_tensor(fslots)[0].cpu().numpy(), torch.as_tensor(fvals)[0].cpu().numpy(), k)

    def answer_batch(
        self,
        texts: Sequence[str],
        k: int = 5,
        k_retrieve: int = 20,
        max_new: int = 16,
        rerank: bool = True,
    ) -> list[dict[str, Any]]:
        """Per query a dict with ``hits`` (as :meth:`query_batch`) and
        ``tokens`` (``max_new`` greedy tokens from the decoder, given the
        query and its top hit). ``rerank=False`` skips the cross-encoder
        (candidates keep retrieval order) but still generates."""
        from ..decode.engine import decode_greedy

        if self._dec_params is None:
            raise RuntimeError("fused RAG answer path needs a decoder (pass decoder= or call set_decoder)")
        texts = ["" if t is None else str(t) for t in texts]
        if not len(texts):
            return []
        max_new = int(max_new)
        dec_max_prompt = self._dec_cfg.max_position - max_new
        if dec_max_prompt < 1:
            raise ValueError(
                f"answer: max_new={max_new} leaves no prompt room in max_position={self._dec_cfg.max_position}"
            )
        ids, lens, kr = self._padded_queries(texts, k_retrieve)
        with torch.no_grad():
            fslots, fvals, _, _ = self._fused(ids, lens, kr, min(k, kr), use_cross=rerank)
            top = fslots[:, 0]
            buf = _splice(ids.long(), lens, self._tok_dev[top].long())
            lp = min(buf.shape[1], dec_max_prompt)
            has_hit = fvals[:, 0] > _NEG / 2
            plen = torch.where(has_hit, lens + self._len_dev[top].long(), lens).clamp(1, lp)
            gen = decode_greedy(self._dec_params, self._dec_cfg, buf[:, :lp], plen, max_new)
        fslots, fvals, gen = fslots.cpu().numpy(), fvals.cpu().numpy(), gen.cpu().numpy()
        # generated answers inherit the retrieval staleness bound (the key is
        # present only while the freshness plane is live, so plane-off
        # outputs are unchanged)
        bound = FRESHNESS.observe_answer(self.index) if FRESHNESS.active() else None
        out = []
        for qi in range(len(texts)):
            row: dict[str, Any] = {"hits": self._hits(fslots[qi], fvals[qi], k), "tokens": [int(t) for t in gen[qi]]}
            if bound is not None:
                row["freshness_ms"] = round(bound["staleness_ms"], 3)
            out.append(row)
        return out

    def answer(self, text: str, **kw) -> dict[str, Any]:
        return self.answer_batch([text], **kw)[0]
