"""Continuous-batching generative decoder over the paged-KV pool.

Port of ``pathway_tpu/decode/engine.py``: the decoder's model math
(``DecoderConfig``, ``init_decoder_params``, prefill, step and
``decode_greedy``) and the greedy ``DecodeEngine`` with its whole-prompt
scheduler. One engine owns a :class:`~pathway_tpu_torch.ops.paged_attention.PagedKvPool`
and a fixed set of lanes; prefills admit into free lanes as queries
arrive, and every ``step`` runs one decode step for all live lanes, whose
attention is kernel B5 (``paged_decode_attention``) on a CUDA pool.

Batching is invisible: the step always runs at the full lane width, so
every matrix product sees one shape, and all math is per row; a stream
decodes to the same tokens alone or among others. Everything is f32; the
caller turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default) so the card's f32 products are full f32.

Where the JAX step is functional (it returns a new pool, for a chaos site
between compute and commit), the port writes each step's new K/V rows into
the pool in place, at position ``lens`` of the live lanes only; rewriting
the same row is harmless, so a step may be repeated. The prefix cache,
chunked prefill, speculative steps, sampling, ``DecodeService``, metrics,
chaos sites and flight-recorder hooks come with later slices: the engine
raises ``NotImplementedError`` when the config asks for one of them.
"""

from __future__ import annotations

import math
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.batching import bucket
from ..ops.fused_attention import KEY_OFF
from ..ops.paged_attention import (
    PagedKvPool,
    dense_decode_attention,
    paged_attention_reference,
    paged_decode_attention,
    pages_for,
)
from .config import DecodeConfig

__all__ = ["DecoderConfig", "init_decoder_params", "decode_greedy", "DecodeTicket", "DecodeEngine"]

#: prefill length buckets
_PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)

@dataclass(frozen=True)
class DecoderConfig:
    """Geometry of the small generative decoder (GPT-2-style blocks,
    learned positions, tied embedding / LM head, f32 everywhere)."""

    vocab_size: int = 32000
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_position: int = 512

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("decoder: num_heads must divide hidden_size")


def init_decoder_params(cfg: DecoderConfig, seed: int = 0) -> dict:
    """Seeded random weights on the CPU: normal(0.02) matrices and
    embeddings, zero biases, LayerNorm scale 1. The layout is the JAX
    package's (``x @ w``; ``weights.from_jax_decoder_params`` bridges its
    trees), so the engine reads either."""
    gen = torch.Generator().manual_seed(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return torch.empty(shape).normal_(0.0, 0.02, generator=gen)

    params: dict = {
        "tok": normal(cfg.vocab_size, d),
        "pos": normal(cfg.max_position, d),
        "lnf_s": torch.ones(d),
        "lnf_b": torch.zeros(d),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1_s": torch.ones(d), "ln1_b": torch.zeros(d),
            "wqkv": normal(d, 3 * d), "bqkv": torch.zeros(3 * d),
            "wo": normal(d, d), "bo": torch.zeros(d),
            "ln2_s": torch.ones(d), "ln2_b": torch.zeros(d),
            "w1": normal(d, f), "b1": torch.zeros(f),
            "w2": normal(f, d), "b2": torch.zeros(d),
        })
    return params


def params_to(params: dict, device) -> dict:
    """The decoder's weight dict as contiguous f32 tensors on ``device``."""
    def mv(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(device=device, dtype=torch.float32).contiguous()

    out = {k: mv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: mv(v) for k, v in lp.items()} for lp in params["layers"]]
    return out


# -- model math (shared by the engine and the fused RAG answer stage) --------


def _ln(x, s, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * (1.0 / torch.sqrt(var + eps)) * s + b


def _mlp(x, lp):
    h2 = _ln(x, lp["ln2_s"], lp["ln2_b"])
    return x + F.gelu(h2 @ lp["w1"] + lp["b1"], approximate="tanh") @ lp["w2"] + lp["b2"]


def _prefill_logits_math(params, cfg: DecoderConfig, ids, length):
    """Causal forward over padded prompts. ``ids``: [B, S] int,
    ``length``: [B] int. Returns per-layer K/V rows ``[B, layers, S, d]``
    each and the next-token logits at position ``length - 1`` ([B, vocab])."""
    b, seq = ids.shape
    d, nh = cfg.hidden_size, cfg.num_heads
    hd = d // nh
    scale = 1.0 / math.sqrt(hd)
    length = length.to(device=ids.device, dtype=torch.int64)
    # ids past the vocabulary clamp to its last row, as the reference's gather does
    x = params["tok"][ids.long().clamp(0, cfg.vocab_size - 1)] + params["pos"][:seq][None]
    qi = torch.arange(seq, device=ids.device)[:, None]
    ki = torch.arange(seq, device=ids.device)[None, :]
    live = (ki <= qi)[None] & (ki[None] < length[:, None, None])
    bias = torch.where(live, 0.0, KEY_OFF)[:, None]  # [B, 1, S, S]
    ks, vs = [], []
    for lp in params["layers"]:
        h = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q, k, v = (h @ lp["wqkv"] + lp["bqkv"]).split(d, dim=-1)
        ks.append(k)
        vs.append(v)
        heads = lambda t: t.reshape(b, seq, nh, hd).transpose(1, 2)  # noqa: E731
        s = (heads(q) @ heads(k).transpose(-1, -2)) * scale + bias
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        att = (p @ heads(v)).transpose(1, 2).reshape(b, seq, d)
        x = _mlp(x + att @ lp["wo"] + lp["bo"], lp)
    xf = _ln(x, params["lnf_s"], params["lnf_b"])
    last = xf[torch.arange(b, device=ids.device), length - 1]  # [B, d]
    return torch.stack(ks, dim=1), torch.stack(vs, dim=1), last @ params["tok"].T


def _step_logits_math(params, cfg: DecoderConfig, toks, positions, attend):
    """One decode step for a batch of tokens. ``toks``/``positions``: [B].
    ``attend(layer, q, k_new, v_new)`` commits the new KV row into that
    layer's cache and returns the attention output [B, d]. Per-row math
    only. Returns the next-token logits [B, vocab] f32."""
    d = cfg.hidden_size
    x = params["tok"][toks.long()] + params["pos"][positions.long()]
    for layer, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q, k_new, v_new = (h @ lp["wqkv"] + lp["bqkv"]).split(d, dim=-1)
        x = _mlp(x + attend(layer, q.contiguous(), k_new, v_new) @ lp["wo"] + lp["bo"], lp)
    return _ln(x, params["lnf_s"], params["lnf_b"]) @ params["tok"].T


def _argmax(logits):
    """Greedy pick; the first index among equal maxima."""
    return torch.argmax(logits, dim=-1)


def decode_greedy(params, cfg: DecoderConfig, ids, length, max_new: int):
    """Greedy generation for a batch of padded prompts over dense KV caches
    (the generate stage of ``ops/fused_rag.py``; the JAX package vmaps its
    one-prompt version). ``ids``: [B, S] int, ``length``: [B] int. Returns
    [B, max_new] int64 tokens."""
    b, seq = ids.shape
    dev = ids.device
    d, layers = cfg.hidden_size, cfg.num_layers
    k_rows, v_rows, logits = _prefill_logits_math(params, cfg, ids, length)
    tok = _argmax(logits)
    if max_new <= 1:
        return tok[:, None]
    ctx = seq + max_new
    cache_k = torch.zeros((b, layers, ctx, d), dtype=torch.float32, device=dev)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :, :seq] = k_rows
    cache_v[:, :, :seq] = v_rows
    rows = torch.arange(b, device=dev)
    cur = length.to(device=dev, dtype=torch.int64).clone()
    out = [tok]
    for _ in range(max_new - 1):

        def attend(layer, q, k_new, v_new):
            cache_k[rows, layer, cur] = k_new
            cache_v[rows, layer, cur] = v_new
            return dense_decode_attention(q, cache_k[:, layer], cache_v[:, layer], cur + 1, n_heads=cfg.num_heads)

        tok = _argmax(_step_logits_math(params, cfg, tok, cur, attend))
        out.append(tok)
        cur = cur + 1
    return torch.stack(out, dim=1)


# -- engine ------------------------------------------------------------------


class DecodeTicket:
    """One query's handle through the decode plane."""

    __slots__ = ("prompt", "max_new", "deadline", "degraded", "skip_rerank", "tokens", "preempted", "done")

    def __init__(self, prompt, max_new, deadline, degraded):
        self.prompt = list(prompt)
        self.max_new = max_new
        self.deadline = deadline
        self.degraded = degraded
        self.skip_rerank = degraded  # degrade semantics: rerank is skipped
        self.tokens: list[int] = []
        self.preempted = False
        self.done = threading.Event()

    def result(self, timeout: float | None = None) -> list[int]:
        """Block for the final token stream (short if the query was
        preempted: check ``preempted``)."""
        self.done.wait(timeout)
        return list(self.tokens)


class _Lane:
    __slots__ = ("ticket", "pages", "t_admit")

    def __init__(self, ticket, pages):
        self.ticket = ticket
        self.pages = pages
        self.t_admit = _time.monotonic()


_NOT_YET = {
    "prefix_cache": "the prefix cache",
    "prefill_chunk": "chunked prefill",
    "spec_tokens": "speculative steps",
    "temperature": "sampled decode",
}


class DecodeEngine:
    """Paged-KV continuous-batching greedy decoder (see module docstring)."""

    def __init__(
        self,
        model_cfg: DecoderConfig | None = None,
        config: DecodeConfig | None = None,
        *,
        params=None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg or DecoderConfig()
        self.config = config or DecodeConfig()
        for field, what in _NOT_YET.items():
            if getattr(self.config, field):
                raise NotImplementedError(f"decode: {what} ({field}=) is not ported yet")
        self.config.check_budget(self.model_cfg.num_layers, self.model_cfg.hidden_size)
        impl = self.config.impl
        if impl == "paged" and self.device.type != "cuda":
            raise ValueError("decode impl='paged' runs kernel B5 and needs a CUDA device")
        self.impl = impl
        self._attention = paged_attention_reference if impl in ("xla", "interpret") else paged_decode_attention
        self.params = params_to(params if params is not None else init_decoder_params(self.model_cfg, seed), self.device)
        self.pool = PagedKvPool(
            layers=self.model_cfg.num_layers,
            dim=self.model_cfg.hidden_size,
            n_pages=self.config.pages,
            page_size=self.config.page_size,
            device=self.device,
        )
        self._pages_per_seq = self.config.pages_per_seq()
        lanes = self.config.lanes
        self._lanes: list[Optional[_Lane]] = [None] * lanes
        self._page_tables = np.full((lanes, self._pages_per_seq), self.pool.sentinel, np.int32)
        self._lens = np.zeros(lanes, np.int32)
        self._pending: deque[DecodeTicket] = deque()
        self.steps = 0

    # -- ticket lifecycle --

    def max_prompt_len(self) -> int:
        return min(self.config.max_seq, self.model_cfg.max_position)

    def make_ticket(self, prompt_ids, *, max_new_tokens: int | None = None, deadline=None, degraded: bool = False):
        max_new = max_new_tokens or self.config.max_new_tokens
        if degraded:
            max_new = min(max_new, self.config.degrade_max_new_tokens)
        prompt = [int(t) % self.model_cfg.vocab_size for t in prompt_ids]
        if not prompt:
            raise ValueError("decode: empty prompt")
        if len(prompt) + max_new > self.max_prompt_len():
            raise ValueError(
                f"decode: prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the context limit {self.max_prompt_len()}"
            )
        return DecodeTicket(prompt, max_new, deadline, degraded)

    def enqueue(self, ticket: DecodeTicket) -> None:
        self._pending.append(ticket)

    def submit(self, prompt_ids, **kw) -> DecodeTicket:
        ticket = self.make_ticket(prompt_ids, **kw)
        self.enqueue(ticket)
        return ticket

    # -- lanes --

    def _free_lane_pages(self, lane_idx: int) -> None:
        lane = self._lanes[lane_idx]
        self.pool.free(lane.pages)
        self._lanes[lane_idx] = None
        self._page_tables[lane_idx, :] = self.pool.sentinel
        self._lens[lane_idx] = 0

    def _preempt_expired(self) -> None:
        """A lane whose ticket's deadline (anything with ``expires_at`` on
        the monotonic clock) has passed gives its pages back."""
        now = _time.monotonic()
        for i, lane in enumerate(self._lanes):
            if lane is None:
                continue
            dl = lane.ticket.deadline
            if dl is not None and dl.expires_at <= now:
                ticket = lane.ticket
                self._free_lane_pages(i)
                ticket.preempted = True
                ticket.done.set()

    def _finish(self, lane_idx: int) -> None:
        ticket = self._lanes[lane_idx].ticket
        self._free_lane_pages(lane_idx)
        ticket.done.set()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    def _prefill_whole(self, i: int, ticket: DecodeTicket, pages) -> None:
        """Whole-prompt prefill into lane ``i``: K/V rows into the lane's
        pages, the first token out."""
        plen = len(ticket.prompt)
        ps = self.config.page_size
        seq = min(bucket(plen, _PREFILL_BUCKETS), self.max_prompt_len())
        ids = np.zeros((1, seq), np.int64)
        ids[0, :plen] = ticket.prompt
        pos = np.arange(plen)
        where = np.stack([np.asarray(pages, np.int64)[pos // ps], pos % ps])
        with torch.no_grad():
            ids_d = self._upload(ids)
            k_rows, v_rows, logits = _prefill_logits_math(
                self.params, self.model_cfg, ids_d, torch.tensor([plen], device=self.device)
            )
            pg, off = self._upload(where)
            self.pool.k[:, pg, off] = k_rows[0, :, :plen]
            self.pool.v[:, pg, off] = v_rows[0, :, :plen]
            tok0 = int(_argmax(logits[0]))
        self._lanes[i] = _Lane(ticket, pages)
        self._page_tables[i, :] = self.pool.sentinel
        self._page_tables[i, : len(pages)] = pages
        self._lens[i] = plen
        ticket.tokens.append(tok0)

    def _admit(self) -> None:
        for i in range(len(self._lanes)):
            if not self._pending:
                return
            if self._lanes[i] is not None:
                continue
            ticket = self._pending[0]
            need = pages_for(len(ticket.prompt) + ticket.max_new, self.config.page_size)
            pages = self.pool.alloc(need)
            if pages is None:
                return  # pool pressure: stay queued, retry next tick
            self._pending.popleft()
            self._prefill_whole(i, ticket, pages)
            if len(ticket.tokens) >= ticket.max_new:
                self._finish(i)

    def step(self) -> int:
        """One engine tick: preempt expired lanes, admit pending prefills,
        then one decode step across every live lane at the full lane width.
        Returns the number of tokens emitted."""
        self._preempt_expired()
        self._admit()
        live = [i for i, ln in enumerate(self._lanes) if ln is not None]
        if not live:
            return 0
        lanes, ps, P = self.config.lanes, self.config.page_size, self._pages_per_seq
        toks = np.zeros(lanes, np.int32)
        for i in live:
            toks[i] = self._lanes[i].ticket.tokens[-1]
        pos = self._lens[live]
        # one upload: tables (first, so the kernel gets an aligned operand),
        # tokens, lens, then (lane, page, offset) of each live lane's new row
        host = np.concatenate([
            self._page_tables.reshape(-1), toks, self._lens,
            np.asarray(live, np.int32), self._page_tables[live, pos // ps], pos % ps,
        ])
        dev = self._upload(host)
        tables_d = dev[: lanes * P].view(lanes, P)
        toks_d, lens_d = dev[lanes * P : lanes * P + lanes], dev[lanes * P + lanes : lanes * P + 2 * lanes]
        n = len(live)
        w = dev[lanes * P + 2 * lanes :].long()
        w_lane, w_page, w_off = w[:n], w[n : 2 * n], w[2 * n :]
        ctx_lens = lens_d + 1
        pool, att, heads = self.pool, self._attention, self.model_cfg.num_heads

        def attend(layer, q, k_new, v_new):
            pool.k[layer, w_page, w_off] = k_new[w_lane]
            pool.v[layer, w_page, w_off] = v_new[w_lane]
            return att(q, pool.k[layer], pool.v[layer], tables_d, ctx_lens, n_heads=heads)

        with torch.no_grad():
            nxt = _argmax(_step_logits_math(self.params, self.model_cfg, toks_d, lens_d, attend)).cpu().numpy()
        emitted = 0
        for i in live:
            lane = self._lanes[i]
            self._lens[i] += 1
            lane.ticket.tokens.append(int(nxt[i]))
            emitted += 1
            if len(lane.ticket.tokens) >= lane.ticket.max_new:
                self._finish(i)
        self.steps += 1
        return emitted

    def busy(self) -> bool:
        return bool(self._pending) or any(lane is not None for lane in self._lanes)

    def drain(self, max_steps: int = 1_000_000) -> None:
        """Run the scheduler until every queued query finished (or was
        preempted)."""
        for _ in range(max_steps):
            if not self.busy():
                return
            self.step()
        raise RuntimeError("decode: drain did not converge")

    def generate(self, prompts, **kw) -> list[list[int]]:
        """Submit every prompt, run to drain, return the token streams."""
        tickets = [self.submit(p, **kw) for p in prompts]
        self.drain()
        return [t.result() for t in tickets]
