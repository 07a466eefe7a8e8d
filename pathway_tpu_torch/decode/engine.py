"""Continuous-batching generative decoder over the paged-KV pool.

Port of ``pathway_tpu/decode/engine.py``: the decoder's model math
(``DecoderConfig``, ``init_decoder_params``, prefill, chunked prefill,
step, speculative draft and verify, ``decode_greedy``), the
``DecodeEngine`` scheduler and the ``DecodeService`` front door. One
engine owns a :class:`~pathway_tpu_torch.ops.paged_attention.PagedKvPool`
and a fixed set of lanes; prefills admit into free lanes as queries
arrive, and every ``step`` runs one decode step for all live lanes, whose
attention is kernel B5 (``paged_decode_attention``) on a CUDA pool, in the
greedy step and in the sampled step alike.

Batching is invisible: the step always runs at the full lane width, so
every matrix product sees one shape, and all math is per row; a stream
decodes to the same tokens alone or among others. Everything is f32; the
caller turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default) so the card's f32 products are full f32.

A step computes, then commits. The ``decode.step`` chaos site sits between
the two, in the greedy step, the sampled step and the speculative tick,
as in the reference. Where the JAX step is functional (it returns a new
pool, and the commit swaps it in), the port writes each step's new K/V
rows into the pool in place during the compute and does not copy the
pool; what makes a kill at the site harmless:

* every row a step writes lies at or past its lane's ``lens`` (at
  ``lens`` in a step, at ``lens .. lens + spec_tokens - 1`` in a verify),
  and attention reads a lane's rows below its context length only, so
  those rows stay masked until the commit moves ``lens``;
* the step's inputs (the tokens, the lens, the rows below ``lens``, the
  sampling key and position) are unchanged by a killed step, so a retry
  computes and writes identical values;
* those rows lie in the lane's own pages: the prefix cache shares only
  full pages of a prompt's prefix, and a prompt's last token is always
  re-prefilled into a page of the lane's own, so no step writes into a
  page that another lane shares.

Chunked prefill writes the chunk's rows at ``filled ..`` in the same way.

The serving extensions are the reference's, all off by default:

* the prefix cache (``decode/prefix_cache.py``) maps the cached full pages
  of a prompt's prefix into the lane's page table (``PagedKvPool.share``),
  and admission then runs in the ``AdaptiveBatcher``'s deadline order;
* chunked prefill advances one prefilling lane by ``prefill_chunk`` prompt
  tokens a tick: the chunk attends the gathered pool context plus its own
  rows causally (:func:`_chunk_prefill_math`, plain PyTorch on the card, as
  the reference computes it outside any Pallas kernel);
* speculative steps draft ``spec_tokens`` tokens per lane (the first
  ``draft_layers`` target layers over a dense per-lane window gathered once
  from the pool, or prompt lookup on the host) and verify them in one
  batched forward of the full target (:func:`_verify_math`); both are plain
  PyTorch on the card, as the reference's are plain XLA. The longest
  matching prefix plus the target's bonus token commits, so the stream is
  the single-token stream;
* sampled decode returns the step's logits through B5 and draws on the
  host (:func:`_sample_token`), keyed on the ticket's prompt, the position
  and the seed, so a stream is the same alone or batched.

The observability hooks are the reference's: the prefill (whole or by
chunks) and the greedy or sampled step book their device time under the
chip ledger's ``decode``, a speculative tick under ``decode.draft`` and
``decode.verify``; the flight recorder gets ``decode.prefill``,
``decode.admit``, ``decode.step``, ``decode.kv_evict`` and
``decode.preempt``; a ticket made under a request trace gets
``decode_prefill`` and ``decode_step`` spans (each in a trace of its own
that links the member requests); the weights and the KV pool report to the
HBM ledger.
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
from ..internals import flight_recorder
from ..internals.chip_ledger import CHIP_LEDGER
from ..models.batching import bucket
from ..ops.fused_attention import KEY_OFF
from ..ops.paged_attention import (
    PagedKvPool,
    dense_decode_attention,
    paged_attention_reference,
    paged_decode_attention,
    pages_for,
)
from ..resilience import chaos
from .config import DecodeConfig, active_decode
from .metrics import DECODE_METRICS

__all__ = ["DecoderConfig", "init_decoder_params", "decode_greedy", "DecodeTicket", "DecodeEngine", "DecodeService"]

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
    d = cfg.hidden_size
    length = length.to(device=ids.device, dtype=torch.int64)
    # ids past the vocabulary clamp to its last row, as the reference's gather does
    x = params["tok"][ids.long().clamp(0, cfg.vocab_size - 1)] + params["pos"][:seq][None]
    qi = torch.arange(seq, device=ids.device)[:, None]
    ki = torch.arange(seq, device=ids.device)[None, :]
    live = (ki <= qi)[None] & (ki[None] < length[:, None, None])
    bias = torch.where(live, 0.0, KEY_OFF)  # [B, S, S]
    ks, vs = [], []
    for lp in params["layers"]:
        h = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q, k, v = (h @ lp["wqkv"] + lp["bqkv"]).split(d, dim=-1)
        ks.append(k)
        vs.append(v)
        x = _mlp(x + _attend_heads(q, k, v, bias, cfg.num_heads) @ lp["wo"] + lp["bo"], lp)
    xf = _ln(x, params["lnf_s"], params["lnf_b"])
    last = xf[torch.arange(b, device=ids.device), length - 1]  # [B, d]
    return torch.stack(ks, dim=1), torch.stack(vs, dim=1), last @ params["tok"].T


def _step_logits_math(params, cfg: DecoderConfig, toks, positions, attend):
    """One decode step for a batch of tokens. ``toks``/``positions``: [B].
    ``attend(layer, q, k_new, v_new)`` commits the new KV row into that
    layer's cache and returns the attention output [B, d]. Per-row math
    only. Returns the next-token logits [B, vocab] f32."""
    d = cfg.hidden_size
    # positions past the table clamp to its last row, as the reference's gather does
    x = params["tok"][toks.long()] + params["pos"][positions.long().clamp(max=cfg.max_position - 1)]
    for layer, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q, k_new, v_new = (h @ lp["wqkv"] + lp["bqkv"]).split(d, dim=-1)
        x = _mlp(x + attend(layer, q.contiguous(), k_new, v_new) @ lp["wo"] + lp["bo"], lp)
    return _ln(x, params["lnf_s"], params["lnf_b"]) @ params["tok"].T


def _argmax(logits):
    """Greedy pick; the first index among equal maxima."""
    return torch.argmax(logits, dim=-1)


def _attend_heads(q, k, v, bias, n_heads: int):
    """Softmax attention of query rows against key rows, per head, in f32
    with an additive bias. ``q``: [..., m, d] · ``k``/``v``: [..., n, d] ·
    ``bias``: broadcastable to [..., m, n]. Returns [..., m, d]."""
    *lead, m, d = q.shape
    n = k.shape[-2]
    hd = d // n_heads
    heads = lambda t, rows: t.reshape(*lead, rows, n_heads, hd).transpose(-2, -3)  # noqa: E731
    s = (heads(q, m) @ heads(k, n).transpose(-1, -2)) * (1.0 / math.sqrt(hd)) + bias.unsqueeze(-3)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return (p @ heads(v, n)).transpose(-2, -3).reshape(*lead, m, d)


def _prompt_lookup(hist: list, n: int, k: int) -> list:
    """Prompt-lookup draft: propose the ``k`` tokens that followed the most
    recent *earlier* occurrence of the stream's trailing n-gram in the
    lane's own prompt + output. Tries match lengths ``n`` down to 1; with
    no match anywhere, proposes the last token repeated. Host work only:
    the target's batched verify is the only device work of such a tick."""
    L = len(hist)
    for m in range(min(n, L - 1), 0, -1):
        pat = hist[L - m:]
        for j in range(L - m - 1, -1, -1):
            if hist[j:j + m] == pat:
                out = list(hist[j + m:j + m + k])
                if out:
                    while len(out) < k:
                        out.append(out[-1])
                    return out
    return [hist[-1]] * k if L else [0] * k


def _draft_view(params, draft_layers: int) -> dict:
    """The layer-skip self-draft: the first ``draft_layers`` target blocks
    plus the shared final LN and tied head. The draft's layer ``l`` *is* the
    target's layer ``l``, so its KV rows are the target's: the draft reads
    the same pool."""
    return {
        "tok": params["tok"],
        "pos": params["pos"],
        "lnf_s": params["lnf_s"],
        "lnf_b": params["lnf_b"],
        "layers": params["layers"][:draft_layers],
    }


def _pool_window(pool, layer: int, page_tables, extra: int):
    """One layer's context gathered out of the pool, each lane's pages in
    table order, plus ``extra`` zero rows for rows overlaid after it:
    ``pool``: [layers, n_pages, page_size, d] · ``page_tables``: [lanes, P]
    (clamped to real pages). Returns [lanes, P * page_size + extra, d]."""
    lanes, d = page_tables.shape[0], pool.shape[-1]
    win = pool[layer][page_tables].reshape(lanes, -1, d)
    return torch.cat([win, win.new_zeros((lanes, extra, d))], dim=1)


def _window_math(params, cfg: DecoderConfig, pool_k, pool_v, page_tables, ids, pos, valid, *, page_size: int):
    """Every layer of the target over a window of consecutive rows per lane,
    against the pages already resident in the pool: the body of chunked
    prefill (one lane) and of the speculative verify. ``page_tables``:
    [lanes, P] int · ``ids``/``pos``: [lanes, m] int tokens and their
    absolute positions (``pos[:, j] = pos[:, 0] + j``) · ``valid``: [lanes,
    m] bool rows to commit, or None for all. Each row attends the lane's
    gathered pool context at positions below its own plus the window's own
    rows causally, exactly what as many sequential steps attend; keys past
    the window's start come only from its own overlay rows, so stale pool
    bytes are never attendable. Writes the valid rows' K/V into the pool in
    place (positions past the lane's page span and sentinel pages are
    dropped). Returns the final-LN rows [lanes, m, d]."""
    dev = ids.device
    lanes, m = ids.shape
    d = cfg.hidden_size
    n_pages = pool_k.shape[1]
    pps = page_tables.shape[1]
    ctx = pps * page_size
    pos = pos.long()
    x = params["tok"][ids.long()] + params["pos"][pos.clamp(max=cfg.max_position - 1)]
    pt = page_tables.long().clamp(max=n_pages - 1)
    ki = torch.arange(ctx + m, device=dev)[None, None, :]
    bias = torch.where(ki <= pos[:, :, None], 0.0, KEY_OFF)  # [lanes, m, ctx + m]
    lane = torch.arange(lanes, device=dev)[:, None]
    at = pos[:, :1].clamp(max=ctx) + torch.arange(m, device=dev)[None, :]  # overlay rows
    ks, vs = [], []
    for layer, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q, k_new, v_new = (h @ lp["wqkv"] + lp["bqkv"]).split(d, dim=-1)  # [lanes, m, d]
        ks.append(k_new)
        vs.append(v_new)
        k_ctx = _pool_window(pool_k, layer, pt, m)
        v_ctx = _pool_window(pool_v, layer, pt, m)
        k_ctx[lane, at] = k_new
        v_ctx[lane, at] = v_new
        x = _mlp(x + _attend_heads(q, k_ctx, v_ctx, bias, cfg.num_heads) @ lp["wo"] + lp["bo"], lp)
    pidx = pos // page_size
    pages = torch.where(pidx < pps, page_tables.long().gather(1, pidx.clamp(max=pps - 1)), n_pages)
    keep = pages < n_pages if valid is None else valid & (pages < n_pages)
    pg, off = pages[keep], (pos % page_size)[keep]
    pool_k[:, pg, off] = torch.stack(ks)[:, keep]
    pool_v[:, pg, off] = torch.stack(vs)[:, keep]
    return _ln(x, params["lnf_s"], params["lnf_b"])


def _chunk_prefill_math(params, cfg: DecoderConfig, pool_k, pool_v, page_ids, ids, start: int, count: int, *,
                        page_size: int):
    """Prefill one chunk of a prompt against pages already resident in the
    pool (:func:`_window_math` for one lane). ``pool_k``/``pool_v``:
    [layers, n_pages, page_size, d] · ``page_ids``: [P] int (the lane's page
    table) · ``ids``: [m] int chunk tokens (padded) · ``start``: prompt
    tokens already committed (a page-aligned prefix-cache hit plus earlier
    chunks) · ``count``: valid tokens of this chunk, the rows committed to
    the pool. Returns the next-token logits at chunk row ``count - 1``
    ([vocab])."""
    rows = torch.arange(ids.shape[0], device=ids.device)
    xf = _window_math(params, cfg, pool_k, pool_v, page_ids[None], ids[None], (start + rows)[None],
                      (rows < count)[None], page_size=page_size)
    return xf[0, count - 1] @ params["tok"].T


def _verify_math(params, cfg: DecoderConfig, pool_k, pool_v, page_tables, lens, inputs, *, page_size: int):
    """Speculative verify: one batched causal forward over every lane's
    k-token window (:func:`_window_math`). ``inputs``: [lanes, k] int (the
    pending token, then the first k-1 draft proposals); row ``j`` of the
    result is the token the target emits at position ``lens + j``. Every
    window row is committed to the pool. Returns the targets [k, lanes]."""
    pos = lens.long()[:, None] + torch.arange(inputs.shape[1], device=inputs.device)[None, :]
    xf = _window_math(params, cfg, pool_k, pool_v, page_tables, inputs, pos, None, page_size=page_size)
    return _argmax(xf @ params["tok"].T).T


def _draft_math(params, cfg: DecoderConfig, pool_k, pool_v, page_tables, lens, toks, *, page_size: int,
                spec_tokens: int, draft_layers: int):
    """Speculative draft: ``spec_tokens`` layer-skip steps proposing a token
    chain per lane. Each lane's context in the first ``draft_layers`` layers
    is gathered out of the pool once into a dense per-lane window
    (:func:`_pool_window`); the draft's own rows overlay it at their
    absolute positions and are discarded after (the verify writes the
    pool's rows for every layer). Returns the proposals [spec_tokens,
    lanes]."""
    dev = toks.device
    dparams = _draft_view(params, draft_layers)
    lanes = toks.shape[0]
    n_pages = pool_k.shape[1]
    ctx = page_tables.shape[1] * page_size
    pt = page_tables.long().clamp(max=n_pages - 1)
    dk = [_pool_window(pool_k, layer, pt, spec_tokens) for layer in range(draft_layers)]
    dv = [_pool_window(pool_v, layer, pt, spec_tokens) for layer in range(draft_layers)]
    ki = torch.arange(ctx + spec_tokens, device=dev)[None, :]
    lane = torch.arange(lanes, device=dev)
    tok, cur = toks.long(), lens.long()
    drafts = []
    for _ in range(spec_tokens):
        # keys at absolute positions <= cur: committed pool rows below each
        # lane's length plus the draft's own rows
        bias = torch.where(ki <= cur[:, None], 0.0, KEY_OFF)[:, None, :]  # [lanes, 1, ctx + k]
        at = cur.clamp(max=ctx + spec_tokens - 1)

        def attend(layer, q, k_new, v_new, at=at, bias=bias):
            dk[layer][lane, at] = k_new
            dv[layer][lane, at] = v_new
            return _attend_heads(q[:, None], dk[layer], dv[layer], bias, cfg.num_heads)[:, 0]

        tok = _argmax(_step_logits_math(dparams, cfg, tok, cur, attend))
        drafts.append(tok)
        cur = cur + 1
    return torch.stack(drafts)


# -- seeded sampling (host side) ---------------------------------------------


def _sample_key(seed: int, prompt) -> int:
    """Counter-based sampling key: a hash of the engine seed and the prompt
    tokens. The draw for stream position ``n`` depends only on (key, n), so
    co-batched strangers cannot perturb a stream."""
    import hashlib

    h = hashlib.blake2b(str(int(seed)).encode(), digest_size=8)
    h.update(b"".join(int(t).to_bytes(8, "little", signed=True) for t in prompt))
    return int.from_bytes(h.digest(), "little")


def _sample_token(logits, cfg, key: int, position: int) -> int:
    """Draw one token from ``logits`` ([vocab] f32) with temperature / top-k
    / top-p, deterministically keyed on (ticket key, stream position). Ties
    break by stable descending sort, so the draw is reproducible across
    platforms."""
    z = np.asarray(logits, np.float64)
    order = np.argsort(-z, kind="stable")
    if cfg.top_k:
        order = order[: cfg.top_k]
    zs = z[order] / float(cfg.temperature)
    zs -= zs.max()
    p = np.exp(zs)
    p /= p.sum()
    if cfg.top_p < 1.0:
        # nucleus: keep the smallest prefix reaching top_p mass (always at
        # least the head token)
        keep = np.cumsum(p) - p < cfg.top_p
        keep[0] = True
        order, p = order[keep], p[keep]
        p /= p.sum()
    rng = np.random.default_rng(np.random.SeedSequence([key, int(position), int(cfg.seed)]))
    draw = rng.random()
    idx = int(np.searchsorted(np.cumsum(p), draw, side="right"))
    return int(order[min(idx, len(p) - 1)])


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


def _members(trace) -> tuple:
    """The request contexts a ticket's trace stands for."""
    from ..tracing import trace_members

    return trace_members(trace)


class DecodeTicket:
    """One query's handle through the decode plane."""

    __slots__ = ("prompt", "max_new", "deadline", "degraded", "skip_rerank", "tokens", "preempted", "done",
                 "sample_key", "trace")

    def __init__(self, prompt, max_new, deadline, degraded, trace=None):
        self.prompt = list(prompt)
        self.max_new = max_new
        self.deadline = deadline
        self.degraded = degraded
        self.skip_rerank = degraded  # degrade semantics: rerank is skipped
        self.tokens: list[int] = []
        self.preempted = False
        self.done = threading.Event()
        self.sample_key: int | None = None  # counter-based sampling key (None: greedy)
        self.trace = trace  # the request's trace context, when traced

    def result(self, timeout: float | None = None) -> list[int]:
        """Block for the final token stream (short if the query was
        preempted: check ``preempted``)."""
        self.done.wait(timeout)
        return list(self.tokens)


class _Lane:
    __slots__ = ("ticket", "pages", "t_admit", "shared", "filled", "prefill_wall")

    def __init__(self, ticket, pages, *, shared: int = 0, filled: int | None = None):
        self.ticket = ticket
        self.pages = pages
        self.t_admit = _time.monotonic()
        # the first ``shared`` pages are mapped from the prefix cache;
        # ``filled`` counts prompt tokens whose KV is committed: below the
        # prompt length the lane is still prefilling and sits out decode steps
        self.shared = shared
        self.filled = len(ticket.prompt) if filled is None else filled
        self.prefill_wall = 0.0

    @property
    def prefilling(self) -> bool:
        return self.filled < len(self.ticket.prompt)


class DecodeEngine:
    """Paged-KV continuous-batching decoder (see module docstring). Built
    without a ``config``, it takes the run-scoped one (``pw.run(decode=)``
    / ``PATHWAY_DECODE``, :func:`~pathway_tpu_torch.decode.config.active_decode`),
    else the defaults."""

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
        self.config = config or active_decode() or DecodeConfig()
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
        # serving extensions (all off by default: off runs the single-token
        # whole-prefill scheduler)
        self.cache = None
        if self.config.prefix_cache:
            from .prefix_cache import PrefixCache

            self.cache = PrefixCache(self.pool, page_size=self.config.page_size,
                                     model_version=f"{self.model_cfg}/seed={seed}")
        self._incremental = bool(self.config.prefix_cache or self.config.prefill_chunk)
        self._draft_layers = 0
        if self.config.spec_tokens:
            self._draft_layers = self.config.draft_layers or max(1, self.model_cfg.num_layers // 2)
            if self._draft_layers >= self.model_cfg.num_layers:
                raise ValueError(
                    "decode: draft_layers must be smaller than the target's "
                    f"num_layers ({self.model_cfg.num_layers}) — a draft as "
                    "deep as the target verifies nothing"
                )
        lanes = self.config.lanes
        self._lanes: list[Optional[_Lane]] = [None] * lanes
        self._page_tables = np.full((lanes, self._pages_per_seq), self.pool.sentinel, np.int32)
        self._lens = np.zeros(lanes, np.int32)
        self._pending: deque[DecodeTicket] = deque()
        self.steps = 0
        from ..internals.profiler import wrap_jit

        # the run profiler's build / execute split of each tick
        self.step = wrap_jit("decode.step", self.step)
        DECODE_METRICS.set_pool(self.pool.pages_in_use, self.pool.n_pages)
        self._ledger_update()
        from ..internals.ledger import LEDGER, pytree_nbytes

        LEDGER.update("weights", "decoder", pytree_nbytes(self.params))

    def _ledger_update(self) -> None:
        """Report the KV page pool to the HBM ledger: exact bytes of the
        pool tensors; ``used`` is the allocated-page fraction, so the
        ledger's fragmentation gauge reads idle pool capacity."""
        from ..internals.ledger import LEDGER

        nbytes = int(self.pool.pool_bytes)
        used = int(nbytes * self.pool.pages_in_use / self.pool.n_pages) if self.pool.n_pages else 0
        LEDGER.update("decode.kv", "pool", nbytes, used_bytes=used)

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
        DECODE_METRICS.record_query(degraded=degraded)
        from ..tracing import current_trace, tracing_enabled

        trace = current_trace() if tracing_enabled() else None
        ticket = DecodeTicket(prompt, max_new, deadline, degraded, trace=trace)
        if self.config.temperature > 0:
            # content-addressed, not order-addressed: the stream a prompt
            # samples is independent of its co-runners
            ticket.sample_key = _sample_key(self.config.seed, prompt)
        return ticket

    def enqueue(self, ticket: DecodeTicket) -> None:
        self._pending.append(ticket)

    def submit(self, prompt_ids, **kw) -> DecodeTicket:
        ticket = self.make_ticket(prompt_ids, **kw)
        self.enqueue(ticket)
        return ticket

    # -- lanes --

    def _free_lane_pages(self, lane_idx: int, reason: str) -> None:
        lane = self._lanes[lane_idx]
        self.pool.free(lane.pages)
        flight_recorder.record("decode.kv_evict", lane=lane_idx, pages=len(lane.pages), reason=reason)
        self._lanes[lane_idx] = None
        self._page_tables[lane_idx, :] = self.pool.sentinel
        self._lens[lane_idx] = 0
        DECODE_METRICS.set_pool(self.pool.pages_in_use, self.pool.n_pages)
        self._ledger_update()

    def _preempt_expired(self) -> None:
        """A lane whose ticket's deadline (anything with ``expires_at`` on
        the monotonic clock) has passed gives its pages back."""
        now = _time.monotonic()
        for i, lane in enumerate(self._lanes):
            if lane is None:
                continue
            dl = lane.ticket.deadline
            if dl is not None and dl.expires_at <= now:
                flight_recorder.record("decode.preempt", lane=i, emitted=len(lane.ticket.tokens),
                                       prompt_tokens=len(lane.ticket.prompt))
                DECODE_METRICS.record_preempt()
                ticket = lane.ticket
                self._free_lane_pages(i, "preempt")
                ticket.preempted = True
                ticket.done.set()

    def _finish(self, lane_idx: int) -> None:
        ticket = self._lanes[lane_idx].ticket
        self._free_lane_pages(lane_idx, "finish")
        ticket.done.set()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    def _first_token(self, logits, ticket: DecodeTicket) -> int:
        """The first generated token from the prefill's logits ([vocab])."""
        if self.config.temperature > 0:
            return _sample_token(logits.cpu().numpy(), self.config, ticket.sample_key, 0)
        return int(_argmax(logits))

    def _prefill_whole(self, i: int, ticket: DecodeTicket, pages) -> None:
        """Whole-prompt prefill into lane ``i``: K/V rows into the lane's
        pages, the first token out (the caller runs the max_new check)."""
        plen = len(ticket.prompt)
        ps = self.config.page_size
        w0 = _time.monotonic()
        seq = min(bucket(plen, _PREFILL_BUCKETS), self.max_prompt_len())
        ids = np.zeros((1, seq), np.int64)
        ids[0, :plen] = ticket.prompt
        pos = np.arange(plen)
        where = np.stack([np.asarray(pages, np.int64)[pos // ps], pos % ps])
        with torch.no_grad(), CHIP_LEDGER.timed("decode", device=self.device):
            ids_d = self._upload(ids)
            k_rows, v_rows, logits = _prefill_logits_math(
                self.params, self.model_cfg, ids_d, torch.tensor([plen], device=self.device)
            )
            pg, off = self._upload(where)
            self.pool.k[:, pg, off] = k_rows[0, :, :plen]
            self.pool.v[:, pg, off] = v_rows[0, :, :plen]
            tok0 = self._first_token(logits[0], ticket)
        lane = _Lane(ticket, pages)
        lane.prefill_wall = _time.monotonic() - w0
        self._lanes[i] = lane
        self._page_tables[i, :] = self.pool.sentinel
        self._page_tables[i, : len(pages)] = pages
        self._lens[i] = plen
        ticket.tokens.append(tok0)
        DECODE_METRICS.record_prefill(plen, lane.prefill_wall)
        DECODE_METRICS.set_pool(self.pool.pages_in_use, self.pool.n_pages)
        self._ledger_update()
        flight_recorder.record("decode.prefill", lane=i, prompt_tokens=plen, pages=len(pages),
                               wall_ms=round(lane.prefill_wall * 1000.0, 3))

    def _admit(self) -> None:
        if self._incremental:
            return self._admit_incremental()
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

    @staticmethod
    def _deadline_key(ticket: DecodeTicket):
        """The AdaptiveBatcher's deadline order: earliest ``expires_at``
        first, deadline-less work last, FIFO on ties."""
        dl = ticket.deadline
        return (1, 0.0) if dl is None else (0, dl.expires_at)

    def _admit_incremental(self) -> None:
        """Admission with the prefix cache and/or chunked prefill on: pending
        work admits in deadline order; the prompt's cached full-page prefix is
        mapped instead of allocated and prefilled; pool pressure reclaims
        idle cached prefixes before giving up; and a prompt with work left to
        prefill installs as a *prefilling* lane that :meth:`_advance_prefills`
        completes chunk by chunk."""
        ps = self.config.page_size
        while self._pending:
            i = next((j for j, ln in enumerate(self._lanes) if ln is None), -1)
            if i < 0:
                return
            idx = min(range(len(self._pending)), key=lambda j: self._deadline_key(self._pending[j]))
            ticket = self._pending[idx]
            plen = len(ticket.prompt)
            need = pages_for(plen + ticket.max_new, ps)
            shared = self.cache.lookup(ticket.prompt) if self.cache else []
            priv_need = need - len(shared)
            priv = self.pool.alloc(priv_need)
            if priv is None and self.cache is not None:
                # pool pressure: evict idle cached prefixes, retry once
                self.cache.reclaim(priv_need - self.pool.pages_free)
                DECODE_METRICS.set_cached_pages(self.cache.cached_pages)
                priv = self.pool.alloc(priv_need)
            if priv is None:
                if shared:
                    self.pool.free(shared)  # drop the lookup's holds
                return  # stay queued, retry next tick
            del self._pending[idx]
            pages = list(shared) + priv
            hit_tokens = len(shared) * ps
            if self.cache is not None:
                DECODE_METRICS.record_prefix(len(shared), pages_for(plen, ps) - len(shared))
            if not shared and not self.config.prefill_chunk:
                # cold miss, chunking off: the one-shot prefill, then publish
                # the fresh pages for the next request to share
                self._prefill_whole(i, ticket, pages)
                if self.cache is not None:
                    self.cache.publish(ticket.prompt, pages, plen)
                    DECODE_METRICS.set_cached_pages(self.cache.cached_pages)
                if len(ticket.tokens) >= ticket.max_new:
                    self._finish(i)
                continue
            # install as a prefilling lane; chunks advance per tick
            self._lanes[i] = _Lane(ticket, pages, shared=len(shared), filled=hit_tokens)
            self._page_tables[i, :] = self.pool.sentinel
            self._page_tables[i, : len(pages)] = pages
            self._lens[i] = hit_tokens
            DECODE_METRICS.set_pool(self.pool.pages_in_use, self.pool.n_pages)
            self._ledger_update()
            flight_recorder.record("decode.admit", lane=i, prompt_tokens=plen, pages=len(pages),
                                   prefix_hit_tokens=hit_tokens)

    def _advance_prefills(self) -> None:
        """Advance the most urgent prefilling lane by one chunk. One chunk a
        tick: a long prefill interleaves with decode steps instead of
        stalling them."""
        if not self._incremental:
            return
        idxs = [i for i, ln in enumerate(self._lanes) if ln is not None and ln.prefilling]
        if not idxs:
            return
        i = min(idxs, key=lambda j: self._deadline_key(self._lanes[j].ticket))
        lane = self._lanes[i]
        ticket = lane.ticket
        plen = len(ticket.prompt)
        count = plen - lane.filled
        if self.config.prefill_chunk:
            count = min(count, self.config.prefill_chunk)
        m = min(bucket(count, _PREFILL_BUCKETS), self.max_prompt_len())
        ids = np.zeros(m, np.int64)
        ids[:count] = ticket.prompt[lane.filled : lane.filled + count]
        w0 = _time.monotonic()
        with torch.no_grad(), CHIP_LEDGER.timed("decode", device=self.device):
            logits = _chunk_prefill_math(
                self.params, self.model_cfg, self.pool.k, self.pool.v, self._upload(self._page_tables[i]),
                self._upload(ids), lane.filled, count, page_size=self.config.page_size,
            )
        lane.filled += count
        self._lens[i] = lane.filled
        if lane.filled < plen:
            lane.prefill_wall += _time.monotonic() - w0
            return
        # prefill complete: emit the first token, publish the prefix
        with torch.no_grad():
            ticket.tokens.append(self._first_token(logits, ticket))
        lane.prefill_wall += _time.monotonic() - w0
        if self.cache is not None:
            self.cache.publish(ticket.prompt, lane.pages, plen)
            DECODE_METRICS.set_cached_pages(self.cache.cached_pages)
        hit_tokens = lane.shared * self.config.page_size
        DECODE_METRICS.record_prefill(plen, lane.prefill_wall)
        DECODE_METRICS.set_pool(self.pool.pages_in_use, self.pool.n_pages)
        self._ledger_update()
        flight_recorder.record("decode.prefill", lane=i, prompt_tokens=plen, pages=len(lane.pages),
                               wall_ms=round(lane.prefill_wall * 1000.0, 3), prefix_hit_tokens=hit_tokens)
        from ..tracing import record_span, tracing_enabled

        if tracing_enabled() and ticket.trace is not None:
            record_span("decode_prefill", start_mono=w0, end_mono=_time.monotonic(), new_trace=True,
                        links=tuple(t.trace_id for t in _members(ticket.trace)), prefix_hit=hit_tokens,
                        prompt_tokens=plen)
        if len(ticket.tokens) >= ticket.max_new:
            self._finish(i)

    def _step_upload(self, live):
        """One upload per tick: tables, pending tokens, lens, then (lane,
        page, offset) of each live lane's next row. Returns the device
        tables, tokens, lens and the three row-index vectors."""
        lanes, ps, P = self.config.lanes, self.config.page_size, self._pages_per_seq
        toks = np.zeros(lanes, np.int32)
        for i in live:
            toks[i] = self._lanes[i].ticket.tokens[-1]
        pos = self._lens[live]
        host = np.concatenate([
            self._page_tables.reshape(-1), toks, self._lens,
            np.asarray(live, np.int32), self._page_tables[live, pos // ps], pos % ps,
        ])
        dev = self._upload(host)
        n = len(live)
        w = dev[lanes * P + 2 * lanes :].long()
        return (dev[: lanes * P].view(lanes, P), dev[lanes * P : lanes * P + lanes],
                dev[lanes * P + lanes : lanes * P + 2 * lanes], w[:n], w[n : 2 * n], w[2 * n :])

    def step(self) -> int:
        """One engine tick: preempt expired lanes, admit pending prefills,
        advance one chunked prefill, then one decode step (or one
        speculative tick) across every live lane at the full lane width.
        Returns the number of tokens emitted."""
        self._preempt_expired()
        self._admit()
        self._advance_prefills()
        live = [i for i, ln in enumerate(self._lanes) if ln is not None and not ln.prefilling]
        DECODE_METRICS.set_active_lanes(len(live))
        if not live:
            return 0
        if self.config.spec_tokens:
            return self._spec_tick(live)
        # captured before the commit loop finishes lanes (a finished lane's
        # journey still belongs to this tick's step span)
        lane_tickets = [self._lanes[i].ticket for i in live]
        w0 = _time.monotonic()
        tables_d, toks_d, lens_d, w_lane, w_page, w_off = self._step_upload(live)
        ctx_lens = lens_d + 1
        pool, att, heads = self.pool, self._attention, self.model_cfg.num_heads

        def attend(layer, q, k_new, v_new):
            pool.k[layer, w_page, w_off] = k_new[w_lane]
            pool.v[layer, w_page, w_off] = v_new[w_lane]
            return att(q, pool.k[layer], pool.v[layer], tables_d, ctx_lens, n_heads=heads)

        with torch.no_grad(), CHIP_LEDGER.timed("decode", device=self.device):
            logits = _step_logits_math(self.params, self.model_cfg, toks_d, lens_d, attend)
            if self.config.temperature > 0:
                # counter-based draws (ticket key x stream position)
                logits = logits.cpu().numpy()
                nxt = np.zeros(self.config.lanes, np.int64)
                for i in live:
                    t = self._lanes[i].ticket
                    nxt[i] = _sample_token(logits[i], self.config, t.sample_key, len(t.tokens))
            else:
                nxt = _argmax(logits).cpu().numpy()
        wall = _time.monotonic() - w0
        # ---- the point of no state: the step's K/V rows sit at each lane's
        # ``lens``, masked until the commit below moves it (time = the step
        # counter, so plans can target the Nth step) ----
        chaos.inject("decode.step", time=self.steps)
        # ---- commit ----
        emitted = 0
        for i in live:
            lane = self._lanes[i]
            self._lens[i] += 1
            lane.ticket.tokens.append(int(nxt[i]))
            emitted += 1
            if len(lane.ticket.tokens) >= lane.ticket.max_new:
                self._finish(i)
        self.steps += 1
        DECODE_METRICS.record_step(emitted, wall)
        flight_recorder.record("decode.step", batch=len(live), tokens=emitted, wall_ms=round(wall * 1000.0, 3))
        self._step_span(lane_tickets, w0, wall, step=self.steps - 1, batch=len(live), tokens=emitted)
        return emitted

    @staticmethod
    def _step_span(lane_tickets, w0: float, wall: float, **attrs) -> None:
        """One fused tick serves N lanes: its ``decode_step`` span gets a
        trace of its own that links every member request's journey."""
        from ..tracing import record_span, tracing_enabled

        if not tracing_enabled():
            return
        lane_traces = tuple(sorted({m.trace_id for t in lane_tickets for m in _members(t.trace)}))
        if lane_traces:
            record_span("decode_step", start_mono=w0, end_mono=w0 + wall, new_trace=True, links=lane_traces,
                        **attrs)

    def _spec_tick(self, live) -> int:
        """One speculative tick: the draft proposes ``spec_tokens`` tokens
        per lane, the full target verifies the chain in one batched forward,
        and the longest matching prefix (plus the target's bonus token)
        commits. Every committed token is the target's own argmax given the
        same context, so the stream is the single-token stream."""
        k_spec = self.config.spec_tokens
        lanes, ps = self.config.lanes, self.config.page_size
        toks = np.zeros(lanes, np.int64)
        for i in live:
            toks[i] = self._lanes[i].ticket.tokens[-1]
        lane_tickets = [self._lanes[i].ticket for i in live]
        w0 = _time.monotonic()
        host = np.concatenate([self._page_tables.reshape(-1).astype(np.int64), self._lens.astype(np.int64), toks])
        dev = self._upload(host)
        n_tab = lanes * self._pages_per_seq
        pt, lens, tk = dev[:n_tab].view(lanes, -1), dev[n_tab : n_tab + lanes], dev[n_tab + lanes :]
        with torch.no_grad():
            with CHIP_LEDGER.timed("decode.draft", device=self.device):
                if self.config.draft_ngram:
                    # prompt-lookup draft: proposals copied from the lane's own
                    # history, no device work
                    dr = np.zeros((k_spec, lanes), np.int64)
                    for i in live:
                        t = self._lanes[i].ticket
                        dr[:, i] = _prompt_lookup(t.prompt + t.tokens, self.config.draft_ngram, k_spec)
                    drafts = self._upload(dr)
                else:
                    drafts = _draft_math(self.params, self.model_cfg, self.pool.k, self.pool.v, pt, lens, tk,
                                         page_size=ps, spec_tokens=k_spec, draft_layers=self._draft_layers)
            with CHIP_LEDGER.timed("decode.verify", device=self.device):
                # verify output j is the target's argmax at position lens + j,
                # trustworthy iff every earlier proposal matched
                inputs = torch.cat([tk[None], drafts[:-1]], dim=0).T
                targets = _verify_math(self.params, self.model_cfg, self.pool.k, self.pool.v, pt, lens, inputs,
                                       page_size=ps)
            both = torch.stack([drafts, targets]).cpu().numpy()
        drafts, targets = both[0], both[1]
        wall = _time.monotonic() - w0
        # ---- the point of no state (as in the greedy step): the verify's
        # rows sit at lens .. lens + spec_tokens - 1 ----
        chaos.inject("decode.step", time=self.steps)
        # ---- commit ----
        emitted = proposed = accepted = 0
        for i in live:
            lane = self._lanes[i]
            a = 0
            while a < k_spec and drafts[a][i] == targets[a][i]:
                a += 1
            proposed += k_spec
            accepted += a
            # a matched proposals commit, plus the target's bonus token
            c = a + 1 if a < k_spec else k_spec
            c = min(c, lane.ticket.max_new - len(lane.ticket.tokens))
            self._lens[i] += c
            lane.ticket.tokens.extend(int(targets[j][i]) for j in range(c))
            emitted += c
            if len(lane.ticket.tokens) >= lane.ticket.max_new:
                self._finish(i)
        self.steps += 1
        DECODE_METRICS.record_step(emitted, wall)
        DECODE_METRICS.record_spec(proposed, accepted)
        flight_recorder.record("decode.step", batch=len(live), tokens=emitted, wall_ms=round(wall * 1000.0, 3),
                               proposed=proposed, accepted=accepted)
        self._step_span(lane_tickets, w0, wall, step=self.steps - 1, batch=len(live), tokens=emitted,
                        proposed=proposed, accepted=accepted)
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


class DecodeService:
    """Deadline-aware front door: the serving plane's ``AdaptiveBatcher``
    coalesces decode queries, drops the ones whose deadline expired while
    queued, and yields the ingest stream's ``query_share`` between fused
    dispatches. The dispatch runs on the batcher's thread: an exception
    there stops the service and is kept in ``error``."""

    def __init__(self, engine: DecodeEngine, *, config=None):
        from ..serving.batching import AdaptiveBatcher

        self.engine = engine
        self._batcher = AdaptiveBatcher(self._dispatch, config=config, name="decode", on_expired=self._expired)

    def submit(self, prompt_ids, *, deadline=None, max_new_tokens: int | None = None,
               degraded: bool = False) -> DecodeTicket:
        ticket = self.engine.make_ticket(prompt_ids, max_new_tokens=max_new_tokens, deadline=deadline,
                                         degraded=degraded)
        self._batcher.submit(ticket, deadline)
        return ticket

    def _dispatch(self, items) -> None:
        for ticket in items:
            self.engine.enqueue(ticket)
        self.engine.drain()

    @staticmethod
    def _expired(ticket) -> None:
        DECODE_METRICS.record_preempt()
        ticket.preempted = True
        ticket.done.set()

    def stop(self) -> None:
        self._batcher.stop()

    @property
    def error(self):
        return self._batcher.error
