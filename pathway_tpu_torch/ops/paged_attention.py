"""Decode-step attention over a paged KV pool, and the pool itself.

Port of ``pathway_tpu/ops/paged_attention.py`` (kernel B5,
``paged_decode_attention`` / ``_paged_kernel``). Every in-flight
sequence keeps its KV cache in fixed-size pages of one preallocated pool
and owns a page table, the pool slots that hold its context in order; a
decode step attends one query token per sequence against that context.

On a CUDA tensor ``paged_decode_attention`` launches
``csrc/paged_decode_attention.cu``, split over the context
(flash-decoding): one block per (sequence, head, split of
:func:`decode_split_plan`'s ``chunk`` positions) that reads its own table
row and length, loads only live rows (all of them in flight at once) and
keeps an unnormalised softmax, then, when the context spans more than one
split, a log-sum-exp combine launch. The TPU kernel's gather buffer and
zero-fill are gone. It takes any head dim up to ``MAX_HEAD_DIM``. Its plain
version, :func:`paged_attention_reference`, gathers the pages into a
contiguous context and runs :func:`dense_decode_attention`. Positions at
or past a sequence's length get the additive ``KEY_OFF``, whose softmax
weight underflows to exactly 0; rows of length 0 are exact zeros.

The TPU kernel is bitwise equal to its reference under one compiler;
the CUDA kernel sums in another order and is held to the plain version at
f32 1e-4.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from . import _build
from .fused_attention import KEY_OFF

MAX_HEAD_DIM = 256  # widest head the kernel takes
_SPLIT_POSITIONS = 64  # context positions a split covers (whole pages up to this page size)


def pages_for(length: int, page_size: int) -> int:
    """Number of fixed-size pages covering ``length`` context tokens."""
    return max(0, (int(length) + page_size - 1) // page_size)


def decode_split_plan(pages_per_seq: int, page_size: int) -> tuple[int, int]:
    """(positions per split, splits) of the kernel's context split: whole
    pages, as many as fit in 64 positions (64 positions when a page is
    larger, so such a page spans splits), over a context of
    ``pages_per_seq`` pages."""
    if page_size <= _SPLIT_POSITIONS:
        chunk = page_size * (_SPLIT_POSITIONS // page_size)
    else:
        chunk = _SPLIT_POSITIONS
    return chunk, max(1, -(-(pages_per_seq * page_size) // chunk))


def dense_decode_attention(q, k_ctx, v_ctx, lens, *, n_heads: int, scale=None):
    """One query token per sequence over a contiguous context. ``q``: [B, d]
    · ``k_ctx``/``v_ctx``: [B, ctx, d] · ``lens``: [B]. Returns [B, d]
    float32; rows with ``lens == 0`` are exactly zero. Per-row math only:
    no value of one row reaches another."""
    b, d = q.shape
    hd = d // n_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    ctx = k_ctx.shape[1]
    qh = q.float().reshape(b, n_heads, 1, hd)
    kh = k_ctx.float().reshape(b, ctx, n_heads, hd).transpose(1, 2)
    vh = v_ctx.float().reshape(b, ctx, n_heads, hd).transpose(1, 2)
    lens = lens.to(device=q.device, dtype=torch.int64)
    bias = torch.where(torch.arange(ctx, device=q.device)[None, :] < lens[:, None], 0.0, KEY_OFF)
    s = (qh @ kh.transpose(-1, -2)) * scale + bias[:, None, None, :].float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = (p @ vh).reshape(b, d)
    return torch.where((lens > 0)[:, None], out, 0.0)


def paged_attention_reference(q, k_pages, v_pages, page_tables, lens, *, n_heads: int, scale=None):
    """Plain version of the kernel: gather each sequence's context out of
    its pages (table entries clamped to the pool), then
    :func:`dense_decode_attention`."""
    n_pages, page_size, d = k_pages.shape
    b, pages_per_seq = page_tables.shape
    pt = page_tables.to(device=k_pages.device, dtype=torch.int64).clamp(0, n_pages - 1)
    k_ctx = k_pages[pt].reshape(b, pages_per_seq * page_size, d)
    v_ctx = v_pages[pt].reshape(b, pages_per_seq * page_size, d)
    return dense_decode_attention(q, k_ctx, v_ctx, lens, n_heads=n_heads, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, page_tables, lens, *, n_heads: int, scale=None):
    """Paged-KV decode attention. ``q``: [B, d] · ``k_pages``/``v_pages``:
    [n_pages, page_size, d] (one layer of the pool) · ``page_tables``: [B, P]
    int32 (entries past ``pages_for(lens[b])`` are never read) · ``lens``:
    [B] int32. Returns [B, d] float32. CUDA tensors launch the kernel (f32,
    head dim up to 256) and, past one split, its combine, or raise; CPU
    tensors take :func:`paged_attention_reference`."""
    if not q.is_cuda:
        return paged_attention_reference(q, k_pages, v_pages, page_tables, lens, n_heads=n_heads, scale=scale)
    _build.require(q, dtype=torch.float32, ndim=2, name="q")
    _build.require(k_pages, dtype=torch.float32, ndim=3, name="k_pages")
    _build.require(v_pages, dtype=torch.float32, ndim=3, name="v_pages")
    _build.require(page_tables, dtype=torch.int32, ndim=2, name="page_tables")
    _build.require(lens, dtype=torch.int32, ndim=1, name="lens")
    b, d = q.shape
    n_pages, page_size, dk = k_pages.shape
    pages_per_seq = page_tables.shape[1]
    if n_heads < 1 or d % n_heads or d // n_heads > MAX_HEAD_DIM:
        raise ValueError(
            f"paged_decode_attention takes head dims up to {MAX_HEAD_DIM} (d divisible by the heads), "
            f"got d {d} / {n_heads} heads"
        )
    if (
        dk != d
        or tuple(v_pages.shape) != tuple(k_pages.shape)
        or page_tables.shape[0] != b
        or lens.shape[0] != b
        or len({t.device for t in (q, k_pages, v_pages, page_tables, lens)}) != 1
    ):
        raise ValueError("paged_decode_attention: operand shapes or devices disagree")
    hd = d // n_heads
    out = torch.empty((b, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    chunk, splits = decode_split_plan(pages_per_seq, page_size)
    partials = torch.empty((b * n_heads * splits * (hd + 2) if splits > 1 else 1,), dtype=torch.float32,
                           device=q.device)
    err = _build.library("paged_decode_attention.cu").pt_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_tables.data_ptr(), lens.data_ptr(),
        out.data_ptr(), partials.data_ptr(), b, d, n_pages, page_size, pages_per_seq, hd, chunk,
        float(1.0 / math.sqrt(hd) if scale is None else scale), _build.stream_handle(q),
    )
    _build.check(err, "paged_decode_attention")
    _build.LAUNCHES["paged_decode_attention"] += 1
    if splits > 1:  # the entry point launched the combine after the splits
        _build.LAUNCHES["paged_decode_combine"] += 1
    return out


class PagedKvPool:
    """A preallocated K+V page pool plus its host-side free list.

    Device state is two tensors ``[layers, n_pages, page_size, dim]`` f32;
    the decode engine writes new rows into them in place. The allocator is
    host bookkeeping: a LIFO free list (recently freed pages are reused
    first), and ``alloc`` returning ``None`` is the backpressure signal.
    Pages are refcounted so one physical page can sit in several page
    tables: ``alloc`` grants at refcount 1, ``share`` adds a holder, ``free``
    drops one, and the page returns to the free list at zero."""

    @property
    def sentinel(self) -> int:
        """Page-table entry of an unused slot: one past the pool."""
        return self.n_pages

    def __init__(self, *, layers: int, dim: int, n_pages: int, page_size: int, dtype=torch.float32, device=None):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("paged kv pool: n_pages and page_size must be positive")
        self.device = resolve_device(device)
        self.layers = layers
        self.dim = dim
        self.n_pages = n_pages
        self.page_size = page_size
        self.k = torch.zeros((layers, n_pages, page_size, dim), dtype=dtype, device=self.device)
        self.v = torch.zeros((layers, n_pages, page_size, dim), dtype=dtype, device=self.device)
        self._free = list(range(n_pages - 1, -1, -1))
        self._refs: dict[int, int] = {}

    @property
    def pages_in_use(self) -> int:
        """Physical pages allocated; a shared page counts once."""
        return self.n_pages - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pool_bytes(self) -> int:
        return self.k.numel() * self.k.element_size() + self.v.numel() * self.v.element_size()

    def refcount(self, page) -> int:
        return self._refs.get(int(page), 0)

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages at refcount 1, or ``None`` (taking nothing) if
        the pool cannot cover the request: never a partial grant."""
        if n < 0:
            raise ValueError("paged kv pool: cannot allocate a negative page count")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages) -> None:
        """Add one holder to each (already allocated) page."""
        for p in pages:
            if int(p) not in self._refs:
                raise ValueError(f"paged kv pool: cannot share unallocated page {int(p)}")
        for p in pages:
            self._refs[int(p)] += 1

    def free(self, pages) -> None:
        """Drop one holder from each page; physically free at zero."""
        for p in pages:
            p = int(p)
            if not 0 <= p < self.n_pages:
                raise ValueError(f"paged kv pool: page {p} is not in the pool")
            if p not in self._refs:
                raise ValueError(f"paged kv pool: double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
