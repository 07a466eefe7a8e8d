"""Fused KNN scores + top-k.

Port of ``pathway_tpu/ops/pallas_knn.py::knn_topk`` (kernel B2, ``_kernel``
/ ``_merge_topk``): the top-k of ``factor * (queries @ docs.T) + bias``
without materialising the [Q, N] score matrix. ``bias`` carries ``NEG``
for dead index slots and ``-|doc|^2`` for L2 (factor 2). Ties go to the
lower doc index; candidates scored at or below ``NEG / 2`` return index -1
and score ``NEG``.

The TPU carries a running top-k across a sequential doc axis; Hopper has
no such axis, so ``csrc/knn_topk.cu`` runs a split-N partial pass (each
block scores one doc range and keeps per-query top-k lists) and a merge
pass over the ``[q, splits, k]`` partials. :func:`launch_plan` picks the
partial pass from the number of queries: up to ``SMALL_Q_MAX`` the
bytes-bound streaming kernel (f32 FMAs, the queries held on chip, the
docs streamed once through a ``cp.async`` ring, one block per SM), above
it the tensor-core kernel (3xTF32 ``wgmma`` fed by TMA, 64 queries x 128
docs a tile). The kernels take k <= 64, the widths the index sends them
(``ops/knn.py``); wider k on a CUDA tensor raises.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build

NEG = -3.0e38  # sentinel below any real score

KERNEL_MAX_K = 64
# Queries up to which the streaming kernel runs; above it the tensor-core
# kernel. At q = 16 the two were timed side by side on the card (PERF.md).
SMALL_Q_MAX = 16
_SMEM_MAX = 232_448  # dynamic shared memory a block may take on Hopper
_ST_TN = 32  # docs per tile of the streaming kernel
_ST_STAGES = 4  # most ring tiles of the streaming kernel
_TC_BQ = 64  # queries per block of the tensor-core kernel
_TC_BN = 128  # docs per tile of the tensor-core kernel


def knn_topk_reference(queries, docs, *, k: int, bias=None, factor: float = 1.0):
    """Plain version: full scores, a stable descending sort (ties to the
    lower index), dead candidates -> (NEG, -1), padded to k columns."""
    q = queries.float()
    d = docs.float()
    scores = (q @ d.T) * factor
    if bias is not None:
        scores = scores + bias.float()[None, :]
    dead = scores <= NEG / 2
    scores = scores.masked_fill(dead, NEG)
    kk = min(k, scores.shape[1])
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk].to(torch.int32)
    idx = torch.where(vals <= NEG / 2, -1, idx)
    if kk < k:
        pad = k - kk
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), NEG)], dim=1)
        idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], dim=1)
    return vals, idx


def topk_agreement(vals_a, idx_a, vals_b, idx_b, *, atol: float, rtol: float = 0.0) -> tuple[float, bool]:
    """Compare two top-k results of the same inputs computed with sums in
    different orders: -> (share of positions with equal indices, whether
    they agree). They agree when the scores match position by position
    within tolerance and every index found by only one side scores within
    tolerance of the k-th score (a near-tie at the boundary, which f32
    rounding may decide either way); swaps inside the list are then
    near-ties too."""
    va, vb = vals_a.double().cpu(), vals_b.double().cpu()
    ia, ib = idx_a.long().cpu(), idx_b.long().cpu()
    same = float((ia == ib).double().mean()) if ia.numel() else 1.0
    tol = atol + rtol * vb.abs()
    if not bool(((va - vb).abs() <= tol).all()):
        return same, False
    for r in range(ia.shape[0]):
        only_a = set(ia[r].tolist()) ^ set(ib[r].tolist())
        if not only_a:
            continue
        kth = float(vb[r, -1])
        lim = atol + rtol * abs(kth)
        scores = dict(zip(ia[r].tolist(), va[r].tolist())) | dict(zip(ib[r].tolist(), vb[r].tolist()))
        if any(abs(scores[i] - kth) > lim for i in only_a):
            return same, False
    return same, True


@dataclasses.dataclass(frozen=True)
class KnnPlan:
    """How one call splits its work: the partial pass (``"stream"`` or
    ``"tc"``), its doc tile, and ``splits`` blocks' worth of doc ranges of
    ``tiles_per_split`` tiles each (the last one shorter, none empty);
    ``stages`` is the streaming kernel's ring depth (0 for ``"tc"``)."""

    regime: str
    tile: int
    splits: int
    tiles_per_split: int
    stages: int


def _stream_stages(nq: int, dim: int) -> int:
    """Ring tiles the streaming kernel fits in shared memory next to its
    queries (held as the next power of two) and candidate buffers; below
    2 it cannot run at this width. Mirrors ``launch_stream`` in the source."""
    nqt = 1 << (max(nq, 1) - 1).bit_length()
    fixed = 4 * (nqt * dim + 2 * nqt * _ST_TN + 2 * nqt)
    return min(_ST_STAGES, (_SMEM_MAX - fixed) // (4 * _ST_TN * (dim + 1)))


def launch_plan(nq: int, nd: int, sm_count: int, *, dim: int = 384, regime: str | None = None) -> KnnPlan:
    """The partial pass and its splits for ``nq`` queries against ``nd``
    docs of width ``dim`` on a card of ``sm_count`` SMs. Up to
    ``SMALL_Q_MAX`` queries (and a width whose ring fits) the streaming
    kernel runs one block per SM; above, the tensor-core kernel runs a grid
    of (query tiles of 64, splits) with at most one block per SM, so each
    query merges few, long splits. Its TMA loads need a width that is a
    multiple of 4; at any other width the streaming kernel takes every
    query count, ``SMALL_Q_MAX`` queries a launch. ``regime`` forces one of
    the two (the card's tests and the chip script time both at the
    boundary)."""
    stages = _stream_stages(min(nq, SMALL_Q_MAX), dim)
    if regime is None:
        regime = "stream" if stages >= 2 and (nq <= SMALL_Q_MAX or dim % 4) else "tc"
    if regime == "stream":
        if stages < 2:
            raise ValueError(f"the streaming knn_topk kernel cannot hold {SMALL_Q_MAX} queries of width {dim}")
        tile, want = _ST_TN, sm_count
    elif regime == "tc":
        if dim % 4:
            raise ValueError(f"the tensor-core knn_topk kernel takes widths that are multiples of 4, got {dim}")
        tile, want, stages = _TC_BN, max(1, sm_count // -(-nq // _TC_BQ)), 0
    else:
        raise ValueError(f"unknown knn_topk regime {regime!r}")
    tiles = max(1, -(-nd // tile))
    per = -(-tiles // min(max(1, want), tiles))
    return KnnPlan(regime, tile, -(-tiles // per), per, stages)


def knn_topk(queries, docs, *, k: int, bias=None, factor: float = 1.0, regime: str | None = None):
    """queries [Q, D] x docs [N, D] (+ bias [N]) -> (scores [Q, k] f32,
    indices [Q, k] int32). CUDA tensors launch a partial pass chosen by
    :func:`launch_plan` (``regime`` forces one) and the merge pass (f32,
    k <= 64) or raise; CPU tensors take :func:`knn_topk_reference`."""
    if not queries.is_cuda:
        return knn_topk_reference(queries, docs, k=k, bias=bias, factor=factor)
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"knn_topk kernel takes 1 <= k <= {KERNEL_MAX_K}, got {k}")
    _build.require(queries, dtype=torch.float32, ndim=2, name="queries")
    _build.require(docs, dtype=torch.float32, ndim=2, name="docs")
    nq, dim = queries.shape
    nd = docs.shape[0]
    if docs.shape[1] != dim:
        raise ValueError(f"queries dim {dim} != docs dim {docs.shape[1]}")
    if bias is None:
        bias = torch.zeros((nd,), dtype=torch.float32, device=docs.device)
    _build.require(bias, dtype=torch.float32, ndim=1, name="bias")
    if bias.shape[0] != nd or docs.device != queries.device or bias.device != queries.device:
        raise ValueError("bias must be [N] and every operand on one device")
    out_s = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    if nq == 0:
        return out_s, out_i
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    plan = launch_plan(nq, nd, sms, dim=dim, regime=regime)
    part_s = torch.empty((nq, plan.splits, k), dtype=torch.float32, device=queries.device)
    part_i = torch.empty((nq, plan.splits, k), dtype=torch.int32, device=queries.device)
    lib = _build.library("knn_topk.cu")
    stream = _build.stream_handle(queries)
    name = f"knn_topk_{plan.regime}"
    if plan.regime == "tc":
        err = lib.pt_knn_topk_tc(
            queries.data_ptr(), docs.data_ptr(), bias.data_ptr(), float(factor), nq, nd, dim, k, plan.splits,
            plan.tiles_per_split, part_s.data_ptr(), part_i.data_ptr(), stream,
        )
        _build.check(err, name)
        _build.LAUNCHES[name] += 1
    for g0 in range(0, nq, SMALL_Q_MAX) if plan.regime == "stream" else ():
        g1 = min(nq, g0 + SMALL_Q_MAX)  # past one group only at a width TMA cannot take
        err = lib.pt_knn_topk_stream(
            queries[g0:g1].data_ptr(), docs.data_ptr(), bias.data_ptr(), float(factor), g1 - g0, nd, dim, k,
            plan.splits, plan.tiles_per_split, plan.stages, part_s[g0:g1].data_ptr(), part_i[g0:g1].data_ptr(),
            stream,
        )
        _build.check(err, name)
        _build.LAUNCHES[name] += 1
    err = lib.pt_knn_topk_merge(
        part_s.data_ptr(), part_i.data_ptr(), nq, plan.splits, k, out_s.data_ptr(), out_i.data_ptr(), stream
    )
    _build.check(err, "knn_topk_merge")
    _build.LAUNCHES["knn_topk_merge"] += 1
    return out_s, out_i
