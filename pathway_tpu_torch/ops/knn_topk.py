"""Fused KNN scores + top-k.

Port of ``pathway_tpu/ops/pallas_knn.py::knn_topk`` (kernel B2, ``_kernel``
/ ``_merge_topk``): the top-k of ``factor * (queries @ docs.T) + bias``
without materialising the [Q, N] score matrix. ``bias`` carries ``NEG``
for dead index slots and ``-|doc|^2`` for L2 (factor 2). Ties go to the
lower doc index; candidates scored at or below ``NEG / 2`` return index -1
and score ``NEG``.

The TPU carries a running top-k across a sequential doc axis; Hopper has
no such axis, so ``csrc/knn_topk.cu`` runs a split-N pass (each block
scores a doc range in f32 and keeps per-query top-k lists in registers)
and a merge pass over the ``[q, splits, k]`` partials. The kernel takes
k <= 64, the widths the index sends it (``ops/knn.py``); wider k on a
CUDA tensor raises.
"""

from __future__ import annotations

import torch

from . import _build

NEG = -3.0e38  # sentinel below any real score

KERNEL_MAX_K = 64
_TQ = 64  # queries per block of the partial pass
_TN = 64  # docs per tile of the partial pass
_BLOCKS_PER_SM = 8  # partial-pass blocks to aim for per SM


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


def _splits(nq: int, nd: int, device) -> tuple[int, int]:
    tiles = max(1, -(-nd // _TN))
    qtiles = max(1, -(-nq // _TQ))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-(_BLOCKS_PER_SM * sms) // qtiles))
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per


def knn_topk(queries, docs, *, k: int, bias=None, factor: float = 1.0):
    """queries [Q, D] x docs [N, D] (+ bias [N]) -> (scores [Q, k] f32,
    indices [Q, k] int32). CUDA tensors launch the two-pass kernel (f32,
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
    splits, per = _splits(nq, nd, queries.device)
    part_s = torch.empty((nq, splits, k), dtype=torch.float32, device=queries.device)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=queries.device)
    lib = _build.library("knn_topk.cu")
    stream = _build.stream_handle(queries)
    err = lib.pt_knn_topk_partial(
        queries.data_ptr(), docs.data_ptr(), bias.data_ptr(), float(factor), nq, nd, dim, k,
        splits, per, part_s.data_ptr(), part_i.data_ptr(), stream,
    )
    _build.check(err, "knn_topk_partial")
    _build.LAUNCHES["knn_topk_partial"] += 1
    err = lib.pt_knn_topk_merge(
        part_s.data_ptr(), part_i.data_ptr(), nq, splits, k, out_s.data_ptr(), out_i.data_ptr(), stream
    )
    _build.check(err, "knn_topk_merge")
    _build.LAUNCHES["knn_topk_merge"] += 1
    return out_s, out_i
