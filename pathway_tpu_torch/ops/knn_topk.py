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

:func:`knn_topk_sharded` ports ``pallas_knn.py::knn_topk_sharded`` for a
slab cut into equal shards on several devices (the mesh index): the same
two passes per shard on its device, the merge writing global indices, and
one more merge launch over the ``[q, n_shards, k]`` candidates.
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


def _topk_into(queries, docs, bias, *, k: int, factor: float, regime: str | None, out_s, out_i, base: int = 0):
    """Launch the partial pass and the merge of ``queries`` x ``docs`` on
    their device, which must be the current one (``ctypes`` launches run
    there), on its current stream; the merged lists land in the rows of
    ``out_s`` / ``out_i`` (row stride ``out_s.stride(0)``, which may exceed
    k), live indices shifted by ``base``."""
    nq, dim = queries.shape
    nd = docs.shape[0]
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
        part_s.data_ptr(), part_i.data_ptr(), nq, plan.splits, k, int(base), out_s.stride(0), out_s.data_ptr(),
        out_i.data_ptr(), stream,
    )
    _build.check(err, "knn_topk_merge")
    _build.LAUNCHES["knn_topk_merge"] += 1


def _check_operands(queries, docs, bias, k: int):
    """The kernels' operand rules: f32, contiguous, aligned, k <= 64,
    docs and bias on one device."""
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"knn_topk kernel takes 1 <= k <= {KERNEL_MAX_K}, got {k}")
    _build.require(queries, dtype=torch.float32, ndim=2, name="queries")
    _build.require(docs, dtype=torch.float32, ndim=2, name="docs")
    _build.require(bias, dtype=torch.float32, ndim=1, name="bias")
    if docs.shape[1] != queries.shape[1]:
        raise ValueError(f"queries dim {queries.shape[1]} != docs dim {docs.shape[1]}")
    if bias.shape[0] != docs.shape[0] or bias.device != docs.device:
        raise ValueError("bias must be [N] on the docs' device")


def knn_topk(queries, docs, *, k: int, bias=None, factor: float = 1.0, regime: str | None = None):
    """queries [Q, D] x docs [N, D] (+ bias [N]) -> (scores [Q, k] f32,
    indices [Q, k] int32). CUDA tensors launch a partial pass chosen by
    :func:`launch_plan` (``regime`` forces one) and the merge pass (f32,
    k <= 64) or raise; CPU tensors take :func:`knn_topk_reference`."""
    if not queries.is_cuda:
        return knn_topk_reference(queries, docs, k=k, bias=bias, factor=factor)
    if bias is None:
        bias = torch.zeros((docs.shape[0],), dtype=torch.float32, device=docs.device)
    _check_operands(queries, docs, bias, k)
    if docs.device != queries.device:
        raise ValueError("queries and docs must lie on one device")
    nq = queries.shape[0]
    out_s = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    if nq:
        with torch.cuda.device(queries.device):
            _topk_into(queries, docs, bias, k=k, factor=factor, regime=regime, out_s=out_s, out_i=out_i)
    return out_s, out_i


# ---------------------------------------------------------------- sharded


def knn_topk_sharded_reference(queries, doc_shards, bias_shards, *, k: int, factor: float = 1.0):
    """Plain version of :func:`knn_topk_sharded`, on any device:
    :func:`knn_topk_reference` per shard, live indices shifted by
    ``shard * shard_len`` (-1 kept), and :func:`_merge_candidates_reference`
    over the shard-major concatenation; on the first shard's device."""
    dev0 = doc_shards[0].device
    rows = doc_shards[0].shape[0]
    vals, idx = [], []
    for s, (docs, bias) in enumerate(zip(doc_shards, bias_shards)):
        v, i = knn_topk_reference(queries.to(docs.device), docs, k=k, bias=bias, factor=factor)
        vals.append(v.to(dev0))
        idx.append(torch.where(i >= 0, i + s * rows, -1).to(dev0))
    return _merge_candidates_reference(torch.stack(vals, dim=1), torch.stack(idx, dim=1), k)


def _merge_candidates_reference(cand_s, cand_i, k: int):
    """Plain cross-shard merge: a stable descending sort of the flattened
    [q, n_shards, k] candidates (ties to the lower position of the
    shard-major order, which is the lower global row), cut to k."""
    nq = cand_s.shape[0]
    vals, order = torch.sort(cand_s.reshape(nq, -1), dim=1, descending=True, stable=True)
    return vals[:, :k], cand_i.reshape(nq, -1).gather(1, order[:, :k])


def merge_shard_candidates(cand_s, cand_i, k: int):
    """The cross-shard merge of :func:`knn_topk_sharded`: [q, n_shards, k]
    candidates with global indices -> the [q, k] top-k, ties to the lower
    global index. On CUDA one ``knn_merge_kernel`` launch (key
    ``knn_topk_sharded_merge``); on the CPU :func:`_merge_candidates_reference`."""
    nq, n_shards = cand_s.shape[0], cand_s.shape[1]
    if not cand_s.is_cuda:
        return _merge_candidates_reference(cand_s, cand_i, k)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=cand_s.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=cand_s.device)
    if nq:
        with torch.cuda.device(cand_s.device):
            err = _build.library("knn_topk.cu").pt_knn_topk_merge(
                cand_s.data_ptr(), cand_i.data_ptr(), nq, n_shards, k, 0, k, out_s.data_ptr(), out_i.data_ptr(),
                _build.stream_handle(cand_s),
            )
        _build.check(err, "knn_topk_sharded_merge")
        _build.LAUNCHES["knn_topk_sharded_merge"] += 1
    return out_s, out_i


def knn_topk_sharded(queries, doc_shards, bias_shards, *, k: int, factor: float = 1.0, regime: str | None = None):
    """Port of ``pathway_tpu/ops/pallas_knn.py::knn_topk_sharded``: the
    top-k of ``factor * (queries @ docs.T) + bias`` over a slab cut into
    equal shards, shard ``s`` holding global rows ``[s * L, (s + 1) * L)``
    on its own device -> (scores [Q, k] f32, indices [Q, k] int32) on the
    first shard's device. Ties go to the lower global row.

    On CUDA each shard runs B2's partial pass (:func:`launch_plan`) and its
    merge on its device and current stream (the queries copied there once),
    the merge writing global indices into the shard's k columns of a
    [Q, n_shards, k] block on the first shard's device: a shard on that
    device writes them in place, one on another card into a tensor of its
    own that is copied over (PyTorch's copy between cards records an event
    on the source's stream that the destination's stream waits on). Every
    shard's launches are issued before anything waits; then
    :func:`merge_shard_candidates` folds the block. CPU shards take
    :func:`knn_topk_sharded_reference`."""
    if not doc_shards or len(doc_shards) != len(bias_shards):
        raise ValueError("knn_topk_sharded takes one bias per doc shard, at least one shard")
    rows = doc_shards[0].shape[0]
    if any(d.shape[0] != rows for d in doc_shards):
        raise ValueError("knn_topk_sharded takes shards of equal length")
    if not doc_shards[0].is_cuda:
        return knn_topk_sharded_reference(queries, doc_shards, bias_shards, k=k, factor=factor)
    dev0 = doc_shards[0].device
    for docs, bias in zip(doc_shards, bias_shards):
        if not docs.is_cuda:
            raise ValueError("knn_topk_sharded takes every shard on a CUDA device, or every shard on the CPU")
        _check_operands(queries, docs, bias, k)
    nq, n_shards = queries.shape[0], len(doc_shards)
    cand_s = torch.empty((nq, n_shards, k), dtype=torch.float32, device=dev0)
    cand_i = torch.empty((nq, n_shards, k), dtype=torch.int32, device=dev0)
    if nq == 0:
        return merge_shard_candidates(cand_s, cand_i, k)
    # the copies between cards come first (queries) and last (results): a
    # copy makes each side's stream wait for the other's earlier work, so
    # one between two shards' launches would run the shards one after another
    on_device = {dev: queries.to(dev).contiguous() for dev in {d.device for d in doc_shards}}
    remote = []
    for s, (docs, bias) in enumerate(zip(doc_shards, bias_shards)):
        dev = docs.device
        with torch.cuda.device(dev):
            if dev == dev0:
                _topk_into(on_device[dev], docs, bias, k=k, factor=factor, regime=regime,
                           out_s=cand_s[:, s], out_i=cand_i[:, s], base=s * rows)
            else:
                own_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
                own_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
                _topk_into(on_device[dev], docs, bias, k=k, factor=factor, regime=regime,
                           out_s=own_s, out_i=own_i, base=s * rows)
                remote.append((s, own_s, own_i))
    for s, own_s, own_i in remote:
        cand_s[:, s].copy_(own_s, non_blocking=True)
        cand_i[:, s].copy_(own_i, non_blocking=True)
    return merge_shard_candidates(cand_s, cand_i, k)
