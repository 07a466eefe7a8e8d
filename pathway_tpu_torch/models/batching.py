"""Bucketed batching for jit-compiled models.

Stream delta batches have ragged sizes/lengths; XLA wants static shapes.
Strategy (SURVEY.md §7 hard part 3): round batch and sequence dims up to
a small set of power-of-two buckets so the jit cache stays tiny, pad
with masked rows, and slice the padding off on the host. The same
discipline the reference gets implicitly from torch dynamic shapes —
but here every unique bucket compiles once and then runs from cache.
"""

from __future__ import annotations

import numpy as np

# Intermediate buckets (48/96 below 128; 160/192/224 between 128 and
# 256; 320/384/448 between 256 and 512) bound the worst-case pad tax of
# a sorted length-group to the gap to the next bucket — the old coarse
# set sent TokenCountSplitter-regime chunks (~130-190 wordpieces) in a
# mixed batch straight to 256 and wasted ~40% of the encoder FLOPs on
# pad tokens (r05 bench).  Callers sort by length BEFORE grouping
# (SentenceEncoder._matrix_groups), so each group's max length sits
# close to its bucket and the extra buckets translate into real
# pad-fraction wins, not just more compiled programs.  The jit cache
# stays bounded: one program per (batch bucket, seq bucket) pair that
# actually occurs.
DEFAULT_SEQ_BUCKETS = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512)
DEFAULT_BATCH_BUCKETS = (1, 8, 32, 128, 256, 512, 1024)


def bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_fraction(lens, seq_buckets=DEFAULT_SEQ_BUCKETS, group: int | None = None):
    """Fraction of encoder tokens that would be padding if ``lens`` were
    sorted by length, split into groups of ``group`` rows (None = one
    group), and each group padded to its own seq bucket.

    This is the FLOP-waste model the batching layer optimises: the
    kernel's dead-block skip removes all-padding rows, so the tax that
    remains is (bucket - len) inside live rows — exactly what this
    reports."""
    lens = sorted(int(l) for l in lens)
    if not lens:
        return 0.0
    real = padded = 0
    step = group or len(lens)
    for i in range(0, len(lens), step):
        g = lens[i : i + step]
        s = bucket(max(g), seq_buckets)
        real += sum(g)
        padded += s * len(g)
    return 1.0 - real / max(padded, 1)


def pad_token_batch(
    token_lists: list[list[int]],
    pad_id: int = 0,
    seq_buckets=DEFAULT_SEQ_BUCKETS,
    batch_buckets=DEFAULT_BATCH_BUCKETS,
    max_batch: int | None = None,
    token_type_lists: list[list[int]] | None = None,
):
    """-> (ids[B,S] int32, mask[B,S] bool, token_types[B,S] or None, n_real).

    B and S are bucketed; rows past ``n_real`` are padding. If the input
    exceeds ``max_batch`` (or the largest batch bucket) the caller should
    chunk first — see :func:`chunks`.
    """
    n = len(token_lists)
    max_len = max((len(t) for t in token_lists), default=1)
    S = bucket(max_len, seq_buckets)
    if max_batch is not None:
        bb = tuple(b for b in batch_buckets if b < max_batch) + (max_batch,)
    else:
        bb = batch_buckets
    B = max(bucket(n, bb), n)
    ids = np.full((B, S), pad_id, dtype=np.int32)
    mask = np.zeros((B, S), dtype=bool)
    tts = None
    if token_type_lists is not None:
        tts = np.zeros((B, S), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        L = min(len(toks), S)
        ids[i, :L] = toks[:L]
        mask[i, :L] = True
        if tts is not None:
            tt = token_type_lists[i]
            tts[i, :L] = tt[:L]
    # padding rows are all-masked; the mean-pool divide is guarded by
    # jnp.maximum(count, 1) in the encoder
    return ids, mask, tts, n


def chunks(seq, size: int):
    for i in range(0, len(seq), size):
        yield seq[i : i + size]


def _capped_batch_buckets(max_batch: int, batch_buckets) -> tuple[int, ...]:
    return tuple(b for b in batch_buckets if b < max_batch) + (max_batch,)


def effective_max_batch(max_batch: int, mesh_ndata: int = 1) -> int:
    """The chunk size ``SentenceEncoder.encode_tokens`` actually uses:
    with a data mesh the batch rounds down to a multiple of the data
    axis so every shard gets whole rows."""
    if mesh_ndata > 1:
        return max(max_batch - max_batch % mesh_ndata, mesh_ndata)
    return max_batch


def predict_compile_keys(
    lengths,
    *,
    max_batch: int,
    seq_buckets=DEFAULT_SEQ_BUCKETS,
    batch_buckets=DEFAULT_BATCH_BUCKETS,
    mesh_ndata: int = 1,
) -> set[tuple[int, int]]:
    """Exact set of (B, S) geometries the bucketed encode path dispatches
    for a workload of token ``lengths`` (the reference's jit compile keys)
    — the model the deep verifier's predictor (PWL018) is validated
    against: this must mirror ``SentenceEncoder.encode_tokens`` (sort by
    length, chunk by the mesh-rounded max batch, pad each chunk to its
    bucket) exactly, and the bucket-sweep test asserts it matches
    ``SentenceEncoder.dispatch_geometry_count``."""
    if not lengths:
        return set()
    order = sorted(int(l) for l in lengths)
    batch = effective_max_batch(max_batch, mesh_ndata)
    bb = _capped_batch_buckets(batch, batch_buckets)
    keys: set[tuple[int, int]] = set()
    for i in range(0, len(order), batch):
        g = order[i : i + batch]
        s = bucket(max(max(g), 1), seq_buckets)
        b = max(bucket(len(g), bb), len(g))
        keys.add((b, s))
    return keys


def compile_bucket_space(
    max_seq_len: int,
    max_batch: int,
    *,
    seq_buckets=DEFAULT_SEQ_BUCKETS,
    batch_buckets=DEFAULT_BATCH_BUCKETS,
    mesh_ndata: int = 1,
) -> int:
    """Upper bound of distinct (B, S) geometries any workload can drive
    through the bucketed encode path at this geometry — the symbolic
    enumeration PWL018 sums against its budget."""
    batch = effective_max_batch(max_batch, mesh_ndata)
    bb = _capped_batch_buckets(batch, batch_buckets)
    scap = bucket(max(1, int(max_seq_len)), seq_buckets)
    n_seq = sum(1 for s in seq_buckets if s <= scap) or 1
    return n_seq * len(bb)
