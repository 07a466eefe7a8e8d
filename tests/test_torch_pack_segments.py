"""``SentenceEncoder._pack_segments`` of the PyTorch port against the JAX
package's, on the CPU: the same slot map, the same engage / decline
decisions, and packed embeddings within the encoder bound of the JAX ones.
A tiny encoder with ``max_position`` 512 (packing needs 512-token rows);
``PACK_ROWS`` is set small on both instances, so the JAX package's scan
pads few rows.

Tolerance: bf16 working dtype, max abs error < 3e-2 and min cosine > 0.999
(the bound slice 1 holds the port's embeddings to)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.sentence_encoder import SentenceEncoder as JEncoder
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch import SentenceEncoder
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_params

TINY = dict(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=512)


def _pair(**over):
    kw = {**TINY, **over}
    jenc = JEncoder(config=JCfg(**kw), checkpoint_dir="/nonexistent", max_seq_len=512, max_batch=1024)
    jenc.tokenizer = JTok(vocab_size=min(kw["vocab_size"], 2048))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, meta.unbox(jenc.params)))
    tenc = SentenceEncoder(config=TCfg(**kw), max_seq_len=512, max_batch=1024, device="cpu", params=params)
    tenc.tokenizer = TTok(vocab_size=min(kw["vocab_size"], 2048))
    jenc.PACK_ROWS = tenc.PACK_ROWS = 16
    return jenc, tenc


@pytest.fixture(scope="module")
def encoders():
    return _pair()


def _long_tail(rng, n, short=(64, 128), tail=(129, 256), tail_share=0.05):
    """Token matrices of n chunks: most at ``short`` wordpieces, the rest at
    ``tail`` (the long-tailed epoch that makes packing pay)."""
    lens = np.where(rng.random(n) < tail_share, rng.integers(*tail, n), rng.integers(*short, n)).astype(np.int32)
    ids = np.zeros((n, 512), np.int32)
    for i, ln in enumerate(lens):
        ids[i, :ln] = rng.integers(999, 2047, ln)
        ids[i, 0], ids[i, ln - 1] = 101, 102
    return ids, lens


def _unpack(order, embs, n):
    out = np.zeros((n, embs.shape[1]), np.float32)
    keep = order < n
    out[order[keep]] = np.asarray(embs)[keep]
    return out


def _close(ref, got):
    assert np.abs(ref - got).max() < 3e-2
    assert (ref * got).sum(axis=1).min() > 0.999


def test_slot_map_and_embeddings_match_jax(encoders):
    jenc, tenc = encoders
    ids, lens = _long_tail(np.random.default_rng(0), 600)
    j_order, j_embs = jenc._pack_segments(ids, lens)
    t_order, t_embs = tenc._pack_segments(ids, lens)
    n_slots = len(t_order)
    # the JAX package pads its rows to a multiple of PACK_ROWS; those slots are empty
    np.testing.assert_array_equal(t_order, np.asarray(j_order)[:n_slots])
    assert (np.asarray(j_order)[n_slots:] == len(lens)).all()
    assert sorted(t_order[t_order < len(lens)].tolist()) == list(range(len(lens)))
    _close(_unpack(np.asarray(j_order), j_embs, 600), _unpack(t_order, t_embs.numpy(), 600))


def _decline_case(name):
    rng = np.random.default_rng(1)
    if name == "engages":
        return _long_tail(rng, 520)
    if name == "n<512":
        return _long_tail(rng, 500)
    if name == "mean<64":
        return _long_tail(rng, 600, short=(20, 40), tail=(129, 256), tail_share=0.2)
    if name == "max>512":
        ids, lens = _long_tail(rng, 600)
        ids = np.pad(ids, ((0, 0), (0, 64)))
        lens[3] = 560
        return ids, lens
    if name == "ratio>0.45":  # lengths near their buckets: little padding to win back
        return _long_tail(rng, 600, short=(120, 128), tail=(120, 128))
    raise ValueError(name)


@pytest.mark.parametrize("case", ["engages", "n<512", "mean<64", "max>512", "ratio>0.45", "vocab>=32768"])
def test_engage_and_decline_decisions_match_jax(encoders, case):
    if case == "vocab>=32768":
        jenc, tenc = _pair(vocab_size=32768)
        ids, lens = _long_tail(np.random.default_rng(2), 600)
    else:
        jenc, tenc = encoders
        ids, lens = _decline_case(case)
    j, t = jenc._pack_segments(ids, lens), tenc._pack_segments(ids, lens)
    assert (j is None) == (t is None) == (case != "engages")


def test_packed_and_unpacked_embeddings_agree(encoders):
    _, tenc = encoders
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(500)]
    n = np.where(rng.random(560) < 0.05, rng.integers(130, 250, 560), rng.integers(64, 126, 560))
    texts = [" ".join(rng.choice(words, k)) for k in n]
    calls = []
    pack = tenc._pack_segments
    tenc._pack_segments = lambda ids, lens: calls.append(pack(ids, lens)) or calls[-1]
    try:
        dev = tenc.encode_device(texts)
    finally:
        del tenc._pack_segments
    assert len(calls) == 1 and calls[0] is not None  # encode_device tries the packer first
    ids, lens = tenc._tokenize_matrix(texts)
    _close(tenc._encode_matrix(ids, lens), dev.numpy())
    assert isinstance(dev, torch.Tensor) and dev.shape == (560, TINY["hidden_size"])
