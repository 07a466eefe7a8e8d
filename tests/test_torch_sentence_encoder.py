"""The port's host layer and encoder path against the JAX package, on the
CPU: the WordPiece tokenizer (hashed and vocab.txt modes), the weight
bridge, ``SentenceEncoder`` (``encode``, ``encode_device``,
``encode_tokens``; both the ``_matrix_groups`` and ``_pack_uniform``
paths), and the slice end to end: docs -> ``encode_device`` ->
``add_batch_device`` -> queries -> ``search_batch`` and
``search_texts_batch``, whose neighbour sets must equal the JAX package's.

Both packages get the same weights (the JAX package's ``init_params``
through ``weights.py``). Tolerance for embeddings: bf16 working dtype,
max abs error < 3e-2 and min cosine > 0.999."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.sentence_encoder import SentenceEncoder as JEncoder
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu.ops.knn import DeviceKnnIndex as JIndex
from pathway_tpu_torch import DeviceKnnIndex, SentenceEncoder
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.weights import from_jax_params, to_jax_params

WORDS = [f"w{i}" for i in range(300)] + ["apple", "banana", "cherry", "river", "stone", "cloud", "light"]


def _texts(rng, n, lo=1, hi=20):
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1))) for _ in range(n)]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "##s", "##ed", "##ing", "app", "##le", "ban", "##ana"]
    toks += [w for w in WORDS if w not in ("apple", "banana")][:400]
    path.write_text("\n".join(toks) + "\n", encoding="utf-8")
    return str(path)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


# ------------------------------------------------------------- tokenizer


def test_tokenizer_hashed_mode_ids_equal():
    rng = np.random.default_rng(0)
    texts = _texts(rng, 50) + ["", "Hello, World! 123", "naïve café — ok", "x" * 300]
    j, t = JTok(), TTok()
    for max_len in (8, 128):
        assert [t.encode(s, max_len) for s in texts] == [j.encode(s, max_len) for s in texts]
    ids, lens = t.batch_encode_matrix(texts, 32)
    for i, s in enumerate(texts):
        assert ids[i, : lens[i]].tolist() == j.encode(s, 32)
        assert (ids[i, lens[i] :] == t.pad_id).all()
    assert t.encode_pair("a b c", "d e", 6) == j.encode_pair("a b c", "d e", 6)


def test_tokenizer_vocab_mode_ids_equal(vocab_file):
    texts = ["apple bananas w1 w299 stones", "unknownword w3ed", "APPLE w7 w8 w9", "a" * 150]
    j, t = JTok(vocab_file=vocab_file), TTok(vocab_file=vocab_file)
    assert (t.cls_id, t.sep_id, t.pad_id, t.unk_id) == (j.cls_id, j.sep_id, j.pad_id, j.unk_id)
    assert [t.encode(s, 16) for s in texts] == [j.encode(s, 16) for s in texts]
    assert t.encode_pair(texts[0], texts[1], 12) == j.encode_pair(texts[0], texts[1], 12)


# ------------------------------------------------------------- weights


def test_weight_bridge_round_trip_is_exact():
    from pathway_tpu.models.encoder import TextEncoder as JTextEncoder
    from pathway_tpu.models.encoder import init_params as jinit

    cfg = JCfg(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=32)
    tree = _tree(jinit(JTextEncoder(cfg), cfg))
    sd = from_jax_params(tree)
    assert sd["layers.1.attention.qkv.weight"].shape == (96, 32)  # [out, in]
    back = to_jax_params(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(leaf, flat_b[path]) and leaf.dtype == flat_b[path].dtype, path
    np.testing.assert_array_equal(sd["layers.0.mlp_in.weight"].numpy(), tree["params"]["layer_0"]["mlp_in"]["kernel"].T)


# ------------------------------------------------------------- encoder

SMALL = dict(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=64)


@pytest.fixture(scope="module")
def encoders():
    jenc = JEncoder(config=JCfg(**SMALL), checkpoint_dir="/nonexistent", max_seq_len=48, max_batch=8)
    jenc.tokenizer = JTok(vocab_size=SMALL["vocab_size"])
    tenc = SentenceEncoder(
        config=TCfg(**SMALL), max_seq_len=48, max_batch=8, device="cpu", params=from_jax_params(_tree(jenc.params))
    )
    tenc.tokenizer = TTok(vocab_size=SMALL["vocab_size"])
    return jenc, tenc


def _close(ref, got):
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() < 3e-2
    assert (ref * got).sum(axis=1).min() > 0.999


@pytest.mark.parametrize("n", [5, 16, 21])  # 16 = 2 * max_batch: the _pack_uniform path
def test_encode_and_encode_device_match(encoders, n):
    jenc, tenc = encoders
    texts = _texts(np.random.default_rng(n), n, hi=40)
    ref = np.asarray(jenc.encode(texts))
    _close(ref, tenc.encode(texts))
    dev = tenc.encode_device(texts)
    assert isinstance(dev, torch.Tensor) and dev.shape == (n, SMALL["hidden_size"])
    _close(np.asarray(jenc.encode_device(texts)), dev.numpy())
    padded = tenc.encode_device(texts, pad_to=n + 3)
    assert padded.shape[0] == n + 3 and (padded[n:] == 0).all()
    _close(ref, padded[:n].numpy())


def test_pack_uniform_and_matrix_groups_agree(encoders):
    jenc, tenc = encoders
    texts = _texts(np.random.default_rng(1), 16, hi=40)
    ids, lens = tenc._tokenize_matrix(texts)
    order, embs = tenc._pack_uniform(ids, lens)
    assert sorted(order.tolist()) == list(range(16))
    via_groups = tenc._encode_matrix(ids, lens)
    np.testing.assert_allclose(embs.numpy(), via_groups[order], atol=1e-6)
    assert tenc._pack_uniform(ids[:12], lens[:12]) is None  # n % max_batch != 0


def test_encode_tokens_module_path(encoders):
    jenc, tenc = encoders
    rng = np.random.default_rng(2)
    toks = [[101] + rng.integers(999, 2000, rng.integers(1, 30)).tolist() + [102] for _ in range(11)]
    _close(jenc.encode_tokens(toks), tenc.encode_tokens(toks))
    assert tenc.encode_tokens([]).shape == (0, SMALL["hidden_size"])


def test_encode_device_many_matches_single(encoders):
    _, tenc = encoders
    rng = np.random.default_rng(3)
    batches = [_texts(rng, 6), _texts(rng, 9)]
    many = tenc.encode_device_many(batches)
    for b, got in zip(batches, many):
        np.testing.assert_allclose(got.numpy(), tenc.encode_device(b).numpy(), atol=1e-6)


# ------------------------------------------------------------- end to end


def test_slice_end_to_end_neighbour_sets(vocab_file):
    """The ``_pipeline_doc_ids`` config of ``__graft_entry__.py``: texts ->
    embed -> on-device index -> nearest-neighbour query, both packages."""
    kw = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32)
    jenc = JEncoder(config=JCfg(**kw), checkpoint_dir="/nonexistent", max_seq_len=16, max_batch=16)
    jenc.tokenizer = JTok(vocab_file=vocab_file)
    tenc = SentenceEncoder(
        config=TCfg(**kw), max_seq_len=16, max_batch=16, device="cpu", params=from_jax_params(_tree(jenc.params))
    )
    tenc.tokenizer = TTok(vocab_file=vocab_file)
    rng = np.random.default_rng(7)
    docs = _texts(rng, 12, lo=4, hi=8)
    queries = _texts(rng, 3, lo=4, hi=8) + [docs[4]]

    jidx = JIndex(dim=kw["hidden_size"], metric="cos")
    jidx.add_batch_device(list(range(12)), jenc.encode_device(docs))
    jidx.attach_encoder(jenc)
    tidx = DeviceKnnIndex(dim=kw["hidden_size"], metric="cos", device="cpu")
    tidx.add_batch_device(list(range(12)), tenc.encode_device(docs))
    tidx.attach_encoder(tenc)

    want = jidx.search_batch(np.asarray(jenc.encode_device(queries)), 3)
    got = tidx.search_batch(tenc.encode_device(queries), 3)
    assert [set(k for k, _ in r) for r in got] == [set(k for k, _ in r) for r in want]
    assert got[3][0][0] == 4  # a doc's own text finds it first
    got_text = tidx.search_texts_batch(queries, 3)
    want_text = jidx.search_texts_batch(queries, 3)
    assert [set(k for k, _ in r) for r in got_text] == [set(k for k, _ in r) for r in want_text]
    assert [set(k for k, _ in r) for r in got_text] == [set(k for k, _ in r) for r in got]
