"""Local HuggingFace checkpoints in the PyTorch port against the JAX
package, on the CPU. Each test writes a tiny BERT-named checkpoint itself
(``model.safetensors`` with the ``safetensors`` package, or
``pytorch_model.bin`` with ``torch.save``) under every name prefix the
reference accepts (``""``, ``"bert."``, ``"model."``); nothing is
downloaded. ``SentenceEncoder`` and ``CrossEncoderScorer`` of both
packages load it through ``checkpoint_dir`` or through
``PATHWAY_TPU_CKPT`` / ``PATHWAY_TPU_XENC_CKPT`` (set with
``monkeypatch``), and must give the same embeddings and scores. A
directory without a checkpoint, or one that lacks a name, leaves both
packages on their seeded random weights.

Tolerances: bf16 embeddings within 3e-2 with min cosine > 0.999; float32
cross-encoder scores within 1e-4 (the same math summed in another order).
The port's own safetensors reader must give exactly the tensors that the
``safetensors`` package gives."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file as load_torch
from safetensors.torch import save_file as save_torch

from pathway_tpu.models.encoder import CrossEncoderHead as JHead
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.encoder import TextEncoder as JTextEncoder
from pathway_tpu.models.encoder import init_params as jinit
from pathway_tpu.models.sentence_encoder import CrossEncoderScorer as JScorer
from pathway_tpu.models.sentence_encoder import SentenceEncoder as JEncoder
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu_torch import CrossEncoderScorer, SentenceEncoder
from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
from pathway_tpu_torch.models.encoder import init_cross_encoder_params, init_params
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.ops.fused_layer import prepare_params
from pathway_tpu_torch.weights import load_hf_weights, read_safetensors

TINY = dict(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=64)
WORDS = [f"w{i}" for i in range(200)]


def _hf_state(seed: int, classifier: bool) -> dict[str, np.ndarray]:
    """Seeded float32 weights under BERT's names, for the TINY geometry."""
    rng = np.random.default_rng(seed)
    d, ff = TINY["hidden_size"], TINY["intermediate_size"]
    w = lambda *shape: (0.05 * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    ln = lambda: {"weight": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32), "bias": w(d)}  # noqa: E731
    st = {
        "embeddings.word_embeddings.weight": w(TINY["vocab_size"], d),
        "embeddings.position_embeddings.weight": w(TINY["max_position"], d),
        "embeddings.token_type_embeddings.weight": w(2, d),
    }
    st.update({f"embeddings.LayerNorm.{k}": v for k, v in ln().items()})
    for i in range(TINY["num_layers"]):
        pre = f"encoder.layer.{i}."
        for name, (n_out, n_in) in {
            "attention.self.query": (d, d), "attention.self.key": (d, d), "attention.self.value": (d, d),
            "attention.output.dense": (d, d), "intermediate.dense": (ff, d), "output.dense": (d, ff),
        }.items():
            st[pre + name + ".weight"], st[pre + name + ".bias"] = w(n_out, n_in), w(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            st.update({f"{pre}{name}.{k}": v for k, v in ln().items()})
    if classifier:
        st["classifier.weight"], st["classifier.bias"] = w(1, d), w(1)
    return st


def _write(path, state: dict, fmt: str, prefix: str) -> None:
    named = {prefix + k: v for k, v in state.items()}
    path.mkdir(parents=True, exist_ok=True)
    if fmt == "safetensors":
        save_numpy(named, str(path / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in named.items()}, str(path / "pytorch_model.bin"))


def _texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(2, 12))) for _ in range(n)]


def _pairs(seed: int, n: int) -> list[tuple[str, str]]:
    a, b = _texts(seed, n), _texts(seed + 1, n)
    return list(zip(a, b))


def _load(kind: str, where, monkeypatch):
    """(JAX object, port object) of ``kind`` built the way ``where`` says:
    a directory passed as ``checkpoint_dir``, or ("env", directory)."""
    env = {"sentence": "PATHWAY_TPU_CKPT", "cross": "PATHWAY_TPU_XENC_CKPT"}[kind]
    if isinstance(where, tuple):
        monkeypatch.setenv(env, str(where[1]))
        kw = {}
    else:
        monkeypatch.delenv(env, raising=False)
        kw = {"checkpoint_dir": str(where)}
    if kind == "sentence":
        j = JEncoder(config=JCfg(**TINY), max_seq_len=32, max_batch=8, **kw)
        t = SentenceEncoder(config=TCfg(**TINY), max_seq_len=32, max_batch=8, device="cpu", **kw)
    else:
        j = JScorer(config=JCfg.cross_encoder_l6(**TINY, dtype=jnp.float32), max_seq_len=48, max_batch=8, **kw)
        t = CrossEncoderScorer(config=TCfg.cross_encoder_l6(**TINY, dtype=torch.float32), max_seq_len=48,
                               max_batch=8, device="cpu", **kw)
    j.tokenizer = JTok(vocab_size=TINY["vocab_size"])
    t.tokenizer = TTok(vocab_size=TINY["vocab_size"])
    return j, t


def _same(got: torch.Tensor, want: np.ndarray) -> bool:
    """``got`` equals ``want`` cast to ``got``'s dtype (the module keeps
    its projections in the working dtype)."""
    return torch.equal(got, torch.from_numpy(want).to(got.dtype))


@pytest.mark.parametrize(
    "kind,fmt,prefix,via",
    [
        ("sentence", "safetensors", "", "arg"),
        ("sentence", "bin", "bert.", "env"),
        ("sentence", "safetensors", "model.", "env"),
        ("cross", "bin", "", "env"),
        ("cross", "safetensors", "bert.", "arg"),
        ("cross", "bin", "model.", "arg"),
    ],
)
def test_checkpoint_loads_in_both_packages_and_they_agree(tmp_path, monkeypatch, kind, fmt, prefix, via):
    hf = _hf_state(seed=11, classifier=kind == "cross")
    _write(tmp_path / "ckpt", hf, fmt, prefix)
    where = ("env", tmp_path / "ckpt") if via == "env" else tmp_path / "ckpt"
    j, t = _load(kind, where, monkeypatch)
    # the port's weights are the checkpoint's, q | k | v concatenated
    enc = "encoder." if kind == "cross" else ""
    sd = t.module.state_dict()
    qkv = np.concatenate([hf[f"encoder.layer.1.attention.self.{p}.weight"] for p in ("query", "key", "value")])
    assert _same(sd[enc + "layers.1.attention.qkv.weight"], qkv)
    assert _same(sd[enc + "ln_embed.bias"], hf["embeddings.LayerNorm.bias"])
    assert _same(sd[enc + "layers.0.mlp_out.bias"], hf["encoder.layer.0.output.dense.bias"])
    if kind == "sentence":
        # the whole-layer path's weights were laid out after the load
        assert _same(t.params["layers.1.attention.qkv.weight"], qkv)
        texts = _texts(3, 9)
        ref, got = np.asarray(j.encode(texts)), t.encode(texts)
        assert np.abs(ref - got).max() < 3e-2
        assert (ref * got).sum(axis=1).min() > 0.999
    else:
        assert _same(sd["classifier.weight"], hf["classifier.weight"])
        pairs = _pairs(5, 9)
        np.testing.assert_allclose(t.score(pairs), np.asarray(j.score(pairs)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["sentence", "cross"])
@pytest.mark.parametrize("case", ["empty_dir", "missing_key", "no_dir"])
def test_no_usable_checkpoint_leaves_random_weights_in_both(tmp_path, monkeypatch, kind, case):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    if case == "missing_key":
        hf = _hf_state(seed=12, classifier=kind == "cross")
        del hf["encoder.layer.1.output.dense.bias"]
        _write(ckpt, hf, "safetensors", "bert.")
    j, t = _load(kind, ckpt if case != "no_dir" else tmp_path / "absent", monkeypatch)
    if kind == "sentence":
        tcfg = TCfg(**TINY)
        want_t = prepare_params(init_params(tcfg, seed=0), tcfg)
        assert all(torch.equal(t.params[k], v) for k, v in want_t.items())
        want_j = jinit(JTextEncoder(JCfg(**TINY)), JCfg(**TINY))
    else:
        tcfg = TCfg.cross_encoder_l6(**TINY, dtype=torch.float32)
        want_t = init_cross_encoder_params(tcfg, seed=0)
        assert all(torch.equal(t.module.state_dict()[k], v) for k, v in want_t.items())
        jcfg = JCfg.cross_encoder_l6(**TINY, dtype=jnp.float32)
        want_j = jinit(JHead(jcfg), jcfg)
    got_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, meta.unbox(j.params)))
    want_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, meta.unbox(want_j)))
    assert len(got_leaves) == len(want_leaves)
    assert all(np.array_equal(a, b) for a, b in zip(got_leaves, want_leaves))


def test_load_hf_weights_raises_before_replacing_anything(tmp_path):
    tcfg = TCfg(**TINY)
    init = init_params(tcfg, seed=0)
    with pytest.raises(FileNotFoundError):
        load_hf_weights(init, str(tmp_path))
    hf = _hf_state(seed=13, classifier=False)
    del hf["embeddings.LayerNorm.weight"]
    _write(tmp_path, hf, "bin", "model.")
    before = {k: v.clone() for k, v in init.items()}
    with pytest.raises(KeyError):
        load_hf_weights(init, str(tmp_path))
    assert all(torch.equal(init[k], before[k]) for k in before)


def test_safetensors_reader_gives_exactly_what_the_package_gives(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "f64": torch.randn(4, generator=g).double(),
        "i64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
        "i32": torch.arange(5, dtype=torch.int32),
        "u8": torch.arange(6, dtype=torch.uint8),
        "flag": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = tmp_path / "model.safetensors"
    save_torch(tensors, str(path), metadata={"format": "pt"})
    got, want = read_safetensors(str(path)), load_torch(str(path))
    assert set(got) == set(want) == set(tensors)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        assert torch.equal(got[name], w), name
