"""Contrastive training in the PyTorch port against the JAX package, on the
CPU: ``info_nce_loss``, the gradients of kernels B3 and B4 (their autograd
Functions) and of ``encoder_forward`` (B1), two ``ContrastiveTrainer``
steps on a one-device mesh and on a dp 4 x tp 2 mesh, the placements of
``parallel/sharding.py`` and the kernels that have no backward. Inputs come
from ``numpy.random.default_rng(seed)``; the reference's Pallas kernels run
in interpret mode, its trainers on its CPU devices (``tests/conftest.py``
gives JAX eight).

Tolerances, each beside its assertion:

* the loss: 1e-6 (f32 on both sides);
* attention gradients: the reference's own bound between its kernel's and
  XLA's gradients, 0.2 in bf16 (``tests/test_fused_attention.py:99``;
  one bf16 rounding step at the gradients' magnitude), 1e-4 in f32;
* ``encoder_forward``'s gradients: 2e-2 in bf16
  (``tests/test_fused_layer.py:121-123``), 1e-5 in f32;
* trainer steps in f32: losses within 2e-6 relative, parameters within a
  tenth of the learning rate (AdamW moves each one by about the learning
  rate a step); in bf16 the two frameworks round the forward at other
  points, so losses agree within 2e-3 and an element whose gradient is
  near zero may step the other way: every parameter within 2 x steps x
  the learning rate, and 95 % of them within a tenth of it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from pathway_tpu.models.encoder import CrossEncoderHead as JCrossHead
from pathway_tpu.models.encoder import EncoderConfig as JCfg
from pathway_tpu.models.encoder import TextEncoder as JTextEncoder
from pathway_tpu.models.encoder import init_params as jinit
from pathway_tpu.models.encoder import param_logical_axes as jaxes
from pathway_tpu.models.training import ContrastiveTrainer as JTrainer
from pathway_tpu.models.training import info_nce_loss as jinfo_nce
from pathway_tpu.ops import fused_layer as jfl
from pathway_tpu.ops.fused_attention import attention as jattention
from pathway_tpu.parallel.sharding import make_mesh as jmake_mesh
from pathway_tpu_torch.models import ContrastiveTrainer, info_nce_loss
from pathway_tpu_torch.models.encoder import CrossEncoderHead, EncoderConfig, TextEncoder, param_logical_axes
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops import fused_attention as tfa
from pathway_tpu_torch.ops import fused_layer as tfl
from pathway_tpu_torch.parallel import sharding
from pathway_tpu_torch.weights import from_jax_params

# tests/test_sharding.py's trainer geometry
TRAIN = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64, max_position=32,
             pooling="mean")
LAYER = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=512)
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _cfgs(kw: dict, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return JCfg(**kw, dtype=jdt), EncoderConfig(**kw, dtype=tdt)


def _state_dict(params) -> dict:
    return from_jax_params(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), meta.unbox(params)))


# ------------------------------------------------------------------ loss


def test_info_nce_loss_matches_the_reference():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((12, 24)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    want = float(jinfo_nce(jnp.asarray(a), jnp.asarray(b)))
    got = float(info_nce_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) < 1e-6  # f32 on both sides


# ------------------------------------------------------- attention (B3, B4)


def _qkv(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, 3 * d)).astype(np.float32)


def _grads(qkv, jloss, tloss, dtype):
    """The qkv gradients of ``jloss`` (JAX) and ``tloss`` (the port)."""
    jdt, tdt = DTYPES[dtype]
    gj = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(qkv).astype(jdt)).astype(jnp.float32))
    t = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    tloss(t).backward()
    return gj, t.grad.float().numpy()


def test_masked_attention_grad_matches_jax_on_the_reference_case():
    """``tests/test_fused_attention.py::test_kernel_grad_matches_xla``'s case:
    sum(out^2), every key live."""
    b, s, h, d = 6, 32, 12, 384
    qkv = _qkv(b, s, d)
    mask = np.ones((b, s), bool)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)

    def jloss(t):
        out = jattention(t, jm, n_heads=h, impl="interpret").astype(jnp.float32)
        return jnp.sum(out * out)

    def tloss(t):
        out = tfa.attention(t, tm, n_heads=h).float()
        return (out * out).sum()

    gj, gt = _grads(qkv, jloss, tloss, "bf16")
    assert np.abs(gj - gt).max() < 0.2  # the reference's bound, bf16


@pytest.mark.parametrize("dtype,tol", [("bf16", 0.2), ("f32", 1e-4)])
@pytest.mark.parametrize("packed", [False, True], ids=["key_mask", "segment_ids"])
def test_attention_grads_match_jax_with_masked_keys(dtype, tol, packed):
    """A fixed cotangent on the live rows (the reference's padding rows of a
    packed call hold what no caller reads, the port's zeros), padded keys or
    segments of 3-11 tokens with a -1 tail."""
    b, s, h, d = 5, 32, 4, 128
    rng = np.random.default_rng(2)
    qkv = _qkv(b, s, d, seed=3)
    mask = np.ones((b, s), bool)
    mask[0, s // 2 :] = False
    mask[1, 3:] = False
    seg = np.full((b, s), -1, np.int32)
    for r in range(b):
        pos = sid = 0
        while pos < s - 4:
            n = min(int(rng.integers(3, 12)), s - 4 - pos)
            seg[r, pos : pos + n] = r * 100 + sid
            pos, sid = pos + n, sid + 1
    live = ((seg >= 0) if packed else np.ones((b, s), bool))[:, :, None]
    w = (rng.standard_normal((b, s, d)) * live).astype(np.float32)
    jkw = {"segment_ids": jnp.asarray(seg)} if packed else {}
    tkw = {"segment_ids": torch.from_numpy(seg)} if packed else {}
    jm, tm = (None, None) if packed else (jnp.asarray(mask), torch.from_numpy(mask))

    def jloss(t):
        return jnp.sum(jattention(t, jm, n_heads=h, impl="interpret", **jkw).astype(jnp.float32) * w)

    def tloss(t):
        return (tfa.attention(t, tm, n_heads=h, **tkw).float() * torch.from_numpy(w)).sum()

    gj, gt = _grads(qkv, jloss, tloss, dtype)
    assert np.abs(gj - gt).max() < tol  # bf16: the reference's bound; f32: summation order only


def test_zero_empty_sequences_pass_no_gradient():
    """``masked_attention(zero_empty=True)`` writes 0 for a sequence with no
    live key, so none of its qkv gets a gradient."""
    qkv = torch.from_numpy(_qkv(3, 16, 32)).requires_grad_(True)
    mask = torch.ones(3, 16, dtype=torch.bool)
    mask[2] = False
    out = tfa.masked_attention(qkv, mask, 2, zero_empty=True)
    out.sum().backward()
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert torch.equal(qkv.grad[2], torch.zeros_like(qkv.grad[2])) and qkv.grad[:2].abs().sum() > 0


def test_attention_without_grad_saves_nothing():
    """Grad disabled, or a qkv that does not require it: the forward alone,
    no graph."""
    qkv = torch.from_numpy(_qkv(2, 16, 32))
    mask = torch.ones(2, 16, dtype=torch.bool)
    assert tfa.attention(qkv, mask, n_heads=2).grad_fn is None
    with torch.no_grad():
        assert tfa.attention(qkv.requires_grad_(True), mask, n_heads=2).grad_fn is None
    assert tfa.attention(qkv, mask, n_heads=2).grad_fn is not None


# ------------------------------------------------------------ B1 backward


@pytest.mark.parametrize("dtype,tol", [("bf16", 2e-2), ("f32", 1e-5)])
def test_encoder_forward_grads_match_jax(dtype, tol):
    """jax.grad of the reference's ``encoder_forward(interpret=True)`` and the
    port's gradients for every state-dict tensor, at its own shape, from
    raw and from prepared parameters."""
    jcfg, tcfg = _cfgs(LAYER, dtype)
    params = jinit(JTextEncoder(jcfg), jcfg)
    sd = _state_dict(params)
    rng = np.random.default_rng(3)
    b, s = 3, 16
    ids = rng.integers(5, LAYER["vocab_size"] - 1, (b, s)).astype(np.int32)
    lens = rng.integers(s // 2, s + 1, (b,))
    mask = np.arange(s)[None, :] < lens[:, None]
    def loss(p):
        return jfl.encoder_forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask), interpret=True).sum()

    gj = _state_dict(jax.jit(jax.grad(loss))(meta.unbox(params)))
    for tp in ({k: v.clone() for k, v in sd.items()}, tfl.prepare_params(sd, tcfg)):
        tp = {k: v.requires_grad_(True) for k, v in tp.items()}
        tfl.encoder_forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask)).sum().backward()
        for k, t in tp.items():
            assert t.grad.shape == t.shape, k
            assert (t.grad.float() - gj[k]).abs().max() < tol, k  # bf16: the reference's module-vs-kernel bound


def test_encoder_forward_without_grad_is_the_forward():
    _, tcfg = _cfgs(LAYER, "f32")
    sd = _state_dict(jinit(JTextEncoder(JCfg(**LAYER)), JCfg(**LAYER)))
    ids = torch.from_numpy(np.random.default_rng(4).integers(5, 999, (2, 16)).astype(np.int32))
    mask = torch.ones(2, 16, dtype=torch.bool)
    want = tfl.encoder_forward(sd, tcfg, ids, mask)
    got = tfl.encoder_forward({k: v.requires_grad_(True) for k, v in sd.items()}, tcfg, ids, mask)
    assert want.grad_fn is None and got.grad_fn is not None and torch.equal(got.detach(), want)


# ------------------------------------------------------------------ trainer


def _pairs(b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    ids_a, ids_b = (rng.integers(0, TRAIN["vocab_size"], (b, s)).astype(np.int32) for _ in range(2))
    lens = rng.integers(4, s + 1, (b,))
    mask = np.arange(s)[None, :] < lens[:, None]
    return ids_a, mask, ids_b, mask


def _close_params(got: dict, want: dict, dtype: str, lr: float, steps: int) -> None:
    if dtype == "f32":
        for k in want:
            assert (got[k] - want[k]).abs().max() < 0.1 * lr, k  # a tenth of one AdamW move
        return
    near = []
    for k in want:
        diff = (got[k].float() - want[k]).abs()
        assert diff.max() <= 2 * steps * lr * 1.01, k  # at most every step the other way
        near.append((diff <= 0.1 * lr).flatten())
    assert torch.cat(near).float().mean() > 0.95


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_two_steps_match_the_reference_trainer(dtype):
    """From the reference trainer's initial parameters (``weights.from_jax_
    params``), two steps on one device of each: losses and parameters."""
    jcfg, tcfg = _cfgs(TRAIN, dtype)
    batch = _pairs()
    jt = JTrainer(config=jcfg, mesh=jmake_mesh(devices=jax.devices()[:1]))
    tt = ContrastiveTrainer(config=tcfg, mesh=sharding.make_mesh(devices=["cpu"]))
    tt.load_state_dict(_state_dict(jt.params))
    jl = [jt.step(*batch) for _ in range(2)]
    tl = [tt.step(*(torch.from_numpy(a) for a in batch)) for _ in range(2)]
    assert jl[1] < jl[0] and tl[1] < tl[0]
    loss_tol = 2e-6 * jl[0] if dtype == "f32" else 2e-3  # f32: summation order; bf16: forward rounding
    assert max(abs(a - b) for a, b in zip(jl, tl)) < loss_tol
    _close_params(tt.state_dict(), _state_dict(jt.params), dtype, tt.learning_rate, 2)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_dp4_tp2_steps_match_unsharded_and_the_reference(dtype):
    """``tests/test_sharding.py::test_contrastive_trainer_tp_dp_step``'s mesh:
    eight CPU devices as dp 4 x tp 2, against the port's one-device trainer
    and the reference's trainer on its eight virtual devices."""
    jcfg, tcfg = _cfgs(TRAIN, dtype)
    batch = _pairs(seed=1)
    jt = JTrainer(config=jcfg, mesh=jmake_mesh(model_parallel=2))
    sd0 = _state_dict(jt.params)
    mesh = sharding.make_mesh(devices=["cpu"] * 8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    t8 = ContrastiveTrainer(config=tcfg, mesh=mesh)
    t1 = ContrastiveTrainer(config=tcfg, mesh=sharding.make_mesh(devices=["cpu"]))
    for t in (t8, t1):
        t.load_state_dict(sd0)
    jl = [jt.step(*batch) for _ in range(2)]
    l8 = [t8.step(*batch) for _ in range(2)]
    l1 = [t1.step(*batch) for _ in range(2)]
    assert l8[1] < l8[0] and jl[1] < jl[0]
    loss_tol = 2e-6 * jl[0] if dtype == "f32" else 2e-3  # f32: summation order; bf16: forward rounding
    for other in (l1, jl):
        assert max(abs(a - b) for a, b in zip(l8, other)) < loss_tol
    got = t8.state_dict()
    for want in (t1.state_dict(), _state_dict(jt.params)):
        _close_params(got, want, dtype, t8.learning_rate, 2)
    # the replicas stay identical
    for rep in t8._replicas[1:]:
        assert all(torch.equal(a, b) for a, b in zip(t8._replicas[0].leaves(), rep.leaves()))


def test_sharded_gradients_equal_the_module_gradients():
    """One dp 2 x tp 2 gradient in f32 against the one-device trainer's."""
    _, tcfg = _cfgs(dict(TRAIN, num_layers=2), "f32")
    batch = _pairs(seed=2)
    l4, g4 = ContrastiveTrainer(tcfg, sharding.make_mesh(devices=["cpu"] * 4, model_parallel=2)).value_and_grad(*batch)
    l1, g1 = ContrastiveTrainer(tcfg, sharding.make_mesh(devices=["cpu"])).value_and_grad(*batch)
    assert abs(l4 - l1) < 1e-6 * l1  # f32, summation order
    for k in g1:
        assert g4[k].shape == g1[k].shape and (g4[k] - g1[k]).abs().max() < 1e-5, k  # f32 sums over every token


def test_trainer_optimizer_and_placement():
    """optax.adamw's defaults (weight decay 1e-4, not torch's 1e-2);
    ``mesh=None`` is every card and raises without one; the batch must
    split over the data axis; the model axis must split the heads."""
    t = ContrastiveTrainer(EncoderConfig(**TRAIN), sharding.make_mesh(devices=["cpu"]))
    group = t.opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (2e-5, (0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(TextEncoder(EncoderConfig(**TRAIN)).state_dict())
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            ContrastiveTrainer(EncoderConfig(**TRAIN))
    t4 = ContrastiveTrainer(EncoderConfig(**TRAIN), sharding.make_mesh(devices=["cpu"] * 4, model_parallel=1))
    ids_a, mask, ids_b, _ = _pairs(b=6)
    with pytest.raises(ValueError, match="does not split"):
        t4.step(ids_a, mask, ids_b, mask)
    with pytest.raises(ValueError, match="num_heads"):
        ContrastiveTrainer(EncoderConfig(**dict(TRAIN, num_heads=2)), sharding.make_mesh(devices=["cpu"] * 4,
                                                                                        model_parallel=4))


# ------------------------------------------------------------- placements


def _reference_axes(jmodel, jcfg) -> dict:
    """The reference's partition spec, by the port's state-dict names, each
    Dense kernel's axes read in the port's [out, in] layout."""
    flat = jax.tree_util.tree_flatten_with_path(jaxes(jmodel, jcfg), is_leaf=lambda x: isinstance(x, tuple))[0]
    out = {}
    for path, spec in flat:
        keys = [k.key for k in path if hasattr(k, "key")][1:]  # drop "params"
        leaf = keys[-1]
        name = ".".join(k.replace("layer_", "layers.") for k in keys[:-1])
        axes = tuple(spec)
        if leaf == "kernel":
            axes = axes[::-1]
        out[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = axes
    return out


@pytest.mark.parametrize("head", [False, True], ids=["text_encoder", "cross_encoder"])
def test_param_logical_axes_match_the_reference_partition_spec(head):
    jcfg, tcfg = _cfgs(TRAIN, "f32")
    jmodel, tmodel = (JCrossHead(jcfg), CrossEncoderHead(tcfg)) if head else (JTextEncoder(jcfg), TextEncoder(tcfg))
    got = param_logical_axes(tmodel, tcfg)
    assert got == _reference_axes(jmodel, jcfg)
    assert got["encoder.layers.0.attention.qkv.weight" if head else "layers.0.attention.qkv.weight"] == ("heads",
                                                                                                          "embed")


def test_placements_follow_the_logical_rules():
    mesh = sharding.make_mesh(devices=["cpu"] * 8, model_parallel=2)
    assert sharding.LOGICAL_RULES == (("embed", None), ("heads", "model"), ("mlp", "model"), ("vocab", None),
                                      ("batch", "data"))
    p = sharding.param_sharding(mesh, param_logical_axes(TextEncoder(EncoderConfig(**TRAIN)), None))
    assert p["layers.0.attention.qkv.weight"].spec == ("model", None)
    assert p["layers.0.mlp_out.weight"].spec == (None, "model")
    assert p["tok_embed.weight"].spec == (None, None) and p["layers.0.ln_att.bias"].spec == ()
    assert sharding.data_sharding(mesh, 3).spec == ("data", None, None) and sharding.replicated(mesh).spec == ()
    # the fused qkv splits per head inside each of q, k and v, and joins back
    w = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(24, 2)  # q | k | v, 8 rows each
    pieces = p["layers.0.attention.qkv.weight"].split(w, groups=3)
    assert [r[0].item() // 2 for r in pieces[0]] == [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19]
    assert torch.equal(p["layers.0.attention.qkv.weight"].join(pieces, groups=3), w)
    rows = sharding.data_sharding(mesh).split(torch.arange(8)[:, None])
    assert [r.flatten().tolist() for r in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not split"):
        sharding.data_sharding(mesh).split(torch.zeros(6, 2))


# ------------------------------------------------- kernels with no backward


def _no_backward_calls():
    from pathway_tpu_torch.ops.knn_topk import knn_topk, knn_topk_sharded
    from pathway_tpu_torch.ops.paged_attention import paged_decode_attention

    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    q, docs, bias = r(2, 16), r(40, 16), torch.zeros(40)
    pages = r(4, 4, 16)
    tables, lens = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32), torch.tensor([5, 8], dtype=torch.int32)
    x, w, b = r(6, 16).bfloat16(), r(16, 16).bfloat16(), r(16)
    return {
        "gemm_bias_act": (lambda t: tfl.gemm_bias_act(x, t, b), w),
        "gemm_bias_residual_layernorm": (
            lambda t: tfl.gemm_bias_residual_layernorm(x, t, b, x.float(), torch.ones(16), torch.zeros(16), 1e-12), w
        ),
        "knn_topk": (lambda t: knn_topk(t, docs, k=4, bias=bias), q),
        "knn_topk_sharded": (lambda t: knn_topk_sharded(q, [t[:20], t[20:]], [bias[:20], bias[20:]], k=4), docs),
        "paged_decode_attention": (lambda t: paged_decode_attention(t, pages, pages, tables, lens, n_heads=2), q),
    }


@pytest.mark.parametrize("kernel", list(_no_backward_calls()))
def test_kernels_without_backward_raise_under_grad(kernel):
    """B2, B2s, B5 and the two GEMMs called alone have no backward in the
    reference: with grad enabled and an operand that requires it they raise
    naming the kernel (never a detached result); otherwise they run."""
    call, operand = _no_backward_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"^{kernel} has no backward"):
        call(operand.clone().requires_grad_(True))
    with torch.no_grad():
        call(operand.clone().requires_grad_(True))
    call(operand)


def test_serving_paths_record_no_backward(monkeypatch):
    """The encoder's module, packed and whole-layer paths and the
    cross-encoder's score run with parameters that require grad while grad
    is enabled outside them, and save nothing for a backward: none goes
    through an autograd Function or raises."""
    from pathway_tpu_torch.models.sentence_encoder import CrossEncoderScorer, SentenceEncoder
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer

    def refuse(*args, **kwargs):
        raise AssertionError("a serving path recorded a backward")

    for fn in (tfa._MaskedAttention, tfa._SegmentAttention, tfl._EncoderForward):
        monkeypatch.setattr(fn, "apply", refuse)
    cfg = EncoderConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                        max_position=64)
    enc = SentenceEncoder(config=cfg, device="cpu", max_batch=4, max_seq_len=32)
    enc.tokenizer = WordPieceTokenizer(vocab_size=cfg.vocab_size)
    assert torch.is_grad_enabled() and all(p.requires_grad for p in enc.module.parameters())
    assert enc.encode(["a short text", "another one"]).shape == (2, 32)
    assert enc.encode_tokens([[101, 7, 8, 102], [101, 9, 102]]).shape == (2, 32)
    seg = np.array([[0, 0, 1, 1, 1, -1, -1, -1]], np.int32)
    ids = np.array([[101, 7, 101, 8, 9, 0, 0, 0]])
    pos = np.array([[0, 1, 0, 1, 2, 0, 0, 0]])
    out = enc._run_packed(ids, pos, seg, np.array([2, 3], np.float32))
    assert out.shape[1] == 32 and out.grad_fn is None
    scorer = CrossEncoderScorer(config=EncoderConfig.cross_encoder_l6(**{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size", "max_position")}),
        max_seq_len=32, max_batch=4, device="cpu")
    scorer.tokenizer = WordPieceTokenizer(vocab_size=cfg.vocab_size)
    assert scorer.score([("q", "a doc"), ("q", "another doc")]).shape == (2,)


def test_build_guard_names_the_kernel():
    with pytest.raises(RuntimeError, match="^demo has no backward"):
        _build.no_backward("demo", torch.zeros(1, requires_grad=True))
    _build.no_backward("demo", torch.zeros(1), None)
