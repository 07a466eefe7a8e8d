"""CPU checks around the redesigned kernels: the wrappers' operand checks
and the build cache's key, which must cover every header in ``csrc/``."""

from __future__ import annotations

import os
import shutil

import pytest
import torch

from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops import fused_attention as tfa
from pathway_tpu_torch.ops.fused_attention import masked_attention_operands, segment_attention_operands
from pathway_tpu_torch.ops.fused_layer import (
    gemm_bias_act_operands,
    gemm_bias_residual_layernorm,
    gemm_bias_residual_layernorm_operands,
    gemm_bias_residual_layernorm_reference,
)


def _gemm_operands(m=8, n=16, k=32):
    return (torch.zeros(m, k, dtype=torch.bfloat16), torch.zeros(n, k, dtype=torch.bfloat16),
            torch.zeros(n, dtype=torch.float32))


@pytest.mark.parametrize("m,n,k", [(8, 16, 32), (1, 1152, 384), (32, 1152, 384), (17, 1536, 40), (0, 384, 384)])
def test_gemm_operands_pass_and_give_the_shape(m, n, k):
    assert gemm_bias_act_operands(*_gemm_operands(m, n, k)) == (m, n, k)


@pytest.mark.parametrize(
    "case",
    ["k_not_multiple_of_8", "n_not_multiple_of_8", "x_not_contiguous", "w_not_contiguous", "x_float32",
     "bias_bf16", "w_k_mismatch", "bias_n_mismatch", "x_rank_3"],
)
def test_gemm_operands_raise(case):
    x, w, b = _gemm_operands()
    if case == "k_not_multiple_of_8":
        x, w, b = _gemm_operands(k=12)
    elif case == "n_not_multiple_of_8":
        x, w, b = _gemm_operands(n=12)
    elif case == "x_not_contiguous":
        x = torch.zeros(32, 8, dtype=torch.bfloat16).t()
    elif case == "w_not_contiguous":
        w = torch.zeros(32, 16, dtype=torch.bfloat16).t()
    elif case == "x_float32":
        x = x.float()
    elif case == "bias_bf16":
        b = b.bfloat16()
    elif case == "w_k_mismatch":
        w = torch.zeros(16, 40, dtype=torch.bfloat16)
    elif case == "bias_n_mismatch":
        b = torch.zeros(8)
    elif case == "x_rank_3":
        x = x[None]
    with pytest.raises(ValueError):
        gemm_bias_act_operands(x, w, b)


@pytest.mark.parametrize("on_meta", ["x", "w", "b"])
def test_gemm_operands_on_two_devices_raise(on_meta):
    ops = dict(zip("xwb", _gemm_operands()))
    ops[on_meta] = ops[on_meta].to("meta")
    with pytest.raises(ValueError, match="lie on"):
        gemm_bias_act_operands(ops["x"], ops["w"], ops["b"])


@pytest.mark.parametrize("b,s", [(2, 100), (1, 512), (3, 37)])
def test_segment_operands_pass_and_give_the_shape(b, s):
    qkv = torch.zeros(b, s, 3 * 384, dtype=torch.bfloat16)
    seg = torch.zeros(b, s, dtype=torch.int32)
    assert segment_attention_operands(qkv, seg, 12) == (b, s, 384, 32, 32)


@pytest.mark.parametrize("which", ["masked", "segment"])
@pytest.mark.parametrize(
    "d,heads,hd,kernel_hd",
    [(384, 12, 32, 32), (768, 12, 64, 64), (1024, 8, 128, 128), (384, 8, 48, 64), (96, 4, 24, 32),
     (384, 4, 96, 128), (100, 4, 25, 32), (127, 1, 127, 128), (384, 2, 192, 256), (256, 1, 256, 256),
     (312, 12, 26, 32)],
)
def test_attention_operands_take_head_dims_up_to_128(which, d, heads, hd, kernel_hd):
    """Kernels for head dims 32, 64, 128 and 256; any other head dim up to
    256 is zero-padded to the next of these."""
    qkv = torch.zeros(2, 37, 3 * d, dtype=torch.bfloat16)
    other = torch.zeros(2, 37, dtype=torch.bool if which == "masked" else torch.int32)
    check = masked_attention_operands if which == "masked" else segment_attention_operands
    assert check(qkv, other, heads) == (2, 37, d, hd, kernel_hd)


@pytest.mark.parametrize("which", ["masked", "segment"])
@pytest.mark.parametrize("case", ["head_dim_over_128", "s_over_512", "heads_do_not_split", "other_shape",
                                  "other_device", "qkv_bf16_required"])
def test_attention_operands_raise_naming_the_limits(which, case):
    b, s, d, heads = 2, 64, 384, 12
    if case == "head_dim_over_128":
        heads = 1  # head dim 384: over the largest kernel's 256
    elif case == "s_over_512":
        s = 513
    elif case == "heads_do_not_split":
        heads = 7
    qkv = torch.zeros(b, s, 3 * d, dtype=torch.float32 if case == "qkv_bf16_required" else torch.bfloat16)
    other = torch.zeros(b, s - (case == "other_shape"), dtype=torch.int32)
    if case == "other_device":
        other = other.to("meta")
    check = masked_attention_operands if which == "masked" else segment_attention_operands
    match = {"head_dim_over_128": "head dims up to 256", "s_over_512": "S <= 512"}.get(case)
    with pytest.raises(ValueError, match=match):
        check(qkv, other, heads)


@pytest.mark.parametrize("hd", [24, 48, 96, 100, 160])
@pytest.mark.parametrize("which", ["masked", "segment"])
def test_zero_padded_heads_keep_the_result(which, hd):
    """The wrapper's padding, run through the plain versions in float32:
    heads padded with zero columns to the kernel's head dim, at the true
    head dim's scale (here folded into q), give the unpadded result in the
    kept columns."""
    import math

    heads, b, s = 3, 2, 40
    hdp = next(k for k in tfa._HEAD_DIMS if k >= hd)
    g = torch.Generator().manual_seed(hd)
    qkv = torch.randn(b, s, 3 * heads * hd, generator=g)
    if which == "masked":
        other = torch.arange(s)[None, :] < torch.tensor([[s], [s // 3]])
        run = lambda x: tfa.masked_attention_reference(x, other, heads)  # noqa: E731
    else:
        other = (torch.arange(s) // 7).repeat(b, 1).int()
        other[1, -5:] = -1
        run = lambda x: tfa.segment_attention_reference(x, other, heads)  # noqa: E731
    padded = tfa._pad_heads(qkv, heads, hd, hdp)
    assert padded.shape == (b, s, 3 * heads * hdp)
    assert torch.equal(tfa._unpad_heads(padded[..., : heads * hdp].contiguous(), heads, hd, hdp), qkv[..., : heads * hd])
    padded[..., : heads * hdp] *= math.sqrt(hdp / hd)  # the kernel's scale is 1/sqrt(hd), not 1/sqrt(hdp)
    got = tfa._unpad_heads(run(padded), heads, hd, hdp)
    torch.testing.assert_close(got, run(qkv), rtol=1e-5, atol=1e-5)


def _ln_operands(m=8, n=384, k=32, res_dtype=torch.bfloat16):
    return (torch.zeros(m, k, dtype=torch.bfloat16), torch.zeros(n, k, dtype=torch.bfloat16), torch.zeros(n),
            torch.zeros(m, n, dtype=res_dtype), torch.ones(n), torch.zeros(n))


@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [256, 384, 512, 768, 1024])
def test_gemm_ln_operands_take_every_layernorm_width(n, res_dtype):
    assert gemm_bias_residual_layernorm_operands(*_ln_operands(17, n, 40, res_dtype)) == (17, n, 40)


@pytest.mark.parametrize("case", ["n_320", "n_2048", "k_not_multiple_of_8", "residual_f16", "residual_shape",
                                  "gamma_bf16", "w_other_device"])
def test_gemm_ln_operands_raise_naming_the_limits(case):
    ops = list(_ln_operands())
    if case == "n_320":
        ops = list(_ln_operands(n=320))
    elif case == "n_2048":
        ops = list(_ln_operands(n=2048))
    elif case == "k_not_multiple_of_8":
        ops = list(_ln_operands(k=36))
    elif case == "residual_f16":
        ops[3] = ops[3].half()
    elif case == "residual_shape":
        ops[3] = ops[3][:-1]
    elif case == "gamma_bf16":
        ops[4] = ops[4].bfloat16()
    elif case == "w_other_device":
        ops[1] = ops[1].to("meta")
    match = "N must be one of" if case.startswith(("n_", "k_")) else None
    with pytest.raises(ValueError, match=match):
        gemm_bias_residual_layernorm_operands(*ops)


@pytest.mark.parametrize("out_f32", [True, False])
def test_gemm_ln_cpu_takes_the_plain_version(out_f32):
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(9, 16, generator=g).bfloat16(), torch.randn(256, 16, generator=g).bfloat16()
    b, r = torch.randn(256, generator=g), torch.randn(9, 256, generator=g)
    gam, bet = torch.randn(256, generator=g), torch.randn(256, generator=g)
    got = gemm_bias_residual_layernorm(x, w, b, r, gam, bet, 1e-12, out_f32=out_f32)
    want = gemm_bias_residual_layernorm_reference(x, w, b, r, gam, bet, 1e-12, out_f32=out_f32)
    assert (got[0] is None) == (not out_f32) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["head_dim_over_128", "s_over_512", "qkv_not_contiguous", "qkv_float32",
                                  "seg_shape", "seg_other_device", "width_not_3d"])
def test_segment_operands_raise(case):
    b, s, heads = 2, 64, 12
    qkv = torch.zeros(b, s, 3 * 384, dtype=torch.bfloat16)
    seg = torch.zeros(b, s, dtype=torch.int32)
    if case == "s_over_512":
        qkv, seg = torch.zeros(1, 513, 3 * 384, dtype=torch.bfloat16), torch.zeros(1, 513, dtype=torch.int32)
    elif case == "head_dim_over_128":
        heads = 1  # head dim 384: over the largest kernel's 256
    elif case == "qkv_not_contiguous":
        qkv = torch.zeros(s, b, 3 * 384, dtype=torch.bfloat16).transpose(0, 1)
    elif case == "qkv_float32":
        qkv = qkv.float()
    elif case == "seg_shape":
        seg = seg[:, :-1]
    elif case == "seg_other_device":
        seg = seg.to("meta")
    elif case == "width_not_3d":
        qkv = torch.zeros(b, s, 1000, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        segment_attention_operands(qkv, seg, heads)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", str(copy))
    return copy


def test_lib_path_covers_every_header(csrc_copy):
    before = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert len(set(before.values())) == len(before)
    assert all(p.startswith(_build.BUILD_DIR) for p in before.values())
    (csrc_copy / "tile_helpers.cuh").write_bytes(b"// helpers v1\n")
    with_header = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert all(with_header[s] != before[s] for s in before)
    (csrc_copy / "tile_helpers.cuh").write_bytes(b"// helpers v2\n")  # an edited header
    edited = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert all(edited[s] != with_header[s] for s in before)
    assert {s: _build._lib_path(s) for s in _build.SOURCES} == edited  # stable while nothing changes


def test_lib_path_moves_with_its_own_source_only(csrc_copy):
    before = {s: _build._lib_path(s) for s in _build.SOURCES}
    src = csrc_copy / "segment_attention.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert after["segment_attention.cu"] != before["segment_attention.cu"]
    assert all(after[s] == before[s] for s in before if s != "segment_attention.cu")
    assert os.path.basename(after["segment_attention.cu"]).startswith("libsegment_attention-")


_C_TYPES = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


@pytest.mark.parametrize(
    "source,entry", [(s, e) for s, entries in sorted(_build.SOURCES.items()) for e in sorted(entries)]
)
def test_bound_argtypes_match_the_c_signature(source, entry):
    """ctypes passes what ``SOURCES`` says: a count or type that differs
    from the C definition would only show as a failed call on the card."""
    import re

    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    sig = re.search(rf"\bint {entry}\(([^)]*)\)", text)
    assert sig, f"{entry} is not defined in {source}"
    params = [" ".join(p.split()[:-1]).replace("const ", "").replace(" *", "*") for p in sig.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == [t.__name__ for t in _build.SOURCES[source][entry]]


@pytest.mark.parametrize("n,width", [(8, 256), (128, 256), (256, 256), (312, 384), (640, 768), (776, 1024), (1024, 1024)])
def test_ln_width_pads_to_the_next_kernel_width(n, width):
    from pathway_tpu_torch.ops.fused_layer import _ln_width

    assert _ln_width(n) == width


def test_ln_width_over_1024_raises():
    from pathway_tpu_torch.ops.fused_layer import _ln_width

    with pytest.raises(ValueError, match="up to 1024"):
        _ln_width(1032)


def test_pad_to_zero_pads_and_keeps_one_copy_per_parameter():
    """A parameter is padded once (the copy is kept while it lives and is
    not written to); an activation is padded per call."""
    from pathway_tpu_torch.ops import fused_layer as fl

    w = torch.arange(12.0).reshape(3, 4)
    p = fl._pad_to(w, (8, 8), keep=True)
    assert p.shape == (8, 8) and torch.equal(p[:3, :4], w) and p[3:].abs().sum() == 0 and p[:, 4:].abs().sum() == 0
    assert fl._pad_to(w, (8, 8), keep=True) is p
    w.add_(1.0)  # written to: the kept copy is stale and made anew
    q = fl._pad_to(w, (8, 8), keep=True)
    assert q is not p and torch.equal(q[:3, :4], w)
    assert fl._pad_to(w, (3, 4), keep=True) is w
    x = torch.ones(2, 5)
    assert fl._pad_to(x, (2, 8)) is not fl._pad_to(x, (2, 8))
    key = (id(w), (8, 8))
    assert key in fl._PADDED
    del w, p, q
    import gc

    gc.collect()
    assert key not in fl._PADDED
