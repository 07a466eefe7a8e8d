"""CPU checks around the redesigned kernels: the wrappers' operand checks
and the build cache's key, which must cover every header in ``csrc/``."""

from __future__ import annotations

import os
import shutil

import pytest
import torch

from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops.fused_attention import segment_attention_operands
from pathway_tpu_torch.ops.fused_layer import gemm_bias_act_operands


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
    assert segment_attention_operands(qkv, seg, 12) == (b, s, 384, 32)


@pytest.mark.parametrize("case", ["s_over_512", "head_dim_64", "qkv_not_contiguous", "qkv_float32",
                                  "seg_shape", "seg_other_device", "width_not_3d"])
def test_segment_operands_raise(case):
    b, s, heads = 2, 64, 12
    qkv = torch.zeros(b, s, 3 * 384, dtype=torch.bfloat16)
    seg = torch.zeros(b, s, dtype=torch.int32)
    if case == "s_over_512":
        qkv, seg = torch.zeros(1, 513, 3 * 384, dtype=torch.bfloat16), torch.zeros(1, 513, dtype=torch.int32)
    elif case == "head_dim_64":
        heads = 6
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
