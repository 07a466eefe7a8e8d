"""The port's CLIP dual encoder held against the JAX package's, on the CPU.

At the reference tests' small geometry (images 32 x 32 in patches of 8, one
layer of width 64 in each tower), the reference's seeded weights are
carried over with ``weights.from_jax_clip_params`` and the same numpy
images and texts go through both packages: at f32 the normalised
embeddings agree within 1e-4, at bf16 each row's cosine is at least 0.999,
on both image wires and the text tower. ``_pack_yuv420`` is byte-identical
to the reference's, the yuv420 wire stays within the reference's cosine
bar of the rgb one (at f32; at bf16 its cosines are held to the
reference's), and the five staging cases of
``tests/test_clip_staging.py`` see the same ``_pipeline_events`` sequence
and the same ring counters in both packages.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.models.clip import CLIPConfig as JCLIPConfig
from pathway_tpu.models.clip import CLIPEncoder as JCLIPEncoder
from pathway_tpu_torch.models.clip import CLIPConfig, CLIPEncoder, init_clip_params
from pathway_tpu_torch.weights import from_jax_clip_params, to_jax_clip_params

GEOMETRY = dict(image_size=32, patch_size=8, vision_layers=1, vision_width=64, vision_heads=2, text_layers=1,
                text_width=64, text_heads=2, embed_dim=32)
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jax.numpy.bfloat16, torch.bfloat16)}
F32_ATOL = 1e-4  # normalised embeddings, f32 towers on both sides
BF16_MIN_COS = 0.999  # per row, bf16 towers on both sides (bf16 rounds at other places)
TEXTS = ["a photo of a cat", "two dogs playing in the snow", "", "many words in one caption " * 20]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    """(reference encoder, port encoder with the reference's weights, dtype name)."""
    jdt, tdt = DTYPES[request.param]
    jenc = JCLIPEncoder(JCLIPConfig(**GEOMETRY, dtype=jdt), max_batch=8)
    tenc = CLIPEncoder(CLIPConfig(**GEOMETRY, dtype=tdt), max_batch=8, device="cpu")
    tenc.load_state_dict(from_jax_clip_params(_np_tree(jenc.vparams), _np_tree(jenc.tparams)))
    yield jenc, tenc, request.param
    jenc.transport = tenc.transport = "yuv420"


def _images(n: int, seed: int = 7, size: int = 32) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, size, size, 3)) * 255).astype(np.uint8)


def _agree(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        cos = (got * want).sum(axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        assert cos.min() >= BF16_MIN_COS, cos


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_vision_tower_matches_the_reference(pair, wire):
    jenc, tenc, dtype = pair
    jenc.transport = tenc.transport = wire
    imgs = _images(20)  # three batches of 8 (the last padded to its bucket)
    _agree(tenc.encode_image(imgs), np.asarray(jenc.encode_image(imgs)), dtype)


def test_vision_tower_matches_the_reference_on_float_images(pair):
    jenc, tenc, dtype = pair
    imgs = np.random.default_rng(3).random((5, 32, 32, 3)).astype(np.float32)
    _agree(tenc.encode_image(imgs), np.asarray(jenc.encode_image(imgs)), dtype)


def test_text_tower_matches_the_reference(pair):
    jenc, tenc, dtype = pair
    _agree(tenc.encode_text(TEXTS), np.asarray(jenc.encode_text(TEXTS)), dtype)


def test_weights_round_trip(pair):
    jenc, tenc, _ = pair
    v, t = to_jax_clip_params(tenc.state_dict())
    for got, want in ((v, jenc.vparams), (t, jenc.tparams)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np_tree(want))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np_tree(want))):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("size", [32, 64, 224])
def test_pack_yuv420_is_byte_identical(size):
    imgs = _images(3, seed=size, size=size)
    got = CLIPEncoder._pack_yuv420(imgs)
    assert got.dtype == np.uint8 and got.tobytes() == JCLIPEncoder._pack_yuv420(imgs).tobytes()
    assert got.shape[1] * 2 == imgs[0].size  # half the bytes of an rgb row


# bf16: the two wires' cosine moves with each embedding's rounding. Port and
# reference rows agree at 1 - cos <= 3e-5 (BF16_MIN_COS's margin in practice,
# an angle of at most 0.0077 rad each); on the wires' angle of ~0.14 rad that
# moves their cosine by at most sin(0.14) * 2 * 0.0077 = 2.2e-3
WIRE_COS_BF16_ATOL = 2.5e-3


def test_yuv420_wire_close_to_rgb(pair):
    """The reference's bar (cosine above 0.99 between the two wires) at f32,
    where it holds the wire's own loss; at bf16 this data sits within the
    rounding of the bar (the reference's 0.99053 at f32 0.99056), so there the
    port's wire cosines are held to the reference's own."""
    jenc, tenc, dtype = pair
    imgs = _images(4, seed=0)
    cos = {}
    for name, enc in (("reference", jenc), ("port", tenc)):
        enc.transport = "rgb"
        ref = np.asarray(enc.encode_image(imgs))
        enc.transport = "yuv420"
        cos[name] = (ref * np.asarray(enc.encode_image(imgs))).sum(axis=1)
    if dtype == "float32":
        assert cos["port"].min() > 0.99, cos  # the reference's own bar
    np.testing.assert_allclose(cos["port"], cos["reference"], rtol=0,
                               atol=1e-5 if dtype == "float32" else WIRE_COS_BF16_ATOL)
    assert tenc._pack_yuv420(imgs).shape[1] * 2 == imgs[0].size


def test_encode_image_device_equals_encode_image(pair):
    _, tenc, _ = pair
    imgs = _images(11)
    dev = tenc.encode_image_device(imgs)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32 and dev.device.type == "cpu"
    assert np.array_equal(dev.numpy(), tenc.encode_image(imgs))
    assert tenc.encode_image(_images(0)).shape == (0, 32) and tuple(tenc.encode_image_device(_images(0)).shape) == (0, 32)


def test_seeded_weights_are_deterministic():
    cfg = CLIPConfig(**GEOMETRY)
    a, b, c = init_clip_params(cfg, 0), init_clip_params(cfg, 0), init_clip_params(cfg, 1)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if "ln_" not in k and not k.endswith("bias"))
    assert a["vision.cls"].dtype == torch.bfloat16 and a["vision.patch_proj.weight"].dtype == torch.float32


# ------------------------------------------------ the staging loop's twins


def _events(enc, imgs):
    ev: list[str] = []
    enc._pipeline_events = ev
    try:
        out = enc.encode_image(imgs)
    finally:
        enc._pipeline_events = None
    return ev, np.asarray(out)


def test_pack_ahead_precedes_dispatch(pair):
    jenc, tenc, _ = pair
    ev, _ = _events(tenc, _images(20))  # max_batch 8 -> 3 batches
    assert ev == _events(jenc, _images(20))[0]
    assert ev.index("pack:1") < ev.index("dispatch:0"), ev
    assert ev.index("pack:2") < ev.index("dispatch:1"), ev
    for i in range(3):
        assert ev.index(f"stage:{i}") < ev.index(f"dispatch:{i}"), ev
    assert ev.index("dispatch:2") < ev.index("complete:0"), ev


def test_single_batch_has_no_lookahead(pair):
    jenc, tenc, _ = pair
    ev, out = _events(tenc, _images(4))
    assert ev == _events(jenc, _images(4))[0]
    assert out.shape == (4, 32)
    assert "pack:1" not in ev
    assert ev.index("pack:0") < ev.index("stage:0") < ev.index("dispatch:0")


def test_staged_output_matches_unstaged_reference(pair):
    _, tenc, _ = pair
    imgs = _images(20)
    got = tenc.encode_image(imgs)
    ref = []
    for lo in range(0, len(imgs), 8):
        n, flat, fwd = tenc._pack_image_batch(imgs[lo : lo + 8])
        ref.append(fwd(torch.from_numpy(flat)).numpy()[:n])
    assert np.array_equal(got, np.concatenate(ref))


def test_repeat_encode_is_deterministic(pair):
    _, tenc, _ = pair
    imgs = _images(12)
    assert np.array_equal(tenc.encode_image(imgs), tenc.encode_image(imgs))


def test_ring_donates_across_batches(pair):
    jenc, tenc, _ = pair
    counters = []
    for enc in (jenc, tenc):
        enc._ring = None  # a fresh ring, so both count the same three stages
        enc.encode_image(_images(24))  # 3 batches through the 2-deep ring
        ring = enc._ring
        assert ring is not None and ring.staged >= 3 and ring.donated >= 1 and ring.in_flight() == 0
        counters.append((ring.staged, ring.donated, ring.in_flight()))
    assert counters[0] == counters[1]
