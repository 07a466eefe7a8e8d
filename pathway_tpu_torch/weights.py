"""Weight bridges between the reference's parameter trees and the port's:
the flax ``TextEncoder`` tree and the port's TextEncoder state dict, the
flax ``CrossEncoderHead`` tree (``encoder/...`` + ``classifier``) and the
port's ``CrossEncoderHead`` state dict, and the decoder's weight dict
(``decode/engine.py::init_decoder_params``), which both packages keep in
one layout (``x @ w``).

The mapping is the one ``pathway_tpu/models/encoder.py::load_hf_weights``
encodes, read in the other direction:

* a Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``;
* ``qkv`` stays one concatenated q | k | v projection;
* embeddings (``embedding`` -> ``weight``) and LayerNorm (``scale`` ->
  ``weight``, ``bias`` -> ``bias``) map one to one;
* flax ``layer_{i}`` is ``layers.{i}``.

The tree is plain nested dicts of numpy arrays (unboxed), with or without
the top-level ``"params"`` key. Values are copied exactly; every round
trip gives back the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

_DENSE = ("attention/qkv", "attention/out", "mlp_in", "mlp_out")
_NORMS = ("ln_att", "ln_mlp")


def _get(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """flax TextEncoder params (numpy) -> TextEncoder state dict (CPU)."""
    p = tree["params"] if "params" in tree else tree
    t = lambda a: torch.from_numpy(np.array(a, order="C", copy=True))  # noqa: E731
    sd = {
        "tok_embed.weight": t(p["tok_embed"]["embedding"]),
        "pos_embed.weight": t(p["pos_embed"]["embedding"]),
    }
    if "type_embed" in p:
        sd["type_embed.weight"] = t(p["type_embed"]["embedding"])
    sd["ln_embed.weight"] = t(p["ln_embed"]["scale"])
    sd["ln_embed.bias"] = t(p["ln_embed"]["bias"])
    i = 0
    while f"layer_{i}" in p:
        layer = p[f"layer_{i}"]
        pre = f"layers.{i}."
        for path in _DENSE:
            dense = _get(layer, path)
            name = pre + path.replace("/", ".")
            sd[name + ".weight"] = t(np.asarray(dense["kernel"]).T)
            sd[name + ".bias"] = t(dense["bias"])
        for ln in _NORMS:
            sd[pre + ln + ".weight"] = t(layer[ln]["scale"])
            sd[pre + ln + ".bias"] = t(layer[ln]["bias"])
        i += 1
    return sd


def to_jax_params(state_dict: dict) -> dict:
    """TextEncoder state dict -> flax-layout params tree of numpy arrays."""
    a = lambda key: state_dict[key].detach().cpu().numpy().copy()  # noqa: E731
    p: dict = {
        "tok_embed": {"embedding": a("tok_embed.weight")},
        "pos_embed": {"embedding": a("pos_embed.weight")},
    }
    if "type_embed.weight" in state_dict:
        p["type_embed"] = {"embedding": a("type_embed.weight")}
    p["ln_embed"] = {"scale": a("ln_embed.weight"), "bias": a("ln_embed.bias")}
    i = 0
    while f"layers.{i}.attention.qkv.weight" in state_dict:
        pre = f"layers.{i}."
        layer: dict = {"attention": {}}
        for path in _DENSE:
            name = pre + path.replace("/", ".")
            dense = {"kernel": np.ascontiguousarray(a(name + ".weight").T), "bias": a(name + ".bias")}
            if path.startswith("attention/"):
                layer["attention"][path.split("/")[1]] = dense
            else:
                layer[path] = dense
        for ln in _NORMS:
            layer[ln] = {"scale": a(pre + ln + ".weight"), "bias": a(pre + ln + ".bias")}
        p[f"layer_{i}"] = layer
        i += 1
    return {"params": p}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _a(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def from_jax_cross_encoder_params(tree: dict) -> dict[str, torch.Tensor]:
    """flax CrossEncoderHead params -> CrossEncoderHead state dict (CPU)."""
    p = tree["params"] if "params" in tree else tree
    sd = {f"encoder.{k}": v for k, v in from_jax_params(p["encoder"]).items()}
    sd["classifier.weight"] = _t(np.asarray(p["classifier"]["kernel"]).T)
    sd["classifier.bias"] = _t(p["classifier"]["bias"])
    return sd


def to_jax_cross_encoder_params(state_dict: dict) -> dict:
    """CrossEncoderHead state dict -> flax-layout params tree of numpy arrays."""
    enc = {k[len("encoder.") :]: v for k, v in state_dict.items() if k.startswith("encoder.")}
    p = {
        "encoder": to_jax_params(enc)["params"],
        "classifier": {
            "kernel": np.ascontiguousarray(_a(state_dict["classifier.weight"]).T),
            "bias": _a(state_dict["classifier.bias"]),
        },
    }
    return {"params": p}


def from_jax_decoder_params(params: dict) -> dict:
    """The JAX decoder's weight dict (jax or numpy arrays) -> the same dict
    of CPU tensors."""
    out = {k: _t(np.asarray(v)) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: _t(np.asarray(v)) for k, v in lp.items()} for lp in params["layers"]]
    return out


def to_jax_decoder_params(params: dict) -> dict:
    """The port's decoder weight dict -> the same dict of numpy arrays."""
    out = {k: _a(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: _a(v) for k, v in lp.items()} for lp in params["layers"]]
    return out


# ------------------------------------------------------ HF checkpoints

_SAFETENSORS_NP = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``model.safetensors`` file -> {name: CPU tensor}, without the
    ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header of dtype, shape and data offsets, then the raw bytes. Tensors
    are read through numpy (bf16 through ``torch.frombuffer``) and copied."""
    import json

    with open(path, "rb") as f:
        blob = f.read()
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8 : 8 + n])
    data = memoryview(blob)[8 + n :]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            t = torch.frombuffer(bytearray(data[start:end]), dtype=torch.bfloat16)
        else:
            t = torch.from_numpy(np.frombuffer(data[start:end], dtype=_SAFETENSORS_NP[meta["dtype"]]).copy())
        out[name] = t.reshape(shape)
    return out


def _read_checkpoint(checkpoint_dir: str) -> dict[str, torch.Tensor]:
    """``model.safetensors`` first, then ``pytorch_model.bin``, as the
    reference's ``load_hf_weights`` looks for them."""
    import os

    st_path = os.path.join(checkpoint_dir, "model.safetensors")
    pt_path = os.path.join(checkpoint_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    if os.path.exists(pt_path):
        return torch.load(pt_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")


def load_hf_weights(state_dict: dict, checkpoint_dir: str) -> dict[str, torch.Tensor]:
    """A HuggingFace BERT-named checkpoint in ``checkpoint_dir`` mapped onto
    a TextEncoder state dict, or a CrossEncoderHead one (``encoder.``
    names and a ``classifier``). Port of
    ``pathway_tpu/models/encoder.py::load_hf_weights``: names may carry the
    prefix ``""``, ``"bert."`` or ``"model."``; q, k and v are concatenated
    into one qkv projection. Returns a new state dict (``state_dict`` is
    left as it is); raises FileNotFoundError without a checkpoint and
    KeyError on a missing name, before anything is replaced."""
    ckpt = _read_checkpoint(checkpoint_dir)

    def g(name: str) -> torch.Tensor:
        for pfx in ("", "bert.", "model."):
            if pfx + name in ckpt:
                return ckpt[pfx + name]
        raise KeyError(name)

    enc = "encoder." if "encoder.tok_embed.weight" in state_dict else ""
    new = {
        enc + "tok_embed.weight": g("embeddings.word_embeddings.weight"),
        enc + "pos_embed.weight": g("embeddings.position_embeddings.weight"),
        enc + "ln_embed.weight": g("embeddings.LayerNorm.weight"),
        enc + "ln_embed.bias": g("embeddings.LayerNorm.bias"),
    }
    if enc + "type_embed.weight" in state_dict:
        new[enc + "type_embed.weight"] = g("embeddings.token_type_embeddings.weight")
    i = 0
    while f"{enc}layers.{i}.attention.qkv.weight" in state_dict:
        pre, hf = f"{enc}layers.{i}.", f"encoder.layer.{i}."
        for part in ("weight", "bias"):
            new[pre + "attention.qkv." + part] = torch.cat(
                [g(f"{hf}attention.self.{p}.{part}") for p in ("query", "key", "value")]
            )
            new[pre + "attention.out." + part] = g(hf + "attention.output.dense." + part)
            new[pre + "ln_att." + part] = g(hf + "attention.output.LayerNorm." + part)
            new[pre + "mlp_in." + part] = g(hf + "intermediate.dense." + part)
            new[pre + "mlp_out." + part] = g(hf + "output.dense." + part)
            new[pre + "ln_mlp." + part] = g(hf + "output.LayerNorm." + part)
        i += 1
    if "classifier.weight" in state_dict:
        new["classifier.weight"] = g("classifier.weight")
        new["classifier.bias"] = g("classifier.bias")
    return {**state_dict, **{k: v.to(state_dict[k].dtype) for k, v in new.items()}}
