"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python chip_smoke.py

Builds the port's kernels from ``pathway_tpu_torch/csrc`` with nvcc, holds
every kernel against its plain PyTorch version at the main paths' shapes
(with times, bounds and a PyTorch yardstick; B2 at 1, 16 and 256 queries,
both of its partial passes timed at 16; B5 at head dims 64, 128, 48 and,
staged in column tiles, 512 and 320; attention and packed attention at S
1024; the geometries that run zero-padded: attention at head dim 256,
LayerNorm widths 128 and 312, a GEMM with K 300 and N 900, and whole layers
at the widths of bert-tiny and TinyBERT-312; the staged LayerNorm width
1536; ``knn_topk_sharded`` at 1, 16 and 256 queries over 4 shards of 2^20
rows on the mesh below), times the index's tie-ordered top-k beside
``torch.topk``, then drives eight paths, each with the launch counters set
to 0 just before it and read just after:

* ``main_path`` (MiniLM-L6): 16,384 synthetic documents ->
  ``SentenceEncoder.encode_device`` -> ``DeviceKnnIndex.add_batch_device``
  (filled to 1,048,576 rows) -> text queries -> ``search_batch`` /
  ``search_texts_batch`` (single queries take B2's streaming pass, the
  batch of 512 its tensor-core pass; both must launch);
* ``rag_path``: ``FusedRagPipeline`` over MiniLM-L6 and a cross_encoder_l6
  reranker: 16 long-tailed epochs of 1,024 chunks through the segment
  packer (kernel B4), 512 single queries, one batch of 512, and
  ``answer_batch`` of 64 with the default decoder;
* ``decode_path``: ``DecodeEngine`` (kernel B5: its split and combine
  kernels must both launch) serving 64 prompts with continuous batching,
  each arrival preceded by a ``DeviceReranker.order``;
* ``engine_path``: the dataflow engine as a user drives it, ``import
  pathway_tpu_torch as pw``: 131,072 documents streamed through
  ``pw.io.python.read`` (128 epochs of 1,024) -> ``DataIndex(BruteForceKnn(
  embedder=SentenceTransformerEmbedder()))`` -> 512 single text queries
  and one epoch of 512 through ``query_as_of_now`` -> ``pw.io.subscribe`` ->
  ``pw.run``; gated on the kernels' launches, ``add_batch_device`` carrying
  every ingest epoch, hits equal to the library path's, and a KNNIndex's
  neighbour sets equal on 1 and 4 engine workers;
* ``server_path``: the README's RAG document server as written, on the
  port: 8,192 files of synthetic prose (about 22,000 chunks) ->
  ``pw.io.fs.read(format="binary", mode="streaming", with_metadata=True)``
  -> ``VectorStoreServer(embedder=SentenceTransformerEmbedder(),
  parser=ParseUtf8(), splitter=TokenCountSplitter())`` ->
  ``run_server(threaded=True)``, driven over HTTP: 512 sequential
  ``/v1/retrieve``, 64 filtered, a burst of 64 concurrent requests,
  ``/v1/statistics`` and ``/v1/inputs``, then 256 new files, 64 modified
  and 64 deleted while serving; gated on the kernels' launches,
  ``add_batch_device`` carrying every ingest epoch, every unfiltered answer
  equal to the library path's, filters, file counts and the live changes;
* ``mesh_path``: on a ``DeviceMesh`` of every visible card when there are
  two or more, else 4 data shards on ``cuda:0`` (an explicit device list):
  ``SentenceEncoder(mesh=)`` -> ``DeviceKnnIndex(reserved_space=2^22,
  mesh=)`` (4 x 2^20 rows, filled to 15/16, 1 % removed) beside an
  unsharded twin, 512 single text queries and a batch of 512, then
  ``pw.run(mesh=)`` over ``DataIndex(BruteForceKnn(embedder=
  SentenceTransformerEmbedder(mesh=)))`` with 32,768 streamed documents;
  gated on the per-shard passes and the cross-shard merge launching, hits
  equal to the twin's, the mesh encoder against the single-device one, the
  engine's hits equal to the same pipeline without a mesh, and no mesh left
  installed after the run.

Each phase prints one JSON line. The last three lines are the card's name
and power limit, the ``kernels`` line and ``{"ok": true, ...}``. Any failure
exits non-zero; with no CUDA device it exits 2 and prints no result.
Imports no JAX.

    python chip_smoke.py --kernels [TREE]

runs only the build and the kernel phase (every kernel held and timed, no
path, launches 0) and ends with the card's line and the ``kernels`` line;
with TREE, against the port of that checkout (another commit unpacked with
``git archive``), so two versions' kernels compare on one card in turns.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s
HBM_BYTES = 3.35e12  # H100 SXM device-memory bytes/s
SEED = 0
# kernel vs plain version: both sum in f32 but in other orders, so a bf16
# output may differ by one bf16 rounding step, an f32 output by 1e-4
# relative; a whole layer chains five such kernels
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1.6e-2, atol=3e-2)
# a whole encoder against its plain version: the bound the JAX package holds
# between its own kernel and module (max abs error, min cosine)
ENCODER_TOL = (3e-2, 0.999)
# cross-encoder logits through six bf16 layers against the same scorer with
# plain attention: a whole layer's tolerance
RERANK_TOL = dict(rtol=1.6e-2, atol=3e-2)
# kernel and plain decode engines may part only where the plain logits' top
# two lie closer than this (the two attentions sum in other orders)
NEAR_TIE = 1e-4
DEV = "cuda"
ALT_TREE = False  # set by --kernels TREE: the kernels of another checkout


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def held(name: str, got, want, *, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises when ``got`` is
    not finite or any element lies beyond ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    if not got.isfinite().all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - want).abs()
    bad = int((diff > atol + rtol * want.abs()).sum())
    if bad:
        raise AssertionError(
            f"{name} disagrees with its plain version: {bad} elements beyond rtol {rtol} / atol {atol}, "
            f"max abs err {diff.max().item()}"
        )
    return diff.max().item()


def held_embeddings(name: str, got, want) -> tuple[float, float]:
    """(max abs error, min cosine) of unit embeddings against their plain
    version; raises outside ``ENCODER_TOL``."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    cos = float((got * want).sum(axis=1).min())
    if not (np.isfinite(got).all() and err < ENCODER_TOL[0] and cos > ENCODER_TOL[1]):
        raise AssertionError(f"{name} disagrees with the plain path: max abs err {err}, min cos {cos}")
    return err, cos


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync_cards(torch, devices=None) -> None:
    """Wait for every card in ``devices`` (each once), or the current one."""
    for dev in sorted({str(d) for d in devices}) if devices else [None]:
        torch.cuda.synchronize(dev)


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph and replayed, so no host launch cost sits between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5, warmup=1) / reps


def host_ms(fn, reps: int = 200) -> float:
    """Host time of one call of ``fn``: the rate at which calls are enqueued."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env(torch) -> dict:
    from pathway_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60, check=True)
    env = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "device": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
    }
    emit("env", **env)
    return env


def phase_build() -> None:
    from pathway_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(_build.SOURCES))


def _entry(name, source, replaces, kernel_key, err, ms, plain_ms, flops, nbytes, peak, library_ms, **extra):
    b_ms, b_by = bound(flops, nbytes, peak)
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "kernel_key": kernel_key,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": library_ms, **extra,
    }
    emit("kernel", **entry)
    return entry


def phase_kernels(torch) -> list[dict]:
    """Every kernel against its plain version, at the main path's shapes."""
    import torch.nn.functional as F

    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params
    from pathway_tpu_torch.ops import fused_layer as fl
    from pathway_tpu_torch.ops.fused_attention import masked_attention, masked_attention_reference
    from pathway_tpu_torch.ops.knn import _pallas_bias
    from pathway_tpu_torch.ops.knn_topk import knn_topk, knn_topk_reference, topk_agreement

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cfg = EncoderConfig.minilm_l6()
    d, h, ffn, eps = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.layer_norm_eps
    hd = d // h
    lp = {k: v.to(dev) for k, v in fl.layer_params(init_params(cfg, seed=SEED), 0).items()}
    w = {k: v.to(torch.bfloat16).contiguous() for k, v in lp.items() if k.endswith("weight") and "ln" not in k}
    entries = []
    src_gemm = "pathway_tpu_torch/csrc/gemm_epilogue.cu"
    src_attn = "pathway_tpu_torch/csrc/masked_attention.cu"
    b1 = "pathway_tpu/ops/fused_layer.py:239"

    # ---- B1: one layer over 1024 sequences at S = 160, lengths in [80, 160], 16 of them 0
    B, S = 1024, 160
    x = torch.randn(B, S, d, device=dev, generator=g).bfloat16()
    lens = torch.randint(80, S + 1, (B,), device=dev, generator=g, dtype=torch.int32)
    lens[-16:] = 0
    tokens = x.reshape(-1, d)
    M = tokens.shape[0]
    lp_t = fl.prepare_params(lp, cfg)
    layer_k = lambda: fl.fused_layer_tokens(tokens, lens, lp_t, n_heads=h, seq=S, eps=eps)  # noqa: E731
    layer_p = lambda: fl.fused_layer_tokens_reference(tokens, lens, lp_t, n_heads=h, seq=S, eps=eps)  # noqa: E731
    layer_err = held("B1 layer", layer_k(), layer_p(), **LAYER_TOL)
    live_lens = lens.double()
    n_live = int((live_lens > 0).sum())
    layer_flops = 2 * n_live * S * (3 * d * d + d * d + 2 * d * ffn) + 4 * h * hd * float((live_lens**2).sum())
    layer_bytes = 2 * (2 * M * d) + 2 * (4 * d * d + 2 * d * ffn)
    lb_ms, lb_by = bound(layer_flops, layer_bytes, PEAK_BF16)
    emit(
        "b1_layer", shape=[M, d], seq=S, live_sequences=n_live, max_abs_err=layer_err,
        ms=cuda_ms(layer_k), plain_ms=cuda_ms(layer_p, reps=3), bound_ms=lb_ms, bound_by=lb_by,
    )

    # the layer's own intermediates feed each kernel at its main-path shape
    qkv = fl.gemm_bias_act(tokens, w["attention.qkv.weight"], lp["attention.qkv.bias"], False)
    mask = torch.arange(S, device=dev)[None, :] < lens[:, None]
    ctx = masked_attention(qkv.view(-1, S, 3 * d), mask, h, True).view(-1, d)
    h1, h1b = fl.gemm_bias_residual_layernorm(
        ctx, w["attention.out.weight"], lp["attention.out.bias"], tokens, lp["ln_att.weight"], lp["ln_att.bias"], eps
    )
    mid = fl.gemm_bias_act(h1b, w["mlp_in.weight"], lp["mlp_in.bias"], True)

    # the main path's shapes: a batch of 1024 x 160 and the single-query
    # embed, one query at seq bucket 32; a call that small is host-bound, so
    # its host time and its device time alone (CUDA-graph replay) are kept too
    for tag, xin, wk, bk, act in (("qkv", tokens, "attention.qkv.weight", "attention.qkv.bias", False),
                                  ("mlp_in", h1b, "mlp_in.weight", "mlp_in.bias", True),
                                  ("qkv,single_query", tokens[:32].contiguous(), "attention.qkv.weight",
                                   "attention.qkv.bias", False)):
        ww, bb = w[wk], lp[bk]
        n, k = ww.shape
        m = xin.shape[0]
        name = f"gemm_bias_act[{tag}]"
        err = held(name, fl.gemm_bias_act(xin, ww, bb, act), fl.gemm_bias_act_reference(xin, ww, bb, act), **BF16_TOL)
        bb16 = bb.bfloat16()
        lib = (lambda: F.gelu(F.linear(xin, ww, bb16), approximate="tanh")) if act else (lambda: F.linear(xin, ww, bb16))
        kern = lambda: fl.gemm_bias_act(xin, ww, bb, act)  # noqa: E731
        single = m < 1024
        extra = {"host_ms": host_ms(kern), "graph_ms": graph_ms(kern), "library_graph_ms": graph_ms(lib)} if single else {}
        entries.append(_entry(
            name, src_gemm, b1, "gemm_bias_act", err,
            cuda_ms(kern, reps=200 if single else 10),
            cuda_ms(lambda: fl.gemm_bias_act_reference(xin, ww, bb, act), reps=3),
            2.0 * m * n * k, 2 * m * k + 2 * n * k + 4 * n + 2 * m * n, PEAK_BF16, cuda_ms(lib, reps=200 if single else 10),
            shape=[m, k, n], **extra,
        ))

    def ln_entry(name, xin, ww, bb, res, gam, bet, out_f32):
        m_, k_ = xin.shape
        n = ww.shape[0]
        kern = lambda: fl.gemm_bias_residual_layernorm(xin, ww, bb, res, gam, bet, eps, out_f32=out_f32)  # noqa: E731
        plain = lambda: fl.gemm_bias_residual_layernorm_reference(xin, ww, bb, res, gam, bet, eps, out_f32=out_f32)  # noqa: E731
        (gf, gb), (pf, pb) = kern(), plain()
        err = held(name, gb, pb, **BF16_TOL)
        if out_f32:
            err = max(err, held(name + " f32", gf, pf, **F32_TOL))
        bb16 = bb.bfloat16()
        lib = lambda: F.layer_norm((res + F.linear(xin, ww, bb16)).float(), (n,), gam, bet, eps)  # noqa: E731
        out_bytes = m_ * n * (6 if out_f32 else 2)
        return _entry(
            name, src_gemm, b1, "gemm_bias_residual_layernorm", err,
            cuda_ms(kern), cuda_ms(plain, reps=3), 2.0 * m_ * n * k_,
            2 * m_ * k_ + 2 * n * k_ + 12 * n + res.element_size() * m_ * n + out_bytes, PEAK_BF16, cuda_ms(lib),
            shape=[m_, k_, n],
        )

    for tag, xin, wk, bk, res, lnk, out_f32 in (
        ("out_ln1", ctx, "attention.out.weight", "attention.out.bias", tokens, "ln_att", True),
        ("mlp_out_ln2", mid, "mlp_out.weight", "mlp_out.bias", h1, "ln_mlp", False),
    ):
        entries.append(ln_entry(f"gemm_bias_residual_layernorm[{tag}]", xin, w[wk], lp[bk], res,
                                lp[lnk + ".weight"], lp[lnk + ".bias"], out_f32))
    # BERT-base width (N 768): out projection (K 768, bf16 residual, f32 rows
    # out) and FFN out (K 3072, f32 residual, bf16 out) over 32,768 rows,
    # and the widths that run zero-padded: the FFN out of bert-tiny (N 128 -> 256) and of
    # TinyBERT-4L-312 (N 312 -> 384), f32 residual as in the layer
    # and a staged width past 1024 (N 1536, three column chunks of 512), K 1536, bf16 residual, f32 rows out
    for n_out, k_in, res_dt, out_f32 in ((768, 768, torch.bfloat16, True), (768, 3072, torch.float32, False),
                                         (128, 512, torch.float32, False), (312, 1200, torch.float32, False),
                                         (1536, 1536, torch.bfloat16, True)):
        xin = torch.randn(32_768, k_in, device=dev, generator=g).bfloat16()
        ww = (0.03 * torch.randn(n_out, k_in, device=dev, generator=g)).bfloat16()
        res = (1.0 + torch.randn(32_768, n_out, device=dev, generator=g)).to(res_dt)
        bb, gam, bet = (0.1 * torch.randn(n_out, device=dev, generator=g) for _ in range(3))
        try:
            entries.append(ln_entry(f"gemm_bias_residual_layernorm[N{n_out},K{k_in}]", xin, ww, bb, res, 1.0 + gam,
                                    bet, out_f32))
        except ValueError:
            if not ALT_TREE:
                raise
            emit("kernel_skipped", name=f"gemm_bias_residual_layernorm[N{n_out},K{k_in}]",
                 reason="the other tree's kernel does not take this width")
        del xin, ww, res
    # K and N that are not multiples of 8 run zero-padded to them
    xin = torch.randn(32_768, 300, device=dev, generator=g).bfloat16()
    ww = (0.05 * torch.randn(900, 300, device=dev, generator=g)).bfloat16()
    bb = 0.1 * torch.randn(900, device=dev, generator=g)
    try:
        err = held("gemm_bias_act[K300,N900]", fl.gemm_bias_act(xin, ww, bb, True),
                   fl.gemm_bias_act_reference(xin, ww, bb, True), **BF16_TOL)
        bb16 = bb.bfloat16()
        entries.append(_entry(
            "gemm_bias_act[K300,N900]", src_gemm, b1, "gemm_bias_act", err,
            cuda_ms(lambda: fl.gemm_bias_act(xin, ww, bb, True)),
            cuda_ms(lambda: fl.gemm_bias_act_reference(xin, ww, bb, True), reps=3),
            2.0 * 32_768 * 900 * 300, 2 * 32_768 * 300 + 2 * 900 * 300 + 4 * 900 + 2 * 32_768 * 900, PEAK_BF16,
            cuda_ms(lambda: F.gelu(F.linear(xin, ww, bb16), approximate="tanh")), shape=[32_768, 300, 900],
        ))
    except ValueError:
        if not ALT_TREE:
            raise
        emit("kernel_skipped", name="gemm_bias_act[K300,N900]", reason="the other tree's kernel does not take it")
    del xin, ww

    def attention_entry(name, replaces, qkv3, key_mask, zero_empty, heads=h):
        """Every query row is held, padded ones and those of sequences
        with no live key included: B1 (``zero_empty``) writes zeros there,
        B3 averages V uniformly."""
        b_, s_ = key_mask.shape
        d_ = qkv3.shape[-1] // 3
        hd_ = d_ // heads
        got = masked_attention(qkv3, key_mask, heads, zero_empty)
        err = held(name, got, masked_attention_reference(qkv3, key_mask, heads, zero_empty), **BF16_TOL)
        empty = ~key_mask.any(dim=1)
        if zero_empty and not (got[empty] == 0).all():
            raise AssertionError(f"{name}: a sequence with no live key must give zeros")
        if not zero_empty:
            uniform = qkv3[empty][:, :, 2 * d_:].float().mean(dim=1, keepdim=True).expand(-1, s_, -1)
            held(name + " fully masked rows vs mean of V", got[empty], uniform, **BF16_TOL)
        kl = key_mask.sum(dim=1).double()
        flops = 4.0 * heads * hd_ * float((kl**2).sum())
        nbytes = 2 * 3 * d_ * s_ * float((kl > 0).sum()) + b_ * s_ + 2 * b_ * s_ * d_
        q_, k_, v_ = (t.view(b_, s_, heads, hd_).transpose(1, 2) for t in qkv3.split(d_, dim=-1))
        q_, k_, v_ = q_.contiguous(), k_.contiguous(), v_.contiguous()
        amask = key_mask[:, None, None, :]
        return _entry(
            name, src_attn, replaces, "masked_attention", err,
            cuda_ms(lambda: masked_attention(qkv3, key_mask, heads, zero_empty)),
            cuda_ms(lambda: masked_attention_reference(qkv3, key_mask, heads, zero_empty), reps=3),
            flops, nbytes, PEAK_BF16,
            cuda_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=amask)),
            shape=[b_, s_, 3 * d_], heads=heads,
        )

    entries.append(attention_entry("masked_attention[B1 layer]", b1, qkv.view(-1, S, 3 * d), mask, True))

    # ---- B3: qkv [256, 128, 1152] bf16, one fully masked row
    qkv3 = torch.randn(256, 128, 3 * d, device=dev, generator=g).bfloat16()
    kl3 = torch.randint(64, 129, (256,), device=dev, generator=g)
    kl3[7] = 0
    km3 = torch.arange(128, device=dev)[None, :] < kl3[:, None]
    entries.append(attention_entry("masked_attention[B3]", "pathway_tpu/ops/fused_attention.py:117", qkv3, km3, False))
    # B3 at BERT-base geometry (12 heads of 64), at head dim 128 (8 heads, d 1024) and 256 (4 heads, d 1024),
    # same lengths
    for tag, width, heads in (("hd64", 768, 12), ("hd128", 1024, 8), ("hd256", 1024, 4)):
        qkv_h = torch.randn(256, 128, 3 * width, device=dev, generator=g).bfloat16()
        try:
            entries.append(attention_entry(f"masked_attention[{tag}]", "pathway_tpu/ops/fused_attention.py:117",
                                           qkv_h, km3, False, heads=heads))
        except ValueError:
            if not ALT_TREE:
                raise
            emit("kernel_skipped", name=f"masked_attention[{tag}]", reason="the other tree's kernel does not take it")
        del qkv_h
    # S 1024 at MiniLM's heads (12 of 32): 32 sequences of 512-1024 live keys, one fully masked
    qkv_s = torch.randn(32, 1024, 3 * d, device=dev, generator=g).bfloat16()
    kl_s = torch.randint(512, 1025, (32,), device=dev, generator=g)
    kl_s[5] = 0
    km_s = torch.arange(1024, device=dev)[None, :] < kl_s[:, None]
    try:
        entries.append(attention_entry("masked_attention[S1024]", "pathway_tpu/ops/fused_attention.py:117", qkv_s,
                                       km_s, False))
    except ValueError:
        if not ALT_TREE:
            raise
        emit("kernel_skipped", name="masked_attention[S1024]", reason="the other tree's kernel does not take it")
    del qkv_s
    phase_b1_layer(torch, g, "hd64", 768, 12, 3072)
    # public small widths that run zero-padded: bert-tiny (LayerNorm 128 -> 256) and TinyBERT-4L-312
    # (LayerNorm 312 -> 384, 12 heads of 26 -> 32)
    phase_b1_layer(torch, g, "d128", 128, 2, 512)
    phase_b1_layer(torch, g, "d312", 312, 12, 1200)

    entries.extend(knn_entries(torch, g, d))
    entries.extend(knn_sharded_entries(torch, g, d))
    entries.append(segment_attention_entry(torch, g))
    entries.append(segment_attention_entry(torch, g, rows=128, d=768, h=12, tag="hd64"))
    try:
        entries.append(segment_attention_entry(torch, g, rows=64, tag="S1024", seq=1024))
    except ValueError:
        if not ALT_TREE:
            raise
        emit("kernel_skipped", name="segment_attention[S1024]", reason="the other tree's kernel does not take it")
    for hd, heads in ((64, 4), (128, 2), (48, 4), (512, 2), (320, 2)):
        entry = paged_decode_attention_entry(torch, g, hd, heads)
        if entry is not None:
            entries.append(entry)
    return entries


def knn_entries(torch, g, d: int, N: int = 1 << 20) -> list[dict]:
    """B2 against ``N`` (1,048,576) x ``d`` f32 docs with 10 % dead slots, at the
    main path's shapes: one query (the index's single-query search, the
    streaming kernel), 16 (the regime boundary, where the tensor-core kernel
    is timed beside it) and 256 (batch search, the tensor-core kernel)."""
    import inspect

    import torch.nn.functional as F

    from pathway_tpu_torch.ops.knn import _pallas_bias
    from pathway_tpu_torch.ops.knn_topk import knn_topk, knn_topk_reference, topk_agreement

    forced = "regime" in inspect.signature(knn_topk).parameters  # an older tree has one regime
    docs = F.normalize(torch.randn(N, d, device=DEV, generator=g), dim=1)
    valid = torch.rand(N, device=DEV, generator=g) >= 0.1
    queries = F.normalize(torch.randn(256, d, device=DEV, generator=g), dim=1)
    entries = []
    for Q, metric, k in ((1, "cos", 16), (1, "cos", 64), (1, "l2", 16), (16, "cos", 16),
                         (256, "cos", 16), (256, "cos", 64), (256, "l2", 16), (256, "l2", 64)):
        q = queries[:Q].contiguous()
        bias = _pallas_bias(metric, docs, valid)
        factor = 2.0 if metric == "l2" else 1.0
        vk, ik = knn_topk(q, docs, k=k, bias=bias, factor=factor)
        vp, ip = knn_topk_reference(q, docs, k=k, bias=bias, factor=factor)
        share, ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
        if not ok:
            raise AssertionError(f"knn_topk {metric} k={k} q={Q} disagrees with its plain version ({share})")
        single = Q <= 16
        reps = 20 if single else 5
        lib = lambda: torch.topk(torch.addmm(bias, q, docs.T, alpha=factor), k, dim=1)  # noqa: E731
        flops, nbytes = 2.0 * Q * N * d, 4 * N * d + 4 * N + 4 * Q * d + 8 * Q * k
        extra = {}
        if Q == 16 and forced:  # the other partial pass at the boundary
            other = lambda: knn_topk(q, docs, k=k, bias=bias, factor=factor, regime="tc")  # noqa: E731
            vo, io = other()
            if not topk_agreement(vo, io, vp, ip, atol=1e-5, rtol=1e-5)[1]:
                raise AssertionError("knn_topk's tensor-core pass at q 16 disagrees with the plain version")
            extra["tc_regime_ms"] = cuda_ms(other, reps=reps)
        if not single:  # the tensor cores' bound: bytes, or 3 TF32 products per f32 one at 495 TF/s
            extra["bound_3xtf32_ms"] = max(nbytes / HBM_BYTES, 3 * flops / PEAK_TF32) * 1e3
        entries.append(_entry(
            f"knn_topk[{metric},k={k}]" if Q == 256 else f"knn_topk[{metric},k={k},q={Q}]",
            "pathway_tpu_torch/csrc/knn_topk.cu", "pathway_tpu/ops/pallas_knn.py:113",
            "knn_topk_stream" if single else "knn_topk_tc", (vk - vp).abs().max().item(),
            cuda_ms(lambda: knn_topk(q, docs, k=k, bias=bias, factor=factor), reps=reps),
            cuda_ms(lambda: knn_topk_reference(q, docs, k=k, bias=bias, factor=factor), reps=2, warmup=1),
            flops, nbytes, PEAK_F32, cuda_ms(lib, reps=reps), index_agreement=share, shape=[Q, N, d], **extra,
        ))
    del docs, valid, queries
    torch.cuda.empty_cache()
    return entries


def mesh_devices(torch) -> tuple[object, str]:
    """The mesh of ``mesh_path`` and the sharded kernel rows: one data
    shard a card when two or more are visible, else 4 shards on ``cuda:0``
    from an explicit device list; and a line that says which."""
    from pathway_tpu_torch.parallel.sharding import make_mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return make_mesh(n_devices=n, model_parallel=1), f"{n} cards, one data shard each"
    return make_mesh(devices=["cuda:0"] * MESH_ONE_CARD_SHARDS, model_parallel=1), (
        f"one card: {MESH_ONE_CARD_SHARDS} data shards on cuda:0 (an explicit device list)")


def knn_sharded_entries(torch, g, d: int, rows: int = 1 << 20) -> list[dict]:
    """``knn_topk_sharded`` over the mesh of :func:`mesh_devices` (4 shards
    of ``rows`` (1,048,576) x ``d`` f32 docs, 10 % dead: each shard is
    ``main_path``'s B2 shape) at 1 query (each shard's streaming pass), 16
    and 256 (its tensor-core pass), cos k 16, against its plain version
    and against the plain top-k over the shards concatenated; the bound is every shard's bytes (or f32 operations) over the distinct
    cards' rates; the yardstick one ``addmm`` + ``topk`` over the shards
    concatenated on the first card."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops.knn import _pallas_bias

    try:
        from pathway_tpu_torch.ops.knn_topk import (
            knn_topk_reference, knn_topk_sharded, knn_topk_sharded_reference, merge_shard_candidates,
            topk_agreement,
        )
    except ImportError:
        if not ALT_TREE:
            raise
        emit("kernel_skipped", name="knn_topk_sharded", reason="the other tree has no knn_topk_sharded")
        return []
    mesh, where = mesh_devices(torch)
    devs = mesh.data_devices()
    cards = len(set(devs))
    doc_shards, bias_shards = [], []
    for dev in devs:
        docs = F.normalize(torch.randn(rows, d, device=DEV, generator=g), dim=1).to(dev)
        valid = (torch.rand(rows, device=DEV, generator=g) >= 0.1).to(dev)
        doc_shards.append(docs)
        bias_shards.append(_pallas_bias("cos", docs, valid))
    cat_docs = torch.cat([t.to(DEV) for t in doc_shards])
    cat_bias = torch.cat([t.to(DEV) for t in bias_shards])
    queries = F.normalize(torch.randn(256, d, device=DEV, generator=g), dim=1)
    N, k, entries = rows * len(devs), 16, []
    for Q in (1, 16, 256):
        q = queries[:Q].contiguous()
        vk, ik = knn_topk_sharded(q, doc_shards, bias_shards, k=k)
        vp, ip = knn_topk_sharded_reference(q, doc_shards, bias_shards, k=k)
        share, ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
        if not ok:
            raise AssertionError(f"knn_topk_sharded q={Q} disagrees with its plain version ({share})")
        # and with the plain top-k over the whole slab, which knows nothing of shards
        vw, iw = knn_topk_reference(q, cat_docs, k=k, bias=cat_bias)
        whole_share, ok = topk_agreement(vk, ik, vw, iw, atol=1e-5, rtol=1e-5)
        if not ok:
            raise AssertionError(f"knn_topk_sharded q={Q} disagrees with the whole slab's plain top-k "
                                 f"({whole_share})")
        del vw, iw
        reps = 20 if Q <= 16 else 5
        flops, nbytes = 2.0 * Q * N * d, 4 * N * d + 4 * N + 4 * Q * d + 8 * Q * k
        extra = {"shards": len(devs), "cards": cards, "mesh": where, "whole_slab_agreement": whole_share}
        if Q > 16:  # the tensor cores' bound: bytes, or 3 TF32 products per f32 one, over the cards
            extra["bound_3xtf32_ms"] = max(nbytes / HBM_BYTES, 3 * flops / PEAK_TF32) * 1e3 / cards
        cand_s = torch.stack([vk] * len(devs), dim=1).contiguous()
        cand_i = torch.stack([ik] * len(devs), dim=1).contiguous()
        extra["cross_shard_merge_ms"] = cuda_ms(lambda: merge_shard_candidates(cand_s, cand_i, k), reps=20)
        lib = lambda: torch.topk(torch.addmm(cat_bias, q, cat_docs.T), k, dim=1)  # noqa: E731
        entries.append(_entry(
            f"knn_topk_sharded[cos,k={k},q={Q}]", "pathway_tpu_torch/csrc/knn_topk.cu",
            "pathway_tpu/ops/pallas_knn.py:181", "knn_topk_sharded_merge", (vk - vp).abs().max().item(),
            cuda_ms(lambda: knn_topk_sharded(q, doc_shards, bias_shards, k=k), reps=reps),
            cuda_ms(lambda: knn_topk_sharded_reference(q, doc_shards, bias_shards, k=k), reps=2, warmup=1),
            flops / cards, nbytes / cards, PEAK_F32, cuda_ms(lib, reps=reps), index_agreement=share,
            shape=[Q, len(devs), rows, d], **extra,
        ))
    del doc_shards, bias_shards, cat_docs, cat_bias, queries
    torch.cuda.empty_cache()
    return entries


def phase_b1_layer(torch, g, tag: str, hidden: int, heads: int, ffn: int) -> None:
    """B1 at another width (hd64: BERT-base, d 768, 12 heads of 64, FFN
    3072): two layers of random weights over 256 sequences at S = 128,
    lengths 32-128 with four of them 0, held to the plain layers at the
    whole-layer tolerance."""
    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params
    from pathway_tpu_torch.ops import fused_layer as fl

    cfg = EncoderConfig(hidden_size=hidden, num_layers=2, num_heads=heads, intermediate_size=ffn)
    d, h, ffn, eps = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.layer_norm_eps
    params = fl.prepare_params({k: v.to(DEV) for k, v in init_params(cfg, seed=SEED).items()}, cfg)
    layers = [fl.layer_params(params, i) for i in range(cfg.num_layers)]
    B, S = 256, 128
    tokens = torch.randn(B * S, d, device=DEV, generator=g).bfloat16()
    lens = torch.randint(32, S + 1, (B,), device=DEV, generator=g, dtype=torch.int32)
    lens[-4:] = 0

    def run(layer):
        x = tokens
        for lp in layers:
            x = layer(x, lens, lp, n_heads=h, seq=S, eps=eps)
        return x

    try:
        got = run(fl.fused_layer_tokens)
    except ValueError:
        if ALT_TREE:
            emit("kernel_skipped", name=f"b1_layer[{tag}]", reason="the other tree's kernels do not take this width")
            return
        raise
    err = held(f"B1 layer[{tag}]", got, run(fl.fused_layer_tokens_reference), **LAYER_TOL)
    live_lens = lens.double()
    n_live = int((live_lens > 0).sum())
    flops = cfg.num_layers * (
        2 * n_live * S * (3 * d * d + d * d + 2 * d * ffn) + 4 * h * (d // h) * float((live_lens**2).sum())
    )
    nbytes = cfg.num_layers * (2 * (2 * B * S * d) + 2 * (4 * d * d + 2 * d * ffn))
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
    emit(
        f"b1_layer[{tag}]", shape=[B * S, d], seq=S, heads=h, layers=cfg.num_layers, live_sequences=n_live,
        max_abs_err=err, ms=cuda_ms(lambda: run(fl.fused_layer_tokens)),
        plain_ms=cuda_ms(lambda: run(fl.fused_layer_tokens_reference), reps=3), bound_ms=b_ms, bound_by=b_by,
    )


def segment_attention_entry(torch, g, rows: int = 256, d: int = 384, h: int = 12, tag: str = "B4",
                            seq: int = 512) -> dict:
    """B4 at the packed ingest's shapes: qkv [rows, seq, 3d] bf16 (MiniLM:
    d 384, 12 heads; rows of 512), segment ids laid out by the port's own
    packer from seeded lengths of 64-256."""
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch.models.sentence_encoder import shelf_pack
    from pathway_tpu_torch.ops.fused_attention import segment_attention, segment_attention_reference

    L, SEGS = seq, seq // 64
    hd = d // h
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(64, 257, rows * 3)
    while True:  # enough chunks for ``rows`` packed rows
        order, lns, row_of, off_of, slot_of = shelf_pack(lens, L, SEGS)
        if row_of[-1] + 1 >= rows:
            break
        lens = np.concatenate([lens, rng.integers(64, 257, rows)])
    keep = row_of < rows
    seg = np.full((rows, L), -1, np.int32)
    for ln, r, off, slot in zip(lns[keep], row_of[keep], off_of[keep], slot_of[keep]):
        seg[r, off : off + ln] = r * SEGS + slot
    seg_d = torch.from_numpy(seg).to(DEV)
    qkv = torch.randn(rows, L, 3 * d, device=DEV, generator=g).bfloat16()
    got = segment_attention(qkv, seg_d, h)
    want = segment_attention_reference(qkv, seg_d, h)
    live = seg_d >= 0
    name = f"segment_attention[{tag}]"
    err = held(name + " live rows", got[live], want[live], **BF16_TOL)
    if not (got[~live].isfinite().all() and (got[~live] == 0).all()):
        raise AssertionError(f"{name}: padding rows must be finite (the kernel writes zeros)")
    q, k, v = (t.reshape(rows, L, h, hd).transpose(1, 2).contiguous() for t in qkv.split(d, dim=-1))
    same = seg_d[:, None, :, None] == seg_d[:, None, None, :]  # the library call's mask, built outside its timing
    flops = 4.0 * h * hd * float((lns[keep].astype(np.float64) ** 2).sum())
    nbytes = 2 * rows * L * 3 * d + 2 * rows * L * d + 4 * rows * L
    return _entry(
        name, "pathway_tpu_torch/csrc/segment_attention.cu",
        "pathway_tpu/ops/fused_attention.py:244", "segment_attention", err,
        cuda_ms(lambda: segment_attention(qkv, seg_d, h)),
        cuda_ms(lambda: segment_attention_reference(qkv, seg_d, h), reps=2, warmup=1),
        flops, nbytes, PEAK_BF16, cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same)),
        shape=[rows, L, 3 * d], heads=h, segments=int(keep.sum()), live_tokens=int(live.sum()),
    )


def paged_decode_attention_entry(torch, g, hd: int = 64, h: int = 4) -> dict | None:
    """B5 at the decode engine's shapes: 8 lanes, ``h`` heads of ``hd`` (the
    decoder: 4 of 64), a pool of 512 pages x 16, page tables of 10, lengths
    1-160 with one lane at 0, shuffled tables and shared prefix pages; at
    head dims above 256 (staged in column tiles) also a table entry past the
    pool beyond a lane's length, which is never read. Its
    time is device time (CUDA-graph replay: a call this small is host-bound,
    its enqueue rate kept as ``enqueue_ms``). None when an older tree
    (``--kernels TREE``) does not take the head dim."""
    from pathway_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    lanes, n_pages, page, pps = 8, 512, 16, 10
    d = h * hd
    name = "paged_decode_attention[B5]" if hd == 64 else f"paged_decode_attention[hd{hd}]"
    q = torch.randn(lanes, d, device=DEV, generator=g)
    kp = torch.randn(n_pages, page, d, device=DEV, generator=g)
    vp = torch.randn(n_pages, page, d, device=DEV, generator=g)
    tables = torch.stack([torch.randperm(n_pages, device=DEV, generator=g)[:pps] for _ in range(lanes)]).int()
    tables[1, :4] = tables[0, :4]  # shared prefix pages
    lens = torch.randint(1, pps * page + 1, (lanes,), device=DEV, generator=g, dtype=torch.int32)
    lens[3] = 0
    if hd > 256:
        tables[4, pps - 1] = n_pages + 7  # out of range, past the lane's length
        lens[4] = (pps - 1) * page
    kern = lambda: paged_decode_attention(q, kp, vp, tables, lens, n_heads=h)  # noqa: E731
    try:
        got = kern()
    except ValueError:
        if ALT_TREE:
            emit("kernel_skipped", name=name, reason="the other tree's kernel does not take this head dim")
            return None
        raise
    err = held(name, got, paged_attention_reference(q, kp, vp, tables, lens, n_heads=h), **F32_TOL)
    if not (got[3] == 0).all():
        raise AssertionError(f"{name}: a length-0 lane must give exact zeros")
    ctx = float(lens.double().sum())
    nbytes = 4 * lanes * d + 2 * 4 * d * ctx + 4 * lanes * pps + 4 * lanes + 4 * lanes * d
    return _entry(
        name, "pathway_tpu_torch/csrc/paged_decode_attention.cu",
        "pathway_tpu/ops/paged_attention.py:255", "paged_decode_attention", err, graph_ms(kern),
        cuda_ms(lambda: paged_attention_reference(q, kp, vp, tables, lens, n_heads=h), reps=20),
        4.0 * d * ctx, nbytes, PEAK_F32, None, enqueue_ms=cuda_ms(kern, reps=50),
        shape=[lanes, d, n_pages, page, pps], heads=h, context_tokens=int(ctx),
    )


def phase_tie_helper(torch, g, nq: int = 512, n: int = 1 << 20, k: int = 128) -> None:
    """The index's plain top-k with exact ties in ascending index order
    (``ops/knn._topk_lower_index``) at q 512 x 2^20, fetch 128 (the plain
    route just above the kernel's k <= 64), beside ``torch.topk`` (no tie
    order) and a stable full sort (the simple exact form). Gate: equal to
    the stable sort on a tie group of 200 that straddles k."""
    from pathway_tpu_torch.ops.knn import _topk_lower_index

    scores = torch.randn(nq, n, device=DEV, generator=g)
    scores[:, 1000:1200] = 8.0  # exact ties above every other score
    _, idx = _topk_lower_index(scores, k)
    _, si = torch.sort(scores, dim=1, descending=True, stable=True)
    if not torch.equal(idx, si[:, :k]):
        raise AssertionError("_topk_lower_index disagrees with the stable sort on exact ties")
    del si
    emit(
        "tie_helper", shape=[nq, n], k=k,
        ms=cuda_ms(lambda: _topk_lower_index(scores, k), reps=5),
        torch_topk_ms=cuda_ms(lambda: torch.topk(scores, k, dim=1), reps=5),
        stable_sort_ms=cuda_ms(lambda: torch.sort(scores, dim=1, descending=True, stable=True), reps=2, warmup=1),
    )
    del scores
    torch.cuda.empty_cache()


def device_ops(torch, fn) -> tuple[dict | None, float | None]:
    """Device operations (kernels and copies, counted by name) and their
    summed device time in ms for one warmed-up call of ``fn``, from a
    torch.profiler trace; (None, None) when the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None
    counts: dict[str, int] = {}
    for e in events:
        counts[e.name[:80]] = counts.get(e.name[:80], 0) + 1
    total_us = sum(e.time_range.elapsed_us() for e in events)
    return {"total": len(events), "by_name": counts}, total_us / 1e3


def _synthetic_texts(rng, n: int, lo: int, hi: int) -> list[str]:
    import numpy as np

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(8000)]
    zipf = 1.0 / np.arange(1, len(vocab) + 1)
    zipf /= zipf.sum()
    return [" ".join(rng.choice(vocab, rng.integers(lo, hi + 1), p=zipf)) for _ in range(n)]


def _synthetic_texts_bulk(rng, n: int, lo: int, hi: int) -> list[str]:
    """``_synthetic_texts``'s distribution (Zipf over 8,000 made-up words,
    lo..hi words a text) drawn in one call, for corpora too large to draw
    text by text."""
    import numpy as np

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(8000)])
    zipf = 1.0 / np.arange(1, len(vocab) + 1)
    lens = rng.integers(lo, hi + 1, n)
    words = vocab[rng.choice(len(vocab), int(lens.sum()), p=zipf / zipf.sum())]
    ends = np.cumsum(lens)
    return [" ".join(words[e - ln : e]) for e, ln in zip(ends, lens)]


def phase_main_path(torch) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch import DeviceKnnIndex, SentenceEncoder
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import knn_topk_reference, topk_agreement

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    n_docs, capacity, dim = 16_384, 1 << 20, 384
    docs = _synthetic_texts(rng, n_docs, 20, 220)
    fresh = _synthetic_texts(rng, 256 + 64, 5, 40)
    self_ids = rng.choice(n_docs, 256, replace=False)
    queries = [docs[i] for i in self_ids] + fresh[:256]
    extra = fresh[256:]

    enc = SentenceEncoder(max_seq_len=256, max_batch=1024, seed=SEED)
    # the same weights (same seed) with every kernel replaced by its plain version
    plain = SentenceEncoder(
        config=dataclasses.replace(enc.cfg, layer_impl="plain", attention_impl="plain"),
        max_seq_len=256, max_batch=1024, seed=SEED,
    )
    # correctness on a small input: the kernel path (B1) against the plain path
    small = docs[:64]
    small_err, small_cos = held_embeddings("encode (B1)", enc.encode(small), plain.encode(small))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    enc._tokenize_matrix(docs)
    tokenize_s = time.perf_counter() - t0  # host-only share of the embed phase

    _build.reset_launches()
    t0 = time.perf_counter()
    embs = enc.encode_device(docs)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    if embs.shape != (n_docs, dim) or not torch.isfinite(embs).all():
        raise AssertionError(f"bad embeddings {tuple(embs.shape)}")
    norms = embs.norm(dim=1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-3):
        raise AssertionError("embeddings are not unit vectors")

    index = DeviceKnnIndex(dim=dim, metric="cos", reserved_space=capacity)
    t0 = time.perf_counter()
    index.add_batch_device(list(range(n_docs)), embs)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for start in range(n_docs, capacity, n_docs):
        filler = F.normalize(torch.randn(n_docs, dim, device=dev, generator=g), dim=1)
        index.add_batch_device(list(range(start, start + n_docs)), filler)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if len(index) != capacity or index.capacity != capacity:
        raise AssertionError(f"index holds {len(index)} rows in {index.capacity}")

    lat, lat_embed = [], []
    for text in queries:
        t0 = time.perf_counter()
        q1 = enc.encode_device([text])
        torch.cuda.synchronize()  # splits the latency into embed and search; both are counted
        t1 = time.perf_counter()
        res = index.search_batch(q1, 10)
        lat.append((time.perf_counter() - t0) * 1e3)
        lat_embed.append((t1 - t0) * 1e3)
        if len(res[0]) != 10:
            raise AssertionError("a query returned fewer than 10 neighbours")
    q_emb = enc.encode_device(queries)
    t0 = time.perf_counter()
    batch = index.search_batch(q_emb, 10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    self_top1 = float(np.mean([batch[i][0][0] == int(self_ids[i]) for i in range(256)]))

    index.attach_encoder(enc)
    by_text = index.search_texts_batch(extra, 10)
    before = dict(_build.LAUNCHES)
    toks = [enc.tokenizer.encode(t, enc.max_seq_len) for t in extra]
    tok_emb = enc.encode_tokens(toks)
    by_tokens = index.search_batch(tok_emb, 10)
    b3_launches = _build.LAUNCHES["masked_attention"] - before.get("masked_attention", 0)
    b3_gemms = _build.LAUNCHES["gemm_bias_act"] - before.get("gemm_bias_act", 0)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # gate: the module path (B3) against the same call with plain attention
    tokens_err, tokens_cos = held_embeddings("encode_tokens (B3)", tok_emb, plain.encode_tokens(toks))
    query_ops, query_device_ms = device_ops(torch, lambda: enc.encode_device([queries[0]]))

    overlap = float(np.mean([
        len({k for k, _ in a} & {k for k, _ in b}) / 10.0 for a, b in zip(by_text, by_tokens)
    ]))
    # gate: the kernel top-k equals the plain top-k on the same embeddings
    qn = F.normalize(q_emb, dim=1)
    vk, ik = index.search_dispatch(q_emb, 10)
    vp, ip = knn_topk_reference(qn, index._dev_matrix, k=16, bias=index._dev_bias)
    share, ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
    needed = ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention", "knn_topk_stream", "knn_topk_tc",
              "knn_topk_merge")
    missing = [k for k in needed if launches.get(k, 0) == 0]
    if missing or b3_launches == 0:
        raise AssertionError(f"main path never launched {missing} (B3 module launches: {b3_launches})")
    if not ok:
        raise AssertionError(f"index kernel top-k disagrees with the plain top-k ({share})")
    result = dict(
        docs=n_docs, index_rows=len(index), embed_seconds=embed_s, docs_per_s=n_docs / embed_s,
        tokenize_seconds=tokenize_s, fill_seconds=fill_s,
        query_p50_ms=float(np.percentile(lat, 50)), query_p99_ms=float(np.percentile(lat, 99)),
        query_embed_p50_ms=float(np.percentile(lat_embed, 50)),
        query_search_p50_ms=float(np.percentile(np.subtract(lat, lat_embed), 50)),
        queries=len(queries), batch_512_search_ms=batch_ms, self_query_top1=self_top1,
        text_vs_tokens_overlap=overlap, topk_index_agreement=share, small_input_max_abs_err=small_err,
        small_input_min_cos=small_cos, encode_tokens_max_abs_err=tokens_err, encode_tokens_min_cos=tokens_cos,
        single_query_embed_device_ops=query_ops, single_query_embed_device_ms=query_device_ms,
        b3_module_attention_launches=b3_launches,
        b3_module_gemm_launches=b3_gemms, max_memory_allocated=peak, launches=launches,
    )
    emit("main_path", **result)
    return launches


def _long_tailed_texts(rng, n: int, vocab: list[str]) -> list[str]:
    """``n`` chunks of seeded made-up words (one wordpiece each under the
    hashed tokenizer): about 95 % at 64-128 wordpieces, the rest at 129-256,
    [CLS] and [SEP] included."""
    import numpy as np

    lens = np.where(rng.random(n) < 0.95, rng.integers(64, 129, n), rng.integers(129, 257, n)) - 2
    zipf = 1.0 / np.arange(1, len(vocab) + 1)
    words = np.asarray(vocab)[rng.choice(len(vocab), int(lens.sum()), p=zipf / zipf.sum())]
    ends = np.cumsum(lens)
    return [" ".join(words[e - ln : e]) for e, ln in zip(ends, lens)]


def _percentiles(ms: list[float]) -> dict:
    import numpy as np

    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def phase_rag_path(torch) -> tuple[dict, object]:
    """The RAG answer plane at full width: MiniLM-L6 embedder, cross_encoder_l6
    reranker, ``FusedRagPipeline(reserved_space=16_384, doc_seq_len=128)``
    with the default decoder. Returns the path's launch counts and its
    cross-encoder scorer."""
    import numpy as np

    from pathway_tpu_torch import CrossEncoderScorer, DecoderConfig, FusedRagPipeline, SentenceEncoder
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import topk_agreement

    rng = np.random.default_rng(SEED + 3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(8000)]
    n_epochs, per_epoch = 16, 1024
    epochs = [_long_tailed_texts(rng, per_epoch, vocab) for _ in range(n_epochs)]
    fresh = _synthetic_texts(rng, 256, 5, 40)
    own = [" ".join(epochs[i % n_epochs][i].split()[:40]) for i in range(256)]  # a document's opening words
    queries = own + fresh

    enc = SentenceEncoder(max_seq_len=256, max_batch=1024, seed=SEED, device=DEV)
    cross = CrossEncoderScorer(seed=SEED, device=DEV)
    pipe = FusedRagPipeline(enc, cross, reserved_space=16_384, doc_seq_len=128)
    pipe.set_decoder(DecoderConfig(), seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    b4_by_epoch = []
    t0 = time.perf_counter()
    for e, texts in enumerate(epochs):
        before = _build.LAUNCHES["segment_attention"]
        pipe.add_docs(list(range(e * per_epoch, (e + 1) * per_epoch)), texts)
        b4_by_epoch.append(_build.LAUNCHES["segment_attention"] - before)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = dict(_build.LAUNCHES)
    lat = []
    for text in queries:
        t0 = time.perf_counter()
        hits = pipe.query(text, k=5, k_retrieve=20)
        lat.append((time.perf_counter() - t0) * 1e3)
        if len(hits) != 5:
            raise AssertionError(f"a fused query returned {len(hits)} hits, not 5")
    t0 = time.perf_counter()
    batch = pipe.query_batch(queries, k=5, k_retrieve=20)
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    answers = pipe.answer_batch(queries[:64], k=5, k_retrieve=20, max_new=16)
    answer_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)

    # ---- gates, outside the counted run
    if len(pipe) != n_epochs * per_epoch or min(b4_by_epoch) == 0:
        raise AssertionError(f"the segment packer did not engage on every epoch: B4 launches {b4_by_epoch}")
    if any(len(r) != 5 for r in batch):
        raise AssertionError("query_batch returned fewer than 5 hits")
    if any(len(a["tokens"]) != 16 or not all(0 <= t < 32000 for t in a["tokens"]) for a in answers):
        raise AssertionError("an answer does not hold 16 in-vocabulary tokens")
    for key in ("segment_attention", "masked_attention"):
        if launches.get(key, 0) == 0:
            raise AssertionError(f"rag_path never launched {key}")
    # one epoch packed (B4) against the same texts with the packer declined (B1)
    ids, lens = enc._tokenize_matrix(epochs[0])
    order, embs = enc._pack_segments(ids, lens)
    packed = np.zeros((per_epoch, enc.dim), np.float32)
    keep = order < per_epoch
    packed[order[keep]] = embs.cpu().numpy()[keep]
    pack_err, pack_cos = held_embeddings("packed ingest (B4)", packed, enc._encode_matrix(ids, lens))
    # the cross-encoder (B3) against the same scorer with plain attention
    cross_plain = CrossEncoderScorer(
        config=dataclasses.replace(cross.cfg, attention_impl="plain"), seed=SEED, device=DEV
    )
    pairs = [(queries[i], epochs[1][i]) for i in range(128)]
    cross_err = held(
        "cross-encoder scores (B3)", torch.from_numpy(cross.score(pairs)), torch.from_numpy(cross_plain.score(pairs)),
        **RERANK_TOL,
    )
    # the final hits of the same candidates, reranked with plain attention
    q_ids, q_lens, kr = pipe._padded_queries(queries, 20)
    fs, fv, _, _ = pipe._fused(q_ids, q_lens, kr, 5)
    pipe.cross = cross_plain
    ps, pv, _, _ = pipe._fused(q_ids, q_lens, kr, 5)
    pipe.cross = cross
    share, ok = topk_agreement(fv, fs, pv, ps, atol=RERANK_TOL["atol"], rtol=RERANK_TOL["rtol"])
    if not ok:
        raise AssertionError(f"fused hits with B3 disagree with plain-attention reranking beyond boundary ties ({share})")
    # seeded random weights score the candidates of a query nearly alike: how
    # far apart the final five lie says how much of the agreement is ties
    spread = (fv[:, 0] - fv[:, -1]).double().cpu()
    query_ops, query_device_ms = device_ops(torch, lambda: pipe.query(queries[0], k=5, k_retrieve=20))
    emit(
        "rag_path", docs=len(pipe), epochs=n_epochs, ingest_seconds=ingest_s, ingest_docs_per_s=len(pipe) / ingest_s,
        b4_launches_by_epoch=b4_by_epoch, ingest_launches=ingest_launches,
        query=_percentiles(lat), queries=len(queries), query_batch_512_ms=batch_ms, answer_batch_64_ms=answer_ms,
        answer_tokens=16, packed_vs_unpacked_max_abs_err=pack_err, packed_vs_unpacked_min_cos=pack_cos,
        cross_vs_plain_max_abs_err=cross_err, hits_vs_plain_rerank_agreement=share,
        final_score_spread_median=float(spread.median()), final_score_spread_max=float(spread.max()),
        single_query_device_ops=query_ops, single_query_device_ms=query_device_ms,
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
    )
    return launches, cross


def _first_split(torch, params, cfg, prompt, got, want):
    """Where two token streams of one prompt first part, and the top-2 gap
    of the plain model's logits there (recomputed by a prefill over the
    prompt and the shared prefix); (None, None) when they agree."""
    from pathway_tpu_torch.decode.engine import _prefill_logits_math

    for t, (a, b) in enumerate(zip(got, want)):
        if a != b:
            ids = torch.tensor([prompt + want[:t]], device=DEV)
            with torch.no_grad():
                _, _, logits = _prefill_logits_math(params, cfg, ids, torch.tensor([ids.shape[1]], device=DEV))
            top = torch.topk(logits[0], 2).values
            return t, float(top[0] - top[1])
    return None, None


# engine_path: documents streamed through the dataflow engine, epochs of them,
# and the documents of the 1- vs 4-worker KNNIndex comparison
ENGINE_DOCS, ENGINE_EPOCH, ENGINE_QUERIES, ENGINE_WORKER_DOCS = 131_072, 1024, 512, 16_384
HIT_TOL = 1e-5  # topk_agreement tolerance of the engine's hits against the library path's


def _hits_agree(got: list, want: list, k: int) -> tuple[float, bool]:
    """``topk_agreement`` of two lists of per-query [(doc_id, score), ...]."""
    import torch

    from pathway_tpu_torch.ops.knn_topk import topk_agreement

    if any(len(g) != k or len(w) != k for g, w in zip(got, want)) or len(got) != len(want):
        return 0.0, False
    tens = lambda hits, j: torch.tensor([[h[j] for h in row] for row in hits], dtype=torch.float64)  # noqa: E731
    return topk_agreement(tens(got, 1), tens(got, 0), tens(want, 1), tens(want, 0), atol=HIT_TOL, rtol=HIT_TOL)


def _engine_knn_workers(pw, texts: list, queries: list, n_workers: int, k: int = 10) -> list:
    """``__graft_entry__._pipeline_doc_ids`` at full width: a KNNIndex over
    an embedder column of ``texts`` (one row per UDF call, so a row's
    embedding never depends on its batch), nearest items of ``queries``,
    on ``n_workers`` engine workers -> per query [(doc_id, -distance)]."""
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    embedder = SentenceTransformerEmbedder(device=DEV, max_batch_size=1)
    schema = pw.schema_from_types(doc_id=int, text=str)
    docs = pw.debug.table_from_rows(schema=schema, rows=list(enumerate(texts)))
    docs = docs.select(pw.this.doc_id, emb=embedder(pw.this.text))
    qt = pw.debug.table_from_rows(schema=schema, rows=[(100_000 + i, q) for i, q in enumerate(queries)])
    qt = qt.select(pw.this.doc_id, emb=embedder(pw.this.text))
    index = pw.ml.KNNIndex(docs.emb, docs, n_dimensions=embedder.get_embedding_dimension(),
                           reserved_space=len(texts), device=DEV)
    result = index.get_nearest_items(qt.emb, k=k, with_distances=True).select(
        qid=qt.doc_id, nearest=pw.this.doc_id, dist=pw.this.dist
    )
    runner = GraphRunner(n_workers=n_workers)
    cap, names = runner.capture(result)
    runner.run()
    pw.clear_graph()
    iq, i_near, i_dist = (names.index(c) for c in ("qid", "nearest", "dist"))
    by_qid = {row[iq]: list(zip(row[i_near], (-d for d in row[i_dist]))) for row in cap.state.values()}
    return [by_qid[100_000 + i] for i in range(len(queries))]


def phase_engine_path(torch, n_docs: int = ENGINE_DOCS, per_epoch: int = ENGINE_EPOCH,
                      n_queries: int = ENGINE_QUERIES, worker_docs: int = ENGINE_WORKER_DOCS) -> dict:
    """The live dataflow engine, as a user writes it: ``pw.io.python.read``
    (a ConnectorSubject committing every ``per_epoch`` documents, each
    commit its own epoch) -> ``DataIndex(BruteForceKnn(embedder=
    SentenceTransformerEmbedder()))`` (MiniLM-L6, seeded weights; device-
    resident ingest through ``add_batch_device``) ->
    ``query_as_of_now(number_of_matches=10)`` on text queries (the fused
    text path: B1 embed, B2 top-k) -> ``pw.io.subscribe`` -> ``pw.run``.
    ``n_queries`` single queries, one commit (epoch) each, then one epoch
    of ``n_queries``. Gates: the encoder kernels and both B2 partial passes
    launch, ``add_batch_device`` carries every ingest epoch (no host
    round trip), every query's hits equal the library path's (the same
    embedder's ``encode_device`` -> ``DeviceKnnIndex.add_batch_device`` ->
    ``search_texts_batch`` in the same batches), and a KNNIndex over an
    embedder column gives the same neighbour sets on 1 and 4 engine
    workers. Returns the launch counts of the pipeline's run."""
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DeviceKnnIndex
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    t_phase = time.perf_counter()
    k = 10
    rng = np.random.default_rng(SEED + 11)
    texts = _synthetic_texts_bulk(rng, n_docs, 20, 220)
    own = rng.choice(n_docs, n_queries // 2, replace=False)
    singles = [texts[i] for i in own] + _synthetic_texts(rng, n_queries - len(own), 5, 40)
    batch = [" ".join(texts[i].split()[:30]) for i in rng.choice(n_docs, n_queries // 2, replace=False)]
    batch += _synthetic_texts(rng, n_queries - len(batch), 5, 40)
    n_epochs = -(-n_docs // per_epoch)

    t_setup = time.perf_counter() - t_phase  # drawing the corpus and the queries
    embedder = SentenceTransformerEmbedder(device=DEV)
    enc = embedder._encoder
    enc.encode_device(texts[:per_epoch], pad_to=per_epoch)  # warm-up: first launches, handles
    lib_index = DeviceKnnIndex(dim=enc.dim, metric="cos", reserved_space=n_docs, device=DEV)

    adds = collections.Counter()
    real_dev, real_host = DeviceKnnIndex.add_batch_device, DeviceKnnIndex.add_batch

    def counted_dev(self, keys, vecs, metas=None):
        if self is not lib_index:
            adds["device_calls"] += 1
            adds["device_rows"] += len(keys)
        return real_dev(self, keys, vecs, metas)

    def counted_host(self, items):
        adds["host_calls"] += 1
        return real_host(self, items)

    now = time.perf_counter
    cv = threading.Condition()
    # "need": the answers the query subject waits for; a callback wakes it only once they are in (a wake-up
    # per answer would hand the GIL between threads 512 times inside the batch epoch's timing)
    state = {"doc_rows": 0, "doc_times": set(), "answers": {}, "t_answer": {}, "ingest_done": False, "need": 0}
    t_commit: dict[int, float] = {}

    class Documents(pw.io.python.ConnectorSubject):
        def run(self):
            for e in range(n_epochs):
                for i in range(e * per_epoch, min(n_docs, (e + 1) * per_epoch)):
                    self.next(doc_id=i, text=texts[i])
                if e == 0:
                    state["t0"] = now()
                self.commit()
                with cv:  # one commit per epoch: wait for the engine to take this one
                    if not cv.wait_for(lambda: state["doc_rows"] >= min(n_docs, (e + 1) * per_epoch), timeout=300):
                        raise TimeoutError(f"ingest epoch {e} was not delivered")
            torch.cuda.synchronize()
            state["ingest_s"] = now() - state["t0"]
            with cv:
                state["ingest_done"] = True
                cv.notify_all()

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            with cv:
                cv.wait_for(lambda: state["ingest_done"], timeout=1200)
            for i, text in enumerate(singles):
                state["need"] = i + 1
                t_commit[i] = now()
                self.next(qid=i, text=text)
                self.commit()
                with cv:
                    if not cv.wait_for(lambda: i in state["answers"], timeout=120):
                        raise TimeoutError(f"query {i} was not answered")
            base = len(singles)
            state["need"] = base + len(batch)
            t_commit[-1] = now()
            for i, text in enumerate(batch):
                self.next(qid=base + i, text=text)
            self.commit()
            with cv:
                if not cv.wait_for(lambda: len(state["answers"]) == base + len(batch), timeout=300):
                    raise TimeoutError("the batch epoch was not answered")

    def on_doc(key, row, time, is_addition):  # (the engine's own thread: the only writer)
        state["doc_rows"] += 1
        state["doc_times"].add(time)

    def on_epoch_end(time):
        with cv:
            cv.notify_all()

    def on_answer(key, row, time, is_addition):
        at = now()
        with cv:
            state["answers"][row["qid"]] = list(zip(row["ids"], row["scores"]))
            state["t_answer"][row["qid"]] = at
            if len(state["answers"]) >= state["need"]:
                cv.notify_all()

    pw.clear_graph()
    doc_schema = pw.schema_from_types(doc_id=int, text=str)
    docs = pw.io.python.read(Documents(), schema=doc_schema, autocommit_duration_ms=None)
    queries = pw.io.python.read(Queries(), schema=pw.schema_from_types(qid=int, text=str), autocommit_duration_ms=None)
    index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(
        docs.text, dimensions=enc.dim, reserved_space=n_docs, embedder=embedder, device=DEV))
    replies = index.query_as_of_now(queries.text, number_of_matches=k)
    answers = replies.select(qid=queries.qid, ids=pw.this.doc_id, scores=pw.this._pw_index_reply_score)
    pw.io.subscribe(docs, on_doc, on_time_end=on_epoch_end)
    pw.io.subscribe(answers, on_answer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DeviceKnnIndex.add_batch_device, DeviceKnnIndex.add_batch = counted_dev, counted_host
    try:
        _build.reset_launches()
        t_run = now()
        pw.run()
        torch.cuda.synchronize()
        run_s = now() - t_run
        launches = dict(_build.LAUNCHES)
    finally:
        DeviceKnnIndex.add_batch_device, DeviceKnnIndex.add_batch = real_dev, real_host
        pw.clear_graph()
    peak = torch.cuda.max_memory_allocated()
    lat = [(state["t_answer"][i] - t_commit[i]) * 1e3 for i in range(len(singles))]
    batch_ms = (max(state["t_answer"][len(singles) + i] for i in range(len(batch))) - t_commit[-1]) * 1e3
    ingest_epochs = len(state["doc_times"])

    # ---- gates, outside the counted run
    missing = [key for key in ("gemm_bias_act", "gemm_bias_residual_layernorm", "knn_topk_stream", "knn_topk_tc",
                               "knn_topk_merge") if launches.get(key, 0) == 0]
    if launches.get("masked_attention", 0) + launches.get("segment_attention", 0) == 0:
        missing.append("masked_attention or segment_attention")
    if missing:
        raise AssertionError(f"engine_path never launched {missing}")
    if state["doc_rows"] != n_docs or adds["device_rows"] != n_docs:
        raise AssertionError(f"{state['doc_rows']} documents delivered, {adds['device_rows']} reached the index")
    if ingest_epochs != n_epochs or adds["device_calls"] != ingest_epochs or adds["host_calls"]:
        raise AssertionError(
            f"add_batch_device carried {adds['device_calls']} of {ingest_epochs} ingest epochs ({n_epochs} commits, "
            f"{adds['host_calls']} host-side adds)"
        )
    # the library path over the same documents in the same batches
    for e in range(n_epochs):
        ids = list(range(e * per_epoch, min(n_docs, (e + 1) * per_epoch)))
        lib_index.add_batch_device(ids, enc.encode_device([texts[i] for i in ids], pad_to=per_epoch))
    lib_index.attach_encoder(enc)
    want = [lib_index.search_texts_batch([q], k)[0] for q in singles]
    t0 = now()
    want += lib_index.search_texts_batch(batch, k)
    lib_batch_ms = (now() - t0) * 1e3  # the batch epoch's search alone, outside the engine
    batch_ops, batch_device_ms = device_ops(torch, lambda: lib_index.search_texts_batch(batch, k))
    got = [state["answers"][i] for i in range(len(singles) + len(batch))]
    share, ok = _hits_agree(got, want, k)
    if not ok:
        raise AssertionError(f"engine hits disagree with the library path's beyond {HIT_TOL} ({share})")
    self_top1 = float(np.mean([got[i][0][0] == int(own[i]) for i in range(len(own))]))
    # one ingest epoch's device work: embed 1024 documents and scatter them
    scratch = DeviceKnnIndex(dim=enc.dim, metric="cos", reserved_space=2 * per_epoch, device=DEV)
    sample = texts[:per_epoch]
    epoch_ops, epoch_device_ms = device_ops(
        torch, lambda: scratch.add_batch_device(list(range(per_epoch)), enc.encode_device(sample, pad_to=per_epoch)))
    del lib_index, scratch
    # the flagship pipeline's worker-count invariance at full width
    w_docs = texts[:worker_docs]
    w_queries = singles[:32] + batch[:32]
    t0 = now()
    one = _engine_knn_workers(pw, w_docs, w_queries, 1)
    one_s = now() - t0
    four = _engine_knn_workers(pw, w_docs, w_queries, 4)
    four_s = now() - t0 - one_s
    w_share, w_ok = _hits_agree(four, one, k)
    if not w_ok:
        raise AssertionError(f"KNNIndex neighbour sets differ between 1 and 4 engine workers ({w_share})")
    emit(
        "engine_path", docs=n_docs, setup_seconds=t_setup, commits=n_epochs, ingest_epochs=ingest_epochs,
        ingest_seconds=state["ingest_s"], ingest_docs_per_s=n_docs / state["ingest_s"],
        query=_percentiles(lat), queries=len(singles), batch_epoch_queries=len(batch), batch_epoch_ms=batch_ms,
        library_batch_search_ms=lib_batch_ms, batch_search_device_ms=batch_device_ms,
        batch_search_device_ops=batch_ops and batch_ops["total"],
        run_seconds=run_s, ingest_epoch_device_ops=epoch_ops, ingest_epoch_device_ms=epoch_device_ms,
        add_batch_device_calls=adds["device_calls"], host_add_calls=adds["host_calls"],
        hits_vs_library_agreement=share, self_query_top1=self_top1, workers_1_vs_4_agreement=w_share,
        workers_docs=len(w_docs), workers_queries=len(w_queries), workers_1_seconds=one_s, workers_4_seconds=four_s,
        phase_seconds=now() - t_phase,
        max_memory_allocated=peak, launches=launches,
    )
    return launches


# server_path: the README's RAG document server. Files of the corpus, the
# sequential, filtered and burst queries, the burst's client threads, and the
# live changes: new files (bursts x files), modified and deleted files
SERVER_FILES, SERVER_QUERIES, SERVER_FILTERED, SERVER_BURST, SERVER_BURST_THREADS = 8192, 512, 64, 64, 8
SERVER_NEW_BURSTS, SERVER_NEW_PER_BURST, SERVER_MODIFIED, SERVER_DELETED = 4, 64, 64, 64


def _prose_files(rng, n_files: int) -> list[str]:
    """``n_files`` texts of synthetic prose: words Zipf over 8,000 made-up
    words (``_synthetic_texts``' vocabulary), sentences of 8-30 words, 300 to
    3,000 words a file, log-normal and long-tailed."""
    import numpy as np

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(8000)])
    zipf = 1.0 / np.arange(1, len(vocab) + 1)
    n_words = np.clip(np.round(rng.lognormal(np.log(900.0), 0.6, n_files)), 300, 3000).astype(np.int64)
    words = vocab[rng.choice(len(vocab), int(n_words.sum()), p=zipf / zipf.sum())]
    sentence_lens = rng.integers(8, 31, int(n_words.sum()) // 8 + n_files)
    out, pos, s = [], 0, 0
    for nw in n_words:
        end, parts = pos + int(nw), []
        while pos < end:
            ln = min(int(sentence_lens[s]), end - pos)
            s += 1
            parts.append(" ".join(words[pos : pos + ln]) + ".")
            pos += ln
        out.append(" ".join(parts))
    return out


def _unique_chunk(tag: str, rng, n_words: int = 40) -> str:
    """One chunk of text that occurs nowhere else: made-up words carrying
    ``tag`` (each one wordpiece under the hashed tokenizer)."""
    return " ".join(f"{tag}x{int(w)}" for w in rng.integers(0, 1 << 30, n_words)) + "."


def phase_server_path(torch, n_files: int = SERVER_FILES, n_queries: int = SERVER_QUERIES,
                      n_filtered: int = SERVER_FILTERED, n_burst: int = SERVER_BURST,
                      burst_threads: int = SERVER_BURST_THREADS, new_bursts: int = SERVER_NEW_BURSTS,
                      new_per_burst: int = SERVER_NEW_PER_BURST, n_modified: int = SERVER_MODIFIED,
                      n_deleted: int = SERVER_DELETED) -> dict:
    """The README's RAG serving example as written, on the port:
    ``pw.io.fs.read(folder, format="binary", mode="streaming",
    with_metadata=True)`` -> ``VectorStoreServer(embedder=
    SentenceTransformerEmbedder(), parser=ParseUtf8(),
    splitter=TokenCountSplitter())`` -> ``run_server(threaded=True)``,
    driven over real HTTP: ``n_queries`` sequential ``/v1/retrieve`` (k 10,
    each a random chunk's exact text), ``n_filtered`` with
    ``metadata_filter`` or ``filepath_globpattern``, one burst of
    ``n_burst`` concurrent requests from ``burst_threads`` client threads,
    ``/v1/statistics`` and ``/v1/inputs``; then, while serving,
    ``new_bursts`` bursts of ``new_per_burst`` new one-chunk files,
    ``n_modified`` files rewritten and ``n_deleted`` deleted; then the
    engine stops and the port is freed. Gates: the encoder kernels, B2's
    streaming pass and its merge launch; ``add_batch_device`` carries every
    ingest epoch and no host-side add happens; every unfiltered answer
    equals the library path's hits (``encode_device`` ->
    ``add_batch_device`` -> ``search_texts_batch`` replayed on the engine's
    own batches, adds and removals) under ``topk_agreement``; each
    exact-text query finds its chunk; filtered answers hold only matching
    paths; ``file_count`` equals the files present; new files become
    retrievable, modified files lose their old chunks and deleted files
    their path. Returns the launch counts of the served run."""
    import fnmatch
    import gc
    import http.client
    import shutil
    import socket
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DeviceKnnIndex
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.io import fs as fs_mod
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    now = time.perf_counter
    t_phase = now()
    k = 10
    rng = np.random.default_rng(SEED + 21)
    texts = _prose_files(rng, n_files)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    folder = tempfile.mkdtemp(prefix="server_path_docs_", dir=build_dir)
    paths = [os.path.join(folder, f"doc_{i:05d}.txt") for i in range(n_files)]
    for path, text in zip(paths, texts):
        with open(path, "w") as f:
            f.write(text)
    t_setup = now() - t_phase  # drawing and writing the corpus

    embedder = pw.xpacks.llm.embedders.SentenceTransformerEmbedder(device=DEV)
    enc = embedder._encoder
    enc.encode_device(texts[:256], pad_to=256)  # warm-up: first launches, handles
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    # every operation on the engine's index, in order, for the library replay
    ops: list[tuple] = []
    encoded: list[tuple] = []  # (texts, pad_to) of each encode_device call of the engine
    counts = collections.Counter()
    add_epochs: set = set()  # engine times of the device adds
    refills = collections.Counter()
    real = {name: getattr(DeviceKnnIndex, name) for name in
            ("add_batch_device", "add_batch", "remove", "search_texts_batch", "_device_topk")}
    real_encode, real_chunk, real_init = embedder.encode_device, TokenCountSplitter.chunk, GraphRunner.__init__
    real_list_files, scans = fs_mod._list_files, []  # the streaming scanner's start times
    runners = []

    def encode_device(batch, pad_to=None):
        encoded.append((list(batch), pad_to))
        return real_encode(batch, pad_to=pad_to)

    def add_batch_device(self, keys, vecs, metas=None):
        real["add_batch_device"](self, keys, vecs, metas)
        counts["device_calls"] += 1
        add_epochs.add(runners[-1].engine.current_time)
        batch, pad_to = encoded[-1]
        ops.append(("add", list(keys), list(metas), batch, pad_to))

    def add_batch(self, items):
        counts["host_calls"] += 1
        return real["add_batch"](self, items)

    def remove(self, key):
        real["remove"](self, key)
        ops.append(("remove", key))

    def search_texts_batch(self, batch, kk, filter_fns=None):
        out = real["search_texts_batch"](self, batch, kk, filter_fns)
        ops.append(("search", list(batch), kk, filter_fns, out))
        return out

    def device_topk(self, q, fetch):
        if fetch > 64:  # a filtered query's refill; its first one past 64 fetches 256 (or the capacity)
            refills["queries"] += int(q.shape[0]) if fetch <= 256 else 0
            refills["dispatches"] += 1
            refills["max_fetch"] = max(refills["max_fetch"], int(fetch))
        return real["_device_topk"](self, q, fetch)

    def list_files(*a, **kw):
        scans.append(now())
        return real_list_files(*a, **kw)

    def chunk(self, txt):
        t0 = now()
        try:
            return real_chunk(self, txt)
        finally:
            counts["split_s"] += now() - t0

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    def post(path, payload, timeout=300):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    answers: dict[str, list] = collections.defaultdict(list)  # unfiltered query text -> its answers, in order

    def retrieve(text, **filters):
        hits = post("/v1/retrieve", {"query": text, "k": k, **filters})
        if not filters:
            answers[text].append(hits)
        return hits

    chunk_epochs: set = set()
    pw.clear_graph()
    docs = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    server = pw.xpacks.llm.VectorStoreServer(docs, embedder=embedder, parser=pw.xpacks.llm.parsers.ParseUtf8(),
                                             splitter=pw.xpacks.llm.splitters.TokenCountSplitter())
    pw.io.subscribe(server._graph["chunked_docs"],
                    lambda key, row, time, is_addition: is_addition and chunk_epochs.add(time))
    embedder.encode_device = encode_device
    for name, fn in (("add_batch_device", add_batch_device), ("add_batch", add_batch), ("remove", remove),
                     ("search_texts_batch", search_texts_batch), ("_device_topk", device_topk)):
        setattr(DeviceKnnIndex, name, fn)
    TokenCountSplitter.chunk, GraphRunner.__init__, fs_mod._list_files = chunk, recording_init, list_files
    result: dict = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t_run = now()
        run = server.run_server(host="127.0.0.1", port=port, threaded=True)

        def file_count(timeout=600):
            deadline = now() + timeout
            while True:
                try:
                    return post("/v1/statistics", {})["file_count"]
                except OSError:  # the endpoint is not up yet
                    if now() > deadline:
                        raise
                    time.sleep(0.2)

        def wait_files(n, timeout=600):
            deadline = now() + timeout
            while (count := file_count()) != n:
                if now() > deadline:
                    raise TimeoutError(f"/v1/statistics counts {count} files, expected {n}")
                time.sleep(0.1)

        wait_files(n_files)
        ingest_s = now() - t_run
        chunks = [(m.value["path"], t) for op in ops if op[0] == "add" for m, t in zip(op[2], op[3])]
        result.update(files=n_files, chunks=len(chunks), ingest_seconds=ingest_s, ingest_files_per_s=n_files / ingest_s,
                      ingest_chunks_per_s=len(chunks) / ingest_s, splitter_seconds=counts["split_s"],
                      splitter_share=counts["split_s"] / ingest_s, ingest_epochs=len(chunk_epochs))
        emit("server_path_ingest", **result)
        chunks_of: dict[str, list] = collections.defaultdict(list)
        for path, text in chunks:
            chunks_of[path].append(text)

        # sequential exact-text queries, then filtered ones
        picked = rng.choice(len(chunks), n_queries + n_burst, replace=False)
        own = [chunks[i] for i in picked[:n_queries]]
        lat, top1, found = [], 0, 0
        for path, text in own:
            t0 = now()
            hits = retrieve(text)
            lat.append((now() - t0) * 1e3)
            keys = [(h["metadata"]["path"], h["text"]) for h in hits]
            top1 += keys[:1] == [(path, text)]
            found += (path, text) in keys
        if found != len(own):
            raise AssertionError(f"{len(own) - found} of {len(own)} exact-text queries missed their own chunk")
        bad_filter = 0
        for j in range(n_filtered):
            i = int(rng.integers(0, n_files))
            stem = os.path.basename(paths[i])
            if j % 2:
                flt, match = {"metadata_filter": f"contains(path, `{stem[:8]}`)"}, lambda p, s=stem[:8]: s in p
            else:
                pattern = f"**/{stem[:7]}*.txt"
                flt, match = {"filepath_globpattern": pattern}, lambda p, s=stem[:7]: fnmatch.fnmatch(
                    os.path.basename(p), f"{s}*.txt")
            hits = retrieve(chunks_of[paths[i]][0], **flt)
            bad_filter += (not hits) or any(not match(h["metadata"]["path"]) for h in hits)
        if bad_filter:
            raise AssertionError(f"{bad_filter} filtered answers were empty or held a path outside their filter")

        # one burst of concurrent requests from a few client threads, each with several connections open
        burst = [chunks[i][1] for i in picked[n_queries:]]
        burst_lat: list[float] = []
        searches_before = sum(1 for op in ops if op[0] == "search")

        def client(mine):
            conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=300) for _ in mine]
            sent = []
            for conn, text in zip(conns, mine):
                sent.append(now())
                conn.request("POST", "/v1/retrieve", json.dumps({"query": text, "k": k}),
                             {"Content-Type": "application/json"})
            for conn, text, t0 in zip(conns, mine, sent):
                body = json.loads(conn.getresponse().read().decode())
                burst_lat.append((now() - t0) * 1e3)
                answers[text].append(body)
                conn.close()

        t0 = now()
        workers = [threading.Thread(target=client, args=(burst[i::burst_threads],)) for i in range(burst_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        burst_ms = (now() - t0) * 1e3
        burst_epochs = [len(op[1]) for op in ops[searches_before:] if op[0] == "search"]
        if len(burst_lat) != len(burst):
            raise AssertionError(f"{len(burst_lat)} of {len(burst)} burst requests were answered")
        inputs = post("/v1/inputs", {})
        if file_count() != n_files or len(inputs) != n_files:
            raise AssertionError(f"/v1/inputs lists {len(inputs)} files, expected {n_files}")

        # live changes while serving: new files, then modified, then deleted ones
        present = n_files
        to_retrievable = []
        for b in range(new_bursts):
            new = {}
            for i in range(new_per_burst):
                path = os.path.join(folder, f"new_{b}_{i:03d}.txt")
                text = _unique_chunk(f"n{b}q{i}", rng)
                with open(path, "w") as f:
                    f.write(text)
                new[path] = (text, now())
            present += len(new)
            deadline = now() + 120
            while new:
                for path, (text, t_write) in list(new.items()):
                    if any(h["metadata"]["path"] == path for h in retrieve(text)):
                        to_retrievable.append(now() - t_write)
                        del new[path]
                if new and now() > deadline:
                    raise AssertionError(f"{len(new)} new files were never retrievable")
        wait_files(present)
        changed = [paths[i] for i in rng.choice(n_files, n_modified + n_deleted, replace=False)]
        modified, deleted = changed[:n_modified], changed[n_modified:]
        rewritten = {}
        for path in modified:
            rewritten[path] = _unique_chunk(f"m{os.path.basename(path)[4:9]}", rng)
            with open(path, "w") as f:
                f.write(rewritten[path])
        deadline = now() + 120
        while rewritten:  # until each new text finds its file, then its old chunks must be gone
            for path, text in list(rewritten.items()):
                if any((h["metadata"]["path"], h["text"]) == (path, text) for h in retrieve(text)):
                    del rewritten[path]
            if rewritten and now() > deadline:
                raise AssertionError(f"the new texts of {len(rewritten)} modified files were never retrievable")
        stale = sum(any((h["metadata"]["path"], h["text"]) in {(path, t) for t in chunks_of[path]}
                        for h in retrieve(chunks_of[path][0])) for path in modified)
        for path in deleted:
            os.remove(path)
        present -= len(deleted)
        wait_files(present)
        gone = set(deleted)
        stale += sum(any(h["metadata"]["path"] in gone for h in retrieve(chunks_of[path][-1])) for path in deleted)
        inputs = post("/v1/inputs", {})
        if stale or len(inputs) != present or gone & {m["path"] for m in inputs}:
            raise AssertionError(f"{stale} answers after a change still held a modified file's old chunk or a "
                                 f"deleted file's path; /v1/inputs lists {len(inputs)} of {present} files")
    finally:
        if runners:
            runners[-1].engine.stop()
        embedder.encode_device = real_encode
        for name, fn in real.items():
            setattr(DeviceKnnIndex, name, fn)
        TokenCountSplitter.chunk, GraphRunner.__init__, fs_mod._list_files = real_chunk, real_init, real_list_files
    run.join(timeout=120)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    run_s = now() - t_run
    pw.clear_graph()
    if run.is_alive():
        raise AssertionError("the served run did not end after the engine stopped")
    with socket.socket() as s:  # the server closed its socket: a new listener binds the port
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
    shutil.rmtree(folder)

    # ---- gates, outside the counted run
    missing = [key for key in ("gemm_bias_act", "gemm_bias_residual_layernorm", "knn_topk_stream", "knn_topk_merge")
               if launches.get(key, 0) == 0]
    if launches.get("masked_attention", 0) + launches.get("segment_attention", 0) == 0:
        missing.append("masked_attention or segment_attention")
    if missing:
        raise AssertionError(f"server_path never launched {missing}")
    if add_epochs != chunk_epochs or counts["host_calls"]:
        raise AssertionError(f"add_batch_device carried {len(add_epochs & chunk_epochs)} of {len(chunk_epochs)} "
                             f"ingest epochs ({len(add_epochs - chunk_epochs)} others, {counts['host_calls']} "
                             f"host-side adds)")
    # the library path: the same adds (same chunk texts, same batches), removals and search batches, replayed
    lib = DeviceKnnIndex(dim=enc.dim, metric="cos", reserved_space=1024, device=DEV)
    lib.attach_encoder(enc)
    named: dict = {}  # key -> (path, text)
    want: dict[str, list] = collections.defaultdict(list)
    for op in ops:
        if op[0] == "add":
            _, keys, metas, batch, pad_to = op
            lib.add_batch_device(keys, enc.encode_device(batch, pad_to=pad_to), metas)
            named.update({key: (m.value["path"], t) for key, m, t in zip(keys, metas, batch)})
        elif op[0] == "remove":
            lib.remove(op[1])
        else:
            _, batch, kk, filter_fns, _ = op
            out = lib.search_texts_batch(batch, kk, filter_fns)
            for i, (text, hits) in enumerate(zip(batch, out)):
                if filter_fns is None or filter_fns[i] is None:
                    want[text].append([(named[key], score) for key, score in hits])
    ids: dict = {}
    got_rows, want_rows = [], []
    for text, seq in answers.items():
        if len(want[text]) != len(seq):
            raise AssertionError(f"{len(seq)} answers to one query text, {len(want[text])} library searches")
        for hits, lib_hits in zip(seq, want[text]):
            got_rows.append([(ids.setdefault((h["metadata"]["path"], h["text"]), len(ids)), -h["dist"]) for h in hits])
            want_rows.append([(ids.setdefault(name, len(ids)), score) for name, score in lib_hits])
    share, ok = _hits_agree(got_rows, want_rows, k)
    if not ok:
        raise AssertionError(f"served answers disagree with the library path's beyond {HIT_TOL} ({share})")
    first = next(op for op in ops if op[0] == "add")
    scratch = DeviceKnnIndex(dim=enc.dim, metric="cos", reserved_space=len(first[1]), device=DEV)
    ingest_ops, ingest_device_ms = device_ops(torch, lambda: scratch.add_batch_device(
        first[1], enc.encode_device(first[3], pad_to=first[4])))
    del lib, scratch, server, embedder, enc, ops, encoded
    gc.collect()
    torch.cuda.empty_cache()
    result.update(
        setup_seconds=t_setup, ingest_device_ms=ingest_device_ms, ingest_device_ops=ingest_ops and ingest_ops["total"],
        retrieve=_percentiles(lat), queries=len(own), self_query_top1=top1 / len(own), filtered_queries=n_filtered,
        filtered_refilled_past_64=refills["queries"], filtered_refill_dispatches=refills["dispatches"],
        filtered_max_fetch=refills["max_fetch"], scans=len(scans),
        scan_period=_percentiles(np.diff(scans[1:]) * 1e3) if len(scans) > 2 else None,
        burst_requests=len(burst), burst_threads=burst_threads, burst_wall_ms=burst_ms,
        burst_request=_percentiles(burst_lat), burst_epoch_queries=burst_epochs,
        new_files=len(to_retrievable), write_to_retrievable_p50_s=float(np.percentile(to_retrievable, 50)),
        write_to_retrievable_max_s=float(max(to_retrievable)), modified_files=len(modified),
        deleted_files=len(deleted), files_at_end=present, answers_vs_library=share,
        answers_compared=len(got_rows), add_batch_device_calls=counts["device_calls"],
        add_batch_device_epochs=len(add_epochs), host_add_calls=counts["host_calls"], b4_fired=launches.get("segment_attention", 0) > 0,
        run_seconds=run_s, phase_seconds=now() - t_phase, max_memory_allocated=peak, launches=launches,
    )
    emit("server_path", **result)
    return launches


def phase_decode_path(torch, cross) -> dict:
    """The decode plane as ``bench.py``'s decode-serving suite drives it: 64
    seeded prompts of 4-63 tokens, each submitted after a
    ``DeviceReranker.order`` over 8 candidates at cross_encoder_l6 width,
    one engine step per arrival, then drain."""
    import numpy as np

    from pathway_tpu_torch import DecodeConfig, DecodeEngine, DecoderConfig, DeviceReranker
    from pathway_tpu_torch.ops import _build

    mcfg = DecoderConfig()
    dcfg = DecodeConfig(pages=512, page_size=16, lanes=8, max_new_tokens=32, degrade_max_new_tokens=8, max_seq=160)
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(1, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(4, 64, 64)]
    cand_docs = [f"candidate document {i} about topic {i % 7}" for i in range(8)]
    engine = DecodeEngine(mcfg, dcfg, seed=SEED, device=DEV)
    reranker = DeviceReranker(scorer=cross)
    engine.generate(prompts[:2])  # warm-up: cuBLAS handles and the first launches
    reranker.order("warmup", cand_docs)
    steps0 = engine.steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    tickets, done_at = [], {}

    def poll() -> None:
        now = time.monotonic()
        for i, (_, tk) in enumerate(tickets):
            if i not in done_at and tk.done.is_set():
                done_at[i] = now

    t0 = time.perf_counter()
    for qi, prompt in enumerate(prompts):
        reranker.order(f"query {qi}", cand_docs)
        tickets.append((time.monotonic(), engine.submit(prompt)))
        engine.step()  # arrivals interleave with in-flight decoding
        poll()
    while engine.busy():
        engine.step()
        poll()
    poll()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    streams = [tk.tokens for _, tk in tickets]
    completion = [(done_at[i] - tickets[i][0]) * 1e3 for i in range(len(tickets))]

    # ---- gates, outside the counted run
    for key in ("paged_decode_attention", "paged_decode_combine"):
        if launches.get(key, 0) == 0:
            raise AssertionError(f"decode_path never launched {key} (B5)")
    if any(len(s) != dcfg.max_new_tokens for s in streams):
        raise AssertionError("a decode stream is short")
    plain = DecodeEngine(mcfg, dataclasses.replace(dcfg, impl="xla"), seed=SEED, device=DEV).generate(prompts)
    splits = []
    for prompt, got, want in zip(prompts, streams, plain):
        t, gap = _first_split(torch, engine.params, mcfg, prompt, got, want)
        if t is not None:
            splits.append({"step": t, "top2_gap": gap})
            if gap >= NEAR_TIE:
                raise AssertionError(f"kernel and plain decode part at step {t} with a top-2 gap of {gap}")
    alone = DecodeEngine(mcfg, dcfg, seed=SEED, device=DEV).generate([prompts[0]])[0]
    together = DecodeEngine(mcfg, dcfg, seed=SEED, device=DEV).generate(prompts[:8])[0]
    if alone != together:
        raise AssertionError("a prompt decodes differently alone and among seven others")
    # one full-width step of a fresh engine with 8 live lanes: wall vs device time
    probe = DecodeEngine(mcfg, dcfg, seed=SEED, device=DEV)
    for prompt in prompts[:8]:
        probe.submit(prompt)
    probe.step()  # admits (prefills) all eight, then steps
    t0 = time.perf_counter()
    probe.step()
    step_wall_ms = (time.perf_counter() - t0) * 1e3
    step_ops, step_device_ms = device_ops(torch, probe.step)
    tokens = sum(len(s) for s in streams)
    emit(
        "decode_path", step_wall_ms=step_wall_ms, step_device_ops=step_ops, step_device_ms=step_device_ms, prompts=len(prompts), tokens=tokens, wall_seconds=wall, tokens_per_s=tokens / wall,
        completion=_percentiles(completion), steps=engine.steps - steps0, streams_equal_plain=len(prompts) - len(splits),
        near_tie_splits=splits, alone_equals_batched=True, max_memory_allocated=peak, launches=launches,
    )
    return launches


# decode_ext_path: the traffic (requests, of them long ones, their shared
# prefixes), the pool and lanes, the request deadline, and the configurations
DECODE_EXT_REQUESTS, DECODE_EXT_LONG, DECODE_EXT_PREFIXES, DECODE_EXT_DEADLINE_MS = 64, 8, 4, 120_000.0
DECODE_EXT_POOL = "pages=1024,page=16,lanes=8,max_new=32,degrade=8,max_seq=512"
DECODE_EXT_IMPL = "paged"  # kernel B5
DECODE_EXT_CONFIGS = (
    ("a_greedy", ""),
    ("b_cache_chunk", ",cache=on,chunk=64"),
    ("c_spec_layer_skip", ",cache=on,chunk=64,spec=4,draft=2"),
    ("d_spec_prompt_lookup", ",cache=on,chunk=64,spec=4,draft=2,ngram=3"),
)
DECODE_EXT_SAMPLED = f",temp=0.8,top_k=50,top_p=0.95,seed={SEED}"
# the service's batcher: the engine batches continuously inside a dispatch
# (which drains it), so a dispatch takes every queued request (up to 64) after
# a 20 ms coalescing window, and no slot is yielded (no ingest runs beside it)
DECODE_EXT_SERVING = dict(max_queue=256, batch_max=64, batch_window_ms=20.0, latency_budget_ms=60_000.0,
                          query_share=1.0)


def _decode_ext_prompts(vocab: int) -> list[list[int]]:
    """64 seeded requests: each starts with one of 4 shared system prefixes
    of 64-256 tokens (whole pages of 16), then a 4-63-token question; 8 of
    them are long, 300-440 tokens, so chunked prefill interleaves with
    decoding."""
    import numpy as np

    rng = np.random.default_rng(SEED + 13)
    prefixes = [rng.integers(1, vocab, 16 * int(n)).tolist() for n in rng.integers(4, 17, DECODE_EXT_PREFIXES)]
    long = set(rng.choice(DECODE_EXT_REQUESTS, DECODE_EXT_LONG, replace=False).tolist())
    prompts = []
    for i in range(DECODE_EXT_REQUESTS):
        pre = prefixes[i % DECODE_EXT_PREFIXES]
        n_q = int(rng.integers(300, 441)) - len(pre) if i in long else int(rng.integers(4, 64))
        prompts.append(pre + rng.integers(1, vocab, n_q).tolist())
    return prompts


def _serve_decode(torch, pw, mcfg, spec: str, prompts) -> dict:
    """``pw.run(decode=spec)`` over one python connector whose subject builds
    a ``DecodeEngine`` (its config from the run, ``active_decode()``) behind a
    ``DecodeService``, submits every prompt with a deadline, and hands each
    stream to the dataflow as a row; ``pw.io.subscribe`` collects them. The
    launch counters are set to 0 just before the run and again, with the
    decode metrics, after the engine's warm-up inside it, and read just after
    the run; the service's error, the pool and the cache are read after the
    drain."""
    import numpy as np

    from pathway_tpu_torch.decode import DECODE_METRICS, DecodeEngine, DecodeService
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.serving import Deadline, ServingConfig

    state: dict = {}

    class Requests(pw.io.python.ConnectorSubject):
        def run(self):
            engine = DecodeEngine(mcfg, seed=SEED, device=DEV)
            engine.generate([[7] * 24])  # warm-up: cuBLAS handles, first launches (one cached page at most)
            torch.cuda.synchronize()
            _build.reset_launches()  # the counts are the 64 requests' own, not the warm-up's
            DECODE_METRICS.reset()
            svc = DecodeService(engine, config=ServingConfig(**DECODE_EXT_SERVING))
            done_at: dict = {}
            t0 = time.perf_counter()
            sent = []
            for p in prompts:
                sent.append(time.perf_counter())
                sent_ticket = svc.submit(p, deadline=Deadline(DECODE_EXT_DEADLINE_MS))
                state.setdefault("tickets", []).append(sent_ticket)
            tickets = state["tickets"]
            while len(done_at) < len(tickets) and svc.error is None:
                for i, tk in enumerate(tickets):
                    if i not in done_at and tk.done.is_set():
                        done_at[i] = time.perf_counter()
                time.sleep(0.0005)
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - t0
            svc.stop()
            state.update(error=svc.error, config=engine.config, pages_in_use=engine.pool.pages_in_use,
                         cached_pages=engine.cache.cached_pages if engine.cache is not None else 0,
                         completion_ms=[(done_at[i] - sent[i]) * 1e3 for i in sorted(done_at)],
                         metrics=DECODE_METRICS.snapshot(), params=engine.params,
                         preempted=sum(tk.preempted for tk in tickets))
            for i, tk in enumerate(tickets):
                self.next(i=i, tokens=json.dumps(tk.tokens))

    pw.clear_graph()
    rows = pw.io.python.read(Requests(), schema=pw.schema_from_types(i=int, tokens=str), autocommit_duration_ms=50)
    streams: dict = {}
    pw.io.subscribe(rows, lambda key, row, time, is_addition: streams.__setitem__(row["i"], json.loads(row["tokens"])))
    torch.cuda.synchronize()
    _build.reset_launches()
    pw.run(decode=f"{DECODE_EXT_POOL},impl={DECODE_EXT_IMPL}{spec}")
    launches = dict(_build.LAUNCHES)
    pw.clear_graph()
    if state.get("error") is not None:
        raise AssertionError(f"DecodeService failed under {spec!r}: {state['error']!r}")
    if sorted(streams) != list(range(len(prompts))) or state["preempted"]:
        raise AssertionError(f"{len(streams)} of {len(prompts)} streams came back ({state['preempted']} preempted)")
    if state["pages_in_use"] != state["cached_pages"]:
        raise AssertionError(f"the pool holds {state['pages_in_use']} pages after the drain, "
                             f"{state['cached_pages']} of them cached")
    if state["config"] != pw.decode.parse_decode_spec(f"{DECODE_EXT_POOL},impl={DECODE_EXT_IMPL}{spec}"):
        raise AssertionError("the engine built in the run did not take pw.run(decode=)'s config")
    tokens = sum(len(v) for v in streams.values())
    m = state["metrics"]
    return dict(
        streams=[streams[i] for i in range(len(prompts))], launches=launches, params=state["params"],
        summary=dict(
            tokens=tokens, wall_seconds=state["wall"], tokens_per_s=tokens / state["wall"],
            completion=_percentiles(state["completion_ms"]), prefix_hit_ratio=m.get("prefix_hit_ratio", 0.0),
            prefix_hit_pages=m.get("prefix_hit_pages_total", 0),
            prefill_tokens_saved=m.get("prefix_hit_pages_total", 0) * 16,
            spec_proposed=m.get("spec_proposed_total", 0), spec_acceptance_rate=m.get("spec_acceptance_rate", 0.0),
            steps=m["steps_total"], pool_pages_after=state["pages_in_use"], cached_pages_after=state["cached_pages"],
            b5_launches=launches.get("paged_decode_attention", 0),
        ),
    )


def _lane_logits(torch, params, mcfg, prompt, tokens, attention) -> list:
    """The next-token logits of one lane after ``prompt`` and each prefix of
    ``tokens``, computed as the engine's step computes them (prefill, then
    one decode step per token through ``attention`` over a paged pool):
    entry t is what token t is drawn from."""
    from pathway_tpu_torch.decode.engine import _prefill_logits_math, _step_logits_math
    from pathway_tpu_torch.ops.paged_attention import PagedKvPool, pages_for

    ps, plen = 16, len(prompt)
    n_pages = pages_for(plen + len(tokens) + 1, ps)
    pool = PagedKvPool(layers=mcfg.num_layers, dim=mcfg.hidden_size, n_pages=n_pages, page_size=ps, device=DEV)
    table = torch.arange(n_pages, device=DEV, dtype=torch.int32)[None]
    with torch.no_grad():
        ids = torch.tensor([prompt], device=DEV)
        k_rows, v_rows, logits = _prefill_logits_math(params, mcfg, ids, torch.tensor([plen], device=DEV))
        pos = torch.arange(plen, device=DEV)
        pool.k[:, pos // ps, pos % ps] = k_rows[0]
        pool.v[:, pos // ps, pos % ps] = v_rows[0]
        out = [logits[0]]
        for t, tok in enumerate(tokens[:-1]):
            at = plen + t
            lens = torch.tensor([at], device=DEV, dtype=torch.int32)

            def attend(layer, q, k_new, v_new, at=at, lens=lens):
                pool.k[layer, at // ps, at % ps] = k_new[0]
                pool.v[layer, at // ps, at % ps] = v_new[0]
                return attention(q, pool.k[layer], pool.v[layer], table, lens + 1, n_heads=mcfg.num_heads)

            out.append(_step_logits_math(params, mcfg, torch.tensor([tok], device=DEV), lens, attend)[0])
    return out


def phase_decode_ext_path(torch) -> dict:
    """The decode extensions at ``DecoderConfig()`` width (vocab 32,000, d
    256, 4 layers of 4 heads of 64, 512 positions), ``impl="paged"``, each
    configuration a ``pw.run(decode=<spec>)`` whose engine takes the spec
    through ``active_decode()`` and serves 64 requests through
    ``DecodeService`` (``_serve_decode``): (a) greedy, (b) the prefix cache
    with chunked prefill of 64, (c) (b) with 4 speculative tokens drafted by
    2 layers, (d) (c) drafted by prompt lookup (n-gram 3); then sampled
    decode (temperature 0.8, top-k 50, top-p 0.95) twice. Gates: (b), (c)
    and (d) give (a)'s streams or part only at a near tie; B5 launches in the
    greedy and the sampled step; the cache hits; the verify runs; the
    service keeps no error; the pool returns to its cached pages; the
    sampled streams repeat, equal those of each prompt decoded alone, and
    where they part from an ``impl="xla"`` engine's the two attentions'
    logits there agree at f32 1e-4."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DecodeEngine, DecoderConfig
    from pathway_tpu_torch.decode import parse_decode_spec
    from pathway_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    t_phase = time.perf_counter()
    mcfg = DecoderConfig()
    prompts = _decode_ext_prompts(mcfg.vocab_size)
    launches: collections.Counter = collections.Counter()
    runs = {}
    for tag, spec in DECODE_EXT_CONFIGS:
        runs[tag] = _serve_decode(torch, pw, mcfg, spec, prompts)
        launches.update(runs[tag]["launches"])
        emit("decode_ext_config", config=tag, spec=DECODE_EXT_POOL + spec, **runs[tag]["summary"])
    sampled = _serve_decode(torch, pw, mcfg, DECODE_EXT_SAMPLED, prompts)
    launches.update(sampled["launches"])
    emit("decode_ext_config", config="e_sampled", spec=DECODE_EXT_POOL + DECODE_EXT_SAMPLED, **sampled["summary"])
    again = _serve_decode(torch, pw, mcfg, DECODE_EXT_SAMPLED, prompts)
    launches.update(again["launches"])

    # ---- gates, outside the counted runs
    params = runs["a_greedy"]["params"]
    base = runs["a_greedy"]["streams"]
    parted = {}
    for tag in ("b_cache_chunk", "c_spec_layer_skip", "d_spec_prompt_lookup"):
        splits = []
        for prompt, got, want in zip(prompts, runs[tag]["streams"], base):
            t, gap = _first_split(torch, params, mcfg, prompt, got, want)
            if t is not None:
                splits.append({"step": t, "top2_gap": gap})
                if gap >= NEAR_TIE:
                    raise AssertionError(f"{tag} parts from greedy at step {t} with a top-2 gap of {gap}")
        parted[tag] = splits
    for tag in ("a_greedy", "e_sampled"):
        run = runs.get(tag, sampled)
        if run["launches"].get("paged_decode_attention", 0) == 0:
            raise AssertionError(f"decode_ext_path {tag} never launched B5")
    if runs["b_cache_chunk"]["summary"]["prefix_hit_pages"] == 0:
        raise AssertionError("the prefix cache never hit")
    for tag in ("c_spec_layer_skip", "d_spec_prompt_lookup"):
        if runs[tag]["summary"]["spec_proposed"] == 0:
            raise AssertionError(f"{tag}: the verify never ran")
    if sampled["streams"] != again["streams"]:
        raise AssertionError("sampled decode is not reproducible across two runs")
    scfg = parse_decode_spec(f"{DECODE_EXT_POOL},impl={DECODE_EXT_IMPL}{DECODE_EXT_SAMPLED}")
    alone = [DecodeEngine(mcfg, scfg, seed=SEED, device=DEV).generate([p])[0] for p in prompts[:4]]
    if alone != sampled["streams"][:4]:
        raise AssertionError("a sampled stream differs alone and batched")
    xla = DecodeEngine(mcfg, dataclasses.replace(scfg, impl="xla"), seed=SEED, device=DEV).generate(prompts)
    sampled_splits = []
    for prompt, got, want in zip(prompts, sampled["streams"], xla):
        t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if t is None:
            continue
        kern = _lane_logits(torch, params, mcfg, prompt, got[: t + 1], paged_decode_attention)[t]
        plain = _lane_logits(torch, params, mcfg, prompt, got[: t + 1], paged_attention_reference)[t]
        sampled_splits.append({"step": t, "max_abs_err": held(f"sampled logits at step {t}", kern, plain, **F32_TOL)})

    # the sampled step: one full-width step of a fresh engine with 8 live lanes, wall and device time
    probe = DecodeEngine(mcfg, scfg, seed=SEED, device=DEV)
    for p in prompts[:8]:
        probe.submit(p)
    probe.step()  # admits (prefills) all eight, then steps
    t0 = time.perf_counter()
    probe.step()
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3
    step_ops, step_device_ms = device_ops(torch, probe.step)
    emit(
        "decode_ext_path", requests=len(prompts), prompt_tokens=sum(len(p) for p in prompts),
        long_requests=DECODE_EXT_LONG, configs={tag: r["summary"] for tag, r in runs.items()},
        sampled=sampled["summary"], near_tie_splits=parted, sampled_repeats=True, sampled_alone_equals_batched=True,
        sampled_vs_xla_splits=sampled_splits, sampled_step_wall_ms=step_wall_ms, sampled_step_device_ms=step_device_ms,
        sampled_step_device_ops=step_ops and step_ops["total"], phase_seconds=time.perf_counter() - t_phase,
        launches=dict(launches),
    )
    return dict(launches)


# mesh_path: shards on one card, index rows (4 x 2^20), documents embedded, text
# queries, the engine's streamed documents and its single queries
MESH_ONE_CARD_SHARDS, MESH_ROWS, MESH_DOCS, MESH_QUERIES = 4, 1 << 22, 16_384, 512
MESH_ENGINE_DOCS, MESH_ENGINE_SINGLES, MESH_ENGINE_EPOCH = 32_768, 128, 1024
# the mesh encoder against the single-device one: the bound the JAX package
# holds its own mesh encoder to (tests/test_sharding.py)
MESH_ENCODER_TOL = dict(rtol=2e-3, atol=1e-3, min_cos=0.9999)


def _stream_and_query(torch, pw, embedder, texts: list, singles: list, batch: list, per_epoch: int, cards=None,
                      **run_kwargs):
    """``engine_path``'s pipeline: ``texts`` streamed by a subject committing
    every ``per_epoch`` (each commit waits for its delivery) ->
    ``DataIndex(BruteForceKnn(embedder=))`` -> ``singles`` one epoch each,
    then ``batch`` as one epoch, ``query_as_of_now(number_of_matches=10)``,
    under ``pw.run(**run_kwargs)`` -> (per query [(doc_id, score)], ingest
    seconds, run seconds); each clock is read after every card of ``cards``
    (default: the current one) is done."""
    import threading

    k, n_docs = 10, len(texts)
    n_epochs = -(-n_docs // per_epoch)
    cv = threading.Condition()
    state = {"doc_rows": 0, "answers": {}, "ingest_done": False, "need": 0}

    class Documents(pw.io.python.ConnectorSubject):
        def run(self):
            for e in range(n_epochs):
                for i in range(e * per_epoch, min(n_docs, (e + 1) * per_epoch)):
                    self.next(doc_id=i, text=texts[i])
                if e == 0:
                    state["t0"] = time.perf_counter()
                self.commit()
                with cv:
                    if not cv.wait_for(lambda: state["doc_rows"] >= min(n_docs, (e + 1) * per_epoch), timeout=300):
                        raise TimeoutError(f"ingest epoch {e} was not delivered")
            sync_cards(torch, cards)
            state["ingest_s"] = time.perf_counter() - state["t0"]
            with cv:
                state["ingest_done"] = True
                cv.notify_all()

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            with cv:
                cv.wait_for(lambda: state["ingest_done"], timeout=1200)
            for i, text in enumerate(singles):
                state["need"] = i + 1
                self.next(qid=i, text=text)
                self.commit()
                with cv:
                    if not cv.wait_for(lambda: i in state["answers"], timeout=120):
                        raise TimeoutError(f"query {i} was not answered")
            state["need"] = len(singles) + len(batch)
            for i, text in enumerate(batch):
                self.next(qid=len(singles) + i, text=text)
            self.commit()
            with cv:
                if not cv.wait_for(lambda: len(state["answers"]) == state["need"], timeout=300):
                    raise TimeoutError("the batch epoch was not answered")

    def on_doc(key, row, time, is_addition):
        state["doc_rows"] += 1

    def on_epoch_end(time):
        with cv:
            cv.notify_all()

    def on_answer(key, row, time, is_addition):
        with cv:
            state["answers"][row["qid"]] = list(zip(row["ids"], row["scores"]))
            if len(state["answers"]) >= state["need"]:
                cv.notify_all()

    pw.clear_graph()
    schema = pw.schema_from_types(doc_id=int, text=str)
    docs = pw.io.python.read(Documents(), schema=schema, autocommit_duration_ms=None)
    queries = pw.io.python.read(Queries(), schema=pw.schema_from_types(qid=int, text=str), autocommit_duration_ms=None)
    index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(
        docs.text, dimensions=embedder.get_embedding_dimension(), reserved_space=n_docs, embedder=embedder))
    answers = index.query_as_of_now(queries.text, number_of_matches=k).select(
        qid=queries.qid, ids=pw.this.doc_id, scores=pw.this._pw_index_reply_score)
    pw.io.subscribe(docs, on_doc, on_time_end=on_epoch_end)
    pw.io.subscribe(answers, on_answer)
    try:
        t0 = time.perf_counter()
        pw.run(**run_kwargs)
        sync_cards(torch, cards)
        run_s = time.perf_counter() - t0
    finally:
        pw.clear_graph()
    if state["doc_rows"] != n_docs:
        raise AssertionError(f"{state['doc_rows']} of {n_docs} documents delivered")
    return [state["answers"][i] for i in range(len(singles) + len(batch))], state["ingest_s"], run_s


def phase_mesh_path(torch, rows: int = MESH_ROWS, n_docs: int = MESH_DOCS, n_queries: int = MESH_QUERIES,
                    engine_docs: int = MESH_ENGINE_DOCS, engine_singles: int = MESH_ENGINE_SINGLES) -> dict:
    """The mesh-sharded index and the data-parallel encoder (MiniLM-L6, d
    384, bf16, seeded) on the mesh of :func:`mesh_devices`:
    ``SentenceEncoder(mesh=)`` embeds ``n_docs`` documents into
    ``DeviceKnnIndex(reserved_space=rows, mesh=)`` (4 shards of 2^20 rows:
    each shard's B2 shape is ``main_path``'s), seeded unit rows fill it to
    15/16 (no shard outgrows its slab), 1 % of the keys are removed; an
    unsharded twin on ``cuda:0`` holds the same keys and rows. ``n_queries``
    single text queries (each shard's streaming pass) and one batch of them
    (each shard's tensor-core pass), k 10, on both. Then ``pw.run(mesh=)``
    streams ``engine_docs`` documents through ``DataIndex(BruteForceKnn(
    embedder=SentenceTransformerEmbedder(mesh=)))`` with ``engine_singles``
    single queries and a batch epoch of ``n_queries``. Gates: both per-shard
    regimes and the cross-shard merge launch; hits equal the twin's
    (``topk_agreement`` at 1e-5); the mesh encoder against the
    single-device one at the JAX package's bound; the engine's hits equal
    those of the same pipeline run without a mesh; no mesh is left
    installed after the run. Returns the launch counts of the path."""
    import numpy as np
    import torch.nn.functional as F

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DeviceKnnIndex, SentenceEncoder
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import merge_shard_candidates
    from pathway_tpu_torch.parallel.mesh import active_mesh
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    t_phase = time.perf_counter()
    now = time.perf_counter
    mesh, where = mesh_devices(torch)
    devs = mesh.data_devices()
    cards = sorted(set(devs), key=str)
    dim, k = 384, 10
    rng = np.random.default_rng(SEED + 21)
    docs = _synthetic_texts_bulk(rng, n_docs, 20, 220)
    own = rng.choice(n_docs, n_queries // 2, replace=False)
    queries = [docs[i] for i in own] + _synthetic_texts(rng, n_queries - len(own), 5, 40)

    enc = SentenceEncoder(max_seq_len=256, max_batch=1024, seed=SEED, mesh=mesh)
    solo = SentenceEncoder(max_seq_len=256, max_batch=1024, seed=SEED, device=DEV)
    # gate: the mesh path against the single-device encoder, both through the module path
    toks = [enc.tokenizer.encode(t, enc.max_seq_len) for t in docs[:256]]
    got_e, want_e = enc.encode_tokens(toks), solo.encode_tokens(toks)
    enc_err = float(np.abs(got_e - want_e).max())
    enc_cos = float((got_e * want_e).sum(axis=1).min())
    tol = MESH_ENCODER_TOL
    if not (np.allclose(got_e, want_e, rtol=tol["rtol"], atol=tol["atol"]) and enc_cos > tol["min_cos"]):
        raise AssertionError(f"mesh encoder disagrees with the single-device one: max abs err {enc_err}, "
                             f"min cos {enc_cos}")
    del solo
    for dev in cards:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    _build.reset_launches()
    t0 = now()
    embs = enc.encode_device(docs)
    sync_cards(torch, cards)
    embed_s = now() - t0
    if embs.shape != (n_docs, dim) or not torch.isfinite(embs).all():
        raise AssertionError(f"bad mesh embeddings {tuple(embs.shape)}")
    index = DeviceKnnIndex(dim=dim, metric="cos", reserved_space=rows, mesh=mesh)
    twin = DeviceKnnIndex(dim=dim, metric="cos", reserved_space=rows, device=DEV)
    fill = rows * 15 // 16
    g = torch.Generator(device=DEV).manual_seed(SEED + 22)
    t0 = now()
    for idx in (index, twin):
        idx.add_batch_device(list(range(n_docs)), embs)
    for start in range(n_docs, fill, 1 << 16):
        keys = list(range(start, min(fill, start + (1 << 16))))
        filler = F.normalize(torch.randn(len(keys), dim, device=DEV, generator=g), dim=1)
        for idx in (index, twin):
            idx.add_batch_device(keys, filler)
    sync_cards(torch, cards)
    fill_s = now() - t0
    gone = rng.choice(fill, fill // 100, replace=False).tolist()
    for key in gone:
        index.remove(key)
        twin.remove(key)
    if index.shard_capacity * len(devs) != rows or len(index) != fill - len(gone) or len(twin) != len(index):
        raise AssertionError(f"mesh index holds {len(index)} rows in {len(devs)} x {index.shard_capacity}")

    q_single = [enc.encode_device([text]) for text in queries]
    lat, lat_twin, got, want = [], [], [], []
    stream_before = _build.LAUNCHES["knn_topk_stream"]
    for q1 in q_single:
        t0 = now()
        got += index.search_batch(q1, k)
        lat.append((now() - t0) * 1e3)
        t0 = now()
        want += twin.search_batch(q1, k)
        lat_twin.append((now() - t0) * 1e3)
    # each single query: one streaming pass a shard, one for the twin
    sharded_stream = _build.LAUNCHES["knn_topk_stream"] - stream_before - len(q_single)
    q_batch = enc.encode_device(queries)
    tc_before = _build.LAUNCHES["knn_topk_tc"]
    t0 = now()
    got += index.search_batch(q_batch, k)
    batch_ms = (now() - t0) * 1e3
    sharded_tc = _build.LAUNCHES["knn_topk_tc"] - tc_before
    t0 = now()
    want += twin.search_batch(q_batch, k)
    twin_batch_ms = (now() - t0) * 1e3
    share, ok = _hits_agree(got, want, k)
    if not ok:
        raise AssertionError(f"mesh index hits disagree with the unsharded twin's beyond {HIT_TOL} ({share})")
    self_top1 = float(np.mean([got[i][0][0] == int(own[i]) for i in range(len(own))]))
    sync_cards(torch, cards)
    peak = {str(dev): torch.cuda.max_memory_allocated(dev) for dev in cards}
    del index, twin, embs, q_single, q_batch
    torch.cuda.empty_cache()

    # the engine, as a user runs it on the mesh
    texts = _synthetic_texts_bulk(rng, engine_docs, 20, 220)
    singles = [texts[i] for i in rng.choice(engine_docs, engine_singles, replace=False)]
    batch = _synthetic_texts(rng, n_queries, 5, 40)
    embedder = SentenceTransformerEmbedder(mesh=mesh)
    engine_before = dict(_build.LAUNCHES)
    hits, ingest_s, run_s = _stream_and_query(torch, pw, embedder, texts, singles, batch, MESH_ENGINE_EPOCH,
                                              cards=cards, mesh=mesh)
    sync_cards(torch, cards)
    launches = dict(_build.LAUNCHES)
    left = active_mesh()
    engine_merges = launches.get("knn_topk_sharded_merge", 0) - engine_before.get("knn_topk_sharded_merge", 0)
    # the same pipeline and embedder without a mesh: one unsharded index
    plain_hits, plain_ingest_s, _ = _stream_and_query(torch, pw, embedder, texts, singles, batch, MESH_ENGINE_EPOCH)
    e_share, e_ok = _hits_agree(hits, plain_hits, k)

    t_merge = {}
    for Q in (1, n_queries):
        cand_s = torch.randn(Q, len(devs), 16, device=DEV).sort(dim=2, descending=True).values
        cand_i = torch.randint(0, rows, (Q, len(devs), 16), device=DEV, dtype=torch.int32)
        t_merge[f"q{Q}"] = cuda_ms(lambda: merge_shard_candidates(cand_s, cand_i, 16), reps=50)

    if not e_ok:
        raise AssertionError(f"the engine's mesh hits disagree with the unsharded run's ({e_share})")
    if left is not None:
        raise AssertionError(f"pw.run(mesh=) left {left} installed")
    missing = [key for key in ("knn_topk_stream", "knn_topk_tc", "knn_topk_merge", "knn_topk_sharded_merge",
                               "masked_attention") if launches.get(key, 0) == 0]
    if missing or sharded_stream < len(devs) * len(queries) or sharded_tc < len(devs) or engine_merges == 0:
        raise AssertionError(f"mesh_path never launched {missing} (per-shard streaming passes {sharded_stream}, "
                             f"tensor-core passes {sharded_tc}, {len(devs)} shards; engine merges {engine_merges})")
    result = dict(
        mesh=where, shards=len(devs), cards=len(cards), index_rows=rows, filled=fill, removed=len(gone),
        docs=n_docs, embed_seconds=embed_s, embed_docs_per_s=n_docs / embed_s, fill_seconds=fill_s,
        encoder_vs_single_max_abs_err=enc_err, encoder_vs_single_min_cos=enc_cos,
        query=_percentiles(lat), twin_query=_percentiles(lat_twin), queries=len(queries),
        batch_512_search_ms=batch_ms, twin_batch_512_search_ms=twin_batch_ms, hits_vs_twin_agreement=share,
        self_query_top1=self_top1, cross_shard_merge_ms=t_merge, per_shard_stream_launches=sharded_stream,
        per_shard_tc_launches=sharded_tc, engine_docs=engine_docs, engine_ingest_seconds=ingest_s,
        engine_ingest_docs_per_s=engine_docs / ingest_s, engine_unsharded_ingest_docs_per_s=engine_docs / plain_ingest_s,
        engine_run_seconds=run_s, engine_queries=len(singles) + len(batch), engine_sharded_merges=engine_merges,
        engine_hits_vs_unsharded_agreement=e_share, max_memory_allocated=peak, phase_seconds=now() - t_phase,
        launches=launches,
    )
    emit("mesh_path", **result)
    return launches


# qa_path: the corpus, the questions answered and the retrievals, the
# retriever's k and the reranker's cut
QA_FILES, QA_ANSWERS, QA_RETRIEVE, QA_SEARCH_K, QA_RERANK_K = 1024, 256, 64, 6, 3


def phase_qa_path(torch, n_files: int = QA_FILES, n_answers: int = QA_ANSWERS,
                  n_retrieve: int = QA_RETRIEVE) -> dict:
    """The README's question answerer on the port: ``pw.io.fs.read`` over
    ``n_files`` files of synthetic prose -> ``DocumentStore(
    retriever_factory=BruteForceKnnFactory(embedder=
    SentenceTransformerEmbedder()), splitter=TokenCountSplitter())`` at
    MiniLM-L6 width, each query's ``QA_SEARCH_K`` retrieved docs rescored by a
    ``CrossEncoderReranker`` at cross_encoder_l6 width and cut by
    ``rerank_topk_filter`` to ``QA_RERANK_K`` -> ``BaseRAGQuestionAnswerer``
    whose chat (defined here, deterministic) answers with
    ``rag_evals.extractive_answerer`` over its context -> ``QARestServer``,
    driven over HTTP: ``n_answers`` sequential ``/v1/pw_ai_answer`` (each a
    sentence of one file) and ``n_retrieve`` ``/v1/retrieve``. In the same
    run, a python connector replays every question, one an epoch, through
    ``answer_query`` in process. Gates: each answer and its
    ``context_docs`` equal the replay's; the encoder kernels, B2's streaming
    pass and merge launch; each served rerank call launches the
    cross-encoder's attention (``masked_attention``) once a layer a batch and
    nothing else launches during it; the ``rag_evals`` report over the
    questions is printed."""
    import socket
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.xpacks.llm import rag_evals
    from pathway_tpu_torch.xpacks.llm.llms import BaseChat, _messages_to_plain
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker, rerank_topk_filter
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer

    now = time.perf_counter
    t_phase = now()
    rng = np.random.default_rng(SEED + 31)
    texts = _prose_files(rng, n_files)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    folder = tempfile.mkdtemp(prefix="qa_path_docs_", dir=build_dir)
    paths = [os.path.join(folder, f"doc_{i:05d}.txt") for i in range(n_files)]
    for path, text in zip(paths, texts):
        with open(path, "w") as f:
            f.write(text)
    questions, cases = [], []
    for i in rng.choice(n_files, n_answers, replace=False):
        sentences = [x.strip() for x in texts[i].split(".") if len(x.split()) >= 8]
        q = sentences[int(rng.integers(0, len(sentences)))] + "."
        questions.append(q)
        cases.append(rag_evals.EvalCase(q, paths[i], tuple(sorted(q[:-1].split(), key=len)[-2:])))
    retrieve_q = [questions[int(j)] for j in rng.choice(n_answers, n_retrieve, replace=False)]

    embedder = pw.xpacks.llm.embedders.SentenceTransformerEmbedder(device=DEV)
    embedder._encoder.encode_device(texts[:64], pad_to=64)  # warm-up: first launches, handles
    reranker = CrossEncoderReranker(seed=SEED, device=DEV)
    reranker.__wrapped__(texts[:8], texts[8:16])

    class ExtractiveChat(BaseChat):
        """Answers with the extractive answerer over the context its prompt carries."""

        def __wrapped__(self, messages, **kwargs) -> str:
            asked = json.loads(_messages_to_plain(messages)[-1]["content"])
            return rag_evals.extractive_answerer(asked["question"], asked["context"].split("\n\n"))

        def _accepts_call_arg(self, arg_name: str) -> bool:
            return False

    def qa_prompt(context: str, query: str) -> str:
        return json.dumps({"question": query, "context": context})

    rerank_launches: list = []  # each served rerank call's own launches, and what its forward should launch

    @pw.udf
    def rerank(docs, query: str) -> pw.Json:
        plain = [d.value if isinstance(d, pw.Json) else d for d in (docs.value if isinstance(docs, pw.Json) else docs)]
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        scores = reranker.__wrapped__([str(d["text"]) for d in plain], [query] * len(plain))
        torch.cuda.synchronize()
        own = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items() if v != before.get(k, 0)}
        groups = -(-len(plain) // reranker._scorer.max_batch)
        rerank_launches.append((own, {"masked_attention": reranker._scorer.cfg.num_layers * groups} if groups else {}))
        top, _ = rerank_topk_filter.func(plain, scores, QA_RERANK_K)
        return pw.Json(list(top))

    class RerankedStore:
        """The document store with each query's retrieved docs rescored by
        the cross-encoder and cut to the best ``QA_RERANK_K``."""

        def __init__(self, store):
            self.store = store
            self.RetrieveQuerySchema = store.RetrieveQuerySchema
            self.StatisticsQuerySchema = store.StatisticsQuerySchema
            self.InputsQuerySchema = store.InputsQuerySchema

        def retrieve_query(self, queries):
            hits = self.store.retrieve_query(queries)
            return (queries.select(q=pw.this.query) + hits).select(result=rerank(pw.this.result, pw.this.q))

        def statistics_query(self, queries):
            return self.store.statistics_query(queries)

        def inputs_query(self, queries):
            return self.store.inputs_query(queries)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    def post(path, payload, timeout=300):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    replay_go, replayed = threading.Event(), {}
    replay_done = threading.Event()

    class Replay(pw.io.python.ConnectorSubject):
        def run(self):
            replay_go.wait()
            for q in questions:
                self.next(prompt=q, filters=None, model=None, return_context_docs=True)
                self.commit()
                while q not in replayed:
                    time.sleep(0.001)
            replay_done.set()

    runners = []
    real_init = GraphRunner.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    pw.clear_graph()
    docs = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    store = pw.xpacks.llm.DocumentStore(
        docs, retriever_factory=pw.indexing.BruteForceKnnFactory(embedder=embedder),
        splitter=pw.xpacks.llm.splitters.TokenCountSplitter())
    rag = BaseRAGQuestionAnswerer(ExtractiveChat(), RerankedStore(store), prompt_template=qa_prompt,
                                  search_topk=QA_SEARCH_K)
    server = QARestServer("127.0.0.1", port, rag)
    replay_q = pw.io.python.read(Replay(), schema=rag.AnswerQuerySchema, autocommit_duration_ms=None)
    pw.io.subscribe(replay_q.select(prompt=pw.this.prompt) + rag.answer_query(replay_q),
                    lambda key, row, time, is_addition: is_addition and replayed.__setitem__(
                        row["prompt"], json.loads(json.dumps(row["result"].value, default=float))))
    GraphRunner.__init__ = recording_init
    result: dict = {}
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t_run = now()
        run = server.run(threaded=True)
        deadline = now() + 600
        while True:
            try:
                if post("/v1/statistics", {})["file_count"] == n_files:
                    break
            except OSError:  # the endpoint is not up yet
                pass
            if now() > deadline:
                raise TimeoutError("the QA server never indexed every file")
            time.sleep(0.2)
        ingest_s = now() - t_run
        answers, lat = {}, []
        t0 = now()
        for q in questions:
            t1 = now()
            answers[q] = post("/v1/pw_ai_answer", {"prompt": q, "return_context_docs": True})
            lat.append((now() - t1) * 1e3)
        answer_s = now() - t0
        retrieved, rlat = [], []
        for q in retrieve_q:
            t1 = now()
            retrieved.append(post("/v1/retrieve", {"query": q, "k": QA_SEARCH_K}))
            rlat.append((now() - t1) * 1e3)
        replay_go.set()
        if not replay_done.wait(timeout=600):
            raise TimeoutError(f"the in-process replay answered {len(replayed)} of {len(questions)} questions")
        result.update(files=n_files, ingest_seconds=ingest_s, answers=len(answers), answers_per_s=len(answers) / answer_s,
                      pw_ai_answer=_percentiles(lat), retrieve=_percentiles(rlat), retrievals=len(retrieved))
    finally:
        if runners:
            runners[-1].engine.stop()
        GraphRunner.__init__ = real_init
    run.join(timeout=120)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    pw.clear_graph()
    shutil.rmtree(folder)
    if run.is_alive():
        raise AssertionError("the served run did not end after the engine stopped")

    # ---- gates, outside the counted run
    missing = [key for key in ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention", "knn_topk_stream",
                               "knn_topk_merge") if launches.get(key, 0) == 0]
    if missing:
        raise AssertionError(f"qa_path never launched {missing}")
    # the cross-encoder's attention: each served rerank call launched B3 once a
    # layer a batch, and nothing else launched while it ran
    if not rerank_launches or any(own != want for own, want in rerank_launches):
        bad = next((r for r in rerank_launches if r[0] != r[1]), None)
        raise AssertionError(f"{len(rerank_launches)} rerank calls; a call's own launches against its forward's: {bad}")
    if sum(own.get("masked_attention", 0) for own, _ in rerank_launches) == 0:
        raise AssertionError("the cross-encoder's attention never launched")
    differ = 0
    for q in questions:
        got, want = answers[q], replayed[q]
        same_docs = [(d["text"], d["metadata"]["path"]) for d in got["context_docs"]] == [
            (d["text"], d["metadata"]["path"]) for d in want["context_docs"]]
        differ += not (got["response"] == want["response"] and same_docs
                       and len(got["context_docs"]) == QA_RERANK_K)
    if differ:
        raise AssertionError(f"{differ} of {len(questions)} served answers differ from the in-process replay")
    if any(len(r) != QA_RERANK_K for r in retrieved):
        raise AssertionError("a /v1/retrieve answer did not hold the reranker's cut")
    report = rag_evals.EvalReport(k=QA_RERANK_K)
    for case in cases:
        docs_ = answers[case.question]["context_docs"]
        files = [d["metadata"]["path"] for d in docs_]
        rank = next((i + 1 for i, f in enumerate(files) if case.expected_file in f), None)
        answer = answers[case.question]["response"]
        report.outcomes.append(rag_evals.CaseOutcome(case, files, rank, answer,
                                                     rag_evals._coverage(answer, case.answer_terms)))
    result.update(rag_evals=report.as_dict() | {"misses": len(report.as_dict()["misses"])},
                  replay_equal=len(questions), rerank_calls=len(rerank_launches),
                  rerank_attention_launches=sum(own.get("masked_attention", 0) for own, _ in rerank_launches),
                  phase_seconds=now() - t_phase, launches=launches)
    emit("qa_path", **result)
    return launches


def main(argv: list[str]) -> int:
    global ALT_TREE
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 2
    if argv[:1] not in ([], ["--kernels"]) or len(argv) > 2:
        print("usage: chip_smoke.py [--kernels [TREE]]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["--kernels"] and len(argv) == 2:  # the port of another checkout (A/B of two versions)
        ALT_TREE = True
        sys.path.insert(0, os.path.abspath(argv[1]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    env = phase_env(torch)
    phase_build()
    entries = phase_kernels(torch)
    if argv:
        for e in entries:
            e.pop("kernel_key")
        print(env["nvidia_smi"])
        print(json.dumps({"kernels": entries}))
        return 0
    phase_tie_helper(torch, torch.Generator(device=DEV).manual_seed(SEED + 4))
    launches = collections.Counter(phase_main_path(torch))
    rag_launches, cross = phase_rag_path(torch)
    launches.update(rag_launches)
    launches.update(phase_decode_path(torch, cross))
    launches.update(phase_engine_path(torch))
    launches.update(phase_server_path(torch))
    launches.update(phase_mesh_path(torch))
    launches.update(phase_decode_ext_path(torch))
    launches.update(phase_qa_path(torch))
    for e in entries:  # launches summed over the eight paths' counted runs
        e["launches"] = launches.get(e.pop("kernel_key"), 0)
    emit("done", seconds=time.perf_counter() - t_start)
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
