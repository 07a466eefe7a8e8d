"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python chip_smoke.py

Builds the port's kernels from ``pathway_tpu_torch/csrc`` with nvcc, holds
every kernel against its plain PyTorch version at the main path's shapes
(with times, bounds and a PyTorch yardstick), then runs the main path at
MiniLM-L6 width: 16,384 synthetic documents -> ``SentenceEncoder.encode_device``
-> ``DeviceKnnIndex.add_batch_device`` (filled to 1,048,576 rows) -> text
queries -> ``search_batch`` / ``search_texts_batch``. Each phase prints one
JSON line. The last three lines are the card's name and power limit, the
``kernels`` line and ``{"ok": true, ...}``. Any failure exits non-zero;
with no CUDA device it exits 2 and prints no result. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores
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

    dev = torch.device("cuda")
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

    for tag, xin, wk, bk, act in (("qkv", tokens, "attention.qkv.weight", "attention.qkv.bias", False),
                                  ("mlp_in", h1b, "mlp_in.weight", "mlp_in.bias", True)):
        ww, bb = w[wk], lp[bk]
        n, k = ww.shape
        name = f"gemm_bias_act[{tag}]"
        err = held(name, fl.gemm_bias_act(xin, ww, bb, act), fl.gemm_bias_act_reference(xin, ww, bb, act), **BF16_TOL)
        bb16 = bb.bfloat16()
        lib = (lambda: F.gelu(F.linear(xin, ww, bb16), approximate="tanh")) if act else (lambda: F.linear(xin, ww, bb16))
        entries.append(_entry(
            name, src_gemm, b1, "gemm_bias_act", err,
            cuda_ms(lambda: fl.gemm_bias_act(xin, ww, bb, act)),
            cuda_ms(lambda: fl.gemm_bias_act_reference(xin, ww, bb, act), reps=3),
            2.0 * M * n * k, 2 * M * k + 2 * n * k + 4 * n + 2 * M * n, PEAK_BF16, cuda_ms(lib),
            shape=[M, k, n],
        ))

    for tag, xin, wk, bk, res, lnk, out_f32 in (
        ("out_ln1", ctx, "attention.out.weight", "attention.out.bias", tokens, "ln_att", True),
        ("mlp_out_ln2", mid, "mlp_out.weight", "mlp_out.bias", h1, "ln_mlp", False),
    ):
        ww, bb, gam, bet = w[wk], lp[bk], lp[lnk + ".weight"], lp[lnk + ".bias"]
        n, k = ww.shape
        kern = lambda: fl.gemm_bias_residual_layernorm(xin, ww, bb, res, gam, bet, eps, out_f32=out_f32)  # noqa: E731
        plain = lambda: fl.gemm_bias_residual_layernorm_reference(xin, ww, bb, res, gam, bet, eps, out_f32=out_f32)  # noqa: E731
        name = f"gemm_bias_residual_layernorm[{tag}]"
        (gf, gb), (pf, pb) = kern(), plain()
        err = held(name, gb, pb, **BF16_TOL)
        if out_f32:
            err = max(err, held(name + " f32", gf, pf, **F32_TOL))
        bb16 = bb.bfloat16()
        lib = lambda: F.layer_norm((res + F.linear(xin, ww, bb16)).float(), (n,), gam, bet, eps)  # noqa: E731
        out_bytes = M * n * (6 if out_f32 else 2)
        entries.append(_entry(
            name, src_gemm, b1, "gemm_bias_residual_layernorm", err,
            cuda_ms(kern), cuda_ms(plain, reps=3), 2.0 * M * n * k,
            2 * M * k + 2 * n * k + 12 * n + res.element_size() * M * n + out_bytes, PEAK_BF16, cuda_ms(lib),
            shape=[M, k, n],
        ))

    def attention_entry(name, replaces, qkv3, key_mask, zero_empty):
        """Every query row is held, padded ones and those of sequences
        with no live key included: B1 (``zero_empty``) writes zeros there,
        B3 averages V uniformly."""
        b_, s_ = key_mask.shape
        got = masked_attention(qkv3, key_mask, h, zero_empty)
        err = held(name, got, masked_attention_reference(qkv3, key_mask, h, zero_empty), **BF16_TOL)
        empty = ~key_mask.any(dim=1)
        if zero_empty and not (got[empty] == 0).all():
            raise AssertionError(f"{name}: a sequence with no live key must give zeros")
        if not zero_empty:
            uniform = qkv3[empty][:, :, 2 * d:].float().mean(dim=1, keepdim=True).expand(-1, s_, -1)
            held(name + " fully masked rows vs mean of V", got[empty], uniform, **BF16_TOL)
        kl = key_mask.sum(dim=1).double()
        flops = 4.0 * h * hd * float((kl**2).sum())
        nbytes = 2 * 3 * d * s_ * float((kl > 0).sum()) + b_ * s_ + 2 * b_ * s_ * d
        q_, k_, v_ = (t.view(b_, s_, h, hd).transpose(1, 2) for t in qkv3.split(d, dim=-1))
        q_, k_, v_ = q_.contiguous(), k_.contiguous(), v_.contiguous()
        amask = key_mask[:, None, None, :]
        return _entry(
            name, src_attn, replaces, "masked_attention", err,
            cuda_ms(lambda: masked_attention(qkv3, key_mask, h, zero_empty)),
            cuda_ms(lambda: masked_attention_reference(qkv3, key_mask, h, zero_empty), reps=3),
            flops, nbytes, PEAK_BF16,
            cuda_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=amask)),
            shape=[b_, s_, 3 * d],
        )

    entries.append(attention_entry("masked_attention[B1 layer]", b1, qkv.view(-1, S, 3 * d), mask, True))

    # ---- B3: qkv [256, 128, 1152] bf16, one fully masked row
    qkv3 = torch.randn(256, 128, 3 * d, device=dev, generator=g).bfloat16()
    kl3 = torch.randint(64, 129, (256,), device=dev, generator=g)
    kl3[7] = 0
    km3 = torch.arange(128, device=dev)[None, :] < kl3[:, None]
    entries.append(attention_entry("masked_attention[B3]", "pathway_tpu/ops/fused_attention.py:117", qkv3, km3, False))

    # ---- B2: q = 256 against 1,048,576 x 384 f32 docs, 10% dead slots
    N, Q = 1 << 20, 256
    docs = F.normalize(torch.randn(N, d, device=dev, generator=g), dim=1)
    valid = torch.rand(N, device=dev, generator=g) >= 0.1
    queries = F.normalize(torch.randn(Q, d, device=dev, generator=g), dim=1)
    for metric in ("cos", "l2"):
        bias = _pallas_bias(metric, docs, valid)
        factor = 2.0 if metric == "l2" else 1.0
        for k in (16, 64):
            vk, ik = knn_topk(queries, docs, k=k, bias=bias, factor=factor)
            vp, ip = knn_topk_reference(queries, docs, k=k, bias=bias, factor=factor)
            share, ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
            if not ok:
                raise AssertionError(f"knn_topk {metric} k={k} disagrees with its plain version ({share})")
            lib = lambda: torch.topk(torch.addmm(bias, queries, docs.T, alpha=factor), k, dim=1)  # noqa: E731
            entries.append(_entry(
                f"knn_topk[{metric},k={k}]", "pathway_tpu_torch/csrc/knn_topk.cu",
                "pathway_tpu/ops/pallas_knn.py:113", "knn_topk_partial",
                (vk - vp).abs().max().item(),
                cuda_ms(lambda: knn_topk(queries, docs, k=k, bias=bias, factor=factor), reps=5),
                cuda_ms(lambda: knn_topk_reference(queries, docs, k=k, bias=bias, factor=factor), reps=2, warmup=1),
                2.0 * Q * N * d, 4 * N * d + 4 * N + 4 * Q * d + 8 * Q * k, PEAK_F32, cuda_ms(lib, reps=5),
                index_agreement=share, shape=[Q, N, d],
            ))
    del docs, valid, queries
    torch.cuda.empty_cache()
    return entries


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


def phase_main_path(torch) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch import DeviceKnnIndex, SentenceEncoder
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import knn_topk_reference, topk_agreement

    dev = torch.device("cuda")
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
    needed = ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention", "knn_topk_partial", "knn_topk_merge")
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


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    env = phase_env(torch)
    phase_build()
    entries = phase_kernels(torch)
    launches = phase_main_path(torch)
    for e in entries:
        e["launches"] = launches.get(e.pop("kernel_key"), 0)
    emit("done", seconds=time.perf_counter() - t_start)
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
