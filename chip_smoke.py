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
rows on the mesh below, and at 1, 16 and 256 queries over ``elastic_path``'s
2-shard generation; B2 at d 512, CLIP's width, at 1, 16 and 256 queries;
B2 at d 784, the KNN classifier's MNIST width, l2 k 3 over the 63,000-row
train split of ``load_mnist_sample(70000, synthetic=True)`` at 1, 16 and
256 of its test images, each row naming the partial pass ``launch_plan``
chose; attention at S 8192, the ring's one-card shape), times the index's
tie-ordered top-k beside ``torch.topk``, then drives twenty-two paths, each
with the launch counters set to 0 just before it and read just after:

* ``main_path`` (MiniLM-L6): 16,384 synthetic documents ->
  ``SentenceEncoder.encode_device`` -> ``DeviceKnnIndex.add_batch_device``
  (filled to 1,048,576 rows) -> text queries -> ``search_batch`` /
  ``search_texts_batch`` (single queries take B2's streaming pass, the
  batch of 512 its tensor-core pass; both must launch);
* ``analysis_path``: the pre-run verifier on the card. 4,096 documents
  through ``pw.io.python.read`` -> ``SentenceTransformerEmbedder``
  (MiniLM-L6, B1) -> ``pw.ml.KNNIndex`` (cos, 2^20 reserved rows, B2) <- 16
  queries, run under ``pw.run(analysis="deep")`` and again with
  ``analysis="off"``, gated on equal hits (ids exact away from near-ties,
  scores 1e-5); every deep target of that graph (B2 at 2^20 x 384, q 16)
  and a decode target at ``decode_path``'s pool (B5: 8 lanes, 512 pages x
  16, head dim 64) run once under ``torch.cuda.set_sync_debug_mode("error")``,
  gated on the verifier's PWL017 verdict (its op trace on ``meta``) equal
  to the card's, each kernel launching and agreeing with its plain version
  (``topk_agreement`` 1e-5, f32 1e-4); the torch host-sync fixture's
  staging UDF raising there and drawing PWL017; the MiniLM-L6
  ``SentenceEncoder`` dispatching exactly ``predict_compile_keys``' (rows,
  seq) geometries over the CPU tests' length sweep; PWL010 firing at the
  card's memory, not at 16 GiB; ``python -m pathway_tpu_torch analyze``
  over the demos (exit 0) and a positive fixture (exit 1 under
  ``--fail-on=warn``);
* ``train_path`` (MiniLM-L6, full width): ``ContrastiveTrainer`` on
  ``cuda:0``, 128 pairs at S 128 (live lengths 16-128), 3 warm-up steps,
  20 timed ``step()`` calls, 4 split into forward, backward and AdamW and
  one profiled;
  B3 in every layer of both towers (exactly 12 launches a step, nothing
  else), attention's backward recomputed in plain PyTorch; gated on the
  loss falling, the first step's gradients against an all-plain trainer's,
  a dp 1 x tp 2 step on ``[[cuda:0, cuda:0]]`` against the unsharded loss
  and the B4 and ``encoder_forward`` Functions' gradients; reports step
  p50 / p99, pairs/s, tokens/s, the backward's share, achieved TFLOP/s
  against 989 and peak memory;
* ``clip_path``: ``CLIPEncoder`` at full ViT-B/32 width (bf16, seeded) on
  ``cuda:0``: 4,096 uint8 224 x 224 images through both wires (rgb,
  yuv420), through the collaborative ingest stage and through
  ``encode_image_device`` into a ``DeviceKnnIndex(dim=512)`` filled to
  2^20 rows; ``encode_text`` queries at 1, 16 and 256, k 16; gated on the
  yuv420 wire within cosine 0.99 of the rgb one, the stage's output
  byte-identical to the inline one, ``encode_image_device`` equal to
  ``encode_image``, every image retrieving its own row first, B2 at d 512
  against its plain version and B2 launching;
* ``ring_path``: ``ring_encode`` at MiniLM-L6 width (max_position 8192)
  over 4 shards pooled on ``cuda:0``, two documents of S 8192 (one
  ragged), against the same weights' one-card ``TextEncoder`` forward
  (B3 at S 8192, head dim 32) at cosine 0.999; B3 on that forward's qkv
  against its plain version; B3 launching;
* ``http_path``: a local server streams 16,384 documents as
  newline-delimited JSON over chunked transfer, cut once at half and
  resumed on the reconnect -> ``pw.io.http.read(stream=True)`` ->
  ``SentenceTransformerEmbedder`` (B1) -> ``pw.ml.KNNIndex`` (B2) <- 256
  queries from ``pw.io.python.read`` -> ``pw.io.http.write`` POSTing each
  answer to a second local endpoint; gated on every document delivered
  once, every answer POSTed once, hits equal to a ``pw.io.python.read``
  twin's fed the same epochs (ids exact, scores 1e-5), B1 and B2
  launching;
* ``kafka_path``: a Debezium change stream into a live index. A
  ``confluent_kafka`` stand-in (an in-process broker in this script, put in
  ``sys.modules``) carries topic ``pg.public.docs`` (4 partitions, keyed by
  document id): 32,768 ``op: r`` snapshot rows, 8,192 ``op: u`` updates,
  4,096 ``op: d`` deletes -> ``pw.io.debezium.read`` (the connector's own
  confluent branch) -> ``SentenceTransformerEmbedder`` (MiniLM-L6, B1;
  ``http_path``'s) -> ``pw.ml.KNNIndex`` (B2, freed slots taken again) <-
  queries from topic ``queries`` through ``pw.io.kafka.read`` (2 single
  queries after each phase, then 256 in one epoch) -> ``pw.io.kafka.write``
  to topic ``answers``; gated on both readers subscribing and polling,
  exactly the 28,672 live keys in the index, no answer naming a key
  deleted in an earlier epoch, every updated row first for its new text,
  the burst equal to a ``DeviceKnnIndex`` built directly from the final
  rows (ids exact, scores 1e-5), every query answered once on ``answers``,
  B1 and both B2 passes launching. The rows carry a ``category`` (16
  labels) and an ``updated_at`` (seconds of the envelope's ``ts_ms``: the
  snapshot over 64 one-minute windows, the updates in later ones); two more
  outputs on the same table, each subscribed: a one-minute tumbling
  ``windowby`` counting rows per window and ``pw.sql("SELECT category,
  COUNT(*) AS n FROM docs GROUP BY category")``, each gated on its final
  state equal, exactly, to a plain count of the live rows; and the KNN
  classifier: ``pw.ml.classifiers.knn_lsh_classifier_train`` over the
  embedded rows (``label`` their category; its defaults, so an l2 index of
  its own, B2) and ``knn_lsh_classify(k=3)`` of every query, live through
  the three phases, gated on the classifier's index ending with exactly
  the live keys and every final label equal to a plain majority vote over
  the top 3 of an l2 ``DeviceKnnIndex`` built directly from the final rows
  (f32 near-ties counted, not gated), its seconds and B2 launches reported;
* ``s3_path``: an S3 prefix kept live in the index across a restart. A
  ``boto3`` stand-in (an in-process bucket in this script, put in
  ``sys.modules``; pages of 1,000 keys, ETags the MD5 of each body) holds
  16,384 objects of 20-220 words under ``s3://docs/corpus/`` ->
  ``pw.io.s3.read(format="plaintext_by_file", with_metadata=True,
  mode="streaming", persistent_id=, object_cache=)`` (the connector's own
  ``AwsS3Settings.create_client()`` branch) under a filesystem persistence
  backend -> ``SentenceTransformerEmbedder`` (MiniLM-L6, B1;
  ``http_path``'s) -> ``pw.ml.KNNIndex`` (B2) <- queries from
  ``pw.io.python.read`` (16 single queries after each phase, then 256 in
  one epoch); (a) the snapshot scan, (b) 2,048 objects rewritten, 1,024
  deleted and 1,024 added between two scans, (c) the run stopped, 512 added
  and 512 rewritten while it is down, and restarted on the same
  persistence and object cache; gated on exactly the live keys in the index
  after each phase, no answer naming an object deleted before its query,
  every rewritten object first for its new text, each phase's GETs exactly
  the objects it changed (1,024 on the restart), the burst equal to a
  ``DeviceKnnIndex`` built directly from the final objects (ids exact,
  scores 1e-5), B1 and both B2 passes launching;
* ``rag_path``: ``FusedRagPipeline`` over MiniLM-L6 and a cross_encoder_l6
  reranker: 16 long-tailed epochs of 1,024 chunks through the segment
  packer (kernel B4), 512 single queries, one batch of 512, and
  ``answer_batch`` of 64 with the default decoder;
* ``decode_path``: ``DecodeEngine`` (kernel B5: its split and combine
  kernels must both launch) serving 64 prompts with continuous batching,
  each arrival preceded by a ``DeviceReranker.order``;
* ``engine_path``: the dataflow engine as a user drives it, ``import
  pathway_tpu_torch as pw``: 65,536 documents streamed through
  ``pw.io.python.read`` (64 epochs of 1,024) -> ``DataIndex(BruteForceKnn(
  embedder=SentenceTransformerEmbedder()))`` -> 512 single text queries
  and one epoch of 512 through ``query_as_of_now`` -> ``pw.io.subscribe`` ->
  ``pw.run``; gated on the kernels' launches, ``add_batch_device`` carrying
  every ingest epoch, hits equal to the library path's, and a KNNIndex's
  neighbour sets equal on 1 and 4 engine workers;
* ``server_path``: the README's RAG document server as written, on the
  port: 2,048 files of synthetic prose (about 5,500 chunks) ->
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
  installed after the run;
* ``decode_ext_path``: ``pw.run(decode=)`` -> ``DecodeService`` in every
  decode extension (greedy, cache + chunks, two speculative drafts,
  sampled), streams held to greedy's;
* ``qa_path``: the question answerer (``QARestServer`` over 1,024 files, a
  cross-encoder cut), answers held to an in-process replay;
* ``observe_path``: the question answerer behind ``serving=`` under
  ``pw.run(tracing=True, chip_ledger=True, freshness=True, watchdog=True,
  with_http_server=True, monitoring_http_port=0)`` against a planes-off
  twin (off, on, on, off), with an overload burst and a ``DecodeService``
  burst; gated on equal answers, the ledger's accounts and its bookings
  against a profiled window, the traces, the sheds, the scrape and the
  freshness plane against polling.
* ``profile_phase`` (after ``engine_path``): its pipeline over 16,384
  streamed documents under ``pw.run(profile=, chip_ledger=True)`` with
  ``PATHWAY_JOURNAL_DIR`` set; gated on the Chrome trace's operator
  self-times (connector, embedder UDF, index), the encoder's kernel
  statistics and encode MFU, and ``python -m pathway_tpu_torch top --once``
  and ``perf snapshot`` on the journal;
* ``tenant_path``: a ``TenantPackedIndex`` of 4,096 tenants x 256
  documents (2^20 rows, f32); 512 single queries and 128 batches of 64
  over 256 tenants (B2's two regimes under the tenant mask), each hit
  checked against its tenant's rows and, for 64 tenants, a private
  ``DeviceKnnIndex``; a demotion sweep and the demoted tenants' host scans
  and promotions; ``rest_connector(serving=)`` under ``pw.run(tenancy=)``
  with weights 1 / 2 / 4 and a capped tenant (typed 429s, every other
  answer equal to a library replay); ``index.tenant`` against
  ``index.hot``;
* ``tier_path``: a ``TieredKnnIndex`` of 2^20 documents round 256 Gaussian
  centres (int8 cold tier on the host, 2^17 hot rows, 16 of 256 clusters
  probed), Zipf-skewed single and batched queries, a demote and promote
  cycle, every cold rescore held against the same rows copied afresh
  (the staging ring), recall@10 against an exact f32 scan, 4,096
  self-queries, the int8 recall floor under forced demotion, and an
  all-hot twin equal to ``DeviceKnnIndex.search_batch``;
* ``recovery_path``: persistence, recovery and the overlapped epoch
  pipeline at ``engine_path``'s width. A live index of 65,536 streamed
  documents under ``persistence_config`` (snapshots every 2 s) in child
  processes: run A uninterrupted, run B SIGKILLed past 32,768 delivered
  documents, run C restarted on B's root (the index rebuilt on the card
  from the operator snapshot: B1 re-embeds, the device add re-adds),
  gated on every document delivered once across B and C, C's 256 answers
  and index rows against A's, C's restore launching B1 and its queries B2,
  and the snapshot unpickling with the card hidden; time to recover split
  into its parts. Then an in-process restart under ``pw.run(recovery=2)``
  through a chaos raise at ``engine.after_sink_flush`` (output equal to an
  unkilled twin's, one supervisor restart on ``/metrics``, one index on the
  card after it), the epoch pipeline at depth 1, 2, 1, 2 and depth 2 with
  four ingest workers (byte-identical sink output; docs/s, host prep,
  device wait by CUDA events and by wall minus thread time, overlap), and
  the decode step killed at ``decode.step`` and retried in greedy, sampled
  and prompt-lookup speculative mode (streams equal to an unkilled twin's,
  B5 launching).
* ``elastic_path``: the elastic reshard plane. A ``DeviceKnnIndex`` of
  2^20 seeded rows (d 384, cos, added on the card, 10 % removed)
  registered with ``pw.elastic`` and resharded live 1 -> 2 -> 4 -> 2 (one
  shard a card on four or more cards; 1 -> 2 -> 1 on two; on one card the
  device pool of ``parallel/mesh.py`` holds ``mesh_devices``' four shards
  on ``cuda:0``) while a reader sends single queries and a batch of 256
  probes at every chunk boundary and a writer adds and removes 64-row
  batches through the handle; gated on every read served, every row of the
  new generation equal to the old's byte for byte, the old slabs released,
  a write through the old generation raising ``StaleGeneration``, B2 / B2s
  at each generation against the plain top-k over the whole slab, and the
  probes answering as before any reshard. Then a ``TieredKnnIndex`` (2^18
  rows, 2^15 hot, int8 cold) and a ``TenantPackedIndex`` (1,024 tenants x
  256 rows) resharded 1 -> 2 -> 1 (membership, extents and answers
  unchanged), and in child processes a ``pw.run(mesh="auto", elastic=)``
  run whose controller grows the index it embeds 16,384 documents into
  (B1) on its HBM watermark (``/metrics`` scraped) and a reshard of 2^18
  rows SIGKILLed at ``elastic.migrate_chunk`` and completed on restart by
  ``recover_pending_reshard`` (answers equal to an unkilled twin's).
* ``cluster_path``: the multi-process cluster. One user program spawned
  through ``python -m pathway_tpu_torch spawn --processes P``: 16,384
  documents through ``pw.io.python.read`` on process 0 (persisted, a commit
  of 1,024), keyed by id through a groupby that exchanges them by key
  shard, embedded by ``SentenceTransformerEmbedder`` (MiniLM-L6, B1) in
  the process that owns each key, into a ``DeviceKnnIndex`` (cos) on
  process 0 registered with ``pw.elastic`` and a jsonlines sink, then 512
  queries at k 10 (B2). Run A in one process, run B in two (process 0
  reshards the index 1 -> 2 at half the documents), run C in two with
  worker 1 SIGKILLed at a third and respawned alone; gated on every
  document delivered once, B's and C's answers against A's, B1 launching in
  every process, B2 on process 0, the generation ``/status`` shows going
  0 -> 1 at B's cutover, and one partial restart in C (generation 0 -> 1);
  reports docs/s, each process's B1 launches and device ms,
  ``cluster_detection_latency_ms`` and ``cluster_mttr_ms``.

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
import functools
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


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


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
        library_ms=encoder_layer_library_ms(torch, 1, d, h, ffn, eps, tokens, lens, S),
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
        if not zero_empty and empty.any():
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
    # train_path's shape: TRAIN_PAIRS sequences at S TRAIN_SEQ, live lengths from TRAIN_MIN_LEN
    g_train = torch.Generator(device=dev).manual_seed(SEED + 17)
    kl_t = torch.randint(TRAIN_MIN_LEN, TRAIN_SEQ + 1, (TRAIN_PAIRS,), device=dev, generator=g_train)
    km_t = torch.arange(TRAIN_SEQ, device=dev)[None, :] < kl_t[:, None]
    qkv_t = torch.randn(TRAIN_PAIRS, TRAIN_SEQ, 3 * d, device=dev, generator=g_train).bfloat16()
    entries.append(attention_entry("masked_attention[train]", "pathway_tpu/ops/fused_attention.py:117", qkv_t, km_t,
                                   False))
    del qkv_t
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
    # ring_path's one-card forward: RING_BATCH documents of S 8192 at MiniLM's heads (12 of 32), one ragged
    qkv_r = torch.randn(RING_BATCH, RING_SEQ, 3 * d, device=dev, generator=g).bfloat16()
    km_r = torch.ones(RING_BATCH, RING_SEQ, dtype=torch.bool, device=dev)
    km_r[1, int(RING_SEQ * RING_RAGGED) :] = False
    try:
        entries.append(attention_entry(f"masked_attention[S{RING_SEQ}]", "pathway_tpu/ops/fused_attention.py:117",
                                       qkv_r, km_r, False))
    except ValueError:
        if not ALT_TREE:
            raise
        emit("kernel_skipped", name=f"masked_attention[S{RING_SEQ}]", reason="the other tree's kernel does not take it")
    del qkv_r
    torch.cuda.empty_cache()
    phase_b1_layer(torch, g, "hd64", 768, 12, 3072)
    # public small widths that run zero-padded: bert-tiny (LayerNorm 128 -> 256) and TinyBERT-4L-312
    # (LayerNorm 312 -> 384, 12 heads of 26 -> 32)
    phase_b1_layer(torch, g, "d128", 128, 2, 512)
    phase_b1_layer(torch, g, "d312", 312, 12, 1200)

    entries.extend(knn_entries(torch, g, d))
    entries.extend(knn_entries(torch, g, CLIP_DIM, cases=tuple((q, "cos", CLIP_K) for q in CLIP_QUERY_SIZES)))
    entries.extend(mnist_entries(torch, g))
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


MNIST_SAMPLE = 70_000  # load_mnist_sample's default sample: a 63,000-row train split, 7,000 test images
MNIST_DIM = 784  # the classifier's documented workload, 28 x 28 pixels
MNIST_K = 3  # knn_lsh_classify's default k
MNIST_QUERY_SIZES = (1, 16, 256)  # B2's streaming pass (2 ring stages at this width), then its tensor cores
KNN_CASES = ((1, "cos", 16), (1, "cos", 64), (1, "l2", 16), (16, "cos", 16),
             (256, "cos", 16), (256, "cos", 64), (256, "l2", 16), (256, "l2", 64))  # (queries, metric, k)


def knn_entries(torch, g, d: int, N: int = 1 << 20, cases=KNN_CASES, data=None) -> list[dict]:
    """B2 against ``N`` (1,048,576) x ``d`` f32 docs with 10 % dead slots, at the
    main path's shapes: one query (the index's single-query search, the
    streaming kernel), 16 (the regime boundary, where the other partial pass
    is timed beside it when it can hold the width) and 256 (batch search,
    the tensor-core kernel). A width other than MiniLM's 384 names itself in
    the rows (``,d=512``: ``clip_path``'s image index). ``data`` = (docs,
    queries) on the card replaces the seeded unit vectors, every doc live
    (the MNIST rows). Each row names the partial pass ``launch_plan`` chose."""
    import inspect

    import torch.nn.functional as F

    from pathway_tpu_torch.ops.knn import _pallas_bias
    from pathway_tpu_torch.ops.knn_topk import knn_topk, knn_topk_reference, launch_plan, topk_agreement

    forced = "regime" in inspect.signature(knn_topk).parameters  # an older tree has one regime
    if data is None:
        docs = F.normalize(torch.randn(N, d, device=DEV, generator=g), dim=1)
        valid = torch.rand(N, device=DEV, generator=g) >= 0.1
        queries = F.normalize(torch.randn(256, d, device=DEV, generator=g), dim=1)
    else:
        docs, queries = data
        N = docs.shape[0]
        valid = torch.ones(N, dtype=torch.bool, device=DEV)
    sms = torch.cuda.get_device_properties(docs.device).multi_processor_count
    entries = []
    width = "" if d == 384 else f",d={d}"
    for Q, metric, k in cases:
        q = queries[:Q].contiguous()
        bias = _pallas_bias(metric, docs, valid)
        factor = 2.0 if metric == "l2" else 1.0
        vk, ik = knn_topk(q, docs, k=k, bias=bias, factor=factor)
        vp, ip = knn_topk_reference(q, docs, k=k, bias=bias, factor=factor)
        share, ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
        if not ok:
            raise AssertionError(f"knn_topk {metric} k={k} q={Q}{width} disagrees with its plain version ({share})")
        plan = launch_plan(Q, N, sms, dim=d)
        single = Q <= 16
        reps = 20 if single else 5
        lib = lambda: torch.topk(torch.addmm(bias, q, docs.T, alpha=factor), k, dim=1)  # noqa: E731
        flops, nbytes = 2.0 * Q * N * d, 4 * N * d + 4 * N + 4 * Q * d + 8 * Q * k
        extra = {"regime": plan.regime, "splits": plan.splits, "stages": plan.stages}
        if Q == 16 and forced:  # the other partial pass at the boundary, where it holds this width
            alt = "tc" if plan.regime == "stream" else "stream"
            try:
                launch_plan(Q, N, sms, dim=d, regime=alt)
            except ValueError as exc:
                extra[f"{alt}_regime"] = str(exc)
            else:
                other = lambda: knn_topk(q, docs, k=k, bias=bias, factor=factor, regime=alt)  # noqa: E731
                vo, io = other()
                if not topk_agreement(vo, io, vp, ip, atol=1e-5, rtol=1e-5)[1]:
                    raise AssertionError(f"knn_topk's {alt} pass at q 16{width} disagrees with the plain version")
                extra[f"{alt}_regime_ms"] = cuda_ms(other, reps=reps)
        if plan.regime == "tc":  # the tensor cores' bound: bytes, or 3 TF32 products per f32 one at 495 TF/s
            extra["bound_3xtf32_ms"] = max(nbytes / HBM_BYTES, 3 * flops / PEAK_TF32) * 1e3
        entries.append(_entry(
            f"knn_topk[{metric},k={k}{width}]" if Q == 256 else f"knn_topk[{metric},k={k},q={Q}{width}]",
            "pathway_tpu_torch/csrc/knn_topk.cu", "pathway_tpu/ops/pallas_knn.py:113",
            f"knn_topk_{plan.regime}", (vk - vp).abs().max().item(),
            cuda_ms(lambda: knn_topk(q, docs, k=k, bias=bias, factor=factor), reps=reps),
            cuda_ms(lambda: knn_topk_reference(q, docs, k=k, bias=bias, factor=factor), reps=2, warmup=1),
            flops, nbytes, PEAK_F32, cuda_ms(lib, reps=reps), index_agreement=share, shape=[Q, N, d], **extra,
        ))
    del docs, valid, queries
    torch.cuda.empty_cache()
    return entries


def mnist_entries(torch, g) -> list[dict]:
    """B2 at the KNN classifier's width: the 63,000 x 784 train split of
    ``load_mnist_sample(70000, synthetic=True)`` as docs (l2, k 3, every
    row live), its first test images as 1, 16 and 256 queries. The rows
    are the loader's own generator's, made here as one array (the loader
    builds a table of them)."""
    import numpy as np

    rng = np.random.default_rng(0)  # ``load_mnist_sample``'s synthetic stand-in
    images = rng.integers(0, 255, (MNIST_SAMPLE, MNIST_DIM)).astype(np.float32)
    split = MNIST_SAMPLE - MNIST_SAMPLE // 10
    docs = torch.from_numpy(images[:split]).to(DEV)
    queries = torch.from_numpy(images[split : split + 256]).to(DEV)
    return knn_entries(torch, g, MNIST_DIM, cases=tuple((q, "l2", MNIST_K) for q in MNIST_QUERY_SIZES),
                       data=(docs, queries))


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
        from pathway_tpu_torch.ops.knn_topk import knn_topk_sharded  # noqa: F401
    except ImportError:
        if not ALT_TREE:
            raise
        emit("kernel_skipped", name="knn_topk_sharded", reason="the other tree has no knn_topk_sharded")
        return []
    mesh, where = mesh_devices(torch)
    devs = mesh.data_devices()
    doc_shards, bias_shards = [], []
    for dev in devs:
        docs = F.normalize(torch.randn(rows, d, device=DEV, generator=g), dim=1).to(dev)
        valid = (torch.rand(rows, device=DEV, generator=g) >= 0.1).to(dev)
        doc_shards.append(docs)
        bias_shards.append(_pallas_bias("cos", docs, valid))
    queries = F.normalize(torch.randn(256, d, device=DEV, generator=g), dim=1)
    entries = sharded_entries(torch, doc_shards, bias_shards, queries, where)
    del doc_shards, bias_shards, queries
    torch.cuda.empty_cache()
    return entries


def sharded_entries(torch, doc_shards, bias_shards, queries, where: str, suffix: str = "") -> list[dict]:
    """The ``knn_topk_sharded`` rows of ``doc_shards`` (f32, one a shard,
    with their biases) at 1, 16 and 256 of ``queries``, cos k 16: each held
    against its plain version and the plain top-k over the shards
    concatenated, timed beside them and the yardstick."""
    from pathway_tpu_torch.ops.knn_topk import (
        knn_topk_reference, knn_topk_sharded, knn_topk_sharded_reference, merge_shard_candidates, topk_agreement,
    )

    devs = [t.device for t in doc_shards]
    cards = len(set(devs))
    rows, d = doc_shards[0].shape
    cat_docs = torch.cat([t.to(DEV) for t in doc_shards])
    cat_bias = torch.cat([t.to(DEV) for t in bias_shards])
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
            f"knn_topk_sharded[cos,k={k},q={Q}{suffix}]", "pathway_tpu_torch/csrc/knn_topk.cu",
            "pathway_tpu/ops/pallas_knn.py:181", "knn_topk_sharded_merge", (vk - vp).abs().max().item(),
            cuda_ms(lambda: knn_topk_sharded(q, doc_shards, bias_shards, k=k), reps=reps),
            cuda_ms(lambda: knn_topk_sharded_reference(q, doc_shards, bias_shards, k=k), reps=2, warmup=1),
            flops / cards, nbytes / cards, PEAK_F32, cuda_ms(lib, reps=reps), index_agreement=share,
            shape=[Q, len(devs), rows, d], **extra,
        ))
    del cat_docs, cat_bias
    return entries


def encoder_layer_library_ms(torch, n_layers: int, d: int, h: int, ffn: int, eps: float, tokens, lens, seq: int) -> float:
    """The PyTorch yardstick of B1's whole layer, timed only: per layer one
    ``torch.nn.TransformerEncoderLayer`` call (post-LN, tanh-GELU through
    ``nn.GELU(approximate="tanh")``, ``batch_first``, a key-padding mask,
    eval mode under ``inference_mode``: the conditions of its native fast
    path) over the same padded rows, bf16, its own random weights."""
    import torch.nn as nn

    mods = [nn.TransformerEncoderLayer(d, h, ffn, dropout=0.0, activation=nn.GELU(approximate="tanh"),
                                       layer_norm_eps=eps, batch_first=True, norm_first=False, device=DEV,
                                       dtype=torch.bfloat16).eval() for _ in range(n_layers)]
    pad = torch.arange(seq, device=DEV)[None, :] >= lens[:, None]
    rows = tokens.view(-1, seq, d)

    def run():
        with torch.inference_mode():
            y = rows
            for m in mods:
                y = m(y, src_key_padding_mask=pad)
        return y

    return cuda_ms(run)


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
        library_ms=encoder_layer_library_ms(torch, cfg.num_layers, d, h, ffn, eps, tokens, lens, S),
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


ANALYSIS_DOCS = 4096  # documents of the gated pipeline (an epoch of 1,024 each)
ANALYSIS_QUERIES = 16
ANALYSIS_ROWS = 1 << 20  # the pipeline index's reserved rows, and B2's deep-target slab
ANALYSIS_DECODE = {"pages": 512, "page_size": 16, "lanes": 8, "max_seq": 160}  # decode_path's pool
ANALYSIS_DECODE_HIDDEN = 256  # DecoderConfig(): 4 heads of 64
ANALYSIS_SWEEP = [3, 5, 9, 17, 20, 31, 12, 7, 28, 2, 16, 33, 4, 4, 8, 19, 25, 30]  # the CPU bucket-sweep's lengths
ANALYSIS_HOST_SYNC = '''import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def embed_on_device(x, y):
    vec = torch.stack([torch.full((), x, device=DEVICE), torch.full((), y, device=DEVICE)])
    host = (vec / (torch.linalg.norm(vec) + 1e-6)).cpu()
    return (float(host[0]), float(host[1]))


docs = pw.debug.table_from_rows(pw.schema_from_types(x=float, y=float), [(1.0, 0.0), (0.0, 1.0)])
docs = docs.select(emb=pw.apply_with_type(embed_on_device, pw.ANY, docs.x, docs.y))
index = KNNIndex(docs.emb, docs, n_dimensions=2, reserved_space=100, distance_type="cosine")
pw.io.null.write(index.get_nearest_items(docs.emb, k=2))
pw.run()
'''  # the CPU tests' torch host-sync fixture: its staging UDF fills a card tensor and reads it back with .cpu()
# its clean twin: the same UDF keeps the value on the card (no .cpu(), no float() of a card tensor)
ANALYSIS_HOST_SYNC_CLEAN = ANALYSIS_HOST_SYNC.replace(
    '''    host = (vec / (torch.linalg.norm(vec) + 1e-6)).cpu()
    return (float(host[0]), float(host[1]))
''', '''    return vec / (torch.linalg.norm(vec) + 1e-6)
''')
assert ANALYSIS_HOST_SYNC_CLEAN != ANALYSIS_HOST_SYNC
_ANALYZE_RUNNER = r"""
import contextlib, io, json, runpy, sys
out = []
for argv in json.loads(sys.argv[1]):  # each as ``python -m pathway_tpu_torch *argv``, one interpreter for all
    o = io.StringIO()
    sys.argv = ["pathway_tpu_torch", *argv]
    with contextlib.redirect_stdout(o):
        try:
            runpy.run_module("pathway_tpu_torch", run_name="__main__", alter_sys=True)
            rc = 0
        except SystemExit as exc:
            rc = exc.code
    out.append({"rc": rc, "stdout": o.getvalue()})
print(json.dumps(out))
"""


def _card_sync_verdict(torch, fn, *args) -> tuple[bool, str, object]:
    """Run ``fn(*args)`` under ``torch.cuda.set_sync_debug_mode("error")``:
    (whether the card's own detector raised, its message, the result)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        return True, str(exc).splitlines()[0][:160], None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return False, "", out


def phase_analysis_path(torch, env: dict, n_docs: int = ANALYSIS_DOCS, n_queries: int = ANALYSIS_QUERIES,
                        rows: int = ANALYSIS_ROWS) -> dict:
    """The pre-run verifier (``analysis/``) on the card. (1) The main path's
    pipeline at MiniLM-L6 width (``pw.io.python.read`` of ``n_docs``
    documents -> ``SentenceTransformerEmbedder`` -> a ``KNNIndex`` of
    ``rows`` reserved rows <- ``n_queries`` queries) run under
    ``pw.run(analysis="deep")`` and again with ``analysis="off"``: hits
    equal, no ``AnalysisError``; the rule ids its graph draws and the
    gate's seconds. (2) Every deep target ``build_targets`` makes of that
    graph, and a decode target at ``decode_path``'s pool, run once on the
    card at its real geometry under ``set_sync_debug_mode("error")``: the
    verifier's PWL017 verdict (its op trace on ``meta``) equals the card's,
    B2 and B5 launch and agree with their plain versions; the torch
    host-sync fixture's staging UDF raises there and the verifier flags it,
    and its clean twin runs clean there and the verifier is silent.
    (3) PWL018: the MiniLM-L6 ``SentenceEncoder`` through the CPU tests'
    length sweep dispatches exactly ``predict_compile_keys``' geometries,
    and a second pass none. (4) The HBM rules read the card's budget.
    (5) ``python -m pathway_tpu_torch analyze`` over the demos and a
    positive fixture (one process runs each command as ``-m`` would).
    Returns the phase's launch counts, its timing loops' left out."""
    import tempfile

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.analysis import analyze
    from pathway_tpu_torch.analysis.deep import build_targets
    from pathway_tpu_torch.analysis.deep.targets import OpTrace
    from pathway_tpu_torch.analysis.graph_view import GraphView
    from pathway_tpu_torch.internals.ledger import default_hbm_bytes, index_hbm_bytes
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.sentence_encoder import SentenceEncoder
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import knn as ops_knn
    from pathway_tpu_torch.ops import paged_attention as ops_pa
    from pathway_tpu_torch.ops.knn_topk import topk_agreement
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    t_phase = time.perf_counter()
    k = 10
    rng = np.random.default_rng(SEED + 23)
    texts = _synthetic_texts_bulk(rng, n_docs, 20, 220)
    queries = [texts[i] for i in rng.choice(n_docs, n_queries // 2, replace=False)]
    queries += _synthetic_texts(rng, n_queries - len(queries), 5, 40)
    embedder = SentenceTransformerEmbedder(device=DEV)
    torch.cuda.synchronize()
    _build.reset_launches()

    # ---- (1) the pre-run gate on the live pipeline, deep and off
    def pipeline(analysis: str):
        import threading

        pw.clear_graph()
        cv, seen, answers = threading.Condition(), [0], {}

        class Documents(pw.io.python.ConnectorSubject):
            def run(self):
                for lo in range(0, n_docs, 1024):
                    for i in range(lo, min(n_docs, lo + 1024)):
                        self.next(doc_id=i, text=texts[i])
                    self.commit()
                    with cv:  # one commit, one epoch: the same UDF batches in every run
                        if not cv.wait_for(lambda: seen[0] >= min(n_docs, lo + 1024), timeout=300):
                            raise TimeoutError("analysis_path: an ingest epoch was not delivered")

        def on_doc(key, row, time, is_addition):
            with cv:
                seen[0] += 1
                cv.notify_all()

        schema = pw.schema_from_types(doc_id=int, text=str)
        docs = pw.io.python.read(Documents(), schema=schema, autocommit_duration_ms=None)
        docs = docs.select(pw.this.doc_id, emb=embedder(pw.this.text))
        pw.io.subscribe(docs, on_doc)
        qt = pw.debug.table_from_rows(schema=schema, rows=[(100_000 + i, q) for i, q in enumerate(queries)])
        qt = qt.select(pw.this.doc_id, emb=embedder(pw.this.text))
        index = pw.ml.KNNIndex(docs.emb, docs, n_dimensions=embedder.get_embedding_dimension(), reserved_space=rows,
                               distance_type="cosine", device=DEV)
        hits = index.get_nearest_items(qt.emb, k=k, with_distances=True).select(
            qid=qt.doc_id, nearest=pw.this.doc_id, dist=pw.this.dist)

        def on_hit(key, row, time, is_addition):
            if is_addition:
                answers[row["qid"]] = list(zip(row["nearest"], (-d for d in row["dist"])))

        pw.io.subscribe(hits, on_hit)
        gate: dict = {"seconds": 0.0, "diags": []}

        def timed_gate(mode):  # the run's own gate, timed, its findings kept
            t0 = time.perf_counter()
            try:
                return real_gate(mode)
            finally:
                gate["seconds"] += time.perf_counter() - t0

        def kept(*a, **kw):
            diags = real_analyze(*a, **kw)
            gate["diags"] += diags
            return diags

        run_mod._run_analysis, analysis_mod.analyze = timed_gate, kept
        t0 = time.perf_counter()
        try:
            pw.run(analysis=analysis)
        finally:
            run_mod._run_analysis, analysis_mod.analyze = real_gate, real_analyze
        torch.cuda.synchronize()
        gate["run_seconds"] = time.perf_counter() - t0
        gate["targets"] = build_targets(GraphView(G))  # the run's context is recorded on the graph
        pw.clear_graph()
        return [answers[100_000 + i] for i in range(n_queries)], gate

    import pathway_tpu_torch.analysis as analysis_mod
    from pathway_tpu_torch.internals import run as run_mod

    real_gate, real_analyze = run_mod._run_analysis, analysis_mod.analyze
    deep_hits, gate = pipeline("deep")
    off_hits, off = pipeline("off")
    if not gate["diags"] or off["diags"]:
        raise AssertionError("analysis_path: the deep run did not go through the gate, or the off run did")
    gate["rules"] = sorted({d.rule for d in gate["diags"]})
    gate["findings"] = [f"{d.rule} {d.severity.value}: {d.message[:120]}" for d in gate.pop("diags")]
    share, ok = _hits_agree(deep_hits, off_hits, k)
    if not ok:
        raise AssertionError(f"analysis_path: the deep-gated run's hits differ from the ungated run's ({share})")
    pipeline_launches = dict(_build.LAUNCHES)

    # ---- (2) the deep targets on the card, against its own sync detector
    targets = [t for t in gate.pop("targets") if t.trace is not None]
    decode_spec = ops_pa.deep_trace_spec(ANALYSIS_DECODE)
    g = torch.Generator(device=DEV).manual_seed(SEED + 24)
    verdicts = []
    timing = collections.Counter()  # the timing loops' launches: not the path's

    def timed_ms(fn) -> float:
        before = collections.Counter(_build.LAUNCHES)
        ms = cuda_ms(fn)
        timing.update(collections.Counter(_build.LAUNCHES) - before)
        return ms

    runs = [(t.kind, t.name, t.trace, t.spec.get("metric", "cos")) for t in targets]
    for kind, name, trace, metric in runs + [("decode", decode_spec["name"], decode_spec, None)]:
        ops = OpTrace(trace["fn"], trace["args"]).syncs
        if kind == "knn":
            dim = trace["args"][0].shape[1]
            matrix = torch.nn.functional.normalize(torch.randn(rows, dim, device=DEV, generator=g), dim=1)
            valid = torch.ones(rows, dtype=torch.bool, device=DEV)
            q = torch.nn.functional.normalize(torch.randn(n_queries, dim, device=DEV, generator=g), dim=1)
            args = (matrix, valid, q)
            keys = ("knn_topk_stream", "knn_topk_merge")
        else:
            lanes, pages, page = ANALYSIS_DECODE["lanes"], ANALYSIS_DECODE["pages"], ANALYSIS_DECODE["page_size"]
            pps = ops_pa.pages_for(ANALYSIS_DECODE["max_seq"], page)
            d = ANALYSIS_DECODE_HIDDEN
            pool = lambda: torch.randn(pages, page, d, device=DEV, generator=g)  # noqa: E731
            args = (torch.randn(lanes, d, device=DEV, generator=g), pool(), pool(),
                    torch.randperm(pages, device=DEV, generator=g)[: lanes * pps].reshape(lanes, pps).int(),
                    torch.randint(1, ANALYSIS_DECODE["max_seq"] + 1, (lanes,), device=DEV, generator=g).int())
            keys = ("paged_decode_attention", "paged_decode_combine")
        before = collections.Counter(_build.LAUNCHES)
        synced, message, out = _card_sync_verdict(torch, trace["fn"], *args)
        launched = {key: _build.LAUNCHES[key] - before[key] for key in keys}
        if bool(ops) != synced:
            raise AssertionError(f"analysis_path: the verifier's PWL017 verdict on {name} ({ops}) is not the card's "
                                 f"({message or 'no sync'})")
        if synced or not all(launched.values()):
            raise AssertionError(f"analysis_path: {name} synced on the card ({message}) or did not launch {launched}")
        if kind == "knn":
            want = ops_knn._topk_fn(metric)(*args, out[0].shape[1])
            agree, agreed = topk_agreement(out[0], out[1], want[0], want[1], atol=1e-5, rtol=1e-5)
            err = float((out[0] - want[0]).abs().max())
            if not agreed:
                raise AssertionError(f"analysis_path: {name} disagrees with the plain top-k ({agree})")
        else:
            want = ops_pa.paged_attention_reference(*args, n_heads=4)
            err = held(name, out, want, rtol=1e-4, atol=1e-4)
        verdicts.append(dict(target=name, kind=kind, trace_syncs=ops, card_synced=synced, launches=launched,
                             max_abs_err=err, ms=timed_ms(lambda: trace["fn"](*args))))
        del args, out, want
    # the torch host-sync fixture and its clean twin: each staging UDF fills
    # its vector on the card, so its .cpu() readback is the one sync the
    # detector can meet; the positive syncs on the card and the verifier
    # flags it, the twin runs clean and the verifier is silent
    def fixture_verdicts(source: str, path: str) -> tuple[list, bool, str, object]:
        with open(path, "w") as f:
            f.write(source)
        scope: dict = {}
        saved = os.environ.get("PATHWAY_ANALYZE_ONLY")
        os.environ["PATHWAY_ANALYZE_ONLY"] = "1"
        try:
            pw.clear_graph()
            exec(compile(source, path, "exec"), scope)
            flagged_ = [d for d in analyze(G, deep=True) if d.rule == "PWL017"]
        finally:
            pw.clear_graph()
            if saved is None:
                os.environ.pop("PATHWAY_ANALYZE_ONLY")
            else:
                os.environ["PATHWAY_ANALYZE_ONLY"] = saved
        return (flagged_, *_card_sync_verdict(torch, scope["embed_on_device"], 1.0, 0.0))

    with tempfile.TemporaryDirectory() as tmp:
        fixture = os.path.join(tmp, "deep_host_sync.py")
        flagged, udf_synced, udf_message, _ = fixture_verdicts(ANALYSIS_HOST_SYNC, fixture)
        if not udf_synced or [d.detail.get("markers") for d in flagged] != [["cpu"]]:
            raise AssertionError(f"analysis_path: the host-sync fixture: card synced {udf_synced}, verifier "
                                 f"{[d.render() for d in flagged]}")
        clean_flagged, clean_synced, clean_message, clean_out = fixture_verdicts(
            ANALYSIS_HOST_SYNC_CLEAN, os.path.join(tmp, "deep_host_sync_clean.py"))
        if clean_synced or clean_flagged or not (clean_out.device.type == torch.device(DEV).type
                                                  and bool(torch.isfinite(clean_out).all())):
            raise AssertionError(f"analysis_path: the clean twin: card synced {clean_synced} ({clean_message}), "
                                 f"verifier {[d.render() for d in clean_flagged]}")

        # ---- (3) PWL018: dispatched geometries against the prediction, at MiniLM-L6 width
        enc = SentenceEncoder(max_seq_len=32, max_batch=16, seed=SEED, device=DEV)
        toks = [[(i * 7 + j) % 29000 + 1 for j in range(n)] for i, n in enumerate(ANALYSIS_SWEEP)]
        predicted = enc.predict_compile_keys(ANALYSIS_SWEEP)
        libs_before = len(_build._LIBS)
        before = collections.Counter(_build.LAUNCHES)
        out = enc.encode_tokens(toks)
        first = set(enc._geometries)
        enc.encode_tokens(toks)
        torch.cuda.synchronize()
        sweep_launches = dict(collections.Counter(_build.LAUNCHES) - before)
        if first != predicted or enc._geometries != predicted or not np.isfinite(out).all():
            raise AssertionError(f"analysis_path: the encoder dispatched {sorted(enc._geometries)}, predicted "
                                 f"{sorted(predicted)}")
        sources = sorted(n for n in os.listdir(_build.CSRC) if n.endswith(".cu"))
        if len(_build._LIBS) != libs_before or sorted(_build._LIBS) != sources:
            raise AssertionError(f"analysis_path: built {sorted(_build._LIBS)} for the sources {sources}")

        # ---- (4) the HBM rules read the card's budget (analyze-only: nothing is allocated)
        def pwl010(rows_: int, budget: str | None) -> bool:
            saved_env = {v: os.environ.get(v) for v in ("PATHWAY_ANALYZE_ONLY", "PATHWAY_HBM_BYTES")}
            os.environ["PATHWAY_ANALYZE_ONLY"] = "1"
            os.environ.pop("PATHWAY_HBM_BYTES", None)
            if budget is not None:
                os.environ["PATHWAY_HBM_BYTES"] = budget
            try:
                pw.clear_graph()
                vecs = pw.debug.table_from_rows(pw.schema_from_types(v=float), [(1.0,)])
                vecs = vecs.select(emb=pw.apply_with_type(lambda v: (v,) * 384, pw.ANY, pw.this.v))
                index_ = pw.ml.KNNIndex(vecs.emb, vecs, n_dimensions=384, reserved_space=rows_, device=DEV)
                pw.io.null.write(index_.get_nearest_items(vecs.emb, k=3))
                assert pw.run() is None
                return any(d.rule == "PWL010" for d in analyze(G))
            finally:
                pw.clear_graph()
                for v, val in saved_env.items():
                    if val is None:
                        os.environ.pop(v, None)
                    else:
                        os.environ[v] = val

        card_budget, card_bytes = default_hbm_bytes(), torch.cuda.get_device_properties(0).total_memory
        hbm = {"default_hbm_bytes": card_budget, "total_memory": card_bytes,
               "index_2p24_bytes": index_hbm_bytes(1 << 24, 384), "index_2p26_bytes": index_hbm_bytes(1 << 26, 384),
               "pwl010_2p24_at_16GiB": pwl010(1 << 24, "16G"), "pwl010_2p24_at_card": pwl010(1 << 24, None),
               "pwl010_2p26_at_card": pwl010(1 << 26, None)}
        if card_budget != card_bytes or not hbm["pwl010_2p24_at_16GiB"] or hbm["pwl010_2p24_at_card"] or \
                not hbm["pwl010_2p26_at_card"]:
            raise AssertionError(f"analysis_path: the HBM rules did not read the card's budget: {hbm}")

        # ---- (5) the command line, in one process
        root = os.path.dirname(os.path.abspath(__file__))
        child_env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        from pathway_tpu_torch.debug.demos import demo_programs

        cmds = [["analyze", "--deep", "--json", demo] for demo in demo_programs()]
        cmds.append(["analyze", "--deep", "--fail-on=warn", fixture])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _ANALYZE_RUNNER, json.dumps(cmds)], cwd=root, env=child_env,
                              capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
    *demos, fatal = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else [{}]
    if len(demos) != len(cmds) - 1 or any(d["rc"] != 0 for d in demos) or fatal.get("rc") != 1 or \
            "PWL017" not in fatal.get("stdout", ""):
        raise AssertionError(f"analysis_path: analyze over the demos gave {[d['rc'] for d in demos]}, the fixture "
                             f"{fatal.get('rc')} ({proc.stderr[-800:]})")
    torch.cuda.synchronize()
    launches = {key: n - timing[key] for key, n in _build.LAUNCHES.items() if n - timing[key]}
    missing = [key for key in ("gemm_bias_act", "gemm_bias_residual_layernorm", "knn_topk_stream", "knn_topk_merge",
                               "paged_decode_attention", "paged_decode_combine") if launches.get(key, 0) == 0]
    if missing:
        raise AssertionError(f"analysis_path never launched {missing}")
    result = dict(
        card=env["nvidia_smi"], docs=n_docs, queries=n_queries, index_rows=rows, gate_seconds=gate["seconds"],
        rule_ids=gate["rules"], findings=gate["findings"], deep_run_seconds=gate["run_seconds"],
        off_run_seconds=off["run_seconds"], hits_agreement=share, pipeline_launches=pipeline_launches,
        targets=verdicts, host_sync_fixture={"card_synced": udf_synced, "card_message": udf_message,
                                             "flagged": [d.detail for d in flagged]},
        host_sync_clean_twin={"card_synced": clean_synced, "flagged": len(clean_flagged)},
        timing_launches=dict(timing),
        sweep_keys=sorted(predicted), sweep_launches=sweep_launches, built_libraries=len(_build._LIBS),
        cu_sources=len(sources), hbm=hbm, demos_rc=[d["rc"] for d in demos],
        demo_rules=[sorted({x["rule"] for x in json.loads(d["stdout"])["diagnostics"]}) for d in demos],
        fixture_rc=fatal["rc"], cli_seconds=cli_s, phase_seconds=time.perf_counter() - t_phase,
        launches=launches,
    )
    emit("analysis_path", **result)
    return launches


TRAIN_PAIRS, TRAIN_SEQ, TRAIN_MIN_LEN = 128, 128, 16  # pairs a step, padded length, shortest live length
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_SPLIT_STEPS = 3, 20, 4  # SPLIT: steps timed part by part
TRAIN_LR = 2e-5  # the reference trainer's default
# kernel-forward gradients against the plain trainer's: the two round the
# bf16 forward at other points (P before normalisation in the kernel, after
# it in the plain chain), so each gradient tensor is held by direction
# (cosine 0.9998 and up for every tensor on the CPU at two layers, this batch)
TRAIN_GRAD_MIN_COS = 0.995
# the dp 1 x tp 2 step's loss against the unsharded one: the out and mlp_out
# partial products are rounded to bf16 before their sum
TRAIN_TP_LOSS_TOL = 2e-3
# a Function's gradient against autograd through the same plain chain with
# the same cotangent: the same operations
TRAIN_FN_TOL = dict(rtol=1.6e-2, atol=1e-2)


def _train_batch(torch, rng, cfg, n_pairs: int, seq: int, min_len: int, dev):
    """Two towers of ``n_pairs`` token rows at padded length ``seq``, live
    lengths drawn from ``[min_len, seq]``, on ``dev``."""
    import numpy as np

    out = []
    for _ in range(2):
        ids = rng.integers(1000, cfg.vocab_size, (n_pairs, seq)).astype(np.int64)
        lens = rng.integers(min_len, seq + 1, (n_pairs,))
        mask = np.arange(seq)[None, :] < lens[:, None]
        out += [torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)]
    return tuple(out)


def _grad_cosines(torch, got: dict, want: dict) -> dict:
    cos = {}
    for name, g in want.items():
        a, b = got[name].float().flatten(), g.float().flatten()
        cos[name] = float(torch.nn.functional.cosine_similarity(a, b, dim=0)) if b.abs().max() > 0 else 1.0
    return cos


def phase_train_path(torch, env: dict, n_pairs: int = TRAIN_PAIRS, seq: int = TRAIN_SEQ, warmup: int = TRAIN_WARMUP,
                     steps: int = TRAIN_STEPS, split_steps: int = TRAIN_SPLIT_STEPS) -> dict:
    """Contrastive training at MiniLM-L6's full width on one card:
    ``ContrastiveTrainer`` (``make_mesh(n_devices=1)``: ``cuda:0``) takes
    ``warmup`` steps, then ``steps`` timed ``step()`` calls,
    ``split_steps`` steps timed part by part (forward and loss, backward,
    AdamW) and one step under ``torch.profiler`` (the card's time by
    operator and its share of a step) on one repeated batch of ``n_pairs``
    pairs at S ``seq``. Each
    tower's six layers launch B3 (``masked_attention``) once in the forward;
    attention's backward recomputes in plain PyTorch, the projections are
    ``F.linear``.

    Gated on the loss falling, exactly 2 towers x layers B3 launches a
    counted step and no other kernel, the first step's gradients against an
    all-plain trainer's (same weights), a dp 1 x tp 2 step on the pooled
    mesh ``[[cuda:0, cuda:0]]`` (one B3 launch per model shard) against the
    unsharded loss, and the B4 and ``encoder_forward`` Functions' gradients
    against autograd through their plain chains. Returns the counted
    launches."""
    import numpy as np

    from pathway_tpu_torch.models import ContrastiveTrainer, EncoderConfig, TextEncoder
    from pathway_tpu_torch.models.encoder import init_params
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import fused_attention as fa
    from pathway_tpu_torch.ops import fused_layer as fl
    from pathway_tpu_torch.parallel.sharding import make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    cfg = EncoderConfig.minilm_l6()
    rng = np.random.default_rng(SEED + 17)
    batch = _train_batch(torch, rng, cfg, n_pairs, seq, TRAIN_MIN_LEN, dev)
    one = make_mesh(n_devices=1) if DEV == "cuda" else make_mesh(devices=["cpu"])
    trainer = ContrastiveTrainer(cfg, mesh=one, learning_rate=TRAIN_LR, seed=SEED)

    # gate: the first step's gradients, kernel forwards against plain ones
    plain = ContrastiveTrainer(dataclasses.replace(cfg, attention_impl="plain"), mesh=one, learning_rate=TRAIN_LR,
                               seed=SEED)
    loss0, grads = trainer.value_and_grad(*batch)
    plain_loss0, plain_grads = plain.value_and_grad(*batch)
    del plain
    cos = _grad_cosines(torch, grads, plain_grads)
    worst = min(cos, key=cos.get)
    if not np.isfinite(loss0) or cos[worst] < TRAIN_GRAD_MIN_COS:
        raise AssertionError(f"train_path: kernel-forward gradients disagree with the plain trainer's: "
                             f"{worst} cosine {cos[worst]} (loss {loss0} vs {plain_loss0})")
    grad_rel = max(float((grads[k].float() - v.float()).abs().max() / v.float().abs().max().clamp_min(1e-30))
                   for k, v in plain_grads.items())
    del grads, plain_grads

    # gate: dp 1 x tp 2 on one card, from the same weights
    pooled = ContrastiveTrainer(cfg, mesh=make_mesh(devices=[dev, dev], model_parallel=2), learning_rate=TRAIN_LR,
                                seed=SEED)
    before = _build.LAUNCHES["masked_attention"]
    tp_loss = pooled.step(*batch)
    torch.cuda.synchronize()
    tp_launches = _build.LAUNCHES["masked_attention"] - before
    del pooled
    if abs(tp_loss - loss0) > TRAIN_TP_LOSS_TOL or tp_launches != 2 * 2 * cfg.num_layers:
        raise AssertionError(f"train_path: dp1 x tp2 step loss {tp_loss} vs {loss0} (tolerance {TRAIN_TP_LOSS_TOL}), "
                             f"{tp_launches} B3 launches (want {4 * cfg.num_layers})")

    losses = [trainer.step(*batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.step(*batch))  # a float: waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    parts = []
    for _ in range(split_steps):
        t0 = time.perf_counter()
        loss = trainer.loss(*batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.apply_gradients()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        losses.append(float(loss.detach()))
        parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    # one more step under the profiler: the card's time by operator
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        losses.append(trainer.step(*batch))
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_card = torch.autograd.DeviceType.CUDA
    device_ms = sum(e.self_device_time_total for e in events if e.device_type == on_card) / 1e3
    ops = sorted((e for e in events if e.device_type != on_card and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    top_ops = {e.key: e.self_device_time_total / 1e3 for e in ops[:8]}
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    counted = steps + split_steps + 1
    want = {"masked_attention": 2 * cfg.num_layers * counted}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"train_path launched {launches}, want exactly {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < loss0:
        raise AssertionError(f"train_path: the loss did not fall ({loss0} -> {losses[-1]})")

    # gate: the B4 and encoder_forward Functions against autograd through their plain chains
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    qkv = torch.randn(16, 256, 3 * cfg.hidden_size, device=dev, generator=g).bfloat16()
    seg = torch.full((16, 256), -1, dtype=torch.int32, device=dev)
    for r in range(16):
        cuts = sorted(rng.choice(np.arange(8, 240), 5, replace=False).tolist())
        for j, (a, b) in enumerate(zip([0] + cuts, cuts + [240])):
            seg[r, a:b] = r * 8 + j
    w = torch.randn(16, 256, cfg.hidden_size, device=dev, generator=g) * (seg >= 0)[:, :, None]
    got = qkv.clone().requires_grad_(True)
    (fa.attention(got, None, n_heads=cfg.num_heads, segment_ids=seg).float() * w).sum().backward()
    want_b4 = qkv.clone().requires_grad_(True)
    (fa.packed_attention_reference(want_b4, seg, cfg.num_heads).float() * w).sum().backward()
    b4_err = held("segment_attention Function gradient", got.grad, want_b4.grad, **TRAIN_FN_TOL)
    del qkv, got, want_b4, w

    small = dataclasses.replace(cfg, num_layers=2)
    sd = {k: v.to(dev).requires_grad_(True) for k, v in init_params(small, SEED).items()}
    ids, mask = batch[0][:16, :64], batch[1][:16, :64]
    proj = torch.randn(ids.shape[0], cfg.hidden_size, device=dev, generator=g)  # a cotangent with weight everywhere
    (fl.encoder_forward(sd, small, ids, mask) * proj).sum().backward()
    with torch.device("meta"):
        module = TextEncoder(dataclasses.replace(small, attention_impl="plain"))
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()}
    (torch.func.functional_call(module, ref, (ids, mask)) * proj).sum().backward()
    enc_cos = _grad_cosines(torch, {k: v.grad for k, v in sd.items()}, {k: v.grad for k, v in ref.items()})
    enc_worst = min(enc_cos, key=enc_cos.get)
    if enc_cos[enc_worst] < TRAIN_GRAD_MIN_COS or any(sd[k].grad.shape != sd[k].shape for k in sd):
        raise AssertionError(f"train_path: encoder_forward's gradient {enc_worst} cosine {enc_cos[enc_worst]}")
    del sd, ref, module, trainer
    torch.cuda.empty_cache()

    p50, p99 = float(np.percentile(step_ms, 50)), float(np.percentile(step_ms, 99))
    fwd, bwd, upd = (float(np.median([p[i] for p in parts])) for i in range(3))
    lens = torch.cat([batch[1].sum(dim=1), batch[3].sum(dim=1)]).double()
    tokens = 2 * n_pairs * seq  # the GEMMs run every padded token
    attn_pairs = float(seq * lens.sum())  # the kernel's (query, live key) pairs
    step_flops = 3.0 * fl.encoder_flops(cfg, tokens, attn_pairs)  # forward + backward ~ 3x the forward
    result = dict(
        pairs=n_pairs, seq=seq, layers=cfg.num_layers, hidden=cfg.hidden_size, warmup_steps=warmup,
        timed_steps=steps, split_steps=split_steps, first_loss=loss0, last_loss=losses[-1],
        losses=losses, step_p50_ms=p50, step_p99_ms=p99, pairs_per_s=n_pairs / (p50 / 1e3),
        tokens_per_s=tokens / (p50 / 1e3), live_tokens_per_s=float(lens.sum()) / (p50 / 1e3),
        forward_ms=fwd, backward_ms=bwd, update_ms=upd, backward_share=bwd / (fwd + bwd + upd),
        profiled_device_ms=device_ms, device_busy_share=device_ms / p50, top_device_ops_ms=top_ops,
        step_tflops=step_flops / 1e12, achieved_tflops=step_flops / (p50 / 1e3) / 1e12,
        mfu_vs_989=step_flops / (p50 / 1e3) / PEAK_BF16, max_memory_allocated=peak,
        grad_min_cos=cos[worst], grad_min_cos_tensor=worst, grad_max_rel_err=grad_rel, plain_first_loss=plain_loss0,
        tp2_loss=tp_loss, tp2_b3_launches=tp_launches, b4_grad_max_abs_err=b4_err,
        encoder_forward_grad_min_cos=enc_cos[enc_worst], launches=launches, nvidia_smi=env["nvidia_smi"],
        seconds=time.perf_counter() - t_phase,
    )
    emit("train_path", **result)
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
# and the documents of the 1- vs 4-worker KNNIndex comparison (131,072 documents until the twenty-first path needed
# the time; 4,096 worker documents until the fourteenth)
ENGINE_DOCS, ENGINE_EPOCH, ENGINE_QUERIES, ENGINE_WORKER_DOCS = 65_536, 1024, 512, 2_048
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
SERVER_FILES, SERVER_QUERIES, SERVER_FILTERED, SERVER_BURST, SERVER_BURST_THREADS = 2048, 512, 64, 64, 8  # 4,096 files until the fourteenth path needed the time
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
    port = _free_port()

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
DECODE_EXT_REQUESTS, DECODE_EXT_LONG, DECODE_EXT_PREFIXES, DECODE_EXT_DEADLINE_MS = 32, 8, 4, 120_000.0  # 64 requests until the fourteenth path needed the time
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
    """``DECODE_EXT_REQUESTS`` seeded requests: each starts with one of 4
    shared system prefixes of 64-256 tokens (whole pages of 16), then a
    4-63-token question; 8 of them are long, 300-440 tokens, so chunked
    prefill interleaves with decoding."""
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
                      embed_in_udf: bool = False, **run_kwargs):
    """``engine_path``'s pipeline: ``texts`` streamed by a subject committing
    every ``per_epoch`` (each commit waits for its delivery) ->
    ``DataIndex(BruteForceKnn(embedder=))`` -> ``singles`` one epoch each,
    then ``batch`` as one epoch, ``query_as_of_now(number_of_matches=10)``,
    under ``pw.run(**run_kwargs)`` -> (per query [(doc_id, score)], ingest
    seconds, run seconds); each clock is read after every card of ``cards``
    (default: the current one) is done. ``embed_in_udf``: documents and
    queries are embedded by the embedder as a UDF column of their own
    (an operator of its own in a profile) and the index takes the vectors."""
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
    dim = embedder.get_embedding_dimension()
    if embed_in_udf:
        docs = docs.select(pw.this.doc_id, pw.this.text, vector=embedder(pw.this.text))
        queries = queries.select(pw.this.qid, vector=embedder(pw.this.text))
        index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(docs.vector, dimensions=dim,
                                                                      reserved_space=n_docs, device=DEV))
        query_col = queries.vector
    else:
        index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(
            docs.text, dimensions=dim, reserved_space=n_docs, embedder=embedder))
        query_col = queries.text
    answers = index.query_as_of_now(query_col, number_of_matches=k).select(
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

    port = _free_port()

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


# observe_path: the corpus and the files written while serving, the traffic
# and its clients, the overload burst at an admission queue bounded well
# below it, the decode burst, and the freshness probe
# 1,024 files, 256 new and 128 answers until the fifteenth path needed the time (256 answers until the fourteenth);
# 512 files and 128 new until the nineteenth
OBS_FILES, OBS_NEW, OBS_ANSWERS, OBS_RETRIEVE, OBS_CLIENTS = 256, 64, 64, 64, 8
OBS_BURST, OBS_QUEUE, OBS_DECODE, OBS_PROBE, OBS_WINDOW, OBS_WRITE_GROUP = 256, 32, 16, 32, 6, 8
# the questions and retrievals read the corpus only: the files written while
# they are asked cannot change their answers, so the twin's must be equal
OBS_FILTER = 'globmatch(`"**/doc_*"`, path)'
OBS_DECODE_SPEC = ",cache=on,chunk=64,spec=4,draft=2"  # decode_ext_path's configuration (c)
OBS_SERVING = dict(max_queue=OBS_QUEUE, batch_max=64, batch_window_ms=2.0, latency_budget_ms=60_000.0,
                   query_share=1.0, default_deadline_ms=120_000.0)
OBS_PLANES = dict(tracing=True, chip_ledger=True, freshness=True, watchdog=True, with_http_server=True,
                  monitoring_http_port=0)
OBS_ACCOUNTS = ("encode", "index.search", "rerank", "decode", "decode.draft", "decode.verify", "compile")
# the engine-side spans a served answer's trace must hold, from its HTTP root
OBS_STAGES = ("request", "admission", "queue", "dispatch", "pipeline", "index_search", "rerank")
# the reference's metric names a scrape must hold, by section
OBS_METRICS = {
    "chip": ("pathway_chip_seconds_total", "pathway_chip_dispatches_total", "pathway_chip_busy_seconds_total",
             "pathway_chip_stranded_fraction"),
    "index": ("pathway_index_docs", "pathway_index_searches_total", "pathway_index_queries_total"),
    "serving": ("pathway_serving_admitted_total", "pathway_serving_shed_total", "pathway_serving_batches_total",
                "pathway_serving_stage_seconds_bucket"),
    "decode": ("pathway_decode_tokens_total", "pathway_decode_steps_total", "pathway_decode_spec_acceptance_rate"),
    "freshness": ("pathway_freshness_visibility_lag_seconds_bucket", "pathway_freshness_staleness_seconds"),
}
LEDGER_DEVICE_SHARE = 0.9  # an account's booked seconds against the profiler's device span of its blocks, and its kernels' time


def _obs_write(folder: str, name: str, text: str) -> float:
    """Write one file so that it appears whole in the watched folder (written
    beside it, then renamed into it); returns the write time."""
    staging = folder + "_staging"
    os.makedirs(staging, exist_ok=True)
    tmp = os.path.join(staging, name)
    with open(tmp, "w") as f:
        f.write(text)
    t = time.perf_counter()
    os.replace(tmp, os.path.join(folder, name))
    return t


def _obs_serve(torch, parts: dict, *, on: bool, questions, retrievals, new_texts, decode_prompts,
               cold_build: bool = False, burst: int = 0, probe=(), window: bool = False) -> dict:
    """One run of the question answerer (``phase_observe_path``): the planes
    on (``pw.run(**OBS_PLANES)``) or off, the corpus written once the
    endpoint is up, then ``questions`` and ``retrievals`` from
    ``OBS_CLIENTS`` concurrent clients while ``new_texts`` are written and
    each polled until retrievable, then the decode burst; with the planes
    on, also (``burst``) the overload burst and the scrape, the ledger's
    snapshot, (``probe``) the freshness probe and (``window``) the
    profiled window. ``cold_build``: the kernels are built anew, into an
    empty directory, once the run is up (the ledger's ``compile``)."""
    import queue as queue_mod
    import shutil
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.decode import DecodeEngine, DecoderConfig, DecodeService
    from pathway_tpu_torch.freshness.plane import FRESHNESS
    from pathway_tpu_torch.internals import http_monitoring
    from pathway_tpu_torch.internals.chip_ledger import CHIP_LEDGER
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.io import fs as fs_mod
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.serving import SERVING_METRICS, Deadline, ServingConfig
    from pathway_tpu_torch.tracing import TRACE_STORE
    from pathway_tpu_torch.tracing import span as trace_span
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer

    now = time.perf_counter
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    # one folder for every run: the answers quote their documents' paths
    folder = os.path.join(build_dir, "observe_path_docs")
    shutil.rmtree(folder, ignore_errors=True)
    shutil.rmtree(folder + "_staging", ignore_errors=True)
    os.makedirs(folder)
    port = _free_port()

    def post(path, payload, timeout=600):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read().decode()), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode() or "null"), dict(e.headers)

    def retrievable(text, path) -> bool:
        status, hits, _ = post("/v1/retrieve", {"query": text, "k": 1})
        return status == 200 and any(h["metadata"]["path"] == path for h in hits)

    def file_count() -> int:
        try:
            status, stats, _ = post("/v1/statistics", {})
        except OSError:  # the endpoint is not up yet
            return -1
        return stats["file_count"] if status == 200 else -1

    runners, monitors, scans, batch_sizes = [], [], [], []
    real_init, real_start = GraphRunner.__init__, http_monitoring.MonitoringHttpServer.start
    real_list, real_record_batch = fs_mod._list_files, SERVING_METRICS.record_batch

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    def recording_start(self):
        real_start(self)
        monitors.append(self)

    def list_files(*a, **kw):
        scans.append(now())
        return real_list(*a, **kw)

    def record_batch(size, ewma):
        batch_sizes.append(int(size))
        return real_record_batch(size, ewma)

    pw.clear_graph()
    docs = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    store = pw.xpacks.llm.DocumentStore(
        docs, retriever_factory=pw.indexing.BruteForceKnnFactory(embedder=parts["embedder"]),
        splitter=pw.xpacks.llm.splitters.TokenCountSplitter())
    rag = BaseRAGQuestionAnswerer(parts["chat"], parts["store"](store), prompt_template=parts["prompt"],
                                  search_topk=QA_SEARCH_K)
    QARestServer("127.0.0.1", port, rag, serving=ServingConfig(**OBS_SERVING))
    for reg in (CHIP_LEDGER, FRESHNESS, TRACE_STORE, SERVING_METRICS):
        reg.reset()
    GraphRunner.__init__, http_monitoring.MonitoringHttpServer.start = recording_init, recording_start
    fs_mod._list_files, SERVING_METRICS.record_batch = list_files, record_batch
    out: dict = {}
    res: dict = {}
    run = threading.Thread(target=lambda: res.update(result=pw.run(**(OBS_PLANES if on else {}))), daemon=True)
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t_run = now()
        run.start()
        deadline = now() + 300
        while file_count() != 0:
            if now() > deadline:
                raise TimeoutError("the observed server never came up")
            time.sleep(0.05)
        if cold_build:  # the kernels built anew while the run is up: the ledger books the nvcc builds
            _build.BUILD_DIR = tempfile.mkdtemp(prefix="observe_build_", dir=build_dir)
            _build._LIBS.clear()
            t0 = now()
            _build.build_all()
            out["cold_build_seconds"] = now() - t0
        t0 = now()
        for i, text in enumerate(parts["texts"]):
            _obs_write(folder, f"doc_{i:05d}.txt", text)
        while file_count() != len(parts["texts"]):
            if now() > deadline + 300:
                raise TimeoutError("the observed server never indexed the corpus")
            time.sleep(0.05)
        out["ingest_seconds"] = now() - t0

        # questions and retrievals from concurrent clients, files written meanwhile
        work: queue_mod.Queue = queue_mod.Queue()
        for j, q in enumerate(questions):
            work.put(("answer", j, {"prompt": q, "filters": OBS_FILTER, "return_context_docs": True}))
        for j, q in enumerate(retrievals):
            work.put(("retrieve", j, {"query": q, "k": QA_SEARCH_K, "metadata_filter": OBS_FILTER}))
        answers, retrieved, traces, lat, failures = {}, {}, {}, [], []

        def client():
            while True:
                try:
                    kind, j, payload = work.get_nowait()
                except queue_mod.Empty:
                    return
                t1 = now()
                status, body, headers = post("/v1/pw_ai_answer" if kind == "answer" else "/v1/retrieve", payload)
                lat.append((now() - t1) * 1e3)
                if status != 200:
                    failures.append((kind, j, status, body))
                (answers if kind == "answer" else retrieved)[j] = (body, headers.get("X-Pathway-Trace"))
                if on and kind == "answer":  # read at once: the store's ring evicts the oldest spans
                    tid = headers.get("X-Pathway-Trace")
                    traces[j] = TRACE_STORE.get_trace(tid) if tid else []

        written_lag = []

        def writer():  # groups of OBS_WRITE_GROUP files, each file polled until retrievable
            for g in range(0, len(new_texts), OBS_WRITE_GROUP):
                group = {}
                for i in range(g, min(g + OBS_WRITE_GROUP, len(new_texts))):
                    name = f"new_{i:05d}.txt"
                    group[os.path.join(folder, name)] = (new_texts[i], _obs_write(folder, name, new_texts[i]))
                until = now() + 120
                while group:
                    for path, (text, t_write) in list(group.items()):
                        if retrievable(text, path):
                            written_lag.append(now() - t_write)
                            del group[path]
                    if group and now() > until:
                        failures.append(("new_files", g, "never retrievable", sorted(group)[:2]))
                        return
                    time.sleep(0.01)

        clients = [threading.Thread(target=client) for _ in range(OBS_CLIENTS)]
        writing = threading.Thread(target=writer)
        t0 = now()
        for t in clients + [writing]:
            t.start()
        for t in clients:
            t.join(timeout=900)
        traffic_s = now() - t0
        writing.join(timeout=900)
        if failures or len(answers) != len(questions) or len(retrieved) != len(retrievals):
            raise AssertionError(f"observe_path traffic: {len(answers)} answers, {len(retrieved)} retrievals, "
                                 f"failures {failures[:3]}")
        out.update(answers=answers, retrieved=retrieved, traffic_seconds=traffic_s,
                   answers_per_s=(len(questions) + len(retrievals)) / traffic_s, latency=_percentiles(lat),
                   new_files=len(written_lag), write_to_retrievable=_percentiles([x * 1e3 for x in written_lag]))
        out["traces"] = traces

        # the decode burst behind a DecodeService: configuration (c), whose
        # ticks are all speculative (draft and verify), then the greedy one,
        # whose steps run B5
        out.update(streams={}, tokens_per_s={})
        for tag, spec in (("c", OBS_DECODE_SPEC), ("a", "")):
            engine = DecodeEngine(DecoderConfig(), pw.decode.parse_decode_spec(
                f"{DECODE_EXT_POOL},impl={DECODE_EXT_IMPL}{spec}"), seed=SEED, device=DEV)
            engine.generate([[7] * 24])  # warm-up
            svc = DecodeService(engine, config=ServingConfig(**DECODE_EXT_SERVING))
            try:
                torch.cuda.synchronize()
                t0 = now()
                tickets = []
                for p in decode_prompts:
                    with trace_span("request", new_trace=True):
                        tickets.append(svc.submit(p, deadline=Deadline(DECODE_EXT_DEADLINE_MS)))
                streams = [t.result(timeout=600) for t in tickets]
                torch.cuda.synchronize()
                decode_s = now() - t0
            finally:
                svc.stop()
            if svc.error is not None or any(t.preempted for t in tickets):
                raise AssertionError(f"observe_path's decode burst ({tag}) failed: {svc.error!r}")
            out["streams"][tag] = streams
            out["tokens_per_s"][tag] = sum(map(len, streams)) / decode_s

        if burst:  # the overload burst: far more concurrent requests than the admission queue holds
            admitted0 = SERVING_METRICS.snapshot()["admitted_total"]
            gate = threading.Barrier(burst)
            got = []

            def one(j):
                gate.wait()
                got.append(post("/v1/retrieve", {"query": questions[j % len(questions)], "k": QA_SEARCH_K,
                                                 "metadata_filter": OBS_FILTER}))

            threads = [threading.Thread(target=one, args=(j,)) for j in range(burst)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            snap = SERVING_METRICS.snapshot()
            out["burst"] = dict(
                sent=burst, answered=sum(s == 200 for s, _, _ in got),
                shed=sum(s == 503 and b.get("reason") == "queue_full" for s, b, _ in got),
                other=[(s, b) for s, b, _ in got if s not in (200, 503)][:3],
                admitted=snap["admitted_total"] - admitted0, bad_answers=sum(
                    s == 200 and len(b) != QA_RERANK_K for s, b, _ in got),
                shed_with_trace=sum(s == 503 and bool(h.get("X-Pathway-Trace")) for s, _, h in got))
        if on:
            mport = monitors[-1].port
            with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=60) as resp:
                out["metrics"] = resp.read().decode()
            with urllib.request.urlopen(f"http://127.0.0.1:{mport}/status", timeout=60) as resp:
                out["status"] = json.loads(resp.read().decode())
            out["ledger"] = CHIP_LEDGER.snapshot()
            out["freshness"] = FRESHNESS.snapshot()
            out["batch_sizes"] = dict(sorted(collections.Counter(batch_sizes).items()))

        plane_lag, polled_lag = [], []
        # a random pause before each write, over the scanner's whole period
        # (its sleep and its walk of the folder), so that the writes fall at
        # any phase of it rather than just after the scan that served the last
        period = float(np.median(np.diff(scans[-20:]))) if len(scans) > 2 else fs_mod._POLL_INTERVAL_S
        delays = np.random.default_rng(SEED + 43).uniform(0.0, period, len(probe))
        for i, text in enumerate(probe):  # the freshness probe: nothing else is served meanwhile
            # named to sort first: the scanner lists the folder, then walks it
            # in order, so a file late in the walk waits the walk's length
            # more than one period (the files written while serving show it)
            name = f"0probe_{i:05d}.txt"
            path = os.path.join(folder, name)
            time.sleep(float(delays[i]))
            count0 = FRESHNESS.snapshot()["lag"]["count"]
            t_write = _obs_write(folder, name, text)
            until = now() + 120
            if i % 2 == 0:  # the plane's own measure: its lag of the epoch that made the file visible
                while FRESHNESS.snapshot()["lag"]["count"] == count0:
                    if now() > until:
                        raise AssertionError("the freshness plane never saw a probe file's epoch")
                    time.sleep(0.01)
                plane_lag.append(FRESHNESS.snapshot()["lag"]["last_ms"] / 1e3)
                while not retrievable(text, path):  # then the file is retrievable as well
                    time.sleep(0.01)
            else:  # the path's own measure: polling until the file is retrieved
                while not retrievable(text, path):
                    if now() > until:
                        raise AssertionError(f"probe file {name} was never retrievable")
                    time.sleep(0.01)
                polled_lag.append(now() - t_write)
        if probe:
            out["probe"] = dict(plane_s=plane_lag, polled_s=polled_lag, scan_periods_s=np.diff(scans[-50:]).tolist())

        if window:  # the ledger against the card over one profiled window
            from torch.profiler import ProfilerActivity, profile

            from torch._C._profiler import _ExperimentalConfig
            from torch.autograd import DeviceType

            spec_engine = DecodeEngine(DecoderConfig(), pw.decode.parse_decode_spec(
                f"{DECODE_EXT_POOL},impl={DECODE_EXT_IMPL}{OBS_DECODE_SPEC}"), seed=SEED, device=DEV)
            spec_engine.generate([[7] * 24])  # warm-up
            svc2 = DecodeService(spec_engine, config=ServingConfig(**DECODE_EXT_SERVING))
            svc3 = DecodeService(engine, config=ServingConfig(**DECODE_EXT_SERVING))
            torch.cuda.synchronize()
            CHIP_LEDGER.reset()
            t0 = now()
            # the bookings run on the engine's and the batchers' threads
            every_thread = _ExperimentalConfig(profile_all_threads=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         experimental_config=every_thread) as prof:
                for j in range(OBS_WINDOW):
                    post("/v1/pw_ai_answer", {"prompt": questions[j], "filters": OBS_FILTER,
                                              "return_context_docs": True})
                for one in (svc2, svc3):  # one engine at a time: the bookings never overlap
                    for t in [one.submit(p, deadline=Deadline(DECODE_EXT_DEADLINE_MS)) for p in decode_prompts[:4]]:
                        t.result(timeout=600)
                name = "window_00000.txt"
                _obs_write(folder, name, new_texts[0] + " window")
                while not retrievable(new_texts[0] + " window", os.path.join(folder, name)):
                    time.sleep(0.01)
                torch.cuda.synchronize()
            wall = now() - t0
            svc2.stop()
            svc3.stop()
            booked = {a: r["seconds"] for a, r in CHIP_LEDGER.snapshot(wall_s=wall)["accounts"].items()}
            # each block appears twice under its name: as the host range, whose
            # device time is the sum of the kernels the profiler links to it
            # (through the PyTorch operators inside it: not the kernels launched
            # through ctypes), and as the profiler's device-side annotation,
            # whose time is the span from its first kernel's start to its last
            # kernel's end, the figure the ledger's events measure; the two are
            # read apart, never summed
            device, kernels = collections.Counter(), collections.Counter()
            for e in prof.events():
                if e.name.startswith("chip_ledger::"):
                    into = device if e.device_type == DeviceType.CUDA else kernels
                    into[e.name.split("::", 1)[1]] += getattr(e, "device_time_total", 0.0) / 1e6
            out["window"] = dict(wall_s=wall, booked_s=booked, device_s=dict(device), kernel_s=dict(kernels),
                                 device_events=sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
        out["launches"] = dict(_build.LAUNCHES)
    finally:
        if runners:
            runners[-1].engine.stop()
        GraphRunner.__init__, http_monitoring.MonitoringHttpServer.start = real_init, real_start
        fs_mod._list_files, SERVING_METRICS.record_batch = real_list, real_record_batch
    if run.ident is not None:
        run.join(timeout=120)
    pw.clear_graph()
    shutil.rmtree(folder)
    shutil.rmtree(folder + "_staging", ignore_errors=True)
    if run.is_alive():
        raise AssertionError("the observed run did not end after the engine stopped")
    out["result"] = res.get("result")
    out["run_seconds"] = now() - t_run
    return out


def _obs_same_answers(on: dict, off: dict) -> int:
    """How many answers and retrievals of a planes-on run differ from its
    twin's (responses, context documents and hits by text and path; hit
    scores within the top-k tolerance)."""
    differ = 0
    for j, (body, _) in on["answers"].items():
        want = off["answers"][j][0]
        docs = [(d["text"], d["metadata"]["path"]) for d in body["context_docs"]]
        differ += not (body["response"] == want["response"]
                       and docs == [(d["text"], d["metadata"]["path"]) for d in want["context_docs"]])
    for j, (body, _) in on["retrieved"].items():
        want = off["retrieved"][j][0]
        differ += [(d["text"], d["metadata"]["path"]) for d in body] != [
            (d["text"], d["metadata"]["path"]) for d in want] or any(
            abs(float(a.get("dist", 0.0)) - float(b.get("dist", 0.0))) > HIT_TOL for a, b in zip(body, want))
    return differ


def phase_observe_path(torch, env: dict, n_files: int = OBS_FILES, n_new: int = OBS_NEW,
                       n_answers: int = OBS_ANSWERS, n_retrieve: int = OBS_RETRIEVE, n_decode: int = OBS_DECODE,
                       n_burst: int = OBS_BURST, n_probe: int = OBS_PROBE) -> dict:
    """The observability planes over ``qa_path``'s question answerer at full
    MiniLM-L6 width (``DocumentStore`` over brute-force KNN, k 6, each query's
    docs rescored by a seeded cross_encoder_l6 ``CrossEncoderReranker`` cut
    to 3, the extractive chat, ``QARestServer(serving=ServingConfig(...))``),
    run four times, each over ``n_files`` files written once the endpoint is
    up: planes off, on, on, off. Each run serves half of ``n_answers`` answers
    and ``n_retrieve`` retrievals from ``OBS_CLIENTS`` concurrent clients while
    half of ``n_new`` more files are written (each polled until retrievable),
    then a ``DecodeService`` burst of ``n_decode`` requests under
    ``decode_ext_path``'s configuration (c). The planes-on runs run under
    ``pw.run(tracing=True, chip_ledger=True, freshness=True, watchdog=True,
    with_http_server=True, monitoring_http_port=0)``; the first of them
    rebuilds the kernels into an empty directory once it is up, meets an
    overload burst of ``n_burst`` concurrent requests at an admission queue
    of ``OBS_QUEUE`` and is scraped; both run the freshness probe; the second
    profiles one window of answers, decode requests and a new file.

    Gates: every answer and hit, and every decode stream, equal the twin's;
    the ledger books a positive figure under each of ``OBS_ACCOUNTS``; over
    the profiled window each account's booked seconds are at least
    ``LEDGER_DEVICE_SHARE`` of the profiler's device-side span of its blocks
    and of its kernels' summed time, and all of them together do not exceed
    the wall; every answer carries an
    ``X-Pathway-Trace`` id whose trace holds ``OBS_STAGES`` and no span
    belongs to two requests; the burst sheds with a typed 503 and every
    admitted request is answered; the scrape holds ``OBS_METRICS`` and
    ``/status`` parses; the plane's write -> retrievable p50 lies within one
    scanner period of the polled one; the encoder's kernels, B2, B3 and B5
    launch."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.decode import DecoderConfig
    from pathway_tpu_torch.internals.chip_ledger import chip_peak_tflops
    from pathway_tpu_torch.internals.ledger import default_hbm_bytes
    from pathway_tpu_torch.xpacks.llm import rag_evals
    from pathway_tpu_torch.xpacks.llm.llms import BaseChat, _messages_to_plain
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker, rerank_topk_filter

    now = time.perf_counter
    t_phase = now()
    # the trace and flight-recorder dumps stay inside the checkout
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.environ.setdefault("PATHWAY_TRACE_DIR", os.path.join(build_dir, "observe_path_traces"))
    os.environ.setdefault("PATHWAY_FLIGHT_RECORDER_DIR", os.path.join(build_dir, "observe_path_blackbox"))
    rng = np.random.default_rng(SEED + 41)
    texts = _prose_files(rng, n_files)
    new_texts = [_unique_chunk(f"o{i}", rng) for i in range(n_new)]
    probe_texts = [_unique_chunk(f"p{i}", rng) for i in range(n_probe)]
    questions = []
    for i in rng.choice(n_files, n_answers, replace=False):
        sentences = [x.strip() for x in texts[i].split(".") if len(x.split()) >= 8]
        questions.append(sentences[int(rng.integers(0, len(sentences)))] + ".")
    retrievals = [questions[int(j)] for j in rng.choice(n_answers, n_retrieve, replace=False)]
    decode_prompts = _decode_ext_prompts(DecoderConfig().vocab_size)[:n_decode]

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

    @pw.udf
    def rerank(docs, query: str) -> pw.Json:
        # one forward a query: the reranker's own booking and span (``rerank``)
        plain = [d.value if isinstance(d, pw.Json) else d for d in (docs.value if isinstance(docs, pw.Json) else docs)]
        scores = reranker.__wrapped__([str(d["text"]) for d in plain], [query] * len(plain))
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

    parts = dict(texts=texts, embedder=embedder, chat=ExtractiveChat(), prompt=qa_prompt, store=RerankedStore)
    half_q, half_r, half_n = len(questions) // 2, len(retrievals) // 2, len(new_texts) // 2
    halves = [dict(questions=questions[:half_q], retrievals=retrievals[:half_r], new_texts=new_texts[:half_n]),
              dict(questions=questions[half_q:], retrievals=retrievals[half_r:], new_texts=new_texts[half_n:])]
    half_probe = len(probe_texts) // 2
    # off, on, on, off: each half served once with the planes off and once on,
    # the order turned round for the second half
    off1 = _obs_serve(torch, parts, on=False, decode_prompts=decode_prompts, **halves[0])
    on1 = _obs_serve(torch, parts, on=True, decode_prompts=decode_prompts, cold_build=True, burst=n_burst,
                     probe=probe_texts[:half_probe], **halves[0])
    on2 = _obs_serve(torch, parts, on=True, decode_prompts=decode_prompts, probe=probe_texts[half_probe:],
                     window=True, **halves[1])
    off2 = _obs_serve(torch, parts, on=False, decode_prompts=decode_prompts, **halves[1])
    launches = collections.Counter()
    for r in (off1, on1, on2, off2):
        launches.update(r["launches"])

    # ---- gates, outside the counted runs
    differ = _obs_same_answers(on1, off1) + _obs_same_answers(on2, off2)
    if differ:
        raise AssertionError(f"{differ} answers or retrievals with the planes on differ from the twin's")
    if any(r["streams"] != off1["streams"] for r in (on1, on2, off2)):
        raise AssertionError("a decode stream with the planes on differs from the twin's")
    missing = [k for k in ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention", "knn_topk_stream",
                           "knn_topk_merge", "paged_decode_attention") if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"observe_path never launched {missing}")
    accounts = collections.Counter()
    for r in (on1, on2):
        for a, row in r["ledger"]["accounts"].items():
            accounts[a] += row["seconds"]
    unbooked = [a for a in OBS_ACCOUNTS if accounts.get(a, 0.0) <= 0.0]
    if unbooked:
        raise AssertionError(f"the chip ledger booked nothing under {unbooked}: {dict(accounts)}")
    win = on2["window"]
    if not win["device_events"]:
        raise AssertionError("the profiled window holds no device events")
    attributed = [a for a in ("encode", "index.search", "rerank", "decode", "decode.draft", "decode.verify")
                  if win["device_s"].get(a, 0.0) > 0.0]
    if len(attributed) < 6:
        raise AssertionError(f"the profiler attributed device time to {attributed} only: {win}")
    short = {a: (win["booked_s"].get(a, 0.0), s) for part in ("device_s", "kernel_s") for a, s in win[part].items()
             if win["booked_s"].get(a, 0.0) < LEDGER_DEVICE_SHARE * s}
    if short or sum(win["booked_s"].values()) > win["wall_s"]:
        raise AssertionError(f"the ledger against the card: booked below {LEDGER_DEVICE_SHARE} of the device span "
                             f"or of the kernels' time {short}, or {sum(win['booked_s'].values())} s booked over a "
                             f"{win['wall_s']} s wall")
    span_ids: collections.Counter = collections.Counter()
    for r in (on1, on2):
        for j, (body, tid) in r["answers"].items():
            spans = r["traces"][j]
            stages = {s["stage"] for s in spans}
            if not tid or not set(OBS_STAGES) <= stages or any(s["trace"] != tid for s in spans):
                raise AssertionError(f"answer {j}'s trace {tid!r} holds {sorted(stages)}")
            span_ids.update(s["span"] for s in spans)
        if not r["result"].trace_dumps or r["result"].health is None or not r["result"].monitoring_http_port:
            raise AssertionError(f"a planes-on run's result lacks its trace dump, health or port: {r['result']}")
    if any(n > 1 for n in span_ids.values()):
        raise AssertionError("a span belongs to two requests")
    burst = on1["burst"]
    if burst["shed"] < 1 or burst["answered"] != burst["admitted"] or burst["other"] or burst["bad_answers"] or (
            burst["answered"] + burst["shed"] != burst["sent"]) or burst["shed_with_trace"] != burst["shed"]:
        raise AssertionError(f"the overload burst: {burst}")
    absent = {sec: [m for m in names if m not in on1["metrics"]] for sec, names in OBS_METRICS.items()}
    if any(absent.values()) or not isinstance(on1["status"], dict):
        raise AssertionError(f"the scrape lacks {absent}")
    probe = dict(plane_p50_s=float(np.percentile(on1["probe"]["plane_s"] + on2["probe"]["plane_s"], 50)),
                 polled_p50_s=float(np.percentile(on1["probe"]["polled_s"] + on2["probe"]["polled_s"], 50)),
                 scan_period_s=float(np.median(on1["probe"]["scan_periods_s"] + on2["probe"]["scan_periods_s"])),
                 files=n_probe)
    if abs(probe["polled_p50_s"] - probe["plane_p50_s"]) > probe["scan_period_s"]:
        raise AssertionError(f"freshness: the plane's p50 is not within one scanner period of the polled one: {probe}")
    # the decode pool's budget and the MFU peak are the card's, not a TPU's
    budget = default_hbm_bytes()
    card_bytes = torch.cuda.get_device_properties(0).total_memory if DEV != "cpu" else None
    if DEV != "cpu" and not os.environ.get("PATHWAY_HBM_BYTES") and budget != card_bytes:
        raise AssertionError(f"the decode pool's budget is {budget} bytes, the card holds {card_bytes}")

    def ledger_view(r):
        snap = r["ledger"]
        return dict(accounts={a: row["seconds"] for a, row in snap["accounts"].items()},
                    dispatches={a: row["dispatches"] for a, row in snap["accounts"].items()},
                    busy_seconds=snap["busy_seconds"], wall_seconds=snap["wall_seconds"],
                    stranded_fraction=snap["stranded_fraction"], stranded_causes=snap["stranded_causes"])

    result = dict(
        card=env["nvidia_smi"], files=n_files, answers=len(questions), retrievals=len(retrievals),
        new_files=on1["new_files"] + on2["new_files"], clients=OBS_CLIENTS,
        answers_per_s=dict(off1=off1["answers_per_s"], on1=on1["answers_per_s"], on2=on2["answers_per_s"],
                           off2=off2["answers_per_s"]),
        latency_ms=dict(off1=off1["latency"], on1=on1["latency"], on2=on2["latency"], off2=off2["latency"]),
        tokens_per_s=dict(off1=off1["tokens_per_s"], on1=on1["tokens_per_s"], on2=on2["tokens_per_s"],
                          off2=off2["tokens_per_s"]),
        ingest_seconds=dict(off1=off1["ingest_seconds"], on1=on1["ingest_seconds"], on2=on2["ingest_seconds"],
                            off2=off2["ingest_seconds"]),
        write_to_retrievable_ms=dict(on1=on1["write_to_retrievable"], on2=on2["write_to_retrievable"],
                                     off1=off1["write_to_retrievable"], off2=off2["write_to_retrievable"]),
        ledger=dict(on1=ledger_view(on1), on2=ledger_view(on2)), cold_build_seconds=on1["cold_build_seconds"],
        window=win, freshness=dict(
            on1={k: on1["freshness"]["lag"][k] for k in ("count", "p50_ms", "p99_ms")},
            on2={k: on2["freshness"]["lag"][k] for k in ("count", "p50_ms", "p99_ms")}, probe=probe),
        burst=burst, batch_sizes=dict(on1=on1["batch_sizes"], on2=on2["batch_sizes"]),
        health={tag: dict(status=r["result"].health["status"], breached={
            rule["name"]: round(rule["value"], 4) for rule in r["result"].health["rules"] if rule["level"] != "ok"})
            for tag, r in (("on1", on1), ("on2", on2))},
        decode_pool_budget_bytes=budget, card_memory_bytes=card_bytes, chip_peak_tflops=chip_peak_tflops(),
        run_seconds=dict(off1=off1["run_seconds"], on1=on1["run_seconds"], on2=on2["run_seconds"],
                         off2=off2["run_seconds"]),
        phase_seconds=now() - t_phase, launches=dict(launches),
    )
    emit("observe_path", **result)
    return dict(launches)


# ---------------------------------------------------------------- tenant_path

TENANTS = 4096  # tenants of the shared slab
TENANT_DOCS = 256  # documents a tenant
TENANT_QUERY_TENANTS = 256  # tenants the searches spread over
TENANT_SINGLES = 512  # single-query searches (B2's streaming pass)
TENANT_BATCHES = 128  # batches of TENANT_BATCH queries (B2's tensor-core pass)
TENANT_BATCH = 64
TENANT_CHECKED = 64  # tenants held against a private DeviceKnnIndex
TENANT_COLD_CHECKED = 8  # demoted tenants held (host scan, then promoted)
TENANT_SERVED = 48  # requests a served client sends
TENANT_CLIENTS = 8
TENANT_WEIGHTS = {"w1": 1.0, "w2": 2.0, "w4": 4.0}
TENANT_CAP = dict(qps=5.0, burst=2)  # the capped tenant's quota
HIT_SCORE_TOL = 1e-5  # f32 scores of one row in two indexes (other slab sizes, other sums)


def _rows_agree(got: list, want: list, tol: float = HIT_SCORE_TOL) -> bool:
    """Per query: as many hits, scores within ``tol`` rank by rank, and the
    same ids but where two scores within ``tol`` trade places (B2 sums a row
    in another order in a slab of another size)."""
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        ws = [s for _, s in w]
        for (gk, gs), (wk, wsc) in zip(g, w):
            if abs(gs - wsc) > tol:
                return False
            if gk != wk:
                ties = {k for k, s in w if abs(s - wsc) <= tol}
                if gk not in ties and not (gk not in {k for k, _ in w} and abs(gs - ws[-1]) <= tol):
                    return False
    return len(got) == len(want)


def phase_tenant_path(torch, n_tenants: int = TENANTS, per_tenant: int = TENANT_DOCS,
                      query_tenants: int = TENANT_QUERY_TENANTS, n_singles: int = TENANT_SINGLES,
                      n_batches: int = TENANT_BATCHES, batch: int = TENANT_BATCH, n_checked: int = TENANT_CHECKED,
                      n_cold: int = TENANT_COLD_CHECKED, served: int = TENANT_SERVED,
                      clients: int = TENANT_CLIENTS) -> dict:
    """The tenant-packed slab at MiniLM-L6 width (d 384, f32, cos):
    ``n_tenants`` x ``per_tenant`` documents (keys 0..per_tenant-1 in every
    tenant) in one ``TenantPackedIndex``; single queries and batches over
    ``query_tenants`` tenants (B2's two regimes under the tenant mask), each
    result checked against the tenant's own rows on the host and, for
    ``n_checked`` tenants, against a private ``DeviceKnnIndex``; a demotion
    schedule sends the never-searched tenants to the host, whose exact
    host-scan answers and answers after promotion are held too; then
    ``rest_connector(serving=)`` under ``pw.run(tenancy=)`` with tenants of
    weight 1, 2 and 4 and one capped at a small QPS, ``clients`` clients
    sending at once: the capped tenant's sheds are typed 429
    ``tenant_rate_limited`` and every other answer equals a library replay.
    The ``index.tenant`` ledger account reconciles exactly against
    ``index.hot``."""
    import concurrent.futures
    import socket
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch.nn.functional as F

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DeviceKnnIndex
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.internals.ledger import LEDGER, hot_row_bytes
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.tenancy import TENANCY_METRICS, TenantPackedIndex, use_tenancy

    t_phase = time.perf_counter()
    now = time.perf_counter
    dim, k = 384, 10
    rng = np.random.default_rng(SEED + 30)
    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    LEDGER.reset()
    TENANCY_METRICS.reset()
    rows = n_tenants * per_tenant
    docs = F.normalize(torch.randn(rows, dim, device=DEV, generator=g), dim=1).cpu().numpy()
    tenant_docs = lambda t: docs[t * per_tenant:(t + 1) * per_tenant]  # noqa: E731
    name = lambda t: f"t{t}"  # noqa: E731
    slab = TenantPackedIndex(dim, reserved_space=rows, name="tenant-slab", device=DEV)
    t0 = now()
    for t in range(n_tenants):
        slab.add_tenant_batch(name(t), list(range(per_tenant)), tenant_docs(t))
    add_s = now() - t0
    if len(slab) != rows or slab.capacity != rows:
        raise AssertionError(f"the slab holds {len(slab)} rows in {slab.capacity}")

    stride = n_tenants // query_tenants
    searched = [t * stride for t in range(query_tenants)]
    checked = searched[:n_checked]

    def queries_for(t, n):
        picks = rng.integers(0, per_tenant, n)
        return (tenant_docs(t)[picks] + 0.3 * rng.standard_normal((n, dim)).astype(np.float32)).astype(np.float32)

    def own_scores(t, q, res):
        """Every hit is one of the tenant's own rows at its own score."""
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        for qi, row in enumerate(res):
            if len(row) != k:
                return False
            for key, score in row:
                if abs(float(qn[qi] @ tenant_docs(t)[key]) - score) > 1e-4:
                    return False
        return True

    plan = [(searched[i % query_tenants], 1) for i in range(n_singles)]
    plan += [(searched[(i * 2) % query_tenants], batch) for i in range(n_batches)]
    qsets = [(t, queries_for(t, n)) for t, n in plan]
    slab.search_tenant_batch(searched[0], qsets[0][1], k)  # uploads the slab (not timed)
    torch.cuda.synchronize()
    _build.reset_launches()
    results, lat_single, lat_batch = [], [], []
    t0 = now()
    for t, q in qsets:
        t1 = now()
        res = slab.search_tenant_batch(name(t), q, k)
        (lat_single if len(q) == 1 else lat_batch).append((now() - t1) * 1e3)
        results.append(res)
    search_s = now() - t0
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    crossed = [i for i, ((t, q), res) in enumerate(zip(qsets, results)) if not own_scores(t, q, res)]
    private = {}
    for t in checked:
        idx = DeviceKnnIndex(dim, reserved_space=per_tenant, device=DEV)
        idx.add_batch_arrays(list(range(per_tenant)), tenant_docs(t))
        private[t] = idx
    held_private = [i for i, (t, q) in enumerate(qsets) if t in private]
    disagree = [i for i in held_private if not _rows_agree(results[i], private[qsets[i][0]].search_batch(qsets[i][1], k))]

    # demotion: every never-searched tenant goes to the host at the first sweep
    never = [t for t in range(n_tenants) if t % stride][:n_cold]
    cold_private = {}
    for t in never:
        idx = DeviceKnnIndex(dim, reserved_space=per_tenant, device=DEV)
        idx.add_batch_arrays(list(range(per_tenant)), tenant_docs(t))
        cold_private[t] = idx
    t0 = now()
    with use_tenancy("demote_every=16,demote_below=0.3"):
        probe = queries_for(checked[0], 1)
        for _ in range(16):
            slab.search_tenant_batch(name(checked[0]), probe, k)
        demote_s = now() - t0
        cold_count = sum(slab.tenant_is_cold(name(t)) for t in range(n_tenants))
        cold_ok, promoted_ok = [], []
        for t in never:
            q = queries_for(t, 4)
            was_cold = slab.tenant_is_cold(name(t))
            host = slab.search_tenant_batch(name(t), q, k)  # the first hit: the exact host scan
            back = slab.search_tenant_batch(name(t), q, k)  # the second hit promoted it
            want = cold_private[t].search_batch(q, k)
            cold_ok.append(was_cold and _rows_agree(host, want))
            promoted_ok.append(not slab.tenant_is_cold(name(t)) and _rows_agree(back, want))
    slab._publish_metrics()
    row_b = hot_row_bytes(dim)
    hot_row = LEDGER._rows.get(("index.hot", slab.name))
    tenant_rows = [v for (acct, owner), v in LEDGER._rows.items()
                   if acct == "index.tenant" and owner.startswith(slab.name + "/")]
    hot_bytes = hot_row[0] if hot_row else 0
    tenant_bytes = sum(v[0] for v in tenant_rows)

    # the served part: one endpoint, the tenant in the header and the body
    weights = dict(TENANT_WEIGHTS)
    spec = {"quotas": {**{t: {"weight": w} for t, w in weights.items()},
                       "capped": {"qps": TENANT_CAP["qps"], "burst": TENANT_CAP["burst"]}}}
    served_tenants = list(weights) + ["capped"]
    # the served tenants first in the registry: its first 50 tenants keep
    # their own series, later ones fold into tenant="other"
    TENANCY_METRICS.reset()
    for i, t in enumerate(served_tenants):  # the served tenants' rows: those of 4 searched tenants
        slab.add_tenant_batch(t, list(range(per_tenant)), tenant_docs(searched[i]))
    qbank = {t: queries_for(searched[i], served) for i, t in enumerate(served_tenants)}

    port, mport = _free_port(), _free_port()
    pw.clear_graph()
    q, writer = pw.io.http.rest_connector(
        host="127.0.0.1", port=port, schema=pw.schema_from_types(tenant=str, qi=int),
        serving=pw.serving.ServingConfig(max_queue=256, batch_max=64, batch_window_ms=2.0,
                                         latency_budget_ms=60_000.0, query_share=1.0))

    def answer(tenant: str, qi: int) -> pw.Json:
        hits = slab.search_tenant_batch(tenant, qbank[tenant][qi][None, :], k)[0]
        return pw.Json([[int(key), float(score)] for key, score in hits])

    writer(q.select(result=pw.apply_with_type(answer, pw.Json, pw.this.tenant, pw.this.qi)))
    runners = []
    real_init = GraphRunner.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    def post(tenant, qi):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=json.dumps({"tenant": tenant, "qi": qi}).encode(),
                                     headers={"Content-Type": "application/json", "X-Pathway-Tenant": tenant})
        t1 = now()
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return tenant, qi, resp.status, json.loads(resp.read().decode()), (now() - t1) * 1e3
        except urllib.error.HTTPError as e:
            return tenant, qi, e.code, json.loads(e.read().decode()), (now() - t1) * 1e3

    def client(c):
        return [post(served_tenants[(c + j) % len(served_tenants)], (c * served + j) % served) for j in range(served)]

    out: dict = {}
    GraphRunner.__init__ = recording_init
    try:
        _build.reset_launches()
        run = threading.Thread(target=lambda: out.update(r=pw.run(
            tenancy=spec, chip_ledger=True, with_http_server=True, monitoring_http_port=mport)), daemon=True)
        run.start()
        for _ in range(600):
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=1):
                    break
            except OSError:
                time.sleep(0.05)
        t0 = now()
        with concurrent.futures.ThreadPoolExecutor(clients) as ex:
            replies = [r for rs in ex.map(client, range(clients)) for r in rs]
        serve_s = now() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=60) as resp:
            scrape = resp.read().decode()
    finally:
        if runners:
            runners[-1].engine.stop()
        GraphRunner.__init__ = real_init
    run.join(timeout=120)
    pw.clear_graph()
    torch.cuda.synchronize()
    served_launches = dict(_build.LAUNCHES)
    if run.is_alive() or "r" not in out:
        raise AssertionError("the served tenant run did not end cleanly")
    shed = [r for r in replies if r[2] != 200]
    ok = [r for r in replies if r[2] == 200]
    bad_sheds = [r for r in shed if r[0] != "capped" or r[2] != 429 or r[3].get("reason") != "tenant_rate_limited"]
    replay_bad = [r for r in ok if r[3] != [[int(kk), float(s)] for kk, s in
                                           slab.search_tenant_batch(r[0], qbank[r[0]][r[1]][None, :], k)[0]]]

    def series(metric, tenant):
        for line in scrape.splitlines():
            if line.startswith(f'{metric}{{tenant="{tenant}"'):
                return float(line.rsplit(" ", 1)[1])
        return None

    chip_share = {t: {"weight": weights.get(t), "served": sum(1 for r in ok if r[0] == t),
                      "serving_chip_seconds": series("pathway_serving_tenant_chip_seconds_total", t),
                      "chip_ledger_seconds": series("pathway_chip_tenant_seconds_total", t)}
                  for t in served_tenants}

    # ---- gates
    missing = [key for key in ("knn_topk_stream", "knn_topk_tc", "knn_topk_merge") if launches.get(key, 0) == 0]
    if missing or served_launches.get("knn_topk_stream", 0) == 0:
        raise AssertionError(f"tenant_path never launched {missing} (served: {served_launches})")
    if crossed or disagree:
        raise AssertionError(f"tenant searches crossed tenants ({len(crossed)}) or left their private indexes "
                             f"({len(disagree)} of {len(held_private)})")
    if not (all(cold_ok) and all(promoted_ok)) or cold_count < n_tenants - query_tenants:
        raise AssertionError(f"demotion: {cold_count} tenants cold, host scans {cold_ok}, promoted {promoted_ok}")
    if hot_bytes != slab.capacity * row_b or tenant_bytes != hot_bytes:
        raise AssertionError(f"index.tenant {tenant_bytes} bytes against index.hot {hot_bytes}")
    capped = [r for r in replies if r[0] == "capped"]
    if bad_sheds or replay_bad or not any(r[2] == 429 for r in capped):
        raise AssertionError(f"served: {len(bad_sheds)} untyped sheds, {len(replay_bad)} answers off the replay, "
                             f"{sum(r[2] == 429 for r in capped)} of {len(capped)} capped requests shed")
    result = dict(
        tenants=n_tenants, docs_per_tenant=per_tenant, slab_rows=slab.capacity, slab_bytes=slab.capacity * row_b,
        add_seconds=add_s, search_seconds=search_s, single=_percentiles(lat_single),
        batch_of_64=_percentiles(lat_batch), singles=len(lat_single), batches=len(lat_batch),
        tenants_held_private=len(checked), results_held_private=len(held_private), crossed=len(crossed),
        demote_seconds=demote_s, cold_tenants=cold_count, cold_held=len(never),
        index_tenant_bytes=tenant_bytes, index_hot_bytes=hot_bytes,
        served_requests=len(replies), served_ok=len(ok), shed_429=len(shed), serve_seconds=serve_s,
        served_p50_ms=_percentiles([r[4] for r in ok])["p50_ms"], per_tenant=chip_share,
        launches=launches, served_launches=served_launches, phase_seconds=time.perf_counter() - t_phase,
    )
    emit("tenant_path", **result)
    launches = collections.Counter(launches)
    launches.update(served_launches)
    return dict(launches)


# ------------------------------------------------------------------ tier_path

TIER_DOCS = 1 << 20
TIER_HOT = 1 << 17
TIER_CLUSTERS = 256
TIER_PROBE = 16
TIER_GROUP = 10  # documents of one near-duplicate group (chunks of one source)
TIER_SINGLES = 64  # 1,024 until the thirteenth path, 512 until the fourteenth, 256 until the fifteenth, 128 until the twenty-first needed the time
TIER_BATCHES = 8
TIER_BATCH = 256
TIER_SELF = 4096
TIER_RECALL_FLOOR = 0.95  # the reference's floor (tests/test_tiered_index.py)
TIER_RESCORE_TOL = 1e-5  # a rescore against the same rows copied afresh (f32)


def phase_tier_path(torch, n_docs: int = TIER_DOCS, hot_rows: int = TIER_HOT, n_clusters: int = TIER_CLUSTERS,
                    n_probe: int = TIER_PROBE, n_singles: int = TIER_SINGLES, n_batches: int = TIER_BATCHES,
                    batch: int = TIER_BATCH, n_self: int = TIER_SELF) -> dict:
    """The tiered index at MiniLM-L6 width (d 384, cos): ``n_docs``
    documents drawn round ``n_clusters`` Gaussian centres, in groups of
    ``TIER_GROUP`` near-duplicates, into a ``TieredKnnIndex`` with an int8
    cold tier on the host, ``hot_rows`` hot rows on the card (B2) and
    ``n_probe`` probed clusters; ``n_singles`` single queries and
    ``n_batches`` batches of ``batch`` on Zipf-skewed clusters (promotion has
    work), one forced demote and promote cycle, then every document demoted
    (the int8 recall floor). Every cold rescore is checked against the same
    rows copied afresh (the staging ring's check); recall@10 against an exact
    f32 scan on the card; a second index with every document hot equals
    ``DeviceKnnIndex.search_batch`` exactly."""
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch import DeviceKnnIndex
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.index_metrics import INDEX_METRICS
    from pathway_tpu_torch.ops.knn import _topk_lower_index
    from pathway_tpu_torch.ops.tiered_knn import TierConfig, TieredKnnIndex, cold_scores

    t_phase = time.perf_counter()
    now = time.perf_counter
    dim, k = 384, 10
    rng = np.random.default_rng(SEED + 40)
    g = torch.Generator(device=DEV).manual_seed(SEED + 40)
    n_groups = -(-n_docs // TIER_GROUP)
    centres = torch.randn(n_clusters, dim, device=DEV, generator=g)
    group_cluster = torch.randint(0, n_clusters, (n_groups,), device=DEV, generator=g)
    groups = centres[group_cluster] + 0.5 * torch.randn(n_groups, dim, device=DEV, generator=g)
    group_of = torch.arange(n_docs, device=DEV) // TIER_GROUP
    docs_dev = F.normalize(groups[group_of] + 0.25 * torch.randn(n_docs, dim, device=DEV, generator=g), dim=1)
    docs = docs_dev.cpu().numpy()
    cluster_groups = [np.nonzero(group_cluster.cpu().numpy() == c)[0] for c in range(n_clusters)]
    groups_h = groups.cpu().numpy()
    zipf = 1.0 / np.arange(1, n_clusters + 1) ** 1.1
    cluster_rank = rng.permutation(n_clusters)

    def queries(n):
        cs = cluster_rank[rng.choice(n_clusters, n, p=zipf / zipf.sum())]
        gs = np.asarray([rng.choice(cluster_groups[c]) for c in cs])
        return (groups_h[gs] + 0.25 * rng.standard_normal((n, dim))).astype(np.float32)

    def exact(q):
        qd = F.normalize(torch.from_numpy(q).to(DEV), dim=1)
        return _topk_lower_index(qd @ docs_dev.T, k)[1].cpu().numpy()

    def recall(q, res):
        truth = exact(q)
        return float(np.mean([len(set(truth[i].tolist()) & {kk for kk, _ in res[i]}) / k for i in range(len(q))]))

    INDEX_METRICS.reset()
    tier = TieredKnnIndex(dim, reserved_space=n_docs, name="tiered", device=DEV,
                          tiers=TierConfig(hot_rows=hot_rows, n_clusters=n_clusters, n_probe=n_probe,
                                           cold_dtype="int8"))
    t0 = now()
    step = 1 << 16
    for lo in range(0, n_docs, step):
        tier.add_batch_arrays(list(range(lo, min(n_docs, lo + step))), docs[lo:lo + step])
    ingest_s = now() - t0
    if tier.hot_docs() != hot_rows or tier.cold_docs() != n_docs - hot_rows:
        raise AssertionError(f"{tier.hot_docs()} hot and {tier.cold_docs()} cold documents")
    cold_host_bytes = tier._cold._q.nbytes + tier._cold._scale.nbytes

    rescore_err = []
    real_score = tier._cold_score

    def checked_score(q, payload):
        got = real_score(q, payload)
        fresh = [torch.from_numpy(np.array(a, copy=True)).to(DEV) for a in payload]
        docs_f = fresh[0].to(torch.float32) * (fresh[1] / 127.0)[:, None]
        want = cold_scores("cos", torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(DEV), docs_f)
        rescore_err.append(held("cold rescore", got, want, rtol=0.0, atol=TIER_RESCORE_TOL))
        return got

    tier._cold_score = checked_score
    singles = queries(n_singles)
    batches = [queries(batch) for _ in range(n_batches)]
    tier.search_batch(singles[:1], k)  # uploads the hot slab (not timed)
    torch.cuda.synchronize()
    _build.reset_launches()
    lat, res_single = [], []
    t0 = now()
    for i in range(n_singles):
        t1 = now()
        res_single.append(tier.search_batch(singles[i:i + 1], k)[0])
        lat.append((now() - t1) * 1e3)
    single_s = now() - t0
    res_batches, batch_ms = [], []
    for q in batches:
        t1 = now()
        res_batches.append(tier.search_batch(q, k))
        batch_ms.append((now() - t1) * 1e3)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    snap = INDEX_METRICS.snapshot()
    tiers_snap = dict(snap["indexes"]["tiered"]["tiers"])
    fetch = snap["cold_fetch_seconds"]
    traffic_recall = recall(np.concatenate([singles] + batches),
                            res_single + [r for rb in res_batches for r in rb])
    dups = sum(len(row) != len({kk for kk, _ in row}) for row in res_single + [r for rb in res_batches for r in rb])

    # one forced demote and promote cycle on the most queried hot cluster
    hot_clusters = [c for c in np.argsort(-tier._hits) if len(tier._members[c]) > len(tier._cold_keys[c])]
    c = int(hot_clusters[0])
    promos, demos = tiers_snap["promotions"], tiers_snap["demotions"]
    moved = tier.force_demote([c])
    gs = cluster_groups[c]
    for _ in range(2):
        tier.search_batch((groups_h[rng.choice(gs, batch)] + 0.25 * rng.standard_normal((batch, dim))
                           ).astype(np.float32), k)
    tier.maybe_rebalance(force=True)
    cyc = INDEX_METRICS.snapshot()["indexes"]["tiered"]["tiers"]
    cycled = moved > 0 and cyc["demotions"] > demos and cyc["promotions"] > promos
    # every key still found after the cycle: self-queries
    sample = rng.choice(n_docs, n_self, replace=False)
    lost = 0
    for lo in range(0, n_self, batch):
        ids = sample[lo:lo + batch]
        res = tier.search_batch(docs[ids], k)
        lost += sum(int(i) not in {kk for kk, _ in row} for i, row in zip(ids, res))
    # every document demoted: the int8 recall floor
    tier.force_demote()
    demoted_q = np.concatenate([queries(batch), queries(batch)])
    demoted_res = tier.search_batch(demoted_q[:batch], k) + tier.search_batch(demoted_q[batch:], k)
    demoted_recall = recall(demoted_q, demoted_res)
    ring = tier._cold_ring.stats()

    # a second index with every document hot equals the flat index exactly
    n_hot = min(hot_rows, n_docs)
    all_hot = TieredKnnIndex(dim, reserved_space=n_hot, device=DEV,
                             tiers=TierConfig(hot_rows=n_hot, n_clusters=n_clusters, n_probe=n_probe))
    flat = DeviceKnnIndex(dim, reserved_space=n_hot, device=DEV)
    all_hot.add_batch_arrays(list(range(n_hot)), docs[:n_hot])
    flat.add_batch_arrays(list(range(n_hot)), docs[:n_hot])
    hq = queries(batch)
    same = all_hot.cold_docs() == 0 and all(
        all_hot.search_batch(hq[i:i + 1], k) == flat.search_batch(hq[i:i + 1], k) for i in range(64)
    ) and all_hot.search_batch(hq, k) == flat.search_batch(hq, k)

    # ---- gates
    missing = [key for key in ("knn_topk_stream", "knn_topk_merge") if launches.get(key, 0) == 0]
    if missing:
        raise AssertionError(f"tier_path never launched {missing}")
    if dups or lost or not cycled or not same:
        raise AssertionError(f"tier_path: {dups} results with a key twice, {lost} of {n_self} self-queries lost, "
                             f"cycle {cycled} (moved {moved}), all-hot equal to flat {same}")
    if demoted_recall < TIER_RECALL_FLOOR or not rescore_err:
        raise AssertionError(f"int8 recall@10 under forced demotion {demoted_recall} < {TIER_RECALL_FLOOR}")
    result = dict(
        docs=n_docs, hot_rows=hot_rows, clusters=n_clusters, probe=n_probe, cold_host_bytes=cold_host_bytes,
        ingest_seconds=ingest_s, single=_percentiles(lat), singles_per_s=n_singles / single_s,
        batch_of_256_ms=batch_ms, recall_at_10=traffic_recall, demoted_recall_at_10=demoted_recall,
        hot_hit_ratio=tiers_snap["hot_hit_ratio"], promotions=tiers_snap["promotions"],
        demotions=tiers_snap["demotions"], cold_fetch_seconds=fetch.get("sum"), cold_fetches=fetch.get("count"),
        cycle_moved=moved, self_queries=n_self, self_lost=lost, rescores_checked=len(rescore_err),
        rescore_max_abs_err=max(rescore_err), ring=ring, launches=launches,
        phase_seconds=time.perf_counter() - t_phase,
    )
    emit("tier_path", **result)
    return launches


# -------------------------------------------------------------- profile_phase

PROFILE_DOCS = 16_384
PROFILE_QUERIES = 64


def phase_profile(torch, n_docs: int = PROFILE_DOCS, n_queries: int = PROFILE_QUERIES) -> dict:
    """``engine_path``'s pipeline, the embedder as a UDF column of its own,
    under ``pw.run(profile=path, chip_ledger=True)`` with
    ``PATHWAY_JOURNAL_DIR`` set: ``n_docs`` streamed documents,
    ``n_queries`` single text queries and a batch of as many. The Chrome trace must parse and carry self-times for the
    connector, the embedder's UDF and the index; ``ENCODER_KERNEL_STATS``
    its pad fraction and achieved TFLOP/s (the encode MFU against the
    card's 989 TFLOP/s bf16 peak); ``python -m pathway_tpu_torch top --once``
    and ``perf snapshot`` run on the journal in a subprocess and exit 0."""
    import shutil

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.chip_ledger import CHIP_LEDGER
    from pathway_tpu_torch.internals.profiler import ENCODER_KERNEL_STATS
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.perf.journal import get_journal

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile_phase")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    journal_dir, trace_path = os.path.join(root, "journal"), os.path.join(root, "profile.json")
    rng = np.random.default_rng(SEED + 50)
    texts = _synthetic_texts_bulk(rng, n_docs, 20, 220)
    singles = _synthetic_texts(rng, n_queries, 5, 40)
    batch_q = _synthetic_texts(rng, n_queries, 5, 40)
    embedder = pw.xpacks.llm.embedders.SentenceTransformerEmbedder()
    embedder(["warm up the encoder"])
    prev = os.environ.get("PATHWAY_JOURNAL_DIR")
    os.environ["PATHWAY_JOURNAL_DIR"] = journal_dir
    try:
        torch.cuda.synchronize()
        ENCODER_KERNEL_STATS.reset()
        CHIP_LEDGER.reset()
        _build.reset_launches()
        answers, ingest_s, run_s = _stream_and_query(torch, pw, embedder, texts, singles, batch_q, 1024,
                                                     embed_in_udf=True, profile=trace_path, chip_ledger=True)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        enc = ENCODER_KERNEL_STATS.snapshot()
        chip = CHIP_LEDGER.snapshot()
        journal = get_journal(journal_dir)
        journal.append("bench", {"suite": "chip_smoke.profile_phase", "records": [
            {"metric": "profile_phase_docs_per_s", "value": n_docs / ingest_s, "unit": "docs/s"},
            {"metric": "profile_phase_run_s", "value": run_s, "unit": "s"}],
            "headline": {"metric": "encode_achieved_tflops", "value": enc["achieved_tflops"], "unit": "TFLOP/s"}})
    finally:
        if prev is None:
            os.environ.pop("PATHWAY_JOURNAL_DIR", None)
        else:
            os.environ["PATHWAY_JOURNAL_DIR"] = prev
    with open(trace_path) as fh:
        trace = json.load(fh)
    self_ms: dict[str, float] = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "operator":
            self_ms[e["name"]] = self_ms.get(e["name"], 0.0) + e["dur"] / 1e3
    cli = {}
    for cmd in (["top", "--once", "--journal", journal_dir], ["perf", "snapshot", "--journal", journal_dir]):
        proc = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", *cmd], capture_output=True, text=True,
                              timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
        cli[cmd[0]] = {"rc": proc.returncode, "stdout_lines": len(proc.stdout.splitlines()),
                       "stderr": proc.stderr[-400:]}
    mfu = chip.get("encode_mfu") or {}

    # ---- gates
    want_ops = {"connector": ("SessionSourceNode",), "embedder": ("BatchApply", "AsyncApply"),
                "index": ("ExternalIndex",)}
    found = {role: sorted(n for n in self_ms if any(p in n for p in pats)) for role, pats in want_ops.items()}
    missing = [key for key in ("gemm_bias_act", "knn_topk_stream", "knn_topk_merge") if launches.get(key, 0) == 0]
    if missing or not all(found.values()):
        raise AssertionError(f"profile_phase: launches missing {missing}; operators found {found} in {sorted(self_ms)}")
    if not (enc["dispatches"] and 0.0 <= enc["pad_fraction"] < 1.0 and enc["achieved_tflops"] > 0 and mfu):
        raise AssertionError(f"profile_phase: encoder statistics {enc}, encode MFU {mfu}")
    if any(v["rc"] != 0 for v in cli.values()) or len(answers) != 2 * n_queries:
        raise AssertionError(f"profile_phase: CLI {cli}, {len(answers)} answers")
    result = dict(
        docs=n_docs, queries=2 * n_queries, ingest_seconds=ingest_s, run_seconds=run_s,
        trace_events=len(trace["traceEvents"]), operators_found=found,
        operator_self_ms={n: round(v, 3) for n, v in sorted(self_ms.items(), key=lambda kv: -kv[1])[:12]},
        encoder=enc, encode_mfu=mfu, cli=cli, launches=launches, phase_seconds=time.perf_counter() - t_phase,
    )
    emit("profile_phase", **result)
    return launches


# recovery_path: persistence, recovery and the overlapped epoch pipeline at
# engine_path's width. Documents, epoch size, the crash point, the queries C
# answers, the snapshot interval; the in-process restart's documents, queries
# and the epoch its chaos rule raises at; the pipeline runs' documents and
# queries and the depth / ingest-worker settings in run order; the decode
# requests and the steps decode.step raises at
# 131,072 documents, killed at 65,536, until the fifteenth path needed the time
RECOVERY_DOCS, RECOVERY_EPOCH, RECOVERY_KILL_AT, RECOVERY_QUERIES = 65_536, 1024, 32_768, 256
RECOVERY_SNAPSHOT_MS = 2000
RECOVERY_RESTART_DOCS, RECOVERY_RESTART_QUERIES, RECOVERY_CHAOS_EPOCH = 32_768, 32, 12
RECOVERY_PIPE_DOCS, RECOVERY_PIPE_QUERIES = 32_768, 32
RECOVERY_PIPE_RUNS = ((1, 0), (2, 0), (1, 0), (2, 0), (2, 4))
RECOVERY_DECODE_REQUESTS, RECOVERY_CHAOS_STEPS = 16, (2, 7)
RECOVERY_DECODE_MODES = (("greedy", ""), ("sampled", DECODE_EXT_SAMPLED), ("spec_prompt_lookup", ",spec=4,draft=2,ngram=3"))
RECOVERY_CHILD_TIMEOUT = 300.0
RECOVERY_TINY = None  # a tiny EncoderConfig's keywords: the CPU rehearsal's stand-in for MiniLM-L6 (children too)


@functools.lru_cache(maxsize=2)
def _recovery_corpus(n_docs: int, n_queries: int) -> tuple[list, list]:
    """The documents (``_synthetic_texts_bulk``, 20-220 words) and the
    single queries (half of them documents of the corpus, half new text).
    Drawn once a process (8 s at 131,072 documents); a child reads the
    parent's draw from the file ``RECOVERY_CORPUS`` names when it is set."""
    import numpy as np

    path = os.environ.get("RECOVERY_CORPUS")
    if path:
        import pickle

        with open(path, "rb") as f:
            texts, queries = pickle.load(f)
        if len(texts) == n_docs and len(queries) == n_queries:
            return texts, queries

    rng = np.random.default_rng(SEED + 17)
    texts = _synthetic_texts_bulk(rng, n_docs, 20, 220)
    own = rng.choice(n_docs, n_queries // 2, replace=False)
    queries = [texts[i] for i in own] + _synthetic_texts(rng, n_queries - len(own), 5, 40)
    return texts, queries


def _recovery_embedder():
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    embedder = SentenceTransformerEmbedder(device=DEV)
    if RECOVERY_TINY is not None:  # the CPU rehearsal: a tiny encoder of the same code
        from pathway_tpu_torch.models.sentence_encoder import SentenceEncoder

        embedder._encoder = SentenceEncoder(config=EncoderConfig(**RECOVERY_TINY), device=DEV)
    return embedder


def _recovery_graph(pw, texts: list, queries: list, per_epoch: int, *, pace: str = "delivered", sink=None,
                    answers_out=None, on_ingested=None, persistent: bool = True, embedder=None) -> dict:
    """Build the recovery pipeline in the global graph and return its state:
    ``pw.io.python.read`` of the documents (``persistent_id="docs"``, offsets:
    a restarted subject resumes at the ``__seq__`` bookmark, one commit of
    ``per_epoch`` documents an epoch) -> ``DataIndex(BruteForceKnn(
    embedder=SentenceTransformerEmbedder()))`` <- single text queries (a
    second persistent source, one query an epoch once every document was
    delivered) -> ``pw.io.subscribe``. ``pace``: ``"delivered"`` commits an
    epoch once the last one reached the sink, ``"drained"`` once the engine
    took the last commit (so the overlapped pipeline can run ahead while
    each commit stays one epoch). ``sink``: a file that gets each delivered
    document's id (flushed at each epoch's end, before the delivered
    marker); ``answers_out``: one JSON line an answer. ``on_ingested``:
    called in the query subject's thread once ingest is complete, before
    the queries. ``embedder``: a ``SentenceTransformerEmbedder`` to reuse
    (a new one by default)."""
    import threading

    n_docs = len(texts)
    mono = time.monotonic
    cv = threading.Condition()
    state = {"rows": 0, "delivered": [], "log": [], "answers": {}, "attempts": 0, "t_first": None, "epochs": set(),
             "pending": []}

    def wait(ctx, cond) -> bool:
        """Wait for ``cond`` (under ``cv``); False once the engine stopped."""
        with cv:
            while not cond():
                if ctx.wait_stopped(0):
                    return False
                cv.wait(0.05)
        return True

    class Documents(pw.io.python.ConnectorSubject):
        supports_offsets = True

        def run(self):
            ctx = self._ctx  # this attempt's context: a restarted run hands the subject a new one
            start = int(ctx.offsets.get("__seq__", 0))
            with cv:
                state["attempts"] += 1
                state["rows"] = start  # rows at or below the recovered frontier were delivered before
                state["pending"] = []
            for b in range(start, n_docs, per_epoch):
                e = min(n_docs, b + per_epoch)
                ctx.insert_batch({"doc_id": list(range(b, e)), "text": texts[b:e]})
                ctx.commit()
                if pace == "drained":
                    ok = wait(ctx, lambda: not ctx.session.pending())
                else:
                    ok = wait(ctx, lambda e=e: state["rows"] >= e)
                if not ok:
                    return

    class Queries(pw.io.python.ConnectorSubject):
        supports_offsets = True

        def run(self):
            ctx = self._ctx
            if not wait(ctx, lambda: state["rows"] >= n_docs):
                return
            if on_ingested is not None:
                on_ingested(state)
            for i in range(int(ctx.offsets.get("__seq__", 0)), len(queries)):
                ctx.insert_batch({"qid": [i], "text": [queries[i]]})
                ctx.commit()
                if not wait(ctx, lambda i=i: i in state["answers"]):
                    return

    def on_doc(key, row, time, is_addition):  # (``time``: the epoch)
        if state["t_first"] is None:
            state["t_first"] = mono()
        state["delivered"].append(row["doc_id"])
        state["log"].append((time, row["doc_id"], int(is_addition)))
        state["epochs"].add(time)
        state["pending"].append(row["doc_id"])

    def on_epoch_end(time):
        # one write an epoch, flushed before the engine marks it delivered
        if sink is not None and state["pending"]:
            sink.write("".join(f"{d}\n" for d in state["pending"]))
            sink.flush()
        with cv:
            state["rows"] += len(state["pending"])
            state["pending"] = []
            cv.notify_all()

    def on_answer(key, row, time, is_addition):
        hits = [[int(i), float(s)] for i, s in zip(row["ids"], row["scores"])]
        if answers_out is not None:
            answers_out.write(json.dumps({"qid": row["qid"], "hits": hits}) + "\n")
            answers_out.flush()
        with cv:
            state["answers"][row["qid"]] = hits
            cv.notify_all()

    class DocSchema(pw.Schema, append_only=True):
        doc_id: int
        text: str

    class QuerySchema(pw.Schema, append_only=True):
        qid: int
        text: str

    embedder = embedder or _recovery_embedder()
    docs = pw.io.python.read(Documents(), schema=DocSchema, autocommit_duration_ms=None,
                             persistent_id="docs" if persistent else None)
    qs = pw.io.python.read(Queries(), schema=QuerySchema, autocommit_duration_ms=None,
                           persistent_id="queries" if persistent else None)
    index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(
        docs.text, dimensions=embedder.get_embedding_dimension(), reserved_space=n_docs, embedder=embedder,
        device=DEV))
    replies = index.query_as_of_now(qs.text, number_of_matches=10)
    answers = replies.select(qid=qs.qid, ids=pw.this.doc_id, scores=pw.this._pw_index_reply_score)
    pw.io.subscribe(docs, on_doc, on_time_end=on_epoch_end)
    pw.io.subscribe(answers, on_answer)
    state["embedder"] = embedder
    return state


def _index_rows(index) -> tuple:
    """(sorted keys, their rows of the index's device matrix on the host)."""
    import numpy as np

    keys = sorted(index._slot_of)
    slots = [index._slot_of[k] for k in keys]
    rows = index._dev_matrix[slots].float().cpu().numpy() if keys else np.zeros((0, index.dim), np.float32)
    return np.asarray([int(k) for k in keys], np.uint64), rows


def _recovery_child(spec_json: str) -> int:
    """One run of the recovery pipeline in a process of its own (the
    crash-and-recover part of ``recovery_path``): A (uninterrupted, writes
    its index rows), B (the parent SIGKILLs it mid-stream) or C (restarts on
    B's root, holds its index rows against A's, answers the queries) per
    ``spec``; the report goes to ``spec["report"]`` as JSON."""
    global DEV, RECOVERY_TINY
    spec = json.loads(spec_json)
    DEV, RECOVERY_TINY = spec["dev"], spec.get("tiny")
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DeviceKnnIndex
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.engine.persistence import EnginePersistence
    from pathway_tpu_torch.internals.chip_ledger import CHIP_LEDGER
    from pathway_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = DEV != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    texts, queries = _recovery_corpus(spec["n_docs"], spec["n_queries"])
    report: dict = {"role": spec["role"]}
    marks: dict = collections.defaultdict(float)
    indexes: list = []
    real = {
        "init": DeviceKnnIndex.__init__, "add": DeviceKnnIndex.add_batch_device,
        "src": EnginePersistence.recover_source, "snap": EnginePersistence.recover_operator_snapshot,
        "setup": df.EngineGraph._setup_persistence, "restore": df.ExternalIndexNode.restore_state,
        "pass": df.EngineGraph._topo_pass,
    }

    def init(self, *a, **kw):
        real["init"](self, *a, **kw)
        indexes.append(self)

    def add(self, keys, vecs, metas=None):
        if not marks.get("restoring"):
            return real["add"](self, keys, vecs, metas)
        sync()
        t0 = time.monotonic()
        out = real["add"](self, keys, vecs, metas)
        sync()
        marks["restore_add_s"] += time.monotonic() - t0
        return out

    def timed_read(name):
        def wrapped(self, *a, **kw):
            t0 = time.monotonic()
            try:
                return real[name](self, *a, **kw)
            finally:
                marks["read_s"] += time.monotonic() - t0
        return wrapped

    def setup(self):
        marks["t_setup0"] = time.monotonic()
        real["setup"](self)
        marks["t_setup1"] = time.monotonic()
        report["replay_frontier"] = int(self.replay_frontier)
        report["snapshot_time"] = int(self._opsnap_time)
        report["replayed_rows"] = sum(
            len(ups) for s in self.session_sources for _t, ups in s.replay_batches)
        report["replayed_epochs"] = sum(len(s.replay_batches) for s in self.session_sources)
        marks["frontier"] = self.replay_frontier

    def restore(self, state):
        sync()
        enc0 = CHIP_LEDGER.snapshot().get("accounts", {}).get("encode", {}).get("seconds", 0.0)
        launches0 = dict(_build.LAUNCHES)
        marks["restoring"] = 1.0
        t0 = time.monotonic()
        try:
            real["restore"](self, state)
            sync()
        finally:
            marks["restoring"] = 0.0
        report["restore_s"] = time.monotonic() - t0
        report["restored_rows"] = len(self.data_rows)
        enc1 = CHIP_LEDGER.snapshot().get("accounts", {}).get("encode", {}).get("seconds", 0.0)
        report["restore_encode_device_s"] = enc1 - enc0
        report["restore_launches"] = {k: v - launches0.get(k, 0) for k, v in _build.LAUNCHES.items()
                                      if v - launches0.get(k, 0)}

    def topo(self, t, end_epoch=True):
        real["pass"](self, t, end_epoch)
        if t == marks.get("frontier", -2) and "t_replayed" not in marks:
            sync()
            marks["t_replayed"] = time.monotonic()

    DeviceKnnIndex.__init__, DeviceKnnIndex.add_batch_device = init, add
    EnginePersistence.recover_source = timed_read("src")
    EnginePersistence.recover_operator_snapshot = timed_read("snap")
    df.EngineGraph._setup_persistence, df.ExternalIndexNode.restore_state = setup, restore
    df.EngineGraph._topo_pass = topo
    sink = open(spec["sink"], "a")
    answers_out = open(spec["answers"], "a")
    try:
        pw.clear_graph()
        state = _recovery_graph(pw, texts, queries, spec["per_epoch"], sink=sink, answers_out=answers_out)
        state["embedder"]._encoder.encode_device(texts[:8], pad_to=8)  # warm-up: handles, first launches
        sync()
        _build.reset_launches()
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(spec["root"]),
                                                  snapshot_interval_ms=spec["snapshot_ms"])
        t_run = time.monotonic()
        pw.run(persistence_config=cfg, chip_ledger=bool(spec.get("chip_ledger")))
        sync()
        t_end = time.monotonic()
    finally:
        sink.close()
        answers_out.close()
        for cls, name, key in ((DeviceKnnIndex, "__init__", "init"), (DeviceKnnIndex, "add_batch_device", "add"),
                               (EnginePersistence, "recover_source", "src"),
                               (EnginePersistence, "recover_operator_snapshot", "snap"),
                               (df.EngineGraph, "_setup_persistence", "setup"),
                               (df.ExternalIndexNode, "restore_state", "restore"),
                               (df.EngineGraph, "_topo_pass", "pass")):
            setattr(cls, name, real[key])
    index = max(indexes, key=lambda ix: len(ix._slot_of))
    keys, rows = _index_rows(index)
    report.update(
        launches=dict(_build.LAUNCHES), delivered=len(state["delivered"]), answers=len(state["answers"]),
        index_rows=len(keys), run_s=t_end - t_run, since_spawn_s=t_end - spec["t_spawn"],
        read_s=marks["read_s"], restore_add_s=marks["restore_add_s"],
    )
    if state["t_first"] is not None:
        report["first_delivery_since_run_s"] = state["t_first"] - t_run
        report["first_delivery_since_spawn_s"] = state["t_first"] - spec["t_spawn"]
    if "t_setup0" in marks:
        report["setup_s"] = marks["t_setup1"] - marks["t_setup0"]
        report["start_to_setup_s"] = marks["t_setup0"] - t_run
    if "t_replayed" in marks:
        report["log_tail_replay_s"] = marks["t_replayed"] - marks["t_setup1"]
        if state["t_first"] is not None:
            report["first_live_epoch_s"] = state["t_first"] - marks["t_replayed"]
    if spec.get("rows_out"):
        np.save(spec["rows_out"] + ".keys.npy", keys)
        np.save(spec["rows_out"] + ".rows.npy", rows)
    if spec.get("rows_ref"):
        ref_keys = np.load(spec["rows_ref"] + ".keys.npy")
        ref_rows = np.load(spec["rows_ref"] + ".rows.npy")
        if not np.array_equal(ref_keys, keys):
            raise AssertionError(f"C's index holds {len(keys)} keys, A's {len(ref_keys)}, not the same set")
        err, cos = held_embeddings("recovered index rows against the uninterrupted run's", rows, ref_rows)
        report.update(rows_max_abs_err=err, rows_min_cos=cos,
                      rows_bitwise_equal=int((rows == ref_rows).all(axis=1).sum()))
    with open(spec["report"], "w") as f:
        json.dump(report, f)
    return 0


def _unpickle_hidden(path: str) -> dict:
    """Run in a child with the card hidden: read the operator snapshot log
    at ``path`` and unpickle its latest snapshot. A CUDA tensor inside would
    fail to load here."""
    import pickle

    import torch

    from pathway_tpu_torch.engine.persistence import sniff_log_reader

    records = list(sniff_log_reader(path))
    if not records:
        raise AssertionError(f"no operator snapshot in {path}")
    _kind, t, _key, blob = records[-1]
    data = pickle.loads(blob)
    return {"cuda_available": torch.cuda.is_available(), "time": int(t), "nodes": len(data["states"]),
            "bytes": len(blob)}


_CHILDREN: list = []  # every child process recovery_path starts; none outlives the phase


def _spawn_child(code: str, arg: str, env=None):
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", code, arg], cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)
    return proc


def _child_result(proc, what: str, timeout: float) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} did not finish in {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{err[-4000:]}")
    return out


def _sink_ids(path: str) -> list[int]:
    """The document ids a sink file holds (a torn last line is not one)."""
    with open(path) as f:
        text = f.read()
    return [int(x) for x in text[: text.rfind("\n") + 1].split()]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _d, fs in os.walk(path) for f in fs)


def _recovery_crash(torch, folder: str, n_docs: int, per_epoch: int, kill_at: int, n_queries: int,
                    snapshot_ms: int) -> dict:
    """Part 1: a real process crash of a live index and its recovery (runs
    A, B, C and the hidden-card unpickle, each a process of its own)."""
    import pickle
    import signal

    child = "import sys, chip_smoke; sys.exit(chip_smoke._recovery_child(sys.argv[1]))"
    corpus = os.path.join(folder, "corpus.pkl")
    with open(corpus, "wb") as f:
        pickle.dump(_recovery_corpus(n_docs, n_queries), f, protocol=4)
    child_env = dict(os.environ, RECOVERY_CORPUS=corpus)

    def spec(role: str, **kw) -> dict:
        base = os.path.join(folder, role)
        return dict(role=role, dev=DEV, tiny=RECOVERY_TINY, n_docs=n_docs, n_queries=n_queries, per_epoch=per_epoch,
                    snapshot_ms=snapshot_ms, sink=base + ".sink", answers=base + ".answers",
                    report=base + ".report.json", t_spawn=time.monotonic(), **kw)

    root_a, root_b = os.path.join(folder, "root_a"), os.path.join(folder, "root_b")
    spec_a = spec("A", root=root_a, rows_out=os.path.join(folder, "rows_a"))
    proc_a = _spawn_child(child, json.dumps(spec_a), env=child_env)
    spec_b = spec("B", root=root_b)
    proc_b = _spawn_child(child, json.dumps(spec_b), env=child_env)
    snap_b = os.path.join(root_b, "streams", "__operators__.bin")
    deadline = time.monotonic() + RECOVERY_CHILD_TIMEOUT
    delivered_b = 0
    while True:
        if proc_b.poll() is not None:
            _out, err = proc_b.communicate()
            raise AssertionError(f"run B ended (exit {proc_b.returncode}) before the parent killed it:\n{err[-4000:]}")
        if os.path.exists(spec_b["sink"]):
            delivered_b = len(_sink_ids(spec_b["sink"]))
        if delivered_b >= kill_at and os.path.exists(snap_b) and os.path.getsize(snap_b) > 0:
            break
        if time.monotonic() > deadline:
            proc_b.kill()
            raise AssertionError(f"run B delivered {delivered_b} documents in {RECOVERY_CHILD_TIMEOUT} s")
        time.sleep(0.02)
    os.kill(proc_b.pid, signal.SIGKILL)
    proc_b.communicate()
    t_killed = time.monotonic()
    b_ids = _sink_ids(spec_b["sink"])
    # the snapshot as the crash left it, unpickled with the card hidden
    import shutil

    hidden_copy = os.path.join(folder, "snapshot_at_crash.bin")
    shutil.copyfile(snap_b, hidden_copy)
    hidden_env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc_h = _spawn_child("import sys, json, chip_smoke; print(json.dumps(chip_smoke._unpickle_hidden(sys.argv[1])))",
                          hidden_copy, env=hidden_env)
    _child_result(proc_a, "run A", RECOVERY_CHILD_TIMEOUT)
    hidden = json.loads(_child_result(proc_h, "the hidden-card unpickle", RECOVERY_CHILD_TIMEOUT).splitlines()[-1])
    if hidden["cuda_available"]:
        raise AssertionError("the hidden-card child still saw a card")
    root_bytes_at_crash = _dir_bytes(root_b)
    spec_c = spec("C", root=root_b, rows_ref=os.path.join(folder, "rows_a"), chip_ledger=True)
    _child_result(_spawn_child(child, json.dumps(spec_c), env=child_env), "run C", RECOVERY_CHILD_TIMEOUT)
    rep_a, rep_c = (json.load(open(s["report"])) for s in (spec_a, spec_c))
    c_ids = _sink_ids(spec_c["sink"])

    # ---- gates
    both = collections.Counter(b_ids + c_ids)
    missing = n_docs - len(both)
    dups = sorted(k for k, v in both.items() if v > 1)
    extra = [k for k in both if not 0 <= k < n_docs]
    # the one at-least-once window of the contract: a kill after an epoch's
    # sink flush and before its delivered marker re-delivers that epoch
    last_b_epoch = set(b_ids[-per_epoch:]) if b_ids else set()
    window_ok = not dups or (len(dups) <= per_epoch and set(dups) <= last_b_epoch)
    if missing or extra or any(v > 2 for v in both.values()) or not window_ok:
        raise AssertionError(f"across B and C: {missing} documents missing, {len(dups)} delivered twice, "
                             f"{len(extra)} unknown")
    answers = {}
    for role, sp in (("A", spec_a), ("C", spec_c)):
        with open(sp["answers"]) as f:
            answers[role] = {rec["qid"]: rec["hits"] for rec in map(json.loads, f)}
    if sorted(answers["A"]) != list(range(n_queries)) or sorted(answers["C"]) != list(range(n_queries)):
        raise AssertionError(f"A answered {len(answers['A'])}, C {len(answers['C'])} of {n_queries} queries")
    share, ok = _hits_agree([answers["C"][i] for i in range(n_queries)], [answers["A"][i] for i in range(n_queries)],
                            10)
    if not ok:
        raise AssertionError(f"C's hits disagree with the uninterrupted run's beyond {HIT_TOL} ({share})")
    b1 = ("gemm_bias_act", "gemm_bias_residual_layernorm")
    if DEV != "cpu":
        restore_b1 = {k: rep_c.get("restore_launches", {}).get(k, 0) for k in b1}
        b2 = {k: rep_c["launches"].get(k, 0) for k in ("knn_topk_stream", "knn_topk_merge")}
        if not all(restore_b1.values()) or not all(b2.values()):
            raise AssertionError(f"C's restore launched {restore_b1}, its run {b2}")
    if rep_c.get("restored_rows", 0) == 0 or rep_c.get("snapshot_time", -1) < 0:
        raise AssertionError("C did not restore the index from the operator snapshot")
    return dict(
        docs=n_docs, per_epoch=per_epoch, killed_after_docs=len(b_ids), delivered_by_b=len(b_ids),
        delivered_by_c=len(c_ids), redelivered=len(dups), queries=n_queries, hits_vs_uninterrupted=share,
        time_to_recover_s=rep_c.get("first_delivery_since_run_s"),
        time_to_recover_since_spawn_s=rep_c.get("first_delivery_since_spawn_s"),
        recover_split=dict(read_logs_and_snapshot_s=rep_c.get("read_s"), setup_s=rep_c.get("setup_s"),
                           restore_s=rep_c.get("restore_s"), re_embed_encode_device_s=rep_c.get(
                               "restore_encode_device_s"), index_adds_s=rep_c.get("restore_add_s"),
                           log_tail_replay_s=rep_c.get("log_tail_replay_s"),
                           first_live_epoch_s=rep_c.get("first_live_epoch_s")),
        snapshot_time=rep_c.get("snapshot_time"), replay_frontier=rep_c.get("replay_frontier"),
        rows_restored_from_snapshot=rep_c.get("restored_rows"), rows_replayed_from_log=rep_c.get("replayed_rows"),
        epochs_replayed_from_log=rep_c.get("replayed_epochs"),
        restored_rows_max_abs_err=rep_c.get("rows_max_abs_err"), restored_rows_min_cos=rep_c.get("rows_min_cos"),
        restored_rows_bitwise_equal=rep_c.get("rows_bitwise_equal"), index_rows=rep_c.get("index_rows"),
        restore_launches=rep_c.get("restore_launches"), c_launches=rep_c.get("launches"),
        hidden_card_unpickle=hidden, persistence_root_bytes_at_crash=root_bytes_at_crash,
        persistence_root_bytes_after_c=_dir_bytes(root_b), run_a_seconds=rep_a.get("run_s"),
        run_c_seconds=rep_c.get("run_s"), c_start_after_kill_s=spec_c["t_spawn"] - t_killed,
    )


def _recovery_restart(torch, folder: str, n_docs: int, per_epoch: int, n_queries: int, chaos_epoch: int) -> dict:
    """Part 2: an in-process restart under the supervisor. The pipeline over
    ``n_docs`` documents under ``pw.run(recovery=2, persistence_config=...,
    with_http_server=True)``; a chaos rule raises at
    ``engine.after_sink_flush`` at epoch ``chaos_epoch``. Gates: the
    delivered documents and the answers equal an unkilled twin's (the
    raised epoch, flushed but never marked delivered, comes again: the
    contract's one at-least-once window), ``/metrics`` reads one supervisor
    restart, and after the restart the card holds one index, not two."""
    import gc
    import urllib.request

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import run as trun
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.internals.ledger import LEDGER
    from pathway_tpu_torch.resilience import SUPERVISOR_METRICS, chaos

    texts, queries = _recovery_corpus(n_docs, n_queries)
    real_release, real_run = trun.release_crashed_attempt, GraphRunner.run
    embedder = _recovery_embedder()  # one encoder for both runs: the card's memory compares their indexes
    embedder._encoder.encode_device(texts[:8], pad_to=8)

    def once(root: str, chaotic: bool) -> dict:
        probe: dict = {}
        port = _free_port()

        def on_ingested(state):
            torch.cuda.synchronize()
            hot = LEDGER.accounts().get("index.hot", {})
            probe.update(attempt=state["attempts"], memory_allocated=torch.cuda.memory_allocated(),
                         index_hot_owners=hot.get("owners", 0), index_hot_bytes=hot.get("bytes", 0))
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                probe["metrics"] = r.read().decode()

        pw.clear_graph()
        state = _recovery_graph(pw, texts, queries, per_epoch, on_ingested=on_ingested, embedder=embedder)
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(root))
        SUPERVISOR_METRICS.reset()
        # the same baseline for both runs: earlier paths' garbage collected, the allocator's cache returned
        gc.collect()
        torch.cuda.empty_cache()
        if chaotic:
            chaos.activate([{"site": "engine.after_sink_flush", "time": chaos_epoch, "action": "raise"}])
        release = {"s": 0.0}
        spans: list = []  # each attempt's (start, end) of GraphRunner.run, from t0

        def timed_release():
            t = time.perf_counter()
            real_release()
            release["s"] += time.perf_counter() - t

        def timed_run(self, *a, **kw):
            spans.append([time.perf_counter() - t0, None])
            try:
                return real_run(self, *a, **kw)
            finally:
                spans[-1][1] = time.perf_counter() - t0

        trun.release_crashed_attempt, GraphRunner.run = timed_release, timed_run
        t0 = time.perf_counter()
        try:
            pw.run(recovery=2, persistence_config=cfg, with_http_server=True, monitoring_http_port=port)
        finally:
            trun.release_crashed_attempt, GraphRunner.run = real_release, real_run
            chaos.deactivate()
            pw.clear_graph()
        torch.cuda.synchronize()
        return dict(state=state, probe=probe, seconds=time.perf_counter() - t0, release_s=release["s"],
                    spans=spans, restarts=SUPERVISOR_METRICS.snapshot()["restarts_total"])

    twin = once(os.path.join(folder, "restart_twin"), False)
    hit = once(os.path.join(folder, "restart_chaos"), True)
    tw, ch = twin["state"], hit["state"]
    dup = collections.Counter(ch["delivered"])
    twice = sorted(k for k, v in dup.items() if v > 1)
    window = set(range(chaos_epoch * per_epoch, (chaos_epoch + 1) * per_epoch))
    if set(dup) != set(tw["delivered"]) or any(v > 2 for v in dup.values()) or set(twice) - window:
        raise AssertionError(f"the restarted run delivered {len(dup)} documents ({len(twice)} twice), the twin "
                             f"{len(set(tw['delivered']))}")
    share, ok = _hits_agree([ch["answers"][i] for i in range(n_queries)], [tw["answers"][i] for i in range(n_queries)],
                            10)
    if not ok:
        raise AssertionError(f"the restarted run's hits disagree with its twin's ({share})")
    if hit["restarts"] != 1 or ch["attempts"] != 2:
        raise AssertionError(f"{hit['restarts']} supervisor restarts, {ch['attempts']} attempts of the subject")
    line = [ln for ln in hit["probe"]["metrics"].splitlines() if ln.startswith("pathway_supervisor_restarts_total")]
    if [ln.rsplit(" ", 1)[-1] for ln in line] != ["1"]:
        raise AssertionError(f"/metrics reads {line} for the supervisor's restarts")
    mem_twin, mem_hit = twin["probe"]["memory_allocated"], hit["probe"]["memory_allocated"]
    index_bytes = hit["probe"]["index_hot_bytes"]
    if hit["probe"]["index_hot_owners"] != 1 or mem_hit > mem_twin + index_bytes // 2:
        raise AssertionError(f"after the restart the ledger books {hit['probe']['index_hot_owners']} indexes and "
                             f"the card holds {mem_hit} bytes against the twin's {mem_twin}")
    return dict(docs=n_docs, chaos_epoch=chaos_epoch, redelivered=len(twice), restarts=hit["restarts"],
                metrics_line=line[0], hits_vs_twin=share, memory_allocated_after_restart=mem_hit,
                memory_allocated_twin=mem_twin, index_hot_owners=hit["probe"]["index_hot_owners"],
                index_hot_bytes=index_bytes, twin_seconds=twin["seconds"], restarted_seconds=hit["seconds"],
                release_seconds=hit["release_s"], attempt_spans=hit["spans"], twin_spans=twin["spans"])


def _recovery_pipeline_runs(torch, n_docs: int, per_epoch: int, n_queries: int, runs=RECOVERY_PIPE_RUNS) -> dict:
    """Part 3: the epoch pipeline and the host-ingest stage. The pipeline
    (no persistence) over ``n_docs`` documents, paced so that each commit is
    one epoch while the stager may run ahead, at each (depth, ingest
    workers) of ``runs`` in turn; the last with the stage's autoscaler on.
    Gate: the sink output (every delivered row with its epoch and diff, and
    every answer with its scores) is byte-identical across the runs."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ingest import stage as ingest_stage
    from pathway_tpu_torch.ingest.metrics import INGEST_METRICS
    from pathway_tpu_torch.internals import flight_recorder
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    texts, queries = _recovery_corpus(n_docs, n_queries)
    embedder = _recovery_embedder()
    embedder._encoder.encode_device(texts[:8], pad_to=8)
    outs, stats = [], []
    real_init = GraphRunner.__init__
    for depth, workers in runs:
        runners: list = []

        def init(self, *a, **kw):
            real_init(self, *a, **kw)
            runners.append(self)

        pw.clear_graph()
        state = _recovery_graph(pw, texts, queries, per_epoch, pace="drained", persistent=False, embedder=embedder)
        INGEST_METRICS.reset()
        seq0 = flight_recorder.RECORDER._seq
        env_before = os.environ.get("PATHWAY_INGEST_AUTOSCALE")
        if workers:
            os.environ["PATHWAY_INGEST_AUTOSCALE"] = "1"
        GraphRunner.__init__ = init
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            pw.run(pipeline_depth=depth, ingest_workers=workers)
        finally:
            GraphRunner.__init__ = real_init
            if env_before is None:
                os.environ.pop("PATHWAY_INGEST_AUTOSCALE", None)
            else:
                os.environ["PATHWAY_INGEST_AUTOSCALE"] = env_before
            pw.clear_graph()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ps = runners[-1].engine.pipeline_stats if runners else None
        ing = INGEST_METRICS.snapshot() if INGEST_METRICS.active() else None
        if workers:
            ingest_stage.shutdown_stage()
        autoscale = [e for e in flight_recorder.RECORDER.events()
                     if e["seq"] > seq0 and e["kind"] == "ingest.autoscale"]
        out = [" ".join(map(str, rec)) for rec in state["log"]]
        out += [json.dumps([i, state["answers"][i]]) for i in sorted(state["answers"])]
        outs.append("\n".join(out))
        entry = dict(depth=depth, ingest_workers=workers, seconds=wall, docs_per_s=n_docs / wall,
                     epochs=len(state["epochs"]), autoscale_events=len(autoscale))
        if ps is not None:
            d = ps.as_dict()
            entry.update(host_prep_s=d["host_prep_s"], device_wait_s=d["device_wait_s"],
                         device_wait_cpu_s=d["device_wait_cpu_s"], device_wait_events_s=d["device_wait_events_s"],
                         overlap_s=d["overlap_s"], overlap_ratio=d["overlap_ratio"], exec_s=d["exec_s"])
        if ing is not None:
            entry.update(ingest_utilization=ing["utilization"], ingest_workers_final=ing["host_workers"],
                         ingest_scale_up=ing["scale_up"], ingest_scale_down=ing["scale_down"],
                         ingest_committed=ing["committed"])
        stats.append(entry)
    if any(o != outs[0] for o in outs[1:]):
        raise AssertionError("the sink output differs between depths / ingest-worker settings: "
                             f"{[hash(o) for o in outs]}")
    if len(outs[0].splitlines()) != n_docs + n_queries:
        raise AssertionError(f"{len(outs[0].splitlines())} sink lines for {n_docs} documents and {n_queries} queries")
    return dict(docs=n_docs, runs=stats, identical_outputs=len(outs))


def _recovery_decode(torch, n_requests: int, steps=RECOVERY_CHAOS_STEPS) -> dict:
    """Part 4: the decode step's crash discipline. ``decode_ext_path``'s
    seeded decoder (B5 paged attention), ``n_requests`` requests in greedy,
    sampled and prompt-lookup speculative mode; ``decode.step`` raises at
    each of ``steps`` and the drain is retried. Gates: every stream equals
    an unkilled twin's exactly, and B5 launches in the chaotic runs."""
    from pathway_tpu_torch import DecodeEngine, DecoderConfig
    from pathway_tpu_torch.decode import parse_decode_spec
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.resilience import chaos

    mcfg = DecoderConfig()
    prompts = _decode_ext_prompts(mcfg.vocab_size)[:n_requests]
    out = {}
    for mode, extra in RECOVERY_DECODE_MODES:
        spec = f"{DECODE_EXT_POOL},impl={DECODE_EXT_IMPL}{extra}"
        twin = DecodeEngine(mcfg, parse_decode_spec(spec), seed=SEED, device=DEV).generate(prompts)
        eng = DecodeEngine(mcfg, parse_decode_spec(spec), seed=SEED, device=DEV)
        tickets = [eng.submit(p) for p in prompts]
        before = dict(_build.LAUNCHES)
        chaos.activate([{"site": "decode.step", "time": s, "action": "raise"} for s in steps])
        raised = 0
        try:
            while True:
                try:
                    eng.drain()
                    break
                except chaos.ChaosInjected:
                    raised += 1
        finally:
            chaos.deactivate()
        b5 = _build.LAUNCHES.get("paged_decode_attention", 0) - before.get("paged_decode_attention", 0)
        streams = [t.result() for t in tickets]
        if raised != len(steps) or streams != twin:
            bad = sum(a != b for a, b in zip(streams, twin))
            raise AssertionError(f"decode {mode}: {raised} of {len(steps)} kills fired, {bad} streams differ "
                                 "from the unkilled twin's")
        if DEV != "cpu" and "spec" not in mode and not b5:  # a speculative tick's verify is plain PyTorch
            raise AssertionError(f"decode {mode}: B5 never launched")
        out[mode] = dict(kills=raised, tokens=sum(len(s) for s in streams), b5_launches=b5, steps=eng.steps)
    return dict(requests=n_requests, chaos_steps=list(steps), modes=out)


def phase_recovery_path(torch, n_docs: int = RECOVERY_DOCS, per_epoch: int = RECOVERY_EPOCH,
                        kill_at: int = RECOVERY_KILL_AT, n_queries: int = RECOVERY_QUERIES,
                        snapshot_ms: int = RECOVERY_SNAPSHOT_MS, restart_docs: int = RECOVERY_RESTART_DOCS,
                        restart_queries: int = RECOVERY_RESTART_QUERIES, chaos_epoch: int = RECOVERY_CHAOS_EPOCH,
                        pipe_docs: int = RECOVERY_PIPE_DOCS, pipe_queries: int = RECOVERY_PIPE_QUERIES,
                        decode_requests: int = RECOVERY_DECODE_REQUESTS) -> dict:
    """Persistence, recovery and the overlapped epoch pipeline on the card,
    at ``engine_path``'s width (MiniLM-L6, seeded weights; B1, B4 where the
    embedder packs, B2). Four parts, each gated (see their functions): a
    live index's crash and recovery across processes, an in-process
    supervisor restart, the epoch pipeline at depth 1 and 2 with the
    host-ingest stage, and the decode step's crash discipline. Returns the
    launch counts of the parts' counted runs (the launch counters are set
    to 0 just before this phase; its children count their own)."""
    import gc
    import shutil
    import tempfile

    from pathway_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    folder = tempfile.mkdtemp(prefix="recovery_", dir=build_dir)
    # the children need the card's memory that the earlier paths' garbage and
    # this process's allocator cache still hold
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        crash = _recovery_crash(torch, folder, n_docs, per_epoch, kill_at, n_queries, snapshot_ms)
        crash["seconds"] = time.perf_counter() - t0
        emit("recovery_crash", **crash)
        t0 = time.perf_counter()
        restart = _recovery_restart(torch, folder, restart_docs, per_epoch, restart_queries, chaos_epoch)
        restart["seconds"] = time.perf_counter() - t0
        emit("recovery_restart", **restart)
        t0 = time.perf_counter()
        pipe = _recovery_pipeline_runs(torch, pipe_docs, per_epoch, pipe_queries)
        pipe["seconds"] = time.perf_counter() - t0
        emit("recovery_pipeline", **pipe)
        t0 = time.perf_counter()
        dec = _recovery_decode(torch, decode_requests)
        dec["seconds"] = time.perf_counter() - t0
        emit("recovery_decode", **dec)
        launches = collections.Counter(_build.LAUNCHES)
        # the children's own counted runs: C's restore and its queries
        launches.update(crash["c_launches"] or {})
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(folder, ignore_errors=True)
    emit("recovery_path", seconds=time.perf_counter() - t_phase, launches=dict(launches))
    return dict(launches)


ELASTIC_ROWS, ELASTIC_DIM, ELASTIC_REMOVED, ELASTIC_CHUNK = 1 << 20, 384, 0.10, 8192
ELASTIC_PROBES, ELASTIC_SINGLES = 256, 256  # fixed probes; single queries timed before and after each reshard
ELASTIC_WRITE_BATCH = 64
ELASTIC_TIER_ROWS, ELASTIC_TIER_HOT, ELASTIC_TIER_CLUSTERS = 1 << 18, 1 << 15, 64
ELASTIC_TENANTS, ELASTIC_TENANT_DOCS, ELASTIC_TENANT_PROBED, ELASTIC_TENANT_COLD = 1024, 256, 64, 8
ELASTIC_RUN_DOCS, ELASTIC_RUN_EPOCH, ELASTIC_CRASH_ROWS, ELASTIC_CRASH_HIT = 16_384, 1024, 1 << 18, 5
ELASTIC_CHILD_TIMEOUT = 300.0


def elastic_plan(torch) -> tuple[list | None, tuple, str]:
    """(device pool, the flat index's shard steps, a line that says which):
    with four or more cards it reshards across cards 1 -> 2 -> 4 -> 2, with
    two 1 -> 2 -> 1; on one card ``mesh_devices``' list (4 shards on
    ``cuda:0``) becomes the private device pool of ``parallel/mesh.py`` and
    the steps are 1 -> 2 -> 4 -> 2 within it."""
    if DEV == "cpu":  # the CPU rehearsal
        return ["cpu"] * MESH_ONE_CARD_SHARDS, (2, 4, 2), "the CPU: a pool of 4 CPU devices"
    n = torch.cuda.device_count()
    if n >= 4:
        return None, (2, 4, 2), f"{n} cards, one shard a card"
    if n == 2:
        return None, (2, 1), "2 cards, one shard a card"
    mesh, _ = mesh_devices(torch)
    return [str(d) for d in mesh.data_devices()], (2, 4, 2), (
        f"one card: the device pool of {MESH_ONE_CARD_SHARDS} shards on cuda:0 (mesh_devices' list)")


def _card_bytes(torch, devices) -> int:
    """Bytes allocated on the distinct cards of ``devices`` (0 on the CPU)."""
    return sum(torch.cuda.memory_allocated(d) for d in {str(d) for d in devices} if d.startswith("cuda"))


def _slab_bytes(index) -> int:
    return sum(t.element_size() * t.numel() for part in index._slab for t in part)


def _key_rows(index, keys) -> "object":
    """The rows of ``keys`` as ``index`` holds them (pulled from its slabs)."""
    import numpy as np

    slots = np.fromiter((index._slot_of[k] for k in keys), np.int64, len(keys))
    return index._rows_at(slots)


def _kept_launches(fn):
    """Run ``fn`` (a comparison with a plain version, or a timing) without
    its launches counting toward the path."""
    from pathway_tpu_torch.ops import _build

    saved = dict(_build.LAUNCHES)
    try:
        return fn()
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def _hold_generation(torch, index, probes) -> dict:
    """B2 (one shard) or B2s (several) on this generation's slabs against the
    plain top-k over the whole slab: ids exact and scores at 1e-5 up to 16
    queries, ``topk_agreement`` above."""
    from pathway_tpu_torch.ops.knn_topk import knn_topk, knn_topk_reference, knn_topk_sharded, topk_agreement

    docs = [p[0] for p in index._slab]
    biases = [p[2] for p in index._slab]
    cat_docs = torch.cat([t.to(DEV) for t in docs])
    cat_bias = torch.cat([t.to(DEV) for t in biases])
    out = {}
    for Q in (1, 16, len(probes)):
        q = probes[:Q].contiguous()
        if len(docs) == 1:
            vk, ik = knn_topk(q, docs[0], k=10, bias=biases[0])
        else:
            vk, ik = knn_topk_sharded(q, docs, biases, k=10)
        vp, ip = knn_topk_reference(q, cat_docs, k=10, bias=cat_bias)
        if Q <= 16:
            err = float((vk - vp).abs().max())
            if not torch.equal(ik.long().cpu(), ip.long().cpu()) or err > 1e-5:
                raise AssertionError(f"B2{'s' if len(docs) > 1 else ''} at {len(docs)} shards, q {Q}: ids or scores "
                                     f"differ from the whole slab's plain top-k (max abs err {err})")
            out[f"q{Q}_max_abs_err"] = err
        else:
            share, ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
            if not ok:
                raise AssertionError(f"B2s at {len(docs)} shards, q {Q}: disagrees with the plain top-k ({share})")
            out[f"q{Q}_agreement"] = share
    del cat_docs, cat_bias
    return out


def _reshard_timed(pw, torch, h, to: int, chunk: int, probes_dev, singles_dev, key_base: int) -> dict:
    """One live reshard of the flat index behind ``h`` with a reader (single
    queries without pause, a batch of the probes at every chunk boundary)
    and a writer (64-row device adds and removes of its own earlier rows,
    through the handle while the migration runs) beside it. Returns the
    reshard's numbers; the gates are the caller's."""
    import threading

    import numpy as np

    from pathway_tpu_torch.elastic import controller
    from pathway_tpu_torch.elastic.metrics import ELASTIC_METRICS
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    sync = (lambda: sync_cards(torch, h.index.shard_devices)) if DEV != "cpu" else (lambda: None)
    marks = collections.defaultdict(float)
    real = {"export": DeviceKnnIndex.reshard_export_chunks, "import": DeviceKnnIndex.reshard_import_chunk,
            "finish": DeviceKnnIndex.reshard_finish, "barrier": controller._barrier}

    def export(self, chunk_rows):
        gen = real["export"](self, chunk_rows)
        while True:
            t0 = time.perf_counter()
            item = next(gen, None)
            marks["export_s"] += time.perf_counter() - t0
            if item is None:
                return
            yield item

    def timed(name):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                marks[f"{name}_s"] += time.perf_counter() - t0
        return wrapped

    def single_window() -> list[float]:
        lat = []
        for i in range(len(singles_dev)):
            t0 = time.perf_counter()
            res = h.search_batch(singles_dev[i : i + 1], 10)
            lat.append((time.perf_counter() - t0) * 1e3)
            if len(res[0]) != 10:
                raise AssertionError("a single query returned fewer than 10 neighbours")
        return lat

    launches0 = dict(_build.LAUNCHES)
    before = single_window()
    reads = {"issued": 0, "served": 0, "lat": [], "batches": 0, "errors": []}
    writes = {"added": 0, "removed": 0, "ops": 0, "mine": []}
    stop = threading.Event()
    rng = np.random.default_rng(SEED + 40 + to)

    def reader():
        seen, i = ELASTIC_METRICS._chunks, 0
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                res = h.search_batch(singles_dev[i % len(singles_dev) : i % len(singles_dev) + 1], 10)
                ok = len(res) == 1 and len(res[0]) == 10
            except Exception as exc:  # noqa: BLE001 (counted: the gate reads it)
                ok = False
                reads["errors"].append(repr(exc)[:200])
            reads["lat"].append((time.perf_counter() - t0) * 1e3)
            reads["issued"] += 1
            reads["served"] += ok
            i += 1
            done = ELASTIC_METRICS._chunks
            if done > seen:  # a chunk boundary passed: one batch of the probes
                seen = done
                res = h.search_batch(probes_dev, 10)
                reads["issued"] += 1
                reads["served"] += len(res) == len(probes_dev) and all(len(r) == 10 for r in res)
                reads["batches"] += 1

    def writer():
        while not stop.is_set() and not h._migrating:
            time.sleep(0.0005)
        n = 0
        while not stop.is_set():
            vecs = torch.from_numpy(rng.standard_normal((ELASTIC_WRITE_BATCH, ELASTIC_DIM), dtype=np.float32))
            vecs = vecs.to(h.index.device)
            with h._lock:  # every write lands in the migrating generation and its delta log
                if not h._migrating:
                    break
                if writes["ops"] % 2 == 0 or not writes["mine"]:
                    keys = list(range(key_base + n, key_base + n + ELASTIC_WRITE_BATCH))
                    n += ELASTIC_WRITE_BATCH
                    h.add_batch_device(keys, vecs)
                    writes["mine"].append(keys)
                    writes["added"] += len(keys)
                else:
                    for key in writes["mine"].pop(0):
                        h.remove(key)
                        writes["removed"] += 1
                writes["ops"] += 1
            time.sleep(0.002)

    DeviceKnnIndex.reshard_export_chunks = export
    DeviceKnnIndex.reshard_import_chunk = timed("import")
    DeviceKnnIndex.reshard_finish = timed("finish")
    controller._barrier = timed("barrier")
    threads = [threading.Thread(target=reader, daemon=True), threading.Thread(target=writer, daemon=True)]
    try:
        for t in threads:
            t.start()
        pulls0 = h.index._host_pulls
        old = h.index
        t0 = time.perf_counter()
        summary = pw.elastic.reshard(to, chunk_rows=chunk, reason="manual")
        mttr_wall = time.perf_counter() - t0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        DeviceKnnIndex.reshard_export_chunks = real["export"]
        DeviceKnnIndex.reshard_import_chunk = real["import"]
        DeviceKnnIndex.reshard_finish = real["finish"]
        controller._barrier = real["barrier"]
    sync()
    launches_old = {k: v - launches0.get(k, 0) for k, v in _build.LAUNCHES.items() if v - launches0.get(k, 0)}
    return dict(
        summary=summary, old=old, mttr_wall=mttr_wall, marks=dict(marks), before=before, reads=reads,
        writes=writes, host_pulls=old._host_pulls - pulls0, launches_during=launches_old,
        single_window=single_window,
    )


def _elastic_flat(pw, torch, steps, chunk, n_rows, n_probes, n_singles) -> tuple[dict, list, dict]:
    """Part 1: the flat index (cos, d 384, ``n_rows`` seeded rows added on
    the card, 10 % removed) resharded along ``steps`` under traffic."""
    import gc

    import numpy as np

    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, StaleGeneration

    devs = [DEV] if DEV == "cpu" else sorted({f"cuda:{i}" for i in range(torch.cuda.device_count())})
    rng = np.random.default_rng(SEED + 31)
    probes = rng.standard_normal((n_probes, ELASTIC_DIM), dtype=np.float32)
    singles = rng.standard_normal((n_singles, ELASTIC_DIM), dtype=np.float32)
    probes_dev, singles_dev = torch.from_numpy(probes).to(DEV), torch.from_numpy(singles).to(DEV)
    if DEV != "cpu":  # this thread's cuBLAS workspace on every card belongs to the base, not to a generation
        for d in devs:
            torch.ones(8, 8, device=d) @ torch.ones(8, 8, device=d)
        sync_cards(torch, devs)
    gc.collect()
    base_bytes = _card_bytes(torch, devs)
    index = DeviceKnnIndex(ELASTIC_DIM, "cos", reserved_space=n_rows, device=DEV)
    t0 = time.perf_counter()
    batch = max(1, min(1 << 16, n_rows))
    for start in range(0, n_rows, batch):
        rows = rng.standard_normal((min(batch, n_rows - start), ELASTIC_DIM), dtype=np.float32)
        index.add_batch_device(list(range(start, start + len(rows))), torch.from_numpy(rows).to(DEV))
    removed = rng.choice(n_rows, int(n_rows * ELASTIC_REMOVED), replace=False)
    for key in removed.tolist():
        index.remove(key)
    build_s = time.perf_counter() - t0
    h = pw.elastic.register_handle(index)
    del index  # the handle holds the live generation; an old one must be free to go
    ref0 = h.search_batch(probes_dev, 10)
    steps_out, entries = [], []
    for step, to in enumerate(steps):
        out = _reshard_timed(pw, torch, h, to, chunk, probes_dev, singles_dev, key_base=n_rows + (step + 1) * 10**7)
        summary, old = out["summary"], out["old"]
        new = h.index
        reads = out["reads"]
        if reads["served"] != reads["issued"] or reads["errors"]:
            raise AssertionError(f"reshard to {to}: {reads['issued'] - reads['served']} of {reads['issued']} "
                                 f"reads failed or came back short ({reads['errors'][:3]})")
        if new.n_shards != to or summary["to_shards"] != to:
            raise AssertionError(f"reshard to {to} left {new.n_shards} shards")
        if out["host_pulls"] > 1:  # the rows leave the card once a reshard, chunk by chunk
            raise AssertionError(f"reshard to {to} copied the whole slab to the host {out['host_pulls']} times")
        # the new generation's rows equal the old's (the source plus the
        # replayed delta) byte for byte, shard by shard
        keys_old, keys_new = sorted(old._slot_of), sorted(new._slot_of)
        if keys_old != keys_new:
            raise AssertionError(f"reshard to {to}: {len(keys_old)} keys before, {len(keys_new)} after")
        rows_old, rows_new = _key_rows(old, keys_old), _key_rows(new, keys_new)
        if not np.array_equal(rows_old.view(np.uint32), rows_new.view(np.uint32)):
            bad = int((rows_old.view(np.uint32) != rows_new.view(np.uint32)).any(axis=1).sum())
            raise AssertionError(f"reshard to {to}: {bad} rows differ from the old generation's")
        shard_rows = [len(free) for free in new._free_shard]
        try:
            old.add_batch_arrays(["stale"], np.zeros((1, ELASTIC_DIM), np.float32))
            raise AssertionError(f"reshard to {to}: a write through the old generation went through")
        except StaleGeneration:
            pass
        del old, out["old"], rows_old, rows_new
        # the writer's rows go again (through the live handle), so every
        # probe meets the rows it met before any reshard
        for keys in out["writes"]["mine"]:
            for key in keys:
                h.remove(key)
        gc.collect()
        if DEV != "cpu":
            sync_cards(torch, devs)
        extra_bytes = _card_bytes(torch, devs) - base_bytes - _slab_bytes(new)
        chunk_bytes = chunk * (ELASTIC_DIM * 4 + 1 + 4)
        if extra_bytes > chunk_bytes:
            raise AssertionError(f"reshard to {to}: {extra_bytes} bytes on the cards beyond one generation's slabs "
                                 f"(a chunk is {chunk_bytes}): the old slabs were not released")
        launches_new0 = dict(_build.LAUNCHES)
        after = out["single_window"]()
        got = h.search_batch(probes_dev, 10)
        bitwise = sum(g == r for g, r in zip(got, ref0))
        for g, r in zip(got, ref0):
            if [k for k, _ in g] != [k for k, _ in r] or max(abs(a - b) for (_, a), (_, b) in zip(g, r)) > 1e-5:
                raise AssertionError(f"after the reshard to {to} a probe answers otherwise than before any reshard")
        launches_new = {k: v - launches_new0.get(k, 0) for k, v in _build.LAUNCHES.items()}
        held = _kept_launches(lambda: _hold_generation(torch, new, probes_dev))
        if to == 2 and not entries and DEV != "cpu":
            entries = _kept_launches(lambda: sharded_entries(
                torch, [p[0] for p in new._slab], [p[2] for p in new._slab], probes_dev, "elastic_path's 2-shard "
                "generation", suffix=",2 shards"))
        m = out["marks"]
        during = reads["lat"]
        rec = dict(
            to_shards=to, from_shards=summary["from_shards"], generation=summary["generation"],
            rows_migrated=summary["rows_migrated"], chunks=-(-summary["rows_migrated"] // chunk),
            mttr_s=summary["mttr_s"], mttr_wall_s=out["mttr_wall"], export_s=m.get("export_s", 0.0),
            import_s=m.get("import_s", 0.0), finish_s=m.get("finish_s", 0.0), barrier_s=m.get("barrier_s", 0.0),
            delta_and_cutover_s=summary["mttr_s"] - sum(m.get(k, 0.0) for k in ("export_s", "import_s", "finish_s",
                                                                               "barrier_s")),
            rows_per_s=summary["rows_migrated"] / max(summary["mttr_s"], 1e-9), whole_slab_host_copies=out[
                "host_pulls"], reads_issued=reads["issued"], served_fraction=reads["served"] / max(1, reads["issued"]),
            probe_batches_during=reads["batches"], writes_added=out["writes"]["added"],
            writes_removed=out["writes"]["removed"], query_before=_percentiles(out["before"]),
            query_during=_percentiles(during), query_after=_percentiles(after),
            elastic_p99_blowup_ratio=float(np.percentile(during, 99) / np.percentile(out["before"], 99)),
            probes_bitwise_equal=bitwise, free_slots_a_shard=shard_rows, bytes_beyond_one_generation=extra_bytes,
            launches_old_generation=out["launches_during"], launches_new_generation={
                k: v for k, v in launches_new.items() if v}, held=held,
        )
        emit("elastic_reshard", step=step, **rec)
        steps_out.append(rec)
    return dict(rows=n_rows, removed=len(removed), build_s=build_s, steps=steps_out), entries, ref0


def _same_answers(got, want) -> bool:
    """The answers of a resharded index against its answers before: byte for
    byte on the card (B2 scores a row the same on any shard); on the CPU's
    plain path, keys equal and scores at 1e-5 (the CPU's matrix product sums
    in an order that depends on the slab's shape)."""
    if DEV != "cpu":
        return got == want
    return [[k for k, _ in r] for r in got] == [[k for k, _ in r] for r in want] and all(
        abs(a - b) <= 1e-5 for g, w in zip(got, want) for (_, a), (_, b) in zip(g, w))


def _elastic_tiered_packed(pw, torch, n_tier, tier_hot, tier_clusters, n_tenants, per_tenant, probed, n_cold,
                           chunk) -> dict:
    """Part 2: a tiered index (int8 cold tier on the host) and a tenant-packed
    slab, each resharded 1 -> 2 -> 1: hot and cold membership and tenant
    extents preserved, the probes answered byte for byte as before."""
    import numpy as np

    from pathway_tpu_torch.ops.tiered_knn import TierConfig, TieredKnnIndex
    from pathway_tpu_torch.tenancy import TenantPackedIndex

    rng = np.random.default_rng(SEED + 33)
    probes = rng.standard_normal((ELASTIC_PROBES, ELASTIC_DIM), dtype=np.float32)
    out = {}
    t0 = time.perf_counter()
    tier = TieredKnnIndex(ELASTIC_DIM, reserved_space=n_tier, device=DEV, tiers=TierConfig(
        hot_rows=tier_hot, n_clusters=tier_clusters, cold_dtype="int8"))
    for start in range(0, n_tier, 1 << 14):
        rows = rng.standard_normal((min(1 << 14, n_tier - start), ELASTIC_DIM), dtype=np.float32)
        tier.add_batch_arrays(list(range(start, start + len(rows))), rows)
    ht = pw.elastic.register_handle(tier)
    ref = ht.search_batch(probes, 10)
    member = (sorted(tier.hot._slot_of), tier._cold_total)
    build_s = time.perf_counter() - t0
    tier_steps = []
    for to in (2, 1):
        s = pw.elastic.reshard(to, chunk_rows=chunk)
        got = ht.search_batch(probes, 10)
        now = (sorted(ht.index.hot._slot_of), ht.index._cold_total)
        if now != member or sum(ht.index._cold_docs_shard) != member[1] or ht.index.n_shards != to:
            raise AssertionError(f"tiered reshard to {to}: hot or cold membership changed")
        if not _same_answers(got, ref):
            raise AssertionError(f"tiered reshard to {to}: the probes answer otherwise than before")
        tier_steps.append(dict(to_shards=to, mttr_s=s["mttr_s"], rows_migrated=s["rows_migrated"]))
    out["tiered"] = dict(rows=n_tier, hot=len(member[0]), cold=member[1], build_s=build_s, steps=tier_steps)
    del ht, tier

    t0 = time.perf_counter()
    packed = TenantPackedIndex(ELASTIC_DIM, reserved_space=n_tenants * per_tenant, device=DEV)
    tenants = [f"t{i}" for i in range(n_tenants)]
    for t in tenants:
        packed.add_tenant_batch(t, list(range(per_tenant)),
                                rng.standard_normal((per_tenant, ELASTIC_DIM), dtype=np.float32))
    for t in tenants[:n_cold]:
        packed._demote(t)
    hp = pw.elastic.register_handle(packed)
    # half the cold tenants (one search each way: two would promote them) and hot ones
    asked = tenants[: n_cold // 2] + [tenants[n_cold + i] for i in rng.choice(n_tenants - n_cold, probed,
                                                                              replace=False)]
    tq = probes[:16]

    def layout(idx):
        """A tenant's rows, granted rows and residency (its extents may split
        where a target shard's room ended, but never across two shards)."""
        c = idx.shard_capacity
        for t, segs in idx._segments.items():
            if any(start // c != (start + size - 1) // c for start, size in segs):
                raise AssertionError(f"tenant {t}'s extent {segs} spans two shards")
        return {t: (idx.tenant_docs(t), idx.tenant_is_cold(t), idx._tenant_rows.get(t, 0)) for t in tenants}

    before = layout(packed)
    ref = {t: hp.search_tenant_batch(t, tq, 10) for t in asked}
    build_s = time.perf_counter() - t0
    packed_steps = []
    for to in (2, 1):
        s = pw.elastic.reshard(to, chunk_rows=chunk)
        if layout(hp.index) != before or hp.index.n_shards != to:
            raise AssertionError(f"packed reshard to {to}: tenant extents or cold tenants changed")
        for t in asked:
            if not _same_answers(hp.search_tenant_batch(t, tq, 10), ref[t]):
                raise AssertionError(f"packed reshard to {to}: tenant {t} answers otherwise than before")
        packed_steps.append(dict(to_shards=to, mttr_s=s["mttr_s"], rows_migrated=s["rows_migrated"]))
    out["packed"] = dict(tenants=n_tenants, per_tenant=per_tenant, cold_tenants=n_cold, probed_tenants=len(asked),
                         build_s=build_s, steps=packed_steps)
    return out


def _elastic_rows(n: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).standard_normal((n, ELASTIC_DIM), dtype=np.float32)


def _elastic_child(spec_json: str) -> int:
    """A process of part 3: ``controller`` (a ``pw.run(mesh="auto",
    elastic=)`` run that embeds documents with B1 into a registered index
    until the controller grows it on its HBM watermark; its ``/metrics``
    scraped), ``crash`` (a reshard of a persisted index SIGKILLed at
    ``elastic.migrate_chunk``) or ``recover`` (the restart: the intent
    found and the reshard completed). The report goes to ``spec["report"]``."""
    global DEV, RECOVERY_TINY
    spec = json.loads(spec_json)
    DEV, RECOVERY_TINY = spec["dev"], spec.get("tiny")
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.persistence import EnginePersistence
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.parallel.mesh import set_device_pool

    torch.backends.cuda.matmul.allow_tf32 = False
    if spec.get("pool"):
        set_device_pool(spec["pool"])
    report: dict = {"role": spec["role"]}
    if spec["role"] == "controller":
        report.update(_elastic_controller_run(pw, torch, spec))
    else:
        persistence = EnginePersistence(pw.persistence.Config.simple_config(
            pw.persistence.Backend.filesystem(spec["root"])))
        index = pw.DeviceKnnIndex(ELASTIC_DIM, reserved_space=spec["rows"], device=DEV)
        rows = _elastic_rows(spec["rows"], SEED + 61)
        index.add_batch_device(list(range(spec["rows"])), torch.from_numpy(rows).to(DEV))
        h = pw.elastic.register_handle(index)
        if spec["role"] == "crash":
            pw.elastic.reshard(2, chunk_rows=spec["chunk"])  # the chaos rule kills this process mid-migration
            return 3
        probes = torch.from_numpy(_elastic_rows(spec["probes"], SEED + 62)).to(DEV)
        report["intent"] = persistence.reshard_intent()
        _build.reset_launches()
        t0 = time.perf_counter()
        summary = pw.elastic.recover_pending_reshard(complete=True)
        report["recover_s"] = time.perf_counter() - t0
        report.update(recovered=summary is not None, n_shards=h.index.n_shards, generation=h.generation,
                      answers=h.search_batch(probes, 10), intent_after=persistence.reshard_intent(),
                      launches=dict(_build.LAUNCHES))
    with open(spec["report"], "w") as f:
        json.dump(report, f)
    return 0


def _elastic_controller_run(pw, torch, spec) -> dict:
    """The controller child's run (see :func:`_elastic_child`)."""
    import threading
    import urllib.request

    import numpy as np

    from pathway_tpu_torch.internals.ledger import LEDGER
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import topk_agreement

    n_docs, per_epoch = spec["docs"], spec["per_epoch"]
    texts = _synthetic_texts_bulk(np.random.default_rng(SEED + 51), n_docs, 20, 220)
    embedder = _recovery_embedder()
    dim = embedder.get_embedding_dimension()
    # the slab starts small and doubles as the documents arrive
    index = pw.DeviceKnnIndex(dim, reserved_space=n_docs // 16, device=DEV)
    h = pw.elastic.register_handle(index)
    slab = n_docs * (dim * 4 + 1 + 4)
    # the budget: the booked weights plus the slab of every document, so the
    # index's booking crosses the watermark once it holds about half of them
    weights = LEDGER.total_bytes()
    os.environ["PATHWAY_HBM_BYTES"] = str(weights + slab)
    frac = (weights + 0.5 * slab) / (weights + slab)
    port = _free_port()
    cv = threading.Condition()
    state = {"rows": 0, "pending": [], "scrape": None, "grown_at": None}

    class Documents(pw.io.python.ConnectorSubject):
        def run(self):
            ctx = self._ctx
            for b in range(0, n_docs, per_epoch):
                e = min(n_docs, b + per_epoch)
                ctx.insert_batch({"doc_id": list(range(b, e)), "text": texts[b:e]})
                ctx.commit()
                with cv:
                    while state["rows"] < e and not ctx.wait_stopped(0):
                        cv.wait(0.05)

    class DocSchema(pw.Schema, append_only=True):
        doc_id: int
        text: str

    docs = pw.io.python.read(Documents(), schema=DocSchema, autocommit_duration_ms=None)
    vecs = docs.select(doc_id=pw.this.doc_id, vec=embedder(pw.this.text))

    def on_row(key, row, time, is_addition):
        state["pending"].append((row["doc_id"], np.asarray(row["vec"], np.float32)))

    def on_epoch_end(time_):
        batch, state["pending"] = state["pending"], []
        if batch:
            dev = torch.from_numpy(np.stack([v for _, v in batch])).to(h.index.device)
            h.add_batch_device([k for k, _ in batch], dev)
        if state["rows"] + len(batch) >= n_docs and state["scrape"] is None:
            deadline = time.monotonic() + 120.0
            while (h.generation < 1 or h._migrating) and time.monotonic() < deadline:
                time.sleep(0.02)
            state["grown_at"] = h.generation
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
                state["scrape"] = resp.read().decode()
        with cv:
            state["rows"] += len(batch)
            cv.notify_all()

    pw.io.subscribe(vecs, on_row, on_time_end=on_epoch_end)
    _build.reset_launches()
    t0 = time.perf_counter()
    pw.run(mesh="auto", elastic=f"hbm_frac={frac:.6f},max=2,interval=0.05", with_http_server=True,
           monitoring_http_port=port)
    run_s = time.perf_counter() - t0
    scrape = state["scrape"] or ""
    lines = [ln for ln in scrape.splitlines() if ln.startswith("pathway_elastic_")]
    gen = [float(ln.split()[-1]) for ln in lines if ln.startswith("pathway_elastic_generation")]
    if not gen or gen[0] < 1 or 'reason="hbm_watermark"' not in scrape:
        raise AssertionError(f"the run's scrape shows no grown generation: {lines}")
    if h.index.n_shards != 2 or len(h) != n_docs:
        raise AssertionError(f"the controller left {h.index.n_shards} shards and {len(h)} of {n_docs} rows")
    # the answers: the index's top-k against the plain top-k over its rows
    q = embedder._encoder.encode_device(texts[:64]).float()
    keys = sorted(h.index._slot_of)
    rows = torch.from_numpy(_key_rows(h.index, keys)).to(q.device)
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    vp, ip = torch.topk(qn @ rows.T, 10, dim=1)
    got = h.search_batch(q, 10)
    vk = torch.tensor([[s for _, s in r] for r in got])
    ik = torch.tensor([[k for k, _ in r] for r in got])
    share, ok = topk_agreement(vk, ik, vp.cpu(), torch.tensor(keys)[ip.cpu()], atol=1e-5, rtol=1e-5)
    if not ok:
        raise AssertionError(f"the grown index's answers disagree with the plain top-k over its rows ({share})")
    self_top1 = float(np.mean([r[0][0] == i for i, r in enumerate(got)]))
    return dict(docs=n_docs, run_s=run_s, shards=h.index.n_shards, generation=h.generation,
                generation_when_scraped=state["grown_at"], hbm_frac=frac, budget_bytes=weights + slab,
                elastic_lines=lines, answers_agreement=share, self_top1=self_top1, launches=dict(_build.LAUNCHES))


def phase_elastic_path(torch, n_rows: int = ELASTIC_ROWS, chunk: int = ELASTIC_CHUNK, n_probes: int = ELASTIC_PROBES,
                       n_singles: int = ELASTIC_SINGLES, n_tier: int = ELASTIC_TIER_ROWS,
                       tier_hot: int = ELASTIC_TIER_HOT, tier_clusters: int = ELASTIC_TIER_CLUSTERS,
                       n_tenants: int = ELASTIC_TENANTS, per_tenant: int = ELASTIC_TENANT_DOCS,
                       probed: int = ELASTIC_TENANT_PROBED, n_cold: int = ELASTIC_TENANT_COLD,
                       run_docs: int = ELASTIC_RUN_DOCS, run_epoch: int = ELASTIC_RUN_EPOCH,
                       crash_rows: int = ELASTIC_CRASH_ROWS, crash_hit: int = ELASTIC_CRASH_HIT) -> tuple[dict, list]:
    """The elastic reshard plane on the card (see the module docstring):
    part 1 the flat index under traffic, part 2 the tiered and packed
    indexes, part 3 the run wiring, the controller and a crash in child
    processes. Returns the launch counts of the path's counted runs and the
    2-shard ``knn_topk_sharded`` kernel rows."""
    import gc
    import shutil
    import signal
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.elastic.metrics import ELASTIC_METRICS
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.parallel.mesh import set_device_pool

    t_phase = time.perf_counter()
    pool, steps, where = elastic_plan(torch)
    gc.collect()
    if DEV != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    folder = tempfile.mkdtemp(prefix="elastic_", dir=build_dir)
    prev_pool = set_device_pool(pool)
    children = []
    try:
        # part 3's children start first and run beside parts 1 and 2
        child = "import sys, chip_smoke; sys.exit(chip_smoke._elastic_child(sys.argv[1]))"

        def spec(role: str, **kw) -> dict:
            return dict(role=role, dev=DEV, tiny=RECOVERY_TINY, report=os.path.join(folder, f"{role}.json"),
                        pool=(["cpu"] * 2 if DEV == "cpu" else pool[:2]) if pool else None, **kw)

        spec_ctl = spec("controller", docs=run_docs, per_epoch=run_epoch)
        spec_crash = spec("crash", root=os.path.join(folder, "root"), rows=crash_rows, chunk=chunk)
        children.append(_spawn_child(child, json.dumps(spec_ctl)))
        chaos_env = dict(os.environ, PATHWAY_CHAOS=json.dumps(
            [{"site": "elastic.migrate_chunk", "action": "kill", "hit": crash_hit}]))
        proc_crash = _spawn_child(child, json.dumps(spec_crash), env=chaos_env)
        children.append(proc_crash)

        pw.elastic.reset_registry()
        ELASTIC_METRICS.reset()
        _build.reset_launches()
        t0 = time.perf_counter()
        flat, entries, _ = _elastic_flat(pw, torch, steps, chunk, n_rows, n_probes, n_singles)
        flat["seconds"] = time.perf_counter() - t0
        flat["cards"] = where
        pw.elastic.reset_registry()
        gc.collect()
        t0 = time.perf_counter()
        parts = _elastic_tiered_packed(pw, torch, n_tier, tier_hot, tier_clusters, n_tenants, per_tenant, probed,
                                       n_cold, chunk)
        parts["seconds"] = time.perf_counter() - t0
        emit("elastic_tiered_packed", **parts)
        pw.elastic.reset_registry()
        launches = collections.Counter(_build.LAUNCHES)

        # part 3: the crash, its restart, and the controller run
        t0 = time.perf_counter()
        proc_crash.communicate(timeout=ELASTIC_CHILD_TIMEOUT)
        if proc_crash.returncode != -signal.SIGKILL:
            raise AssertionError(f"the crash child exited {proc_crash.returncode}, not killed at "
                                 "elastic.migrate_chunk")
        spec_rec = dict(spec_crash, role="recover", probes=n_probes, report=os.path.join(folder, "recover.json"))
        _child_result(_spawn_child(child, json.dumps(spec_rec)), "the restarted child", ELASTIC_CHILD_TIMEOUT)
        rec = json.load(open(spec_rec["report"]))
        twin = pw.DeviceKnnIndex(ELASTIC_DIM, reserved_space=crash_rows, device=DEV)
        twin.add_batch_device(list(range(crash_rows)), torch.from_numpy(_elastic_rows(crash_rows, SEED + 61)).to(DEV))
        want = _kept_launches(lambda: twin.search_batch(
            torch.from_numpy(_elastic_rows(n_probes, SEED + 62)).to(DEV), 10))
        del twin
        if rec["intent"] is None or rec["intent"][0] != 2 or not rec["recovered"] or rec["n_shards"] != 2:
            raise AssertionError(f"the restart found intent {rec['intent']} and left {rec['n_shards']} shards")
        if rec["intent_after"] is not None:
            raise AssertionError("the recovered reshard left its intent behind")
        got = [[(k, s) for k, s in row] for row in rec["answers"]]
        if [[k for k, _ in r] for r in got] != [[k for k, _ in r] for r in want] or max(
                abs(a - b) for g, w in zip(got, want) for (_, a), (_, b) in zip(g, w)) > 1e-5:
            raise AssertionError("the recovered index answers otherwise than its unkilled twin")
        crash = dict(rows=crash_rows, killed_at_chunk=crash_hit, intent=rec["intent"], generation=rec["generation"],
                     recover_s=rec["recover_s"], answers_bitwise_equal=sum(g == w for g, w in zip(got, want)))
        _child_result(children[0], "the controller child", ELASTIC_CHILD_TIMEOUT)
        ctl = json.load(open(spec_ctl["report"]))
        crash["seconds"] = time.perf_counter() - t0
        emit("elastic_run_and_crash", controller=ctl, crash=crash)
        launches.update(rec.get("launches") or {})
        launches.update(ctl.get("launches") or {})
    finally:
        set_device_pool(prev_pool)
        pw.elastic.reset_registry()
        for proc in children + [p for p in _CHILDREN if p not in children]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(folder, ignore_errors=True)
    if DEV != "cpu":
        needed = ("knn_topk_stream", "knn_topk_tc", "knn_topk_merge", "knn_topk_sharded_merge", "gemm_bias_act",
                  "gemm_bias_residual_layernorm")
        missing = [k for k in needed if launches.get(k, 0) == 0]
        if missing or not (launches.get("masked_attention", 0) or launches.get("segment_attention", 0)):
            raise AssertionError(f"elastic_path never launched {missing} (or B1's attention)")
    emit("elastic_path", seconds=time.perf_counter() - t_phase, cards=where, flat=flat, launches=dict(launches))
    return dict(launches), entries


# cluster_path: the documents (65,536 halved for the script's time, 32,768 halved again for the twenty-first
# path), a commit's documents, the single queries and their k, the lease
CLUSTER_DOCS, CLUSTER_EPOCH, CLUSTER_QUERIES, CLUSTER_K = 16_384, 1024, 512, 10
CLUSTER_LEASE_MS = 2000
CLUSTER_CHILD_TIMEOUT = 300.0


def _status_generation(port: int) -> int:
    """The cluster generation ``/status`` shows (0 before any)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=30) as resp:
        return int(json.loads(resp.read().decode()).get("cluster", {}).get("generation", 0))


def _cluster_program() -> int:
    """One process of ``cluster_path``'s user program, which ``python -m
    pathway_tpu_torch spawn --processes P`` runs in every process of the
    cluster. The documents (``pw.io.python.read``, persisted, one commit of
    ``per_epoch`` an epoch, the next once the last was delivered) are read
    on process 0 and keyed by id through a groupby, which exchanges them by
    key shard; a ``.select`` embeds them with ``SentenceTransformerEmbedder``
    (MiniLM-L6 at full width, seeded: B1) in the process that owns each
    key. On process 0 the embeddings reach a ``DeviceKnnIndex`` (cos)
    registered with the elastic plane and a jsonlines sink; at
    ``reshard_at`` delivered documents process 0 reshards the index 1 -> 2
    and reads the cluster's generation from ``/status`` before and after.
    When the run ends process 0 answers the single queries (B1, then B2).
    Every process writes its pid when it starts and a report when it ends
    (its launch counts and the encoder's device seconds)."""
    global DEV, RECOVERY_TINY
    t_entry = time.time()
    with open(os.environ["CLUSTER_SPEC"]) as f:
        spec = json.load(f)
    DEV, RECOVERY_TINY = spec["dev"], spec.get("tiny")
    import threading

    import numpy as np
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import flight_recorder
    from pathway_tpu_torch.internals.chip_ledger import CHIP_LEDGER
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.parallel.mesh import set_device_pool
    from pathway_tpu_torch.resilience.cluster import CLUSTER_METRICS

    torch.backends.cuda.matmul.allow_tf32 = False
    pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    out = spec["out"]
    with open(f"{out}.pid.{pid}", "w") as f:
        f.write(str(os.getpid()))
    on_card = DEV != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_docs, per_epoch = spec["n_docs"], spec["per_epoch"]
    texts, queries = _recovery_corpus(n_docs, spec["n_queries"])
    embedder = _recovery_embedder()
    embedder._encoder.encode_device(texts[:8], pad_to=8)  # warm-up: handles, first launches
    sync()
    cards = torch.cuda.device_count() if on_card else 0
    set_device_pool([f"cuda:{i % cards}" for i in range(2)] if on_card else ["cpu"] * 2)
    h = pw.elastic.register_handle(
        pw.DeviceKnnIndex(embedder.get_embedding_dimension(), reserved_space=n_docs, device=DEV))
    cv = threading.Condition()
    state = {"rows": 0, "pending": [], "epochs": [], "status_generation": [], "reshard": None}

    class Documents(pw.io.python.ConnectorSubject):
        supports_offsets = True

        def run(self):
            ctx = self._ctx  # a regrouped run hands the subject a new context
            for b in range(int(ctx.offsets.get("__seq__", 0)), n_docs, per_epoch):
                e = min(n_docs, b + per_epoch)
                ctx.insert_batch({"doc_id": list(range(b, e)), "text": texts[b:e]})
                ctx.commit()
                with cv:
                    while state["rows"] < e:
                        if ctx.wait_stopped(0):
                            return
                        cv.wait(0.05)

    class DocSchema(pw.Schema, append_only=True):
        doc_id: int
        text: str

    docs = pw.io.python.read(Documents(), schema=DocSchema, autocommit_duration_ms=None, persistent_id="docs")
    keyed = docs.groupby(pw.this.doc_id).reduce(pw.this.doc_id, text=pw.reducers.any(pw.this.text))
    vecs = keyed.select(doc_id=pw.this.doc_id, vec=embedder(pw.this.text))

    def on_row(key, row, time, is_addition):  # (``time``: the epoch)
        state["pending"].append((row["doc_id"], row["vec"]))

    def on_epoch_end(epoch):
        batch, state["pending"] = state["pending"], []
        if batch:
            dev = torch.from_numpy(np.stack([np.asarray(v, np.float32) for _, v in batch])).to(h.index.device)
            h.add_batch_device([k for k, _ in batch], dev)
        delivered = state["rows"] + len(batch)
        state["epochs"].append((time.time(), delivered))
        if spec["reshard_at"] and delivered >= spec["reshard_at"] and state["reshard"] is None:
            state["status_generation"].append(_status_generation(spec["status_port"]))
            t0 = time.perf_counter()
            state["reshard"] = dict(pw.elastic.reshard(2), seconds=time.perf_counter() - t0, at_docs=delivered)
            state["status_generation"].append(_status_generation(spec["status_port"]))
        with open(f"{out}.progress", "w") as f:
            f.write(str(delivered))
        with cv:
            state["rows"] = delivered
            cv.notify_all()

    pw.io.subscribe(vecs, on_row, on_time_end=on_epoch_end)
    pw.io.jsonlines.write(vecs.select(pw.this.doc_id), f"{out}.sink")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(spec["root"]))
    _build.reset_launches()
    t_ready = time.time()
    t0 = time.perf_counter()
    pw.run(persistence_config=cfg, cluster_lease_ms=spec["lease_ms"], chip_ledger=True, monitoring_level="none",
           with_http_server=pid == 0, monitoring_http_port=spec["status_port"] if pid == 0 else None)
    sync()
    run_s = time.perf_counter() - t0
    t_run_end = time.time()
    encode = CHIP_LEDGER.snapshot().get("accounts", {}).get("encode", {})
    report = dict(pid=pid, os_pid=os.getpid(), run_s=run_s, encode_device_s=encode.get("seconds", 0.0),
                  generation=int(os.environ.get("PATHWAY_CLUSTER_GENERATION", "0") or 0),
                  run_launches=dict(_build.LAUNCHES))
    if pid == 0:
        q = embedder._encoder.encode_device(queries)
        hits = h.search_batch(q, spec["k"])
        sync()
        dumps = [flight_recorder.load_dump(p) for p in flight_recorder.list_dumps(spec["dumps"])]
        restarts = [e["time"] for d in dumps if d.get("reason") == "cluster.partial_restart" for e in d["events"]
                    if e["kind"] == "cluster.partial_restart"]
        report.update(answers=[[[int(i), float(s)] for i, s in row] for row in hits], rows=len(h),
                      shards=h.index.n_shards, epochs=state["epochs"], reshard=state["reshard"],
                      status_generation=state["status_generation"], partial_restart_at=sorted(set(restarts)),
                      cluster=CLUSTER_METRICS.snapshot())
    report["launches"] = dict(_build.LAUNCHES)
    # where a process's wall goes: started (interpreter, imports), set up
    # (encoder, corpus, warm-up), ran, then the queries and the report
    report["wall"] = dict(entry=t_entry, ready=t_ready, run_end=t_run_end, done=time.time())
    with open(f"{out}.report.{pid}.json", "w") as f:
        json.dump(report, f)
    return 0


def _cluster_dumps_digest(folder: str, last: int = 30) -> str:
    """The flight-recorder dumps a failed cluster run left: each one's
    reason, process and last events, for the failure's message."""
    from pathway_tpu_torch.internals import flight_recorder

    lines = []
    for path in flight_recorder.list_dumps(folder):
        d = flight_recorder.load_dump(path)
        lines.append(f"dump {os.path.basename(path)}: reason={d.get('reason')} process={d.get('process_id')} "
                     f"error={str(d.get('error'))[:300]}")
        for e in d["events"][-last:]:
            fields = {k: v for k, v in e.items() if k not in ("seq", "kind", "time")}
            lines.append(f"  {e['time']:.3f} {e['kind']} {json.dumps(fields, default=str)[:160]}")
    return "\n".join(lines)


def _cluster_run(folder: str, corpus: str, tag: str, processes: int, n_docs: int, per_epoch: int, n_queries: int,
                 reshard_at: int = 0, kill_at: int = 0) -> dict:
    """One spawn of the cluster program (see :func:`_cluster_program`)
    through the port's CLI, in a session of its own so that every process it
    starts (the spawned ones and a respawned worker) goes when it ends.
    ``kill_at``: SIGKILL worker 1 once that many documents are delivered."""
    import signal

    out = os.path.join(folder, tag)
    spec = dict(dev=DEV, tiny=RECOVERY_TINY, n_docs=n_docs, per_epoch=per_epoch, n_queries=n_queries,
                k=CLUSTER_K, root=os.path.join(folder, f"root_{tag}"), out=out, lease_ms=CLUSTER_LEASE_MS,
                reshard_at=reshard_at, status_port=_free_port(), dumps=os.path.join(folder, f"blackbox_{tag}"))
    with open(out + ".spec.json", "w") as f:
        json.dump(spec, f)
    with open(os.path.join(folder, "prog.py"), "w") as f:
        f.write("import sys, chip_smoke\nsys.exit(chip_smoke._cluster_program())\n")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RECOVERY_CORPUS=corpus, CLUSTER_SPEC=out + ".spec.json",
               PATHWAY_CLUSTER_RESPAWN="1" if kill_at else "0", PATHWAY_FLIGHT_RECORDER_DIR=spec["dumps"])
    cmd = [sys.executable, "-m", "pathway_tpu_torch", "spawn", "--processes", str(processes), "--first-port",
           str(_free_port()), os.path.join(folder, "prog.py")]
    t0 = time.perf_counter()
    t_spawn = time.time()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    killed = None
    try:
        if kill_at:
            deadline = time.monotonic() + CLUSTER_CHILD_TIMEOUT
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"run {tag} ended (exit {proc.returncode}) before its worker was killed:\n"
                                         f"{proc.communicate()[1][-4000:]}")
                try:
                    with open(out + ".progress") as f:
                        delivered = int(f.read() or 0)
                except (OSError, ValueError):
                    delivered = 0
                if delivered >= kill_at:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"run {tag} delivered {delivered} documents in {CLUSTER_CHILD_TIMEOUT} s")
                time.sleep(0.02)
            with open(out + ".pid.1") as f:
                victim = int(f.read())
            killed = dict(at_docs=delivered, wall=time.time(), os_pid=victim)
            os.kill(victim, signal.SIGKILL)
        try:
            _out, err = proc.communicate(timeout=CLUSTER_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"run {tag} did not finish in {CLUSTER_CHILD_TIMEOUT} s") from None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # the session: spawn, its processes, a respawned worker
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.communicate()
    wall_s = time.perf_counter() - t0
    t_exit = time.time()
    # a killed worker makes spawn exit 128 + 9, as the reference's does
    if proc.returncode != (128 + signal.SIGKILL if killed else 0):
        raise AssertionError(f"run {tag}: spawn exited {proc.returncode}:\n{err[-3000:]}\n"
                             f"{_cluster_dumps_digest(spec['dumps'])}")
    reports = {}
    for p in range(processes):
        with open(f"{out}.report.{p}.json") as f:
            reports[p] = json.load(f)
    with open(out + ".sink") as f:
        sink = [json.loads(line) for line in f]
    w = reports[0]["wall"]
    split = dict(start_s=w["entry"] - t_spawn, setup_s=w["ready"] - w["entry"], run_s=w["run_end"] - w["ready"],
                 queries_s=w["done"] - w["run_end"], exit_s=t_exit - w["done"])
    return dict(reports=reports, sink=sink, killed=killed, wall_s=wall_s, spec=spec, split=split)


def phase_cluster_path(torch, n_docs: int = CLUSTER_DOCS, per_epoch: int = CLUSTER_EPOCH,
                       n_queries: int = CLUSTER_QUERIES) -> dict:
    """The multi-process cluster on the card: one user program (see
    :func:`_cluster_program`) spawned through ``python -m pathway_tpu_torch
    spawn``: run A in one process (the twin), run B in two processes whose
    process 0 reshards its index 1 -> 2 at half the documents, run C in two
    processes whose worker 1 is SIGKILLed at a third of them and respawned
    alone (``PATHWAY_CLUSTER_RESPAWN=1``). Gated on every document delivered
    once in every run, B's and C's answers against A's (``topk_agreement``
    at ``HIT_TOL``), B1 launching in both processes of B and C and B2 on
    process 0, the generation ``/status`` shows going 0 -> 1 at B's cutover,
    and exactly one partial restart in C that took the generation 0 -> 1.
    Returns the launches the runs' processes counted."""
    import pickle
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    folder = tempfile.mkdtemp(prefix="cluster_", dir=build_dir)
    try:
        corpus = os.path.join(folder, "corpus.pkl")
        with open(corpus, "wb") as f:
            pickle.dump(_recovery_corpus(n_docs, n_queries), f, protocol=4)
        runs = {}
        for tag, processes, kw in (("A", 1, {}), ("B", 2, {"reshard_at": n_docs // 2}),
                                   ("C", 2, {"kill_at": n_docs // 3})):
            runs[tag] = _cluster_run(folder, corpus, tag, processes, n_docs, per_epoch, n_queries, **kw)
    finally:
        shutil.rmtree(folder, ignore_errors=True)

    # ---- gates
    for tag, run in runs.items():
        ids = collections.Counter(rec["doc_id"] for rec in run["sink"])
        if sorted(ids) != list(range(n_docs)) or max(ids.values()) != 1 or any(r["diff"] != 1 for r in run["sink"]):
            raise AssertionError(f"run {tag} delivered {len(ids)} of {n_docs} documents, "
                                 f"{sum(v > 1 for v in ids.values())} of them more than once")
        p0 = run["reports"][0]
        if p0["rows"] != n_docs or len(p0["answers"]) != n_queries:
            raise AssertionError(f"run {tag}: the index holds {p0['rows']} rows, {len(p0['answers'])} answers")
    a, b, c = (runs[t]["reports"][0] for t in "ABC")
    agreement = {}
    for tag, rep in (("B", b), ("C", c)):
        share, ok = _hits_agree(rep["answers"], a["answers"], CLUSTER_K)
        agreement[tag] = share
        if not ok:
            raise AssertionError(f"run {tag}'s answers disagree with the one-process twin's ({share})")
    if b["status_generation"] != [0, 1] or b["shards"] != 2 or b["cluster"]["partial_restarts_total"]:
        raise AssertionError(f"B's reshard: /status generation {b['status_generation']}, {b['shards']} shards, "
                             f"{b['cluster']['partial_restarts_total']} partial restarts")
    if c["cluster"]["partial_restarts_total"] != 1 or c["cluster"]["generation"] != 1 or \
            runs["C"]["reports"][1]["generation"] != 1 or len(c["partial_restart_at"]) != 1:
        raise AssertionError(f"C: {c['cluster']}, the respawned worker at generation "
                             f"{runs['C']['reports'][1]['generation']}")
    b1 = ("gemm_bias_act", "gemm_bias_residual_layernorm")
    per_process = {f"{t}{p}": {k: rep["run_launches"].get(k, 0) for k in b1 + ("masked_attention",
                                                                               "segment_attention")}
                   for t in "ABC" for p, rep in runs[t]["reports"].items()}
    if DEV != "cpu":
        dead = [w for w, ks in per_process.items() if not all(ks[k] for k in b1)]
        b2 = {t: sum(runs[t]["reports"][0]["launches"].get(k, 0) for k in ("knn_topk_stream", "knn_topk_tc"))
              for t in "ABC"}
        if dead or not all(b2.values()):
            raise AssertionError(f"B1 did not launch in {dead}, or B2 on process 0: {b2}")

    # ---- report: rates, the kill's detection and repair (the reference's names)
    killed = runs["C"]["killed"]
    restart_at = c["partial_restart_at"][0]
    before = [t for t, _n in c["epochs"] if t < restart_at]
    after = [t for t, _n in c["epochs"] if t > restart_at]
    launches = collections.Counter()
    for run in runs.values():
        for rep in run["reports"].values():
            launches.update(rep["launches"])
    emit("cluster_path", seconds=time.perf_counter() - t_phase, docs=n_docs, per_epoch=per_epoch,
         queries=n_queries, docs_per_s={t: n_docs / runs[t]["reports"][0]["run_s"] for t in "ABC"},
         run_s={t: runs[t]["reports"][0]["run_s"] for t in "ABC"}, spawn_wall_s={t: runs[t]["wall_s"] for t in "ABC"},
         wall_split={t: runs[t]["split"] for t in "ABC"},
         b1_launches=per_process,
         encode_device_ms={f"{t}{p}": rep["encode_device_s"] * 1e3 for t in "ABC"
                           for p, rep in runs[t]["reports"].items()},
         answers_agreement=agreement, reshard=b["reshard"], status_generation=b["status_generation"],
         killed_at_docs=killed["at_docs"], partial_restarts=c["cluster"]["partial_restarts_total"],
         generation_after_restart=c["cluster"]["generation"],
         kill_to_detection_ms=(restart_at - killed["wall"]) * 1e3,
         cluster_detection_latency_ms=(restart_at - before[-1]) * 1e3 if before else None,
         cluster_mttr_ms=(after[0] - restart_at) * 1e3 if after else None, launches=dict(launches))
    return dict(launches)


# ------------------------------------------------------------------ clip_path

CLIP_IMAGES = 4096  # uint8 224 x 224 images from a numpy seed
CLIP_ROWS = 1 << 20  # the image index's rows: the 4,096 images and seeded filler (d 512, 2 GiB f32)
CLIP_QUERY_SIZES = (1, 16, 256)  # encode_text queries a search (B2's streaming pass, its boundary, its tensor cores)
CLIP_K = 16
CLIP_DIM = 512  # CLIPConfig().embed_dim, the image index's width
CLIP_WIRE_MIN_COS = 0.99  # yuv420 against rgb: the reference's own bar (tests/test_fused_layer.py)
CLIP_STAGE_WORKERS = 6  # ingest-stage workers: most of an 8-core host


def phase_clip_path(torch, env: dict, n_images: int = CLIP_IMAGES, rows: int = CLIP_ROWS, config=None) -> dict:
    """CLIP ViT-B/32 (full width, bf16, seeded) into a 512-d device index.
    ``n_images`` uint8 images go through ``encode_image`` on both wires (rgb,
    yuv420) and, on the collaborative ingest stage, through ``encode_image``
    and ``encode_image_device`` into a ``DeviceKnnIndex(dim=512)`` filled to
    ``rows`` rows the way ``main_path`` fills its index; ``encode_text``
    queries search it at ``CLIP_QUERY_SIZES`` queries, k 16. Gates: the
    yuv420 wire within ``CLIP_WIRE_MIN_COS`` of the rgb one, the
    collaborative output byte-identical to the inline one,
    ``encode_image_device`` equal to ``encode_image``, every image's own row
    first among its neighbours, B2 at d 512 against its plain version
    (``topk_agreement`` 1e-5) at each query count, and B2's partial passes
    launching. Reports images/s per wire end to end and on pre-staged rows
    (the device alone), texts/s and peak memory."""
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch import DeviceKnnIndex
    from pathway_tpu_torch.ingest import stage as ingest_stage
    from pathway_tpu_torch.models import CLIPConfig, CLIPEncoder
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn_topk import knn_topk_reference, topk_agreement

    now = time.perf_counter
    t_phase = now()
    dev = torch.device(DEV)
    cfg = config or CLIPConfig()
    H = cfg.image_size
    rng = np.random.default_rng(SEED + 61)
    images = rng.integers(0, 256, (n_images, H, H, 3), dtype=np.uint8)
    words = [f"w{i}" for i in range(2000)]
    texts = [" ".join(rng.choice(words, int(rng.integers(3, 20)))) for _ in range(max(CLIP_QUERY_SIZES))]
    enc = CLIPEncoder(cfg, seed=SEED, max_batch=256, device=DEV)
    for wire in ("rgb", "yuv420"):  # warm-up: first launches, the library's handles
        enc.transport = wire
        enc.encode_image(images[:8])
    enc.encode_text(texts[:8])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    wires, per_s = {}, {}
    for wire in ("rgb", "yuv420"):
        enc.transport = wire
        t0 = now()
        wires[wire] = enc.encode_image(images)
        per_s[wire] = n_images / (now() - t0)
    cos = (wires["rgb"] * wires["yuv420"]).sum(axis=1)
    st = ingest_stage.configure_stage(CLIP_STAGE_WORKERS)
    try:
        t0 = now()
        staged = enc.encode_image(images)
        per_s["yuv420_stage"] = n_images / (now() - t0)
        t0 = now()
        embs = enc.encode_image_device(images)
        torch.cuda.synchronize()
        per_s["yuv420_stage_device"] = n_images / (now() - t0)
        # the device alone: wire rows already on the card, one tower call a batch of 256
        spans = range(0, n_images, 256)
        flat = torch.from_numpy(np.concatenate(list(st.map_ordered(
            lambda lo: enc._pack_image_batch(images[lo : lo + 256])[1], spans)))).to(dev)
    finally:
        ingest_stage.shutdown_stage()
    t0 = now()
    for lo in range(0, flat.shape[0], 256):
        enc._vfwd_yuv420(flat[lo : lo + 256])
    torch.cuda.synchronize()
    per_s["yuv420_prestaged"] = n_images / (now() - t0)
    del flat

    index = DeviceKnnIndex(dim=cfg.embed_dim, metric="cos", reserved_space=rows, device=DEV)
    t0 = now()
    index.add_batch_device(list(range(n_images)), embs)
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    step = 1 << 14
    for start in range(n_images, rows, step):
        stop = min(rows, start + step)
        index.add_batch_device(list(range(start, stop)),
                               F.normalize(torch.randn(stop - start, cfg.embed_dim, device=dev, generator=g), dim=1))
    torch.cuda.synchronize()
    fill_s = now() - t0
    if len(index) != rows:
        raise AssertionError(f"the image index holds {len(index)} rows of {rows}")
    t0 = now()
    self_hits = index.search_batch(embs, 1)
    self_s = now() - t0
    t0 = now()
    q_emb = enc.encode_text(texts)
    text_s = now() - t0
    search_ms = {}
    for q in CLIP_QUERY_SIZES:
        t0 = now()
        res = index.search_batch(q_emb[:q], CLIP_K)
        search_ms[q] = (now() - t0) * 1e3
        if len(res) != q or any(len(r) != CLIP_K for r in res):
            raise AssertionError(f"a text query at q {q} returned fewer than {CLIP_K} neighbours")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # ---- gates, outside the counted run
    if cos.min() < CLIP_WIRE_MIN_COS:
        raise AssertionError(f"yuv420 against rgb: min cosine {cos.min()} below {CLIP_WIRE_MIN_COS}")
    if staged.tobytes() != wires["yuv420"].tobytes():
        raise AssertionError("the collaborative ingest stage's CLIP embeddings differ from the inline ones")
    if not np.array_equal(embs.cpu().numpy(), wires["yuv420"]):
        raise AssertionError("encode_image_device differs from encode_image")
    if embs.shape != (n_images, cfg.embed_dim) or not torch.isfinite(embs).all():
        raise AssertionError(f"bad image embeddings {tuple(embs.shape)}")
    missed = [i for i, r in enumerate(self_hits) if not r or r[0][0] != i]
    if missed:
        raise AssertionError(f"{len(missed)} images do not retrieve their own row first (e.g. {missed[:5]})")
    shares = {}
    qn = F.normalize(torch.from_numpy(q_emb).to(dev), dim=1)
    for q in CLIP_QUERY_SIZES:
        vk, ik = index.search_dispatch(qn[:q], CLIP_K)
        vp, ip = knn_topk_reference(qn[:q], index._dev_matrix, k=vk.shape[1], bias=index._dev_bias)
        shares[q], ok = topk_agreement(vk, ik, vp, ip, atol=1e-5, rtol=1e-5)
        if not ok:
            raise AssertionError(f"B2 at d {cfg.embed_dim}, q {q} disagrees with its plain version ({shares[q]})")
    missing = [k for k in ("knn_topk_stream", "knn_topk_tc", "knn_topk_merge") if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"clip_path never launched {missing}")
    result = dict(
        card=env["nvidia_smi"], images=n_images, image_size=H, index_rows=len(index), dim=cfg.embed_dim,
        images_per_s=per_s, yuv420_vs_rgb_min_cos=float(cos.min()), yuv420_vs_rgb_mean_cos=float(cos.mean()),
        texts=len(texts), texts_per_s=len(texts) / text_s, fill_seconds=fill_s,
        self_search_seconds=self_s, search_ms={str(q): v for q, v in search_ms.items()},
        b2_index_agreement={str(q): v for q, v in shares.items()}, max_memory_allocated=peak,
        phase_seconds=now() - t_phase, launches=launches,
    )
    emit("clip_path", **result)
    del index, embs
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ ring_path

RING_SEQ, RING_SHARDS, RING_BATCH = 8192, 4, 2  # 2,048 tokens a shard
RING_RAGGED = 0.65  # the second document's live share: its last shard holds no live token
RING_MIN_COS = 0.999  # pooled embeddings of the ring against the one-card forward, bf16 both


def phase_ring_path(torch, env: dict, seq: int = RING_SEQ, shards: int = RING_SHARDS, config=None) -> dict:
    """``ring_encode`` at MiniLM-L6 width (max_position ``seq``, seeded) over
    a pooled mesh of ``shards`` shards on one card (the device pool of
    ``parallel/mesh.py``; every shard's thread launches on ``cuda:0``), for
    ``RING_BATCH`` documents of ``seq`` tokens, one of them ragged. Gates:
    the pooled embeddings against the same weights' one-card
    ``TextEncoder`` forward (B3 at S ``seq``, head dim 32) at cosine
    ``RING_MIN_COS``; B3 on that forward's first-layer qkv against its
    plain version (bf16 tolerances); B3 launching. Reports the ring's ms
    against the one-card forward's."""
    import numpy as np

    from pathway_tpu_torch.models.encoder import EncoderConfig, TextEncoder, _layer_norm, _linear, init_params
    from pathway_tpu_torch.models.long_context import ring_encode
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.fused_attention import masked_attention, masked_attention_reference
    from pathway_tpu_torch.parallel.mesh import resolve_mesh, set_device_pool

    now = time.perf_counter
    t_phase = now()
    dev = torch.device(DEV)
    cfg = config or EncoderConfig.minilm_l6(max_position=seq)
    sd = {k: v.to(dev) for k, v in init_params(cfg, seed=SEED).items()}
    one = TextEncoder(cfg).to(dev).eval().requires_grad_(False)
    one.load_state_dict(sd)
    rng = np.random.default_rng(SEED + 71)
    ids = torch.from_numpy(rng.integers(1000, cfg.vocab_size, (RING_BATCH, seq))).to(dev)
    mask = torch.ones(RING_BATCH, seq, dtype=torch.bool, device=dev)
    mask[1, int(seq * RING_RAGGED) :] = False
    prev = set_device_pool([dev] * shards)
    try:
        mesh = resolve_mesh(shards)
        ring_encode(sd, cfg, ids[:, :seq], mask, mesh)  # warm-up: the shards' threads, the library's handles
        with torch.no_grad():
            one(ids, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = now()
        ringed = ring_encode(sd, cfg, ids, mask, mesh)
        torch.cuda.synchronize()
        ring_ms = (now() - t0) * 1e3
        t0 = now()
        with torch.no_grad():
            direct = one(ids, mask)
        torch.cuda.synchronize()
        one_ms = (now() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        set_device_pool(prev)

    # ---- gates, outside the counted run
    cos = torch.nn.functional.cosine_similarity(ringed.float(), direct.float(), dim=1)
    if ringed.shape != (RING_BATCH, cfg.hidden_size) or not torch.isfinite(ringed).all() or cos.min() < RING_MIN_COS:
        raise AssertionError(f"ring_encode against the one-card forward: shape {tuple(ringed.shape)}, cosines "
                             f"{cos.tolist()} (bar {RING_MIN_COS})")
    if launches.get("masked_attention", 0) == 0:
        raise AssertionError(f"ring_path's one-card forward never launched B3: {launches}")
    with torch.no_grad():  # B3 on the forward's own first-layer qkv, held against its plain version
        layer = one.layers[0]
        x = one.tok_embed.weight[ids.long()].to(cfg.dtype) + one.pos_embed.weight[:seq][None].to(cfg.dtype)
        x = x + one.type_embed.weight[0].to(cfg.dtype)
        qkv = _linear(_layer_norm(x, one.ln_embed, cfg.dtype), layer.attention.qkv, cfg.dtype).contiguous()
        err = held(f"masked_attention[S{seq}] on ring_path's qkv", masked_attention(qkv, mask, cfg.num_heads),
                   masked_attention_reference(qkv, mask, cfg.num_heads), **BF16_TOL)
    result = dict(
        card=env["nvidia_smi"], documents=RING_BATCH, seq=seq, shards=shards, live_tokens=mask.sum(dim=1).tolist(),
        ring_ms=ring_ms, one_card_ms=one_ms, ring_over_one_card=ring_ms / one_ms, min_cos=float(cos.min()),
        b3_max_abs_err=err, max_memory_allocated=peak, phase_seconds=now() - t_phase, launches=launches,
    )
    emit("ring_path", **result)
    del one, sd
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ http_path

HTTP_DOCS, HTTP_QUERIES, HTTP_K = 16_384, 256, 10
HTTP_RETRY = dict(first_delay_ms=100, backoff_factor=2.0, jitter_ms=0)  # the reader's reconnect backoff


class _HttpFeed:
    """Two local endpoints on one ``ThreadingHTTPServer``: ``GET /stream``
    answers newline-delimited JSON documents over chunked transfer, the
    first connection cut without its last chunk after half of them, the
    next one serving the rest; a later connection is held open, idle, until
    :meth:`release` (the reader of a run in streaming mode reconnects when a
    body ends). ``POST /sink`` records each JSON body."""

    def __init__(self, docs: list):
        import http.server
        import threading

        feed = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, format, *args):  # noqa: A002 - no access log on the script's output
                pass

            def do_GET(self):
                with feed.lock:
                    feed.connections.append(time.perf_counter())
                    n_conn = len(feed.connections)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                if n_conn <= 2:
                    lo, hi = (0, len(docs) // 2) if n_conn == 1 else (feed.sent, len(docs))
                    for start in range(lo, hi, 64):
                        part = b"".join(docs[start : min(hi, start + 64)])
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
                        feed.sent = min(hi, start + 64)
                    if n_conn == 1:  # cut: the connection closes without the terminating chunk
                        self.wfile.flush()
                        feed.dropped_at = time.perf_counter()
                        self.close_connection = True
                        return
                else:
                    feed.released.wait(timeout=600)
                self.wfile.write(b"0\r\n\r\n")

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with feed.lock:
                    feed.posted.append(json.loads(body))
                    if len(feed.posted) >= feed.want:
                        feed.done.set()
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.lock = threading.Lock()
        self.connections: list = []
        self.posted: list = []
        self.sent = 0
        self.dropped_at = None
        self.want = 1 << 62
        self.done, self.released = threading.Event(), threading.Event()
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, name="http_path-feed", daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def release(self) -> None:
        self.released.set()

    def close(self) -> None:
        self.released.set()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def _http_pipeline(pw, docs_table, queries, embedder, k: int):
    """Documents -> their embeddings (B1) -> ``pw.ml.KNNIndex`` (B2, on the
    card) <- embedded queries, answered as of now -> (qid, ids, dists)."""
    d_emb = docs_table.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    q_emb = queries.select(qid=pw.this.qid, emb=embedder(pw.this.text))
    index = pw.ml.KNNIndex(d_emb.emb, d_emb, n_dimensions=embedder.get_embedding_dimension(),
                           reserved_space=HTTP_DOCS, distance_type="cosine", device=DEV)
    return index.get_nearest_items_asof_now(q_emb.emb, k=k, with_distances=True).select(
        qid=q_emb.qid, ids=pw.this.doc_id, dists=pw.this.dist)


def phase_http_path(torch, env: dict, n_docs: int = HTTP_DOCS, n_queries: int = HTTP_QUERIES) -> dict:
    """The HTTP client connectors as a user wires them: a local server
    streams ``n_docs`` documents as newline-delimited JSON over chunked
    transfer, drops the connection once at half and serves the rest on the
    reconnect -> ``pw.io.http.read(stream=True)`` -> ``SentenceTransformerEmbedder``
    (MiniLM-L6, B1) -> ``pw.ml.KNNIndex`` (B2) <- ``n_queries`` text queries
    from ``pw.io.python.read`` once every document is in, answered as of
    now -> ``pw.io.http.write`` POSTing each answer to a second local
    endpoint. Gates: every document delivered once, every answer POSTed
    once, the hits equal those of a twin run fed the same documents through
    ``pw.io.python.read`` in the same epochs (ids exact, scores 1e-5 by
    ``topk_agreement``), B1 and B2 launching. Reports docs/s and the
    reconnect's gap."""
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.io.http import RetryPolicy
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    now = time.perf_counter
    t_phase = now()
    rng = np.random.default_rng(SEED + 81)
    texts = _synthetic_texts_bulk(rng, n_docs, 20, 220)
    own = rng.choice(n_docs, n_queries // 2, replace=False)
    queries = [" ".join(texts[i].split()[:24]) for i in own] + _synthetic_texts(rng, n_queries - len(own), 5, 40)
    lines = [json.dumps({"doc_id": i, "text": t}).encode() + b"\n" for i, t in enumerate(texts)]
    embedder = SentenceTransformerEmbedder(device=DEV)
    embedder._encoder.encode_device(texts[:256], pad_to=256)  # warm-up: first launches, handles

    class DocSchema(pw.Schema):  # keyed by id: an epoch's rows reach the embedder in one order in both runs
        doc_id: int = pw.column_definition(primary_key=True)
        text: str

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str


    def run(docs_table):
        """The pipeline over ``docs_table`` -> (answers table, the subscriptions' state, their condition)."""
        cv = threading.Condition()
        state = {"doc_ids": [], "doc_time": {}, "answers": {}}

        class Queries(pw.io.python.ConnectorSubject):
            def run(self):
                with cv:
                    if not cv.wait_for(lambda: len(state["doc_ids"]) >= n_docs, timeout=600):
                        raise TimeoutError(f"only {len(state['doc_ids'])} of {n_docs} documents arrived")
                for i, text in enumerate(queries):
                    self.next(qid=i, text=text)
                self.commit()

        def on_doc(key, row, time, is_addition):  # noqa: F811 - pw.io.subscribe passes ``time=``
            with cv:
                state["doc_ids"].append(row["doc_id"])
                state["doc_time"][row["doc_id"]] = time
                cv.notify_all()

        def on_answer(key, row, time, is_addition):  # noqa: F811
            with cv:
                state["answers"][row["qid"]] = list(zip(row["ids"], (-float(d) for d in row["dists"])))
                cv.notify_all()

        qs = pw.io.python.read(Queries(), schema=QuerySchema, autocommit_duration_ms=None)
        answers = _http_pipeline(pw, docs_table, qs, embedder, HTTP_K)
        pw.io.subscribe(docs_table, on_doc)
        pw.io.subscribe(answers, on_answer)
        return answers, state, cv

    # ---- the HTTP run
    feed = _HttpFeed(lines)
    feed.want = n_queries
    runners = []
    real_init = GraphRunner.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    pw.clear_graph()
    docs = pw.io.http.read(f"{feed.url}/stream", schema=DocSchema, stream=True, mode="streaming",
                           retry_policy=RetryPolicy(**HTTP_RETRY), autocommit_duration_ms=None)
    answers, state, cv = run(docs)
    pw.io.http.write(answers, f"{feed.url}/sink")
    errors: list = []

    def serve():
        try:
            pw.run()
        except BaseException as exc:  # noqa: BLE001 - reported by the gate below
            errors.append(exc)
            feed.done.set()
            with cv:
                cv.notify_all()

    GraphRunner.__init__ = recording_init
    try:
        _build.reset_launches()
        t0 = now()
        th = threading.Thread(target=serve, name="http_path-run", daemon=True)
        th.start()
        with cv:
            if not cv.wait_for(lambda: len(state["doc_ids"]) >= n_docs or errors, timeout=600) or errors:
                raise AssertionError(f"http_path: {len(state['doc_ids'])} of {n_docs} documents delivered; "
                                     f"the run raised {errors}")
        docs_s = time.perf_counter() - t0
        if not feed.done.wait(timeout=600) or errors:
            raise AssertionError(f"http_path: {len(feed.posted)} of {n_queries} answers POSTed; the run raised {errors}")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        run_s = now() - t0
        runners[-1].engine.stop()
        feed.release()  # the idle third connection ends; the stopped reader does not reconnect
        th.join(timeout=120)
    finally:
        GraphRunner.__init__ = real_init
        feed.close()
        pw.clear_graph()
    if th.is_alive() or errors:
        raise AssertionError(f"the HTTP run did not end cleanly: alive={th.is_alive()}, errors={errors}")
    time.sleep(0.5)  # a late POST would land here
    epochs: dict = collections.defaultdict(list)
    for doc_id, t in state["doc_time"].items():
        epochs[t].append(doc_id)
    doc_epochs = [sorted(epochs[t]) for t in sorted(epochs)]

    # ---- the twin: the same documents through pw.io.python.read, in the same epochs
    twin_state = {}

    class Documents(pw.io.python.ConnectorSubject):
        def run(self):
            sent = 0
            for group in doc_epochs:
                for i in group:
                    self.next(doc_id=i, text=texts[i])
                self.commit()
                sent += len(group)
                with twin_state["cv"]:
                    if not twin_state["cv"].wait_for(lambda: len(twin_state["s"]["doc_ids"]) >= sent, timeout=300):
                        raise TimeoutError("a twin epoch was not delivered")

    pw.clear_graph()
    twin_docs = pw.io.python.read(Documents(), schema=DocSchema, autocommit_duration_ms=None)
    _answers, twin_state["s"], twin_state["cv"] = run(twin_docs)
    try:
        pw.run()
    finally:
        pw.clear_graph()
    twin = twin_state["s"]

    # ---- gates
    delivered = collections.Counter(state["doc_ids"])
    if sorted(delivered) != list(range(n_docs)) or max(delivered.values()) != 1:
        raise AssertionError(f"http_path: documents delivered {len(state['doc_ids'])} times over {len(delivered)} ids")
    posted = collections.Counter(b["qid"] for b in feed.posted)
    if sorted(posted) != list(range(n_queries)) or max(posted.values()) != 1 or any(b["diff"] != 1 for b in feed.posted):
        raise AssertionError(f"http_path: {len(feed.posted)} POSTs over {len(posted)} answers")
    by_post = {b["qid"]: list(zip(b["ids"], (-float(d) for d in b["dists"]))) for b in feed.posted}
    for name, got in (("subscribed", state["answers"]), ("POSTed", by_post)):
        share, ok = _hits_agree([got[i] for i in range(n_queries)], [twin["answers"][i] for i in range(n_queries)],
                                HTTP_K)
        if not ok:
            raise AssertionError(f"http_path: the {name} hits differ from the pw.io.python.read twin's ({share})")
    missing = [k for k in ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention", "knn_topk_merge")
               if launches.get(k, 0) == 0]
    if missing or launches.get("knn_topk_stream", 0) + launches.get("knn_topk_tc", 0) == 0:
        raise AssertionError(f"http_path never launched {missing or 'a partial pass of B2'}")
    if len(feed.connections) < 2 or feed.dropped_at is None:
        raise AssertionError(f"http_path: the stream was not cut and resumed ({len(feed.connections)} connections)")
    result = dict(
        card=env["nvidia_smi"], docs=n_docs, queries=n_queries, k=HTTP_K, docs_per_s=n_docs / docs_s,
        docs_seconds=docs_s, run_seconds=run_s, epochs=len(doc_epochs), connections=len(feed.connections),
        reconnect_gap_ms=(feed.connections[1] - feed.dropped_at) * 1e3, reconnect_backoff_ms=HTTP_RETRY["first_delay_ms"],
        posted=len(feed.posted), phase_seconds=now() - t_phase, launches=launches,
    )
    emit("http_path", **result)
    return launches, embedder


# ----------------------------------------------------------------- kafka_path

class KafkaStandIn:
    """An in-process Kafka broker behind a ``confluent_kafka`` stand-in
    module (:attr:`module`, put in ``sys.modules`` around a run, so the
    connectors' own confluent branch runs). Topics hold partitions, each an
    append-only list of (key, value, timestamp ms) records; a keyed record
    goes to ``crc32(key) % partitions``, an unkeyed one round-robin.
    ``Consumer`` subscribes with ``on_assign`` (called at the first ``poll``,
    which assigns every partition of the topics when the callback does not),
    starts each partition where its offset or ``auto.offset.reset`` says,
    polls the partitions in turn, waits for a record up to the poll's
    timeout (librdkafka's semantics: an idle poll returns ``None`` only when
    the timeout has passed), resolves ``offsets_for_times`` and closes;
    ``Producer`` produces, polls and flushes. :attr:`calls` counts the
    client calls by name, :attr:`consumers` holds every consumer (each
    with ``delivered_at``, the clock at its last record, and ``idle_at``,
    at its first ``None`` after it); after :meth:`shutdown` every ``poll``
    raises, which ends a reader that polls for ever."""

    OFFSET_BEGINNING, OFFSET_END, OFFSET_INVALID = -2, -1, -1001  # confluent_kafka's values

    def __init__(self):
        import threading

        self.cond = threading.Condition()
        self.topics: dict = {}
        self.calls = collections.Counter()
        self.subscriptions: list = []
        self.consumers: list = []
        self.down = False
        self._turn = collections.Counter()
        self.module = self._client_module()

    def create_topic(self, name: str, partitions: int) -> None:
        with self.cond:
            self.topics.setdefault(name, [[] for _ in range(partitions)])

    def _append(self, topic: str, key, value, partition=None, ts_ms=None) -> None:
        import zlib

        parts = self.topics.setdefault(topic, [[]])
        if partition is None or partition < 0:
            if key is not None:
                partition = zlib.crc32(key if isinstance(key, bytes) else str(key).encode()) % len(parts)
            else:
                partition = self._turn[topic] % len(parts)
                self._turn[topic] += 1
        parts[partition].append((key, value, ts_ms if ts_ms else int(time.time() * 1000)))

    def produce_many(self, topic: str, records) -> None:
        """Append ``(key, value)`` records at once: a consumer sees all or none."""
        with self.cond:
            for key, value in records:
                self._append(topic, key, value)
            self.cond.notify_all()

    def records(self, topic: str) -> list:
        with self.cond:
            return [r for part in self.topics.get(topic, []) for r in part]

    def shutdown(self) -> None:
        with self.cond:
            self.down = True
            self.cond.notify_all()

    def _client_module(self):
        import types

        broker = self
        mod = types.ModuleType("confluent_kafka")
        mod.OFFSET_BEGINNING, mod.OFFSET_END, mod.OFFSET_INVALID = (
            self.OFFSET_BEGINNING, self.OFFSET_END, self.OFFSET_INVALID)
        mod.TIMESTAMP_CREATE_TIME = 1

        class KafkaException(Exception):
            pass

        class TopicPartition:
            def __init__(self, topic, partition=-1, offset=broker.OFFSET_INVALID):
                self.topic, self.partition, self.offset = topic, partition, offset

            def __repr__(self):
                return f"TopicPartition({self.topic!r}, {self.partition}, {self.offset})"

        class Message:
            __slots__ = ("_topic", "_partition", "_offset", "_key", "_value", "_ts")

            def __init__(self, topic, partition, offset, key, value, ts):
                self._topic, self._partition, self._offset = topic, partition, offset
                self._key, self._value, self._ts = key, value, ts

            def key(self):
                return self._key

            def value(self):
                return self._value

            def topic(self):
                return self._topic

            def partition(self):
                return self._partition

            def offset(self):
                return self._offset

            def timestamp(self):
                return (mod.TIMESTAMP_CREATE_TIME, self._ts)

            def error(self):
                return None

        class Consumer:
            def __init__(self, conf):
                broker.calls["Consumer"] += 1
                self.conf = dict(conf)
                self.topics, self.on_assign, self.positions = [], None, None
                self.closed, self._next = False, 0
                self.delivered_at = self.idle_at = None
                broker.consumers.append(self)

            def subscribe(self, topics, on_assign=None):
                broker.calls["subscribe"] += 1
                broker.subscriptions.append(list(topics))
                self.topics, self.on_assign = list(topics), on_assign

            def assign(self, partitions):
                broker.calls["assign"] += 1
                earliest = self.conf.get("auto.offset.reset", "latest") in ("earliest", "smallest", "beginning")
                positions = {}
                with broker.cond:
                    for tp in partitions:
                        end = len(broker.topics[tp.topic][tp.partition])
                        if tp.offset >= 0:
                            start = min(tp.offset, end)
                        elif tp.offset == broker.OFFSET_END:
                            start = end
                        elif tp.offset == broker.OFFSET_BEGINNING:
                            start = 0
                        else:
                            start = 0 if earliest else end
                        positions[(tp.topic, tp.partition)] = start
                self.positions = positions

            def _rebalance(self):
                with broker.cond:
                    parts = [TopicPartition(t, p) for t in self.topics
                             for p in range(len(broker.topics.setdefault(t, [[]])))]
                if self.on_assign is not None:
                    self.on_assign(self, parts)
                if self.positions is None:  # the callback kept the group's assignment
                    self.assign(parts)

            def offsets_for_times(self, partitions, timeout=None):
                broker.calls["offsets_for_times"] += 1
                out = []
                with broker.cond:
                    for tp in partitions:
                        recs = broker.topics[tp.topic][tp.partition]
                        out.append(TopicPartition(tp.topic, tp.partition,
                                                  next((i for i, r in enumerate(recs) if r[2] >= tp.offset), -1)))
                return out

            def poll(self, timeout=None):
                broker.calls["poll"] += 1
                if self.closed:
                    raise KafkaException("the consumer is closed")
                if self.positions is None:
                    self._rebalance()
                deadline = time.monotonic() + (1e9 if timeout is None or timeout < 0 else timeout)
                owned = list(self.positions)
                with broker.cond:
                    while True:
                        if broker.down:
                            raise KafkaException("the broker shut down")
                        for j in range(len(owned)):
                            tp = owned[(self._next + j) % len(owned)]
                            recs, at = broker.topics[tp[0]][tp[1]], self.positions[tp]
                            if at < len(recs):
                                self.positions[tp] = at + 1
                                self._next = (self._next + j + 1) % len(owned)
                                key, value, ts = recs[at]
                                self.delivered_at, self.idle_at = time.perf_counter(), None
                                return Message(tp[0], tp[1], at, key, value, ts)
                        left = deadline - time.monotonic()
                        if left <= 0:
                            if self.idle_at is None:
                                self.idle_at = time.perf_counter()
                            return None
                        broker.cond.wait(left)

            def close(self):
                broker.calls["close"] += 1
                self.closed = True

        class Producer:
            def __init__(self, conf):
                broker.calls["Producer"] += 1

            def produce(self, topic, value=None, key=None, partition=-1, timestamp=0):
                broker.calls["produce"] += 1
                with broker.cond:
                    broker._append(topic, key, value, partition, timestamp)
                    broker.cond.notify_all()

            def poll(self, timeout=None):
                broker.calls["producer_poll"] += 1
                return 0

            def flush(self, timeout=None):
                broker.calls["flush"] += 1
                return 0

        mod.KafkaException, mod.TopicPartition, mod.Message = KafkaException, TopicPartition, Message
        mod.Consumer, mod.Producer = Consumer, Producer
        return mod


def debezium_envelope(op: str, doc_id: int, before, after, lsn: int, ts_ms: int | None = None) -> tuple[bytes, bytes]:
    """A Debezium postgres change event for ``public.docs`` keyed by
    ``doc_id``: (key JSON, value JSON), as the connector writes them with
    its JSON converter's ``schemas.enable=false``. ``ts_ms`` defaults to one
    millisecond a log position."""
    key = json.dumps({"payload": {"doc_id": doc_id}}).encode()
    value = {"payload": {
        "op": op, "before": before, "after": after, "ts_ms": 1_700_000_000_000 + lsn if ts_ms is None else ts_ms,
        "source": {"connector": "postgresql", "db": "pg", "schema": "public", "table": "docs", "lsn": lsn},
    }}
    return key, json.dumps(value).encode()


KAFKA_SNAPSHOT, KAFKA_UPDATES, KAFKA_DELETES = 32_768, 8_192, 4_096
KAFKA_PARTITIONS = 4
KAFKA_SINGLES = 2  # single queries after each of the three phases (B2's streaming pass), an epoch each
KAFKA_BURST = 256  # queries of the last epoch (B2's tensor-core pass)
KAFKA_K = 10
KAFKA_SETTINGS = {"bootstrap.servers": "localhost:9092", "group.id": "pathway-kafka-path",
                  "auto.offset.reset": "earliest"}
KAFKA_CATEGORIES = 16  # labels of the rows' ``category``, drawn from the path's seed
KAFKA_WINDOW_S = 60  # the tumbling window over ``updated_at``
KAFKA_SNAPSHOT_WINDOWS = 64  # the snapshot's commit times span this many windows
KAFKA_T0_MS = 1_699_999_980_000  # the first commit time, on a minute
KAFKA_CLASSIFY_K = 3  # knn_lsh_classify's neighbours: a majority vote of the categories of three live rows
KAFKA_TIE = 1e-5  # f32 scores this close may rank either way (ROADMAP Queue C): such a query is reported, not gated


def _view_nodes(runner, source, out) -> set:
    """The engine nodes of ``runner`` that carry ``source``'s rows into
    ``out``: downstream of ``source``'s node and upstream of ``out``'s."""
    start, end = runner.lowered[source._id].node, runner.lowered[out._id].node
    reaches: dict = {}

    def reaches_end(node) -> bool:
        if node.id not in reaches:
            reaches[node.id] = node is end or any(reaches_end(c) for c, _port in node.consumers)
        return reaches[node.id]

    found, todo = set(), [c for c, _port in start.consumers]
    while todo:
        node = todo.pop()
        if node not in found and reaches_end(node):
            found.add(node)
            todo.extend(c for c, _port in node.consumers)
    return found


def _time_process(node, acc: list, launches: collections.Counter | None = None) -> None:
    """Add the seconds of each of ``node``'s ``process`` calls to ``acc[0]``
    and, with ``launches``, the B2 launches made inside them (one engine
    worker runs one node at a time)."""
    from pathway_tpu_torch.ops import _build

    real = node.process

    def process(time_):
        t = time.perf_counter()
        before = {n: c for n, c in _build.LAUNCHES.items() if n.startswith("knn_topk")} if launches is not None else {}
        try:
            return real(time_)
        finally:
            acc[0] += time.perf_counter() - t
            if launches is not None:
                for n, c in _build.LAUNCHES.items():
                    if n.startswith("knn_topk") and c != before.get(n, 0):
                        launches[n] += c - before.get(n, 0)

    node.process = process


def phase_kafka_path(torch, env: dict, embedder, n_snapshot: int = KAFKA_SNAPSHOT, n_updates: int = KAFKA_UPDATES,
                     n_deletes: int = KAFKA_DELETES, n_singles: int = KAFKA_SINGLES, n_burst: int = KAFKA_BURST,
                     k: int = KAFKA_K) -> dict:
    """Postgres -> Debezium -> Kafka -> a live index, as a user wires it: a
    ``confluent_kafka`` stand-in (:class:`KafkaStandIn`) carries topic
    ``pg.public.docs`` (``KAFKA_PARTITIONS`` partitions, keyed by document
    id) with a snapshot of ``n_snapshot`` ``op: r`` rows, then ``n_updates``
    ``op: u`` rows with new text, then ``n_deletes`` ``op: d`` rows ->
    ``pw.io.debezium.read`` -> ``SentenceTransformerEmbedder`` (MiniLM-L6,
    B1; ``embedder``, http_path's, warmed up) -> ``pw.ml.KNNIndex`` (B2) <-
    text queries from topic ``queries`` through ``pw.io.kafka.read`` (single
    queries after each phase, then a burst of ``n_burst`` in one epoch),
    answered as of now -> ``pw.io.kafka.write`` to topic ``answers``. A row
    holds ``doc_id``, ``text``, ``category`` (``KAFKA_CATEGORIES`` labels)
    and ``updated_at`` (the seconds of its event's commit time: the snapshot
    spread over ``KAFKA_SNAPSHOT_WINDOWS`` windows, each later event after
    it); the same table feeds a tumbling ``windowby`` over ``updated_at``
    (rows per window) and ``pw.sql`` (rows per category), both subscribed,
    their final states gated equal to a plain count of the live rows that
    the path's own subscription holds; and ``pw.ml.classifiers``'
    ``knn_lsh_classifier_train`` (its defaults: euclidean, so an l2 index
    of its own) over the embedded rows, ``label`` their ``category``, with
    ``knn_lsh_classify(k=KAFKA_CLASSIFY_K)`` of every query, live as the
    rows change, subscribed. Gates:
    both readers ran the confluent branch (subscribe, poll); the index ends
    with exactly the live keys; no answer names a key whose delete was
    committed in an earlier epoch; every updated row still live comes
    first for its new text; the burst's hits equal those of a
    ``DeviceKnnIndex`` built directly from the final rows (their embeddings
    recomputed by the same embedder in the run's batches; ids exact, scores
    1e-5 by ``topk_agreement``); every query answered once on ``answers``;
    the classifier's index ends with exactly the live keys too, and every
    query's final label is the plain majority vote
    (``collections.Counter(...).most_common(1)`` in rank order) over the
    categories of the top 3 of an l2 ``DeviceKnnIndex`` built directly from
    the final rows, but where f32 may rank either way: the 3rd and 4th
    scores within ``KAFKA_TIE``, or three labels apart and the 1st and 2nd
    within it (counted and reported); B1 and both B2 passes and the merge
    launch. Reports the phases' rates, the slots that deletes freed and
    later rows took, the classifier's seconds and B2 launches, and peak
    memory."""
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    now = time.perf_counter
    t_phase = now()
    rng = np.random.default_rng(SEED + 91)
    texts = _synthetic_texts_bulk(rng, n_snapshot, 20, 220)
    updated = rng.choice(n_snapshot, n_updates, replace=False).tolist()
    new_texts = dict(zip(updated, _synthetic_texts_bulk(rng, n_updates, 20, 220)))
    deleted = rng.choice(n_snapshot, n_deletes, replace=False).tolist()
    final = {i: new_texts.get(i, t) for i, t in enumerate(texts)}
    for i in deleted:
        del final[i]
    labels = [f"category-{j:02d}" for j in range(KAFKA_CATEGORIES)]
    category = [labels[j] for j in np.random.default_rng(SEED + 92).integers(0, KAFKA_CATEGORIES, n_snapshot)]
    step_ms = KAFKA_SNAPSHOT_WINDOWS * KAFKA_WINDOW_S * 1000 // n_snapshot  # a commit every step_ms
    live_updated = [i for i in updated if i in final]
    probes = rng.choice(sorted(final), n_burst - n_burst // 2, replace=False).tolist()
    burst = [final[i] for i in live_updated[: n_burst // 2]] + [" ".join(final[i].split()[:24]) for i in probes]
    singles = {
        "snapshot": [" ".join(texts[i].split()[:24]) for i in rng.choice(n_snapshot, n_singles, replace=False)],
        "updates": [new_texts[i] for i in updated[:n_singles]],
        "deletes": [texts[i] for i in deleted[:n_singles]],  # a deleted row's text: its key must not come back
    }

    broker = KafkaStandIn()
    broker.create_topic("pg.public.docs", KAFKA_PARTITIONS)
    for name in ("queries", "answers"):
        broker.create_topic(name, 1)
    lsn = iter(range(1 << 40))
    version = {}  # doc_id -> its row as last written

    def event(op: str, i: int, text: str | None) -> tuple[bytes, bytes]:
        at = next(lsn)
        ts_ms = KAFKA_T0_MS + at * step_ms
        before = version.get(i)
        after = None if text is None else {"doc_id": i, "text": text, "category": category[i],
                                           "updated_at": ts_ms // 1000}
        version[i] = after
        return debezium_envelope(op, i, before, after, at, ts_ms=ts_ms)

    snapshot = [event("r", i, t) for i, t in enumerate(texts)]
    changes = [event("u", i, new_texts[i]) for i in updated]
    removals = [event("d", i, None) for i in deleted]
    final_rows = {i: (row["category"], row["updated_at"]) for i, row in version.items() if row is not None}

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        category: str
        updated_at: int

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    # ---- instruments: the pipeline's index, the slots it frees and takes again, the embedder's batches
    made, freed, reused, batches = [], collections.defaultdict(set), [0], []
    phase = ["setup"]
    real_init, real_remove, real_alloc = DeviceKnnIndex.__init__, DeviceKnnIndex.remove, DeviceKnnIndex._alloc_slots
    real_runner_init, real_encode = GraphRunner.__init__, embedder._encoder.encode
    real_runner_run = GraphRunner.run
    runners = []

    def index_init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    def index_remove(self, key):
        slot = self._slot_of.get(key)
        real_remove(self, key)
        if slot is not None:
            freed[id(self)].add(slot)

    def index_alloc(self, keys):
        slots = real_alloc(self, keys)
        mine = freed[id(self)]
        reused[0] += sum(s in mine for s in slots)
        mine.difference_update(slots)
        return slots

    def runner_init(self, *a, **kw):
        real_runner_init(self, *a, **kw)
        runners.append(self)

    views_s = {"window": [0.0], "sql": [0.0], "classify": [0.0]}  # seconds in each view's operators, every worker
    classify_launches = collections.Counter()  # B2 launches in the classifier's operators

    def runner_run(self, *a, **kw):
        for r in [self] + self._replicas:
            for view, out in (("window", per_window), ("sql", per_category)):
                for node in _view_nodes(r, docs, out):
                    _time_process(node, views_s[view])
            for node in _view_nodes(r, d_emb, predicted) | _view_nodes(r, q_emb, predicted):
                _time_process(node, views_s["classify"], classify_launches)
        return real_runner_run(self, *a, **kw)

    def encode(texts_):
        batches.append((phase[0], list(texts_)))
        return real_encode(texts_)

    cv = threading.Condition()
    state = {"live": {}, "texts": {}, "rows": {}, "removed_at": {}, "answers": {},
             "windows": collections.Counter(), "categories": collections.Counter(),
             "predicted": collections.Counter(), "labelled": set()}

    def on_doc(key, row, time, is_addition):  # noqa: F811 - pw.io.subscribe passes ``time=``
        with cv:
            if is_addition:
                state["live"][key] = row["doc_id"]
                state["texts"][row["doc_id"]] = row["text"]
                state["rows"][key] = (row["category"], row["updated_at"])
            else:
                state["live"].pop(key, None)
                state["rows"].pop(key, None)
                state["removed_at"][row["doc_id"]] = time
            cv.notify_all()

    def counter_of(name: str, label: str):
        def on_change(key, row, time, is_addition):  # noqa: F811
            with cv:  # a multiset of (key, label, n): an update's -1 and +1 may come in either order
                state[name][(key, row[label], row["n"])] += 1 if is_addition else -1

        return on_change

    def on_answer(key, row, time, is_addition):  # noqa: F811
        with cv:
            state["answers"][row["qid"]] = (time, list(row["ids"]), [float(d) for d in row["dists"]])
            cv.notify_all()

    def on_predicted(key, row, time, is_addition):  # noqa: F811
        with cv:  # a live label: an update's -1 and +1 may come in either order
            state["predicted"][(row["qid"], row["label"])] += 1 if is_addition else -1
            state["labelled"].add(row["qid"])
            cv.notify_all()

    pw.clear_graph()
    docs = pw.io.debezium.read(KAFKA_SETTINGS, "pg.public.docs", schema=DocSchema, db_type="postgres",
                               persistent_id="pg-public-docs", autocommit_duration_ms=None)
    queries = pw.io.kafka.read(KAFKA_SETTINGS, "queries", schema=QuerySchema, format="json",
                               autocommit_duration_ms=None)
    d_emb = docs.select(doc_id=pw.this.doc_id, text=pw.this.text, category=pw.this.category,
                        label=pw.this.category, updated_at=pw.this.updated_at, data=embedder(pw.this.text))
    q_emb = queries.select(qid=pw.this.qid, data=embedder(pw.this.text))
    windows = docs.windowby(pw.this.updated_at, window=pw.temporal.tumbling(duration=KAFKA_WINDOW_S))
    per_window = windows.reduce(start=pw.this._pw_window_start, n=pw.reducers.count())
    per_category = pw.sql("SELECT category, COUNT(*) AS n FROM docs GROUP BY category", docs=docs)
    index = pw.ml.KNNIndex(d_emb.data, d_emb, n_dimensions=embedder.get_embedding_dimension(),
                           reserved_space=n_snapshot, distance_type="cosine", device=DEV)
    answers = index.get_nearest_items_asof_now(q_emb.data, k=k, with_distances=True).select(
        qid=q_emb.qid, ids=pw.this.doc_id, dists=pw.this.dist)
    model = pw.ml.classifiers.knn_lsh_classifier_train(d_emb, d=embedder.get_embedding_dimension(), device=DEV)
    predicted = pw.ml.classifiers.knn_lsh_classify(model, d_emb, q_emb, k=KAFKA_CLASSIFY_K).select(
        qid=q_emb.qid, label=pw.this.predicted_label)
    pw.io.kafka.write(answers, KAFKA_SETTINGS, "answers", format="json")
    pw.io.subscribe(d_emb, on_doc)
    pw.io.subscribe(answers, on_answer)
    pw.io.subscribe(per_window, counter_of("windows", "start"))
    pw.io.subscribe(per_category, counter_of("categories", "category"))
    pw.io.subscribe(predicted, on_predicted)
    errors: list = []
    qid = iter(range(1 << 30))
    times: dict = {}

    def serve():
        try:
            pw.run()
        except BaseException as exc:  # noqa: BLE001 - reported by the gates below
            errors.append(exc)
            with cv:
                cv.notify_all()

    def wait(what: str, cond) -> None:
        with cv:
            if not cv.wait_for(lambda: cond() or errors, timeout=600) or errors:
                raise AssertionError(f"kafka_path: {what} did not arrive; the run raised {errors}")

    def ask(texts_: list) -> None:
        ids = [next(qid) for _ in texts_]
        broker.produce_many("queries", [(None, json.dumps({"qid": i, "text": t}).encode())
                                        for i, t in zip(ids, texts_)])
        wait(f"answers to queries {ids[0]}..{ids[-1]}",
             lambda: all(i in state["answers"] and i in state["labelled"] for i in ids))

    def new_seen() -> int:
        return sum(state["texts"].get(i) == new_texts[i] for i in updated)

    def timed(name: str, topic: str, produce, arrived) -> None:
        """One phase: its records at once, then the wait for what the run
        made of them -> its seconds, split at the reader's last record and
        at its first idle poll after it (the poll's timeout, after which
        the reader commits the epoch)."""
        phase[0] = name
        t = now()
        produce()
        wait(name, arrived)
        done = now()
        c = next(c for c in broker.consumers if c.topics == [topic])
        times[name] = dict(total_s=done - t, reader_s=c.delivered_at - t, idle_wait_s=c.idle_at - c.delivered_at,
                           epoch_s=done - c.idle_at)
        phase[0] = "singles"

    saved_module = sys.modules.get("confluent_kafka")
    sys.modules["confluent_kafka"] = broker.module
    DeviceKnnIndex.__init__, DeviceKnnIndex.remove, DeviceKnnIndex._alloc_slots = index_init, index_remove, index_alloc
    GraphRunner.__init__, GraphRunner.run, embedder._encoder.encode = runner_init, runner_run, encode
    th = threading.Thread(target=serve, name="kafka_path-run", daemon=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = now()
        th.start()
        timed("snapshot", "pg.public.docs", lambda: broker.produce_many("pg.public.docs", snapshot),
              lambda: len(state["live"]) >= n_snapshot)
        for text in singles["snapshot"]:
            ask([text])
        timed("updates", "pg.public.docs", lambda: broker.produce_many("pg.public.docs", changes),
              lambda: new_seen() >= n_updates)
        for text in singles["updates"]:
            ask([text])
        timed("deletes", "pg.public.docs", lambda: broker.produce_many("pg.public.docs", removals),
              lambda: len(state["live"]) <= len(final))
        for text in singles["deletes"]:
            ask([text])
        burst_first = len(state["answers"])
        timed("burst", "queries", lambda: ask(burst), lambda: True)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        run_s = now() - t0
        peak = torch.cuda.max_memory_allocated()
        run = runners[-1]
        window_rows = sum(r.lowered[windows._flat._id].node.stats.rows_out for r in [run] + run._replicas)
        run.engine.stop()
        broker.shutdown()  # the readers' polls raise, so they end at once
        th.join(timeout=120)
    finally:
        DeviceKnnIndex.__init__, DeviceKnnIndex.remove, DeviceKnnIndex._alloc_slots = real_init, real_remove, real_alloc
        GraphRunner.__init__, GraphRunner.run = real_runner_init, real_runner_run
        del embedder._encoder.encode
        if saved_module is None:
            sys.modules.pop("confluent_kafka", None)
        else:
            sys.modules["confluent_kafka"] = saved_module
        broker.shutdown()
        pw.clear_graph()
    if th.is_alive() or errors:
        raise AssertionError(f"the Kafka run did not end cleanly: alive={th.is_alive()}, errors={errors}")

    # ---- gates
    subscribed = sorted(tuple(s) for s in broker.subscriptions)
    if subscribed != [("pg.public.docs",), ("queries",)] or broker.calls["poll"] == 0:
        raise AssertionError(f"kafka_path: the confluent branch did not run: {subscribed}, {dict(broker.calls)}")
    pipeline = {ix.metric: ix for ix in made if len(ix._slot_of)}
    if sorted(pipeline) != ["cos", "l2"] or sum(len(ix._slot_of) > 0 for ix in made) != 2:
        raise AssertionError(f"kafka_path: indexes of metrics {sorted(pipeline)} hold rows; the answers' (cos) and "
                             f"the classifier's (l2) expected")
    index_ = pipeline["cos"]
    doc_of = {int(key): doc_id for key, doc_id in state["live"].items()}
    if sorted(doc_of.values()) != sorted(final):
        raise AssertionError(f"kafka_path: the subscription holds {len(doc_of)} rows, {len(final)} live")
    for metric, ix in pipeline.items():
        if {int(key) for key in ix._slot_of} != set(doc_of) or len(ix._slot_of) != len(final):
            raise AssertionError(f"kafka_path: the {metric} index holds {len(ix._slot_of)} keys, "
                                 f"{len(final)} live rows")
    removed_at = {i: state["removed_at"][i] for i in deleted}
    answered = state["answers"]
    stale = [(q, i) for q, (t, ids, _d) in answered.items() for i in ids if i in removed_at and removed_at[i] < t]
    if stale:
        raise AssertionError(f"kafka_path: {len(stale)} answers name a deleted key, first {stale[:4]}")
    # each updated row still live comes first for its new text, in the index the run built
    by_text = {}
    for ph, batch in batches:
        if ph == "updates":
            by_text.update(zip(batch, real_encode(batch)))
    vecs = np.stack([by_text[new_texts[i]] for i in live_updated])
    firsts = []
    for lo in range(0, len(vecs), 256):
        hits = DeviceKnnIndex.search_batch(index_, vecs[lo : lo + 256], 1)
        firsts += [doc_of[int(h[0][0])] for h in hits]
    missed = [i for i, f in zip(live_updated, firsts) if f != i]
    if missed:
        raise AssertionError(f"kafka_path: {len(missed)} updated rows do not come first for their new text")
    # the burst against an index built directly from the final rows, with the run's batches re-encoded
    final_vec, q_of = {}, {}
    for ph, batch in batches:
        if ph in ("snapshot", "updates"):
            final_vec.update(zip(batch, real_encode(batch)))
        else:  # the single queries and the burst
            q_of.update(zip(batch, real_encode(batch)))
    direct = DeviceKnnIndex(index_.dim, metric="cos", reserved_space=len(final), device=DEV)
    ids = sorted(final)
    direct.add_batch_arrays(ids, np.stack([final_vec[final[i]] for i in ids]))
    want = direct.search_batch(np.stack([q_of[t] for t in burst]), k)
    burst_ids = range(burst_first, burst_first + len(burst))
    got = [list(zip(answered[q][1], (1.0 - d for d in answered[q][2]))) for q in sorted(answered)[burst_first:]]
    share, ok = _hits_agree(got, [[(int(i), float(s)) for i, s in row] for row in want], k)
    if not ok or sorted(answered)[burst_first:] != list(burst_ids):
        raise AssertionError(f"kafka_path: the burst's hits differ from a directly built index's ({share})")
    # every query's final label against a plain majority vote over an l2 index built directly from the final rows
    asked = singles["snapshot"] + singles["updates"] + singles["deletes"] + burst
    labels = {(q, label) for (q, label), c in state["predicted"].items() if c}
    if any(c not in (0, 1) for c in state["predicted"].values()) \
            or sorted(q for q, _ in labels) != list(range(len(asked))):
        raise AssertionError(f"kafka_path: the classifier holds {len(labels)} labels for {len(asked)} queries")
    predicted_of = dict(labels)
    direct_l2 = DeviceKnnIndex(index_.dim, metric="l2", reserved_space=len(final), device=DEV)
    direct_l2.add_batch_arrays(ids, np.stack([final_vec[final[i]] for i in ids]))
    near = {"rank_3_4": 0, "rank_1_2": 0}
    wrong = []
    for q, row in enumerate(direct_l2.search_batch(np.stack([q_of[t] for t in asked]), KAFKA_CLASSIFY_K + 1)):
        scores = [float(sc) for _i, sc in row]
        cats = [final_rows[int(i)][0] for i, _sc in row[:KAFKA_CLASSIFY_K]]
        if abs(scores[KAFKA_CLASSIFY_K - 1] - scores[KAFKA_CLASSIFY_K]) <= KAFKA_TIE:
            near["rank_3_4"] += 1
        elif len(set(cats)) == len(cats) and abs(scores[0] - scores[1]) <= KAFKA_TIE:
            near["rank_1_2"] += 1
        elif predicted_of[q] != collections.Counter(cats).most_common(1)[0][0]:
            wrong.append((q, predicted_of[q], cats))
    if wrong:
        raise AssertionError(f"kafka_path: {len(wrong)} labels differ from a plain vote, first {wrong[:4]}")
    written = collections.Counter()
    for _key, value, _ts in broker.records("answers"):
        rec = json.loads(value)
        written[(rec["qid"], rec["diff"])] += 1
    if sorted(written) != [(q, 1) for q in sorted(answered)] or max(written.values()) != 1:
        raise AssertionError(f"kafka_path: {sum(written.values())} records on 'answers' for {len(answered)} queries")
    # the window and the SQL view against a plain count of the live rows the subscription holds
    rows = list(state["rows"].values())
    if sorted(rows) != sorted(final_rows.values()):
        raise AssertionError(f"kafka_path: the subscription holds {len(rows)} rows, the stream leaves "
                             f"{len(final_rows)}")
    views = {}
    for name, want in (("windows", collections.Counter(at // KAFKA_WINDOW_S * KAFKA_WINDOW_S for _c, at in rows)),
                       ("categories", collections.Counter(c for c, _at in rows))):
        held = {(key, label, n) for (key, label, n), c in state[name].items() if c}
        got = {label: n for _key, label, n in held}
        if any(c not in (0, 1) for c in state[name].values()) or len(got) != len(held) or got != dict(want):
            raise AssertionError(f"kafka_path: the {name} held {sorted(got.items())[:4]}..., a plain count of the "
                                 f"live rows gives {sorted(want.items())[:4]}...")
        views[name] = got
    missing = [name for name in ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention",
                                 "knn_topk_stream", "knn_topk_tc", "knn_topk_merge") if launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kafka_path never launched {missing}")
    busy = lambda name: times[name]["reader_s"] + times[name]["epoch_s"]  # noqa: E731
    result = dict(
        card=env["nvidia_smi"], snapshot=n_snapshot, updates=n_updates, deletes=n_deletes, live=len(final),
        partitions=KAFKA_PARTITIONS, queries=len(answered), burst=len(burst), k=k,
        # rates over the reader's and the run's seconds: without the idle poll's timeout before each commit
        snapshot_docs_per_s=n_snapshot / busy("snapshot"),
        changes_per_s=(n_updates + n_deletes) / (busy("updates") + busy("deletes")),
        updates_per_s=n_updates / busy("updates"), deletes_per_s=n_deletes / busy("deletes"),
        burst_answers_per_s=len(burst) / busy("burst"), phase_times=times, slots_reused=reused[0],
        windows=len(views["windows"]), window_span=[min(views["windows"]), max(views["windows"])],
        categories=len(views["categories"]), window_rows=window_rows, window_seconds=views_s["window"][0],
        window_rows_per_s=window_rows / views_s["window"][0], sql_seconds=views_s["sql"][0],
        classified=len(asked), classify_k=KAFKA_CLASSIFY_K, classify_near_ties=near,
        classify_seconds=views_s["classify"][0], classify_launches=dict(classify_launches),
        polls=broker.calls["poll"], max_memory_allocated=peak, run_seconds=run_s,
        phase_seconds=now() - t_phase, launches=launches,
    )
    emit("kafka_path", **result)
    return launches


# -------------------------------------------------------------------- s3_path

class S3StandIn:
    """An in-process S3 endpoint behind ``boto3`` and ``botocore.config``
    stand-in modules (:meth:`modules`, put in ``sys.modules`` around a run,
    so a connector's own ``AwsS3Settings.create_client()`` branch runs).
    A bucket maps keys to bodies; an object's ETag is the quoted MD5 of its
    body. ``list_objects_v2`` pages ``page_size`` keys at a time with
    ``IsTruncated`` and ``NextContinuationToken``, every page of a listing
    served from the bucket as it stood at the listing's first page (a change
    lands between two listings, never inside one); ``get_object``,
    ``put_object`` and ``delete_object`` act on one key, a missing one
    raising ``NoSuchKey``. :attr:`calls` counts the client calls by name,
    :attr:`gets` each key's ``get_object`` calls, :attr:`timeline` holds
    (call, start, end) of every listing page (``list0`` for a first page)
    and every ``get_object``, :attr:`clients` each ``boto3.client`` call's
    arguments. After :meth:`shutdown` every listing raises, which ends a
    reader that scans for ever; :meth:`resume` serves again."""

    def __init__(self, page_size: int = 1000):
        import threading

        self.lock = threading.Lock()
        self.page_size = page_size
        self.buckets: dict = {}
        self.calls = collections.Counter()
        self.gets = collections.Counter()
        self.timeline: list = []
        self.clients: list = []
        self.down = False
        self._listings: dict = {}
        self._next_listing = 0
        self.boto3, self.botocore, self.botocore_config = self._client_modules()

    def modules(self) -> dict:
        return {"boto3": self.boto3, "botocore": self.botocore, "botocore.config": self.botocore_config}

    def apply(self, bucket: str, puts: dict | None = None, deletes=()) -> None:
        """Write ``puts`` ({key: bytes}) and delete ``deletes`` at once."""
        import hashlib

        with self.lock:
            objects = self.buckets.setdefault(bucket, {})
            for key, body in (puts or {}).items():
                body = bytes(body)
                objects[key] = (body, '"%s"' % hashlib.md5(body).hexdigest(), time.time())
            for key in deletes:
                objects.pop(key, None)

    def keys(self, bucket: str) -> list:
        with self.lock:
            return sorted(self.buckets.get(bucket, {}))

    def shutdown(self) -> None:
        self.down = True

    def resume(self) -> None:
        self.down = False

    def _client_modules(self):
        import datetime
        import io
        import types

        stand_in = self

        class NoSuchKey(Exception):
            def __init__(self, key):
                super().__init__(f"NoSuchKey: {key}")
                self.response = {"Error": {"Code": "NoSuchKey", "Key": key}}

        class Client:
            exceptions = types.SimpleNamespace(NoSuchKey=NoSuchKey)

            def __init__(self, kwargs):
                self.kwargs = kwargs

            def list_objects_v2(self, Bucket, Prefix="", ContinuationToken=None, MaxKeys=None, **_):  # noqa: N803
                t0 = time.perf_counter()
                if stand_in.down:
                    raise ConnectionError("the S3 endpoint shut down")
                with stand_in.lock:
                    stand_in.calls["list_objects_v2"] += 1
                    if ContinuationToken is None:
                        objects = stand_in.buckets.get(Bucket, {})
                        listing = [(k, *objects[k]) for k in sorted(objects) if k.startswith(Prefix)]
                        lid, at = stand_in._next_listing, 0
                        stand_in._next_listing += 1
                    else:
                        lid, at = map(int, ContinuationToken.split(":"))
                        listing = stand_in._listings.pop(lid)
                    n = min(MaxKeys or stand_in.page_size, stand_in.page_size)
                    page, truncated = listing[at : at + n], at + n < len(listing)
                    if truncated:
                        stand_in._listings[lid] = listing
                resp = {"Name": Bucket, "Prefix": Prefix, "KeyCount": len(page), "IsTruncated": truncated}
                if page:
                    resp["Contents"] = [
                        {"Key": k, "ETag": etag, "Size": len(body),
                         "LastModified": datetime.datetime.fromtimestamp(mtime, datetime.timezone.utc)}
                        for k, body, etag, mtime in page
                    ]
                if truncated:
                    resp["NextContinuationToken"] = f"{lid}:{at + n}"
                stand_in.timeline.append(("list" if ContinuationToken else "list0", t0, time.perf_counter()))
                return resp

            def get_object(self, Bucket, Key, **_):  # noqa: N803
                t0 = time.perf_counter()
                with stand_in.lock:
                    stand_in.calls["get_object"] += 1
                    stand_in.gets[Key] += 1
                    obj = stand_in.buckets.get(Bucket, {}).get(Key)
                if obj is None:
                    raise NoSuchKey(Key)
                resp = {"Body": io.BytesIO(obj[0]), "ETag": obj[1], "ContentLength": len(obj[0])}
                stand_in.timeline.append(("get", t0, time.perf_counter()))
                return resp

            def put_object(self, Bucket, Key, Body, **_):  # noqa: N803
                stand_in.calls["put_object"] += 1
                stand_in.apply(Bucket, {Key: Body.read() if hasattr(Body, "read") else Body})
                return {}

            def delete_object(self, Bucket, Key, **_):  # noqa: N803
                stand_in.calls["delete_object"] += 1
                stand_in.apply(Bucket, deletes=[Key])
                return {}

        boto3 = types.ModuleType("boto3")

        def client(service_name, **kwargs):
            if service_name != "s3":
                raise ValueError(f"the stand-in serves s3 only, not {service_name!r}")
            stand_in.clients.append(dict(kwargs))
            return Client(kwargs)

        boto3.client = client
        botocore = types.ModuleType("botocore")
        botocore.__path__ = []
        config = types.ModuleType("botocore.config")

        class Config:
            def __init__(self, **kwargs):
                self.kwargs = kwargs
                self.__dict__.update(kwargs)

        config.Config = Config
        botocore.config = config
        return boto3, botocore, config


S3_BUCKET, S3_PREFIX = "docs", "corpus/"
S3_OBJECTS = 16_384
S3_REWRITES, S3_DELETES, S3_ADDS = 2_048, 1_024, 1_024  # phase (b), between two scans
S3_DOWN_ADDS, S3_DOWN_REWRITES = 512, 512  # phase (c), while the run is down
S3_SINGLES = 16  # single queries after each phase (B2's streaming pass), an epoch each
S3_BURST = 256  # queries of the last epoch (B2's tensor-core pass)
S3_K = 10
S3_POLL_S = 0.25  # the reader's listing interval
S3_ENDPOINT = "http://127.0.0.1:9000"  # a MinIO-style endpoint; the stand-in answers in process


def _scan_split(timeline: list, t_change: float, done: float) -> dict:
    """The seconds of one phase from the stand-in's timeline (entries after
    ``t_change``): the wait for the scan that carried the change, its
    listing, the fetches (with the reader's work between them), and the
    epoch (from the last fetch to the last row at the subscription)."""
    calls = [e for e in timeline if e[1] >= t_change]
    gets = [e for e in calls if e[0] == "get"]
    first_get = min((e[1] for e in gets), default=done)
    scan_start = max(e[1] for e in calls if e[0] == "list0" and e[1] <= first_get)
    list_end = max(e[2] for e in calls if e[0] in ("list0", "list") and scan_start <= e[1] <= first_get)
    last_get = max((e[2] for e in gets), default=list_end)
    return dict(wait_s=scan_start - t_change, listing_s=list_end - scan_start, fetching_s=last_get - list_end,
                epoch_s=done - last_get, busy_s=done - scan_start, total_s=done - t_change)


def phase_s3_path(torch, env: dict, embedder, n_objects: int = S3_OBJECTS, n_rewrites: int = S3_REWRITES,
                  n_deletes: int = S3_DELETES, n_adds: int = S3_ADDS, n_down_adds: int = S3_DOWN_ADDS,
                  n_down_rewrites: int = S3_DOWN_REWRITES, n_singles: int = S3_SINGLES, n_burst: int = S3_BURST,
                  k: int = S3_K, page_size: int = 1000) -> dict:
    """A live index over an S3 prefix, the upstream project's document-store
    deployment with its documents in a bucket that an ingest job rewrites:
    a ``boto3`` stand-in (:class:`S3StandIn`) in ``sys.modules`` holds
    ``n_objects`` plain-text objects under ``s3://docs/corpus/`` ->
    ``pw.io.s3.read(format="plaintext_by_file", with_metadata=True,
    mode="streaming", persistent_id=, object_cache=)`` through the
    connector's own ``AwsS3Settings.create_client()`` branch, under a
    filesystem persistence backend -> ``SentenceTransformerEmbedder``
    (MiniLM-L6, B1; ``embedder``, http_path's, warmed up) ->
    ``pw.ml.KNNIndex`` (B2) <- text queries from ``pw.io.python.read``
    (``n_singles`` single queries after each phase, then a burst of
    ``n_burst`` in one epoch). Phases: (a) the snapshot scan; (b) between
    two scans ``n_rewrites`` objects rewritten, ``n_deletes`` deleted and
    ``n_adds`` added; (c) the run stopped, ``n_down_adds`` objects added and
    ``n_down_rewrites`` rewritten while it is down, and the run restarted on
    the same persistence directory and object cache. Gates: each phase
    leaves exactly the bucket's live keys in the index; no answer names an
    object deleted before its query was asked; every rewritten object still
    live comes first for its new text; each phase fetches exactly the
    objects it changed (the restart ``n_down_adds + n_down_rewrites``:
    ``get_object`` counted by the stand-in); the burst's hits equal those of
    a ``DeviceKnnIndex`` built directly from the final objects (their
    embeddings recomputed by the same embedder in the run's batches; ids
    exact, scores 1e-5 by ``topk_agreement``); B1, both B2 passes and the
    merge launch. Reports the snapshot's objects/s, phase (b)'s changes/s,
    the restart's seconds to its first answer, each phase split into its
    wait, listing, fetching and epoch seconds, GETs a phase and peak
    memory."""
    import queue
    import shutil
    import tempfile
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    now = time.perf_counter
    t_phase = now()
    rng = np.random.default_rng(SEED + 101)
    texts = _synthetic_texts_bulk(rng, n_objects + n_rewrites + n_adds + n_down_adds + n_down_rewrites, 20, 220)
    fresh = iter(texts[n_objects:])
    name = lambda i: f"{S3_PREFIX}doc-{i:06d}.txt"  # noqa: E731
    start = {name(i): texts[i] for i in range(n_objects)}
    order = rng.permutation(n_objects)
    rewritten_b = [name(i) for i in order[:n_rewrites]]
    deleted_b = [name(i) for i in order[n_rewrites : n_rewrites + n_deletes]]
    change_b = {key: next(fresh) for key in rewritten_b + [name(n_objects + j) for j in range(n_adds)]}
    after_b = {**start, **change_b}
    for key in deleted_b:
        del after_b[key]
    live_b = sorted(after_b)
    rewritten_c = [live_b[i] for i in rng.choice(len(live_b), n_down_rewrites, replace=False)]
    added_c = [name(n_objects + n_adds + j) for j in range(n_down_adds)]
    change_c = {key: next(fresh) for key in rewritten_c + added_c}
    final = {**after_b, **change_c}
    rewritten = sorted(set(rewritten_b) | set(rewritten_c))
    prefix = lambda text: " ".join(text.split()[: min(24, len(text.split()) - 1)])  # noqa: E731 - never a whole object
    pick = lambda keys, n: [keys[i] for i in rng.choice(len(keys), n, replace=False)]  # noqa: E731
    half = n_singles // 2
    singles = {
        "snapshot": [prefix(start[key]) for key in pick(sorted(start), n_singles)],
        # a rewritten object's new text, and a deleted object's text: its key must not come back
        "changes": [change_b[key] for key in rewritten_b[:half]] + [start[key] for key in deleted_b[: n_singles - half]],
        "restart": [change_c[key] for key in rewritten_c[:half]] + [change_c[key] for key in added_c[: n_singles - half]],
    }
    burst = [final[key] for key in pick(rewritten, n_burst // 2)] + \
        [prefix(final[key]) for key in pick(sorted(final), n_burst - n_burst // 2)]
    first_query = prefix(final[pick(live_b, 1)[0]])

    stand_in = S3StandIn(page_size=page_size)
    stand_in.apply(S3_BUCKET, {key: text.encode() for key, text in start.items()})
    folder = tempfile.mkdtemp(prefix="s3_path-")  # the persistence root and the object cache
    persistence = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.path.join(folder, "persistence")))
    settings = pw.io.s3.AwsS3Settings(bucket_name=S3_BUCKET, endpoint=S3_ENDPOINT, with_path_style=True,
                                      region="us-east-1", access_key="stand-in", secret_access_key="stand-in")

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    # ---- instruments: the pipelines' indexes, the runners, the embedder's batches (a query batch holds only
    # texts of queries in flight; the others are objects')
    made, runners, batches, asking = [], [], [], collections.Counter()
    real_init, real_runner_init, real_encode = DeviceKnnIndex.__init__, GraphRunner.__init__, embedder._encoder.encode

    def index_init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    def runner_init(self, *a, **kw):
        real_runner_init(self, *a, **kw)
        runners.append(self)

    def encode(texts_):
        with cv:
            batches.append(("query" if all(asking[t] for t in texts_) else "object", list(texts_)))
        return real_encode(texts_)

    cv = threading.Condition()
    state = {"count": collections.Counter(), "path_of": {}, "texts": {}, "n_live": 0, "pending": {},
             "answers": {}, "answered_at": {}, "asked": {}}

    def on_doc(key, row, time, is_addition):  # noqa: F811 - pw.io.subscribe passes ``time=``
        with cv:
            before = state["count"][key] > 0
            state["count"][key] += 1 if is_addition else -1
            state["n_live"] += (state["count"][key] > 0) - before
            if is_addition:
                state["path_of"][key] = row["path"]
                state["texts"][row["path"]] = row["data"]
                if state["pending"].get(row["path"]) == row["data"]:
                    del state["pending"][row["path"]]
            cv.notify_all()

    def on_answer(key, row, time, is_addition):  # noqa: F811
        with cv:
            if row["qid"] not in state["answers"]:
                asking[state["asked"][row["qid"]]] -= 1
            state["answers"][row["qid"]] = (list(row["ids"]), [float(d) for d in row["dists"]])
            state["answered_at"][row["qid"]] = now()
            cv.notify_all()

    def build(asks: "queue.Queue") -> None:
        class Queries(pw.io.python.ConnectorSubject):
            def run(self):
                while (batch := asks.get()) is not None:
                    for qid, text in batch:
                        self.next(qid=qid, text=text)
                    self.commit()

        pw.clear_graph()
        docs = pw.io.s3.read(f"s3://{S3_BUCKET}/{S3_PREFIX}", aws_s3_settings=settings, format="plaintext_by_file",
                             with_metadata=True, mode="streaming", persistent_id="s3-docs-corpus",
                             object_cache=os.path.join(folder, "object-cache"), poll_interval_s=S3_POLL_S,
                             autocommit_duration_ms=None)
        queries = pw.io.python.read(Queries(), schema=QuerySchema, autocommit_duration_ms=None)
        d_emb = docs.select(path=pw.this._metadata["path"].as_str(), data=pw.this.data, emb=embedder(pw.this.data))
        q_emb = queries.select(qid=pw.this.qid, emb=embedder(pw.this.text))
        index = pw.ml.KNNIndex(d_emb.emb, d_emb, n_dimensions=embedder.get_embedding_dimension(),
                               reserved_space=n_objects + n_adds + n_down_adds, distance_type="cosine", device=DEV)
        answers = index.get_nearest_items_asof_now(q_emb.emb, k=k, with_distances=True).select(
            qid=q_emb.qid, ids=pw.this.path, dists=pw.this.dist)
        pw.io.subscribe(d_emb, on_doc)
        pw.io.subscribe(answers, on_answer)

    errors: list = []
    qid = iter(range(1 << 30))
    asked_after: dict = {}  # qid -> the keys deleted before it was asked
    deleted_so_far: set = set()
    times, gets, indexes, run_from = {}, {}, {}, [0]  # run_from: where the current run's indexes start in ``made``

    def serve():
        try:
            pw.run(persistence_config=persistence)
        except BaseException as exc:  # noqa: BLE001 - reported by the gates below
            errors.append(exc)
            with cv:
                cv.notify_all()

    def wait(what: str, cond) -> None:
        with cv:
            if not cv.wait_for(lambda: cond() or errors, timeout=600) or errors:
                raise AssertionError(f"s3_path: {what} did not arrive; the run raised {errors}")

    def ask(asks, texts_: list) -> list:
        ids = [next(qid) for _ in texts_]
        with cv:
            for i, text in zip(ids, texts_):
                asked_after[i] = frozenset(deleted_so_far)
                state["asked"][i] = text
                asking[text] += 1
        asks.put(list(zip(ids, texts_)))
        wait(f"answers to queries {ids[0]}..{ids[-1]}", lambda: all(i in state["answers"] for i in ids))
        return ids

    def expect(name_: str, t_change: float, live: dict, changed: dict) -> None:
        """Wait until the subscription holds exactly ``live`` -> the phase's
        split, its GETs and the index's keys against the live rows."""
        with cv:
            state["pending"] = {key: text for key, text in changed.items() if state["texts"].get(key) != text}
        wait(name_, lambda: not state["pending"] and state["n_live"] == len(live))
        times[name_] = _scan_split(stand_in.timeline, t_change, now())
        with cv:
            by_key = {key: state["path_of"][key] for key, c in state["count"].items() if c > 0}
        if sorted(by_key.values()) != sorted(live) or any(state["texts"][p] != t for p, t in live.items()):
            raise AssertionError(f"s3_path: after {name_} the run holds {len(by_key)} objects, the bucket {len(live)}")
        pipeline = [ix for ix in made[run_from[0]:] if len(ix._slot_of)]
        if len(pipeline) != 1 or {int(key) for key in pipeline[0]._slot_of} != {int(key) for key in by_key}:
            raise AssertionError(f"s3_path: after {name_} the index does not hold exactly the live keys")
        indexes[name_] = (pipeline[0], {int(key): path for key, path in by_key.items()})

    def stop(asks, th) -> None:
        asks.put(None)
        runners[-1].engine.stop()
        th.join(timeout=120)
        if th.is_alive() or errors:
            raise AssertionError(f"the S3 run did not end cleanly: alive={th.is_alive()}, errors={errors}")

    saved = {m: sys.modules.get(m) for m in stand_in.modules()}
    sys.modules.update(stand_in.modules())
    DeviceKnnIndex.__init__, GraphRunner.__init__, embedder._encoder.encode = index_init, runner_init, encode
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        # ---- run 1: (a) the snapshot scan, (b) changes between two scans
        asks = queue.Queue()
        build(asks)
        t0 = now()
        th = threading.Thread(target=serve, name="s3_path-run", daemon=True)
        th.start()
        expect("snapshot", t0, start, start)
        gets["snapshot"] = stand_in.calls["get_object"]
        for text in singles["snapshot"]:
            ask(asks, [text])
        t_b, got_before = now(), stand_in.calls["get_object"]
        stand_in.apply(S3_BUCKET, {key: change_b[key].encode() for key in change_b}, deleted_b)
        deleted_so_far.update(deleted_b)
        expect("changes", t_b, after_b, change_b)
        gets["changes"] = stand_in.calls["get_object"] - got_before
        for text in singles["changes"]:
            ask(asks, [text])
        stop(asks, th)
        run1_s = now() - t0
        # ---- (c) changes while the run is down, then the restart on the same persistence and object cache
        stand_in.apply(S3_BUCKET, {key: change_c[key].encode() for key in change_c})
        got_before, gets_by_key = stand_in.calls["get_object"], collections.Counter(stand_in.gets)
        run_from[0] = len(made)
        asks = queue.Queue()
        build(asks)
        t_c = now()
        th = threading.Thread(target=serve, name="s3_path-restart", daemon=True)
        th.start()
        first_ids = ask(asks, [first_query])
        first_answer_s = state["answered_at"][first_ids[0]] - t_c
        expect("restart", t_c, final, change_c)
        gets["restart"] = stand_in.calls["get_object"] - got_before
        restart_keys = collections.Counter(stand_in.gets) - gets_by_key
        for text in singles["restart"]:
            ask(asks, [text])
        t_burst = now()
        burst_ids = ask(asks, burst)
        burst_s = now() - t_burst
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        stop(asks, th)
        run2_s = now() - t_c
    finally:
        DeviceKnnIndex.__init__, GraphRunner.__init__ = real_init, real_runner_init
        del embedder._encoder.encode
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
        stand_in.shutdown()
        pw.clear_graph()
        shutil.rmtree(folder, ignore_errors=True)

    # ---- gates
    client = stand_in.clients[0] if stand_in.clients else {}
    if len(stand_in.clients) != 2 or client.get("endpoint_url") != S3_ENDPOINT or \
            client["config"].kwargs != {"s3": {"addressing_style": "path"}}:
        raise AssertionError(f"s3_path: the AwsS3Settings branch did not run as configured: {stand_in.clients}")
    want_gets = {"snapshot": n_objects, "changes": n_rewrites + n_adds, "restart": n_down_adds + n_down_rewrites}
    if gets != want_gets or set(restart_keys) != set(change_c) or max(restart_keys.values()) != 1:
        raise AssertionError(f"s3_path: GETs {gets} (restart over {len(restart_keys)} keys), expected {want_gets}")
    answered = state["answers"]
    stale = [(q, p) for q, (ids, _d) in answered.items() for p in ids if p in asked_after[q]]
    if stale:
        raise AssertionError(f"s3_path: {len(stale)} answers name a deleted object, first {stale[:4]}")
    # the latest encode of each object's text (as the run's index holds it) and of the burst's, re-encoded in
    # the run's own batches
    vec_of, q_vec = {}, {}
    needed = {"object": set(final.values()) | {after_b[key] for key in rewritten_b}, "query": set(burst)}
    for kind, batch in reversed(batches):
        into = vec_of if kind == "object" else q_vec
        if any(t in needed[kind] and t not in into for t in batch):
            for t, v in zip(batch, real_encode(batch)):
                into.setdefault(t, v)
    # each rewritten object comes first for its new text, after (b) in run 1's index and at the end in run 2's
    for name_, keys in (("changes", rewritten_b), ("restart", rewritten)):
        index_, path_of = indexes[name_]
        row = {path: key for key, path in path_of.items()}
        text_of = after_b if name_ == "changes" else final
        vecs = np.stack([vec_of[text_of[key]] for key in keys])
        firsts = []
        for lo in range(0, len(vecs), 256):
            firsts += [int(h[0][0]) for h in DeviceKnnIndex.search_batch(index_, vecs[lo : lo + 256], 1)]
        missed = [key for key, f in zip(keys, firsts) if f != row[key]]
        if missed:
            raise AssertionError(f"s3_path: after {name_}, {len(missed)} rewritten objects do not come first "
                                 f"for their new text, first {missed[:4]}")
    # the burst against an index built directly from the final objects
    paths = sorted(final)
    direct = DeviceKnnIndex(embedder.get_embedding_dimension(), metric="cos", reserved_space=len(paths), device=DEV)
    direct.add_batch_arrays(list(range(len(paths))), np.stack([vec_of[final[p]] for p in paths]))
    want = direct.search_batch(np.stack([q_vec[t] for t in burst]), k)
    at = {p: i for i, p in enumerate(paths)}
    got = [[(at[p], 1.0 - d) for p, d in zip(*answered[q])] for q in burst_ids]
    share, ok = _hits_agree(got, [[(int(i), float(s)) for i, s in row] for row in want], k)
    if not ok:
        raise AssertionError(f"s3_path: the burst's hits differ from a directly built index's ({share})")
    missing = [name_ for name_ in ("gemm_bias_act", "gemm_bias_residual_layernorm", "masked_attention",
                                   "knn_topk_stream", "knn_topk_tc", "knn_topk_merge") if launches.get(name_, 0) == 0]
    if missing:
        raise AssertionError(f"s3_path never launched {missing}")
    result = dict(
        card=env["nvidia_smi"], objects=n_objects, rewrites=n_rewrites, deletes=n_deletes, adds=n_adds,
        down_adds=n_down_adds, down_rewrites=n_down_rewrites, live=len(final), page_size=page_size,
        poll_interval_s=S3_POLL_S, queries=len(answered), burst=len(burst), k=k,
        # rates over the scan and the run's seconds: without the wait for the next listing
        snapshot_objects_per_s=n_objects / times["snapshot"]["busy_s"],
        changes_per_s=(n_rewrites + n_deletes + n_adds) / times["changes"]["busy_s"],
        restart_first_answer_s=first_answer_s, restart_changes_per_s=len(change_c) / times["restart"]["busy_s"],
        burst_answers_per_s=len(burst) / burst_s, phase_times=times, gets=gets,
        listings=stand_in.calls["list_objects_v2"], max_memory_allocated=peak, run_seconds=run1_s + run2_s,
        phase_seconds=now() - t_phase, launches=launches,
    )
    emit("s3_path", **result)
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
    launches.update(phase_analysis_path(torch, env))
    launches.update(phase_train_path(torch, env))
    launches.update(phase_clip_path(torch, env))
    launches.update(phase_ring_path(torch, env))
    http_launches, embedder = phase_http_path(torch, env)
    launches.update(http_launches)
    launches.update(phase_kafka_path(torch, env, embedder))
    launches.update(phase_s3_path(torch, env, embedder))
    rag_launches, cross = phase_rag_path(torch)
    launches.update(rag_launches)
    launches.update(phase_decode_path(torch, cross))
    launches.update(phase_engine_path(torch))
    launches.update(phase_profile(torch))
    launches.update(phase_server_path(torch))
    launches.update(phase_mesh_path(torch))
    launches.update(phase_decode_ext_path(torch))
    launches.update(phase_qa_path(torch))
    launches.update(phase_observe_path(torch, env))
    launches.update(phase_tenant_path(torch))
    launches.update(phase_tier_path(torch))
    launches.update(phase_recovery_path(torch))
    elastic_launches, elastic_entries = phase_elastic_path(torch)
    launches.update(elastic_launches)
    entries += elastic_entries
    launches.update(phase_cluster_path(torch))
    for e in entries:  # launches summed over the twenty-two paths' counted runs
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
