"""The port's multi-process cluster against the JAX package's, on the CPU.

Every process of a cluster runs the same program (``PATHWAY_PROCESSES``,
``PATHWAY_PROCESS_ID``, ``PATHWAY_FIRST_PORT``, ``PATHWAY_CLUSTER_TOKEN``):
process 0 coordinates, reads the single-reader sources and owns the sinks,
and the rows are exchanged by key shard over TCP
(``pathway_tpu_torch/parallel/multiprocess.py``). The reference's wordcount
program (``tests/test_multiprocess.py``) runs in both packages: over 2
processes, 2 processes x 2 threads, 3 processes (the worker peer mesh) and
``spawn --processes 2`` through the port's command line, each output byte
for byte the single-process run's and the reference cluster's; a
partitioned source persists per process across restarts, exactly once.
An embed -> index -> query program at a tiny width over 2 processes
(documents keyed by id through a groupby, which exchanges them by key
shard) embeds rows in both processes and answers as the reference's
2-process run does: ids equal, distances within 1e-5.

Each process has its own wall-clock limit; a cluster whose coordinator
finds its port taken (``EADDRINUSE``: another test took it first) is formed
again on a new port."""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 120
SCORE_TOL = 1e-5

# the HBM ledger's state (``internals/ledger.DeviceLedger``)
_LEDGER_FIELDS = ("_rows", "_high", "_high_total", "_touched")


@pytest.fixture(autouse=True)
def _restore_hbm_ledgers():
    """Both packages' HBM ledgers as each test found them: a ledger left
    active by one package alone would add ``pathway_worker_hbm_bytes`` to
    that package's ``/metrics`` only, in a later file on the same worker."""
    from pathway_tpu.internals.ledger import LEDGER as JLEDGER
    from pathway_tpu_torch.internals.ledger import LEDGER as TLEDGER

    saved = [(led, {f: copy.deepcopy(getattr(led, f)) for f in _LEDGER_FIELDS}) for led in (JLEDGER, TLEDGER)]
    yield
    for led, fields in saved:
        with led._lock:
            for f, v in fields.items():
                setattr(led, f, v)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra: dict) -> dict:
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("PATHWAY_"):
            del env[k]
    env.update(JAX_PLATFORMS="cpu", PATHWAY_CLUSTER_TOKEN="test-cluster-secret",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _in_use(err: str) -> bool:
    return "Address already in use" in err or "EADDRINUSE" in err


def run_cluster(cwd, prog: str, processes: int, threads: int = 1, extra_env=None, tries: int = 3) -> list[str]:
    """Run ``prog`` as a cluster of ``processes`` x ``threads``; returns each
    process's stderr. A cluster that lost its port is formed again."""
    for attempt in range(tries):
        env = _env({"PATHWAY_THREADS": threads, "PATHWAY_PROCESSES": processes, "PATHWAY_FIRST_PORT": _free_port(),
                    "PATHWAY_FLIGHT_RECORDER_DIR": os.path.join(str(cwd), "blackbox"), **(extra_env or {})})
        procs = [subprocess.Popen([sys.executable, prog], env={**env, "PATHWAY_PROCESS_ID": str(pid)}, cwd=str(cwd),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for pid in range(processes)]
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=PROC_TIMEOUT)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if all(p.returncode == 0 for p in procs):
            return errs
        if attempt + 1 < tries and any(_in_use(e) for e in errs):
            continue
        raise AssertionError("\n".join(f"process {i} rc={p.returncode}\n{e[-3000:]}"
                                       for i, (p, e) in enumerate(zip(procs, errs))))
    raise AssertionError("unreachable")


WC_PROGRAM = textwrap.dedent(
    """
    import os
    import {pkg} as pw

    class S(pw.Schema):
        word: str

    t = pw.io.jsonlines.read(os.environ["WC_IN"], schema=S, mode="static")
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    out = os.environ["WC_OUT"] + "." + os.environ.get("PATHWAY_PROCESS_ID", "0")
    pw.io.csv.write(c, out)
    pw.run(monitoring_level="none")
    """
)


def _program(tmp_path, template: str, pkg: str, tag: str) -> str:
    path = tmp_path / f"prog_{tag}.py"
    path.write_text(template.replace("{pkg}", pkg))
    return str(path)


@pytest.fixture(scope="module")
def wc(tmp_path_factory):
    """The input, the port's single-process output and the reference's
    2-process cluster output."""
    tmp = tmp_path_factory.mktemp("wc")
    (tmp / "in").mkdir()
    words = ["cat", "dog", "cat", "bird", "dog", "cat", "emu", "fox", "owl"] * 7
    (tmp / "in" / "words.jsonl").write_text("".join(json.dumps({"word": w}) + "\n" for w in words))
    outs = {}
    for pkg, procs, tag in (("pathway_tpu_torch", 1, "single"), ("pathway_tpu", 2, "reference")):
        out = str(tmp / f"out_{tag}.csv")
        run_cluster(tmp, _program(tmp, WC_PROGRAM, pkg, tag), procs, extra_env={"WC_IN": tmp / "in", "WC_OUT": out})
        outs[tag] = open(out + ".0").read()
    assert outs["single"] == outs["reference"]
    assert "cat,21" in outs["single"]
    return tmp, outs


@pytest.mark.parametrize("processes,threads", [(2, 1), (2, 2), (3, 1)], ids=["2x1", "2x2", "3x1_peer_mesh"])
def test_wordcount_cluster_matches_single_process_and_reference(wc, processes, threads):
    tmp, outs = wc
    tag = f"{processes}x{threads}"
    out = str(tmp / f"out_{tag}.csv")
    run_cluster(tmp, _program(tmp, WC_PROGRAM, "pathway_tpu_torch", tag), processes, threads,
                extra_env={"WC_IN": tmp / "in", "WC_OUT": out})
    assert open(out + ".0").read() == outs["single"] == outs["reference"]
    # the sinks fire on process 0 only
    assert not any(os.path.exists(f"{out}.{pid}") for pid in range(1, processes))


def test_spawn_processes_through_the_cli(wc):
    """``python -m pathway_tpu_torch spawn --processes 2 prog.py`` sets the
    topology variables and a cluster token and launches both processes."""
    tmp, outs = wc
    prog = _program(tmp, WC_PROGRAM, "pathway_tpu_torch", "cli")
    out = str(tmp / "out_cli.csv")
    for attempt in range(3):
        env = _env({"WC_IN": tmp / "in", "WC_OUT": out})
        del env["PATHWAY_CLUSTER_TOKEN"]  # spawn makes one
        r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "spawn", "--processes", "2", "--first-port",
                            str(_free_port()), prog], env=env, cwd=str(tmp), capture_output=True, text=True,
                           timeout=PROC_TIMEOUT)
        if r.returncode == 0 or not _in_use(r.stderr) or attempt == 2:
            break
    assert r.returncode == 0, r.stderr[-3000:]
    assert open(out + ".0").read() == outs["single"]
    assert not os.path.exists(out + ".1")


def test_spawn_from_env_reruns_spawn(wc):
    """``spawn-from-env`` reads the arguments ``spawn`` leaves in
    ``PATHWAY_SPAWN_ARGS``; without them it fails as a usage error."""
    tmp, outs = wc
    prog = _program(tmp, WC_PROGRAM, "pathway_tpu_torch", "from_env")
    out = str(tmp / "out_from_env.csv")
    env = _env({"WC_IN": tmp / "in", "WC_OUT": out,
                "PATHWAY_SPAWN_ARGS": f"--processes=2 --first-port={_free_port()} {prog}"})
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "spawn-from-env"], env=env, cwd=str(tmp),
                       capture_output=True, text=True, timeout=PROC_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert open(out + ".0").read() == outs["single"]
    del env["PATHWAY_SPAWN_ARGS"]
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "spawn-from-env"], env=env, capture_output=True,
                       text=True, timeout=PROC_TIMEOUT)
    assert r.returncode == 2 and "PATHWAY_SPAWN_ARGS is not set" in r.stderr  # a usage error


PERSIST_PROGRAM = textwrap.dedent(
    """
    import os
    import {pkg} as pw
    from {pkg}.io._connector import input_table_from_reader

    N = int(os.environ["PP_N"])
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    NPROC = int(os.environ.get("PATHWAY_PROCESSES", "1"))

    class S(pw.Schema):
        word: str

    WORDS = ["cat", "dog", "bird"]

    def reader(ctx):
        start = int(ctx.offsets.get("pos", 0))
        for i in range(N):
            if NPROC > 1 and i % NPROC != ctx.process_id:
                continue
            if i < start:
                continue  # ingested before the restart
            ctx.insert({"word": WORDS[i % 3]}, offsets={"pos": i + 1})
        ctx.commit()

    t = input_table_from_reader(S, reader, name="part_src", parallel_readers=True, persistent_id="pp",
                                supports_offsets=True, autocommit_duration_ms=100)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, os.environ["WC_OUT"] + "." + str(PID))
    pw.run(monitoring_level="none", persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.environ["PP_STORE"])))
    """
)


def net_counts(path: str) -> dict:
    state: dict = {}
    if not os.path.exists(path):
        return state
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["diff"] > 0:
                state[rec["word"]] = rec["n"]
            elif state.get(rec["word"]) == rec["n"]:
                del state[rec["word"]]
    return state


def test_partitioned_source_persistence_across_restart(tmp_path):
    """Each process logs its own slice of a partitioned source and resumes
    from its own offsets: a restart with more input ingests only the delta,
    and a restart with none re-delivers nothing."""
    prog = _program(tmp_path, PERSIST_PROGRAM, "pathway_tpu_torch", "pp")
    store = str(tmp_path / "store")
    want = {60: {"cat": 20, "dog": 20, "bird": 20}, 90: {"cat": 30, "dog": 30, "bird": 30}}
    for run, n in enumerate((60, 90, 90)):
        out = str(tmp_path / f"out_pp{run}")
        run_cluster(tmp_path, prog, 2, extra_env={"PP_N": n, "PP_STORE": store, "WC_OUT": out})
        if run < 2:
            assert net_counts(out + ".0") == want[n]
        else:
            assert not os.path.exists(out + ".0") or open(out + ".0").read().strip() == ""
        assert os.path.isdir(os.path.join(store, "proc-1")), os.listdir(store)


EMBED_PROGRAM = textwrap.dedent(
    """
    import atexit, json, os
    import numpy as np
    import {pkg} as pw
    from {pkg}.models.sentence_encoder import SentenceEncoder

    PID = os.environ.get("PATHWAY_PROCESS_ID", "0")
    CFG = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32,
               pooling="mean")
    {encoder}
    embedded = [0]

    def _report():
        with open(os.environ["EMB_OUT"] + "." + PID, "w") as f:
            json.dump({"embedded": embedded[0]}, f)

    atexit.register(_report)

    def embed(toks: str) -> tuple:
        embedded[0] += 1
        return tuple(float(x) for x in enc.encode_tokens([[int(t) for t in toks.split()]])[0])

    rng = np.random.default_rng(7)
    docs = [(i, " ".join(str(int(t)) for t in rng.integers(3, 512, 8))) for i in range(48)]
    queries = [(100 + i, " ".join(str(int(t)) for t in rng.integers(3, 512, 8))) for i in range(5)]
    queries += [(200, docs[5][1]), (201, docs[31][1])]
    schema = pw.schema_from_types(doc_id=int, toks=str)
    # documents keyed by id: the groupby exchanges them by key shard, so the
    # embedding UDF runs in the process that owns each document
    dt = pw.debug.table_from_rows(schema=schema, rows=docs).groupby(pw.this.doc_id).reduce(
        pw.this.doc_id, toks=pw.reducers.any(pw.this.toks))
    dt = dt.select(pw.this.doc_id, emb=pw.apply(embed, pw.this.toks))
    qt = pw.debug.table_from_rows(schema=schema, rows=queries).select(pw.this.doc_id,
                                                                      emb=pw.apply(embed, pw.this.toks))
    index = pw.ml.KNNIndex(dt.emb, dt, n_dimensions=32, distance_type="cosine", reserved_space=64{knn_kw})
    hits = index.get_nearest_items(qt.emb, k=3, with_distances=True).select(
        qid=qt.doc_id, ids=pw.this.doc_id, dist=pw.this.dist)
    pw.io.jsonlines.write(hits, os.environ["WC_OUT"] + "." + PID)
    pw.run(monitoring_level="none")
    """
)

_JAX_ENCODER = """
import jax.numpy as jnp
from pathway_tpu.models.encoder import EncoderConfig
enc = SentenceEncoder(config=EncoderConfig(**CFG, dtype=jnp.float32), checkpoint_dir="/nonexistent", max_seq_len=16,
                      max_batch=16)
"""

_PORT_ENCODER = """
import torch
from pathway_tpu_torch.models.encoder import EncoderConfig
enc = SentenceEncoder(config=EncoderConfig(**CFG, dtype=torch.float32), max_seq_len=16, max_batch=16, device="cpu",
                      params=torch.load(os.environ["EMB_WEIGHTS"]))
"""


def _final_hits(path: str) -> dict:
    state: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["diff"] > 0:
                state[rec["qid"]] = (list(rec["ids"]), list(rec["dist"]))
            elif state.get(rec["qid"]) == (list(rec["ids"]), list(rec["dist"])):
                del state[rec["qid"]]
    return state


def test_embed_index_query_over_two_processes_matches_reference(tmp_path):
    """Both processes embed their key shards (a row-wise UDF runs where the
    row lives: after the groupby, on its key's shard); the index, pinned to
    shard 0, answers on process 0 what the reference's 2-process cluster
    answers."""
    import jax
    import torch
    from flax.core import meta

    from pathway_tpu.models.encoder import EncoderConfig as JCfg
    from pathway_tpu.models.sentence_encoder import SentenceEncoder as JEnc
    from pathway_tpu_torch.weights import from_jax_params

    cfg = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32,
               pooling="mean")
    import jax.numpy as jnp

    jenc = JEnc(config=JCfg(**cfg, dtype=jnp.float32), checkpoint_dir="/nonexistent", max_seq_len=16, max_batch=16)
    weights = str(tmp_path / "weights.pt")
    torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, meta.unbox(jenc.params))), weights)
    got = {}
    for pkg, encoder, knn_kw in (("pathway_tpu", _JAX_ENCODER, ""),
                                 ("pathway_tpu_torch", _PORT_ENCODER, ', device="cpu"')):
        template = EMBED_PROGRAM.replace("{encoder}", encoder.strip()).replace(
            "{knn_kw}", knn_kw)
        out, emb = str(tmp_path / f"hits_{pkg}"), str(tmp_path / f"emb_{pkg}")
        run_cluster(tmp_path, _program(tmp_path, template, pkg, pkg), 2,
                    extra_env={"WC_OUT": out, "EMB_OUT": emb, "EMB_WEIGHTS": weights})
        got[pkg] = (_final_hits(out + ".0"), [json.load(open(f"{emb}.{p}"))["embedded"] for p in (0, 1)])
        assert not os.path.exists(out + ".1")
    (port, port_emb), (ref, ref_emb) = got["pathway_tpu_torch"], got["pathway_tpu"]
    assert sorted(port) == sorted(ref) == [100, 101, 102, 103, 104, 200, 201]
    for qid in ref:
        assert port[qid][0] == ref[qid][0], (qid, port[qid], ref[qid])
        np.testing.assert_allclose(port[qid][1], ref[qid][1], rtol=SCORE_TOL, atol=SCORE_TOL)
    assert port[200][0][0] == 5 and port[201][0][0] == 31
    # every row embedded once: the documents in the process that owns
    # their key shard, the queries (never exchanged) on process 0
    assert sum(port_emb) == 55 and min(port_emb) > 0, port_emb
    assert port_emb == ref_emb
