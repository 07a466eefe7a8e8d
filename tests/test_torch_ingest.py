"""The port's host-ingest stage, held against the JAX package's.

The cases of ``tests/test_ingest.py``: the stage's ordered single
committer, its chaos site ``ingest.worker`` (slow and dying workers, their
tasks re-run inline), the autoscaler, ``route_by_length``, the flight
events, the ``PATHWAY_INGEST_WORKERS`` / ``pw.run(ingest_workers=)``
wiring, the tokenizer's shard calls, the encoder and CLIP's image packing
on the stage (byte for byte the inline output), the engine's stager resolving on the stage with and
without persistence, and the ``pathway_ingest_*`` family on ``/metrics``
and the dashboard's column. The stage-core cases run on both packages, and
their results and metrics are equal.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import ingest as jingest
from pathway_tpu.internals import flight_recorder as jfr
from pathway_tpu.internals.ledger import LEDGER as JLEDGER
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
from pathway_tpu.resilience import chaos as jchaos
from pathway_tpu_torch import ingest as tingest
from pathway_tpu_torch.internals import flight_recorder as tfr
from pathway_tpu_torch.internals.ledger import LEDGER as TLEDGER
from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from pathway_tpu_torch.resilience import chaos as tchaos


# the HBM ledger's state (``internals/ledger.DeviceLedger``)
_LEDGER_FIELDS = ("_rows", "_high", "_high_total", "_touched")


@pytest.fixture(autouse=True)
def _restore_hbm_ledgers():
    """Both packages' HBM ledgers as each test found them: a ledger left
    active by one package alone would add ``pathway_worker_hbm_bytes`` to
    that package's ``/metrics`` only, in a later file on the same worker."""
    saved = [(led, {f: copy.deepcopy(getattr(led, f)) for f in _LEDGER_FIELDS}) for led in (JLEDGER, TLEDGER)]
    yield
    for led, fields in saved:
        with led._lock:
            for f, v in fields.items():
                setattr(led, f, v)


PKGS = [(jingest, jfr, jchaos), (tingest, tfr, tchaos)]
WORDS = ["cat", "dog", "bird", "cat", "dog", "cat", "emu", "dog"]
FINAL = {"cat": 3, "dog": 3, "bird": 1, "emu": 1}


@pytest.fixture(autouse=True)
def _clean_stage():
    for ing, _fr, ch in PKGS:
        ing.shutdown_stage()
        ing.INGEST_METRICS.reset()
        ch.deactivate()
    yield
    for ing, _fr, ch in PKGS:
        ing.shutdown_stage()
        ing.INGEST_METRICS.reset()
        ch.deactivate()
    jpw.clear_graph()
    tpw.clear_graph()


@pytest.fixture
def recorders(monkeypatch):
    out = []
    for _ing, fr, _ch in PKGS:
        rec = fr.FlightRecorder(size=512, enabled=True)
        monkeypatch.setattr(fr, "RECORDER", rec)
        out.append(rec)
    return out


def _kinds(rec):
    return [e["kind"] for e in rec.events()]


def _on_both(fn):
    """``fn(ingest, chaos)`` on the reference and the port -> both results."""
    return [fn(ing, ch) for ing, _fr, ch in PKGS]


def test_map_ordered_preserves_submission_order():
    def run(ing, ch):
        st = ing.HostIngestStage(4)
        try:
            out = list(st.map_ordered(lambda x: x * x, range(200)))
        finally:
            st.shutdown()
        snap = ing.INGEST_METRICS.snapshot()
        return out, snap["committed"], snap["host_workers"], snap["enqueued"], snap["dequeued"]

    ref, got = _on_both(run)
    assert got == ref == ([x * x for x in range(200)], 200, 4, 200, 200)


def test_result_error_propagates_at_commit():
    for ing, _fr, _ch in PKGS:
        st = ing.HostIngestStage(2)

        def boom(x):
            if x == 3:
                raise ValueError("task 3 failed")
            return x

        try:
            with pytest.raises(ValueError, match="task 3 failed"):
                list(st.map_ordered(boom, range(6)))
        finally:
            st.shutdown()


def test_chaos_slow_worker_degrades_but_stays_ordered(recorders):
    def run(ing, ch):
        ch.activate([{"site": "ingest.worker", "action": "delay", "delay_s": 0.02, "repeat": True}])
        st = ing.HostIngestStage(3)
        try:
            out = list(st.map_ordered(lambda x: x + 100, range(24)))
        finally:
            st.shutdown()
            ch.deactivate()
        return out, ing.INGEST_METRICS.snapshot()["committed"]

    ref, got = _on_both(run)
    assert got == ref == ([x + 100 for x in range(24)], 24)


def test_chaos_dying_worker_never_drops_or_reorders(recorders):
    """A raise at ``ingest.worker`` kills workers mid-stream; the committer
    re-runs their untouched tasks inline: every row survives, in order."""

    def run(ing, ch):
        ch.activate([{"site": "ingest.worker", "action": "raise", "repeat": True}])
        st = ing.HostIngestStage(2)
        try:
            out = list(st.map_ordered(lambda x: x * 2, range(40)))
        finally:
            st.shutdown()
            ch.deactivate()
        snap = ing.INGEST_METRICS.snapshot()
        return out, snap["committed"], snap["retried"] >= 1

    ref, got = _on_both(run)
    assert got == ref == ([x * 2 for x in range(40)], 40, True)


def test_autoscale_grows_on_backlog_and_shrinks_on_idle(recorders):
    st = tingest.HostIngestStage(1, autoscale=True, min_workers=1, max_workers=4, max_queue=64)
    try:
        assert list(st.map_ordered(lambda x: (time.sleep(0.005), x)[1], range(48))) == list(range(48))
        grown = st.workers
        assert grown > 1, "backlog never grew the pool"
        for _ in range(40):
            st.submit(lambda: None).result()
            time.sleep(0.002)
        assert st.workers < grown, "idle never shrank the pool"
    finally:
        st.shutdown()
    snap = tingest.INGEST_METRICS.snapshot()
    assert snap["scale_up"] >= 1 and snap["scale_down"] >= 1
    assert "ingest.autoscale" in _kinds(recorders[1])


def test_attribution_feed_grows_host_bound_pool():
    def run(ing, ch):
        st = ing.HostIngestStage(1, autoscale=True, max_workers=4)
        try:
            st.observe_attribution(host_prep_s=1.0, device_wait_s=0.01)
            return st.workers
        finally:
            st.shutdown()

    assert _on_both(run) == [2, 2]


def test_route_by_length_splits_and_counts():
    def run(ing, ch):
        split = ing.route_by_length([3, 50, 4, 120, 7], threshold=32)
        snap = ing.INGEST_METRICS.snapshot()
        return split, snap["routed_short"], snap["routed_long"]

    assert _on_both(run) == [(([0, 2, 4], [1, 3]), 3, 2)] * 2


def test_flight_events_and_blackbox_show(tmp_path, recorders, capsys):
    st = tingest.HostIngestStage(1, autoscale=True, max_workers=2, max_queue=4)
    try:
        list(st.map_ordered(lambda x: (time.sleep(0.005), x)[1], range(24)))
    finally:
        st.shutdown()
    kinds = _kinds(recorders[1])
    assert "ingest.enqueue" in kinds and "ingest.dequeue" in kinds
    path = recorders[1].dump("test", directory=str(tmp_path))
    from pathway_tpu_torch import cli

    assert cli.main(["blackbox", "show", path]) == 0
    out = capsys.readouterr().out
    assert "ingest.enqueue" in out and "ingest.dequeue" in out


def test_get_stage_honors_env_and_configure_zero_disables(monkeypatch):
    monkeypatch.delenv("PATHWAY_INGEST_WORKERS", raising=False)
    assert tingest.get_stage() is None
    monkeypatch.setenv("PATHWAY_INGEST_WORKERS", "3")
    st = tingest.get_stage()
    assert st is not None and st.workers == 3
    tingest.shutdown_stage()
    monkeypatch.delenv("PATHWAY_INGEST_WORKERS")
    assert tingest.configure_stage(2) is not None
    assert tingest.configure_stage(0) is None and tingest.get_stage() is None


def test_run_records_ingest_workers_in_run_context():
    t = tpw.debug.table_from_markdown("""
      | x
    1 | 1
    """)
    tpw.io.null.write(t)
    tpw.run(ingest_workers=4)
    from pathway_tpu_torch.internals.parse_graph import G

    assert G.run_context["ingest_workers"] == 4 and tingest.get_stage().workers == 4


TEXTS_MIXED = ["plain ascii text"] * 5 + ["café au lait", "naïve übermut"] + [f"more ascii {i}" for i in range(20)]


def test_tokenizer_mixed_ascii_batch_and_staged_shards_match_the_reference():
    """The ASCII rows take the native path, the others the Python one; the
    stage's shard calls give the same matrix at any worker count, equal
    to the reference tokenizer's ids."""
    ttok, jtok = TTok(), JTok()
    ids, lens = ttok.batch_encode_matrix(TEXTS_MIXED, 32)
    for i, t in enumerate(TEXTS_MIXED):
        ref = jtok.encode(t, max_len=32)
        assert lens[i] == len(ref) and ids[i, : lens[i]].tolist() == ref
        assert (ids[i, lens[i]:] == ttok.pad_id).all()
    texts = [f"document {i} with {'extra words ' * (i % 5)}content" for i in range(300)] + TEXTS_MIXED
    ref_ids, ref_lens = jtok.batch_encode_matrix(texts, 48)
    for workers in (1, 4):
        st = tingest.HostIngestStage(workers)
        try:
            got_ids, got_lens = ttok.batch_encode_matrix(texts, 48, stage=st)
        finally:
            st.shutdown()
        assert np.array_equal(got_ids, ref_ids) and np.array_equal(got_lens, ref_lens)


@pytest.fixture(scope="module")
def tiny_encoder():
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.models.sentence_encoder import SentenceEncoder

    cfg = EncoderConfig(vocab_size=30522, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                        max_position=64, pooling="mean", dtype=torch.float32)
    return SentenceEncoder(config=cfg, max_seq_len=32, max_batch=16, device="cpu")


def test_encoder_stage_byte_identical_any_worker_count_and_records_routing(tiny_encoder):
    texts = [f"doc {i} {'long tail of words ' * (i % 4)}end" for i in range(80)]
    ref = np.asarray(tiny_encoder.encode(texts))
    for workers in (1, 4):
        tingest.configure_stage(workers)
        out = np.asarray(tiny_encoder.encode(texts))
        tingest.shutdown_stage()
        assert out.tobytes() == ref.tobytes(), f"{workers}-worker output diverged"
    snap = tingest.INGEST_METRICS.snapshot()
    assert snap["routed_short"] >= 1 and snap["routed_short"] + snap["routed_long"] == 2 * len(texts)


def test_clip_stage_byte_identical_to_inline_and_to_the_reference():
    """The reference's CLIP stage case: the collaborative pack of 48 images
    in spans of 16 on three workers gives the inline output byte for byte,
    one commit a span, in both packages; the two packages agree on the
    embeddings (f32 towers, the reference's weights carried over)."""
    import jax

    from pathway_tpu.models.clip import CLIPConfig as JCLIPConfig
    from pathway_tpu.models.clip import CLIPEncoder as JCLIPEncoder
    from pathway_tpu_torch.models.clip import CLIPConfig, CLIPEncoder
    from pathway_tpu_torch.weights import from_jax_clip_params

    geometry = dict(image_size=64, patch_size=32, vision_width=64, vision_layers=1, vision_heads=2, text_width=32,
                    text_layers=1, text_heads=2, context_length=16, embed_dim=32)
    jenc = JCLIPEncoder(JCLIPConfig(**geometry, dtype=np.float32), max_batch=16)
    tenc = CLIPEncoder(CLIPConfig(**geometry, dtype=torch.float32), max_batch=16, device="cpu")
    tenc.load_state_dict(from_jax_clip_params(jax.tree_util.tree_map(np.asarray, jenc.vparams),
                                              jax.tree_util.tree_map(np.asarray, jenc.tparams)))
    images = (np.random.default_rng(7).random((48, 64, 64, 3)) * 255).astype(np.uint8)
    outs = []
    for ing, enc in ((jingest, jenc), (tingest, tenc)):
        ref = np.asarray(enc.encode_image(images))
        ing.configure_stage(3)
        out = np.asarray(enc.encode_image(images))
        ing.shutdown_stage()
        assert out.tobytes() == ref.tobytes(), f"collaborative CLIP pack diverged ({ing.__name__})"
        assert ing.INGEST_METRICS.snapshot()["committed"] >= 3  # one pack per span
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-4)


def _build_wordcount(pw, out: str, store: str | None = None):
    conn = sys.modules[pw.__name__ + ".io._connector"]

    class S(pw.Schema):
        word: str

    def reader(ctx):
        for i, w in enumerate(WORDS):
            if i < int(ctx.offsets.get("pos", 0)):
                continue
            ctx.insert({"word": w}, offsets={"pos": i + 1})
            ctx.commit()
            deadline = time.monotonic() + 2.0
            while ctx.session.pending() and time.monotonic() < deadline:
                time.sleep(0.002)

    t = conn.input_table_from_reader(S, reader, name="isrc", persistent_id="i" if store else None,
                                     supports_offsets=True, autocommit_duration_ms=10)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, out)
    return pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store)) if store else None


def _net(text: str) -> dict:
    state: dict = {}
    for line in text.splitlines():
        rec = json.loads(line)
        if rec["diff"] > 0:
            state[rec["word"]] = rec["n"]
        else:
            state.pop(rec["word"], None)
    return state


@pytest.mark.parametrize("persisted", [False, True], ids=["plain", "persisted_under_chaos"])
def test_pipeline_ingest_stage_byte_identical_to_the_reference(tmp_path, monkeypatch, persisted):
    """Depth 2 with the stage resolving the stager's batches on workers
    (under a dying-worker chaos rule and with persistence in the second
    case) gives the reference's strict inline output, byte for byte."""
    ref_out = str(tmp_path / "ref.jsonl")
    cfg = _build_wordcount(jpw, ref_out, str(tmp_path / "ref_store") if persisted else None)
    jpw.run(monitoring_level="none", persistence_config=cfg)
    jpw.clear_graph()
    with open(ref_out) as f:
        ref = f.read()
    assert _net(ref) == FINAL
    monkeypatch.setenv("PATHWAY_INGEST_WORKERS", "2")
    out = str(tmp_path / "staged.jsonl")
    cfg = _build_wordcount(tpw, out, str(tmp_path / "store") if persisted else None)
    if persisted:
        tchaos.activate([{"site": "ingest.worker", "action": "raise", "repeat": True}])
    tpw.run(monitoring_level="none", persistence_config=cfg, pipeline_depth=2)
    tchaos.deactivate()
    with open(out) as f:
        assert f.read() == ref
    snap = tingest.INGEST_METRICS.snapshot()
    assert snap["committed"] > 0, "the engine path never used the stage"
    assert snap["retried"] >= 1 or not persisted, "chaos never killed a worker on the engine path"


def test_metrics_family_matches_the_reference():
    from pathway_tpu.internals.http_monitoring import MonitoringHttpServer as JServer
    from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer as TServer

    assert JServer._ingest_lines() == TServer._ingest_lines() == []  # inactive: nothing renders
    for ing, _fr, _ch in PKGS:
        st = ing.HostIngestStage(2)
        try:
            list(st.map_ordered(lambda x: x, range(5)))
        finally:
            st.shutdown()

    def fixed(lines):  # the utilisation is a measured ratio: names only for that series
        return [ln.rsplit(" ", 1)[0] if "utilization " in ln else ln for ln in lines]

    got, want = fixed(TServer._ingest_lines()), fixed(JServer._ingest_lines())
    assert got == want
    body = "\n".join(TServer._ingest_lines())
    for metric in ("pathway_ingest_queue_depth", "pathway_ingest_host_workers 2", "pathway_ingest_enqueued_total 5",
                   "pathway_ingest_committed_total 5", "pathway_ingest_routed_short_total",
                   "pathway_ingest_routed_long_total"):
        assert metric in body


def test_snapshot_and_dashboard_ingest_column():
    from pathway_tpu_torch.internals.monitoring import StatsMonitor, StatsSnapshot, _operators_table

    snap = StatsSnapshot()
    assert snap.ingest_workers == 0 and snap.ingest_queue_depth == 0
    monitor = StatsMonitor()
    inactive = _operators_table(monitor, time.monotonic(), False)
    assert not any("ingest" in str(c.header) for c in inactive.columns)
    monitor.snapshot.ingest_workers = 3
    monitor.snapshot.ingest_utilization = 0.5
    monitor.snapshot.ingest_committed = 42
    active = _operators_table(monitor, time.monotonic(), False)
    assert any("ingest" in str(c.header) for c in active.columns)
