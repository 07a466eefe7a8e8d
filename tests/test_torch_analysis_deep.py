"""The port's deep verifier (``pathway_tpu_torch.analysis.deep``, rules
PWL017–PWL020) against the reference's, on the CPU.

The cases of the reference's ``tests/test_analysis_deep.py``: one positive
and one clean fixture program per rule (the reference's jax-free fixtures
with ``pathway_tpu`` renamed, written into ``tmp_path``; for PWL017 a torch
counterpart of ``deep_host_sync.py``, whose staging UDF reads a torch tensor
back with ``.cpu()`` where the reference's calls ``jax.device_get``), run
through ``analysis.program.analyze_program`` in-process in both packages:
exit codes, rule ids, severities and details equal (PWL017's markers and
PWL018's message speak of torch: ROADMAP Queue C). Then suppression, the
bucket-sweep test (the port encoder's dispatched geometries against
``predict_compile_keys``, the reference's against its jit cache), the op
tracer (the port's counterpart of the jaxpr walker), and the ops hooks
held equal to the reference's over a grid of specs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.analysis.program import analyze_program as janalyze
from pathway_tpu_torch.analysis.program import analyze_program as tanalyze

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")

#: the port's counterpart of the reference's deep_host_sync.py
TORCH_HOST_SYNC = '''"""Deep-analysis fixture (PWL017 positive): a UDF on the staging path
into a device-backed KNN index reads a torch tensor back with ``.cpu()`` —
a synchronous device->host transfer paid on every epoch's staged batch
(on the card ``torch.cuda.set_sync_debug_mode("error")`` raises on it)."""

import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def embed_on_device(x, y):
    # a device round trip inside host-side staging: the readback, its one
    # sync (the vector is filled on the device), blocks dispatch pipelining
    vec = torch.stack([torch.full((), x, device=DEVICE), torch.full((), y, device=DEVICE)])
    host = (vec / (torch.linalg.norm(vec) + 1e-6)).cpu()
    return (float(host[0]), float(host[1]))


docs = pw.debug.table_from_markdown(
    """
    | x   | y
  1 | 1.0 | 0.0
  2 | 0.0 | 1.0
    """
)
docs = docs.select(emb=pw.apply_with_type(embed_on_device, pw.ANY, docs.x, docs.y))

queries = pw.debug.table_from_markdown(
    """
    | x   | y
  9 | 1.0 | 1.0
    """
)
queries = queries.select(
    emb=pw.apply_with_type(lambda x, y: (x, y), pw.ANY, queries.x, queries.y)
)

index = KNNIndex(
    docs.emb,
    docs,
    n_dimensions=2,
    reserved_space=100,
    distance_type="cosine",
)
res = index.get_nearest_items(queries.emb, k=2)

pw.io.null.write(res)

pw.run()
'''


def port_fixture(tmp_path, name: str) -> str:
    """The port's copy of a reference fixture in ``tmp_path``."""
    path = tmp_path / name
    if name == "deep_host_sync.py":
        path.write_text(TORCH_HOST_SYNC)
    else:
        with open(os.path.join(FIXTURES, name)) as f:
            path.write_text(f.read().replace("pathway_tpu", "pathway_tpu_torch"))
    return str(path)


def analyze(fn, program: str, *, as_json=False, deep=False, fail_on="error", strict_warnings=False):
    """``analyze_program`` in-process -> (exit code, stdout, stderr); the
    process environment (which fixtures set) is restored after."""
    saved = dict(os.environ)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = fn(program, as_json=as_json, deep=deep, fail_on=fail_on, strict_warnings=strict_warnings, out=out)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return rc, out.getvalue(), err.getvalue()


def norm_json(text: str, *, messages: bool = True) -> dict:
    payload = json.loads(text)
    for d in payload["diagnostics"]:
        if "location" in d:
            d["location"]["file"] = os.path.basename(d["location"]["file"])
        if not messages:
            d.pop("message")
    return json.loads(json.dumps(payload).replace("pathway_tpu_torch", "pathway_tpu"))


def both(tmp_path, name: str, *, messages: bool = True, **kw):
    """Both packages' analysis of one fixture: exit codes and output equal
    (JSON normalised) -> the port's (exit code, stdout)."""
    want = analyze(janalyze, os.path.join(FIXTURES, name), **kw)
    got = analyze(tanalyze, port_fixture(tmp_path, name), **kw)
    assert got[0] == want[0], (got, want)
    if kw.get("as_json"):
        assert norm_json(got[1], messages=messages) == norm_json(want[1], messages=messages)
    else:
        rules = lambda text: [ln.split()[:2] for ln in text.splitlines() if ln.startswith("PWL")]  # noqa: E731
        assert rules(got[1]) == rules(want[1])
        assert got[1].splitlines()[-1] == want[1].splitlines()[-1]
    return got[:2]


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.delenv("PATHWAY_COMPILE_BUDGET", raising=False)
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


# ---------------------------------------------------------------------------
# fixture matrix: one positive + one clean program per deep rule
# ---------------------------------------------------------------------------

_CASES = [
    ("PWL017", "deep_host_sync.py", "deep_host_sync_clean.py"),
    ("PWL018", "deep_recompile.py", "deep_recompile_clean.py"),
    ("PWL019", "deep_resharding.py", "deep_resharding_clean.py"),
    ("PWL020", "deep_exactly_once.py", "deep_exactly_once_clean.py"),
]


@pytest.mark.parametrize("rule,positive,clean", _CASES, ids=[c[0] for c in _CASES])
def test_deep_rule_fires_on_positive_fixture(rule, positive, clean, tmp_path):
    """The positive fixture warns (exit 0 under the default
    --fail-on=error), and --fail-on=warn makes the finding fatal."""
    rc, out = both(tmp_path, positive, deep=True)
    assert rc == 0 and rule in out and "warning" in out
    rc, _ = both(tmp_path, positive, deep=True, fail_on="warn")
    assert rc == 1
    # the findings themselves: ids, severities and details (PWL017's
    # markers and PWL018's message aside)
    _, out = analyze(tanalyze, port_fixture(tmp_path, positive), deep=True, as_json=True)[:2]
    _, want = analyze(janalyze, os.path.join(FIXTURES, positive), deep=True, as_json=True)[:2]
    got, want = norm_json(out, messages=False), norm_json(want, messages=False)
    if rule == "PWL017":
        for payload in (got, want):
            for d in payload["diagnostics"]:
                d["detail"].pop("markers")
    assert got == want


@pytest.mark.parametrize("rule,positive,clean", _CASES, ids=[c[0] for c in _CASES])
def test_deep_rule_silent_on_clean_fixture(rule, positive, clean, tmp_path):
    rc, out = both(tmp_path, clean, deep=True, fail_on="warn")
    assert rc == 0 and rule not in out


@pytest.mark.parametrize("rule,positive,clean", _CASES, ids=[c[0] for c in _CASES])
def test_deep_rules_require_deep_flag(rule, positive, clean, tmp_path):
    """Without --deep the op-level pass never runs — the positive
    fixtures lint clean under the plain rule pack."""
    rc, out = both(tmp_path, positive)
    assert rc == 0 and rule not in out


def test_deep_json_carries_anchor_and_detail(tmp_path):
    """The PWL017 finding names the sync markers (``cpu``: the reference's
    fixture gives ``device_get``), the target callable, and the fixture's
    own source line; the summary carries the suppressed count."""
    rc, out = analyze(tanalyze, port_fixture(tmp_path, "deep_host_sync.py"), deep=True, as_json=True)[:2]
    assert rc == 0
    payload = json.loads(out)
    assert payload["summary"]["suppressed"] == 0
    (diag,) = [d for d in payload["diagnostics"] if d["rule"] == "PWL017"]
    assert diag["severity"] == "warning"
    assert diag["detail"]["markers"] == ["cpu"]
    assert diag["detail"]["target"].startswith("knn.search[")
    assert diag["location"]["file"].endswith("deep_host_sync.py") and diag["location"]["line"] > 0


def test_deep_json_sorted_by_rule_then_node(tmp_path):
    rc, out = both(tmp_path, "deep_exactly_once.py", deep=True, as_json=True)
    rules = [d["rule"] for d in json.loads(out)["diagnostics"]]
    assert rc == 0 and rules == sorted(rules) and rules.count("PWL020") == 2


def test_pwl018_json_breakdown_matches_total(tmp_path):
    rc, out = both(tmp_path, "deep_recompile.py", deep=True, as_json=True, messages=False)
    (diag,) = [d for d in json.loads(out)["diagnostics"] if d["rule"] == "PWL018"]
    detail = diag["detail"]
    assert rc == 0 and detail["budget"] == 2
    assert detail["predicted_compiles"] == sum(detail["per_target"].values()) > detail["budget"]
    assert "dispatch geometries" in diag["message"] and "compile" not in diag["message"].replace(
        "PATHWAY_COMPILE_BUDGET", "")


# ---------------------------------------------------------------------------
# suppression + in-process surface
# ---------------------------------------------------------------------------


def _build_sync_udf_graph(pw):
    if pw is jpw:
        def embed(x, y):
            return tuple(jax.device_get(jax.numpy.asarray([x, y])).tolist())
    else:
        def embed(x, y):
            return tuple(torch.tensor([x, y]).cpu().tolist())

    docs = pw.debug.table_from_markdown("""
        | x   | y
      1 | 1.0 | 0.0
    """)
    docs = docs.select(emb=pw.apply_with_type(embed, pw.ANY, docs.x, docs.y))
    queries = docs.select(emb=docs.emb)
    index = pw.stdlib.ml.index.KNNIndex(docs.emb, docs, n_dimensions=2, reserved_space=16, distance_type="cosine")
    return index.get_nearest_items(queries.emb, k=2)


def test_suppress_drops_deep_finding_and_counts_it():
    counts = []
    for pw in (jpw, tpw):
        pw.clear_graph()
        _build_sync_udf_graph(pw)
        assert any(d.rule == "PWL017" for d in pw.analysis.analyze(deep=True))
        pw.clear_graph()
        with pw.analysis.suppress("PWL017"):
            _build_sync_udf_graph(pw)
        stats: dict = {}
        diags = pw.analysis.analyze(deep=True, stats=stats)
        assert not any(d.rule == "PWL017" for d in diags) and stats["suppressed"] >= 1
        counts.append(stats["suppressed"])
    assert counts[0] == counts[1]


def test_deep_rule_ids_registered():
    assert tpw.analysis.DEEP_RULE_IDS == jpw.analysis.DEEP_RULE_IDS == ("PWL017", "PWL018", "PWL019", "PWL020")
    for rule in tpw.analysis.DEEP_RULE_IDS:
        assert rule in tpw.analysis.RULES


# ---------------------------------------------------------------------------
# PWL018 ground truth: predicted keys == dispatched geometries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_encoder():
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.models.sentence_encoder import SentenceEncoder

    cfg = EncoderConfig(vocab_size=30000, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                        max_position=64, pooling="mean")
    return SentenceEncoder(config=cfg, checkpoint_dir="/nonexistent", max_seq_len=32, max_batch=16, device="cpu")


_SWEEP = [3, 5, 9, 17, 20, 31, 12, 7, 28, 2, 16, 33, 4, 4, 8, 19, 25, 30]


def test_bucket_sweep_predictor_matches_dispatched_geometries(tiny_encoder):
    """The predictor's encoder model against reality: a length sweep
    through ``encode_tokens`` dispatches exactly the predicted (rows, seq)
    geometries (the reference holds the same keys to its jit cache), a
    second pass adds none, and a grown sweep exactly the new keys."""
    from pathway_tpu.models.batching import predict_compile_keys as jpredict

    enc = tiny_encoder
    toks = [[(i * 7 + j) % 29000 + 1 for j in range(n)] for i, n in enumerate(_SWEEP)]
    predicted = enc.predict_compile_keys(_SWEEP)
    assert predicted and predicted == jpredict(_SWEEP, max_batch=16)
    base = enc.dispatch_geometry_count()
    out = enc.encode_tokens(toks)
    assert out.shape == (len(_SWEEP), enc.dim)
    assert enc.dispatch_geometry_count() - base == len(predicted)
    assert enc._geometries >= predicted
    enc.encode_tokens(toks)
    assert enc.dispatch_geometry_count() - base == len(predicted)
    more = _SWEEP + [1, 32, 32, 32, 6, 6]
    enc.encode_tokens([[(i * 5 + j) % 29000 + 1 for j in range(n)] for i, n in enumerate(more)])
    assert enc.dispatch_geometry_count() - base == len(enc.predict_compile_keys(more))


def test_compile_bucket_space_bounds_any_workload():
    from pathway_tpu.models.batching import compile_bucket_space as jspace
    from pathway_tpu_torch.models.batching import compile_bucket_space, predict_compile_keys

    bound = compile_bucket_space(32, 16)
    assert bound == jspace(32, 16)
    for lengths in ([1] * 100, list(range(1, 33)) * 4, [32] * 7):
        assert len(predict_compile_keys(lengths, max_batch=16)) <= bound


# ---------------------------------------------------------------------------
# unit level: the op tracer, the ladder arithmetic, the unbucketed path
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_op_tracer_finds_a_sync_nested_in_a_helper():
    """The port's counterpart of the jaxpr walker test: an ``.item()`` two
    calls down is found, as are the other syncs; a clean callable has
    none, and the trace records its ops."""
    from pathway_tpu_torch.analysis.deep.targets import OpTrace

    def scale_of(x):
        return x.abs().max().item()

    def helper(x):
        return x / scale_of(x)

    def leaky(x, m):
        y = helper(x) * 2.0
        return y[m], torch.nonzero(m), y.cpu(), int(y.sum())

    assert OpTrace(leaky, (_meta(4, 3), _meta(4, 3, dtype=torch.bool))).syncs == [
        "item", "boolean_mask", "nonzero", "cpu", "item"]

    def clean(x, m):
        return torch.topk(torch.where(m, x, 0.0) @ x.T, 2)

    trace = OpTrace(clean, (_meta(4, 3), _meta(4, 3, dtype=torch.bool)))
    assert trace.syncs == [] and "topk" in trace.ops and "mm" in trace.ops
    # host tensors are not the card's: nothing to sync
    assert OpTrace(leaky, (torch.ones(4, 3), torch.ones(4, 3, dtype=torch.bool))).syncs == []


def test_op_tracer_records_synchronize_and_restores_it():
    from pathway_tpu_torch.analysis.deep.targets import OpTrace

    real = torch.cuda.synchronize

    def waits(x):
        y = x + 1
        torch.cuda.synchronize()
        return y

    assert OpTrace(waits, (_meta(2),)).syncs == ["synchronize"]
    assert torch.cuda.synchronize is real


def test_op_tracer_leaves_other_threads_synchronize_alone(monkeypatch):
    """A ``torch.cuda.synchronize`` from another thread while a trace runs
    is neither recorded against the target nor swallowed: it reaches the
    real call."""
    import threading

    from pathway_tpu_torch.analysis.deep.targets import OpTrace

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))

    def other_thread_waits(x):
        worker = threading.Thread(target=torch.cuda.synchronize, args=("cuda:0",))
        worker.start()
        worker.join()
        return x + 1

    assert OpTrace(other_thread_waits, (_meta(2),)).syncs == []
    assert calls == ["cuda:0"]


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
def test_knn_deep_trace_spec_is_the_dispatched_search(metric):
    """The KNN target's callable: on ``meta`` it traces without a sync; on
    CPU tensors it is the plain top-k, equal to the reference's traced
    callable run on the same inputs (ids exact, scores at 1e-5)."""
    from pathway_tpu.ops import knn as jknn
    from pathway_tpu_torch.analysis.deep.targets import OpTrace
    from pathway_tpu_torch.ops import knn as tknn

    spec = {"dimensions": 6, "metric": metric}
    tspec, jspec = tknn.deep_trace_spec(spec), jknn.deep_trace_spec(spec)
    assert tspec["name"] == jspec["name"]
    assert [tuple(a.shape) for a in tspec["args"]] == [tuple(a.shape) for a in jspec["args"]]
    assert all(a.device.type == "meta" for a in tspec["args"])
    assert OpTrace(tspec["fn"], tspec["args"]).syncs == []
    rng = np.random.default_rng(7)
    matrix = rng.standard_normal((64, 6)).astype(np.float32)
    if metric == "cos":
        matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    valid = rng.random(64) > 0.2
    queries = rng.standard_normal((8, 6)).astype(np.float32)
    tv, ti = tspec["fn"](torch.from_numpy(matrix), torch.from_numpy(valid), torch.from_numpy(queries))
    jv, ji = jspec["fn"](matrix, valid, queries)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def test_decode_deep_trace_spec_is_the_dispatched_step():
    """The decode target's callable: ``paged_decode_attention`` traced on
    ``meta`` without a sync; on CPU tensors its plain version, equal to the
    reference's traced callable on the same pool at f32 1e-5."""
    from pathway_tpu.ops import paged_attention as jpa
    from pathway_tpu_torch.analysis.deep.targets import OpTrace
    from pathway_tpu_torch.ops import paged_attention as tpa

    cfg = {"lanes": 3, "page_size": 4, "max_seq": 16, "pages": 12}
    tspec, jspec = tpa.deep_trace_spec(cfg), jpa.deep_trace_spec(cfg)
    assert tspec["name"] == jspec["name"]
    assert [tuple(a.shape) for a in tspec["args"]] == [tuple(a.shape) for a in jspec["args"]]
    assert OpTrace(tspec["fn"], tspec["args"]).syncs == []
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    kp = rng.standard_normal((12, 4, 64)).astype(np.float32)
    vp = rng.standard_normal((12, 4, 64)).astype(np.float32)
    pt = rng.integers(0, 12, (3, 4)).astype(np.int32)
    ln = np.array([0, 5, 16], np.int32)
    got = tspec["fn"](*(torch.from_numpy(a) for a in (q, kp, vp, pt, ln)))
    want = jspec["fn"](q, kp, vp, pt, ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_k_bucket_ladder_is_pow2_and_covers_k():
    from pathway_tpu.ops.knn import k_bucket_ladder as jladder
    from pathway_tpu_torch.ops.knn import k_bucket_ladder

    assert k_bucket_ladder(1) == (8,)
    assert k_bucket_ladder(8) == (8,)
    assert k_bucket_ladder(9) == (8, 16)
    assert k_bucket_ladder(100) == (8, 16, 32, 64, 128)
    for k_max in (1, 7, 8, 33, 250, 1 << 20):
        assert k_bucket_ladder(k_max)[-1] >= k_max and k_bucket_ladder(k_max) == jladder(k_max)


def test_knn_compile_profile_dynamic_k_walks_ladder():
    from pathway_tpu_torch.ops.knn import deep_compile_profile, k_bucket_ladder

    static = deep_compile_profile({"reserved_space": 1000, "query_k": 5, "query_k_dynamic": False})
    assert static["compiles"] == 3 + 1
    dynamic = deep_compile_profile({"reserved_space": 1000, "query_k_dynamic": True})
    assert dynamic["compiles"] == 3 + len(k_bucket_ladder(1000))
    assert dynamic["detail"]["k_buckets"] == list(k_bucket_ladder(1000))
    sharded = deep_compile_profile({"reserved_space": 1000, "query_k_dynamic": True}, {"data": 4, "model": 1})
    assert sharded["detail"]["per_shard_capacity"] == 250 and sharded["compiles"] <= dynamic["compiles"]
    tiered = deep_compile_profile({"reserved_space": 1000, "query_k": 5, "query_k_dynamic": False, "tiers": "auto"})
    assert tiered["compiles"] == static["compiles"] + 1 + 1


_KNN_SPECS = [
    {"reserved_space": rows, "query_k": k, "query_k_dynamic": dyn, **({"tiers": True} if tiers else {})}
    for rows in (1, 100, 1 << 20) for k in (1, 3, 10, 64) for dyn in (False, True) for tiers in (False, True)
]
_DECODE_SPECS = [
    {"max_seq": s, **extra}
    for s in (None, 48, 512, 2048)
    for extra in ({}, {"spec_tokens": 4}, {"prefix_cache": True}, {"prefill_chunk": 64},
                  {"spec_tokens": 2, "prefix_cache": True, "prefill_chunk": 100})
]


@pytest.mark.parametrize("mesh", [None, {"data": 4, "model": 1}], ids=["one_device", "data4"])
def test_knn_compile_profiles_equal_the_reference(mesh):
    from pathway_tpu.ops.knn import deep_compile_profile as jprofile
    from pathway_tpu_torch.ops.knn import deep_compile_profile

    for spec in _KNN_SPECS:
        assert deep_compile_profile(spec, mesh) == jprofile(spec, mesh), spec


def test_decode_compile_profiles_and_tier_profiles_equal_the_reference():
    from pathway_tpu.ops.paged_attention import deep_compile_profile as jprofile
    from pathway_tpu.ops.tiered_knn import TierConfig as JTierConfig
    from pathway_tpu.ops.tiered_knn import deep_tier_profile as jtier
    from pathway_tpu_torch.ops.paged_attention import deep_compile_profile
    from pathway_tpu_torch.ops.tiered_knn import TierConfig, deep_tier_profile

    for spec in _DECODE_SPECS:
        assert deep_compile_profile(spec) == jprofile(spec), spec
    assert deep_tier_profile(None) is jtier(None) is None
    for kw in ({}, {"n_clusters": 16, "n_probe": 2}, {"cold_dtype": "f32", "hot_dtype": "int8"}):
        assert deep_tier_profile(TierConfig(**kw)) == jtier(JTierConfig(**kw))
        assert deep_tier_profile(TierConfig(**kw).as_dict()) == jtier(JTierConfig(**kw).as_dict())


def test_staging_placement_equals_the_reference():
    from pathway_tpu.engine.device_ring import staging_placement as jplace
    from pathway_tpu_torch.engine.device_ring import staging_placement

    for axes in (None, {}, {"data": 1, "model": 1}, {"data": 2, "model": 1}, {"data": 4, "model": 2}):
        assert staging_placement(axes) == jplace(axes)


def test_unbucketed_dimension_flagged_unconditionally(monkeypatch):
    from pathway_tpu_torch.analysis.deep.recompile import check_recompile_storm
    from pathway_tpu_torch.analysis.deep.targets import DeepTarget
    from pathway_tpu_torch.analysis.graph_view import GraphView
    from pathway_tpu_torch.ops import knn as ops_knn

    monkeypatch.setattr(ops_knn, "deep_compile_profile",
                        lambda spec, mesh_axes=None: {"compiles": 1, "detail": {}, "unbucketed": ["query_width"]})
    diags = check_recompile_storm(GraphView(), [DeepTarget(name="knn.search[cos,d=2]", kind="knn", spec={})])
    assert len(diags) == 1 and diags[0].rule == "PWL018"
    assert "query_width" in diags[0].message and diags[0].detail["dimension"] == "query_width"
