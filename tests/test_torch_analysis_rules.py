"""The port's static verifier (``pathway_tpu_torch.analysis``, rules
PWL001–PWL016 and PWL021–PWL024) against the reference's, on the CPU.

Every case of the reference's ``tests/test_analysis_rules.py`` and
``tests/test_analysis_interactions.py`` builds the same program in both
packages (one builder, called with each package as ``pw``), describes the
same ``pw.run`` in analyze-only mode, and runs both verifiers. Compared
exactly: the diagnostics' rule ids, severities, messages, tables, ops,
call sites and ``detail`` dicts in their order, and ``render_json``'s
output with package names normalised. The reference test's own assertion
then runs on the port's diagnostics.

PWL004 reads torch where the reference reads JAX (ROADMAP Queue C,
"Deliberate differences"), so its cases pair a JAX program with its torch
counterpart and compare everything but the message.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.analysis import Diagnostic, Severity, render_json
from pathway_tpu_torch.internals.trace import Frame


@pytest.fixture(autouse=True)
def _fresh_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _rules(diags):
    return {d.rule for d in diags}


def _hits(diags, rule):
    return [d for d in diags if d.rule == rule]


def _norm(value):
    return json.loads(json.dumps(value, sort_keys=True).replace("pathway_tpu_torch", "pathway_tpu"))


def _payload(pw, diags, *, messages: bool = True):
    dicts = [d.as_dict() for d in diags]
    rendered = json.loads(pw.analysis.render_json(diags))
    if not messages:
        for d in dicts + rendered["diagnostics"]:
            d.pop("message")
    return _norm({"ordered": dicts, "json": rendered})


def _diagnose(pw, build, monkeypatch, tmp_path, **analyze_kw):
    pw.clear_graph()
    with monkeypatch.context() as mp:
        build(pw, mp, tmp_path)
        return pw.analysis.analyze(**analyze_kw)


def _both(build, monkeypatch, tmp_path, *, messages: bool = True, **analyze_kw):
    """The reference's and the port's diagnostics of one program, held equal."""
    want = _diagnose(jpw, build, monkeypatch, tmp_path, **analyze_kw)
    got = _diagnose(tpw, build, monkeypatch, tmp_path, **analyze_kw)
    assert _payload(tpw, got, messages=messages) == _payload(jpw, want, messages=messages)
    return got


# ------------------------------------------------------------ program parts


def _static(pw, md: str):
    return pw.debug.table_from_markdown(md)


def _stream(pw):
    return pw.demo.range_stream(nb_rows=5, input_rate=1000.0)


def _describe_run(pw, mp, **run_kwargs):
    """Record pw.run's configuration on the graph without executing it
    (the analyze-only path ``analyze`` uses)."""
    mp.setenv("PATHWAY_ANALYZE_ONLY", "1")
    assert pw.run(**run_kwargs) is None


def _null_sink(pw):
    t = _static(pw, """
        | x
      1 | 1
    """)
    pw.io.null.write(t.select(pw.this.x))


def _rest_endpoint(pw, serving=None):
    class RestQuerySchema(pw.Schema):
        value: int

    queries, writer = pw.io.http.rest_connector(
        host="127.0.0.1", port=0, schema=RestQuerySchema, delete_completed_queries=False, serving=serving,
    )
    writer(queries.select(result=pw.this.value * 2))


def _knn_sink(pw, reserved: int, dim: int = 384):
    docs = _static(pw, """
        | x
      1 | 1.0
      2 | 2.0
    """)
    docs = docs.select(emb=pw.apply_with_type(lambda x: (x, x), pw.ANY, docs.x))
    queries = _static(pw, """
        | x
      9 | 1.5
    """)
    queries = queries.select(emb=pw.apply_with_type(lambda x: (x, x), pw.ANY, queries.x))
    index = pw.stdlib.ml.index.KNNIndex(docs.emb, docs, n_dimensions=dim, reserved_space=reserved)
    pw.io.null.write(index.get_nearest_items(queries.emb, k=2))


def _streaming_knn_sink(pw):
    docs = _stream(pw)
    docs = docs.select(emb=pw.apply_with_type(lambda v: (float(v), 1.0), pw.ANY, docs.value))
    queries = _static(pw, """
        | x   | y
      9 | 1.0 | 1.0
    """)
    queries = queries.select(emb=pw.apply_with_type(lambda x, y: (x, y), pw.ANY, queries.x, queries.y))
    index = pw.stdlib.ml.index.KNNIndex(docs.emb, docs, n_dimensions=2, reserved_space=100)
    pw.io.null.write(index.get_nearest_items(queries.emb, k=2))


def _llm_rerank_sink(pw):
    """An HTTP chat endpoint on the rerank hop (LLMReranker records an
    ``llm_endpoints`` entry at expression build)."""

    class StubChat(pw.xpacks.llm.llms.BaseChat):
        def __init__(self):
            super().__init__()
            self.kwargs = {"model": "gpt-x"}

        def __wrapped__(self, messages, **kwargs) -> str:
            return "3"

        def _accepts_call_arg(self, arg_name: str) -> bool:
            return False

    pairs = _static(pw, """
        | doc | query
      1 | a   | q
      2 | b   | q
    """)
    reranker = pw.xpacks.llm.rerankers.LLMReranker(StubChat())
    pw.io.null.write(pairs.select(score=reranker(pairs.doc, pairs.query)))


def _stream_sink(pw, autocommit_ms: int = 1000):
    docs = pw.demo.range_stream(nb_rows=5, input_rate=1000.0, autocommit_duration_ms=autocommit_ms)
    pw.io.null.write(docs.select(doubled=pw.this.value * 2))


def _combined_budget(mp):
    """48 MiB: a 20k x 384 f32 index and the 256 x 16 KV pool each fit
    alone but jointly oversubscribe."""
    mp.setenv("PATHWAY_HBM_BYTES", str(48 * 1024 * 1024))


def _spec_draft_budget(mp):
    """96 MiB: the KV pool plus the nominal target weights fit; a 32 MiB
    draft is the straw."""
    mp.setenv("PATHWAY_HBM_BYTES", str(96 * 1024 * 1024))


# ------------------------------------------------------------------- cases

CASES: dict = {}


def case(check):
    """Register a builder ``(pw, mp, tmp_path)`` with the reference test's
    assertion on the port's diagnostics."""

    def deco(build):
        CASES[build.__name__] = (build, check)
        return build

    return deco


def _warns(rule, *words):
    def check(diags):
        hits = _hits(diags, rule)
        assert hits and hits[0].severity is Severity.WARNING
        for w in words:
            assert w in hits[0].message

    return check


def _absent(*rules):
    def check(diags):
        assert not _rules(diags) & set(rules)

    return check


def _present(*rules):
    def check(diags):
        assert set(rules) <= _rules(diags)

    return check


# PWL001
@case(lambda d: _hits(d, "PWL001")[0].severity is Severity.ERROR and "BOOL" in _hits(d, "PWL001")[0].message)
def pwl001_filter_predicate_not_bool(pw, mp, tmp):
    t = _static(pw, """
        | x
      1 | 1
    """)
    pw.io.null.write(t.filter(pw.this.x))


@case(lambda d: any(x.rule == "PWL001" and "'x'" in x.message for x in d))
def pwl001_concat_dtype_conflict(pw, mp, tmp):
    a = _static(pw, """
        | x
      1 | 1
    """)
    b = _static(pw, """
        | x
      1 | s
    """)
    pw.io.null.write(pw.Table.concat_reindex(a, b))


@case(_absent("PWL001"))
def pwl001_negative_clean_filter_and_concat(pw, mp, tmp):
    a = _static(pw, """
        | x
      1 | 1
    """)
    b = _static(pw, """
        | x
      1 | 2
    """)
    pw.io.null.write(pw.Table.concat_reindex(a, b).filter(pw.this.x > 0))


# PWL002
def _check_pwl002_groupby(d):
    hits = _hits(d, "PWL002")
    assert hits and hits[0].severity is Severity.ERROR
    assert hits[0].op_kind == "groupby_reduce" and hits[0].trace is not None


@case(_check_pwl002_groupby)
def pwl002_unbounded_streaming_groupby(pw, mp, tmp):
    pw.io.null.write(_stream(pw).groupby(pw.this.value).reduce(pw.this.value, n=pw.reducers.count()))


@case(_absent("PWL002"))
def pwl002_windowed_groupby_is_clean(pw, mp, tmp):
    win = _stream(pw).windowby(pw.this.value, window=pw.temporal.tumbling(duration=10)).reduce(
        n=pw.reducers.count())
    pw.io.null.write(win)


@case(_absent("PWL002"))
def pwl002_static_groupby_is_clean(pw, mp, tmp):
    t = _static(pw, """
        | k | v
      1 | a | 1
    """)
    pw.io.null.write(t.groupby(pw.this.k).reduce(pw.this.k, n=pw.reducers.count()))


@case(lambda d: _hits(d, "PWL002")[0].severity is Severity.WARNING)
def pwl002_streaming_join_warns_or_errors(pw, mp, tmp):
    s = _stream(pw)
    t = _static(pw, """
        | value | label
      1 | 1     | a
    """)
    pw.io.null.write(s.join(t, s.value == t.value).select(s.value, t.label))


# PWL003
@case(lambda d: any(x.rule == "PWL003" and "mutable state" in x.message for x in d))
def pwl003_mutable_capture(pw, mp, tmp):
    cache: dict = {}

    def slot(x: int) -> int:
        return cache.setdefault(x, len(cache))

    t = _static(pw, """
        | x
      1 | 1
    """)
    pw.io.null.write(t.select(k=pw.apply_with_type(slot, int, pw.this.x)))


@case(lambda d: any(x.rule == "PWL003" and "non-deterministic" in x.message for x in d))
def pwl003_nondeterministic_grouping_key(pw, mp, tmp):
    import random

    @pw.udf
    def bucket(x: int) -> int:
        return x + random.randint(0, 1)

    t = _static(pw, """
        | x | v
      1 | 1 | 2
    """)
    pw.io.null.write(t.groupby(bucket(pw.this.x)).reduce(total=pw.reducers.sum(pw.this.v)))


@case(lambda d: any(x.rule == "PWL003" and "commutative" in x.message for x in d))
def pwl003_noncommutative_reducer(pw, mp, tmp):
    t = _static(pw, """
        | k | v
      1 | a | 2
    """)
    pw.io.null.write(t.groupby(pw.this.k).reduce(first=pw.reducers.earliest(pw.this.v)))


@case(_absent("PWL003"))
def pwl003_negative_pure_udf_and_sum(pw, mp, tmp):
    @pw.udf(deterministic=True)
    def double(x: int) -> int:
        return 2 * x

    t = _static(pw, """
        | k | v
      1 | a | 2
    """)
    pw.io.null.write(t.groupby(double(pw.this.v)).reduce(total=pw.reducers.sum(pw.this.v)))


# PWL005, PWL006
def _check_pwl005_origin(d):
    hits = _hits(d, "PWL005")
    assert len(hits) == 1 and "'pet'" in hits[0].message and hits[0].op_kind == "static"


@case(_check_pwl005_origin)
def pwl005_dead_column_reported_at_origin(pw, mp, tmp):
    t = _static(pw, """
        | owner | pet | age
      1 | Alice | dog | 2
    """)
    pw.io.null.write(t.filter(pw.this.age >= 3).select(pw.this.owner))


@case(_absent("PWL005"))
def pwl005_negative_all_columns_used(pw, mp, tmp):
    t = _static(pw, """
        | owner | age
      1 | Alice | 2
    """)
    pw.io.null.write(t.filter(pw.this.age >= 3).select(pw.this.owner, pw.this.age))


@case(lambda d: any(x.rule == "PWL006" and x.severity is Severity.INFO for x in d))
def pwl006_unconnected_table(pw, mp, tmp):
    t = _static(pw, """
        | x
      1 | 1
    """)
    t.select(y=pw.this.x + 1)  # orphan: never consumed
    pw.io.null.write(t.select(pw.this.x))


@case(_absent("PWL006"))
def pwl006_negative_everything_connected(pw, mp, tmp):
    t = _static(pw, """
        | x
      1 | 1
    """)
    mid = t.select(y=pw.this.x + 1)
    pw.io.null.write(mid.filter(pw.this.y > 0))


# suppression
@case(_absent("PWL003"))
def suppress_context_manager(pw, mp, tmp):
    t = _static(pw, """
        | k | v
      1 | a | 2
    """)
    with pw.analysis.suppress("PWL003"):
        g = t.groupby(pw.this.k).reduce(first=pw.reducers.earliest(pw.this.v))
    pw.io.null.write(g)


# PWL007
@case(_warns("PWL007", "recovery"))
def pwl007_recovery_with_monitoring_off(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level="none")


@case(_present("PWL007"))
def pwl007_fires_on_bare_default_monitoring(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, recovery=pw.Recovery(max_restarts=2))


@case(_present("PWL007"))
def pwl007_enum_none_counts_as_off(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level=pw.MonitoringLevel.NONE)


@case(_absent("PWL007"))
def pwl007_negative_http_server_silences(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level="none", with_http_server=True)


@case(_absent("PWL007"))
def pwl007_negative_monitoring_configured(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level=pw.MonitoringLevel.IN_OUT)


@case(_absent("PWL007"))
def pwl007_negative_no_recovery(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="none")


@case(_absent("PWL007"))
def pwl007_negative_without_run_context(pw, mp, tmp):
    _null_sink(pw)


# PWL008
@case(_warns("PWL008", "overload"))
def pwl008_unprotected_endpoint_under_recovery(pw, mp, tmp):
    _rest_endpoint(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level="in_out")


@case(_present("PWL008"))
def pwl008_unprotected_endpoint_under_pipelining(pw, mp, tmp):
    _rest_endpoint(pw)
    _describe_run(pw, mp, pipeline_depth=2, monitoring_level="in_out")


@case(_absent("PWL008"))
def pwl008_negative_serving_config_silences(pw, mp, tmp):
    _rest_endpoint(pw, serving=pw.ServingConfig(max_queue=8))
    _describe_run(pw, mp, recovery=True, monitoring_level="in_out")


@case(_absent("PWL008"))
def pwl008_negative_no_pressure(pw, mp, tmp):
    _rest_endpoint(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL008"))
def pwl008_negative_no_endpoints(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level="in_out")


# PWL009
def _check_pwl009_world(world):
    def check(d):
        hits = _hits(d, "PWL009")
        assert hits and hits[0].severity is Severity.WARNING and hits[0].detail["world"] == world

    return check


@case(_check_pwl009_world(2))
def pwl009_multiworker_without_recovery(pw, mp, tmp):
    mp.setenv("PATHWAY_PROCESSES", "2")
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_check_pwl009_world(4))
def pwl009_threads_count_toward_world(pw, mp, tmp):
    mp.setenv("PATHWAY_THREADS", "4")
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


def _check_pwl009_lease(d):
    hits = _hits(d, "PWL009")
    assert len(hits) == 1 and "heartbeats disabled" in hits[0].message
    assert hits[0].detail["cluster_lease_ms"] == 0.0


@case(_check_pwl009_lease)
def pwl009_lease_zero_disables_heartbeats(pw, mp, tmp):
    mp.setenv("PATHWAY_PROCESSES", "2")
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level="in_out", cluster_lease_ms=0)


@case(lambda d: len(_hits(d, "PWL009")) == 2)
def pwl009_both_arms_fire_together(pw, mp, tmp):
    mp.setenv("PATHWAY_PROCESSES", "2")
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", cluster_lease_ms=0)


@case(_absent("PWL009"))
def pwl009_negative_single_worker(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", cluster_lease_ms=0)


@case(_absent("PWL009"))
def pwl009_negative_fault_domain_intact(pw, mp, tmp):
    mp.setenv("PATHWAY_PROCESSES", "2")
    _null_sink(pw)
    _describe_run(pw, mp, recovery=True, monitoring_level="in_out", cluster_lease_ms=2000)


@case(_absent("PWL009"))
def pwl009_negative_without_run_context(pw, mp, tmp):
    _null_sink(pw)


# PWL010
def _check_pwl010_no_mesh(d):
    hits = _hits(d, "PWL010")
    assert hits and hits[0].severity is Severity.WARNING and "mesh" in hits[0].message
    assert hits[0].detail["suggested_mesh"] == 2 and hits[0].detail["mesh_axes"] is None


@case(_check_pwl010_no_mesh)
def pwl010_index_over_hbm_without_mesh(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000_000)  # ~28.6 GiB resident against 16 GiB without a card
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL010"))
def pwl010_mesh_arg_silences(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000_000)
    _describe_run(pw, mp, monitoring_level="in_out", mesh=2)


@case(_absent("PWL010"))
def pwl010_pathway_mesh_env_silences(pw, mp, tmp):
    mp.setenv("PATHWAY_MESH", "4x2")
    _knn_sink(pw, reserved=20_000_000)
    _describe_run(pw, mp, monitoring_level="in_out")


def _check_pwl010_undersized(d):
    hits = _hits(d, "PWL010")
    assert hits and hits[0].detail["mesh_axes"] == {"data": 2, "model": 1}
    assert hits[0].detail["suggested_mesh"] >= 8


@case(_check_pwl010_undersized)
def pwl010_undersized_mesh_still_fires(pw, mp, tmp):
    _knn_sink(pw, reserved=80_000_000)
    _describe_run(pw, mp, monitoring_level="in_out", mesh=2)


@case(_present("PWL010"))
def pwl010_hbm_budget_env_override(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(64 * 1024 * 1024))
    _knn_sink(pw, reserved=200_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL010"))
def pwl010_negative_small_index(pw, mp, tmp):
    _knn_sink(pw, reserved=100_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL010"))
def pwl010_negative_host_index_invisible(pw, mp, tmp):
    docs = _static(pw, """
        | x
      1 | 1.0
    """)
    docs = docs.select(emb=pw.apply_with_type(lambda x: (x, x), pw.ANY, docs.x))
    queries = _static(pw, """
        | x
      9 | 1.5
    """)
    queries = queries.select(emb=pw.apply_with_type(lambda x: (x, x), pw.ANY, queries.x))
    idx = pw.stdlib.indexing.LshKnnFactory(dimensions=2, reserved_space=50_000_000).build_index(docs.emb, docs)
    pw.io.null.write(idx.query_as_of_now(queries.emb))
    _describe_run(pw, mp, monitoring_level="in_out")


# PWL011
def _check_pwl011(d):
    hits = _hits(d, "PWL011")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "ingest_workers" in hits[0].message
    assert hits[0].detail["pipeline_depth"] == 1 and hits[0].detail["ingest_workers"] == 0
    assert hits[0].detail["indexes"]


@case(_check_pwl011)
def pwl011_streaming_device_index_serial_ingest(pw, mp, tmp):
    _streaming_knn_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL011"))
def pwl011_ingest_workers_arg_silences(pw, mp, tmp):
    _streaming_knn_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", ingest_workers=2)


@case(_absent("PWL011"))
def pwl011_ingest_workers_env_silences(pw, mp, tmp):
    mp.setenv("PATHWAY_INGEST_WORKERS", "3")
    _streaming_knn_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL011"))
def pwl011_pipeline_depth_silences(pw, mp, tmp):
    _streaming_knn_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", pipeline_depth=2)


@case(_absent("PWL011"))
def pwl011_negative_static_source(pw, mp, tmp):
    _knn_sink(pw, reserved=100_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL011"))
def pwl011_negative_without_run_context(pw, mp, tmp):
    _streaming_knn_sink(pw)


# PWL012
def _check_pwl012(d):
    hits = _hits(d, "PWL012")
    assert hits and hits[0].severity is Severity.WARNING and "index_tiers" in hits[0].message
    detail = hits[0].detail
    assert detail["bytes"] > detail["hbm_budget_bytes"]
    split = detail["suggested_tier_split"]
    assert split["hot_rows"] + split["cold_rows"] == 20_000_000 and 0 < split["hot_rows"] < 20_000_000
    assert detail["quantized_cold_bytes"] == split["cold_rows"] * (384 + 4)
    assert "PWL010" in _rules(d)


@case(_check_pwl012)
def pwl012_beyond_hbm_without_cold_tier(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL012"))
def pwl012_index_tiers_arg_silences(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000_000)
    _describe_run(pw, mp, monitoring_level="in_out", index_tiers="hot=40000")


@case(_absent("PWL012"))
def pwl012_env_knob_silences(pw, mp, tmp):
    mp.setenv("PATHWAY_INDEX_TIERS", "auto")
    _knn_sink(pw, reserved=20_000_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL010", "PWL012"))
def pwl012_tier_config_silences_pwl010_too(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000_000)
    _describe_run(pw, mp, monitoring_level="in_out", index_tiers="auto")


def _check_pwl012_mesh(d):
    hits = _hits(d, "PWL012")
    assert hits and hits[0].detail["mesh_axes"] == {"data": 2, "model": 1}
    assert hits[0].detail["per_device_bytes"] > hits[0].detail["hbm_budget_bytes"]


@case(_check_pwl012_mesh)
def pwl012_fires_with_undersized_mesh(pw, mp, tmp):
    _knn_sink(pw, reserved=80_000_000)
    _describe_run(pw, mp, monitoring_level="in_out", mesh=2)


@case(_absent("PWL012"))
def pwl012_negative_fits_hbm(pw, mp, tmp):
    _knn_sink(pw, reserved=100_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_present("PWL012"))
def pwl012_hbm_budget_env_override(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(64 * 1024 * 1024))
    _knn_sink(pw, reserved=200_000)
    _describe_run(pw, mp, monitoring_level="in_out")


# PWL013
def _check_pwl013(d):
    hits = _hits(d, "PWL013")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "llm_reranker" in hits[0].message
    assert hits[0].detail["llm_endpoints"][0]["model"] == "gpt-x" and hits[0].detail["decode"]["pages"] == 64


@case(_check_pwl013)
def pwl013_http_llm_with_decode_plane(pw, mp, tmp):
    _llm_rerank_sink(pw)
    _describe_run(pw, mp, decode="pages=64,page=16")


@case(_present("PWL013"))
def pwl013_env_knob_counts_as_decode(pw, mp, tmp):
    mp.setenv("PATHWAY_DECODE", "auto")
    _llm_rerank_sink(pw)
    _describe_run(pw, mp)


@case(_absent("PWL013"))
def pwl013_negative_no_decode_plane(pw, mp, tmp):
    mp.delenv("PATHWAY_DECODE", raising=False)
    _llm_rerank_sink(pw)
    _describe_run(pw, mp)


@case(_absent("PWL013"))
def pwl013_negative_decode_off_spec(pw, mp, tmp):
    _llm_rerank_sink(pw)
    _describe_run(pw, mp, decode="off")


@case(_absent("PWL013"))
def pwl013_negative_device_reranker_does_not_record(pw, mp, tmp):
    pairs = _static(pw, """
        | doc | query
      1 | a   | q
    """)
    if pw is tpw:  # the port's scorer takes the CPU only when asked; a tiny one keeps the case fast
        cfg = tpw.EncoderConfig.cross_encoder_l6(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2,
                                                 intermediate_size=64, max_position=64)
        reranker = pw.xpacks.llm.rerankers.CrossEncoderReranker(device="cpu", config=cfg)
    else:
        reranker = pw.xpacks.llm.rerankers.CrossEncoderReranker()
    pw.io.null.write(pairs.select(score=reranker(pairs.doc, pairs.query)))
    _describe_run(pw, mp, decode=True)


# PWL014
def _check_pwl014(d):
    hits = _hits(d, "PWL014")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "deadline" in hits[0].message
    assert hits[0].detail["endpoints"][0]["deadline_ms"] == 250.0 and hits[0].detail["tracing"] is False


@case(_check_pwl014)
def pwl014_slo_budget_without_observability(pw, mp, tmp):
    mp.delenv("PATHWAY_TRACING", raising=False)
    mp.delenv("PATHWAY_PROFILE", raising=False)
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL014"))
def pwl014_tracing_arg_silences(pw, mp, tmp):
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))
    _describe_run(pw, mp, monitoring_level="in_out", tracing=True)


@case(_absent("PWL014"))
def pwl014_tracing_env_silences(pw, mp, tmp):
    mp.setenv("PATHWAY_TRACING", "1")
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL014"))
def pwl014_profiler_silences(pw, mp, tmp):
    mp.delenv("PATHWAY_TRACING", raising=False)
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))
    _describe_run(pw, mp, monitoring_level="in_out", profile="prof.json")


@case(_absent("PWL014"))
def pwl014_negative_no_deadline_budget(pw, mp, tmp):
    mp.delenv("PATHWAY_TRACING", raising=False)
    mp.delenv("PATHWAY_PROFILE", raising=False)
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=None))
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL014"))
def pwl014_negative_without_run_context(pw, mp, tmp):
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))


# PWL021
def _check_pwl021_deadline(d):
    hits = _hits(d, "PWL021")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING
    assert "chip-time accounting is off" in hits[0].message
    assert hits[0].detail["endpoints"][0]["deadline_ms"] == 250.0 and hits[0].detail["chip_ledger"] is False
    assert "PWL014" not in _rules(d)


@case(_check_pwl021_deadline)
def pwl021_deadline_budget_without_chip_accounting(pw, mp, tmp):
    mp.delenv("PATHWAY_CHIP_LEDGER", raising=False)
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))
    _describe_run(pw, mp, monitoring_level="in_out", tracing=True)


def _check_pwl021_watchdog(d):
    hits = _hits(d, "PWL021")
    assert len(hits) == 1 and hits[0].detail["watchdog"] is True and "watchdog is on" in hits[0].message


@case(_check_pwl021_watchdog)
def pwl021_watchdog_without_chip_accounting(pw, mp, tmp):
    mp.delenv("PATHWAY_CHIP_LEDGER", raising=False)
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", watchdog=True)


@case(_absent("PWL021"))
def pwl021_chip_ledger_arg_silences(pw, mp, tmp):
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))
    _describe_run(pw, mp, monitoring_level="in_out", tracing=True, chip_ledger=True)


@case(_absent("PWL021"))
def pwl021_chip_ledger_env_silences(pw, mp, tmp):
    mp.setenv("PATHWAY_CHIP_LEDGER", "1")
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", watchdog=True)


@case(_absent("PWL021"))
def pwl021_negative_no_contract(pw, mp, tmp):
    mp.delenv("PATHWAY_CHIP_LEDGER", raising=False)
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=None))
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL021"))
def pwl021_negative_without_run_context(pw, mp, tmp):
    _rest_endpoint(pw, serving=pw.ServingConfig(default_deadline_ms=250.0))


# PWL022
def _check_pwl022(word, key, value):
    def check(d):
        hits = _hits(d, "PWL022")
        assert len(hits) == 1 and hits[0].severity is Severity.WARNING and word in hits[0].message
        got = hits[0].detail
        for part in key:
            got = got[part]
        assert got == value

    return check


@case(_check_pwl022("watermarks are armed", ("elastic", "hbm_frac"), 0.85))
def pwl022_watermarks_without_persistence(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", elastic={"auto": True, "hbm_frac": 0.85})


@case(_check_pwl022('mesh="auto"', ("mesh_auto",), True))
def pwl022_mesh_auto_without_persistence(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", mesh="auto")


@case(_check_pwl022("shards=4", ("persistence",), False))
def pwl022_fixed_target_without_persistence(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", elastic=4)


@case(_absent("PWL022"))
def pwl022_persistence_silences(pw, mp, tmp):
    _null_sink(pw)
    backend = pw.persistence.Backend.filesystem(str(tmp / pw.__name__))
    _describe_run(pw, mp, monitoring_level="in_out", elastic={"auto": True, "hbm_frac": 0.85},
                  persistence_config=pw.persistence.Config.simple_config(backend))


@case(_absent("PWL022"))
def pwl022_negative_no_elastic_plane(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL022"))
def pwl022_negative_without_run_context(pw, mp, tmp):
    _null_sink(pw)


# PWL015
def _check_pwl015(d):
    hits = _hits(d, "PWL015")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING
    fp, budget = hits[0].detail["footprint"], hits[0].detail["hbm_budget_bytes"]
    assert fp["index"] <= budget and fp["decode_kv"] <= budget < fp["total"]
    assert not _rules(d) & {"PWL010", "PWL012"}


@case(_check_pwl015)
def pwl015_combined_planes_oversubscribe(pw, mp, tmp):
    _combined_budget(mp)
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16")


@case(_absent("PWL015"))
def pwl015_negative_fits_together(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(256 * 1024 * 1024))
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16")


@case(_absent("PWL015"))
def pwl015_negative_without_decode_plane(pw, mp, tmp):
    _combined_budget(mp)
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(lambda d: "PWL015" not in _rules(d) and "PWL010" in _rules(d))
def pwl015_negative_index_alone_over_budget(pw, mp, tmp):
    _combined_budget(mp)
    _knn_sink(pw, reserved=200_000)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16")


@case(_absent("PWL015"))
def pwl015_mesh_sharding_silences(pw, mp, tmp):
    _combined_budget(mp)
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", mesh=4, decode="pages=256,page=16")


@case(_absent("PWL015"))
def pwl015_index_tiers_silence(pw, mp, tmp):
    _combined_budget(mp)
    mp.setenv("PATHWAY_INDEX_TIERS", "auto")
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16")


@case(_absent("PWL015"))
def pwl015_negative_without_run_context(pw, mp, tmp):
    _combined_budget(mp)
    _knn_sink(pw, reserved=20_000)


# PWL016
def _check_pwl016(d):
    hits = _hits(d, "PWL016")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "quota" in hits[0].message
    assert hits[0].detail["tenancy"]["quotas"] == {}


@case(_check_pwl016)
def pwl016_tenancy_without_quotas(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", tenancy=True)


@case(_present("PWL016"))
def pwl016_env_knob_counts_as_tenancy(pw, mp, tmp):
    mp.setenv("PATHWAY_TENANCY", "on")
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL016"))
def pwl016_default_quota_silences(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", tenancy="qps=50,inflight=8")


@case(_absent("PWL016"))
def pwl016_named_quotas_silence(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", tenancy={"quotas": {"acme": {"qps": 100, "hbm": "1M"}}})


def _check_pwl016_oversubscribed(d):
    hits = _hits(d, "PWL016")
    assert len(hits) == 1 and hits[0].detail["total_bytes"] == 3 * 2 * 1024 * 1024
    assert hits[0].detail["total_bytes"] > hits[0].detail["hbm_budget_bytes"]


@case(_check_pwl016_oversubscribed)
def pwl016_quota_hbm_oversubscription(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(4 * 1024 * 1024))
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", tenancy={"quotas": {t: {"hbm": "2M"} for t in "abc"}})


@case(_absent("PWL016"))
def pwl016_quota_hbm_fits(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(64 * 1024 * 1024))
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", tenancy={"quotas": {t: {"hbm": "2M"} for t in "abc"}})


@case(_absent("PWL016"))
def pwl016_negative_tenancy_off(pw, mp, tmp):
    mp.delenv("PATHWAY_TENANCY", raising=False)
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out")


@case(_absent("PWL016"))
def pwl016_negative_without_run_context(pw, mp, tmp):
    _null_sink(pw)


# PWL023
def _check_pwl023_tenants(d):
    hits = _hits(d, "PWL023")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING
    assert "multi-tenant" in hits[0].message and "prefix caching off" in hits[0].message
    assert hits[0].detail["tenancy"] is True and hits[0].detail["prefix_cache"] is False


@case(_check_pwl023_tenants)
def pwl023_multi_tenant_without_prefix_cache(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=64,page=16", tenancy="qps=50,inflight=8")


def _check_pwl023_rag(d):
    hits = _hits(d, "PWL023")
    assert len(hits) == 1 and "RAG" in hits[0].message and hits[0].detail["rag_indexes"][0]["device_backed"]


@case(_check_pwl023_rag)
def pwl023_rag_traffic_without_prefix_cache(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=64,page=16")


@case(_absent("PWL023"))
def pwl023_prefix_cache_on_silences(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=64,page=16,cache=1", tenancy="qps=50")


@case(_absent("PWL023"))
def pwl023_negative_single_tenant_no_rag(pw, mp, tmp):
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=64,page=16")


@case(_absent("PWL023"))
def pwl023_negative_no_decode_plane(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000)
    _describe_run(pw, mp, monitoring_level="in_out", tenancy="qps=50")


def _check_pwl023_draft(d):
    hits = _hits(d, "PWL023")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "straw" in hits[0].message
    detail = hits[0].detail
    assert detail["draft_weights_bytes"] == 32 * 1024 * 1024
    assert detail["kv_pool_bytes"] + detail["target_weights_bytes"] <= detail["hbm_budget_bytes"]
    assert detail["total_bytes"] > detail["hbm_budget_bytes"]


@case(_check_pwl023_draft)
def pwl023_draft_weights_overflow_hbm(pw, mp, tmp):
    _spec_draft_budget(mp)
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16,cache=1,spec=4,draft_weights=32M")


@case(lambda d: len(_hits(d, "PWL023")) == 2)
def pwl023_both_arms_fire_together(pw, mp, tmp):
    _spec_draft_budget(mp)
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16,spec=4,draft_weights=32M",
                  tenancy="qps=50")


@case(_absent("PWL023"))
def pwl023_negative_draft_fits_budget(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(256 * 1024 * 1024))
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16,cache=1,spec=4,draft_weights=32M")


@case(_absent("PWL023"))
def pwl023_negative_self_draft_books_no_weights(pw, mp, tmp):
    _spec_draft_budget(mp)
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16,cache=1,spec=4,draft=1")


@case(_absent("PWL023"))
def pwl023_negative_base_already_over_budget(pw, mp, tmp):
    mp.setenv("PATHWAY_HBM_BYTES", str(48 * 1024 * 1024))
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", decode="pages=256,page=16,cache=1,spec=4,draft_weights=32M")


@case(_absent("PWL023"))
def pwl023_negative_without_run_context(pw, mp, tmp):
    _knn_sink(pw, reserved=20_000)


# PWL024
def _check_pwl024_plane_off(d):
    hits = _hits(d, "PWL024")
    assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "never" in hits[0].message
    assert hits[0].detail["watchdog_freshness"] is True and hits[0].detail["freshness"] is None


@case(_check_pwl024_plane_off)
def pwl024_watchdog_freshness_keys_with_plane_off(pw, mp, tmp):
    mp.delenv("PATHWAY_FRESHNESS", raising=False)
    _stream_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out",
                  watchdog="interval=1,freshness_warn=0.8,freshness_critical=1.0", chip_ledger=True)


def _check_pwl024_floor(slo, floor, autocommit, window):
    def check(d):
        hits = _hits(d, "PWL024")
        assert len(hits) == 1 and hits[0].severity is Severity.WARNING and "floor" in hits[0].message
        detail = hits[0].detail
        assert (detail["slo_ms"], detail["floor_ms"], detail["autocommit_duration_ms"]) == (slo, floor, autocommit)
        assert detail["batch_window_ms"] == window

    return check


@case(_check_pwl024_floor(100.0, 500.0, 500.0, 0.0))
def pwl024_slo_tighter_than_autocommit_floor(pw, mp, tmp):
    _stream_sink(pw, autocommit_ms=500)
    _describe_run(pw, mp, monitoring_level="in_out", freshness="slo=100ms")


@case(_check_pwl024_floor(60.0, 80.0, 50.0, 30.0))
def pwl024_batcher_linger_folds_into_floor(pw, mp, tmp):
    _rest_endpoint(pw, serving=pw.ServingConfig(batch_window_ms=30.0))
    _describe_run(pw, mp, monitoring_level="in_out", freshness="slo=60ms")


@case(_absent("PWL024"))
def pwl024_freshness_env_silences(pw, mp, tmp):
    mp.setenv("PATHWAY_FRESHNESS", "1")
    _stream_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", watchdog="interval=1,freshness_critical=1.0", chip_ledger=True)


@case(_absent("PWL024"))
def pwl024_negative_slo_clears_floor(pw, mp, tmp):
    _stream_sink(pw, autocommit_ms=500)
    _describe_run(pw, mp, monitoring_level="in_out", freshness="slo=2000ms")


@case(_absent("PWL024"))
def pwl024_negative_plane_on_without_slo(pw, mp, tmp):
    _stream_sink(pw, autocommit_ms=500)
    _describe_run(pw, mp, monitoring_level="in_out", watchdog="interval=1,freshness_critical=1.0",
                  chip_ledger=True, freshness=True)


@case(_absent("PWL024"))
def pwl024_negative_bounded_run(pw, mp, tmp):
    mp.delenv("PATHWAY_FRESHNESS", raising=False)
    _null_sink(pw)
    _describe_run(pw, mp, monitoring_level="in_out", watchdog="interval=1,freshness_critical=1.0", chip_ledger=True)


@case(_absent("PWL024"))
def pwl024_negative_without_run_context(pw, mp, tmp):
    _stream_sink(pw)


@pytest.mark.parametrize("name", list(CASES))
def test_rule_case_matches_the_reference(name, monkeypatch, tmp_path):
    """One case of the reference's rule tests: both packages' diagnostics
    equal, and the reference test's assertion holds on the port's."""
    build, check = CASES[name]
    got = _both(build, monkeypatch, tmp_path)
    assert check(got) is not False


# ------------------------------------------------------------ PWL004 (torch)


def _batched(pw):
    return pw.udf(executor=pw.udfs.BatchExecutor(max_batch_size=8))


def _pwl004_numpy_and_side_effect(pw, mp, tmp):
    if pw is jpw:
        @_batched(pw)
        def embed(xs: list[float]) -> list[float]:
            arr = np.asarray(xs)  # host numpy on traced values
            out = jnp.tanh(arr)
            print("batch", len(xs))  # side effect under jit
            return list(np.asarray(out))
    else:
        @_batched(pw)
        def embed(xs: list[float]) -> list[float]:
            out = torch.tanh(torch.tensor(xs))
            print("batch", len(xs))  # a side effect once per batch
            return list(out.numpy())  # host numpy on a torch tensor

    t = _static(pw, """
        | x
      1 | 1.0
    """)
    pw.io.null.write(t.select(y=embed(pw.this.x)))


def _pwl004_pure_batch(pw, mp, tmp):
    if pw is jpw:
        @_batched(pw)
        def embed(xs: list[float]) -> list[float]:
            return [float(v) for v in jnp.tanh(jnp.asarray(xs))]
    else:
        @_batched(pw)
        def embed(xs: list[float]) -> list[float]:
            return [float(v) for v in torch.tanh(torch.as_tensor(xs))]

    t = _static(pw, """
        | x
      1 | 1.0
    """)
    pw.io.null.write(t.select(y=embed(pw.this.x)))


def _trace_value(pw):
    """A value whose trace has ended: a leaked JAX tracer for the reference,
    a ``FakeTensor`` of a finished ``FakeTensorMode`` for the port."""
    if pw is jpw:
        leaked = []
        jax.make_jaxpr(lambda x: leaked.append(x) or x)(1.0)
        return leaked[0]
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode().from_tensor(torch.zeros(2))


def _pwl004_closed_over_trace_value(pw, mp, tmp):
    stale = _trace_value(pw)

    @_batched(pw)
    def scale(xs: list[float]) -> list[float]:
        return [x * float(stale is not None) for x in xs]

    t = _static(pw, """
        | x
      1 | 1.0
    """)
    pw.io.null.write(t.select(y=scale(pw.this.x)))


def _check_pwl004_numpy(d):
    hits = _hits(d, "PWL004")
    assert any("numpy" in x.message for x in hits) and any("print" in x.message for x in hits)


def _check_pwl004_capture(d):
    (hit,) = _hits(d, "PWL004")
    assert hit.severity is Severity.ERROR and hit.detail == {"param": "exprs.y", "capture": "stale"}
    assert "FakeTensor" in hit.message


@pytest.mark.parametrize(
    "build,check",
    [(_pwl004_numpy_and_side_effect, _check_pwl004_numpy), (_pwl004_pure_batch, _absent("PWL004")),
     (_pwl004_closed_over_trace_value, _check_pwl004_capture)],
    ids=["numpy_and_side_effect_in_batched_udf", "negative_pure_batch", "closed_over_trace_value"],
)
def test_pwl004_torch_counterpart_matches_the_reference(build, check, monkeypatch, tmp_path):
    """A batched UDF applying host numpy to torch tensors (the reference:
    numpy on values traced under jit), one with a ``print``, a pure torch
    batch, and one closing over a trace value (the reference: a JAX
    tracer; the port: a ``FakeTensor``): the same findings, ids,
    severities and details; the messages speak of torch."""
    got = _both(build, monkeypatch, tmp_path, messages=False)
    check(got)


def test_rule_table_matches_the_reference():
    """The rule ids, severities and order; titles only where the
    mechanism changes (PWL004, PWL018)."""
    from pathway_tpu.analysis import rules as jrules
    from pathway_tpu_torch.analysis import rules as trules

    assert list(trules.RULES) == list(jrules.RULES)
    assert trules.DEEP_RULE_IDS == jrules.DEEP_RULE_IDS
    for rule, (sev, title) in jrules.RULES.items():
        tsev, ttitle = trules.RULES[rule]
        assert tsev.value == sev.value
        assert ttitle == title or rule in ("PWL004", "PWL018"), rule
    assert [f.__name__ for f in trules.LOGICAL_RULES] == [
        "check_batched_udf_purity" if f.__name__ == "check_jax_udf_purity" else f.__name__
        for f in jrules.LOGICAL_RULES
    ]


# ------------------------------------------------- suppression and run gate


def test_suppress_direct_and_unknown_rule(monkeypatch, tmp_path):
    def build(pw, mp, tmp):
        t = _static(pw, """
            | k | v
          1 | a | 2
        """)
        g = t.groupby(pw.this.k).reduce(first=pw.reducers.earliest(pw.this.v))
        pw.analysis.suppress("pwl003", g)  # case-insensitive
        pw.io.null.write(g)

    assert "PWL003" not in _rules(_both(build, monkeypatch, tmp_path))
    for pw in (jpw, tpw):
        with pytest.raises(ValueError):
            pw.analysis.suppress("PWL999")
        with pytest.raises(ValueError):
            pw.analysis.suppress()


def test_run_analysis_strict_raises_before_running():
    for pw in (jpw, tpw):
        pw.clear_graph()
        pw.io.null.write(_stream(pw).groupby(pw.this.value).reduce(n=pw.reducers.count()))
        with pytest.raises(pw.analysis.AnalysisError) as exc:
            pw.run(analysis="strict")
        assert [d.rule for d in exc.value.diagnostics if d.rule == "PWL002"]
    assert str(exc.value).splitlines()[0] == "analysis found 1 error(s) — not starting the run"


@pytest.mark.parametrize("source", ["argument", "environment"])
def test_run_analysis_warn_prints_and_continues(source, capsys, monkeypatch):
    """``analysis="warn"`` (or ``PATHWAY_ANALYSIS=warn``) prints the
    findings to stderr and runs; the port prints the reference's text."""
    errs = []
    for pw in (jpw, tpw):
        pw.clear_graph()
        t = _static(pw, """
            | x
          1 | 1
        """)
        seen = []
        pw.io.subscribe(t.select(pw.this.x), lambda key, row, time, is_addition: seen.append(row["x"]))
        t.select(dead=pw.this.x)  # orphan -> PWL006 info, not an error
        if source == "argument":
            pw.run(analysis="warn", monitoring_level=pw.MonitoringLevel.NONE)
        else:
            with monkeypatch.context() as mp:
                mp.setenv("PATHWAY_ANALYSIS", "warn")
                pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        assert seen == [1]
        errs.append(capsys.readouterr().err)
    assert "PWL006" in errs[1]
    analysis_lines = lambda err: [ln for ln in err.splitlines() if ln.startswith(("PWL", "analysis:"))]  # noqa: E731
    assert analysis_lines(errs[1]) == analysis_lines(errs[0])


@pytest.mark.parametrize("mode", ["pedantic", "strictest"])
def test_run_analysis_rejects_unknown_mode(mode):
    for pw in (jpw, tpw):
        with pytest.raises(ValueError, match=mode):
            pw.run(analysis=mode)


def test_run_analysis_deep_runs_a_clean_graph():
    """``analysis="deep"`` over a graph with nothing to find runs it."""
    pw = tpw
    t = _static(pw, """
        | x
      1 | 1
    """)
    seen = []
    pw.io.subscribe(t.select(y=pw.this.x + 1), lambda key, row, time, is_addition: seen.append(row["y"]))
    pw.run(analysis="deep")
    assert seen == [2]


# ------------------------------------------------------ engine-level rules


def test_analyze_engine_flags_uncaptured_node():
    payloads = []
    for pw in (jpw, tpw):
        pw.clear_graph()
        runner_mod = __import__(f"{pw.__name__}.internals.graph_runner", fromlist=["GraphRunner"])
        t = _static(pw, """
            | x
          1 | 1
        """)
        orphan = t.select(y=pw.this.x + 1)
        out = t.select(pw.this.x)
        runner = runner_mod.GraphRunner(n_workers=1)
        runner.lower(orphan)
        runner.capture(out)  # wired to a sink; the orphan is not
        diags = pw.analysis.analyze(engine=runner.engine)
        hits = [d for d in diags if d.rule == "PWL006" and "engine node" in d.message]
        assert hits and all("Select" in d.message for d in hits)
        payloads.append(sorted((d.severity.value, d.op_kind) for d in hits))
    assert payloads[0] == payloads[1]


def test_engine_error_carries_node_identity_and_trace():
    from pathway_tpu_torch.engine.dataflow import EngineError

    frame = Frame(filename="pipe.py", line_number=7, line="x = y.z", function="<module>")

    class FakeNode:
        name = "groupby_reduce"
        id = 42
        user_frame = frame

    err = EngineError("boom", node=FakeNode())
    assert (err.node_name, err.node_id, err.trace) == ("groupby_reduce", 42, frame)


# ------------------------------------------------------------ golden output


def test_json_output_is_stable():
    """The --json wire format, pinned, and byte-equal to the reference's."""
    from pathway_tpu.analysis import Diagnostic as JDiagnostic
    from pathway_tpu.analysis import Severity as JSeverity
    from pathway_tpu.analysis import render_human as jrender_human
    from pathway_tpu.analysis import render_json as jrender_json
    from pathway_tpu.internals.trace import Frame as JFrame
    from pathway_tpu_torch.analysis import render_human

    def diags(D, S, F):
        frame = F(filename="pipe.py", line_number=12, line="bad = s.groupby(...)", function="<module>")
        return [
            D(rule="PWL002", severity=S.ERROR, message="unbounded state", table="s.reduce", table_id=3,
              op_kind="groupby_reduce", trace=frame, detail={"_table": object(), "n": (1, 2), "obj": object()}),
            D(rule="PWL005", severity=S.INFO, message="dead column", table="t", table_id=1, op_kind="static"),
        ]

    got = diags(Diagnostic, Severity, Frame)
    want = diags(JDiagnostic, JSeverity, JFrame)
    assert render_json(got, suppressed=2) == jrender_json(want, suppressed=2)
    assert render_human(got) == jrender_human(want)
    assert json.loads(render_json(got)) == {
        "diagnostics": [
            {"detail": {"n": [1, 2], "obj": "object"},
             "location": {"file": "pipe.py", "function": "<module>", "line": 12},
             "message": "unbounded state", "op": "groupby_reduce", "rule": "PWL002", "severity": "error",
             "table": "s.reduce"},
            {"message": "dead column", "op": "static", "rule": "PWL005", "severity": "info", "table": "t"},
        ],
        "summary": {"error": 1, "info": 1, "suppressed": 0, "warning": 0},
    }


# ------------------------------------------- the HBM family's interactions


def _index_graph(pw, reserved: int = 20_000_000, dim: int = 384):
    docs = pw.debug.table_from_markdown("""
        | x   | y
      1 | 1.0 | 0.0
    """)
    docs = docs.select(emb=pw.apply_with_type(lambda x, y: (x, y), pw.ANY, docs.x, docs.y))
    index = pw.stdlib.ml.index.KNNIndex(docs.emb, docs, n_dimensions=dim, reserved_space=reserved,
                                        distance_type="cosine")
    pw.io.null.write(index.get_nearest_items(docs.emb, k=3))


def _family(pw, context, reserved=20_000_000, dim=384):
    """The four HBM-family rules over one index graph and run context."""
    rules = __import__(f"{pw.__name__}.analysis.rules", fromlist=["RULES"])
    pw.clear_graph()
    _index_graph(pw, reserved, dim)
    from importlib import import_module

    G = import_module(f"{pw.__name__}.internals.parse_graph").G
    if context is not None:
        G.run_context = context
    view = pw.analysis.GraphView(G)
    return {name: getattr(rules, name)(view) for name in (
        "check_index_hbm_budget", "check_index_tier_budget", "check_combined_hbm_oversubscription",
        "check_tenancy_without_quotas")}, G


def _family_both(context, **kw):
    want, _ = _family(jpw, context, **kw)
    got, G = _family(tpw, context, **kw)
    assert _norm({k: [d.as_dict() for d in v] for k, v in got.items()}) == _norm(
        {k: [d.as_dict() for d in v] for k, v in want.items()})
    return got, G


def test_pwl010_and_pwl012_agree_on_footprint():
    got, _ = _family_both(None)
    (d10,), (d12,) = got["check_index_hbm_budget"], got["check_index_tier_budget"]
    for key in ("bytes", "per_device_bytes", "hbm_budget_bytes"):
        assert d10.detail[key] == d12.detail[key]
    assert d10.detail["index"] is d12.detail["index"]


def test_run_tiers_silence_both_hbm_rules():
    got, _ = _family_both({"mesh_axes": None, "index_tiers": {"hot_rows": 10_000}})
    assert not any(got[k] for k in ("check_index_hbm_budget", "check_index_tier_budget",
                                    "check_combined_hbm_oversubscription"))


def test_pwl015_owns_the_each_fits_alone_window(monkeypatch):
    monkeypatch.setenv("PATHWAY_HBM_BYTES", str(48 * 1024 * 1024))
    got, G = _family_both({"mesh_axes": None, "decode": {"pages": 256, "page_size": 16}}, reserved=20_000)
    assert not got["check_index_hbm_budget"] and not got["check_index_tier_budget"]
    (d15,) = got["check_combined_hbm_oversubscription"]
    fp = d15.detail["footprint"]
    from pathway_tpu_torch.analysis.rules import _index_hbm_bytes

    (spec,) = [s for s in G.external_indexes if s.get("device_backed")]
    assert fp["index"] == _index_hbm_bytes(spec) and fp["total"] == fp["index"] + fp["decode_kv"]
    assert d15.detail["hbm_budget_bytes"] == 48 * 1024 * 1024
    assert fp["index"] <= d15.detail["hbm_budget_bytes"] and fp["decode_kv"] <= d15.detail["hbm_budget_bytes"]


def test_mesh_sharding_scales_every_rules_per_device_term():
    got, _ = _family_both({"mesh_axes": {"data": 2, "model": 1}}, reserved=40_000_000)
    (d10,), (d12,) = got["check_index_hbm_budget"], got["check_index_tier_budget"]
    assert d10.detail["per_device_bytes"] == d10.detail["bytes"] // 2 == d12.detail["per_device_bytes"]
    assert d10.detail["mesh_axes"] == {"data": 2, "model": 1}


def test_pwl016_prices_quotas_against_the_shared_budget(monkeypatch):
    monkeypatch.setenv("PATHWAY_HBM_BYTES", str(64 * 1024 * 1024))
    quotas = {"acme": {"hbm_bytes": 40 * 1024 * 1024}, "globex": {"hbm_bytes": 40 * 1024 * 1024}}
    got, G = _family_both({"mesh_axes": None, "tenancy": {"quotas": quotas}}, reserved=20_000)
    (d16,) = got["check_tenancy_without_quotas"]
    assert d16.detail["hbm_budget_bytes"] == 64 * 1024 * 1024 and d16.detail["total_bytes"] == 80 * 1024 * 1024
    assert not got["check_index_hbm_budget"]
    quotas["globex"]["hbm_bytes"] = 16 * 1024 * 1024
    from pathway_tpu_torch.analysis.rules import check_tenancy_without_quotas

    assert check_tenancy_without_quotas(tpw.analysis.GraphView(G)) == []


def test_composed_hazard_fires_exactly_one_rule_per_window(monkeypatch):
    monkeypatch.setenv("PATHWAY_HBM_BYTES", str(64 * 1024 * 1024))
    got, _ = _family_both({
        "mesh_axes": {"data": 2, "model": 1},
        "index_tiers": {"hot_rows": 10_000},
        "decode": {"pages": 64, "page_size": 16},
        "tenancy": {"quotas": {"acme": {"hbm_bytes": 40 * 1024 * 1024}, "globex": {"hbm_bytes": 40 * 1024 * 1024}}},
    }, reserved=20_000)
    assert [d.rule for v in got.values() for d in v] == ["PWL016"]
