"""The port's verifier over the shipped demo programs, the RAG template
and the reference's fixture programs, against the reference's, on the CPU
(the analysis cases of the reference's ``tests/test_self_lint.py`` and the
composed-planes case of ``tests/test_analysis_interactions.py``).

Each fixture runs through ``analysis.program.analyze_program``
in-process in both packages (the reference's file, and the port's copy in
``tmp_path`` with ``pathway_tpu`` renamed): exit codes equal, the human
output's findings and summary line equal, the JSON equal with file paths
and package names normalised; then the reference test's own assertion on
the port's output. One subprocess drives ``python -m pathway_tpu_torch
analyze`` end to end and holds its exit codes and JSON to the reference's
click command.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from click.testing import CliRunner

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.cli import cli as jcli
from pathway_tpu_torch.analysis.program import analyze_program as tanalyze

from .test_torch_analysis_deep import FIXTURES, REPO, analyze, both, norm_json, port_fixture


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    for var in ("PATHWAY_COMPILE_BUDGET", "PATHWAY_PROCESSES", "PATHWAY_HBM_BYTES"):
        monkeypatch.delenv(var, raising=False)
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _fake_embedding(x: str) -> np.ndarray:
    """``tests/mocks.fake_embeddings_model``'s function: an 8-dim embedding
    from a text hash."""
    v = np.frombuffer(hashlib.sha256((x or "").encode()).digest()[:32], dtype=np.uint32).astype(np.float32)
    return v / np.linalg.norm(v)


def _demos():
    from pathway_tpu.debug.demos import demo_programs as jdemos
    from pathway_tpu_torch.debug.demos import demo_programs

    assert [os.path.basename(p) for p in demo_programs()] == [os.path.basename(p) for p in jdemos()]
    return list(zip(demo_programs(), jdemos()))


@pytest.mark.parametrize("demo,ref_demo", _demos(), ids=[os.path.basename(p) for p, _ in _demos()])
def test_demo_pipelines_lint_clean(demo, ref_demo):
    """Every shipped demo passes the verifier with no error-severity
    finding, with the reference's findings on its own demo."""
    from pathway_tpu.analysis.program import analyze_program as janalyze

    got = analyze(tanalyze, demo, as_json=True)
    want = analyze(janalyze, ref_demo, as_json=True)
    assert got[0] == want[0] == 0, (got, want)
    assert norm_json(got[1]) == norm_json(want[1])


def test_unbounded_fixture_fails_with_pwl002_human(tmp_path):
    rc, out = both(tmp_path, "unbounded_groupby.py")
    assert rc == 1 and "PWL002" in out and "error" in out
    assert "unbounded_groupby.py" in out  # the diagnostic cites the fixture's own line


def test_unbounded_fixture_fails_with_pwl002_json(tmp_path):
    rc, out = both(tmp_path, "unbounded_groupby.py", as_json=True)
    payload = json.loads(out)
    assert rc == 1 and payload["summary"]["error"] >= 1
    (diag,) = [d for d in payload["diagnostics"] if d["rule"] == "PWL002"]
    assert diag["severity"] == "error" and diag["location"]["file"].endswith("unbounded_groupby.py")
    assert diag["location"]["line"] > 0


def test_windowed_fixture_passes_clean(tmp_path):
    rc, out = both(tmp_path, "windowed_groupby.py")
    assert rc == 0 and "no findings" in out


def test_broken_program_exits_3(tmp_path):
    rc, out, err = analyze(tanalyze, str(tmp_path / "does_not_exist.py"))
    assert rc == 3 and out == "" and "failed while building its graph" in err


def test_rag_template_lints_clean_in_process():
    """The llm-xpack vector store template: no error-severity finding and
    no deep finding (its device callables are the port's own), as the
    reference's."""
    rendered = []
    for pw in (jpw, tpw):
        pw.clear_graph()

        class DocSchema(pw.Schema):
            data: bytes
            _metadata: pw.Json

        docs = pw.debug.table_from_rows(DocSchema, [(b"pathway is a streaming dataflow framework",
                                                     pw.Json({"path": "/data/pathway.txt"}))])
        pw.xpacks.llm.VectorStoreServer(docs, embedder=pw.udf(_fake_embedding))
        diags = pw.analysis.analyze(deep=True)
        assert not [d for d in diags if d.severity is pw.analysis.Severity.ERROR]
        assert not [d for d in diags if d.rule in pw.analysis.DEEP_RULE_IDS], [d.render() for d in diags]
        rendered.append(sorted((d.rule, d.severity.value) for d in diags))
    assert rendered[0] == rendered[1]


# ------------------------------------------ the rule fixtures, one by one

# fixture, rule, environment, rules that must stay silent
_WARNS = [
    ("recovery_no_monitoring.py", "PWL007", {}, ()),
    ("serving_unprotected.py", "PWL008", {}, ()),
    ("cluster_no_recovery.py", "PWL009", {}, ()),
    ("index_over_hbm.py", "PWL010", {}, ()),
    ("host_bound_ingest.py", "PWL011", {}, ()),
    ("index_no_cold_tier.py", "PWL012", {}, ()),
    ("http_llm_with_device_decode.py", "PWL013", {}, ()),
    ("slo_without_tracing.py", "PWL014", {"PATHWAY_TRACING": None, "PATHWAY_PROFILE": None}, ()),
    ("slo_without_chip_accounting.py", "PWL021", {"PATHWAY_CHIP_LEDGER": None}, ("PWL014",)),
    ("elastic_no_recovery.py", "PWL022", {}, ()),
    ("decode_no_prefix_cache.py", "PWL023", {}, ()),
    ("combined_over_hbm.py", "PWL015", {"PATHWAY_HBM_BYTES": str(48 * 1024 * 1024)}, ("PWL010", "PWL012")),
    ("freshness_unmeasurable.py", "PWL024", {"PATHWAY_FRESHNESS": None}, ("PWL021",)),
    ("tenancy_no_quotas.py", "PWL016", {"PATHWAY_TENANCY": None}, ()),
]


def _env(monkeypatch, env: dict) -> None:
    for var, value in env.items():
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)


@pytest.mark.parametrize("fixture,rule,env,silent", _WARNS, ids=[w[1] for w in _WARNS])
def test_fixture_warns_and_fails_on_warn(fixture, rule, env, silent, tmp_path, monkeypatch):
    """The fixture draws a warning (exit 0), nonzero only under
    ``--fail-on=warn`` (and its deprecated spelling ``--strict-warnings``)."""
    _env(monkeypatch, env)
    rc, out = both(tmp_path, fixture)
    assert rc == 0 and rule in out and "warning" in out
    assert not [r for r in silent if r in out]
    if rule == "PWL009":
        assert out.count("PWL009") == 2
    assert both(tmp_path, fixture, fail_on="warn")[0] == 1
    assert both(tmp_path, fixture, strict_warnings=True)[0] == 1


def _check_pwl007(ds):
    (d,) = ds
    assert d["detail"]["run_context"]["recovery"] == "True"


def _check_pwl008(ds):
    (d,) = ds
    assert d["detail"]["endpoints"][0]["route"] == "/" and d["detail"]["recovery"] is True
    assert d["detail"]["pipeline_depth"] == 2


def _check_pwl009(ds):
    assert len(ds) == 2 and {d["detail"]["world"] for d in ds} == {2}
    (lease,) = [d for d in ds if "cluster_lease_ms" in d["detail"]]
    assert lease["detail"]["cluster_lease_ms"] == 0.0


def _check_pwl010(ds):
    (d,) = ds
    assert d["detail"]["index"]["reserved_space"] == 20_000_000
    assert d["detail"]["bytes"] > d["detail"]["hbm_budget_bytes"] and d["detail"]["suggested_mesh"] == 2


def _check_pwl011(ds):
    (d,) = ds
    assert d["detail"]["pipeline_depth"] == 1 and d["detail"]["ingest_workers"] == 0 and d["detail"]["indexes"]


def _check_pwl012(ds):
    (d,) = ds
    split = d["detail"]["suggested_tier_split"]
    assert d["detail"]["bytes"] > d["detail"]["hbm_budget_bytes"]
    assert split["hot_rows"] > 0 and split["cold_rows"] > 0 and split["hot_rows"] + split["cold_rows"] == 20_000_000
    assert d["detail"]["quantized_cold_bytes"] < d["detail"]["bytes"]


def _check_pwl013(ds):
    (d,) = ds
    endpoints = d["detail"]["llm_endpoints"]
    assert endpoints[0]["kind"] == "llm_reranker" and endpoints[0]["model"] == "gpt-x"
    assert d["detail"]["decode"]["pages"] == 128


def _check_pwl014(ds):
    (d,) = ds
    assert d["detail"]["endpoints"][0]["deadline_ms"] == 250.0
    assert d["detail"]["tracing"] is False and d["detail"]["profile"] is False


def _check_pwl021(ds):
    (d,) = ds
    assert d["detail"]["endpoints"][0]["deadline_ms"] == 250.0
    assert d["detail"]["watchdog"] is True and d["detail"]["chip_ledger"] is False


def _check_pwl022(ds):
    (d,) = ds
    assert d["detail"]["elastic"]["auto"] is True and d["detail"]["elastic"]["hbm_frac"] == 0.85
    assert d["detail"]["persistence"] is False


def _check_pwl023(ds):
    (d,) = ds
    assert d["detail"]["prefix_cache"] is False and d["detail"]["rag_indexes"][0]["device_backed"] is True
    assert d["detail"]["decode"]["pages"] == 128


def _check_pwl015(ds):
    (d,) = ds
    fp, budget = d["detail"]["footprint"], d["detail"]["hbm_budget_bytes"]
    assert budget == 48 * 1024 * 1024 and fp["index"] <= budget and fp["decode_kv"] <= budget < fp["total"]
    assert fp["total"] == fp["index"] + fp["decode_kv"] and d["detail"]["decode"]["pages"] == 256


def _check_pwl024(ds):
    (d,) = ds
    assert d["detail"]["watchdog_freshness"] is True and d["detail"]["freshness"] is None


def _check_pwl016(ds):
    (d,) = ds
    assert d["detail"]["tenancy"]["quotas"] == {} and d["detail"]["tenancy"]["default"] is None


_JSON = {w[1]: (w[0], w[2]) for w in _WARNS}
_CHECKS = {
    "PWL007": _check_pwl007, "PWL008": _check_pwl008, "PWL009": _check_pwl009, "PWL010": _check_pwl010,
    "PWL011": _check_pwl011, "PWL012": _check_pwl012, "PWL013": _check_pwl013, "PWL014": _check_pwl014,
    "PWL021": _check_pwl021, "PWL022": _check_pwl022, "PWL023": _check_pwl023, "PWL015": _check_pwl015,
    "PWL024": _check_pwl024, "PWL016": _check_pwl016,
}


@pytest.mark.parametrize("rule", list(_CHECKS))
def test_fixture_json_carries_its_detail(rule, tmp_path, monkeypatch):
    fixture, env = _JSON[rule]
    _env(monkeypatch, env)
    rc, out = both(tmp_path, fixture, as_json=True)
    hits = [d for d in json.loads(out)["diagnostics"] if d["rule"] == rule]
    assert rc == 0 and all(d["severity"] == "warning" for d in hits)
    _CHECKS[rule](hits)


# fixture, rule, environment, rules that must not appear
_SILENCED = [
    ("host_bound_ingest.py", "PWL011", {"PATHWAY_INGEST_WORKERS": "2"}, ("PWL011",)),
    ("index_no_cold_tier.py", "PWL012", {"PATHWAY_INDEX_TIERS": "auto"}, ("PWL012", "PWL010")),
    ("host_bound_ingest.py", "PWL013", {"PATHWAY_DECODE": None}, ("PWL013",)),
    ("slo_without_tracing.py", "PWL014", {"PATHWAY_TRACING": "1"}, ("PWL014",)),
    ("slo_without_chip_accounting.py", "PWL021", {"PATHWAY_CHIP_LEDGER": "1"}, ("PWL021",)),
    ("combined_over_hbm.py", "PWL023", {"PATHWAY_HBM_BYTES": str(256 * 1024 * 1024)}, ("PWL023",)),
    ("combined_over_hbm.py", "PWL015", {"PATHWAY_HBM_BYTES": str(256 * 1024 * 1024)}, ("PWL015",)),
    ("freshness_unmeasurable.py", "PWL024", {"PATHWAY_FRESHNESS": "1"}, ("PWL024",)),
]


@pytest.mark.parametrize("fixture,rule,env,absent", _SILENCED, ids=[s[1] for s in _SILENCED])
def test_the_suggested_fix_silences_the_fixture(fixture, rule, env, absent, tmp_path, monkeypatch):
    """The fix each diagnostic suggests, given through the environment,
    makes the same program lint clean of it."""
    _env(monkeypatch, env)
    rc, out = both(tmp_path, fixture)
    assert rc == 0 and not [r for r in absent if r in out]


def test_pwl016_explicit_arg_wins_over_env(tmp_path, monkeypatch):
    """The fixture passes tenancy=True, so a quota-carrying PATHWAY_TENANCY
    does not silence it: an explicit argument wins over its variable."""
    monkeypatch.setenv("PATHWAY_TENANCY", "qps=50,inflight=8")
    rc, out = both(tmp_path, "tenancy_no_quotas.py")
    assert rc == 0 and "PWL016" in out


def test_composed_planes_fixture_lints_clean_deep(tmp_path):
    """Mesh + tiers + tenancy with quotas + decode, every fix in place:
    no findings with warnings fatal and the deep pass on."""
    rc, out = both(tmp_path, "composed_planes.py", deep=True, fail_on="warn")
    assert rc == 0 and "no findings" in out


# ----------------------------------------------------- the command, end to end

_RUNNER = r"""
import contextlib, io, json, sys
from pathway_tpu_torch.cli import main
out = []
for argv in json.loads(sys.argv[1]):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code if isinstance(exc.code, int) else 2
    out.append({"rc": rc, "stdout": o.getvalue()})
print(json.dumps(out))
"""


def test_analyze_command_matches_the_reference(tmp_path):
    """``python -m pathway_tpu_torch analyze`` with the reference's flags:
    the exit codes and the JSON of the reference's click command on the
    same programs (one interpreter runs every command)."""
    sync = port_fixture(tmp_path, "deep_host_sync.py")
    recovery = port_fixture(tmp_path, "recovery_no_monitoring.py")
    unbounded = port_fixture(tmp_path, "unbounded_groupby.py")
    cmds = [
        ["analyze", "--deep", "--json", sync],
        ["analyze", "--deep", "--fail-on=warn", sync],
        ["analyze", "--strict-warnings", recovery],
        ["analyze", "--json", unbounded],
        ["analyze", "--fail-on", "error", recovery],
        ["analyze", str(tmp_path / "missing.py")],
    ]
    env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _RUNNER, json.dumps(cmds)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [g["rc"] for g in got] == [0, 1, 1, 1, 0, 3]
    (diag,) = json.loads(got[0]["stdout"])["diagnostics"]
    assert diag["rule"] == "PWL017" and diag["detail"]["markers"] == ["cpu"]
    ref = [os.path.join(FIXTURES, "deep_host_sync.py"), os.path.join(FIXTURES, "recovery_no_monitoring.py"),
           os.path.join(FIXTURES, "unbounded_groupby.py")]
    saved = dict(os.environ)
    try:
        want = [CliRunner().invoke(jcli, args) for args in (
            ["analyze", "--deep", "--json", ref[0]], ["analyze", "--deep", "--fail-on=warn", ref[0]],
            ["analyze", "--strict-warnings", ref[1]], ["analyze", "--json", ref[2]],
            ["analyze", "--fail-on", "error", ref[1]], ["analyze", str(tmp_path / "missing.py")])]
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert [w.exit_code for w in want] == [g["rc"] for g in got]
    assert norm_json(got[3]["stdout"]) == norm_json(want[3].stdout)
    # PWL017's markers and message name the torch read (``cpu``) where the reference's name ``device_get``
    strip = lambda p: [{k: v for k, v in d.items() if k not in ("detail", "message")} | {"detail": {  # noqa: E731
        k: v for k, v in d["detail"].items() if k != "markers"}} for d in p["diagnostics"]]
    assert strip(norm_json(got[0]["stdout"])) == strip(norm_json(want[0].stdout))
