"""The port's resilience plane, held against the JAX package's.

The cases of ``tests/test_resilience.py`` that the port holds (dead-letter
routing and the async transformer are ROADMAP item 7, cluster formation
item 5): ``RetryPolicy`` (the same seed gives the reference's delays, the
backoff, ``execute`` and its metrics), ``Recovery`` and the ``Supervisor``
(restarts, escalation, faults only), ``pw.run(recovery=)`` through a chaos
failure at a connector's ``connector.<name>`` site, connectors'
``retry_policy=``, the chaos plan, the shared cluster-health state, and the
resilience families on ``/metrics`` and ``/status``: their lines equal the
reference's for the same counts, and with the plane idle the scrape
carries nothing of it.
"""

from __future__ import annotations

import json
import sys

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import resilience as jres
from pathway_tpu.internals.http_monitoring import MonitoringHttpServer as JServer
from pathway_tpu_torch import resilience as tres
from pathway_tpu_torch.internals.http_monitoring import MonitoringHttpServer as TServer

PAIRS = ((jpw, jres, JServer), (tpw, tres, TServer))


def _no_sleep(_s: float) -> None:
    pass


@pytest.fixture(autouse=True)
def _reset():
    for _pw, res, _srv in PAIRS:
        res.RETRY_METRICS.reset()
        res.SUPERVISOR_METRICS.reset()
        res.CLUSTER_METRICS.reset()
        res.chaos.deactivate()
    yield
    for pw, res, _srv in PAIRS:
        res.chaos.deactivate()
        res.RETRY_METRICS.reset()
        res.SUPERVISOR_METRICS.reset()
        res.CLUSTER_METRICS.reset()
        pw.clear_graph()


def _waits(policy, n=6):
    sched = policy.spawn()
    return [sched.wait_duration_before_retry() for _ in range(n)]


@pytest.mark.parametrize("kw", [dict(first_delay_ms=10, jitter_ms=100, max_retries=5, seed=42),
                                dict(first_delay_ms=10, jitter_ms=100, max_retries=5, seed=7),
                                dict(first_delay_ms=100, backoff_factor=2.0, jitter_ms=0),
                                dict(first_delay_ms=3, backoff_factor=1.5, jitter_ms=40, seed=0)],
                         ids=["seed42", "seed7", "no_jitter", "seed0"])
def test_retry_delays_equal_the_reference_under_the_same_seed(kw):
    want = _waits(jres.RetryPolicy(**kw))
    got = _waits(tres.RetryPolicy(**kw))
    assert got == want
    assert _waits(tres.RetryPolicy(**kw)) == got  # a seeded policy replays its schedule on every spawn


def test_retry_backoff_growth_and_seeds_differ():
    assert _waits(tres.RetryPolicy(first_delay_ms=100, backoff_factor=2.0, jitter_ms=0), 3) == [0.1, 0.2, 0.4]
    assert _waits(tres.RetryPolicy(first_delay_ms=10, jitter_ms=100, seed=42)) != _waits(
        tres.RetryPolicy(first_delay_ms=10, jitter_ms=100, seed=7))


def test_retry_execute_success_exhaustion_filter_and_none():
    out = []
    for _pw, res, _srv in PAIRS:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("transient")
            return "ok"

        p = res.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=5, sleep=_no_sleep)
        assert p.execute(flaky, scope="t") == "ok"
        with pytest.raises(ValueError, match="always"):
            res.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=2, sleep=_no_sleep).execute(
                lambda: (_ for _ in ()).throw(ValueError("always")), scope="x")
        fatal = {"n": 0}

        def not_transient():
            fatal["n"] += 1
            raise TypeError("not transient")

        with pytest.raises(TypeError):
            p.execute(not_transient, retryable=lambda e: isinstance(e, ConnectionError))
        with pytest.raises(OSError):
            res.RetryPolicy.none().execute(lambda: (_ for _ in ()).throw(OSError("x")))
        out.append((res.RETRY_METRICS.snapshot(), fatal["n"]))
    assert out[1] == out[0]
    snap, fatal_calls = out[1]
    assert snap["t"] == {"attempts": 3, "retries": 2, "successes": 1, "failures": 0}
    assert snap["x"]["attempts"] == 3 and snap["x"]["failures"] == 1 and fatal_calls == 1


def test_recovery_coerce_forms():
    R = tres.Recovery
    assert R.coerce(None) is None and R.coerce(False) is None
    assert R.coerce(True).max_restarts == 3 and R.coerce(7).max_restarts == 7
    r = R(max_restarts=1)
    assert R.coerce(r) is r
    with pytest.raises(TypeError):
        R.coerce("yes")


def _fast(res, n: int):
    return res.Recovery(max_restarts=n, backoff=res.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=n,
                                                                sleep=_no_sleep))


def test_supervisor_restarts_escalates_and_spares_programming_errors():
    out = []
    for _pw, res, _srv in PAIRS:
        state = {"n": 0}

        def attempt(is_restart):
            state["n"] += 1
            assert is_restart == (state["n"] > 1)
            if state["n"] < 3:
                raise OSError("worker died")
            return "done"

        assert res.Supervisor(_fast(res, 5)).run(attempt) == "done"
        with pytest.raises(res.RecoveryEscalated, match="budget exhausted"):
            res.Supervisor(_fast(res, 2)).run(lambda _r: (_ for _ in ()).throw(ConnectionError("perma-dead")))
        bug = {"n": 0}

        def broken(_r):
            bug["n"] += 1
            raise KeyError("a bug, not a fault")

        with pytest.raises(KeyError):
            res.Supervisor(_fast(res, 3)).run(broken)
        out.append((res.SUPERVISOR_METRICS.snapshot(), state["n"], bug["n"]))
    assert out[1] == out[0]
    snap, attempts, bugs = out[1]
    assert snap["restarts"] == {"OSError": 2, "ConnectionError": 2} and snap["escalations"] == 1
    assert attempts == 3 and bugs == 1


def test_run_recovery_restarts_through_a_chaos_connector_failure():
    """A connector failing on its first attempt (the ``connector.<name>``
    chaos site) restarts ``pw.run(recovery=...)``, which then delivers every
    row, in both packages; the port warns without persistence, as the
    reference does."""
    got = []
    for pw, res, _srv in PAIRS:
        conn = sys.modules[pw.__name__ + ".io._connector"]

        class S(pw.Schema):
            v: int

        res.chaos.activate(res.ChaosPlan([{"site": "connector.chaotic", "action": "raise"}]))

        def reader(ctx):
            for i in range(3):
                ctx.insert({"v": i})

        t = conn.input_table_from_reader(S, reader, name="chaotic")
        rows: list[int] = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, rows=rows: rows.append(row["v"]))
        with pytest.warns(UserWarning, match="without persistence_config"):
            pw.run(monitoring_level="none", recovery=_fast(res, 2))
        pw.clear_graph()
        got.append((sorted(rows), res.SUPERVISOR_METRICS.snapshot()["restarts_total"]))
    assert got[1] == got[0] == ([0, 1, 2], 1)


class _FakeMonitor:
    class snapshot:
        time = 0
        rows_in = 0
        rows_out = 0
        operators: dict = {}
        operator_self_time_s: dict = {}
        operator_event_lag_s: dict = {}

    profiler = None

    def input_latency_ms(self, now):
        return 0

    def output_latency_ms(self, now):
        return 0


def _resilience_lines(server_cls) -> list[str]:
    text = server_cls(_FakeMonitor(), port=0)._prometheus()
    return [ln for ln in text.splitlines() if "retry" in ln or "supervisor" in ln or "cluster" in ln]


def test_connector_retry_policy_recovers_and_scrapes_like_the_reference():
    assert _resilience_lines(TServer) == _resilience_lines(JServer) == []  # idle: nothing renders
    for pw, res, _srv in PAIRS:
        conn = sys.modules[pw.__name__ + ".io._connector"]

        class S(pw.Schema):
            v: int

        state = {"fails": 2}

        def reader(ctx, state=state):
            if state["fails"] > 0:
                state["fails"] -= 1
                raise ConnectionError("transient network blip")
            for i in range(3):
                ctx.insert({"v": i})

        t = conn.input_table_from_reader(S, reader, name="flaky", retry_policy=res.RetryPolicy(
            first_delay_ms=1, jitter_ms=0, max_retries=5, sleep=_no_sleep))
        rows: list[int] = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, rows=rows: rows.append(row["v"]))
        pw.run(monitoring_level="none")
        pw.clear_graph()
        assert sorted(rows) == [0, 1, 2]
        assert res.RETRY_METRICS.snapshot()["connector:flaky"] == {"attempts": 3, "retries": 2, "successes": 1,
                                                                   "failures": 0}
        res.Supervisor(_fast(res, 2)).run(lambda r: None if r else (_ for _ in ()).throw(OSError("once")))
        res.CLUSTER_METRICS.record_barrier()
    lines = _resilience_lines(TServer)
    assert lines == _resilience_lines(JServer)
    for want in ('pathway_retry_attempts_total{scope="connector:flaky"} 3',
                 'pathway_retry_retries_total{scope="connector:flaky"} 2',
                 'pathway_supervisor_restarts_total{cause="OSError"} 1', "pathway_cluster_barriers_total 1"):
        assert want in lines
    tstatus = json.loads(TServer(_FakeMonitor(), port=0)._status())
    jstatus = json.loads(JServer(_FakeMonitor(), port=0)._status())
    for key in ("supervisor", "retries"):
        assert tstatus[key] == jstatus[key]
    assert tstatus["cluster"]["barriers_total"] == jstatus["cluster"]["barriers_total"] == 1


def test_chaos_plan_matching_hits_repeat_offset_and_env(tmp_path, monkeypatch):
    plan = tres.ChaosPlan([{"site": "a", "time": 3, "action": "raise"}])
    plan.fire("a", 2, None)
    plan.fire("b", 3, None)
    with pytest.raises(tres.ChaosInjected):
        plan.fire("a", 3, None)
    plan.fire("a", 3, None)  # a rule fires once
    rep = tres.ChaosPlan([{"site": "s", "hit": 2, "repeat": True, "action": "raise"}])
    fired = 0
    for _ in range(6):
        try:
            rep.fire("s", None, None)
        except tres.ChaosInjected:
            fired += 1
    assert fired == 3
    off = tres.ChaosPlan([{"site": "w", "offset": 100, "action": "raise"}])
    off.fire("w", None, 50)
    with pytest.raises(tres.ChaosInjected):
        off.fire("w", None, 150)
    spec = tmp_path / "plan.json"
    spec.write_text(json.dumps({"rules": [{"site": "env.site", "action": "raise"}]}))
    monkeypatch.setenv("PATHWAY_CHAOS", str(spec))
    tres.chaos.reload_env()
    assert tres.chaos.armed() and tres.chaos.armed("env.site") and not tres.chaos.armed("other.site")
    with pytest.raises(tres.ChaosInjected):
        tres.chaos.inject("env.site")
    monkeypatch.delenv("PATHWAY_CHAOS")
    tres.chaos.reload_env()
    assert not tres.chaos.armed()
    tres.chaos.inject("env.site")  # no plan: a no-op
    for site in ("engine.before_stage_commit", "engine.after_stage_commit", "serving.admit",
                 "serving.before_dispatch", "serving.batch_inflight", "ingest.worker"):
        assert site in tres.chaos.registered_sites()


def test_cluster_health_shared_state_matches_the_reference():
    out = []
    for _pw, res, _srv in PAIRS:
        res.CLUSTER_METRICS.record_lease_expired(1)
        res.CLUSTER_METRICS.record_partial_restart(1)
        res.CLUSTER_HEALTH.mark_down([2])
        snap = res.CLUSTER_METRICS.snapshot()
        out.append((snap["lease_expiries"], snap["partial_restarts_total"], sorted(res.CLUSTER_HEALTH.down_shards()),
                    res.CLUSTER_HEALTH.is_down(2), issubclass(res.WorkerLost, Exception),
                    issubclass(res.ClusterRegroup, Exception)))
        res.CLUSTER_HEALTH.mark_all_up()
    assert out[1] == out[0]
    assert out[1][2] == [2]
