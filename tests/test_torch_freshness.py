"""The port's freshness plane against the JAX package's, on the CPU: the
same sequence of arrivals, commits, drains, epoch marks, index publishes
and served answers, every one at an injected time (the planes' clock is a
scripted stand-in, and arrivals and answers take ``ts=`` / ``now=``), gives
equal snapshots, equal lag histograms and per-plane accruals, the same
``render_freshness`` report, and the same ``pathway_freshness_*`` lines.
The spec parser is held on the same specs, malformed ones included.

Tolerances: every value and every character equal."""

from __future__ import annotations

import types

import pytest

from pathway_tpu.freshness import plane as jpl
from pathway_tpu.freshness import report as jrep
from pathway_tpu.internals import http_monitoring as jhm
from pathway_tpu_torch.freshness import plane as tpl
from pathway_tpu_torch.freshness import report as trep
from pathway_tpu_torch.internals import http_monitoring as thm

SPECS = [True, None, False, "on", "off", "", "slo=250ms", "slo=2s", "SLO_MS=40", {"slo_ms": 250}, "slo=0.5s,"]
BAD = ["slo", "slo=fast", "ttl=3", 7.5, {"window": 1}]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_spec_matches_the_reference(spec):
    want, got = jpl.parse_freshness_spec(spec), tpl.parse_freshness_spec(spec)
    assert (got.as_dict() if got else None) == (want.as_dict() if want else None)


@pytest.mark.parametrize("spec", BAD, ids=repr)
def test_malformed_spec_raises_alike(spec):
    with pytest.raises(ValueError) as want:
        jpl.parse_freshness_spec(spec)
    with pytest.raises(ValueError) as got:
        tpl.parse_freshness_spec(spec)
    assert str(got.value) == str(want.value)


class _Index:
    def __init__(self, name, n_shards=1):
        self.name = name
        self.n_shards = n_shards


def _play(mod, steps, monkeypatch, slo_ms):
    clock = {"now": 1_000.0}
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: clock["now"]))
    plane = mod.FreshnessPlane()
    plane.set_enabled(True)
    plane.configure(mod.FreshnessConfig(slo_ms=slo_ms))
    idx = {"docs": _Index("docs", 2), "other": _Index("other"), "next": _Index("next", 3)}
    answers = []
    for op, *args in steps:
        if op == "at":
            clock["now"] = args[0]
        elif op == "arrive":
            plane.note_arrival(args[0], ts=args[1], n=args[2])
        elif op == "commit":
            plane.note_commit(args[0])
        elif op == "drain":
            plane.note_drain(args[0])
        elif op == "epoch":
            t, staged, execd, committed, touched = args
            plane.begin_epoch(t)
            clock["now"] = staged
            plane.epoch_staged(t)
            clock["now"] = execd
            plane.epoch_exec(t)
            for name, shards in touched:
                plane.note_index_add(idx[name], shards)
            clock["now"] = committed
            plane.epoch_committed(t)
        elif op == "add":
            plane.note_index_add(idx[args[0]], args[1])
        elif op == "answer":
            answers.append(plane.observe_answer(idx.get(args[0]), now=args[1], tenant=args[2]))
        elif op == "carry":
            plane.carry_over(idx[args[0]], idx[args[1]], args[2])
        elif op == "accrue":
            plane.accrue(args[0], args[1])
    return plane, answers


STEPS = [
    ("at", 1000.0), ("arrive", 1, 999.9, 3), ("arrive", 1, 999.95, 1), ("arrive", 2, 999.97, 5), ("commit", 1),
    ("commit", 2), ("at", 1000.02), ("drain", 1), ("drain", 2),
    ("epoch", 0, 1000.03, 1000.031, 1000.08, [("docs", [0, 1])]),
    ("answer", "docs", 1000.1, None), ("answer", None, 1000.2, "acme"),
    ("arrive", 1, 1000.5, 2), ("commit", 1), ("at", 1000.9), ("drain", 1),
    ("epoch", 1, 1000.95, 1001.2, 1001.6, [("docs", [1]), ("other", [0])]),
    ("epoch", 2, 1001.7, 1001.7, 1001.71, []),
    ("at", 1002.0), ("add", "other", [0]), ("answer", "other", 1003.0, "globex"),
    ("carry", "docs", "next", 3), ("accrue", "promotion", 0.25), ("accrue", "migration", 0.5),
    ("answer", "next", 1004.0, "acme"),
]


@pytest.mark.parametrize("slo_ms", [None, 250.0, 5000.0])
def test_plane_matches_the_reference(monkeypatch, slo_ms):
    want, wa = _play(jpl, STEPS, monkeypatch, slo_ms)
    got, ga = _play(tpl, STEPS, monkeypatch, slo_ms)
    assert ga == wa
    snap_w, snap_g = want.snapshot(now=1005.0), got.snapshot(now=1005.0)
    assert snap_g == snap_w
    assert snap_g["lag"]["hist"] == snap_w["lag"]["hist"] and snap_g["lag"]["count"] == 2
    assert got.lag_ewma_ms() == want.lag_ewma_ms()
    assert got.visible_wm(_Index("docs")) == want.visible_wm(_Index("docs"))
    assert got.answer_bound(None, now=1006.0) == want.answer_bound(None, now=1006.0)
    assert trep.render_freshness({"freshness": snap_g}) == jrep.render_freshness({"freshness": snap_w})


def test_metrics_lines_match_the_reference(monkeypatch):
    want, _ = _play(jpl, STEPS, monkeypatch, 250.0)
    got, _ = _play(tpl, STEPS, monkeypatch, 250.0)
    for mod, plane in ((jpl, want), (tpl, got)):
        snap = plane.snapshot
        monkeypatch.setattr(plane, "snapshot", lambda now=None, snap=snap: snap(now=1005.0))
        monkeypatch.setattr(mod, "FRESHNESS", plane)
    lines = thm.MonitoringHttpServer._freshness_lines("")
    assert lines == jhm.MonitoringHttpServer._freshness_lines("") and lines


def test_off_plane_records_nothing(monkeypatch):
    monkeypatch.delenv("PATHWAY_FRESHNESS", raising=False)
    for mod in (jpl, tpl):
        plane = mod.FreshnessPlane()
        plane.note_arrival(1, ts=1.0)
        plane.begin_epoch(0)
        plane.note_index_add(_Index("x"), [0])
        plane.epoch_committed(0)
        assert not plane.active() and plane.answer_bound() is None
    assert trep.render_freshness({}) == jrep.render_freshness({})
