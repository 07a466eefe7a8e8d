"""The port's flight recorder against the JAX package's, on the CPU: the
same records give equal event rings and equal dumps (time fields left
out), and ``render`` / ``diff`` of the same dump data give equal text. The
recorders are fresh instances; dumps go to a temporary directory.

Tolerances: every value and every character equal."""

from __future__ import annotations

import json

import pytest

from pathway_tpu.internals import flight_recorder as jfr
from pathway_tpu_torch.internals import flight_recorder as tfr

EVENTS = [
    ("epoch.begin", dict(t=0, worker=0, batches=1)),
    ("serving.admit", dict(route="/v1/retrieve", depth=1, degraded=False, trace="ab" * 16)),
    ("index.search", dict(index="knn0", queries=1, k=6, shards=1, merge_ms=0.0)),
    ("epoch.advance", dict(t=0, worker=0)),
    ("serving.shed", dict(route="/v1/retrieve", reason="queue_full", depth=4)),
    ("decode.prefill", dict(lane=0, prompt_tokens=17, pages=2, wall_ms=1.25)),
    ("decode.step", dict(batch=3, tokens=3, wall_ms=0.5)),
    ("decode.kv_evict", dict(lane=0, pages=2, reason="finish")),
    ("epoch.begin", dict(t=1, worker=0, batches=2)),
    ("epoch.advance", dict(t=1, worker=0)),
]


def _untimed(events):
    return [{k: v for k, v in e.items() if k != "time"} for e in events]


@pytest.mark.parametrize("size", [16, 512])
def test_ring_matches_the_reference(size):
    rings = []
    for mod in (jfr, tfr):
        rec = mod.FlightRecorder(size=size, enabled=True)
        for _ in range(3):
            for kind, fields in EVENTS:
                rec.record(kind, **fields)
        rings.append(_untimed(rec.events()))
    assert rings[0] == rings[1] and len(rings[1]) == min(size, 3 * len(EVENTS))


def test_disabled_recorder_records_nothing():
    for mod in (jfr, tfr):
        rec = mod.FlightRecorder(enabled=False)
        rec.record("epoch.begin", t=0)
        assert len(rec) == 0 and rec.dump("x") is None


def test_dump_matches_the_reference(tmp_path):
    dumps = []
    for mod in (jfr, tfr):
        rec = mod.FlightRecorder(size=64, enabled=True)
        for kind, fields in EVENTS:
            rec.record(kind, **fields)
        path = rec.dump("crash", ValueError("boom"), directory=str(tmp_path / mod.__name__))
        data = mod.load_dump(path)
        assert mod.list_dumps(str(tmp_path / mod.__name__)) == [path]
        dumps.append({k: (_untimed(v) if k == "events" else v) for k, v in data.items()
                      if k not in ("created_at", "pid")})
    assert dumps[0] == dumps[1]


def _fixed_dump(n_events: int, reason: str) -> dict:
    events = [{"seq": i + 1, "time": 1_700_000_000.0 + i, "kind": kind, **fields}
              for i, (kind, fields) in enumerate(EVENTS[:n_events])]
    return {"version": 1, "reason": reason, "pid": 4242, "process_id": 0, "created_at": 1_700_000_100.0,
            "error": {"type": "ValueError", "message": "boom"}, "events": events,
            "chip": {"busy_seconds": 1.5, "wall_seconds": 4.0, "accounted_fraction": 0.375,
                     "stranded_fraction": 0.625, "accounts": {"encode": {"seconds": 1.0, "share": 0.6667,
                                                                         "dispatches": 4}},
                     "stranded_causes": {"unattributed": 2.5}},
            "open_trace_spans": [{"trace": "cd" * 16, "stage": "request", "dur_ms": 12.5, "worker": 0}]}


@pytest.mark.parametrize("tail", [1, 3, 10])
def test_render_matches_the_reference(tail):
    data = json.loads(json.dumps(_fixed_dump(len(EVENTS), "crash")))
    assert tfr.render(data, tail_epochs=tail) == jfr.render(data, tail_epochs=tail)
    assert tfr.last_epoch(data) == jfr.last_epoch(data)


def test_diff_matches_the_reference():
    a, b = _fixed_dump(4, "crash"), _fixed_dump(len(EVENTS), "health.critical:p99_burn")
    assert tfr.diff(a, b) == jfr.diff(a, b)
