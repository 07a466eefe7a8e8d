"""The serving plane's chaos sites in the port, held against the JAX package.

``tests/test_serving.py``'s chaos cases and the three sites themselves:
``serving.admit`` fires inside ``AdmissionController.admit`` before any shed
decision, ``serving.before_dispatch`` before the adaptive batcher hands a
fused batch to the engine, and ``serving.batch_inflight`` after the
dispatch returned while the request futures are pending; both packages
react alike to the same rules. Over HTTP (the port's REST endpoint, whose
run returns when it is stopped): a burst against a chaos-slowed device
sheds typed 503s and recovers, and a request whose budget runs out while
its batch is stalled gets the typed ``deadline_exceeded``.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

import pathway_tpu_torch as tpw
from pathway_tpu import serving as jsv
from pathway_tpu.resilience import chaos as jchaos
from pathway_tpu_torch import serving as tsv
from pathway_tpu_torch.internals import flight_recorder as tfr
from pathway_tpu_torch.resilience import chaos as tchaos
from pathway_tpu_torch.serving import DEADLINE_HEADER

PACKAGES = [(jsv, jchaos), (tsv, tchaos)]


@pytest.fixture(autouse=True)
def _fresh():
    for sv, ch in PACKAGES:
        ch.deactivate()
        sv.SERVING_METRICS.reset()
    yield
    for sv, ch in PACKAGES:
        ch.deactivate()
        sv.SERVING_METRICS.reset()
    tpw.clear_graph()


def _admit_script(sv, ch):
    """A raise at ``serving.admit`` comes before any shed decision: nothing
    is admitted or shed; a delay there only slows the admission."""
    ctl = sv.AdmissionController(sv.ServingConfig(max_queue=2), metrics=sv.ServingMetrics())
    ch.activate([{"site": "serving.admit", "action": "raise"}])
    with pytest.raises(ch.ChaosInjected):
        ctl.admit(sv.Deadline(5000.0))
    ch.activate([{"site": "serving.admit", "action": "delay", "delay_s": 0.05}])
    t0 = time.monotonic()
    ticket = ctl.admit(sv.Deadline(5000.0))
    waited = time.monotonic() - t0 >= 0.05
    ch.deactivate()
    ctl.release(ticket)
    return waited, ctl.metrics.admitted_total, dict(ctl.metrics.shed_total)


def test_admit_site_fires_before_any_shed_decision():
    assert _admit_script(tsv, tchaos) == _admit_script(jsv, jchaos) == (True, 1, {})


def _batch_script(sv, ch, site: str):
    """A raise at a batcher site stops its worker with the error kept; the
    batch before the site never reaches the engine, the one after it did."""
    dispatched: list = []
    ch.activate([{"site": site, "action": "raise"}])
    b = sv.AdaptiveBatcher(lambda items: dispatched.extend(items), config=sv.ServingConfig(batch_max=4),
                           metrics=sv.ServingMetrics())
    try:
        for i in range(3):
            b.submit(i, sv.Deadline(30_000.0))
        until = time.monotonic() + 5.0
        while b.error is None and time.monotonic() < until:
            time.sleep(0.01)
    finally:
        b.stop()
        ch.deactivate()
    return type(b.error).__name__, sorted(dispatched)


@pytest.mark.parametrize("site", ["serving.before_dispatch", "serving.batch_inflight"])
def test_batcher_sites_match_the_reference(site):
    got = _batch_script(tsv, tchaos, site)
    assert got == _batch_script(jsv, jchaos, site)
    name, dispatched = got
    assert name == "ChaosInjected" and (dispatched == [] if site == "serving.before_dispatch" else dispatched)


def test_delay_at_before_dispatch_slows_but_keeps_every_item():
    for sv, ch in PACKAGES:
        calls: list = []
        ch.activate([{"site": "serving.before_dispatch", "action": "delay", "delay_s": 0.05, "repeat": True}])
        b = sv.AdaptiveBatcher(lambda items, calls=calls: calls.append(list(items)),
                               config=sv.ServingConfig(batch_max=2, batch_window_ms=1.0), metrics=sv.ServingMetrics())
        try:
            for i in range(6):
                b.submit(i, sv.Deadline(30_000.0))
            until = time.monotonic() + 5.0
            while sum(len(c) for c in calls) < 6 and time.monotonic() < until:
                time.sleep(0.01)
        finally:
            b.stop()
            ch.deactivate()
        assert sorted(x for c in calls for x in c) == list(range(6)) and b.error is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, payload: dict, headers: dict | None = None, timeout: float = 15):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        try:
            return exc.code, json.loads(body)
        except json.JSONDecodeError:
            return exc.code, {"raw": body}


def _run_rest_pipeline(client, serving):
    """A double-the-value REST pipeline on the port, ``client(port)`` on a
    thread while the engine runs; the engine stops after the client."""
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    web = tpw.io.http.PathwayWebserver(host="127.0.0.1", port=_free_port())
    queries, response_writer = tpw.io.http.rest_connector(webserver=web, schema=tpw.schema_from_types(value=int),
                                                          delete_completed_queries=False, serving=serving)
    response_writer(queries.select(result=tpw.this.value * 2))
    runner = GraphRunner()
    for spec in list(tpw.parse_graph.subscriptions):
        runner.subscribe(spec["table"], on_change=spec.get("on_change"))
    errors: list = []

    def drive():
        try:
            deadline = time.time() + 20
            while not web.serving and time.time() < deadline:
                time.sleep(0.05)
            client(web.port)
        except BaseException as exc:  # surfaced below
            errors.append(exc)
        finally:
            runner.engine.stop()

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    runner.run()
    t.join(timeout=60)
    assert not errors, errors


def test_overload_burst_sheds_typed_and_bounds_queue():
    seq_before = tfr.RECORDER._seq
    outcomes: list = []

    def client(port):
        tchaos.activate({"site": "serving.before_dispatch", "action": "delay", "delay_s": 0.25, "repeat": True})
        url = f"http://127.0.0.1:{port}/"
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(_post, url, {"value": i}, None, 30) for i in range(16)]
            for i, f in enumerate(futs):
                status, body = f.result()
                outcomes.append((status, body, i))
        tchaos.deactivate()
        outcomes.append((*_post(url, {"value": 100}), 100))  # the burst passed: served again

    _run_rest_pipeline(client, tsv.ServingConfig(max_queue=4, default_deadline_ms=20_000.0, batch_max=8,
                                                 batch_window_ms=1.0))
    burst, recovered = outcomes[:-1], outcomes[-1]
    ok = [(s, b, i) for s, b, i in burst if s == 200]
    shed = [(s, b, i) for s, b, i in burst if s != 200]
    assert ok and shed, burst
    assert all(b == i * 2 for _s, b, i in ok)
    assert all(s == 503 and b["reason"] == "queue_full" for s, b, _i in shed)
    assert tsv.SERVING_METRICS.shed_total.get("queue_full", 0) == len(shed)
    assert tsv.SERVING_METRICS.queue_depth <= 4
    assert recovered[:2] == (200, 200)
    kinds = {e["kind"] for e in tfr.RECORDER.events() if e["seq"] > seq_before}
    assert {"serving.admit", "serving.shed", "serving.batch"} <= kinds


def test_deadline_expiry_mid_pipeline_is_typed_503():
    outcomes = {}

    def client(port):
        tchaos.activate({"site": "serving.before_dispatch", "action": "delay", "delay_s": 0.6, "repeat": True})
        outcomes["expired"] = _post(f"http://127.0.0.1:{port}/", {"value": 3}, headers={DEADLINE_HEADER: "150"})
        tchaos.deactivate()
        outcomes["served"] = _post(f"http://127.0.0.1:{port}/", {"value": 3}, headers={DEADLINE_HEADER: "15000"})

    _run_rest_pipeline(client, tsv.ServingConfig(max_queue=8, default_deadline_ms=20_000.0))
    status, body = outcomes["expired"]
    assert status == 503 and body["reason"] == "deadline_exceeded"
    assert outcomes["served"] == (200, 6)
