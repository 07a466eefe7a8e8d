"""The port's serving plane against the JAX package, on the CPU: the
``TokenBucket`` and ``AdmissionController`` on the same scripts (a fake
clock where time matters), the ``AdaptiveBatcher``'s coalescing, deadline
order, expiry and tenant round-robin, and the ``DecodeService`` front door
over the port's decode engine (``tests/test_decode_engine.py``'s service
cases, with the streams held to the JAX engine's).

Tolerances: every outcome, status, body and counter equal."""

from __future__ import annotations

import threading
import time

import pytest

from pathway_tpu import serving as jsv
from pathway_tpu.decode import DecodeConfig as JDecodeConfig
from pathway_tpu.decode import DecodeEngine as JEngine
from pathway_tpu.decode import DecoderConfig as JDecoderConfig
from pathway_tpu.decode import init_decoder_params as jinit_decoder
from pathway_tpu_torch import serving as tsv
from pathway_tpu_torch.decode import DECODE_METRICS, DecodeConfig, DecodeEngine, DecoderConfig, DecodeService
from pathway_tpu_torch.weights import from_jax_decoder_params

PACKAGES = pytest.mark.parametrize("sv", [jsv, tsv], ids=["jax", "torch"])


def _outcome(fn):
    """What a call did: its value, or its typed error's status and body."""
    try:
        return ("ok", fn())
    except jsv.OverloadError as exc:
        return (type(exc).__name__, exc.status, exc.to_response()["reason"])
    except tsv.OverloadError as exc:
        return (type(exc).__name__, exc.status, exc.to_response()["reason"])


# ------------------------------------------------------------ token bucket


def _bucket_script(sv):
    now = [0.0]
    bucket = sv.TokenBucket(qps=10.0, burst=2, clock=lambda: now[0])
    out = [bucket.try_acquire(), bucket.try_acquire(), bucket.try_acquire(), round(bucket.retry_after(), 9)]
    now[0] += 0.1
    out += [bucket.try_acquire(), bucket.try_acquire()]
    now[0] += 5.0
    out += [bucket.try_acquire(), bucket.try_acquire(), bucket.try_acquire(), round(bucket.retry_after(), 9)]
    return out


def test_token_bucket_follows_the_reference_on_a_fake_clock():
    assert _bucket_script(tsv) == _bucket_script(jsv)


# --------------------------------------------------------------- admission


def _controller(sv, **cfg):
    metrics = sv.ServingMetrics()
    return sv.AdmissionController(sv.ServingConfig(**cfg), metrics=metrics, route="/test"), metrics


def _admission_script(sv, start):
    """Every admission path on one fixed clock origin: depth, queue full,
    rate limit, early expiry, the min-service floor, the degrade band and
    the deadline-ordered ledger."""
    D = lambda ms: sv.Deadline(ms, start=start)  # noqa: E731
    out = []
    ctl, m1 = _controller(sv, max_queue=2)
    t1 = ctl.admit(D(5000.0))
    t2 = ctl.admit(D(5000.0))
    out += [ctl.depth, _outcome(lambda: ctl.admit(D(5000.0))), ctl.depth]
    ctl.release(t1)
    ctl.release(t2)
    out += [ctl.depth, m1.queue_depth, m1.admitted_total, dict(m1.shed_total)]
    ctl, m2 = _controller(sv, rate_limit_qps=0.5, rate_limit_burst=1)
    out += [_outcome(lambda: ctl.admit(D(5000.0)).seq), _outcome(lambda: ctl.admit(D(5000.0))), dict(m2.shed_total)]
    ctl, m3 = _controller(sv, min_service_ms=50.0)
    out += [_outcome(lambda: ctl.admit(sv.Deadline(0.0))), _outcome(lambda: ctl.admit(sv.Deadline(10.0))),
            _outcome(lambda: ctl.admit(D(5000.0)).degraded), m3.deadline_expired_total, dict(m3.shed_total)]
    ctl, m4 = _controller(sv, shed="degrade", max_queue=4, degrade_watermark=0.5)
    out += [[ctl.admit(D(5000.0)).degraded for _ in range(4)], _outcome(lambda: ctl.admit(D(5000.0))),
            m4.degraded_total]
    ctl, _ = _controller(sv)
    late, soon = ctl.admit(D(60_000.0)), ctl.admit(D(1_000.0))
    out += [ctl.next_expiry() - start]
    ctl.release(soon)
    out += [ctl.next_expiry() - start]
    ctl.release(late)
    out += [ctl.next_expiry(), ctl.expire(late).to_response()]
    return out


def test_admission_controller_follows_the_reference():
    start = time.monotonic()
    assert _admission_script(tsv, start) == _admission_script(jsv, start)


@PACKAGES
def test_serving_config_validation(sv):
    for bad in (dict(shed="explode"), dict(max_queue=0), dict(query_share=0.0)):
        with pytest.raises(ValueError):
            sv.ServingConfig(**bad)


def test_admission_names_the_planes_it_lacks(monkeypatch):
    """A tenant is attributed with or without a tenancy (its quotas apply
    under one: tests/test_torch_tenancy.py); a request pinned to a healthy
    shard is admitted, and to a shard the cluster marked down is shed as a
    typed 503 (tests/test_torch_cluster_fault_domain.py holds the gate to
    the reference)."""
    from pathway_tpu_torch.resilience.cluster import CLUSTER_HEALTH

    ctl, _ = _controller(tsv)
    assert ctl.admit(tsv.Deadline(5000.0), tenant="acme").tenant == "acme"  # attributed, no quota
    monkeypatch.setenv("PATHWAY_TENANCY", "on")
    assert ctl.admit(tsv.Deadline(5000.0), tenant="acme").tenant == "acme"  # a tenancy without quotas
    assert not ctl.admit(tsv.Deadline(5000.0), shard=1).degraded
    CLUSTER_HEALTH.mark_down([1], retry_after_s=2.0)
    try:
        with pytest.raises(tsv.ShardUnavailable) as exc:
            ctl.admit(tsv.Deadline(5000.0), shard=1)
        assert (exc.value.status, exc.value.reason, exc.value.retry_after_s) == (503, "shard_unavailable", 2.0)
    finally:
        CLUSTER_HEALTH.mark_all_up()


# ---------------------------------------------------------------- batching


def _idle_batcher(sv, **cfg):
    """A batcher whose worker thread exits at once, so ``_take_batch`` is
    driven from the test."""
    b = sv.AdaptiveBatcher(lambda items: None, config=sv.ServingConfig(**cfg), metrics=sv.ServingMetrics())
    b._halt = True
    return b


def _batching_script(sv, start):
    D = lambda ms: sv.Deadline(ms, start=start)  # noqa: E731
    out = []
    b = _idle_batcher(sv, batch_max=8)
    expired = []
    b._on_expired = expired.append
    for item, ms in (("late", 60_000.0), ("soon", 1_000.0), ("dead", 0.0), ("mid", 10_000.0), ("none", None)):
        b.submit(item, D(ms) if ms is not None else None)
    out += [b.next_deadline() - start, b.pending(), b._take_batch()[0], expired, b.dropped_expired_total,
            b.metrics.deadline_expired_total]
    b = _idle_batcher(sv, batch_max=16, latency_budget_ms=100.0, query_share=0.5)
    out.append(b.current_batch_size())
    b._ewma_item_s = 0.01
    out.append(b.current_batch_size())
    b._ewma_item_s = 1.0
    out.append(b.current_batch_size())
    # tenant heaps: deficit round-robin, every tenant at weight 1 without a tenancy
    b = _idle_batcher(sv, batch_max=7)
    for i in range(6):
        b.submit(f"a{i}", D(1000.0 + i), tenant="a")
    for i in range(3):
        b.submit(f"b{i}", D(2000.0 + i), tenant="b")
    b.submit("anon", D(500.0))
    out += [b._take_batch()[0], b._take_batch()[0], b.pending()]

    class FakeEngine:
        epoch_observers: list = []

    eng = FakeEngine()
    eng.epoch_observers = []
    b.attach_engine(eng)
    b.attach_engine(eng)
    b._on_epoch(1, 0.08)
    b._on_epoch(2, 0.04)
    out += [len(eng.epoch_observers), round(b._engine_epoch_s, 12)]
    return out


def test_adaptive_batcher_follows_the_reference():
    start = time.monotonic()
    assert _batching_script(tsv, start) == _batching_script(jsv, start)


def test_tenant_weights_under_a_tenancy_name_item_4(monkeypatch):
    """Under a tenancy the batcher drains the tenant heaps by their quota
    weights (it raised, naming item 4, until the tenancy plane came)."""
    from pathway_tpu_torch.tenancy import use_tenancy

    b = _idle_batcher(tsv, batch_max=6)
    for i in range(6):
        b.submit(f"a{i}", tsv.Deadline(5000.0 + i), tenant="a")
        b.submit(f"b{i}", tsv.Deadline(5000.0 + i), tenant="b")
    with use_tenancy({"quotas": {"a": {"weight": 2}, "b": {"weight": 1}}}):
        items = b._take_batch()[0]
    assert items == ["a0", "a1", "b0", "a2", "a3", "b1"]


@PACKAGES
def test_batcher_fuses_a_burst_and_surfaces_errors(sv):
    calls: list[list] = []
    done = threading.Event()

    def dispatch(items):
        calls.append(list(items))
        if sum(len(c) for c in calls) >= 6:
            done.set()

    b = sv.AdaptiveBatcher(dispatch, config=sv.ServingConfig(batch_max=8, batch_window_ms=40.0, query_share=1.0),
                           metrics=sv.ServingMetrics())
    try:
        for i in range(6):
            b.submit(i, sv.Deadline(30_000.0))
        assert done.wait(timeout=5.0)
        assert sorted(x for c in calls for x in c) == list(range(6)) and len(calls) <= 3
        assert b.metrics.batches_total == len(calls) and b.error is None
    finally:
        b.stop()

    def broken(items):
        raise RuntimeError("device fell over")

    b = sv.AdaptiveBatcher(broken, config=sv.ServingConfig(), metrics=sv.ServingMetrics())
    try:
        b.submit("x", sv.Deadline(30_000.0))
        until = time.monotonic() + 5.0
        while b.error is None and time.monotonic() < until:
            time.sleep(0.01)
        assert isinstance(b.error, RuntimeError)
    finally:
        b.stop()


# ------------------------------------------------------------ DecodeService

GEOM = dict(vocab_size=97, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, max_position=64)
POOL = dict(pages=64, page_size=4, lanes=4, max_new_tokens=6, degrade_max_new_tokens=2, max_seq=48)
JPARAMS = jinit_decoder(JDecoderConfig(**GEOM), seed=0)
PARAMS = from_jax_decoder_params(JPARAMS)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8], [9, 9], [31, 41, 5, 92, 6, 53, 5, 89, 79, 3]]


def _engine(**over):
    return DecodeEngine(DecoderConfig(**GEOM), DecodeConfig(**{**POOL, **over}), params=PARAMS, device="cpu")


@pytest.mark.parametrize("over", [{}, dict(prefix_cache=True, prefill_chunk=4)], ids=["plain", "cache_chunk"])
def test_decode_service_front_door(over):
    svc = DecodeService(_engine(**over))
    try:
        tickets = [svc.submit(p, deadline=tsv.Deadline.none()) for p in PROMPTS]
        tickets.append(svc.submit(PROMPTS[0], deadline=tsv.Deadline(30_000.0), degraded=True))
        streams = [t.result(timeout=60.0) for t in tickets]
        assert svc.error is None
    finally:
        svc.stop()
    jeng = JEngine(JDecoderConfig(**GEOM), JDecodeConfig(**POOL, impl="xla"), params=JPARAMS)
    assert streams[:4] == jeng.generate(PROMPTS)
    assert streams[4] == streams[0][: POOL["degrade_max_new_tokens"]] and tickets[4].skip_rerank


def test_decode_service_drops_queue_expired_tickets():
    DECODE_METRICS.reset()
    svc = DecodeService(_engine())
    try:
        ticket = svc.submit(PROMPTS[0], deadline=tsv.Deadline(1.0, start=time.monotonic() - 10.0))
        assert ticket.done.wait(timeout=60.0)
        assert ticket.preempted and ticket.result() == []
        live = svc.submit(PROMPTS[1], deadline=tsv.Deadline(30_000.0))
        assert live.result(timeout=60.0) == _engine().generate([PROMPTS[1]])[0]
        assert svc.error is None
    finally:
        svc.stop()
    assert DECODE_METRICS.snapshot()["preempted_total"] >= 1
    DECODE_METRICS.reset()


def test_decode_service_keeps_a_dispatch_error():
    """The dispatch runs on the batcher thread: a failing engine stops the
    service and the error is kept, never swallowed."""
    eng = _engine()

    def broken():
        raise RuntimeError("engine fell over")

    eng.drain = broken
    svc = DecodeService(eng)
    try:
        svc.submit(PROMPTS[0], deadline=tsv.Deadline(30_000.0))
        until = time.monotonic() + 5.0
        while svc.error is None and time.monotonic() < until:
            time.sleep(0.01)
        assert isinstance(svc.error, RuntimeError)
    finally:
        svc.stop()
