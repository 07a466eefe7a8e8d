"""The port's HBM ledger and health watchdog against the JAX package's, on
the CPU: ``parse_watchdog_spec`` on the same specs (malformed ones raise
alike), ``parse_bytes``, the footprint helpers, a scripted series of
injected samples through ``HealthWatchdog.evaluate_once`` (same verdicts
sample by sample), the ``DeviceLedger`` accounts, and the budget the decode
pool is checked against: the reference's 16 GiB without a card, the
card's memory on one (held with a stand-in for ``torch.cuda``).

Tolerances: every value equal."""

from __future__ import annotations

import types

import pytest
import torch

from pathway_tpu.internals import ledger as jl
from pathway_tpu_torch.decode.config import DecodeConfig
from pathway_tpu_torch.internals import ledger as tl

SPECS = [
    True, None, False, "on", "off", "", "1", "0", "interval=0.25", "interval=0.1,breach_for=1,clear_for=3",
    "oom_critical_s=3600,oom_warn_s=7200", "p99_warn=0.5,p99_critical=0.9,shed_warn=0.01",
    "stranded_warn=0.3,freshness_critical=2", {"interval": 0.5, "hit_warn": 0.6}, "INTERVAL=2, breach_for=4",
]
BAD_SPECS = ["nonsense", "interval", "bogus=1", "interval=x", 3.5, {"breach_for": "many"}]


def _spec(v):
    if v is None:
        return None
    return (v["interval_s"], tuple(tuple(sorted(r.__dict__.items())) for r in v["rules"]))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_watchdog_spec_matches_the_reference(spec):
    assert _spec(tl.parse_watchdog_spec(spec)) == _spec(jl.parse_watchdog_spec(spec))


@pytest.mark.parametrize("spec", BAD_SPECS, ids=repr)
def test_malformed_watchdog_spec_raises_alike(spec):
    with pytest.raises(ValueError) as want:
        jl.parse_watchdog_spec(spec)
    with pytest.raises(ValueError) as got:
        tl.parse_watchdog_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("raw", ["4G", "512M", "64k", "1.5g", 12345, "77"])
def test_parse_bytes_matches_the_reference(raw):
    assert tl.parse_bytes(raw) == jl.parse_bytes(raw)


def test_footprint_helpers_match_the_reference():
    for fn, args in (("hot_row_bytes", (384,)), ("hot_row_bytes", (384, "int8")), ("cold_row_bytes", (384,)),
                     ("index_hbm_bytes", (1 << 20, 384)), ("kv_pool_bytes", (1024, 16, 4, 256)),
                     ("decoder_weights_bytes", (4, 256))):
        assert getattr(tl, fn)(*args) == getattr(jl, fn)(*args)
    assert tl.footprint(index_bytes=5, kv_bytes=7, weight_bytes=11) == jl.footprint(
        index_bytes=5, kv_bytes=7, weight_bytes=11)


# a scripted series: memory ramps toward the budget, serving burns its p99,
# sheds rise then clear, the card strands, freshness lags behind its SLO
SERIES = [
    dict(t=0.0, hbm_bytes=1 << 30, shed_rate=0.0, p99_s=0.1, deadline_s=1.0, stranded_fraction=0.2),
    dict(t=1.0, hbm_bytes=2 << 30, shed_rate=0.06, p99_s=0.85, deadline_s=1.0, stranded_fraction=0.6),
    dict(t=2.0, hbm_bytes=6 << 30, shed_rate=0.3, p99_s=1.2, deadline_s=1.0, stranded_fraction=0.9,
         freshness_lag_s=0.1, freshness_slo_s=0.25),
    dict(t=3.0, hbm_bytes=12 << 30, shed_rate=0.3, p99_s=1.3, deadline_s=1.0, stranded_fraction=0.95,
         freshness_lag_s=0.3, freshness_slo_s=0.25, hot_hit_ratio=0.1),
    dict(t=4.0, hbm_bytes=15 << 30, shed_rate=0.0, p99_s=0.2, deadline_s=1.0, stranded_fraction=0.1,
         freshness_lag_s=0.4, freshness_slo_s=0.25, hot_hit_ratio=0.15),
    dict(t=5.0, hbm_bytes=15 << 30, shed_rate=0.0, p99_s=0.2, deadline_s=1.0, stranded_fraction=0.1),
    dict(t=6.0, hbm_bytes=17 << 30, shed_rate=0.0),
    dict(t=7.0),
]


def _verdicts(mod, spec, monkeypatch):
    monkeypatch.setattr(mod, "default_hbm_bytes", lambda: 16 * 1024**3)
    cfg = mod.parse_watchdog_spec(spec)
    wd = mod.HealthWatchdog(rules=cfg["rules"], interval_s=cfg["interval_s"], budget_bytes=16 * 1024**3)
    # no dump files from a test: the critical dump is the flight recorder's
    monkeypatch.setattr(wd, "_critical_dump", lambda rule, state: None)
    out = []
    for sample in SERIES:
        v = wd.evaluate_once(dict(sample))
        out.append({k: v[k] for k in ("status", "planes", "rules", "samples", "breaches")})
    return out


@pytest.mark.parametrize("spec", [True, "breach_for=1,clear_for=1", "oom_warn_s=100,shed_critical=0.5"], ids=repr)
def test_watchdog_verdicts_follow_the_reference(monkeypatch, spec):
    assert _verdicts(tl, spec, monkeypatch) == _verdicts(jl, spec, monkeypatch)


def test_device_ledger_matches_the_reference(monkeypatch):
    monkeypatch.delenv("PATHWAY_LEDGER", raising=False)
    monkeypatch.delenv("PATHWAY_HBM_BYTES", raising=False)
    out = []
    for mod in (jl, tl):
        led = mod.DeviceLedger()
        led.update("index.hot", "knn0", 4096, used_bytes=1024)
        led.update("weights", "encoder", 9000)
        led.update("decode.kv", "pool", 1 << 20, used_bytes=1 << 18)
        led.update("index.hot", "knn1", 2048)
        led.update("index.hot", "knn0", 0)  # freed
        led.drop_owner("encoder")
        out.append((led.snapshot(), led.accounts(), led.total_bytes(), led.active()))
    assert out[0] == out[1]


def test_budget_is_the_reference_default_without_a_card(monkeypatch):
    monkeypatch.delenv("PATHWAY_HBM_BYTES", raising=False)
    assert not torch.cuda.is_available()
    assert tl.default_hbm_bytes() == jl.default_hbm_bytes() == 16 * 1024**3
    assert tl.device_memory_bytes() is None
    monkeypatch.setenv("PATHWAY_HBM_BYTES", "3G")
    assert tl.default_hbm_bytes() == jl.default_hbm_bytes() == 3 * 1024**3


def test_budget_and_forecast_read_the_card(monkeypatch):
    """With a card, the budget is its memory and the forecast reads the
    caching allocator (a stand-in for ``torch.cuda`` reports an H100)."""
    monkeypatch.delenv("PATHWAY_HBM_BYTES", raising=False)
    h100 = 85_520_809_984
    fake = types.SimpleNamespace(
        is_available=lambda: True, is_initialized=lambda: True,
        get_device_properties=lambda i: types.SimpleNamespace(total_memory=h100),
        memory_reserved=lambda i: 7 << 30,
    )
    monkeypatch.setattr(torch, "cuda", fake)
    assert tl.default_hbm_bytes() == h100
    assert tl.device_memory_bytes() == 7 << 30
    assert tl.HealthWatchdog()._live_sample()["hbm_bytes"] == 7 << 30
    # the decode pool's budget is the card's: a pool over 16 GiB passes
    pool = DecodeConfig(pages=1 << 14, page_size=64)
    pool.check_budget(layers=4, hidden=1024)
    assert pool.pool_bytes(4, 1024) > 16 * 1024**3
    monkeypatch.setenv("PATHWAY_HBM_BYTES", "16G")
    with pytest.raises(ValueError):
        pool.check_budget(layers=4, hidden=1024)
