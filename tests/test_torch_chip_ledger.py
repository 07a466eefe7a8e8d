"""The port's chip-time ledger against the JAX package's, on the CPU.

The same bookings (explicit seconds), stall notes and tenant mirrors go
into a fresh ledger of each package: the snapshots over an injected wall
are equal (accounts, dispatches, shares, render order, stranded causes,
tenant shares), and so are the ``pathway_chip_*`` lines of ``/metrics``.
Neither reads a clock for what is compared. The port's own parts are held
here too: the card's bf16 peak for the MFU column, the CPU fallback of a
booking, and the nested-dispatch dedup.

Tolerances: every value equal."""

from __future__ import annotations

import pytest

from pathway_tpu.internals import chip_ledger as jcl
from pathway_tpu.internals import http_monitoring as jhm
from pathway_tpu.serving.metrics import SERVING_METRICS as JSERVING
from pathway_tpu_torch.internals import chip_ledger as tcl
from pathway_tpu_torch.internals import http_monitoring as thm
from pathway_tpu_torch.serving.metrics import SERVING_METRICS as TSERVING

# (account, seconds, tenant) bookings in the order a run would make them
BOOKINGS = [
    ("encode", 0.125, None),
    ("index.search", 0.0031, None),
    ("rerank", 0.0204, "acme"),
    ("decode", 0.75, "globex"),
    ("decode.draft", 0.05, None),
    ("decode.verify", 0.2, "acme"),
    ("compile", 1.5, None),
    ("rag.fused", 0.01, None),
    ("index.merge", 0.0007, None),
    ("encode", 0.25, "acme"),
]


def _book(mod, script, *, stalls=(), tenants=()):
    ledger = mod.ChipTimeLedger()
    ledger.set_enabled(True)
    for account, seconds, tenant in script:
        ledger.book(account, seconds, tenant=tenant)
    for cause, seconds in stalls:
        ledger.note_stall(cause, seconds)
    for tenant, seconds in tenants:
        ledger.book_tenant(tenant, seconds)
    return ledger


SCRIPTS = {
    "accounts": dict(script=BOOKINGS),
    "stalls": dict(script=BOOKINGS, stalls=[("host_prep", 0.4), ("barrier", 0.3), ("custom", 9.0)]),
    "tenants": dict(script=BOOKINGS, tenants=[("initech", 0.5), ("acme", 0.1)]),
    "one_account": dict(script=[("index.search", 0.002, None)] * 7),
    "unknown_accounts": dict(script=[("zeta", 0.1, None), ("alpha", 0.2, None), ("encode", 0.3, None)]),
}


@pytest.fixture(autouse=True)
def _quiet_serving():
    # the stranded causes read each package's serving queue histogram
    JSERVING.reset()
    TSERVING.reset()
    yield
    JSERVING.reset()
    TSERVING.reset()


@pytest.mark.parametrize("wall", [None, 0.5, 10.0], ids=["no_wall", "wall_under_busy", "wall_10s"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_snapshot_matches_the_reference(name, wall):
    kw = SCRIPTS[name]
    wall_s = 0.0 if wall is None else wall
    want = _book(jcl, **kw).snapshot(wall_s=wall_s)
    got = _book(tcl, **kw).snapshot(wall_s=wall_s)
    assert got == want
    assert list(got["accounts"]) == list(want["accounts"])  # render order


def test_off_ledger_books_nothing_and_renders_nothing(monkeypatch):
    monkeypatch.delenv("PATHWAY_CHIP_LEDGER", raising=False)
    for mod in (jcl, tcl):
        ledger = mod.ChipTimeLedger()
        assert not ledger.on()
        ledger.book("encode", 1.0)
        ledger.note_stall("host_prep", 1.0)
        with ledger.timed("decode"):
            pass
        assert not ledger.active()
    monkeypatch.setenv("PATHWAY_CHIP_LEDGER", "yes")
    assert tcl.ChipTimeLedger().on() and jcl.ChipTimeLedger().on()


@pytest.mark.parametrize("name", ["stalls", "tenants", "accounts"])
def test_metrics_lines_match_the_reference(monkeypatch, name):
    kw = SCRIPTS[name]
    monkeypatch.setattr(jcl, "CHIP_LEDGER", _book(jcl, **kw))
    monkeypatch.setattr(tcl, "CHIP_LEDGER", _book(tcl, **kw))
    # the stranded residual runs against the booking window: pin it
    for mod in (jcl, tcl):
        snap = mod.CHIP_LEDGER.snapshot

        monkeypatch.setattr(mod.CHIP_LEDGER, "snapshot", lambda wall_s=None, snap=snap: snap(wall_s=7.5))
    want = jhm.MonitoringHttpServer._chip_lines('worker="0"')
    got = thm.MonitoringHttpServer._chip_lines('worker="0"')
    assert got == want and any(line.startswith("pathway_chip_stranded_fraction") for line in got)


def test_nested_booking_is_not_double_counted():
    ledger = tcl.ChipTimeLedger()
    ledger.set_enabled(True)
    with ledger.timed("encode"):
        ledger.book("compile", 3600.0)  # booked inside: more than the block's wall
    snap = ledger.snapshot(wall_s=4000.0)
    assert snap["accounts"]["encode"] == {"seconds": 0.0, "dispatches": 1, "share": 0.0}
    assert snap["accounts"]["compile"]["seconds"] == 3600.0


def test_a_cpu_block_books_its_wall():
    ledger = tcl.ChipTimeLedger()
    ledger.set_enabled(True)
    assert tcl._cuda_devices("cpu") == [] and tcl._cuda_devices(None) == []
    with ledger.timed("index.search", device="cpu"):
        sum(range(1000))
    row = ledger.snapshot(wall_s=1.0)["accounts"]["index.search"]
    assert row["dispatches"] == 1 and row["seconds"] >= 0.0


def test_peak_is_the_cards_and_not_the_tpus(monkeypatch):
    monkeypatch.delenv("PATHWAY_CHIP_PEAK_TFLOPS", raising=False)
    assert jcl.chip_peak_tflops() == 200.0  # the reference's TPU default
    assert tcl.card_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tcl.card_peak_tflops("some other card") is None
    # no card on this machine: no peak, so no MFU column
    assert tcl.chip_peak_tflops() is None
    monkeypatch.setenv("PATHWAY_CHIP_PEAK_TFLOPS", "123.5")
    assert tcl.chip_peak_tflops() == 123.5
    monkeypatch.setenv("PATHWAY_CHIP_PEAK_TFLOPS", "nonsense")
    assert tcl.chip_peak_tflops() is None
    assert _book(tcl, script=BOOKINGS).snapshot(wall_s=5.0).get("encode_mfu") is None
