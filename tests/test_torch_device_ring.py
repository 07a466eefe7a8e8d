"""The port's DeviceRing against the JAX package's, on the CPU
(``tests/test_pipeline.py``'s and ``tests/test_ledger_health.py``'s ring
cases): staging and retiring, slot reuse on wrap, backpressure on a slot
that was never retired, detached snapshot copies, quiescing, the ledger's
``ring`` account, and staged contents across slots that grow and shrink.
The copy on a side stream and the event waits run only on a card
(``tests/test_torch_gpu.py``); here a slot is a plain buffer.

Tolerances: staged values, counters and bytes equal."""

from __future__ import annotations

import gc

import numpy as np
import pytest

import pathway_tpu.engine.device_ring as jring
import pathway_tpu.internals.ledger as jledger
import pathway_tpu_torch.engine.device_ring as tring
import pathway_tpu_torch.internals.ledger as tledger

RINGS = [(jring, {}), (tring, {"device": "cpu"})]
BOTH = pytest.mark.parametrize("mod,dev", RINGS, ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def _clean_ledgers():
    jledger.LEDGER.reset()
    tledger.LEDGER.reset()
    yield
    jledger.LEDGER.reset()
    tledger.LEDGER.reset()


def _values(handles):
    return [np.asarray(h.cpu() if hasattr(h, "cpu") else h).tolist() for h in handles]


def _script(mod, dev):
    """Stage / retire through two slots with payloads of changing size and
    dtype; the staged values and the ring's counters."""
    ring = mod.DeviceRing(depth=2, name="test", **dev)
    out = []
    (ha,) = ring.stage([np.arange(4, dtype=np.int32)])
    out.append(ring.in_flight())
    # callers destructure stage()'s return and pass a new list to retire
    ring.retire([ha])
    out.append(ring.in_flight())
    for i, n in enumerate((3, 7, 2, 5)):
        hs = ring.stage([np.full(n, i, np.int32), np.linspace(0, 1, n + 1).astype(np.float32)])
        out.append(_values(hs))
        ring.retire(hs)
    stats = ring.stats()
    out.append({k: stats[k] for k in ("depth", "staged", "donated", "bytes_staged", "high_water")})
    return out


def test_device_ring_stage_retire_and_reuse_follow_the_reference():
    got = _script(tring, {"device": "cpu"})
    assert got == _script(jring, {})
    assert got[:2] == [1, 0] and got[-1]["staged"] == 5


@BOTH
def test_device_ring_wrap_donates_prior_generation(mod, dev):
    ring = mod.DeviceRing(depth=2, name="test", **dev)
    for i in range(4):
        (h,) = ring.stage([np.full(3, i, np.int32)])
        ring.retire([h])
    # 4 stages through 2 slots: generations 0 and 1 were given up when
    # their slots took generations 2 and 3
    assert ring.staged == 4 and ring.donated == 2


def test_device_ring_reuses_a_retired_slot_in_place():
    """The port keeps a slot's buffers and rewrites them: a retired handle's
    storage is the one a later generation of its slot lands in."""
    ring = tring.DeviceRing(depth=2, name="test", device="cpu")
    (h0,) = ring.stage([np.arange(8, dtype=np.float32)])
    ring.retire([h0])
    (h1,) = ring.stage([np.ones(8, np.float32)])
    ring.retire([h1])
    (h2,) = ring.stage([np.full(6, 7.0, np.float32)])
    assert h2.data_ptr() == h0.data_ptr() and h2.tolist() == [7.0] * 6


@BOTH
def test_device_ring_unretired_slot_blocks_not_corrupts(mod, dev):
    ring = mod.DeviceRing(depth=2, name="test", **dev)
    (h0,) = ring.stage([np.arange(5, dtype=np.int32)])
    (h1,) = ring.stage([np.arange(5, 10, dtype=np.int32)])
    # slot 0 was never retired: staging over it first waits for the device
    (h2,) = ring.stage([np.arange(10, 15, dtype=np.int32)])
    assert _values([h1, h2]) == [[5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]
    ring.retire([h1])
    ring.retire([h2])
    # the port counts the generations its slots hold; the reference keeps
    # the overwritten h0 "in flight" for good (and a later quiesce_all
    # blocks on its deleted buffer and raises): not copied
    assert ring.in_flight() == (0 if mod is tring else 1)


@BOTH
def test_device_ring_snapshot_view_is_detached_copy(mod, dev):
    ring = mod.DeviceRing(depth=2, name="test", **dev)
    (h,) = ring.stage([np.arange(6, dtype=np.int32)])
    (view,) = ring.snapshot_view([h])
    assert isinstance(view, np.ndarray)
    for i in range(3):  # wrap the ring over h's slot twice
        (hn,) = ring.stage([np.full(6, 90 + i, np.int32)])
        ring.retire([hn])
    assert view.tolist() == list(range(6))


def test_quiesce_all_covers_registered_rings():
    ring = tring.DeviceRing(depth=2, name="test-quiesce", device="cpu")
    (h,) = ring.stage([np.arange(3, dtype=np.int32)])
    assert ring in tring.active_rings()
    tring.quiesce_all()  # must not raise or deadlock with a copy in flight
    ring.retire([h])


@pytest.mark.parametrize("mod,dev,ledger", [(jring, {}, jledger), (tring, {"device": "cpu"}, tledger)],
                         ids=["jax", "torch"])
def test_device_ring_stage_registers_exact_bytes(mod, dev, ledger):
    ring = mod.DeviceRing(depth=2, name="ledger-test", **dev)
    arr = np.zeros((16, 8), dtype=np.float32)
    handles = ring.stage([arr])
    accounts = ledger.LEDGER.accounts()
    assert accounts["ring"]["bytes"] == arr.nbytes
    assert accounts["ring"]["fragmentation"] == 0.0  # staged, not retired: in use
    ring.retire(handles)
    owner = ring._ledger_owner
    del ring, handles
    gc.collect()
    # the finalizer drops the row
    assert ledger.LEDGER.accounts().get("ring", {"bytes": 0})["bytes"] == 0
    assert ("ring", owner) not in ledger.LEDGER._rows


def test_device_ring_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the ring stages onto the card, and raises where
    there is none (it never falls back to the CPU)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tring.DeviceRing(name="no-card")
