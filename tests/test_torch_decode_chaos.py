"""The decode step's crash discipline in the port, held against the JAX engine.

``tests/test_decode_engine.py``'s chaos cases (the greedy step, the
speculative tick, the sampled step): ``decode.step`` raises between a step's
compute and its commit, the drain is retried, and every stream equals the
unkilled run's and the reference's under the same kills (the reference
with ``impl="xla"``, as its own tests run it). The port writes the step's
K/V rows into the pool in place instead of copying it, and each point of
what makes that harmless is held here: a killed step leaves the lanes'
``lens`` and tokens as they were, rows at or past ``lens`` stay masked
(garbage written there changes nothing), the retry writes the same rows
bit for bit, and no step writes into a page the prefix cache shares.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pathway_tpu.decode import DecodeConfig as JDecodeConfig
from pathway_tpu.decode import DecodeEngine as JEngine
from pathway_tpu.decode import DecoderConfig as JDecoderConfig
from pathway_tpu.decode import init_decoder_params as jinit_decoder
from pathway_tpu.resilience import chaos as jchaos
from pathway_tpu_torch.decode import DecodeConfig, DecodeEngine, DecoderConfig
from pathway_tpu_torch.resilience import chaos as tchaos
from pathway_tpu_torch.weights import from_jax_decoder_params

GEOM = dict(vocab_size=2048, hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64, max_position=96)
POOL = dict(pages=96, page_size=4, lanes=4, max_new_tokens=8, degrade_max_new_tokens=2, max_seq=80)
JPARAMS = jinit_decoder(JDecoderConfig(**GEOM), seed=0)
PARAMS = from_jax_decoder_params(JPARAMS)
_RNG = np.random.default_rng(0)
SHARED = [int(t) for t in _RNG.integers(0, 2048, 13)]
PROMPTS = [[int(t) for t in _RNG.integers(0, 2048, n)] for n in (5, 9, 3, 30)]
PROMPTS += [SHARED + [5], SHARED + [7, 9], SHARED + [7, 9], [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3]]
SAMPLED = dict(temperature=0.7, top_k=5, top_p=0.9, seed=11)
MODES = {
    "greedy": {},
    "sampled": SAMPLED,
    "spec_layer_skip": dict(spec_tokens=3, draft_layers=1),
    "spec_prompt_lookup": dict(spec_tokens=3, draft_layers=1, draft_ngram=2),
    "cache_chunks": dict(prefix_cache=True, prefill_chunk=4),
}


@pytest.fixture(autouse=True)
def _no_chaos():
    tchaos.deactivate()
    jchaos.deactivate()
    yield
    tchaos.deactivate()
    jchaos.deactivate()


def _engine(**over) -> DecodeEngine:
    return DecodeEngine(DecoderConfig(**GEOM), DecodeConfig(**{**POOL, **over}), params=PARAMS, device="cpu")


def _jengine(**over):
    return JEngine(JDecoderConfig(**GEOM), JDecodeConfig(**{**POOL, "impl": "xla", **over}), params=JPARAMS)


def _killed_drain(eng, chaos, steps) -> list:
    tickets = [eng.submit(p) for p in PROMPTS]
    chaos.activate([{"site": "decode.step", "time": s, "action": "raise"} for s in steps])
    kills = 0
    while True:
        try:
            eng.drain()
            break
        except chaos.ChaosInjected:
            kills += 1
    chaos.deactivate()
    assert kills == len(steps)
    return [t.result() for t in tickets]


@pytest.mark.parametrize("mode", list(MODES))
def test_killed_steps_then_retry_are_identical_to_the_twin_and_the_reference(mode):
    over = MODES[mode]
    steps = (1, 2) if "spec_tokens" in over else (2, 7)  # a speculative drain takes fewer ticks
    twin = _engine(**over).generate(PROMPTS)
    got = _killed_drain(_engine(**over), tchaos, steps)
    assert got == twin
    assert _killed_drain(_jengine(**over), jchaos, steps) == got


def _rows(eng, lane: int, positions) -> torch.Tensor:
    """The pool's K and V rows of ``lane`` at ``positions``, every layer."""
    ps = eng.config.page_size
    pages = [int(eng._page_tables[lane, p // ps]) for p in positions]
    offs = [p % ps for p in positions]
    return torch.stack([eng.pool.k[:, pages, offs], eng.pool.v[:, pages, offs]]).clone()


@pytest.mark.parametrize("mode", ["greedy", "sampled", "spec_layer_skip"])
def test_kill_leaves_lens_masks_its_rows_and_the_retry_rewrites_them_identically(mode):
    over = MODES[mode]
    spec = over.get("spec_tokens", 0)
    eng = _engine(**over)
    tickets = [eng.submit(p) for p in PROMPTS[:4]]
    for _ in range(1 if spec else 3):
        eng.step()
    live = [i for i, ln in enumerate(eng._lanes) if ln is not None and not ln.prefilling]
    lens = eng._lens.copy()
    tokens = [list(t.tokens) for t in tickets]
    window = {i: list(range(lens[i], lens[i] + max(1, spec))) for i in live}
    tchaos.activate([{"site": "decode.step", "time": eng.steps, "action": "raise"}])
    with pytest.raises(tchaos.ChaosInjected):
        eng.step()
    tchaos.deactivate()
    # the killed step committed nothing
    assert (eng._lens == lens).all() and [list(t.tokens) for t in tickets] == tokens
    written = {i: _rows(eng, i, window[i]) for i in live}
    # rows at or past lens are masked: garbage there changes no stream
    for i in live:
        for p in window[i]:
            page, off = int(eng._page_tables[i, p // eng.config.page_size]), p % eng.config.page_size
            eng.pool.k[:, page, off] = 1e4
            eng.pool.v[:, page, off] = -1e4
    eng.step()
    # the retry wrote the killed step's rows again, bit for bit
    for i in live:
        assert torch.equal(_rows(eng, i, window[i]), written[i]), f"lane {i}"
    eng.drain()
    assert [t.result() for t in tickets] == _engine(**over).generate(PROMPTS[:4])


@pytest.mark.parametrize("mode", ["cache_chunks", "spec_prompt_lookup"])
def test_no_step_writes_into_a_page_the_prefix_cache_shares(mode):
    over = {**MODES[mode], "prefix_cache": True}
    eng = _engine(**over)
    tickets = [eng.submit(p) for p in PROMPTS]
    checked = 0
    while eng.busy():
        shared = sorted(p for p, n in eng.pool._refs.items() if n > 1)
        before = (eng.pool.k[:, shared].clone(), eng.pool.v[:, shared].clone())
        eng.step()
        after = (eng.pool.k[:, shared], eng.pool.v[:, shared])
        assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
        checked += len(shared)
    assert checked > 0, "no page was ever shared"
    assert [t.result() for t in tickets] == _engine(**MODES[mode]).generate(PROMPTS)
