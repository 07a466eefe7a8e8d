"""Decode-plane metrics: the ``pathway_decode_*`` family.

The port's copy of the reference's ``decode/metrics.py``, with the same
contract as ``serving/metrics.py``: a process-wide singleton the engine
records into (tokens, prefills, steps, preemptions, the pool and live
lanes, prefix-cache hits and speculative acceptance). ``active`` is true
once the decode plane has done anything, and the prefix and speculative
keys appear in ``snapshot`` only once those features recorded something.
"""

from __future__ import annotations

import threading
from typing import Any

from ..serving.metrics import StageHistogram

__all__ = ["DecodeMetrics", "DECODE_METRICS", "DECODE_STAGES"]

#: step-latency histogram stages
DECODE_STAGES = ("prefill", "decode_step")

#: EWMA smoothing for the sustained tokens/s gauge
_ALPHA = 0.3


class DecodeMetrics:
    """Counters/gauges/histograms for the continuous-batching decoder."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.tokens_total = 0
            self.prefill_total = 0
            self.steps_total = 0
            self.preempted_total = 0
            self.degraded_total = 0
            self.queries_total = 0
            self.kv_pages_in_use = 0
            self.kv_page_pool = 0
            self.active_lanes = 0
            self.tokens_per_second = 0.0
            self.prefix_hit_pages_total = 0
            self.prefix_miss_pages_total = 0
            self.prefix_cached_pages = 0
            self.spec_proposed_total = 0
            self.spec_accepted_total = 0
            self.stages = {s: StageHistogram() for s in DECODE_STAGES}

    # -- recording (engine side) --

    def record_query(self, *, degraded: bool = False) -> None:
        with self._lock:
            self.queries_total += 1
            if degraded:
                self.degraded_total += 1

    def record_prefill(self, tokens: int, seconds: float) -> None:
        """One prefill of ``tokens`` prompt tokens (emits the first
        generated token, which is what the rate gauge counts)."""
        with self._lock:
            self.prefill_total += 1
            self.tokens_total += 1
            self.stages["prefill"].observe(seconds)
            self._blend_rate(1, seconds)

    def record_step(self, tokens: int, seconds: float) -> None:
        """One fused decode step that emitted ``tokens`` new tokens
        across all live lanes."""
        with self._lock:
            self.steps_total += 1
            self.tokens_total += int(tokens)
            self.stages["decode_step"].observe(seconds)
            self._blend_rate(int(tokens), seconds)

    def record_preempt(self) -> None:
        with self._lock:
            self.preempted_total += 1

    def record_prefix(self, hit_pages: int, miss_pages: int) -> None:
        """One prefix-cache lookup: ``hit_pages`` prompt pages mapped
        from the cache, ``miss_pages`` pages that had to be prefilled.
        Only ever called with the cache enabled, so the off path keeps
        these counters at zero and the scrape byte-identical."""
        with self._lock:
            self.prefix_hit_pages_total += int(hit_pages)
            self.prefix_miss_pages_total += int(miss_pages)

    def set_cached_pages(self, n: int) -> None:
        with self._lock:
            self.prefix_cached_pages = int(n)

    def record_spec(self, proposed: int, accepted: int) -> None:
        """One speculative tick: the draft proposed ``proposed`` tokens
        across live lanes, of which ``accepted`` matched the target's
        argmax (bonus tokens are not counted — the rate is a pure
        draft-quality signal)."""
        with self._lock:
            self.spec_proposed_total += int(proposed)
            self.spec_accepted_total += int(accepted)

    def set_pool(self, in_use: int, total: int) -> None:
        with self._lock:
            self.kv_pages_in_use = int(in_use)
            self.kv_page_pool = int(total)

    def set_active_lanes(self, n: int) -> None:
        with self._lock:
            self.active_lanes = int(n)

    def _blend_rate(self, tokens: int, seconds: float) -> None:
        # caller holds the lock
        if seconds <= 0.0 or tokens <= 0:
            return
        rate = tokens / seconds
        if self.tokens_per_second == 0.0:
            self.tokens_per_second = rate
        else:
            self.tokens_per_second = (
                1.0 - _ALPHA
            ) * self.tokens_per_second + _ALPHA * rate

    # -- export side --

    def active(self) -> bool:
        """True once the decode plane has done anything — the gate that
        keeps non-decode deployments' scrape output byte-identical."""
        with self._lock:
            return bool(
                self.queries_total
                or self.prefill_total
                or self.steps_total
                or self.preempted_total
            )

    def prefix_hit_ratio(self) -> float:
        """Fraction of looked-up prompt pages served from the cache."""
        with self._lock:
            seen = self.prefix_hit_pages_total + self.prefix_miss_pages_total
            return self.prefix_hit_pages_total / seen if seen else 0.0

    def spec_acceptance_rate(self) -> float:
        """Fraction of draft proposals the target model confirmed."""
        with self._lock:
            if not self.spec_proposed_total:
                return 0.0
            return self.spec_accepted_total / self.spec_proposed_total

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            # Prefix-cache and speculative keys appear only once those
            # features have recorded something: a cache-off / spec-off
            # deployment's /status block and /metrics scrape stay
            # byte-identical to the pre-feature surface.
            extra: dict[str, Any] = {}
            seen = self.prefix_hit_pages_total + self.prefix_miss_pages_total
            if seen:
                extra["prefix_hit_pages_total"] = self.prefix_hit_pages_total
                extra["prefix_miss_pages_total"] = self.prefix_miss_pages_total
                extra["prefix_cached_pages"] = self.prefix_cached_pages
                extra["prefix_hit_ratio"] = round(
                    self.prefix_hit_pages_total / seen, 4
                )
            if self.spec_proposed_total:
                extra["spec_proposed_total"] = self.spec_proposed_total
                extra["spec_accepted_total"] = self.spec_accepted_total
                extra["spec_acceptance_rate"] = round(
                    self.spec_accepted_total / self.spec_proposed_total, 4
                )
            return {
                "tokens_total": self.tokens_total,
                "prefill_total": self.prefill_total,
                "steps_total": self.steps_total,
                "preempted_total": self.preempted_total,
                "degraded_total": self.degraded_total,
                "queries_total": self.queries_total,
                "kv_pages_in_use": self.kv_pages_in_use,
                "kv_page_pool": self.kv_page_pool,
                "active_lanes": self.active_lanes,
                "tokens_per_second": round(self.tokens_per_second, 3),
                "stage_latency_s": {
                    stage: {"count": h.count, "sum": round(h.total, 6)}
                    for stage, h in self.stages.items()
                    if h.count
                },
                **extra,
            }


#: process-wide singleton (one decode plane per process, like serving)
DECODE_METRICS = DecodeMetrics()
