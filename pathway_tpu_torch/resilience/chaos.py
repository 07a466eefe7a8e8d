"""Deterministic fault-injection harness.

The port's copy of the reference's ``resilience/chaos.py``, the module
whole. Instrumented code calls :func:`inject` at named *sites*:

- ``engine.before_stage_commit`` / ``engine.after_stage_commit`` bracket
  the KIND_FEED write at the staging commit of the epoch pipeline
  (``engine/pipeline.py``; at ``pipeline_depth=1`` they fire at feed time)
  and ``engine.after_sink_flush`` sits between an epoch's sink flush and
  its delivered marker (``engine/dataflow.py``);
- ``connector.<name>`` starts every attempt of a reader
  (``io/_connector.py``), ``ingest.worker`` every task of the host-ingest
  stage (``ingest/stage.py``);
- ``decode.step`` sits between a decode step's compute and its commit
  (``decode/engine.py``);
- ``serving.admit`` (inside ``AdmissionController.admit``, before any shed
  decision), ``serving.before_dispatch`` (just before the adaptive batcher
  hands a fused batch to the engine) and ``serving.batch_inflight`` (after
  dispatch returns, while request futures are still pending);
- ``index.tier.promote`` fires before each chunk of a tiered index's
  promotion (``ops/tiered_knn.py``);
- ``elastic.migrate_chunk`` fires before each chunk of a live reshard
  lands on the target, ``elastic.cutover`` before the cutover and
  ``elastic.abort`` first in a reshard's rollback (``elastic/controller.py``).

The multi-process cluster (``parallel/multiprocess.py``) adds
``coordinator.after_sink_flush`` and ``coordinator.after_mark_delivered``
on process 0, ``worker.after_feed_log``, ``worker.before_advance`` and
``worker.after_advance`` on the workers, and the ``cluster.send`` channel
site that every protocol frame passes.

A *chaos plan* (rules loaded from the
``PATHWAY_CHAOS`` environment variable, or activated in-process via
:func:`activate`) decides whether a given call dies, raises, or
delays, keyed on the site name, the epoch, the persistence byte
offset, the process id and a deterministic hit counter. With no plan
active, :func:`inject` is a near-zero-cost no-op, so the sites stay in
production code paths.

Rule shape (JSON object, or a list of them, or ``{"rules": [...]}``;
``PATHWAY_CHAOS`` may hold the JSON itself or a path to a file)::

    {"site": "worker.after_feed_log",   # required, exact match
     "action": "kill",                  # kill | exit | raise | delay
     "time": 3,                         # optional: only this epoch
     "offset": 4096,                    # optional: fire once the reported
                                        #   byte offset reaches this value
     "process": 1,                      # optional: PATHWAY_PROCESS_ID
     "hit": 2,                          # optional: fire on the n-th match
     "repeat": false,                   # optional: re-arm after firing
     "code": 17,                        # exit code for action=exit
     "delay_s": 0.1}                    # for action=delay

``kill`` sends SIGKILL to the calling process (no cleanup, the crash
the recovery contract is written for); ``exit`` is ``os._exit``;
``raise`` throws :class:`ChaosInjected`, which the run supervisor
treats as restartable.

Cluster-channel fault family: the multiprocess protocol seams
(``cluster.send`` on both sides of the coordinator star) consult
:func:`channel` instead of :func:`inject` and obey a *verdict* —
``drop`` discards the frame, ``duplicate`` sends it twice,
``partition`` arms a sticky drop for ``duration_s`` seconds (default:
until the process exits), modelling a network partition; ``delay``
sleeps inline. Verdict rules never fire from :func:`inject` (a dropped
frame is meaningless at, say, a persistence site) and vice versa the
kill/raise actions still work at channel sites. Rules may additionally
key on ``"generation"`` (the PATHWAY_CLUSTER_GENERATION a process was
spawned with, default 0) so a kill rule fires in the original cluster
generation only — a partially restarted worker replays the same sites
without being re-killed, which is what makes partial-restart chaos
runs deterministic end-to-end.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time as _time
from typing import Any

_SIGNALS = {"kill": signal.SIGKILL, "term": signal.SIGTERM}

# --- static site registry -------------------------------------------------
# Every production inject()/channel() call site declares itself here (the
# deep verifier's PWL020 reads it). Keys are
# exact site names; values name the commit plane the site covers.

SITE_REGISTRY: dict[str, str] = {}


def register_site(site: str, plane: str) -> None:
    """Declare a chaos site statically (idempotent). Call at import time
    next to the code that owns the ``inject(site)`` call."""
    SITE_REGISTRY[site] = plane


def registered_sites(plane: str | None = None) -> list[str]:
    """All registered site names, optionally filtered by plane prefix."""
    if plane is None:
        return sorted(SITE_REGISTRY)
    return sorted(s for s, p in SITE_REGISTRY.items() if p.startswith(plane))


for _site, _plane in (
    ("engine.before_stage_commit", "pipeline"),
    ("engine.after_stage_commit", "pipeline"),
    ("serving.admit", "serving"),
    ("serving.before_dispatch", "serving"),
    ("serving.batch_inflight", "serving"),
    ("ingest.worker", "ingest"),
    ("index.tier.promote", "index"),
    ("elastic.migrate_chunk", "elastic"),
    ("elastic.cutover", "elastic"),
    ("elastic.abort", "elastic"),
):
    register_site(_site, _plane)
del _site, _plane
# channel verdict actions apply only at sites that call channel()
_CHANNEL_ACTIONS = ("drop", "duplicate", "partition")
_ACTIONS = ("kill", "term", "exit", "raise", "delay") + _CHANNEL_ACTIONS


class ChaosInjected(RuntimeError):
    """Scripted failure thrown by a chaos rule with ``action="raise"``."""


class ChaosPlan:
    """A compiled set of chaos rules with per-rule hit state."""

    def __init__(self, rules: list[dict[str, Any]]) -> None:
        self.rules: list[dict[str, Any]] = []
        for rule in rules:
            rule = dict(rule)
            if "site" not in rule:
                raise ValueError(f"chaos rule missing 'site': {rule!r}")
            action = rule.setdefault("action", "raise")
            if action not in _ACTIONS:
                raise ValueError(
                    f"chaos rule action {action!r}: expected one of {_ACTIONS}"
                )
            rule["_hits"] = 0
            rule["_done"] = False
            rule["_partition_until"] = None
            self.rules.append(rule)
        # stable material for deterministic_seed(): the user-visible
        # rule fields only, independent of runtime hit state
        self.seed_material = json.dumps(
            [
                {k: v for k, v in r.items() if not k.startswith("_")}
                for r in self.rules
            ],
            sort_keys=True,
        ).encode()

    @classmethod
    def from_spec(cls, spec: Any) -> "ChaosPlan":
        if isinstance(spec, dict) and "rules" in spec:
            spec = spec["rules"]
        if isinstance(spec, dict):
            spec = [spec]
        if not isinstance(spec, list):
            raise ValueError(f"chaos spec: expected object or list, got {type(spec)}")
        return cls(spec)

    def _matches(
        self, rule: dict[str, Any], site: str, time: int | None, offset: int | None
    ) -> bool:
        if rule["site"] != site:
            return False
        if "process" in rule:
            pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
            if int(rule["process"]) != pid:
                return False
        if "time" in rule:
            if time is None or int(time) != int(rule["time"]):
                return False
        if "offset" in rule:
            # byte offsets grow monotonically within a log; fire the
            # first time the instrumented site reports reaching it
            if offset is None or int(offset) < int(rule["offset"]):
                return False
        if "generation" in rule:
            gen = int(os.environ.get("PATHWAY_CLUSTER_GENERATION", "0") or 0)
            if int(rule["generation"]) != gen:
                return False
        return True

    def fire(self, site: str, time: int | None, offset: int | None) -> None:
        for rule in self.rules:
            if rule["action"] in _CHANNEL_ACTIONS:
                continue  # verdict rules only apply via channel()
            if rule["_done"] or not self._matches(rule, site, time, offset):
                continue
            rule["_hits"] += 1
            if rule["_hits"] < int(rule.get("hit", 1)):
                continue
            if not rule.get("repeat", False):
                rule["_done"] = True
            else:
                rule["_hits"] = 0
            self._act(rule, site, time, offset)

    def channel(
        self, site: str, time: int | None, offset: int | None
    ) -> str | None:
        """Verdict for one protocol frame at a channel site: ``"drop"``,
        ``"duplicate"``, or None (deliver normally). An armed partition
        drops every matching frame until it expires; kill/raise/delay
        rules at channel sites act exactly as they would via inject()."""
        from ..internals import flight_recorder

        verdict: str | None = None
        for rule in self.rules:
            until = rule["_partition_until"]
            if until is not None:
                if _time.monotonic() < until and rule["site"] == site:
                    verdict = "drop"
                continue
            if rule["_done"] or not self._matches(rule, site, time, offset):
                continue
            rule["_hits"] += 1
            if rule["_hits"] < int(rule.get("hit", 1)):
                continue
            if not rule.get("repeat", False):
                rule["_done"] = True
            else:
                rule["_hits"] = 0
            action = rule["action"]
            if action == "partition":
                duration = float(rule.get("duration_s", 1e9))
                rule["_partition_until"] = _time.monotonic() + duration
                flight_recorder.record(
                    "chaos.hit",
                    site=site,
                    action="partition",
                    t=time,
                    duration_s=duration,
                )
                verdict = "drop"
            elif action in ("drop", "duplicate"):
                flight_recorder.record(
                    "chaos.hit", site=site, action=action, t=time
                )
                verdict = action
            else:
                self._act(rule, site, time, offset)
        return verdict

    def _act(
        self, rule: dict[str, Any], site: str, time: int | None, offset: int | None
    ) -> None:
        from ..internals import flight_recorder

        action = rule["action"]
        flight_recorder.record(
            "chaos.hit", site=site, action=action, t=time, offset=offset
        )
        if action in _SIGNALS:
            # the injector runs in-process, so this is the last chance
            # to preserve evidence: dump the ring before the signal
            flight_recorder.dump(f"chaos.{action}", ChaosInjected(site))
            os.kill(os.getpid(), _SIGNALS[action])
            # SIGKILL is not deliverable to ourselves synchronously on
            # every platform; make sure we do not keep running
            _time.sleep(5.0)
            os._exit(int(rule.get("code", 17)))
        if action == "exit":
            flight_recorder.dump("chaos.exit", ChaosInjected(site))
            os._exit(int(rule.get("code", 17)))
        if action == "delay":
            _time.sleep(float(rule.get("delay_s", 0.1)))
            return
        raise ChaosInjected(
            f"chaos[{rule.get('id', rule['site'])}]: site={site} "
            f"time={time} offset={offset}"
        )


_lock = threading.Lock()
_active: ChaosPlan | None = None
_env_loaded = False


def activate(plan: ChaosPlan | list[dict[str, Any]] | dict[str, Any] | None) -> None:
    """Install a plan in-process (tests); ``None`` deactivates."""
    global _active, _env_loaded
    with _lock:
        if plan is not None and not isinstance(plan, ChaosPlan):
            plan = ChaosPlan.from_spec(plan)
        _active = plan
        _env_loaded = True  # explicit activation overrides the env


def deactivate() -> None:
    activate(None)


def reload_env() -> None:
    """Forget any active plan and re-read PATHWAY_CHAOS on the next
    :func:`inject` (tests that set the env var after import)."""
    global _active, _env_loaded
    with _lock:
        _active = None
        _env_loaded = False


def _load_env() -> None:
    global _active, _env_loaded
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
        spec = os.environ.get("PATHWAY_CHAOS")
        if not spec:
            return
        if os.path.exists(spec):
            with open(spec) as f:
                spec = f.read()
        _active = ChaosPlan.from_spec(json.loads(spec))


def armed(site: str | None = None) -> bool:
    """True when a plan is active (with ``site``: when one of its rules
    names that site). A site whose arguments cost something to compute (a
    log's byte offset, a stat of the file) computes them only then."""
    if not _env_loaded:
        _load_env()
    plan = _active
    if plan is None:
        return False
    return site is None or any(rule["site"] == site for rule in plan.rules)


def inject(site: str, *, time: int | None = None, offset: int | None = None) -> None:
    """Chaos hook: no-op unless an active rule matches this call."""
    if not _env_loaded:
        _load_env()
    plan = _active
    if plan is None:
        return
    plan.fire(site, time, offset)


def channel(
    site: str, *, time: int | None = None, offset: int | None = None
) -> str | None:
    """Channel-fault hook for the cluster protocol seams: returns
    ``"drop"`` / ``"duplicate"`` / None for this frame. No-op (None)
    without an active plan."""
    if not _env_loaded:
        _load_env()
    plan = _active
    if plan is None:
        return None
    return plan.channel(site, time, offset)


def deterministic_seed() -> int | None:
    """A stable per-process seed derived from the active chaos spec.

    Same plan + same PATHWAY_PROCESS_ID -> same seed, so every jitter
    source that defaults to it (``RetryPolicy`` without an explicit
    ``seed=``/``rng=``) replays identically across chaos re-runs.
    None when no plan is active (normal runs keep real entropy)."""
    if not _env_loaded:
        _load_env()
    plan = _active
    if plan is None:
        return None
    import zlib

    pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
    return (zlib.crc32(plan.seed_material) ^ (pid * 0x9E3779B1)) & 0xFFFFFFFF
