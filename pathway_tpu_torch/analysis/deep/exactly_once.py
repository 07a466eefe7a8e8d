"""PWL020 — exactly-once / determinism auditor.

The recovery contract replays epochs from the last durable cut, which
is only exactly-once if (a) every effectful node has a failure route
the replay can reason about, and (b) replayed compute is
deterministic. This pass walks the graph's effectful surface in a run
with recovery/persistence on:

- an async UDF / AsyncTransformer with ``on_error="raise"`` (no
  ``_pw_on_error`` route): a mid-epoch invoke failure aborts the epoch
  with external side effects already issued — on replay they issue
  again. The dead-letter route (the default the node opted out of)
  is what makes the retry idempotent from the graph's perspective.
- an effectful node whose commit plane has no registered chaos site
  (``resilience.chaos.SITE_REGISTRY``): the exactly-once claim for
  that plane is untestable — no chaos run can exercise a crash at its
  commit point, so nothing guards the contract against regression.
- a default-``deterministic`` sync UDF upstream of persisted state
  whose bytecode reads wall clock or unseeded RNG: replay recomputes
  the value and commits a *different* one than the pre-crash epoch
  persisted. Either seed the randomness, or declare
  ``deterministic=False`` so the engine memoizes and replays recorded
  outputs instead of recomputing.
"""

from __future__ import annotations

from typing import Any

from ...internals.expression import ApplyExpression, AsyncApplyExpression
from ..diagnostics import Diagnostic
from ..graph_view import GraphView, expr_applies, iter_param_exprs
from ..rules import _diag, _unwrap_fn, _user_fn

__all__ = ["check_exactly_once"]

#: attribute/function names that read wall clock
_WALL_CLOCK_NAMES = frozenset(
    {"time", "time_ns", "monotonic", "perf_counter", "now", "utcnow", "today"}
)
#: shared/unseeded RNG entry points
_RNG_NAMES = frozenset(
    {
        "random",
        "randint",
        "randrange",
        "uniform",
        "gauss",
        "shuffle",
        "choice",
        "choices",
        "sample",
        "uuid4",
        "uuid1",
        "urandom",
        "token_hex",
        "token_bytes",
    }
)
#: modules whose presence makes the name sets above meaningful
_CLOCK_MODULES = frozenset({"time", "datetime"})
_RNG_MODULES = frozenset({"random", "uuid", "secrets", "os", "numpy.random"})


def _nondeterminism_markers(fn: Any) -> list[str]:
    inner = _unwrap_fn(fn)
    code = getattr(inner, "__code__", None)
    if code is None:
        return []
    names = set(code.co_names)
    fn_globals = getattr(inner, "__globals__", {})

    def _mod(n: str) -> str:
        v = fn_globals.get(n)
        return getattr(v, "__name__", "") if type(v).__name__ == "module" else ""

    mods = {_mod(n) for n in code.co_names}
    markers: list[str] = []
    if names & _WALL_CLOCK_NAMES and mods & _CLOCK_MODULES:
        markers.extend(sorted(names & _WALL_CLOCK_NAMES))
    if names & _RNG_NAMES and mods & _RNG_MODULES:
        markers.extend(sorted(names & _RNG_NAMES))
    return markers


def check_exactly_once(view: GraphView, targets) -> list[Diagnostic]:
    ctx = getattr(view.graph, "run_context", None) or {}
    durable = bool(ctx.get("recovery")) or bool(ctx.get("persistence"))
    if not durable:
        return []
    from ...resilience.chaos import registered_sites

    persisted = view.reachable_from_outputs()
    out: list[Diagnostic] = []
    seen_fns: set[int] = set()
    for t in view.tables:
        for key, expr in iter_param_exprs(t._op.params):
            for ap in expr_applies(expr):
                if not isinstance(ap, ApplyExpression):
                    continue
                if isinstance(ap, AsyncApplyExpression):
                    fn = ap._fn
                    name = getattr(
                        _unwrap_fn(fn), "__name__", getattr(fn, "__name__", "udf")
                    )
                    if getattr(ap, "_pw_on_error", None) is None:
                        out.append(
                            _diag(
                                "PWL020",
                                f"effectful async node {name!r} runs under "
                                "recovery/persistence with on_error="
                                "'raise': a mid-epoch failure replays "
                                "side effects that already happened — "
                                "route failures to a dead-letter table "
                                "(on_error='dead_letter', the default) "
                                "or 'skip'",
                                t,
                                detail={"param": key, "udf": name},
                            )
                        )
                    if not registered_sites("udf"):
                        out.append(
                            _diag(
                                "PWL020",
                                f"effectful async node {name!r} has no "
                                "registered chaos site on its commit "
                                "plane ('udf'): the exactly-once claim "
                                "for this node cannot be exercised by a "
                                "chaos run — register the commit point "
                                "via resilience.chaos.register_site",
                                t,
                                detail={"param": key, "udf": name},
                            )
                        )
                    continue
                # sync UDFs: determinism under replay
                if not getattr(ap, "_deterministic", True):
                    continue  # engine memoizes and replays outputs
                if t._id not in persisted:
                    continue  # never reaches persisted state
                fn = _user_fn(ap)
                if fn is None or id(fn) in seen_fns:
                    continue
                seen_fns.add(id(fn))
                markers = _nondeterminism_markers(fn)
                if markers:
                    name = getattr(fn, "__name__", "udf")
                    out.append(
                        _diag(
                            "PWL020",
                            f"UDF {name!r} reads "
                            f"{', '.join(markers)} upstream of persisted "
                            "state in a recovery run: replay recomputes "
                            "a different value than the one the crashed "
                            "epoch persisted — seed the randomness, "
                            "take the timestamp from the stream, or "
                            "declare deterministic=False so the engine "
                            "replays memoized outputs",
                            t,
                            detail={"param": key, "markers": markers},
                        )
                    )
    return out
