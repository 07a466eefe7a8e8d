"""analysis.deep — the op-level deep verifier.

Where rules PWL001–PWL016 check *configuration shape*, this pass
inspects the *lowered compute*: it reconstructs the callables each
device-facing node dispatches (KNN/tiered search, paged-attention
decode step; encoder geometry arithmetically) from the graph-build-time
specs, traces the ops they run on ``meta`` tensors (:class:`.OpTrace`,
the port's counterpart of the reference's ``jax.make_jaxpr``), and runs
four analyses over the result:

- PWL017 — host-sync detector (:mod:`.host_sync`)
- PWL018 — dispatch-geometry storm predictor (:mod:`.recompile`)
- PWL019 — placement / resharding checker (:mod:`.resharding`)
- PWL020 — exactly-once / determinism auditor (:mod:`.exactly_once`)

Surfaces: ``python -m pathway_tpu_torch analyze --deep``,
``pw.run(analysis="deep")``, and ``analysis.analyze(graph, deep=True)``.
Findings are ordinary :class:`~..diagnostics.Diagnostic` records —
anchored to the dispatching node's build-time trace, suppressible per
table via ``pw.analysis.suppress()``, rendered by ``--json`` like every
other rule. This is the pre-flight gate a composed mesh/reshard run
passes before touching the card.
"""

from __future__ import annotations

from ..diagnostics import Diagnostic
from ..graph_view import GraphView
from ..rules import DEEP_RULE_IDS
from .exactly_once import check_exactly_once
from .host_sync import check_host_sync
from .recompile import check_recompile_storm
from .resharding import check_resharding
from .targets import DeepTarget, OpTrace, build_targets

__all__ = ["DEEP_RULE_IDS", "DeepTarget", "OpTrace", "analyze_deep", "build_targets"]

#: rule order mirrors the id order so output grouping is stable
DEEP_RULES = [
    check_host_sync,
    check_recompile_storm,
    check_resharding,
    check_exactly_once,
]


def analyze_deep(view_or_graph=None) -> list[Diagnostic]:
    """Run the deep rule pack over one parse graph (or a prebuilt
    :class:`GraphView`). Suppression/sorting is the caller's job —
    ``analysis.analyze(deep=True)`` applies both."""
    view = (
        view_or_graph
        if isinstance(view_or_graph, GraphView)
        else GraphView(view_or_graph)
    )
    targets = build_targets(view)
    diags: list[Diagnostic] = []
    for rule_fn in DEEP_RULES:
        diags.extend(rule_fn(view, targets))
    return diags
