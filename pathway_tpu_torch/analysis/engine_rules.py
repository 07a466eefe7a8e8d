"""Rules over the lowered ``engine/dataflow.py`` ``EngineGraph``.

The logical rules in :mod:`.rules` see the user's intent; these see what
the lowerer actually built — nodes whose output reaches no output /
capture consume exchange bandwidth for nothing (PWL006 at the engine
level)."""

from __future__ import annotations

from .diagnostics import Diagnostic, Severity


def analyze_engine(engine_graph) -> list[Diagnostic]:
    """Walk a lowered EngineGraph; report nodes that feed nothing."""
    out: list[Diagnostic] = []
    sinks = set()
    for node in getattr(engine_graph, "outputs", []) or []:
        sinks.add(id(node))
    for node in getattr(engine_graph, "captures", []) or []:
        sinks.add(id(node))
    nodes = list(getattr(engine_graph, "nodes", []) or [])

    def _consumer_nodes(node):
        # Node.consumers holds (consumer, input_port) pairs
        for entry in getattr(node, "consumers", []) or []:
            yield entry[0] if isinstance(entry, tuple) else entry

    # backward reachability over consumer edges
    consumed: set[int] = set(sinks)
    changed = True
    while changed:
        changed = False
        for node in nodes:
            if id(node) in consumed:
                continue
            if any(id(c) in consumed for c in _consumer_nodes(node)):
                consumed.add(id(node))
                changed = True
    for node in nodes:
        if id(node) in consumed:
            continue
        if next(_consumer_nodes(node), None) is None:
            out.append(
                Diagnostic(
                    rule="PWL006",
                    severity=Severity.INFO,
                    message=(
                        f"engine node {node.name!r} (id {node.id}) feeds no "
                        "output or capture; its updates are computed and "
                        "exchanged for nothing"
                    ),
                    op_kind=type(node).__name__,
                    trace=getattr(node, "user_frame", None),
                )
            )
    return out
