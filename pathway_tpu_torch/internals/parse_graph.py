"""Global parse graph.

Rebuild of upstream Pathway's python/pathway/internals/parse_graph.py
(ParseGraph :104, global G :244). Tables register themselves; pw.run /
debug helpers tree-shake from requested outputs."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:
    from .table import Table


class ParseGraph:
    def __init__(self):
        self.tables: list["Table"] = []
        self.outputs: list[tuple["Table", dict]] = []  # (table, sink spec)
        self.subscriptions: list[dict] = []
        self.error_log_tables: list["Table"] = []
        # pw.run() records its effective observability/resilience args
        # here before building anything; analysis rules that reason
        # about *run* configuration (PWL007/PWL008) read it off the graph
        self.run_context: dict | None = None
        # serving endpoints built in this program (rest_connector /
        # llm servers): {"route", "kind", "protected"} records for
        # PWL008 (endpoint without overload protection)
        self.serving_endpoints: list[dict] = []
        # device-backed index specs registered at query-build time
        # ({"dimensions", "reserved_space", ...}): PWL010 sizes their
        # HBM footprint against the per-device budget without building
        # or allocating anything
        self.external_indexes: list[dict] = []
        # HTTP LLM call sites built into this program's expressions
        # ({"kind": "llm_reranker" | "llm_chat", "model": ...}): PWL013
        # flags these when a device decode config makes the on-chip
        # rerank/generate path available
        self.llm_endpoints: list[dict] = []
        # bumped on every clear(): per-program caches (e.g. the shared
        # utc_now clock table) key on this so a cleared graph never
        # serves tables built for a discarded program
        self.generation = 0

    def register(self, table: "Table") -> None:
        self.tables.append(table)

    def add_output(self, table: "Table", sink: dict) -> None:
        self.outputs.append((table, sink))

    def add_subscription(self, spec: dict) -> None:
        self.subscriptions.append(spec)

    def clear(self) -> None:
        self.tables.clear()
        self.outputs.clear()
        self.subscriptions.clear()
        self.error_log_tables.clear()
        self.run_context = None
        self.serving_endpoints.clear()
        self.external_indexes.clear()
        self.llm_endpoints.clear()
        self.generation += 1


G = ParseGraph()


def clear_graph() -> None:
    """pw.parse_graph clear for tests (reference G.clear())."""
    G.clear()
