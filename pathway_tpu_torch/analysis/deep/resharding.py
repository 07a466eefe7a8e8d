"""PWL019 — placement / resharding checker.

Propagates placement intents along the producer→consumer edges of the
device-facing nodes and flags the two silent-collective hazards:

1. **cross-mesh resharding** — an index pinned to an explicit mesh
   whose axes differ from the run mesh: every staged batch crosses
   mesh boundaries: a copy between cards (or through the host) the
   author never asked for.
2. **host bounce** — a mesh-sharded consumer fed by staging that is
   not on that mesh: the port stages onto the run mesh exactly
   when one exists (``engine.device_ring.staging_placement``), so an
   index sharded via its own ``mesh=`` in a run *without* a mesh gets
   every epoch's payload via host. The ingest pool
   (``ingest.stage.placement_intent``) produces host buffers by
   design — its single committer is the one doing the ring staging —
   so a pool alone is fine; it only compounds the finding's cost.

Placement facts come from the declarative hooks in the owning modules
rather than being re-derived here, so when the staging strategy
changes, the verifier follows automatically.
"""

from __future__ import annotations

from ..diagnostics import Diagnostic
from ..graph_view import GraphView
from ..rules import _diag

__all__ = ["check_resharding"]


def _norm_axes(axes: dict | None) -> dict | None:
    if not axes:
        return None
    out = {"data": int(axes.get("data", 1) or 1), "model": int(axes.get("model", 1) or 1)}
    if out == {"data": 1, "model": 1}:
        return None  # a 1x1 mesh is no mesh
    return out


def check_resharding(view: GraphView, targets) -> list[Diagnostic]:
    ctx = getattr(view.graph, "run_context", None) or {}
    run_axes = _norm_axes(ctx.get("mesh_axes"))
    from ...engine.device_ring import staging_placement
    from ...ingest.stage import placement_intent

    ring = staging_placement(run_axes)
    pool = placement_intent(int(ctx.get("ingest_workers") or 0))
    out: list[Diagnostic] = []
    for target in targets:
        if target.kind != "knn":
            continue
        idx_axes = _norm_axes(target.spec.get("mesh_axes"))
        if idx_axes is None:
            continue  # index follows the run mesh: placement agrees
        if run_axes is not None and idx_axes != run_axes:
            out.append(
                _diag(
                    "PWL019",
                    f"index {target.name} is pinned to mesh {idx_axes} but "
                    f"the run mesh is {run_axes}: every staged batch is "
                    "implicitly resharded across meshes (all-to-all or "
                    "host gather) on the query/ingest path — use one "
                    "mesh, or drop the per-index mesh= so it follows "
                    "pw.run(mesh=...)",
                    target.table,
                    detail={
                        "index_mesh": idx_axes,
                        "run_mesh": run_axes,
                        "staging": ring,
                    },
                )
            )
        elif run_axes is None and not ring["sharded"]:
            msg = (
                f"index {target.name} is sharded over mesh {idx_axes} but "
                "the run has no mesh: DeviceRing staging lands payloads "
                "on the default device and the engine bounces them "
                "through host onto the index shards every epoch — pass "
                "the same mesh to pw.run(mesh=...) / PATHWAY_MESH so "
                "staging is mesh-aware"
            )
            if pool["workers"] > 0:
                msg += (
                    f" (the {pool['workers']}-worker ingest pool makes "
                    "this worse: its committer re-stages each batch "
                    "host-side before the bounce)"
                )
            out.append(
                _diag(
                    "PWL019",
                    msg,
                    target.table,
                    detail={
                        "index_mesh": idx_axes,
                        "run_mesh": None,
                        "staging": ring,
                        "ingest_pool": pool,
                    },
                )
            )
    return out
