"""PWL018 — dispatch-geometry storm predictor.

Every device callable in this repo is keyed on a *bucketed* shape
space: the encoder pads to (batch, seq) buckets, the KNN search to a
pow2 fetch ladder per capacity, the decode step to its fixed
(lanes, pages_per_seq) geometry plus seq-bucketed prefill. This pass
enumerates that space symbolically — per target, via the owning ops
module's ``deep_compile_profile`` hook — and compares the summed
distinct-geometry prediction against a budget
(``PATHWAY_COMPILE_BUDGET``, default 256), with the reference's
arithmetic. In the port a geometry is not a compile: each ``csrc``
source is built once by ``ops/_build.py`` whatever the shape, so what
the count bounds is the number of distinct dispatch geometries — launch
plans, workspace shapes and caching-allocator blocks — a run walks
through before its shapes settle. A dynamic dimension with *no* bucket
ladder at all is flagged unconditionally, because its geometry count is
workload-dependent and unbounded.

Tenant-packed indexes share one dispatch geometry per (dimensions,
metric) slab — that is the point of the slab — so tenant specs dedupe
to one profile per geometry instead of multiplying.

The encoder half of the model is validated against reality: the
bucket-sweep test asserts ``models.batching.predict_compile_keys``
matches the distinct geometries a real encoder dispatched
(``SentenceEncoder.dispatch_geometry_count``).
"""

from __future__ import annotations

import os

from ..diagnostics import Diagnostic
from ..graph_view import GraphView
from ..rules import _diag

__all__ = ["check_recompile_storm", "compile_budget", "DEFAULT_COMPILE_BUDGET"]

DEFAULT_COMPILE_BUDGET = 256


def compile_budget() -> int:
    raw = os.environ.get("PATHWAY_COMPILE_BUDGET", "")
    try:
        return int(raw) if raw else DEFAULT_COMPILE_BUDGET
    except ValueError:
        return DEFAULT_COMPILE_BUDGET


def _target_profile(target, mesh_axes: dict | None) -> dict:
    if target.kind == "knn":
        from ...ops.knn import deep_compile_profile

        return deep_compile_profile(target.spec, mesh_axes)
    if target.kind == "decode":
        from ...ops.paged_attention import deep_compile_profile

        return deep_compile_profile(target.spec)
    if target.kind == "encoder":
        from ...models.batching import compile_bucket_space

        enc = target.spec.get("encoder") or {}
        ndata = int((mesh_axes or {}).get("data", 1) or 1)
        n = compile_bucket_space(
            int(enc.get("max_seq_len") or 256),
            int(enc.get("max_batch") or 1024),
            mesh_ndata=ndata,
        )
        return {
            "compiles": n,
            "detail": {
                "max_seq_len": enc.get("max_seq_len"),
                "max_batch": enc.get("max_batch"),
                "mesh_ndata": ndata,
            },
            "unbucketed": [],
        }
    return {"compiles": 0, "detail": {}, "unbucketed": []}


def check_recompile_storm(view: GraphView, targets) -> list[Diagnostic]:
    ctx = getattr(view.graph, "run_context", None) or {}
    mesh_axes = ctx.get("mesh_axes")
    budget = compile_budget()
    out: list[Diagnostic] = []
    total = 0
    per_target: list[tuple[object, dict]] = []
    seen_slabs: set[tuple] = set()
    for target in targets:
        if target.kind == "knn" and target.spec.get("tenant"):
            slab_key = (
                int(target.spec.get("dimensions") or 0),
                target.spec.get("metric"),
                bool(target.spec.get("mesh")),
            )
            if slab_key in seen_slabs:
                continue  # one dispatch geometry per slab
            seen_slabs.add(slab_key)
        try:
            prof = _target_profile(target, mesh_axes)
        except Exception:
            continue
        total += int(prof.get("compiles") or 0)
        per_target.append((target, prof))
        for dim_name in prof.get("unbucketed") or ():
            out.append(
                _diag(
                    "PWL018",
                    f"device callable {target.name} has dynamic dimension "
                    f"{dim_name!r} with no bucket ladder: its dispatch "
                    "geometry count is workload-dependent and unbounded — "
                    "route the dimension through a bucket set "
                    "(models/batching.py) before it reaches a kernel "
                    "launch",
                    target.table,
                    detail={"target": target.name, "dimension": dim_name},
                )
            )
    if total > budget and per_target:
        heaviest, heavy_prof = max(
            per_target, key=lambda tp: int(tp[1].get("compiles") or 0)
        )
        breakdown = {
            t.name: int(p.get("compiles") or 0) for t, p in per_target
        }
        out.append(
            _diag(
                "PWL018",
                f"predicted distinct dispatch geometries across device "
                f"callables is {total}, over the budget of {budget} "
                "(PATHWAY_COMPILE_BUDGET): the first epochs walk through "
                "that many launch plans and allocator shapes before the "
                "run settles — shrink the bucket space (max_seq_len / "
                "max_batch / tier geometry), share tenant slabs, or "
                "raise the budget if the spread is accepted",
                heaviest.table,
                detail={
                    "predicted_compiles": total,
                    "budget": budget,
                    "per_target": breakdown,
                    "heaviest": heaviest.name,
                    "heaviest_detail": heavy_prof.get("detail") or {},
                },
            )
        )
    return out
