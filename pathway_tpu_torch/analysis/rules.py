"""The initial rule pack of the pre-execution graph verifier.

The port's copy of the reference's ``analysis/rules.py``: the same ids,
severities, detail keys, messages and order, read over the port's parse
graph and run context. PWL004 reads torch where the reference reads JAX
(ROADMAP Queue C, "Deliberate differences"), and the HBM budget of
PWL010/012/015/016/023 is ``PATHWAY_HBM_BYTES``, else the card's memory,
else the reference's 16 GiB without a card.

Every rule has a stable id (``PWL001``…), walks the logical parse graph
(see :mod:`.graph_view`), and yields :class:`..analysis.Diagnostic`
records anchored to the offending operator's build-time call site.

Rules
-----
PWL001 (error)   dtype consistency across operator boundaries: join key
                 dtype mismatches, non-bool filter predicates, concat /
                 update columns whose concrete types do not unify.
PWL002 (error)   unbounded state: groupby/join/deduplicate fed by a
                 streaming connector with no window grouping and no
                 state-bounding temporal behavior (cutoff/freeze).
PWL003 (warning) shard safety: UDFs capturing mutable globals or
                 closures, non-deterministic expressions routing keys
                 through ``shard_of_value``, reducers that are not
                 commutative/associative per the engine registry.
PWL004 (warning) batched UDF purity: batched UDFs that close over a
                 torch trace value (an fx Proxy or a FakeTensor:
                 error), apply host numpy to torch tensors, or perform
                 Python side effects.
PWL005 (info)    dead columns: columns never read by any consumer on
                 the way to an output (wasted exchange bandwidth).
PWL006 (info)    unconnected tables/nodes: built but feeding no output.
PWL007 (warning) recovery enabled with monitoring fully off.
PWL008 (warning) serving endpoint without overload protection in a run
                 configured for resilience/throughput (recovery or
                 pipeline_depth>1): no admission control, deadlines or
                 load shedding on the query path.
PWL009 (warning) multi-worker run without a cluster fault domain:
                 recovery off (one worker crash kills the whole run) or
                 heartbeats disabled (cluster_lease_ms=0: a hung or
                 partitioned worker stalls every epoch forever).
PWL010 (warning) device-backed index larger than a single device's HBM
                 budget in a run without a mesh: the first growth past
                 the budget OOMs mid-stream — shard it with
                 pw.run(mesh=...) / PATHWAY_MESH.
PWL011 (warning) host-bound ingest: a streaming connector feeds a
                 device-backed model/index with pipeline_depth<=1 and
                 no collaborative ingest stage — tokenize/pack/resolve
                 runs serially in line with device dispatch, starving
                 the chip. pw.run(ingest_workers=N) /
                 PATHWAY_INGEST_WORKERS or pipeline_depth>=2.
PWL012 (warning) device-backed index beyond the HBM budget with no cold
                 tier configured — pw.run(index_tiers=...) /
                 PATHWAY_INDEX_TIERS demotes the cold corpus to host.
PWL013 (warning) HTTP LLM stage (LLMReranker / chat UDF) in a pipeline
                 whose run has a device decode plane configured — the
                 rerank/generate hop can run on-chip (KNNIndex
                 rerank= / decode.DecodeService) instead of paying a
                 network round-trip per pair/message.
PWL014 (warning) serving endpoint with a deadline/SLO budget in a run
                 where tracing and the profiler are both off — a missed
                 deadline surfaces as a 503 with no record of which
                 stage spent the budget; pw.run(tracing=True) /
                 PATHWAY_TRACING (or profile=) makes the tail
                 attributable.
PWL015 (warning) combined HBM oversubscription: the index plane and the
                 decode KV page pool each fit the per-device budget
                 alone, but their *sum* (plus rings/weights) exceeds
                 PATHWAY_HBM_BYTES — the run OOMs only once both planes
                 are resident. Shrink one plane, shard the index, or
                 raise the budget; the live ledger (pathway doctor)
                 tracks the same accounts at runtime.
PWL016 (warning) tenancy without quotas: the multi-tenant plane is
                 configured (pw.run(tenancy=) / PATHWAY_TENANCY) but no
                 per-tenant quotas and no default quota exist — every
                 tenant is unthrottled, so one flooding tenant takes
                 whatever chip time and HBM it wants and the isolation
                 the plane exists for never engages. Also fires when
                 the named quotas' HBM budgets sum past
                 PATHWAY_HBM_BYTES (the admission booking would let
                 tenants collectively OOM the slab).
PWL023 (warning) decode serving economics: the decode plane serves
                 multi-tenant (pw.run(tenancy=)) or RAG traffic (a
                 device-backed index feeding the same run) with prefix
                 caching off — both workloads re-prefill a shared
                 prefix (system prompt / retrieved context template)
                 per request that decode='cache=1' would serve from
                 refcounted pages for free. Second arm: a speculative
                 draft checkpoint (decode='draft_weights=...') whose
                 weights booking is the straw that pushes the KV pool +
                 target weights past PATHWAY_HBM_BYTES — the plane fits
                 until the draft loads, then OOMs at admission.
PWL024 (warning) freshness SLO configured but unmeasurable: a streaming
                 run arms the watchdog's freshness_warn/freshness_critical
                 keys while the freshness plane (pw.run(freshness=) /
                 PATHWAY_FRESHNESS) is off — the rule can never fire
                 because no watermark is ever measured. Second arm: the
                 plane is on but the slo_ms budget is tighter than the
                 floor the pipeline itself imposes (the connectors'
                 autocommit_duration_ms plus the serving batcher's
                 batch_window_ms linger), so every answer breaches the
                 SLO by construction.

Deep rules (``pathway analyze --deep`` / ``pw.run(analysis="deep")``,
implemented in :mod:`.deep`):

PWL017 (warning) host sync inside a device hot path: an .item() /
                 .cpu() / .numpy() / .tolist() / synchronize or a
                 data-dependent shape (nonzero, masked_select, unique)
                 inside the epoch hot loop — in a UDF feeding a
                 device-backed node, or among the ops a device
                 callable runs when traced on meta tensors.
PWL018 (warning) dispatch-geometry storm: the symbolic shape-bucket
                 enumeration over every device callable (seq buckets x
                 batch buckets x capacity ladder x k ladder x tiers x
                 tenant extents) predicts more distinct dispatch
                 geometries than the budget (PATHWAY_COMPILE_BUDGET,
                 default 256), or a dynamic dimension has no bucket
                 ladder at all.
PWL019 (warning) placement: an index pinned to an explicit mesh whose
                 axes differ from the run mesh (implicit cross-mesh
                 resharding collective per batch), or host-pool ingest
                 staged off-mesh so every epoch bounces through host.
PWL020 (warning) exactly-once/determinism: an effectful node (async
                 UDF / AsyncTransformer) under recovery/persistence
                 with no on_error route, a commit plane with no
                 registered chaos site, or a default-deterministic UDF
                 reading wall clock / unseeded RNG upstream of
                 persisted state.
"""

from __future__ import annotations

import dis
from typing import Any, Callable, Iterable

from ..engine import reducers as engine_reducers
from ..internals import dtype as dt
from ..internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    ColumnExpression,
    ColumnReference as ColumnReferenceExpr,
    ReducerExpression,
)
from ..internals.table import LogicalOp, Table
from ..internals.udfs import _DynamicBatcher
from .diagnostics import Diagnostic, Severity
from .graph_view import (
    GraphView,
    PASSTHROUGH_KINDS,
    SOURCE_KINDS,
    expr_applies,
    expr_refs,
    grouping_is_windowed,
    iter_param_exprs,
    join_is_windowed,
    walk_expr,
)

#: rule id -> (default severity, one-line title); the README's "Static
#: analysis" section mirrors this table.
RULES: dict[str, tuple[Severity, str]] = {
    "PWL001": (Severity.ERROR, "dtype mismatch across operator boundary"),
    "PWL002": (Severity.ERROR, "unbounded state on a streaming source"),
    "PWL003": (Severity.WARNING, "shard-unsafe UDF / key routing / reducer"),
    "PWL004": (Severity.WARNING, "impure batched UDF"),
    "PWL005": (Severity.INFO, "dead column (never read downstream)"),
    "PWL006": (Severity.INFO, "unconnected table / engine node"),
    "PWL007": (Severity.WARNING, "recovery enabled with monitoring fully off"),
    "PWL008": (Severity.WARNING, "serving endpoint without overload protection"),
    "PWL009": (Severity.WARNING, "multi-worker run without a cluster fault domain"),
    "PWL010": (Severity.WARNING, "device index exceeds single-device HBM without a mesh"),
    "PWL011": (Severity.WARNING, "host-bound ingest feeding a device model"),
    "PWL012": (Severity.WARNING, "beyond-HBM index without a cold tier"),
    "PWL013": (Severity.WARNING, "HTTP LLM stage with a device decode plane available"),
    "PWL014": (Severity.WARNING, "SLO-budgeted endpoint with tracing and profiler off"),
    "PWL015": (Severity.WARNING, "combined planes oversubscribe the HBM budget"),
    "PWL016": (Severity.WARNING, "tenancy configured without per-tenant quotas"),
    # deep (op-level) rules — emitted by analysis.deep, registered
    # here so suppress() and the generated README table cover them
    "PWL017": (Severity.WARNING, "host sync inside a device hot path"),
    "PWL018": (Severity.WARNING, "predicted dispatch geometries exceed the budget"),
    "PWL019": (Severity.WARNING, "implicit cross-mesh resharding / host bounce"),
    "PWL020": (Severity.WARNING, "effectful node outside the exactly-once contract"),
    "PWL021": (Severity.WARNING, "SLO/watchdog run with chip-time accounting off"),
    "PWL022": (Severity.WARNING, "elastic reshard configured without durable persistence"),
    "PWL023": (Severity.WARNING, "decode plane leaves prefix caching off / draft overflows HBM"),
    "PWL024": (Severity.WARNING, "freshness SLO configured but unmeasurable"),
}

#: rule ids that only the deep pass (``pathway analyze --deep`` /
#: ``pw.run(analysis="deep")``) can emit
DEEP_RULE_IDS: tuple[str, ...] = ("PWL017", "PWL018", "PWL019", "PWL020")

_MUTABLE_TYPES = (list, dict, set, bytearray)


def _diag(
    rule: str,
    message: str,
    table: Table | None = None,
    *,
    severity: Severity | None = None,
    detail: dict | None = None,
) -> Diagnostic:
    op = table._op if table is not None else None
    return Diagnostic(
        rule=rule,
        severity=severity if severity is not None else RULES[rule][0],
        message=message,
        table=table._name if table is not None else None,
        table_id=table._id if table is not None else None,
        op_kind=op.kind if op is not None else None,
        trace=op.trace if op is not None else None,
        detail=detail or {},
    )


def _is_concrete(d: dt.DType) -> bool:
    if d is dt.ANY:
        return False
    if isinstance(d, dt.Optional):
        return _is_concrete(d.wrapped)
    return True


def _unifies(a: dt.DType, b: dt.DType) -> bool:
    if not (_is_concrete(a) and _is_concrete(b)):
        return True  # ANY anywhere: dynamically typed, nothing to prove
    return dt.lub(a, b) is not dt.ANY


# --------------------------------------------------------------------------
# PWL001 — dtype consistency across operator boundaries


def check_dtype_consistency(view: GraphView) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for t in view.tables:
        op = t._op
        if op.kind == "join_select":
            for cond in op.params.get("on") or []:
                left = getattr(cond, "_left", None)
                right = getattr(cond, "_right", None)
                if not isinstance(left, ColumnExpression) or not isinstance(
                    right, ColumnExpression
                ):
                    continue
                ld, rd = left._dtype, right._dtype
                if not _unifies(ld, rd):
                    out.append(
                        _diag(
                            "PWL001",
                            f"join key dtypes do not unify: {ld} vs {rd} "
                            "— rows can never match and the key hash "
                            "routes them to different shards",
                            t,
                            detail={"left": str(ld), "right": str(rd)},
                        )
                    )
        elif op.kind == "filter":
            pred = op.params.get("expr")
            if pred is not None:
                d = pred._dtype
                base = d.wrapped if isinstance(d, dt.Optional) else d
                if _is_concrete(d) and base is not dt.BOOL:
                    out.append(
                        _diag(
                            "PWL001",
                            f"filter predicate has dtype {d}, expected BOOL",
                            t,
                            detail={"dtype": str(d)},
                        )
                    )
        elif op.kind in ("concat", "concat_reindex", "update_rows", "update_cells"):
            for name in t._columns:
                dtypes = [
                    inp._columns[name].dtype
                    for inp in op.inputs
                    if name in inp._columns
                ]
                concrete = [d for d in dtypes if _is_concrete(d)]
                for other in concrete[1:]:
                    if not _unifies(concrete[0], other):
                        out.append(
                            _diag(
                                "PWL001",
                                f"column {name!r} has incompatible dtypes "
                                f"across {op.kind} inputs: "
                                f"{concrete[0]} vs {other}",
                                t,
                                detail={"column": name},
                            )
                        )
                        break
    return out


# --------------------------------------------------------------------------
# PWL002 — unbounded state


def check_unbounded_state(view: GraphView) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for t in view.tables:
        op = t._op
        if op.kind == "groupby_reduce":
            src = op.inputs[0]
            if not view.is_streaming(src):
                continue
            if grouping_is_windowed(op) or view.streaming_paths_mitigated(op):
                continue
            out.append(
                _diag(
                    "PWL002",
                    "groupby/reduce over a streaming source retains state "
                    "for every group forever; attach a window "
                    "(t.windowby(...)) or a temporal behavior with a "
                    "cutoff/freeze threshold",
                    t,
                )
            )
        elif op.kind == "join_select":
            how = str(op.params.get("how") or "inner")
            if how.startswith("asof_now"):
                continue  # left side is not stored
            streaming = [inp for inp in op.inputs if view.is_streaming(inp)]
            if not streaming:
                continue
            if join_is_windowed(op) or view.streaming_paths_mitigated(op):
                continue
            both = len(streaming) == len(op.inputs)
            out.append(
                _diag(
                    "PWL002",
                    (
                        "join between two streaming sources stores both "
                        "sides unboundedly"
                        if both
                        else "join with a streaming input stores that side's "
                        "full history"
                    )
                    + "; window the join keys or use asof_now semantics",
                    t,
                    severity=Severity.ERROR if both else Severity.WARNING,
                )
            )
        elif op.kind == "deduplicate":
            src = op.inputs[0]
            if not view.is_streaming(src):
                continue
            if op.params.get("instance") is None:
                continue  # single global instance: O(1) state
            if view.streaming_paths_mitigated(op):
                continue
            out.append(
                _diag(
                    "PWL002",
                    "deduplicate with an instance key over a streaming "
                    "source keeps one row per distinct instance forever",
                    t,
                    severity=Severity.WARNING,
                )
            )
    return out


# --------------------------------------------------------------------------
# PWL003 — shard safety


def _unwrap_fn(fn: Any) -> Any:
    seen = 0
    while hasattr(fn, "__wrapped__") and seen < 10:
        fn = fn.__wrapped__
        seen += 1
    return fn


def _user_fn(expr: ApplyExpression) -> Any | None:
    """The user-authored callable behind an apply expression, or None
    for package-internal helpers (windowby desugaring etc.)."""
    fn = expr._fn
    if isinstance(fn, _DynamicBatcher):
        fn = fn.batch_fn
    fn = _unwrap_fn(fn)
    if isinstance(fn, _DynamicBatcher):
        fn = _unwrap_fn(fn.batch_fn)
    mod = getattr(fn, "__module__", "") or ""
    if mod.startswith("pathway_tpu_torch"):
        return None
    return fn


def _mutable_captures(fn: Any) -> list[str]:
    code = getattr(fn, "__code__", None)
    if code is None:
        return []
    found: list[str] = []
    fn_globals = getattr(fn, "__globals__", {})
    for name in code.co_names:
        if isinstance(fn_globals.get(name), _MUTABLE_TYPES):
            found.append(f"global {name!r}")
    for var, cell in zip(code.co_freevars, fn.__closure__ or ()):
        try:
            value = cell.cell_contents
        except ValueError:
            continue
        if isinstance(value, _MUTABLE_TYPES):
            found.append(f"closure {var!r}")
    return found


def _reducer_registry() -> dict[str, type]:
    reg: dict[str, type] = {}
    for obj in vars(engine_reducers).values():
        if (
            isinstance(obj, type)
            and issubclass(obj, engine_reducers.Reducer)
            and obj is not engine_reducers.Reducer
        ):
            reg[obj.name] = obj
    # stdlib aliases lowered onto StatefulReducer (graph_runner)
    reg.setdefault("stateful", engine_reducers.StatefulReducer)
    reg["stateful_single"] = engine_reducers.StatefulReducer
    reg["stateful_many"] = engine_reducers.StatefulReducer
    return reg


#: param keys whose expressions decide a row's shard / output key
_KEY_PARAMS = {
    "groupby_reduce": ("grouping", "id_from"),
    "join_select": ("on", "id_from"),
    "reindex": ("expr",),
    "deduplicate": ("instance",),
}


def check_shard_safety(view: GraphView) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    reducer_registry = _reducer_registry()
    seen_fns: set[int] = set()
    for t in view.tables:
        op = t._op
        # (a) UDFs capturing mutable state — any apply anywhere
        for key, expr in iter_param_exprs(op.params):
            for apply_expr in expr_applies(expr):
                fn = _user_fn(apply_expr)
                if fn is None or id(fn) in seen_fns:
                    continue
                seen_fns.add(id(fn))
                for what in _mutable_captures(fn):
                    out.append(
                        _diag(
                            "PWL003",
                            f"UDF {getattr(fn, '__name__', fn)!r} captures "
                            f"mutable state ({what}); each worker shard "
                            "holds its own copy, so results diverge "
                            "across shards and replays",
                            t,
                            detail={"param": key},
                        )
                    )
        # (b) non-deterministic key routing
        for key in _KEY_PARAMS.get(op.kind, ()):
            value = op.params.get(key)
            if value is None:
                continue
            exprs = value if isinstance(value, (list, tuple)) else [value]
            for expr in exprs:
                if not isinstance(expr, ColumnExpression):
                    continue
                for apply_expr in expr_applies(expr):
                    if not getattr(apply_expr, "_deterministic", True):
                        fn = _unwrap_fn(apply_expr._fn)
                        out.append(
                            _diag(
                                "PWL003",
                                "non-deterministic UDF "
                                f"{getattr(fn, '__name__', 'udf')!r} computes "
                                f"a {op.kind} key: shard_of_value may route "
                                "the same logical row to different shards "
                                "on recomputation; mark it "
                                "deterministic=True or precompute the key",
                                t,
                                detail={"param": key},
                            )
                        )
        # (c) non-commutative / non-associative reducers
        if op.kind == "groupby_reduce":
            for name, expr in (op.params.get("exprs") or {}).items():
                reducer_names: list[str] = []
                walk_expr(
                    expr,
                    lambda e: reducer_names.append(e._reducer_name)
                    if isinstance(e, ReducerExpression)
                    else None,
                )
                for rname in reducer_names:
                    cls = reducer_registry.get(rname)
                    if cls is None:
                        continue
                    if not (
                        getattr(cls, "commutative", True)
                        and getattr(cls, "associative", True)
                    ):
                        out.append(
                            _diag(
                                "PWL003",
                                f"reducer {rname!r} (column {name!r}) is not "
                                "commutative/associative: merging partial "
                                "aggregates across shards is order-"
                                "dependent",
                                t,
                                detail={"column": name, "reducer": rname},
                            )
                        )
    return out


# --------------------------------------------------------------------------
# PWL004 — batched UDF purity


def _is_torch_callable(fn: Any) -> bool:
    """A callable torch made (``torch.jit.script``, ``torch.compile``)."""
    mod = getattr(type(fn), "__module__", "") or ""
    return mod.startswith("torch")


def _is_trace_value(value: Any) -> bool:
    """A value that lives only inside a torch trace: an fx ``Proxy`` (from
    ``torch.fx.symbolic_trace``) or a ``FakeTensor`` (from a
    ``FakeTensorMode``) — the port's counterpart of a JAX tracer."""
    cls = type(value)
    mod = getattr(cls, "__module__", "") or ""
    return (mod.startswith("torch.fx") and cls.__name__ == "Proxy") or cls.__name__ == "FakeTensor"


def _batch_fn(expr: AsyncApplyExpression) -> Any | None:
    fn = expr._fn
    for _ in range(10):
        if isinstance(fn, _DynamicBatcher):
            return fn.batch_fn
        if hasattr(fn, "__wrapped__"):
            fn = fn.__wrapped__
        else:
            return None
    return None


def check_batched_udf_purity(view: GraphView) -> list[Diagnostic]:
    """PWL004 over every batched UDF (the reference's
    ``check_jax_udf_purity``, which reads JAX where this reads torch)."""
    out: list[Diagnostic] = []
    seen: set[int] = set()
    for t in view.tables:
        for key, expr in iter_param_exprs(t._op.params):
            for apply_expr in expr_applies(expr):
                if not isinstance(apply_expr, AsyncApplyExpression):
                    continue
                fn = _batch_fn(apply_expr)
                if fn is None or id(fn) in seen:
                    continue
                seen.add(id(fn))
                out.extend(_inspect_batch_fn(fn, t, key))
    return out


def _attr_names(code) -> set[str]:
    """Attribute and method names a code object loads."""
    return {
        ins.argval
        for ins in dis.get_instructions(code)
        if ins.opname in ("LOAD_METHOD", "LOAD_ATTR") and isinstance(ins.argval, str)
    }


def _inspect_batch_fn(fn: Any, table: Table, param: str) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    compiled = _is_torch_callable(fn)
    inner = _unwrap_fn(fn)
    name = getattr(inner, "__name__", getattr(fn, "__name__", "batch_udf"))
    code = getattr(inner, "__code__", None)
    # closing over a trace value (closure cell or module global): the trace
    # that produced it is gone by run time — always an error
    captured: list[tuple[str, Any]] = []
    for var, cell in zip(
        getattr(code, "co_freevars", ()), getattr(inner, "__closure__", None) or ()
    ):
        try:
            captured.append((var, cell.cell_contents))
        except ValueError:
            continue
    inner_globals = getattr(inner, "__globals__", {})
    for var in getattr(code, "co_names", ()):
        if var in inner_globals:
            captured.append((var, inner_globals[var]))
    for var, value in captured:
        if _is_trace_value(value):
            out.append(
                _diag(
                    "PWL004",
                    f"batched UDF {name!r} closes over a torch trace value "
                    f"({var!r}, a {type(value).__name__}): the trace it "
                    "belongs to has ended and the value is invalid at run "
                    "time",
                    table,
                    severity=Severity.ERROR,
                    detail={"param": param, "capture": var},
                )
            )
    if code is None:
        return out
    fn_globals = getattr(inner, "__globals__", {})

    def _module_name(value: Any) -> str:
        return getattr(value, "__name__", "") if type(value).__name__ == "module" else ""

    refs_numpy = any(
        _module_name(fn_globals.get(n)) == "numpy" for n in code.co_names
    ) or "numpy" in _attr_names(code)
    refs_torch = compiled or any(
        _module_name(fn_globals.get(n)).startswith("torch") for n in code.co_names
    )
    if refs_numpy and refs_torch:
        out.append(
            _diag(
                "PWL004",
                f"batched UDF {name!r} calls host numpy on torch tensors: "
                "every batch is copied to the host and back; use torch "
                "ops inside the batched function",
                table,
                detail={"param": param},
            )
        )
    side_effects = [n for n in code.co_names if n in ("print", "open")]
    has_store_global = any(
        ins.opname in ("STORE_GLOBAL", "DELETE_GLOBAL")
        for ins in dis.get_instructions(code)
    )
    if side_effects or has_store_global:
        what = (
            f"calls {side_effects[0]}()"
            if side_effects
            else "writes a global variable"
        )
        out.append(
            _diag(
                "PWL004",
                f"batched UDF {name!r} {what}: side effects run once per "
                "batch, not once per row, and again when a batch is "
                "retried or replayed",
                table,
                detail={"param": param},
            )
        )
    return out


# --------------------------------------------------------------------------
# PWL005 — dead columns


def _mark_refs(exprs: Iterable[ColumnExpression], live: set) -> bool:
    changed = False
    for expr in exprs:
        for ref in expr_refs(expr):
            tbl = ref._table
            if isinstance(tbl, Table):
                k = (tbl._id, ref._name)
                if k not in live:
                    live.add(k)
                    changed = True
    return changed


def check_dead_columns(view: GraphView) -> list[Diagnostic]:
    roots = view.output_tables
    if not roots:
        return []
    reachable = view.reachable_from_outputs()
    tables = [t for t in view.tables if t._id in reachable]
    by_id = {t._id: t for t in tables}
    live: set[tuple[int, str]] = set()
    for r in roots:
        for n in r._columns:
            live.add((r._id, n))

    def step() -> bool:
        changed = False
        for t in tables:
            op = t._op
            params = op.params
            out_live = [n for n in t._columns if (t._id, n) in live]
            if not out_live and t._id not in {r._id for r in roots}:
                continue
            kind = op.kind
            if kind in ("select", "concat_columns", "groupby_reduce", "join_select"):
                exprs_map = params.get("exprs") or {}
                changed |= _mark_refs(
                    (e for n, e in exprs_map.items() if n in out_live), live
                )
                other = {k: v for k, v in params.items() if k != "exprs"}
                changed |= _mark_refs((e for _, e in iter_param_exprs(other)), live)
            elif kind in PASSTHROUGH_KINDS:
                changed |= _mark_refs((e for _, e in iter_param_exprs(params)), live)
                if kind == "flatten":
                    col = params.get("column")
                    for inp in op.inputs:
                        if col in inp._columns and (inp._id, col) not in live:
                            live.add((inp._id, col))
                            changed = True
                for n in out_live:
                    for inp in op.inputs:
                        if n in inp._columns and (inp._id, n) not in live:
                            live.add((inp._id, n))
                            changed = True
                if kind == "sort":
                    # sort's output rows pair with the input's whole rows
                    for inp in op.inputs:
                        for n in inp._columns:
                            if (inp._id, n) not in live:
                                live.add((inp._id, n))
                                changed = True
            elif kind in SOURCE_KINDS:
                continue
            else:
                # unknown/opaque kinds: conservatively everything is read
                changed |= _mark_refs((e for _, e in iter_param_exprs(params)), live)
                for inp in view.op_inputs(op):
                    for n in inp._columns:
                        if (inp._id, n) not in live:
                            live.add((inp._id, n))
                            changed = True
        return changed

    while step():
        pass

    def materialized_here(t: Table, n: str) -> bool:
        # report a dead column only where it is produced (a source table
        # or a computed/renamed expression), not at every operator that
        # merely carries it along — one finding at the origin instead of
        # an echo per pipeline stage
        op = t._op
        if op.kind in SOURCE_KINDS:
            return True
        if op.kind in ("select", "concat_columns", "groupby_reduce", "join_select"):
            e = (op.params.get("exprs") or {}).get(n)
            if e is None:
                return False
            if isinstance(e, ColumnReferenceExpr) and e._name == n:
                return False  # bare same-name carry (with_columns etc.)
            return True
        return False

    out: list[Diagnostic] = []
    root_ids = {r._id for r in roots}
    for t in tables:
        if t._id in root_ids:
            continue
        dead = [
            n
            for n in t._columns
            if (t._id, n) not in live
            and not n.startswith("_pw")
            and materialized_here(t, n)
        ]
        if dead:
            out.append(
                _diag(
                    "PWL005",
                    f"column(s) {', '.join(repr(n) for n in sorted(dead))} "
                    "are never read on any path to an output; they are "
                    "computed and exchanged for nothing",
                    t,
                    detail={"columns": sorted(dead)},
                )
            )
    return out


# --------------------------------------------------------------------------
# PWL006 — unconnected tables


def check_unconnected(view: GraphView) -> list[Diagnostic]:
    if not view.output_tables:
        return []
    reachable = view.reachable_from_outputs()
    out: list[Diagnostic] = []
    for t in view.tables:
        if t._id in reachable:
            continue
        if view.consumers.get(t._id):
            continue  # an ancestor leaf will be reported instead
        if t._op.kind == "error_log":
            continue
        out.append(
            _diag(
                "PWL006",
                "table is built but feeds no output, subscription, or "
                "downstream operator — it will never execute",
                t,
            )
        )
    return out


# --------------------------------------------------------------------------
# PWL007 — recovery without observability


def check_recovery_observability(view: GraphView) -> list[Diagnostic]:
    """``pw.run(recovery=...)`` with monitoring fully off: crashes are
    restarted silently — no dashboard, no /metrics, no restart counters
    anyone can scrape — so a flapping run is both unobserved and, once
    the budget escalates, unexplained. The run configuration is recorded
    on the parse graph by ``pw.run`` (``run_context``) before the
    analyze-only return, so ``pathway analyze`` sees it too."""
    ctx = getattr(view.graph, "run_context", None)
    if not ctx or not ctx.get("recovery"):
        return []
    from ..internals.monitoring import MonitoringLevel

    level = ctx.get("monitoring_level")
    # MonitoringLevel.coerce maps None/False straight to NONE, so the
    # bare default counts as off; AUTO resolves per-tty at runtime and
    # counts as configured. Any Prometheus endpoint silences the rule.
    monitoring_off = (
        level is None
        or level is False
        or level is MonitoringLevel.NONE
        or (isinstance(level, str) and level.lower() == "none")
    )
    if not monitoring_off or ctx.get("with_http_server"):
        return []
    return [
        _diag(
            "PWL007",
            "pw.run(recovery=...) with monitoring fully off: restarts "
            "and escalations will be invisible — pass "
            "monitoring_level=... or with_http_server=True so crash "
            "loops are observable (the flight recorder still dumps on "
            "escalation, but nothing surfaces restart counts live)",
            detail={"run_context": {k: repr(v) for k, v in ctx.items()}},
        )
    ]


# --------------------------------------------------------------------------
# PWL008 — serving endpoint without overload protection


def check_serving_overload(view: GraphView) -> list[Diagnostic]:
    """A ``rest_connector`` endpoint registered without ``serving=``
    (no admission control, per-request deadlines, or shed policy) in a
    run that is otherwise configured for production pressure —
    ``recovery=`` (the process is expected to crash and keep going) or
    ``pipeline_depth > 1`` (the device is expected to be saturated).
    Under overload such an endpoint queues unboundedly inside the
    engine and times out holding memory instead of shedding early with
    a typed 429/503. Endpoints are recorded on the parse graph by
    ``rest_connector`` (``serving_endpoints``); the run configuration by
    ``pw.run`` (``run_context``)."""
    endpoints = getattr(view.graph, "serving_endpoints", None) or []
    unprotected = [e for e in endpoints if not e.get("protected")]
    if not unprotected:
        return []
    ctx = getattr(view.graph, "run_context", None) or {}
    pressured = bool(ctx.get("recovery")) or int(ctx.get("pipeline_depth") or 1) > 1
    if not pressured:
        return []
    routes = ", ".join(sorted(e.get("route", "?") for e in unprotected))
    return [
        _diag(
            "PWL008",
            f"serving endpoint(s) {routes} have no overload protection "
            "(no serving= config: no admission control, per-request "
            "deadlines, or shed policy) while the run is configured for "
            "sustained pressure (recovery= or pipeline_depth>1) — under "
            "overload these endpoints queue unboundedly and time out "
            "instead of shedding early; pass "
            "serving=pw.ServingConfig(...) to rest_connector or the "
            "REST server",
            detail={
                "endpoints": unprotected,
                "recovery": bool(ctx.get("recovery")),
                "pipeline_depth": int(ctx.get("pipeline_depth") or 1),
            },
        )
    ]


# --------------------------------------------------------------------------
# PWL009 — multi-worker run without a cluster fault domain


def check_cluster_fault_domain(view: GraphView) -> list[Diagnostic]:
    """A sharded/multiprocess run (``PATHWAY_PROCESSES``/``THREADS``
    give world > 1) whose cluster fault domain is hollowed out: with
    ``recovery=`` off a single worker crash fails the entire run (no
    supervisor to catch the escalation, no partial restart to contain
    it); with ``cluster_lease_ms=0`` heartbeats are disabled, so a hung
    or network-partitioned worker never expires its lease and every
    surviving worker blocks in the epoch barrier forever. The run
    configuration is recorded on the parse graph by ``pw.run``
    (``run_context``) before the analyze-only return."""
    ctx = getattr(view.graph, "run_context", None)
    if not ctx:
        return []
    world = int(ctx.get("processes") or 1) * int(ctx.get("threads") or 1)
    if world <= 1:
        return []
    out: list[Diagnostic] = []
    if not ctx.get("recovery"):
        out.append(
            _diag(
                "PWL009",
                f"multi-worker run (world={world}) without recovery=: one "
                "worker crash fails the whole run — partial restart "
                "(respawn just the dead worker, survivors resume from the "
                "last snapshot barrier) only engages under "
                "pw.run(recovery=...)",
                detail={"world": world, "recovery": False},
            )
        )
    lease = ctx.get("cluster_lease_ms")
    if lease is not None and float(lease) <= 0:
        out.append(
            _diag(
                "PWL009",
                f"multi-worker run (world={world}) with heartbeats disabled "
                "(cluster_lease_ms=0): a hung or partitioned worker never "
                "expires its lease, so the surviving workers stall in the "
                "epoch barrier forever — set a finite lease "
                "(pw.run(cluster_lease_ms=...) or PATHWAY_CLUSTER_LEASE_MS)",
                detail={"world": world, "cluster_lease_ms": float(lease)},
            )
        )
    return out


# --------------------------------------------------------------------------
# PWL010 — device-backed index larger than one device's HBM, no mesh


def _index_hbm_bytes(spec: dict) -> int:
    """Worst-case resident footprint of one device-backed index:
    the f32 [capacity, dim] matrix, plus the bool valid-mask and f32
    bias row (dim-independent per-row overhead). Capacity doubles on
    growth, so the first allocation past reserved_space is 2x — sizing
    on reserved_space alone is the steady-state floor the user asked
    for, which is what the budget should gate. The arithmetic lives in
    the shared footprint model (``internals/ledger``)."""
    from ..internals.ledger import index_hbm_bytes

    rows = int(spec.get("reserved_space") or 0)
    dim = int(spec.get("dimensions") or 0)
    return index_hbm_bytes(rows, dim)


def _hbm_budget() -> int:
    """PATHWAY_HBM_BYTES, else the card's memory (16 GiB without a card)
    via the shared footprint model — the same knob the decode budget
    check and the live watchdog read."""
    from ..internals.ledger import default_hbm_bytes

    return default_hbm_bytes()


def check_index_hbm_budget(view: GraphView) -> list[Diagnostic]:
    """A device-backed KNN index whose reserved capacity cannot fit in
    a single device's HBM, in a run with no mesh configured: the upload
    (or the first capacity doubling) OOMs mid-stream, after sources
    started. Index specs are recorded on the parse graph at query-build
    time (``external_indexes``); the mesh by ``pw.run`` (``run_context
    ["mesh_axes"]``, parsed without a device) — both visible to the analyze-only
    path before any device allocation."""
    specs = getattr(view.graph, "external_indexes", None) or []
    device_specs = [s for s in specs if s.get("device_backed")]
    if not device_specs:
        return []
    ctx = getattr(view.graph, "run_context", None) or {}
    axes = ctx.get("mesh_axes") or None
    n_shards = int(axes["data"]) if axes else 1
    budget = _hbm_budget()
    tiered_run = bool(ctx.get("index_tiers"))
    out: list[Diagnostic] = []
    for spec in device_specs:
        if spec.get("tiers") or tiered_run:
            # a cold tier bounds the resident footprint to the hot rows
            # (ops/tiered_knn caps them at the HBM budget) — nothing to
            # shard away; PWL012 owns the tier-advice side
            continue
        per_device = _index_hbm_bytes(spec) // max(1, n_shards)
        if per_device <= budget:
            continue
        mesh_note = (
            f"the configured mesh (data={n_shards}) still leaves"
            if n_shards > 1
            else "no mesh is configured, leaving"
        )
        need = -(-_index_hbm_bytes(spec) // budget)  # ceil shards to fit
        out.append(
            _diag(
                "PWL010",
                f"device-backed index ({spec.get('kind', 'index')}, "
                f"reserved_space={spec.get('reserved_space')}, "
                f"dim={spec.get('dimensions')}) needs "
                f"~{_index_hbm_bytes(spec) / 1024**3:.1f} GiB resident; "
                f"{mesh_note} ~{per_device / 1024**3:.1f} GiB on one "
                f"device against a {budget / 1024**3:.0f} GiB HBM budget "
                "— it will OOM on upload or first growth. Shard it: "
                f"pw.run(mesh={need}) / PATHWAY_MESH={need} splits the "
                "matrix over the mesh's data axis (one logical index, "
                "per-shard top-k + cross-chip merge; budget override: "
                "PATHWAY_HBM_BYTES)",
                detail={
                    "index": spec,
                    "bytes": _index_hbm_bytes(spec),
                    "per_device_bytes": per_device,
                    "hbm_budget_bytes": budget,
                    "mesh_axes": axes,
                    "suggested_mesh": need,
                },
            )
        )
    return out


# --------------------------------------------------------------------------
# PWL012 — beyond-HBM index with no cold tier configured


def check_index_tier_budget(view: GraphView) -> list[Diagnostic]:
    """A device-backed index whose projected footprint exceeds the HBM
    budget with no cold tier configured. PWL010 suggests sharding
    (throw chips at it); this rule suggests the other lever — a tiered
    index (ops/tiered_knn.py): HBM-resident hot clusters over an int8
    host cold tier, so the same corpus fits the same slice. The detail
    carries the footprint, a suggested hot/cold split at the budget,
    and the quantized cold-tier estimate (both reuse PWL010's budget
    math via the shared PATHWAY_HBM_BYTES knob)."""
    from ..internals.ledger import cold_row_bytes, hot_row_bytes

    specs = getattr(view.graph, "external_indexes", None) or []
    device_specs = [s for s in specs if s.get("device_backed")]
    if not device_specs:
        return []
    ctx = getattr(view.graph, "run_context", None) or {}
    if ctx.get("index_tiers"):
        return []  # run-scoped tier config covers every device index
    axes = ctx.get("mesh_axes") or None
    n_shards = int(axes["data"]) if axes else 1
    budget = _hbm_budget()
    out: list[Diagnostic] = []
    for spec in device_specs:
        if spec.get("tiers"):
            continue
        total = _index_hbm_bytes(spec)
        per_device = total // max(1, n_shards)
        if per_device <= budget:
            continue
        rows = int(spec.get("reserved_space") or 0)
        dim = int(spec.get("dimensions") or 0)
        hot_rows = min(
            rows, max(1, n_shards) * max(1, budget // max(1, hot_row_bytes(dim)))
        )
        cold_rows = rows - hot_rows
        cold_bytes = cold_rows * cold_row_bytes(dim)
        out.append(
            _diag(
                "PWL012",
                f"device-backed index ({spec.get('kind', 'index')}, "
                f"reserved_space={rows}, dim={dim}) projects "
                f"~{total / 1024**3:.1f} GiB resident against a "
                f"{budget / 1024**3:.0f} GiB HBM budget and no cold "
                "tier is configured — demote the cold corpus to host "
                f"memory: pw.run(index_tiers='hot={hot_rows}') / "
                f"PATHWAY_INDEX_TIERS=hot={hot_rows} keeps the hottest "
                f"{hot_rows} rows in HBM and the remaining {cold_rows} "
                f"rows int8-quantized on host "
                f"(~{cold_bytes / 1024**3:.1f} GiB RAM; budget "
                "override: PATHWAY_HBM_BYTES)",
                detail={
                    "index": spec,
                    "bytes": total,
                    "per_device_bytes": per_device,
                    "hbm_budget_bytes": budget,
                    "mesh_axes": axes,
                    "suggested_tier_split": {
                        "hot_rows": hot_rows,
                        "cold_rows": cold_rows,
                    },
                    "quantized_cold_bytes": cold_bytes,
                },
            )
        )
    return out


def check_host_bound_ingest(view: GraphView) -> list[Diagnostic]:
    """A streaming connector feeding a device-backed index/model in a
    run with the strict serial epoch loop (``pipeline_depth <= 1``) and
    no collaborative ingest stage configured: every epoch tokenizes,
    packs and resolves its batch on the host *in line with* the device
    dispatch, so the chip idles for the whole host-prep span (the r05
    bench measured CLIP ~50x under its device-compute bound this way).
    Either knob breaks the serialization — ``pw.run(ingest_workers=N)``
    / PATHWAY_INGEST_WORKERS runs host prep on a worker pool with an
    order-preserving committer, ``pipeline_depth >= 2`` overlaps whole
    epochs."""
    specs = getattr(view.graph, "external_indexes", None) or []
    device_specs = [s for s in specs if s.get("device_backed")]
    if not device_specs:
        return []
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    if int(ctx.get("pipeline_depth") or 1) > 1:
        return []
    if int(ctx.get("ingest_workers") or 0) > 0:
        return []
    out: list[Diagnostic] = []
    for t in view.tables:
        op = t._op
        if op.kind != "external_index":
            continue
        if not any(view.is_streaming(src) for src in view.op_inputs(op)):
            continue
        out.append(
            _diag(
                "PWL011",
                "streaming connector feeds a device-backed index with "
                "pipeline_depth<=1 and no ingest stage: host prep "
                "(tokenize/pack/resolve) runs serially in line with "
                "device dispatch, starving the chip. Configure the "
                "collaborative host stage — pw.run(ingest_workers=N) / "
                "PATHWAY_INGEST_WORKERS=N (PATHWAY_INGEST_AUTOSCALE=1 "
                "sizes it from queue depth) — or overlap whole epochs "
                "with pipeline_depth>=2; output is byte-identical "
                "either way",
                t,
                detail={
                    "pipeline_depth": int(ctx.get("pipeline_depth") or 1),
                    "ingest_workers": int(ctx.get("ingest_workers") or 0),
                    "indexes": device_specs,
                },
            )
        )
        break  # one diagnostic per run configuration, not per index op
    return out


def check_http_llm_with_device_decode(view: GraphView) -> list[Diagnostic]:
    """An HTTP LLM call site (``LLMReranker`` scoring pairs through a
    chat endpoint, or a chat UDF generating answers) built into a
    program whose run configures the device decode plane
    (``pw.run(decode=...)`` / PATHWAY_DECODE): every pair/message pays
    a network round-trip the chip could absorb — the on-device
    cross-encoder (``KNNIndex(rerank=...)`` / ``models.reranker``)
    replaces the rerank hop and the paged-KV decoder
    (``decode.DecodeService``) the generate hop, keeping the whole
    embed→retrieve→rerank→generate path in one dispatch. Device-native
    stages (``CrossEncoderReranker`` etc.) never record here."""
    endpoints = getattr(view.graph, "llm_endpoints", None) or []
    if not endpoints:
        return []
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx.get("decode"):
        return []
    kinds = sorted({e.get("kind") or "llm" for e in endpoints})
    return [
        _diag(
            "PWL013",
            f"{len(endpoints)} HTTP LLM stage(s) ({', '.join(kinds)}) in "
            "a run with the device decode plane configured: each "
            "pair/message leaves the chip for a network round-trip the "
            "decode plane makes unnecessary. Rerank on-device with "
            "KNNIndex(rerank=...) (models/reranker.py) and generate "
            "with decode.DecodeService — the fused path keeps "
            "embed->retrieve->rerank->generate in one dispatch",
            detail={
                "llm_endpoints": list(endpoints),
                "decode": ctx.get("decode"),
            },
        )
    ]


# --------------------------------------------------------------------------
# PWL014 — SLO budget with no observability to attribute it


def check_slo_without_tracing(view: GraphView) -> list[Diagnostic]:
    """A serving endpoint declares a per-request deadline budget
    (``ServingConfig(default_deadline_ms=...)``) but the run has
    neither the request tracing plane (``pw.run(tracing=True)`` /
    PATHWAY_TRACING) nor the profiler (``profile=`` / PATHWAY_PROFILE)
    on. The budget WILL be missed eventually — and every miss surfaces
    as a bare 429/503 with no record of which stage (queue, batch,
    index, rerank, decode) actually spent it. Either observability
    plane makes the tail attributable: tracing retains the slowest
    complete journeys per window (``pathway trace slow``), the profiler
    writes per-operator timings. Endpoints are recorded on the parse
    graph by ``rest_connector`` (``serving_endpoints``, carrying
    ``deadline_ms``); the run's tracing/profiler intent by ``pw.run``
    (``run_context``)."""
    endpoints = getattr(view.graph, "serving_endpoints", None) or []
    budgeted = [e for e in endpoints if e.get("deadline_ms")]
    if not budgeted:
        return []
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    if ctx.get("tracing") or ctx.get("profile"):
        return []
    routes = ", ".join(sorted(str(e.get("route", "?")) for e in budgeted))
    return [
        _diag(
            "PWL014",
            f"serving endpoint(s) {routes} enforce a per-request "
            "deadline budget but tracing and the profiler are both "
            "off: a missed deadline sheds as a bare 429/503 with no "
            "record of which stage spent the budget. Turn on "
            "pw.run(tracing=True) (or PATHWAY_TRACING=1) to retain "
            "the slowest request journeys with per-stage attribution "
            "(`pathway trace slow`), or profile= for per-operator "
            "timings",
            detail={
                "endpoints": budgeted,
                "tracing": bool(ctx.get("tracing")),
                "profile": bool(ctx.get("profile")),
            },
        )
    ]


# --------------------------------------------------------------------------
# PWL021 — SLO/watchdog run with chip-time accounting off


def check_slo_without_chip_accounting(view: GraphView) -> list[Diagnostic]:
    """The run declares a latency/health contract — a serving endpoint
    with a per-request deadline budget, or ``pw.run(watchdog=)`` — but
    the chip-time ledger (``pw.run(chip_ledger=True)`` /
    PATHWAY_CHIP_LEDGER=1) is off. When the contract is breached, the
    first question is always *where the device-seconds went* (encode?
    index search? rerank? decode? stranded behind host prep?), and
    without the ledger there is no answer: ``pathway top`` renders
    empty, the watchdog's stranded_chip_time rule never fires, and
    ``pathway perf diff`` has no per-plane baseline. Tracing (PWL014)
    attributes *one request's* wall time; the chip ledger attributes
    the *fleet's* device time — an SLO needs both. Intent is recorded
    on the parse graph by ``pw.run`` (``run_context``: ``watchdog``,
    ``chip_ledger``) and ``rest_connector`` (``serving_endpoints``
    carrying ``deadline_ms``)."""
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    if ctx.get("chip_ledger"):
        return []
    endpoints = getattr(view.graph, "serving_endpoints", None) or []
    budgeted = [e for e in endpoints if e.get("deadline_ms")]
    if not budgeted and not ctx.get("watchdog"):
        return []
    reasons = []
    if budgeted:
        routes = ", ".join(sorted(str(e.get("route", "?")) for e in budgeted))
        reasons.append(f"endpoint(s) {routes} enforce a deadline budget")
    if ctx.get("watchdog"):
        reasons.append("the health watchdog is on")
    return [
        _diag(
            "PWL021",
            f"{' and '.join(reasons)} but chip-time accounting is off: "
            "a breach leaves no record of where the device-seconds "
            "went (per-plane chip time, MFU, stranded fraction and "
            "its causes). Turn on pw.run(chip_ledger=True) (or "
            "PATHWAY_CHIP_LEDGER=1) so `pathway top` / `pathway perf "
            "snapshot` can attribute the budget, and the watchdog's "
            "stranded_chip_time rule has a signal",
            detail={
                "endpoints": budgeted,
                "watchdog": bool(ctx.get("watchdog")),
                "chip_ledger": False,
            },
        )
    ]


# --------------------------------------------------------------------------
# PWL022 — elastic reshard configured without durable persistence


def check_elastic_without_persistence(view: GraphView) -> list[Diagnostic]:
    """The elastic plane is armed — reshard watermarks / ``auto`` mode
    (``pw.run(elastic=...)`` / PATHWAY_ELASTIC), a fixed ``shards=``
    target, or ``mesh=\"auto\"`` — but the run has no persistence
    backend. A live reshard is a two-phase protocol fenced by a
    *durable* cluster-generation token plus a durable reshard intent:
    without a backend the generation bump and intent live only in
    process memory, so a crash mid-migration cannot tell a zombie
    writer from the new generation (no StaleGeneration fence survives
    the restart) and ``recover_pending_reshard`` has nothing to read —
    the zero-dropped / byte-identical recovery guarantees silently
    degrade to best-effort. Intent is recorded on the parse graph by
    ``pw.run`` (``run_context``: ``elastic``, ``mesh_axes``,
    ``persistence``)."""
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    if ctx.get("persistence"):
        return []
    elastic = ctx.get("elastic") or {}
    mesh_axes = ctx.get("mesh_axes") or {}
    watermarks = bool(
        elastic.get("auto")
        or elastic.get("oom_warn_s") is not None
        or elastic.get("hbm_frac") is not None
        or elastic.get("stranded_frac") is not None
    )
    fixed_target = elastic.get("shards") is not None
    mesh_auto = bool(mesh_axes.get("auto"))
    if not (watermarks or fixed_target or mesh_auto):
        return []
    reasons = []
    if watermarks:
        reasons.append("elastic reshard watermarks are armed")
    elif fixed_target:
        reasons.append(f"a fixed elastic target (shards={elastic['shards']}) is set")
    if mesh_auto:
        reasons.append('mesh="auto" elects the data axis elastically')
    return [
        _diag(
            "PWL022",
            f"{' and '.join(reasons)} but no persistence backend is "
            "configured: the migration's cluster-generation fence and "
            "reshard intent are durable-by-contract, and without "
            "persistence_config= a crash mid-reshard loses both — "
            "zombie writes are not fenced across restart and the "
            "pending reshard cannot be recovered or rolled back. Pass "
            "pw.run(persistence_config=pw.persistence.Config."
            "simple_config(pw.persistence.Backend.filesystem(...))) "
            "so the generation token and intent survive a crash",
            detail={
                "elastic": elastic or None,
                "mesh_auto": mesh_auto,
                "persistence": False,
            },
        )
    ]


# --------------------------------------------------------------------------
# PWL015 — combined planes oversubscribe the HBM budget


def check_combined_hbm_oversubscription(view: GraphView) -> list[Diagnostic]:
    """Each HBM plane passes its own budget check — the index fits
    (PWL010 silent), the KV page pool fits (decode's parse-time check
    passes) — but their *sum* does not: the run OOMs only once both
    planes are resident, typically mid-stream when the index growth
    lands on top of an allocated pool. Uses the shared footprint model
    (``internals/ledger.footprint``): per-device index bytes after mesh
    sharding plus the KV pool at the nominal decoder geometry (the live
    ledger accounts for the real geometry at runtime). Tiered indexes
    are excluded — their resident set is hot-tier-bounded and PWL012
    owns that advice."""
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    decode_cfg = ctx.get("decode") or None
    specs = getattr(view.graph, "external_indexes", None) or []
    device_specs = [
        s for s in specs if s.get("device_backed") and not s.get("tiers")
    ]
    if not decode_cfg or not device_specs or ctx.get("index_tiers"):
        return []
    from ..internals.ledger import (
        NOMINAL_DECODER_HIDDEN,
        NOMINAL_DECODER_LAYERS,
        footprint,
        kv_pool_bytes,
    )

    budget = _hbm_budget()
    axes = ctx.get("mesh_axes") or None
    n_shards = int(axes["data"]) if axes else 1
    index_bytes = sum(
        _index_hbm_bytes(s) // max(1, n_shards) for s in device_specs
    )
    kv_bytes = kv_pool_bytes(
        int(decode_cfg.get("pages") or 0),
        int(decode_cfg.get("page_size") or 0),
        NOMINAL_DECODER_LAYERS,
        NOMINAL_DECODER_HIDDEN,
    )
    fp = footprint(index_bytes=index_bytes, kv_bytes=kv_bytes)
    # single-plane overflow is PWL010/012's (or decode check_budget's)
    # job — this rule owns exactly the each-passes-alone window
    if index_bytes > budget or kv_bytes > budget or fp["total"] <= budget:
        return []
    return [
        _diag(
            "PWL015",
            f"combined HBM planes oversubscribe the budget: the index "
            f"plane (~{index_bytes / 1024**2:.0f} MiB/device) and the "
            f"decode KV page pool (~{kv_bytes / 1024**2:.0f} MiB at the "
            "nominal decoder geometry) each fit the "
            f"{budget / 1024**2:.0f} MiB budget alone, but together "
            f"need ~{fp['total'] / 1024**2:.0f} MiB — the run OOMs only "
            "once both planes are resident. Shrink the pool "
            "(decode='pages=...'), shard the index (pw.run(mesh=...)), "
            "tier it (index_tiers=), or raise PATHWAY_HBM_BYTES; "
            "`pathway doctor` tracks the same accounts live",
            detail={
                "footprint": fp,
                "hbm_budget_bytes": budget,
                "indexes": device_specs,
                "decode": decode_cfg,
                "mesh_axes": axes,
            },
        )
    ]


# --------------------------------------------------------------------------
# PWL016 — tenancy configured without per-tenant quotas


def check_tenancy_without_quotas(view: GraphView) -> list[Diagnostic]:
    """The multi-tenant serving plane is on (``pw.run(tenancy=...)`` /
    PATHWAY_TENANCY, recorded on ``run_context`` without a device) but nothing
    bounds any tenant: no named quotas and no default quota. The plane
    then routes and labels per tenant but never throttles — one
    flooding tenant still takes whatever chip time and HBM it wants,
    which is exactly the failure mode tenancy exists to prevent. The
    second arm: the named quotas' ``hbm_bytes`` budgets *sum* past the
    PATHWAY_HBM_BYTES budget, so admission would happily book tenant
    segments the device cannot actually hold (the per-tenant check in
    the packed slab passes tenant-by-tenant)."""
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    tcfg = ctx.get("tenancy") or None
    if not tcfg:
        return []
    quotas = tcfg.get("quotas") or {}
    default = tcfg.get("default") or None
    if not quotas and not default:
        return [
            _diag(
                "PWL016",
                "the multi-tenant serving plane is configured but no "
                "per-tenant quotas and no default quota exist: tenants "
                "are routed and labeled but never throttled, so one "
                "flooding tenant still monopolizes chip time and HBM. "
                "Name quotas (tenancy={'quotas': {'acme': {'qps': 100, "
                "'hbm': '64M'}}}) or set a default "
                "(tenancy='qps=50,inflight=8' applies to every tenant)",
                detail={"tenancy": tcfg},
            )
        ]
    budget = _hbm_budget()
    booked = {
        t: int(q["hbm_bytes"])
        for t, q in quotas.items()
        if isinstance(q, dict) and q.get("hbm_bytes")
    }
    total = sum(booked.values())
    if booked and total > budget:
        return [
            _diag(
                "PWL016",
                f"the per-tenant HBM quotas of {len(booked)} tenant(s) "
                f"sum to ~{total / 1024**2:.0f} MiB against a "
                f"{budget / 1024**2:.0f} MiB budget (PATHWAY_HBM_BYTES): "
                "each tenant passes its own admission check, but "
                "collectively they can book segments the device cannot "
                "hold — the slab OOMs once enough tenants grow into "
                "their quotas. Shrink the quotas or raise the budget",
                detail={
                    "tenant_hbm_bytes": booked,
                    "total_bytes": total,
                    "hbm_budget_bytes": budget,
                },
            )
        ]
    return []


# --------------------------------------------------------------------------
# PWL023 — decode plane leaves prefix caching off / draft overflows HBM


def check_decode_serving_economics(view: GraphView) -> list[Diagnostic]:
    """Two decode-plane misconfigurations that cost real money at
    serving time, both visible on ``run_context`` without a device.

    Arm 1 — *prefix caching off under shareable traffic*: the run
    configures the decode plane AND serves either multiple tenants
    (``pw.run(tenancy=...)``) or RAG traffic (a device-backed index in
    the same program — retrieved-context prompts share the system /
    template prefix), but ``decode='cache=1'`` is off. Every request
    then re-prefills the shared prefix the refcounted page table would
    serve at ~zero cost (one content-hash lookup, COW-shared pages,
    booked once in the ledger) — measured as tokens/s/chip, that is
    money left on the table.

    Arm 2 — *draft checkpoint as the HBM straw*: speculative decode is
    on (``spec_tokens>0``) with an external draft checkpoint declared
    (``draft_weights=...``; the built-in layer-skip self-draft adds
    zero weight bytes and never trips this). The KV pool plus the
    target's weights fit the PATHWAY_HBM_BYTES budget, but adding the
    draft's ``weights`` booking does not — the plane admits fine until
    the draft loads, then the ledger (or the device) refuses
    mid-deploy. Pool/KV sizing uses the shared static footprint model
    (``internals/ledger``: ``kv_pool_bytes`` at the nominal decoder
    geometry, ``decoder_weights_bytes`` for the target)."""
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    decode_cfg = ctx.get("decode") or None
    if not decode_cfg:
        return []
    out: list[Diagnostic] = []
    tenancy = bool(ctx.get("tenancy"))
    specs = getattr(view.graph, "external_indexes", None) or []
    rag = any(s.get("device_backed") for s in specs)
    if (tenancy or rag) and not decode_cfg.get("prefix_cache"):
        traffic = []
        if tenancy:
            traffic.append("multi-tenant (tenancy=)")
        if rag:
            traffic.append("RAG (a device-backed index feeds this run)")
        out.append(
            _diag(
                "PWL023",
                f"the decode plane serves {' and '.join(traffic)} "
                "traffic with prefix caching off: every request "
                "re-prefills the shared system/template prefix that "
                "decode='cache=1' would serve from refcounted COW "
                "pages at ~zero cost (content-hash lookup, pages "
                "booked once in the decode.kv ledger account). Turn "
                "on prefix_cache — `pathway perf snapshot` reports "
                "decode_prefix_hit_ratio so the win is measurable",
                detail={
                    "decode": decode_cfg,
                    "tenancy": tenancy,
                    "rag_indexes": [s for s in specs if s.get("device_backed")],
                    "prefix_cache": False,
                },
            )
        )
    draft_bytes = int(decode_cfg.get("draft_weights") or 0)
    if int(decode_cfg.get("spec_tokens") or 0) > 0 and draft_bytes > 0:
        from ..internals.ledger import (
            NOMINAL_DECODER_HIDDEN,
            NOMINAL_DECODER_LAYERS,
            decoder_weights_bytes,
            kv_pool_bytes,
        )

        budget = _hbm_budget()
        kv_bytes = kv_pool_bytes(
            int(decode_cfg.get("pages") or 0),
            int(decode_cfg.get("page_size") or 0),
            NOMINAL_DECODER_LAYERS,
            NOMINAL_DECODER_HIDDEN,
        )
        target_bytes = decoder_weights_bytes(
            NOMINAL_DECODER_LAYERS, NOMINAL_DECODER_HIDDEN
        )
        base = kv_bytes + target_bytes
        # the draft being the *straw* is the point: a plane that
        # overflows without the draft is PWL015/PWL010 territory
        if base <= budget < base + draft_bytes:
            out.append(
                _diag(
                    "PWL023",
                    f"the speculative draft checkpoint "
                    f"(draft_weights=~{draft_bytes / 1024**2:.0f} MiB) "
                    "is the straw that overflows HBM: the KV page pool "
                    f"(~{kv_bytes / 1024**2:.0f} MiB) plus the target "
                    f"weights (~{target_bytes / 1024**2:.0f} MiB) fit "
                    f"the {budget / 1024**2:.0f} MiB budget, but adding "
                    f"the draft needs ~{(base + draft_bytes) / 1024**2:.0f} "
                    "MiB — the plane deploys, then OOMs when the draft "
                    "loads. Use the built-in layer-skip self-draft "
                    "(draft_layers=, zero extra weights), shrink the "
                    "pool (pages=), or raise PATHWAY_HBM_BYTES",
                    detail={
                        "decode": decode_cfg,
                        "kv_pool_bytes": kv_bytes,
                        "target_weights_bytes": target_bytes,
                        "draft_weights_bytes": draft_bytes,
                        "total_bytes": base + draft_bytes,
                        "hbm_budget_bytes": budget,
                    },
                )
            )
    return out


# --------------------------------------------------------------------------
# PWL024 — freshness SLO configured but unmeasurable


def check_freshness_unmeasurable(view: GraphView) -> list[Diagnostic]:
    """The run declares a freshness contract it cannot honor. First
    arm: the watchdog spec carries ``freshness_warn``/
    ``freshness_critical`` thresholds but the freshness plane
    (``pw.run(freshness=...)`` / PATHWAY_FRESHNESS) is off — the
    ``freshness_slo`` watch rule reads the plane's visibility-lag EWMA,
    and with no watermarks ever measured the rule is dead weight: a
    staleness regression sails past the very thresholds configured to
    catch it. Second arm: the plane is on with an ``slo=`` budget
    tighter than the latency floor the pipeline itself imposes — a
    streaming connector only *commits* input every
    ``autocommit_duration_ms`` (so no document can become visible
    faster than that), and a served answer additionally waits out the
    adaptive batcher's ``batch_window_ms`` linger. An SLO below that
    floor breaches on every single answer by construction; the alert
    is noise, not signal. Intent is recorded on the parse graph by
    ``pw.run`` (``run_context``: ``freshness``, ``watchdog_freshness``),
    the connector ops (``autocommit_duration_ms``) and
    ``rest_connector`` (``serving_endpoints`` carrying
    ``batch_window_ms``)."""
    ctx = getattr(view.graph, "run_context", None) or {}
    if not ctx:
        return []  # no pw.run configuration recorded (unit-built graph)
    streaming_ops: list[LogicalOp] = []
    seen: set[int] = set()
    for t in view.tables:
        op = t._op
        if op.kind == "connector" and id(op) not in seen:
            seen.add(id(op))
            streaming_ops.append(op)
    if not streaming_ops:
        return []  # bounded static run: freshness is a no-op by design
    fresh = ctx.get("freshness")
    out: list[Diagnostic] = []
    if ctx.get("watchdog_freshness") and fresh is None:
        out.append(
            _diag(
                "PWL024",
                "the watchdog configures freshness_warn/freshness_critical "
                "thresholds but the freshness plane is off: the "
                "freshness_slo rule reads the plane's visibility-lag "
                "EWMA, so with no watermarks measured it can never "
                "fire and a staleness regression goes unalerted. Turn "
                "on pw.run(freshness='slo=...') (or PATHWAY_FRESHNESS) "
                "so every answer carries a staleness bound the "
                "watchdog can grade",
                detail={"watchdog_freshness": True, "freshness": None},
            )
        )
        return out
    slo_ms = (fresh or {}).get("slo_ms") if isinstance(fresh, dict) else None
    if slo_ms is None:
        return out
    autocommit = max(
        (
            float(op.params.get("autocommit_duration_ms") or 0)
            for op in streaming_ops
        ),
        default=0.0,
    )
    endpoints = getattr(view.graph, "serving_endpoints", None) or []
    batch_window = max(
        (float(e.get("batch_window_ms") or 0) for e in endpoints),
        default=0.0,
    )
    floor_ms = autocommit + batch_window
    if floor_ms > 0 and float(slo_ms) < floor_ms:
        parts = [f"autocommit_duration_ms={autocommit:g}"]
        if batch_window:
            parts.append(f"batcher batch_window_ms={batch_window:g}")
        out.append(
            _diag(
                "PWL024",
                f"freshness SLO {float(slo_ms):g}ms is tighter than the "
                f"{floor_ms:g}ms floor the pipeline imposes "
                f"({' + '.join(parts)}): no document can become "
                "visible faster than the connector commits it, so "
                "every answer breaches the budget by construction. "
                "Raise the SLO past the floor, or shrink "
                "autocommit_duration_ms / the batcher window to meet "
                "it",
                detail={
                    "slo_ms": float(slo_ms),
                    "floor_ms": floor_ms,
                    "autocommit_duration_ms": autocommit,
                    "batch_window_ms": batch_window,
                },
            )
        )
    return out


LOGICAL_RULES: list[Callable[[GraphView], list[Diagnostic]]] = [
    check_dtype_consistency,
    check_unbounded_state,
    check_shard_safety,
    check_batched_udf_purity,
    check_dead_columns,
    check_unconnected,
    check_recovery_observability,
    check_serving_overload,
    check_cluster_fault_domain,
    check_index_hbm_budget,
    check_index_tier_budget,
    check_host_bound_ingest,
    check_http_llm_with_device_decode,
    check_slo_without_tracing,
    check_slo_without_chip_accounting,
    check_combined_hbm_oversubscription,
    check_tenancy_without_quotas,
    check_elastic_without_persistence,
    check_decode_serving_economics,
    check_freshness_unmeasurable,
]
