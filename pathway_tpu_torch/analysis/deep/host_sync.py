"""PWL017 — host-sync detector.

Two sweeps over the same hazard class (an unplanned device->host round
trip inside the epoch hot loop — the WindVE failure mode, where one
blocking transfer in the embedding path serializes the whole pipeline):

1. **op level** — the :class:`~.targets.OpTrace` of every deep target
   (the callable the node dispatches, traced on ``meta`` tensors) and
   its host-sync marks: a scalar or list read of a device tensor, a copy
   to the host, ``torch.cuda.synchronize``, or a data-dependent shape
   that CUDA must read back (``nonzero``, ``masked_select``, ``unique``,
   boolean-mask indexing). Each is a synchronous host round trip per
   dispatch of a kernel this repo promises is device-resident. This is
   the port's counterpart of the reference's jaxpr sweep for callback
   primitives; ``torch.cuda.set_sync_debug_mode("error")`` is the card's
   own detector of the same events.
2. **UDF level** — scan the bytecode of user UDFs sitting on the
   staging path into a device-facing node (the anchor table and its
   ancestors — the staged path that re-runs every epoch) for explicit
   sync calls: ``torch.cuda.synchronize`` / ``Event.synchronize``, and
   ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()`` reads of torch
   values. Those reads, and ``np.asarray`` / ``np.array`` (an implicit
   transfer), only fire when the UDF also references torch and is *not*
   batched — numpy on torch tensors inside a batched UDF is already
   PWL004's finding, and one hazard must not fire twice under two rule
   ids.
"""

from __future__ import annotations

import dis
from typing import Any

from ..diagnostics import Diagnostic
from ..graph_view import GraphView, expr_applies, iter_param_exprs
from ..rules import _batch_fn, _diag, _unwrap_fn, _user_fn

__all__ = ["check_host_sync"]

#: explicit host-sync call names in UDF bytecode
_SYNC_NAMES = frozenset({"synchronize"})

#: reads of a tensor on the host: a sync when applied to torch values
_TRANSFER_NAMES = frozenset({"item", "cpu", "numpy", "tolist"})

#: numpy's implicit transfers: a sync when applied to torch values
_NUMPY_NAMES = frozenset({"asarray", "array"})


def _udf_sync_markers(fn: Any, batched: bool) -> list[str]:
    """Sync markers in one user callable's bytecode."""
    inner = _unwrap_fn(fn)
    code = getattr(inner, "__code__", None)
    if code is None:
        return []
    names = set(code.co_names)
    for ins in dis.get_instructions(code):
        if ins.opname in ("LOAD_METHOD", "LOAD_ATTR") and isinstance(
            ins.argval, str
        ):
            names.add(ins.argval)
    markers = sorted(names & _SYNC_NAMES)
    fn_globals = getattr(inner, "__globals__", {})

    def _mod(n: str) -> str:
        v = fn_globals.get(n)
        return getattr(v, "__name__", "") if type(v).__name__ == "module" else ""

    refs_torch = any(_mod(n).startswith("torch") for n in code.co_names)
    refs_numpy = any(_mod(n) == "numpy" for n in code.co_names)
    if refs_torch and not batched:
        # reads of torch values produced in the same function body, and
        # numpy's implicit transfers of them. Batched UDFs are PWL004's
        # jurisdiction (numpy on torch tensors), so skip them here.
        transfer = sorted(names & _TRANSFER_NAMES)
        if refs_numpy:
            transfer = sorted(set(transfer) | (names & _NUMPY_NAMES))
        markers.extend(t for t in transfer if t not in markers)
    return markers


def _staging_path_tables(view: GraphView, targets) -> dict[int, tuple[Any, Any]]:
    """table id -> (table, anchor target) for every table on a staging
    path into a device-facing node (the anchor itself included)."""
    out: dict[int, tuple[Any, Any]] = {}
    for target in targets:
        anchor = target.table
        if anchor is None:
            continue
        if anchor._id not in out:
            out[anchor._id] = (anchor, target)
        for t in view.ancestors(anchor):
            if t._id not in out:
                out[t._id] = (t, target)
    return out


def check_host_sync(view: GraphView, targets) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    # 1) op sweep over the traced device callables
    for target in targets:
        trace = target.op_trace()
        if trace is None:
            continue
        ops = trace.syncs
        if ops:
            out.append(
                _diag(
                    "PWL017",
                    f"device callable {target.name} contains host-sync "
                    f"op(s) {sorted(set(ops))}: every dispatch pays a "
                    "synchronous device->host round trip inside the "
                    "epoch hot loop",
                    target.table,
                    detail={"target": target.name, "primitives": sorted(set(ops))},
                )
            )
    # 2) UDF sweep over the staging paths
    staged = _staging_path_tables(view, targets)
    seen_fns: set[int] = set()
    for _tid, (table, target) in sorted(staged.items()):
        for key, expr in iter_param_exprs(table._op.params):
            for ap in expr_applies(expr):
                batched = _batch_fn(ap) is not None
                fn = _user_fn(ap)
                if fn is None or id(fn) in seen_fns:
                    continue
                seen_fns.add(id(fn))
                markers = _udf_sync_markers(fn, batched)
                if not markers:
                    continue
                name = getattr(fn, "__name__", "udf")
                where = (
                    "the streaming epoch hot loop"
                    if target.hot_loop
                    else "the DeviceRing-staged path"
                )
                out.append(
                    _diag(
                        "PWL017",
                        f"UDF {name!r} forces a device->host sync "
                        f"({', '.join(markers)}) on {where} into "
                        f"{target.name}: the transfer blocks dispatch "
                        "pipelining every epoch — keep the value on "
                        "device or move the readback behind the sink",
                        table,
                        detail={
                            "param": key,
                            "markers": markers,
                            "target": target.name,
                        },
                    )
                )
    return out
