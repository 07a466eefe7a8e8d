"""DeepTarget — one device-facing callable of the lowered graph,
reconstructed from graph-build-time specs, and the op tracer the deep
rules read.

Analyze-only runs never lower the graph: ``pw.run()`` returns at the
``PATHWAY_ANALYZE_ONLY`` gate, after recording ``G.run_context`` but
before sinks, connectors, or any device allocation exist — so the deep
pass cannot inspect the live dispatch. Instead the ops modules export
``deep_trace_spec`` hooks (``ops/knn.py``, ``ops/paged_attention.py``)
that return the callable the live node dispatches with tiny arguments on
the ``meta`` device. :class:`OpTrace` runs it under a
``TorchFunctionMode`` and a ``TorchDispatchMode`` and records every op
it runs (the port's counterpart of the reference's ``jax.make_jaxpr``):
nothing is computed and no card is touched. On ``meta`` tensors the
callables take their plain versions; on CUDA tensors the same callables
launch kernels B2 and B5. The encoder forward is covered arithmetically
(its bucket space, PWL018) rather than traced.

Host syncs the tracer marks (PWL017): a scalar or list read of a device
tensor (``item``, ``tolist``, ``bool`` / ``int`` / ``float`` of one), a
copy to the host (``cpu``, ``numpy``, ``to`` the CPU), a
``torch.cuda.synchronize``, and the data-dependent shapes CUDA has to
read back (``nonzero``, ``masked_select``, ``unique``, boolean-mask
indexing, ``repeat_interleave`` without ``output_size``). A mark on a
``meta`` tensor does not run: the op runs on zeros on the host and its
tensors return to ``meta``, so the trace goes on past it.

Every target carries the anchor :class:`~...internals.table.Table` of
the graph node that dispatches it, so deep findings cite the same
build-time trace runtime ``EngineError`` s do.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

from ..graph_view import GraphView

__all__ = ["DeepTarget", "OpTrace", "build_targets"]

#: Python-level tensor methods and functions that read a device tensor on
#: the host, by the name the trace records
_HOST_READS = {
    "item": "item",
    "tolist": "tolist",
    "cpu": "cpu",
    "numpy": "numpy",
    "__bool__": "item",
    "__int__": "item",
    "__float__": "item",
    "__index__": "item",
}

#: aten ops whose output shape depends on the data, by the name the trace
#: records
_DATA_SHAPES = {
    "nonzero": "nonzero",
    "argwhere": "nonzero",
    "masked_select": "masked_select",
    "_unique": "unique",
    "_unique2": "unique",
    "unique_dim": "unique",
    "unique_consecutive": "unique",
}


def _on_device(t: Any) -> bool:
    import torch

    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


def _host_stand_in(value: Any) -> Any:
    """``value`` with every ``meta`` tensor replaced by host zeros."""
    import torch

    if isinstance(value, torch.Tensor) and value.device.type == "meta":
        return torch.zeros(value.shape, dtype=value.dtype)
    if isinstance(value, (list, tuple)):
        return type(value)(_host_stand_in(v) for v in value)
    if isinstance(value, dict):
        return {k: _host_stand_in(v) for k, v in value.items()}
    return value


def _to_meta(value: Any) -> Any:
    import torch

    if isinstance(value, torch.Tensor):
        return value.to("meta")
    if isinstance(value, (list, tuple)):
        return type(value)(_to_meta(v) for v in value)
    return value


def _any_meta(args, kwargs) -> bool:
    import torch

    flat = list(args) + list(kwargs.values())
    while flat:
        v = flat.pop()
        if isinstance(v, torch.Tensor) and v.device.type == "meta":
            return True
        if isinstance(v, (list, tuple)):
            flat.extend(v)
    return False


def _sync_mark(torch, name: str, args, kwargs) -> str | None:
    """The host-sync mark of one aten op on device tensors, or None."""
    if name == "_local_scalar_dense":
        return "item"
    if name in _DATA_SHAPES:
        return _DATA_SHAPES[name]
    if name in ("index", "index_put", "index_put_") and len(args) > 1 and any(
        isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8) for i in args[1]
    ):
        return "boolean_mask"
    if name == "repeat_interleave" and kwargs.get("output_size") is None and isinstance(args[0], torch.Tensor) \
            and (len(args) < 2 or isinstance(args[1], torch.Tensor)):
        return "repeat_interleave"
    if name in ("_to_copy", "copy_"):
        src, dst = (args[0], kwargs.get("device")) if name == "_to_copy" else (args[1], args[0].device)
        if _on_device(src) and dst is not None and torch.device(dst).type == "cpu":
            return "cpu"
    return None


class OpTrace:
    """The ops one call of ``fn(*args)`` runs, with its host syncs.

    ``ops`` lists every aten op in call order; ``syncs`` the host-sync
    marks (module docstring), one per occurrence."""

    def __init__(self, fn, args) -> None:
        import torch
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        self.ops: list[str] = []
        self.syncs: list[str] = []
        trace = self
        marking = [0]  # > 0 while a marked op runs: its own aten ops are not marked again

        def run_marked(mark: str, func, args, kwargs, *, back_to_meta: bool):
            trace.syncs.append(mark)
            marking[0] += 1
            try:
                if not _any_meta(args, kwargs):
                    return func(*args, **kwargs)
                out = func(*_host_stand_in(args), **_host_stand_in(kwargs))
                return _to_meta(out) if back_to_meta else out
            finally:
                marking[0] -= 1

        class _Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = getattr(func, "__name__", "")
                this = args[0] if args else None
                if not marking[0] and _on_device(this):
                    if name in _HOST_READS:
                        return run_marked(_HOST_READS[name], func, args, kwargs, back_to_meta=False)
                    if name == "to":
                        device = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
                        if device is not None and device.type == "cpu":
                            return run_marked("cpu", func, args, kwargs, back_to_meta=False)
                return func(*args, **kwargs)

        class _Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.overloadpacket.__name__
                trace.ops.append(name)
                mark = None
                if not marking[0] and any(_on_device(a) for a in args):
                    mark = _sync_mark(torch, name, args, kwargs)
                if mark is None:
                    return func(*args, **kwargs)
                return run_marked(mark, func, args, kwargs, back_to_meta=name != "_local_scalar_dense")

        real_sync = torch.cuda.synchronize
        tracer_thread = threading.get_ident()

        def synchronize(device=None):
            # only the traced call is recorded; every other thread syncs for real
            if threading.get_ident() != tracer_thread:
                return real_sync(device)
            trace.syncs.append("synchronize")

        torch.cuda.synchronize = synchronize
        try:
            with _Functions(), _Dispatch():
                fn(*args)
        finally:
            torch.cuda.synchronize = real_sync


@dataclass
class DeepTarget:
    """One device-facing callable the deep rules analyze."""

    name: str
    kind: str  # "knn" | "encoder" | "decode"
    table: Any = None  # anchor Table for diagnostics (may be None)
    spec: dict = field(default_factory=dict)
    trace: dict | None = None  # {"name", "fn", "args"} from an ops hook
    #: True when the dispatching node sits on a streaming epoch path —
    #: every epoch re-enters it, so a host sync there is paid per epoch
    hot_loop: bool = False
    _ops: Any = None
    _ops_failed: bool = False

    def op_trace(self) -> OpTrace | None:
        """The :class:`OpTrace` of the callable the node dispatches, or None
        when no trace hook exists / tracing failed (the op-level checks
        then skip this target rather than failing analysis)."""
        if self._ops is None and not self._ops_failed and self.trace:
            try:
                self._ops = OpTrace(self.trace["fn"], self.trace["args"])
            except Exception:
                self._ops_failed = True
        return self._ops


def _anchor_is_streaming(view: GraphView, table) -> bool:
    if table is None:
        return False
    try:
        return any(view.is_streaming(src) for src in view.op_inputs(table._op))
    except Exception:
        return False


def build_targets(view: GraphView) -> list[DeepTarget]:
    """Materialize the deep targets of one parse graph: one KNN search
    target per device-backed index spec (plus an encoder target when the
    index carries a fused query encoder), and one decode-step target
    when the run configures the decode plane."""
    targets: list[DeepTarget] = []
    graph = view.graph
    ctx = getattr(graph, "run_context", None) or {}
    specs = [
        s
        for s in (getattr(graph, "external_indexes", None) or [])
        if s.get("device_backed")
    ]
    from ...ops import knn as ops_knn

    for spec in specs:
        table = spec.get("_table")
        hot = _anchor_is_streaming(view, table)
        dim = int(spec.get("dimensions") or 0)
        metric = spec.get("metric", "cos")
        try:
            trace = ops_knn.deep_trace_spec(spec)
        except Exception:
            trace = None
        targets.append(
            DeepTarget(
                name=f"knn.search[{metric},d={dim}]",
                kind="knn",
                table=table,
                spec=spec,
                trace=trace,
                hot_loop=hot,
            )
        )
        enc = spec.get("encoder")
        if enc:
            targets.append(
                DeepTarget(
                    name=(
                        f"encoder.fwd[seq<={enc.get('max_seq_len')},"
                        f"batch<={enc.get('max_batch')}]"
                    ),
                    kind="encoder",
                    table=table,
                    spec=spec,
                    hot_loop=hot,
                )
            )
    decode = ctx.get("decode")
    if decode:
        from ...ops import paged_attention as ops_pa

        try:
            trace = ops_pa.deep_trace_spec(decode)
        except Exception:
            trace = None
        targets.append(
            DeepTarget(
                name=(
                    f"decode.step[lanes={decode.get('lanes')},"
                    f"page={decode.get('page_size')}]"
                ),
                kind="decode",
                spec=dict(decode),
                trace=trace,
                hot_loop=True,
            )
        )
    return targets
