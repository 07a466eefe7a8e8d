"""Row transformers (legacy "complex columns").

Rebuild of upstream Pathway's python/pathway/internals/row_transformer.py
(RowTransformer :26, ClassArg :148) + the engine machinery
(src/engine/dataflow/complex_columns.rs, `Computer` graph.rs:323, R31):
class-based per-row computations where output attributes may reference
OTHER rows — including recursively through pointers (the classic
linked-list length example) — with memoized evaluation.

Usage (reference-compatible surface):

    @pw.transformer
    class compute_lengths:
        class linked_list(pw.ClassArg):
            next = pw.input_attribute()

            @pw.output_attribute
            def len(self) -> int:
                if self.next is None:
                    return 0
                return 1 + self.transformer.linked_list[self.next].len

    result = compute_lengths(linked_list=my_table).linked_list

pw.method attributes are supported both as callables inside other
attributes (``self.c(x)``) and as METHOD COLUMNS: ``result.c`` holds a
per-row bound callable, and ``result.select(r=result.c(10))`` calls it
per row (reference Method machinery, row_transformer.py:254 +
complex_columns.rs). Method cells snapshot as (which, key, name)
sentinels and re-bind to the restored node.
"""

from __future__ import annotations

import weakref
from types import SimpleNamespace
from typing import Any, Callable

from ..engine import dataflow as df
from ..engine.value import ERROR, Pointer, rows_equal
from . import dtype as dt_mod
from .table import Column, LogicalOp, Table


class CycleError(Exception):
    """An output attribute transitively depends on itself (distinct
    from a genuine Python stack overflow on very deep acyclic chains)."""


class _InputAttribute:
    def __init__(self):
        self.name: str | None = None


class _OutputAttribute:
    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__


class _Attribute(_OutputAttribute):
    """Computed helper attribute: memoized but NOT materialized as an
    output column (reference pw.attribute)."""


class _MethodAttribute(_OutputAttribute):
    """Callable attribute: materializes as a column of per-row bound
    callables (reference pw.method, Method row_transformer.py:254)."""


def input_attribute(type: Any = None):  # noqa: A002 - reference signature
    return _InputAttribute()


def output_attribute(fn: Callable) -> _OutputAttribute:
    return _OutputAttribute(fn)


def attribute(fn: Callable) -> _Attribute:
    return _Attribute(fn)


def method(fn: Callable) -> "_MethodAttribute":
    return _MethodAttribute(fn)


class ClassArg:
    """Base for transformer inner classes. Subclass bodies declare
    pw.input_attribute() slots and @pw.output_attribute methods."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._inputs = {}
        cls._outputs = {}
        cls._computed = {}
        cls._methods = {}
        for base in reversed(cls.__mro__):
            for name, v in vars(base).items():
                if isinstance(v, _InputAttribute):
                    v.name = name
                    cls._inputs[name] = v
                elif isinstance(v, _Attribute):
                    cls._computed[name] = v
                elif isinstance(v, _MethodAttribute):
                    cls._methods[name] = v
                elif isinstance(v, _OutputAttribute):
                    cls._outputs[name] = v
        cls._input_index = {n: i for i, n in enumerate(cls._inputs)}


class _RowRef:
    """`self` inside attribute functions: reads input slots from the
    shared state, computes output/auxiliary attributes recursively with
    per-pass memoization."""

    __slots__ = ("_ctx", "_arg", "_key")

    def __init__(self, ctx, arg_name: str, key: int):
        self._ctx = ctx
        self._arg = arg_name
        self._key = key

    @property
    def id(self) -> Pointer:
        return Pointer(self._key)

    @property
    def transformer(self):
        return self._ctx.namespace

    def pointer_from(self, *args) -> Pointer:
        from ..engine.value import ref_scalar

        return Pointer(ref_scalar(*args))

    def __getattr__(self, name: str):
        return self._ctx.resolve(self._arg, self._key, name)


class _ArgAccessor:
    """transformer.<class_arg> namespace: indexable by Pointer."""

    __slots__ = ("_ctx", "_name")

    def __init__(self, ctx, name: str):
        self._ctx = ctx
        self._name = name

    def __getitem__(self, pointer) -> _RowRef:
        return _RowRef(self._ctx, self._name, int(pointer))


class _EvalContext:
    def __init__(self, spec: "Transformer", states: dict[str, dict[int, tuple]]):
        self.spec = spec
        self.states = states  # arg name -> key -> input row tuple
        self.memo: dict[tuple, Any] = {}
        self.in_progress: set[tuple] = set()
        self.namespace = SimpleNamespace(
            **{n: _ArgAccessor(self, n) for n in spec.args}
        )

    def resolve(self, arg: str, key: int, name: str):
        cls = self.spec.args[arg]
        if name in cls._inputs:
            row = self.states[arg].get(key)
            if row is None:
                raise KeyError(f"{arg}[{key:#x}] not present")
            return row[cls._input_index[name]]
        m = cls._methods.get(name)
        if m is not None:
            import functools

            return functools.partial(m.fn, _RowRef(self, arg, key))
        fn_holder = cls._outputs.get(name) or cls._computed.get(name)
        if fn_holder is None:
            raise AttributeError(f"{arg} has no attribute {name!r}")
        mk = (arg, key, name)
        if mk in self.memo:
            return self.memo[mk]
        if mk in self.in_progress:
            raise CycleError(
                f"cyclic attribute reference at {arg}.{name} for row {key:#x}"
            )
        self.in_progress.add(mk)
        try:
            value = fn_holder.fn(_RowRef(self, arg, key))
        finally:
            self.in_progress.discard(mk)
        self.memo[mk] = value
        return value


class BoundMethod:
    """A pw.method cell: calling it evaluates the method against the
    transformer's CURRENT state (reference MethodColumn semantics).
    Equality includes the transformer's state version, so any input
    change re-emits method rows and downstream consumers recompute
    (methods may read ANY row, so this is the sound invalidation)."""

    __slots__ = ("_node", "_spec_name", "_which", "_key", "_name", "_ver")

    def __init__(self, node, which: str, key: int, name: str, spec_name: str | None = None):
        self._node = node
        self._spec_name = (
            spec_name if spec_name is not None else (node.spec.name if node is not None else None)
        )
        self._which = which
        self._key = key
        self._name = name
        self._ver = getattr(node, "state_ver", 0) if node is not None else -1

    def __call__(self, *args):
        node = self._node
        if node is None:
            # a cell restored from another operator's snapshot (or sent
            # cross-process) re-binds lazily against the live transformer
            # node of this process
            node = _LIVE_TRANSFORMER_NODES.get((self._spec_name, self._which))
            if node is None:
                raise RuntimeError(
                    f"pw.method cell {self._which}.{self._name} was detached "
                    "from its transformer (serialized across a process or "
                    "snapshot boundary) and no live transformer node named "
                    f"{self._spec_name!r} exists in this process"
                )
            self._node = node
        ctx = _EvalContext(node.spec, node.states)
        return ctx.resolve(self._which, self._key, self._name)(*args)

    def _binding(self):
        return (self._which, self._key, self._name, self._ver)

    def __eq__(self, other):
        return isinstance(other, BoundMethod) and self._binding() == other._binding()

    def __hash__(self):
        return hash(self._binding())

    def __reduce__(self):
        # method cells can leak into downstream nodes' pickled state
        # (operator snapshots, cross-process rows): serialize the
        # binding, never the node (it holds locks/threads); the restored
        # cell re-binds lazily via _LIVE_TRANSFORMER_NODES on first call
        return (_detached_method, (self._spec_name, self._which, self._key, self._name))

    def __repr__(self):
        return f"<pw.method {self._which}.{self._name} @ {self._key:#x}>"


def _detached_method(spec_name, which, key, name):
    return BoundMethod(None, which, key, name, spec_name=spec_name)


#: live transformer nodes of this process, keyed by (transformer name,
#: class-arg name) — detached BoundMethods (restored from snapshots of
#: OTHER operators' state) resolve against this at call time. Weak so a
#: torn-down graph doesn't pin its nodes.
_LIVE_TRANSFORMER_NODES: "weakref.WeakValueDictionary[tuple, Any]" = (
    weakref.WeakValueDictionary()
)


class _RowTransformerNode(df.Node):
    """Engine node computing one class arg's output attributes. Inputs:
    every class arg's table (port per arg); recomputes affected rows'
    outputs per epoch against the full shared state (legacy semantics:
    these transformers run on small control tables)."""

    def __init__(self, graph, spec: "Transformer", which: str, arg_order: list[str]):
        self.n_inputs = len(arg_order)
        super().__init__(graph, f"RowTransformer:{which}")
        self.spec = spec
        self.which = which
        self.arg_order = arg_order
        self.states: dict[str, dict[int, tuple]] = {n: {} for n in arg_order}
        self.emitted: dict[int, tuple] = {}
        self.pending: dict[tuple, list] = {}  # out-of-order versions: df.apply_keyed
        self.state_ver = 0
        _LIVE_TRANSFORMER_NODES[(spec.name, which)] = self

    def snapshot_state(self):
        def enc(v):
            if isinstance(v, BoundMethod):
                return ("__pw_method__", v._which, v._key, v._name)
            return v

        return {
            "states": self.states,
            "emitted": {
                k: tuple(enc(v) for v in row) for k, row in self.emitted.items()
            },
        }

    def restore_state(self, state) -> None:
        def dec(v):
            if isinstance(v, tuple) and len(v) == 4 and v[0] == "__pw_method__":
                return BoundMethod(self, v[1], v[2], v[3])
            return v

        self.states = state["states"]
        self.emitted = {
            k: tuple(dec(v) for v in row) for k, row in state["emitted"].items()
        }

    def route_owner(self, key, row, port, n_shards):
        return 0  # cross-row pointer chasing needs the whole state

    def process(self, time):
        changed = False
        for port, arg in enumerate(self.arg_order):
            for key, row, diff in self.take(port):
                df.apply_keyed(self.states[arg], self.pending, (arg, key), key, row, diff)
                changed = True
        if not changed:
            return
        self.state_ver += 1
        ctx = _EvalContext(self.spec, self.states)
        cls = self.spec.args[self.which]
        out_names = list(cls._outputs)
        method_names = list(cls._methods)
        updates: list = []
        live = self.states[self.which]
        for key in live:
            try:
                row = tuple(
                    ctx.resolve(self.which, key, n) for n in out_names
                ) + tuple(
                    BoundMethod(self, self.which, key, n) for n in method_names
                )
            except Exception as exc:
                # per-row failure (dangling pointer, user bug): route it
                # like every other operator — abort, or ERROR cells + log
                self.graph.report_row_error(self, exc)
                row = tuple(ERROR for _ in out_names + method_names)
            old = self.emitted.get(key)
            if old is not None and rows_equal(old, row):
                continue
            if old is not None:
                updates.append((key, old, -1))
            updates.append((key, row, 1))
            self.emitted[key] = row
        for key in list(self.emitted):
            if key not in live:
                updates.append((key, self.emitted.pop(key), -1))
        self.emit(updates, time)


class Transformer:
    def __init__(self, name: str, args: dict[str, type[ClassArg]]):
        self.name = name
        self.args = args

    def __call__(self, *pos_tables: Table, **kw_tables: Table) -> SimpleNamespace:
        tables = dict(zip(self.args, pos_tables))
        tables.update(kw_tables)
        if set(tables) != set(self.args):
            raise TypeError(
                f"transformer {self.name} expects tables for {list(self.args)}, "
                f"got {list(tables)}"
            )
        arg_order = list(self.args)
        # project each arg table to its declared input attributes ONCE, in
        # declaration order (the node indexes rows positionally); sharing
        # the select tables lets lowering dedupe them across output nodes
        ins = [
            tables[n].select(**{a: tables[n][a] for a in self.args[n]._inputs})
            for n in arg_order
        ]
        out = {}
        for which, cls in self.args.items():
            cols = {
                n: Column(dt_mod.ANY)
                for n in list(cls._outputs) + list(cls._methods)
            }
            op = LogicalOp(
                "row_transformer",
                ins,
                {"spec": self, "which": which, "arg_order": arg_order},
            )
            out[which] = Table(
                cols, tables[which]._universe, op, name=f"{self.name}.{which}"
            )
        return SimpleNamespace(**out)


def transformer(cls) -> Transformer:
    """Class decorator: turn a namespace of ClassArg subclasses into a
    callable row transformer (reference pw.transformer)."""
    args = {
        name: v
        for name, v in vars(cls).items()
        if isinstance(v, type) and issubclass(v, ClassArg)
    }
    if not args:
        raise TypeError("pw.transformer class must contain ClassArg subclasses")
    return Transformer(cls.__name__, args)
