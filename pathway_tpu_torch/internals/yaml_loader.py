"""YAML pipeline config loader.

Rebuild of upstream Pathway's python/pathway/internals/yaml_loader.py
(:74-160): `$var` references and `!pw.module.Class` instantiation tags
used by the RAG templates. PyYAML is imported when ``load_yaml`` is
called, so the package imports without it."""

from __future__ import annotations

import importlib
from typing import Any, IO


class _PwTag:
    def __init__(self, path: str, kwargs: dict):
        self.path = path
        self.kwargs = kwargs

    def instantiate(self, variables: dict) -> Any:
        target = _resolve_path(self.path)
        kwargs = {k: _materialize(v, variables) for k, v in self.kwargs.items()}
        if kwargs:
            return target(**kwargs)
        # no-kwarg tag: return the object itself (class, function, constant)
        if callable(target) and not isinstance(target, type):
            return target
        if isinstance(target, type):
            return target()
        return target


def _resolve_path(path: str) -> Any:
    # progressive module import + attribute walk: handles subpackages
    # that the parent package does not import eagerly
    if path.startswith("pw."):
        parts = ["pathway_tpu_torch"] + path.split(".")[1:]
    else:
        parts = path.split(".")
    last_exc: Exception | None = None
    for split in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:split]))
            obj: Any = mod
            for a in parts[split:]:
                obj = getattr(obj, a)
            return obj
        except (ImportError, AttributeError) as e:
            if last_exc is None:
                last_exc = e  # the longest split carries the real cause
            continue
    raise ImportError(f"cannot resolve {path!r}") from last_exc


def _materialize(value: Any, variables: dict) -> Any:
    if isinstance(value, _PwTag):
        return value.instantiate(variables)
    if isinstance(value, str) and value.startswith("$"):
        name = value[1:]
        if name in variables:
            return _materialize(variables[name], variables)
        import os

        env = os.environ.get(name)
        if env is not None:
            return env
        raise KeyError(f"undefined variable {value!r}")
    if isinstance(value, dict):
        return {k: _materialize(v, variables) for k, v in value.items()}
    if isinstance(value, list):
        return [_materialize(v, variables) for v in value]
    return value


def _make_loader(yaml):
    class Loader(yaml.SafeLoader):
        pass

    def construct_pw(loader, suffix, node):
        if isinstance(node, yaml.MappingNode):
            kwargs = loader.construct_mapping(node, deep=True)
        else:
            kwargs = {}
        return _PwTag(suffix, kwargs)

    Loader.add_multi_constructor("!", lambda l, s, n: construct_pw(l, s, n))
    return Loader


def load_yaml(stream: str | IO) -> Any:
    """Load a YAML pipeline config, resolving $vars and !pw tags."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("pw.load_yaml needs PyYAML (the `yaml` module), which is not installed") from e
    data = yaml.load(stream, Loader=_make_loader(yaml))
    if not isinstance(data, dict):
        return _materialize(data, {})
    variables = {k: v for k, v in data.items() if k.startswith("$")}
    variables = {k[1:]: v for k, v in variables.items()}
    out = {}
    for k, v in data.items():
        if k.startswith("$"):
            continue
        out[k] = _materialize(v, variables)
    return out
