"""Minimal JMESPath-subset filter compiler.

The reference compiles JMESPath filters natively
(upstream Pathway's src/external_integration/mod.rs:9-14 via the jmespath
crate, with a custom ``globmatch`` function; used by DocumentStore
metadata filters, stdlib/ml/_knn_lsh.py:100-132). jmespath isn't in this
image, so this module implements the subset those filters actually use:

    field paths        a.b.c
    literals           `1`, `"x"`, 'x', numbers, true/false/null
    comparisons        == != < <= > >=
    boolean algebra    &&  ||  !  ( )
    functions          globmatch('pat', path), contains(field, 'x'),
                       starts_with(f, 'x'), ends_with(f, 'x')

compile_filter(src) -> callable(metadata_dict) -> bool
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable

_TOKENS = re.compile(
    r"""\s*(?:
        (?P<lit>`[^`]*`|'[^']*'|"[^"]*"|-?\d+\.\d+|-?\d+)
      | (?P<op>&&|\|\||==|!=|<=|>=|<|>|!|\(|\)|,)
      | (?P<name>[A-Za-z_][\w.]*)
    )""",
    re.VERBOSE,
)


class _Parser:
    def __init__(self, src: str):
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(src):
            m = _TOKENS.match(src, pos)
            if m is None:
                if src[pos:].strip() == "":
                    break
                raise ValueError(f"bad filter syntax at {src[pos:]!r}")
            pos = m.end()
            for kind in ("lit", "op", "name"):
                v = m.group(kind)
                if v is not None:
                    self.toks.append((kind, v))
                    break
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self, val=None):
        kind, v = self.peek()
        if val is not None and v != val:
            raise ValueError(f"expected {val!r}, got {v!r}")
        self.i += 1
        return kind, v

    # expr := or_expr
    def parse(self) -> Callable:
        e = self._or()
        if self.i != len(self.toks):
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return e

    def _or(self):
        left = self._and()
        while self.peek()[1] == "||":
            self.take()
            right = self._and()
            left = (lambda l, r: lambda m: bool(l(m)) or bool(r(m)))(left, right)
        return left

    def _and(self):
        left = self._not()
        while self.peek()[1] == "&&":
            self.take()
            right = self._not()
            left = (lambda l, r: lambda m: bool(l(m)) and bool(r(m)))(left, right)
        return left

    def _not(self):
        if self.peek()[1] == "!":
            self.take()
            inner = self._not()
            return lambda m: not bool(inner(m))
        return self._cmp()

    def _cmp(self):
        left = self._atom()
        kind, v = self.peek()
        if v in ("==", "!=", "<", "<=", ">", ">="):
            self.take()
            right = self._atom()
            ops = {
                "==": lambda a, b: a == b,
                "!=": lambda a, b: a != b,
                "<": lambda a, b: _num_cmp(a, b, lambda x, y: x < y),
                "<=": lambda a, b: _num_cmp(a, b, lambda x, y: x <= y),
                ">": lambda a, b: _num_cmp(a, b, lambda x, y: x > y),
                ">=": lambda a, b: _num_cmp(a, b, lambda x, y: x >= y),
            }
            op = ops[v]
            return (lambda l, r, op: lambda m: op(l(m), r(m)))(left, right, op)
        return left

    def _atom(self):
        kind, v = self.peek()
        if v == "(":
            self.take()
            e = self._or()
            self.take(")")
            return e
        if kind == "lit":
            self.take()
            return (lambda c: lambda m: c)(_literal(v))
        if kind == "name":
            self.take()
            if v in ("true", "false", "null"):
                c = {"true": True, "false": False, "null": None}[v]
                return (lambda c: lambda m: c)(c)
            nxt = self.peek()
            if nxt[1] == "(":
                return self._call(v)
            path = v.split(".")
            return (lambda p: lambda m: _lookup(m, p))(path)
        raise ValueError(f"unexpected token {v!r}")

    def _call(self, fname: str):
        self.take("(")
        args = []
        while self.peek()[1] != ")":
            args.append(self._or())
            if self.peek()[1] == ",":
                self.take()
        self.take(")")
        fns = {
            "globmatch": lambda pat, val: val is not None
            and _globmatch(str(pat), str(val)),
            "contains": lambda hay, needle: hay is not None and needle in hay,
            "starts_with": lambda s, p: s is not None and str(s).startswith(str(p)),
            "ends_with": lambda s, p: s is not None and str(s).endswith(str(p)),
        }
        if fname not in fns:
            raise ValueError(f"unsupported filter function {fname!r}")
        f = fns[fname]
        return (lambda f, args: lambda m: f(*[a(m) for a in args]))(f, args)


def _globmatch(pattern: str, value: str) -> bool:
    """wcmatch.globmatch semantics for the common cases: ``**`` crosses
    directory separators, ``*`` does not."""
    rx = re.escape(pattern)
    rx = rx.replace(r"\*\*", ".♦").replace(r"\*", "[^/]*").replace("♦", "*")
    rx = rx.replace(r"\?", "[^/]")
    return re.fullmatch(rx, value) is not None


def _num_cmp(a, b, op) -> bool:
    try:
        return bool(op(a, b))
    except TypeError:
        return False


def _literal(tok: str) -> Any:
    if tok.startswith("`") or tok.startswith("'") or tok.startswith('"'):
        inner = tok[1:-1]
        if tok.startswith("`"):
            import json

            try:
                return json.loads(inner)
            except ValueError:
                return inner
        return inner
    if "." in tok:
        return float(tok)
    return int(tok)


def _lookup(metadata, path: list[str]):
    cur = metadata
    if hasattr(cur, "value"):
        cur = cur.value  # pw.Json
    for part in path:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def compile_filter(src: str | None) -> Callable[[Any], bool] | None:
    """Compile a filter expression; None/empty -> None (match all)."""
    if src is None or not str(src).strip():
        return None
    pred = _Parser(str(src)).parse()

    def run(metadata) -> bool:
        meta = metadata
        if hasattr(meta, "value"):
            meta = meta.value
        if meta is None:
            meta = {}
        return bool(pred(meta))

    return run
