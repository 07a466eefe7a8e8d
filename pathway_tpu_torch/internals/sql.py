"""pw.sql — SQL to table-expression compiler.

Rebuild of upstream Pathway's python/pathway/internals/sql.py. The reference
uses sqlglot; this build ships a self-contained recursive-descent parser
covering the documented surface: SELECT (expressions, aliases, *), FROM,
WHERE, GROUP BY, HAVING, and the standard operators/aggregates."""

from __future__ import annotations

import re
from typing import Any

from . import dtype as dt
from .expression import ColumnExpression, ReducerExpression, smart_wrap, if_else
from .table import Table

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<str>'[^']*'|\"[^\"]*\")|"
    r"(?P<op><=|>=|!=|<>|=|<|>|\+|-|\*|/|%|\(|\)|,)|(?P<name>[A-Za-z_][A-Za-z_0-9.]*))"
)

_AGGS = {"count", "sum", "min", "max", "avg"}


class _Parser:
    def __init__(self, text: str, tables: dict[str, Table]):
        self.tokens = self._tokenize(text)
        self.pos = 0
        self.tables = tables
        self.current: Table | None = None

    @staticmethod
    def _tokenize(text: str) -> list[tuple[str, str]]:
        out = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m:
                if text[pos].isspace():
                    pos += 1
                    continue
                raise ValueError(f"SQL: cannot tokenize at {text[pos:pos+20]!r}")
            pos = m.end()
            if m.group("num"):
                out.append(("num", m.group("num")))
            elif m.group("str"):
                out.append(("str", m.group("str")[1:-1]))
            elif m.group("op"):
                out.append(("op", m.group("op")))
            else:
                out.append(("name", m.group("name")))
        return out

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else ("eof", "")

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def accept_kw(self, *kws) -> str | None:
        kind, val = self.peek()
        if kind == "name" and val.lower() in kws:
            self.pos += 1
            return val.lower()
        return None

    def expect_kw(self, kw):
        if not self.accept_kw(kw):
            raise ValueError(f"SQL: expected {kw!r}, got {self.peek()}")

    def accept_op(self, *ops) -> str | None:
        kind, val = self.peek()
        if kind == "op" and val in ops:
            self.pos += 1
            return val
        return None

    # ---- grammar ----

    def parse_select(self) -> Table:
        self.expect_kw("select")
        items: list[tuple[str | None, Any]] = []  # (alias, expr or "*")
        while True:
            if self.accept_op("*"):
                items.append((None, "*"))
            else:
                expr = self.parse_expr_deferred()
                alias = None
                if self.accept_kw("as"):
                    alias = self.next()[1]
                else:
                    kind, val = self.peek()
                    if kind == "name" and val.lower() not in (
                        "from", "where", "group", "having", "order", "limit",
                    ):
                        alias = self.next()[1]
                items.append((alias, expr))
            if not self.accept_op(","):
                break
        self.expect_kw("from")
        table = self._parse_from()
        self.current = table

        where_expr = None
        if self.accept_kw("where"):
            where_expr = self.parse_expr_deferred()
        group_cols: list[str] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                group_cols.append(self.next()[1])
                if not self.accept_op(","):
                    break
        having_expr = None
        if self.accept_kw("having"):
            having_expr = self.parse_expr_deferred()

        # materialize
        if where_expr is not None:
            table = table.filter(_build(where_expr, table, allow_agg=False))

        has_agg = any(
            it[1] != "*" and _contains_agg(it[1]) for it in items
        ) or group_cols
        if has_agg:
            # after FROM, qualified names resolve by their bare column
            grouped = table.groupby(*[table[c.split(".")[-1]] for c in group_cols])
            kwargs = {}
            for i, (alias, expr) in enumerate(items):
                if expr == "*":
                    raise ValueError("SQL: * not allowed with GROUP BY")
                name = alias or _default_name(expr, i)
                kwargs[name] = _build(expr, table, allow_agg=True)
            hidden: dict[str, Any] = {}
            if having_expr is not None:
                # aggregates inside HAVING become hidden reduce columns,
                # filtered on and then projected away
                having_expr = _extract_aggs(having_expr, hidden, table)
                kwargs.update(hidden)
            result = grouped.reduce(**kwargs)
            if having_expr is not None:
                result = result.filter(_build_on_result(having_expr, result))
                if hidden:
                    result = result.select(
                        **{n: result[n] for n in kwargs if n not in hidden}
                    )
            return result

        kwargs = {}
        for i, (alias, expr) in enumerate(items):
            if expr == "*":
                for n in table.column_names():
                    kwargs[n] = table[n]
                continue
            name = alias or _default_name(expr, i)
            kwargs[name] = _build(expr, table, allow_agg=False)
        return table.select(**kwargs)

    _CLAUSE_KWS = frozenset(
        {"from", "where", "group", "having", "order", "limit",
         "join", "inner", "left", "right", "full", "outer", "on", "as",
         "union", "intersect", "all"}
    )

    def _parse_table_ref(self):
        tname = self.next()[1]
        if tname not in self.tables:
            raise ValueError(f"SQL: unknown table {tname!r}")
        alias = None
        if self.accept_kw("as"):
            alias = self.next()[1]
        else:
            kind, val = self.peek()
            if kind == "name" and val.lower() not in self._CLAUSE_KWS:
                alias = self.next()[1]
        return self.tables[tname], alias or tname

    def _parse_from(self) -> Table:
        """FROM t [alias] (JOIN t2 [alias] ON cond)* — joins accumulate
        left-to-right; aliased dotted columns resolve per side."""
        current, alias = self._parse_table_ref()
        left_aliases = {alias}
        while True:
            how = None
            if self.accept_kw("join"):
                how = "inner"
            elif self.accept_kw("inner"):
                self.expect_kw("join")
                how = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                self.expect_kw("join")
                how = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                self.expect_kw("join")
                how = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                self.expect_kw("join")
                how = "outer"
            if how is None:
                break
            t2, alias2 = self._parse_table_ref()
            self.expect_kw("on")
            cond_ast = self.parse_expr_deferred()

            def resolver(fullname, _cur=current, _t2=t2, _a2=alias2, _la=frozenset(left_aliases)):
                if "." in fullname:
                    prefix, col = fullname.split(".", 1)
                    if prefix == _a2:
                        return _t2[col]
                    if prefix in _la:
                        return _cur[col]
                    raise ValueError(f"SQL: unknown table alias {prefix!r}")
                if fullname in _cur.column_names():
                    return _cur[fullname]
                return _t2[fullname]

            cond = _build(cond_ast, resolver, allow_agg=False)
            jr = current.join(t2, cond, how=how)
            proj = {n: current[n] for n in current.column_names()}
            for n in t2.column_names():
                # name collisions keep the qualified right-side column:
                # `b.v` must not silently resolve to the left table's v
                proj[n if n not in proj else f"{alias2}.{n}"] = t2[n]
            current = jr.select(**proj)
            left_aliases.add(alias2)
        return current

    # deferred expression AST: tuples
    def parse_expr_deferred(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.accept_kw("or"):
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept_kw("and"):
            left = ("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept_kw("not"):
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_add()
        op = self.accept_op("=", "!=", "<>", "<=", ">=", "<", ">")
        if op:
            right = self.parse_add()
            return ({"=": "==", "<>": "!="}.get(op, op), left, right)
        if self.accept_kw("is"):
            neg = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return ("is_not_null" if neg else "is_null", left)
        return left

    def parse_add(self):
        left = self.parse_mul()
        while True:
            op = self.accept_op("+", "-")
            if not op:
                return left
            left = (op, left, self.parse_mul())

    def parse_mul(self):
        left = self.parse_atom()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return left
            left = (op, left, self.parse_atom())

    def parse_atom(self):
        if self.accept_op("("):
            e = self.parse_expr_deferred()
            if not self.accept_op(")"):
                raise ValueError("SQL: expected )")
            return e
        if self.accept_op("-"):
            return ("neg", self.parse_atom())
        kind, val = self.next()
        if kind == "num":
            return ("lit", float(val) if "." in val else int(val))
        if kind == "str":
            return ("lit", val)
        if kind == "name":
            low = val.lower()
            if low in ("null",):
                return ("lit", None)
            if low in ("true", "false"):
                return ("lit", low == "true")
            if self.accept_op("("):
                args = []
                if self.accept_op("*"):
                    args.append("*")
                elif self.peek() != ("op", ")"):
                    args.append(self.parse_expr_deferred())
                    while self.accept_op(","):
                        args.append(self.parse_expr_deferred())
                if not self.accept_op(")"):
                    raise ValueError("SQL: expected ) after args")
                return ("call", low, args)
            return ("col", val)
        raise ValueError(f"SQL: unexpected token {val!r}")


def _contains_agg(node) -> bool:
    if isinstance(node, tuple):
        if node[0] == "call" and node[1] in _AGGS:
            return True
        return any(_contains_agg(c) for c in node[1:] if isinstance(c, (tuple, list)))
    return False


def _default_name(node, i: int) -> str:
    if isinstance(node, tuple) and node[0] == "col":
        return node[1].split(".")[-1]
    if isinstance(node, tuple) and node[0] == "call":
        return node[1]
    return f"col_{i}"


def _table_resolver(table: Table):
    def resolve(fullname: str):
        # qualified duplicates are materialized under their full name
        if fullname in table.column_names():
            return table[fullname]
        return table[fullname.split(".")[-1]]

    return resolve


def _build(node, resolver, allow_agg: bool) -> Any:
    from .. import reducers as red

    if not callable(resolver):  # accept a Table for convenience
        resolver = _table_resolver(resolver)
    if node == "*":
        raise ValueError("unexpected *")
    kind = node[0]
    if kind == "lit":
        return smart_wrap(node[1])
    if kind == "col":
        return resolver(node[1])
    if kind == "neg":
        return -_build(node[1], resolver, allow_agg)
    if kind == "not":
        from .expression import ColumnUnaryOpExpression

        return ColumnUnaryOpExpression("~", _build(node[1], resolver, allow_agg))
    if kind in ("and", "or"):
        a = _build(node[1], resolver, allow_agg)
        b = _build(node[2], resolver, allow_agg)
        return (a & b) if kind == "and" else (a | b)
    if kind in ("is_null", "is_not_null"):
        e = _build(node[1], resolver, allow_agg)
        return e.is_none() if kind == "is_null" else e.is_not_none()
    if kind == "call":
        fname, args = node[1], node[2]
        if fname in _AGGS:
            if not allow_agg:
                raise ValueError(f"SQL: aggregate {fname} not allowed here")
            if fname == "count":
                return red.count()
            arg = _build(args[0], resolver, allow_agg=False)
            return getattr(red, fname)(arg)
        if fname == "abs":
            return abs(_build(args[0], resolver, allow_agg))
        if fname == "coalesce":
            from .expression import coalesce

            return coalesce(*[_build(a, resolver, allow_agg) for a in args])
        raise ValueError(f"SQL: unknown function {fname!r}")
    # binary operator
    a = _build(node[1], resolver, allow_agg)
    b = _build(node[2], resolver, allow_agg)
    import operator

    ops = {
        "+": lambda x, y: x + y,
        "-": lambda x, y: x - y,
        "*": lambda x, y: x * y,
        "/": lambda x, y: x / y,
        "%": lambda x, y: x % y,
        "==": lambda x, y: x == y,
        "!=": lambda x, y: x != y,
        "<": lambda x, y: x < y,
        "<=": lambda x, y: x <= y,
        ">": lambda x, y: x > y,
        ">=": lambda x, y: x >= y,
    }
    return ops[kind](a, b)


def _extract_aggs(node, hidden: dict, table: Table):
    """Replace aggregate calls in a HAVING AST with references to
    hidden reduce columns (filled into ``hidden``)."""
    if isinstance(node, tuple):
        if node[0] == "call" and node[1] in _AGGS:
            name = f"_pw_having_{len(hidden)}"
            hidden[name] = _build(node, table, allow_agg=True)
            return ("col", name)
        return tuple(
            _extract_aggs(c, hidden, table) if isinstance(c, (tuple, list)) else c
            for c in node
        )
    if isinstance(node, list):
        return [
            _extract_aggs(c, hidden, table) if isinstance(c, (tuple, list)) else c
            for c in node
        ]
    return node


def _build_on_result(node, table: Table):
    # HAVING over reduced table: columns by alias/name
    return _build(node, table, allow_agg=False)


def sql(query: str, **tables: Table) -> Table:
    """Compile a SQL query over the given tables:

        pw.sql("SELECT a, SUM(b) AS total FROM t GROUP BY a", t=my_table)
    """
    parser = _Parser(query, tables)
    result = parser.parse_select()
    # set operations between SELECTs (reference sql.py:336 _union /
    # :352 _intersect): UNION ALL = concat; UNION/INTERSECT distinct
    def distinct(t: Table) -> Table:
        cols = [t[c] for c in t.column_names()]
        return t.groupby(*cols).reduce(*cols)

    def intersect_chain(left: Table) -> Table:
        # INTERSECT binds tighter than UNION (standard SQL precedence)
        while parser.accept_kw("intersect"):
            right = parser.parse_select()
            left = distinct(left).intersect(distinct(right))
        return left

    result = intersect_chain(result)
    while True:
        if parser.accept_kw("union") is None:
            break
        all_ = parser.accept_kw("all") is not None
        right = intersect_chain(parser.parse_select())
        result = result.concat_reindex(right)
        if not all_:
            result = distinct(result)
    if parser.peek()[0] != "eof":
        raise ValueError(
            f"SQL: unsupported trailing syntax at {parser.peek()[1]!r}"
        )
    return result
