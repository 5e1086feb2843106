"""SQL subset parser for relationship queries (paper §4).

Supports exactly the relationship-query surface: SELECT with plain key columns
and COUNT(*)/EXISTS(*)/SUM(expr)/MIN(expr)/MAX(expr)/AVG(expr) aggregates
(arithmetic over measure/entity attributes, abs), FROM with JOIN..ON chains
(arbitrarily parenthesized) or comma lists, WHERE conjunctions of key-equality
join conditions / constant predicates / IN (sub-relationship-query) with
INTERSECT chains, GROUP BY on a single key. Parameters are written ``:name``
(prepare once, execute many — paper §3).

The aggregate chooses the execution semiring (DESIGN.md §3): SUM/COUNT run the
classic (+, ×) accumulator, MIN/MAX the (min/max, ×) lattices, EXISTS(*) pure
boolean reachability, and AVG a fused SUM+COUNT pair. Like the paper's
``SUM(e1)/e2 ≡ SUM(e1/e2)`` per-path convention (Fig. 3), arithmetic around an
aggregate call distributes into it — exact for SUM/AVG, and for MIN/MAX under
the engine's non-negative-factor contract.
"""
from __future__ import annotations

import re

from ..robust.errors import ParseError
from .algebra import (
    BinOp,
    Call,
    Const,
    ConstCond,
    Expr,
    JoinCond,
    Param,
    Query,
    Ref,
    SelectItem,
    Subquery,
    TableRef,
)

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<param>:[A-Za-z_]\w*)|(?P<name>[A-Za-z_]\w*)"
    r"|(?P<op>>=|<=|<>|!=|[(),.*/+\-=<>]))"
)

_KEYWORDS = {
    "select", "from", "where", "join", "on", "group", "by", "in",
    "intersect", "and", "count", "sum", "min", "max", "avg", "exists",
    "abs", "as",
}


def tokenize(sql: str) -> tuple[list[tuple[str, str]], list[int]]:
    """Token stream plus the character offset of each token in the (stripped)
    query text — the offsets feed :class:`ParseError` position context."""
    toks: list[tuple[str, str]] = []
    starts: list[int] = []
    pos = 0
    sql = sql.strip().rstrip(";")
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ParseError(
                f"unrecognized token at character {pos}",
                position=pos, near=sql[pos:pos + 30], query=sql,
            )
        starts.append(m.start(m.lastgroup))
        pos = m.end()
        if m.lastgroup == "num":
            toks.append(("num", m.group("num")))
        elif m.lastgroup == "param":
            toks.append(("param", m.group("param")[1:]))
        elif m.lastgroup == "name":
            w = m.group("name")
            toks.append(("kw", w.lower()) if w.lower() in _KEYWORDS else ("name", w))
        else:
            toks.append(("op", m.group("op")))
    return toks, starts


class _Parser:
    def __init__(self, toks: list[tuple[str, str]], starts: list[int] | None = None,
                 sql: str = ""):
        self.toks = toks
        self.starts = starts or []
        self.sql = sql
        self.i = 0

    def error(self, message: str, at: int | None = None) -> ParseError:
        """A :class:`ParseError` anchored at token index ``at`` (default: the
        current token), carrying the character position and nearby text."""
        j = min(at if at is not None else self.i, len(self.toks))
        pos = self.starts[j] if j < len(self.starts) else len(self.sql)
        return ParseError(
            message, position=pos, token_index=j,
            near=self.sql[pos:pos + 30] if self.sql else None, query=self.sql,
        )

    # -- token helpers ------------------------------------------------------
    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind: str, val: str | None = None) -> bool:
        t = self.peek()
        if t[0] == kind and (val is None or t[1] == val):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, val: str | None = None) -> str:
        t = self.next()
        if t[0] != kind or (val is not None and t[1] != val):
            raise self.error(
                f"expected {kind} {val or ''}, got {t[0]} {t[1]!r}", at=self.i - 1
            )
        return t[1]

    # -- grammar ------------------------------------------------------------
    def parse_query(self) -> Query:
        self.expect("kw", "select")
        select = [self.parse_select_item()]
        while self.accept("op", ","):
            select.append(self.parse_select_item())
        self.expect("kw", "from")
        tables, join_conds = self.parse_from()
        const_conds: list[ConstCond] = []
        if self.accept("kw", "where"):
            jc, cc = self.parse_conds()
            join_conds += jc
            const_conds += cc
        group_by = None
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by = self.parse_ref(allow_unqualified=True)
        return Query(select, tables, join_conds, const_conds, group_by)

    def parse_select_item(self) -> SelectItem:
        # COUNT(*) / EXISTS(*) | plain ref | expression containing an
        # aggregate call SUM/MIN/MAX/AVG(...)
        for star_agg in ("count", "exists"):
            if self.peek() == ("kw", star_agg):
                self.next()
                self.expect("op", "(")
                self.expect("op", "*")
                self.expect("op", ")")
                return SelectItem(expr=None, ref=None, agg=star_agg)
        start = self.i
        expr = self.parse_expr()
        if isinstance(expr, Ref) and self._expr_agg is None:
            return SelectItem(expr=None, ref=expr, agg=None)
        if self._expr_agg is not None:
            return SelectItem(expr=expr, ref=None, agg=self._expr_agg)
        self.i = start
        raise self.error(
            f"unsupported select item (expected a key column, COUNT(*)/EXISTS(*),"
            f" or an aggregate expression), at token {self.toks[start]}", at=start
        )

    def parse_from(self) -> tuple[list[TableRef], list[JoinCond]]:
        tables: list[TableRef] = []
        joins: list[JoinCond] = []

        def parse_source():
            if self.accept("op", "("):
                parse_source()
                self.expect("op", ")")
            else:
                tname = self.expect("name")
                var = self.expect("name") if self.peek()[0] == "name" else tname
                tables.append(TableRef(tname, var))
            while self.accept("kw", "join"):
                if self.accept("op", "("):
                    parse_source()
                    self.expect("op", ")")
                else:
                    tname2 = self.expect("name")
                    var2 = self.expect("name") if self.peek()[0] == "name" else tname2
                    tables.append(TableRef(tname2, var2))
                self.expect("kw", "on")
                l = self.parse_ref()
                self.expect("op", "=")
                r = self.parse_ref()
                joins.append(JoinCond(l, r))

        parse_source()
        while self.accept("op", ","):
            parse_source()
        return tables, joins

    def parse_conds(self) -> tuple[list[JoinCond], list[ConstCond]]:
        joins: list[JoinCond] = []
        consts: list[ConstCond] = []
        while True:
            ref = self.parse_ref()
            if self.accept("kw", "in"):
                consts.append(ConstCond(ref, "in", self.parse_in_rhs()))
            else:
                op = self.expect("op")
                if op not in ("=", ">", "<", ">=", "<="):
                    raise self.error(
                        f"unsupported predicate operator {op!r}", at=self.i - 1
                    )
                t = self.peek()
                if t[0] == "name":
                    joins.append(JoinCond(ref, self.parse_ref()))
                elif t[0] == "num":
                    self.next()
                    consts.append(ConstCond(ref, op, _num(t[1])))
                elif t[0] == "param":
                    self.next()
                    consts.append(ConstCond(ref, op, Param(t[1])))
                else:
                    raise self.error(
                        f"predicate right-hand side must be a column, number,"
                        f" or :parameter, got {t[0]} {t[1]!r}"
                    )
            if not self.accept("kw", "and"):
                break
        return joins, consts

    def parse_in_rhs(self) -> Subquery:
        """Both of the paper's forms:
        A: IN (SELECT …) INTERSECT (SELECT …) …   (IN parens = first subquery's)
        B: IN ( (SELECT …) INTERSECT (SELECT …) … )   (outer parens wrap chain)
        """
        self.expect("op", "(")
        queries: list[Query] = []
        if self.peek() == ("kw", "select"):
            queries.append(self.parse_query())
            self.expect("op", ")")
        else:
            self.expect("op", "(")
            queries.append(self.parse_query())
            self.expect("op", ")")
            while self.accept("kw", "intersect"):
                self.expect("op", "(")
                queries.append(self.parse_query())
                self.expect("op", ")")
            self.expect("op", ")")
        while self.accept("kw", "intersect"):
            self.expect("op", "(")
            queries.append(self.parse_query())
            self.expect("op", ")")
        return Subquery(queries[0], queries[1:])

    def parse_ref(self, allow_unqualified: bool = False) -> Ref:
        name = self.expect("name")
        if self.accept("op", "."):
            return Ref(name, self.expect("name"))
        if allow_unqualified:
            return Ref("", name)
        raise self.error(
            f"expected a qualified column reference (var.Attr), got bare {name!r}",
            at=self.i - 1,
        )

    # -- expressions --------------------------------------------------------
    _expr_agg: str | None = None  # aggregate kind seen inside the expression

    def parse_expr(self) -> Expr:
        self._expr_agg = None
        return self._add()

    def _add(self) -> Expr:
        e = self._mul()
        while True:
            if self.accept("op", "+"):
                e = BinOp("+", e, self._mul())
            elif self.accept("op", "-"):
                e = BinOp("-", e, self._mul())
            else:
                return e

    def _mul(self) -> Expr:
        e = self._atom()
        while True:
            if self.accept("op", "*"):
                e = BinOp("*", e, self._atom())
            elif self.accept("op", "/"):
                e = BinOp("/", e, self._atom())
            else:
                return e

    def _atom(self) -> Expr:
        t = self.peek()
        if t[0] == "kw" and t[1] in ("sum", "min", "max", "avg"):
            self.next()
            self.expect("op", "(")
            inner = self._add()
            self.expect("op", ")")
            if self._expr_agg is not None:
                # AGG(a)+AGG(b) would silently merge into AGG(a+b); that
                # identity holds for SUM only, not MIN/MAX/AVG — reject all
                raise self.error(
                    f"multiple aggregate calls ({self._expr_agg}, {t[1]}) "
                    "in one select item"
                )
            self._expr_agg = t[1]
            return inner  # AGG(e1)/e2 ≡ AGG(e1/e2): per-path accumulation (Fig. 3)
        if t == ("kw", "abs"):
            self.next()
            self.expect("op", "(")
            inner = self._add()
            self.expect("op", ")")
            return Call("abs", (inner,))
        if t[0] == "num":
            self.next()
            return Const(_num(t[1]))
        if t[0] == "param":
            self.next()
            return Param(t[1])
        if t[0] == "name":
            return self.parse_ref()
        if self.accept("op", "("):
            e = self._add()
            self.expect("op", ")")
            return e
        raise self.error(f"unexpected token in expression: {t[0]} {t[1]!r}")


def _num(s: str):
    return float(s) if "." in s else int(s)


def parse(sql: str) -> Query:
    toks, starts = tokenize(sql)
    p = _Parser(toks, starts, sql.strip().rstrip(";"))
    q = p.parse_query()
    if p.peek()[0] != "eof":
        raise p.error(f"trailing tokens after a complete query: {p.toks[p.i:]}")
    return q
