"""RQNA — Relationship Query Normalized Algebra (paper §4, Fig. 6).

Two levels:
  * the SQL-facing AST (``Query`` with joins / IN-subqueries / INTERSECT /
    GROUP BY), produced by :mod:`repro.core.sql`;
  * the normalized *chain plan* (paper's left-deep RQNA), produced by
    :mod:`repro.core.planner`: a seed over an entity domain, a sequence of
    relationship hops / entity factor steps, and a final single-key γ.

Expressions support the multiplicative score shapes of relationship queries
(products/quotients of measures, entity attributes and constants; ``abs``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Union

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Const:
    value: float


@dataclass(frozen=True)
class Param:
    """Named query parameter (prepare-once / execute-many, paper §3)."""

    name: str


@dataclass(frozen=True)
class Ref:
    var: str
    attr: str


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * /
    left: "Expr"
    right: "Expr"


@dataclass(frozen=True)
class Call:
    fn: str  # abs
    args: tuple["Expr", ...]


Expr = Union[Const, Param, Ref, BinOp, Call]


def expr_refs(e: Expr) -> set[Ref]:
    if isinstance(e, Ref):
        return {e}
    if isinstance(e, BinOp):
        return expr_refs(e.left) | expr_refs(e.right)
    if isinstance(e, Call):
        out: set[Ref] = set()
        for a in e.args:
            out |= expr_refs(a)
        return out
    return set()


def multiplicative_factors(e: Expr) -> list[tuple[Expr, bool]]:
    """Flatten into (factor, inverted) terms: e = Π f_i^(±1). Non-multiplicative
    structure stays inside a single factor."""
    if isinstance(e, BinOp) and e.op == "*":
        return multiplicative_factors(e.left) + multiplicative_factors(e.right)
    if isinstance(e, BinOp) and e.op == "/":
        return multiplicative_factors(e.left) + [
            (f, not inv) for f, inv in multiplicative_factors(e.right)
        ]
    return [(e, False)]


def eval_expr(e: Expr, env: dict[tuple[str, str], Any], params: dict[str, Any], np_mod):
    if isinstance(e, Const):
        return e.value
    if isinstance(e, Param):
        return params[e.name]
    if isinstance(e, Ref):
        return env[(e.var, e.attr)]
    if isinstance(e, BinOp):
        l = eval_expr(e.left, env, params, np_mod)
        r = eval_expr(e.right, env, params, np_mod)
        return {"+": l + r, "-": l - r, "*": l * r, "/": l / r}[e.op]
    if isinstance(e, Call):
        args = [eval_expr(a, env, params, np_mod) for a in e.args]
        if e.fn == "abs":
            return np_mod.abs(args[0])
        raise ValueError(f"unknown function {e.fn}")
    raise TypeError(e)


# ---------------------------------------------------------------------------
# SQL-facing AST
# ---------------------------------------------------------------------------


@dataclass
class TableRef:
    table: str
    var: str


@dataclass
class JoinCond:
    left: Ref
    right: Ref


@dataclass
class ConstCond:
    ref: Ref
    op: str  # = > < >= <= in
    value: Any  # number | Param | Subquery | list (for op 'in' on values)


@dataclass
class Subquery:
    """A SELECT projecting one column, possibly INTERSECTed with others."""

    query: "Query"
    intersect: list["Query"] = field(default_factory=list)


@dataclass
class SelectItem:
    expr: Expr | None  # None for plain column
    ref: Ref | None
    agg: str | None  # count | sum | min | max | avg | exists | None


@dataclass
class Query:
    select: list[SelectItem]
    tables: list[TableRef]
    join_conds: list[JoinCond]
    const_conds: list[ConstCond]
    group_by: Ref | None = None

    def var_table(self, var: str) -> str:
        for t in self.tables:
            if t.var == var:
                return t.table
        raise KeyError(var)


# ---------------------------------------------------------------------------
# Normalized chain plan (RQNA physical form)
# ---------------------------------------------------------------------------


@dataclass
class SeedIds:
    """σ_{key=c}: one or more constant/parameter entity ids."""

    entity: str
    ids: Any  # int | Param | list[int|Param]
    var: str  # the seeded variable (its entity attrs become seed scalars)


@dataclass
class SeedMask:
    """Context mask over an entity domain: intersection of sub-chains and/or
    entity-attribute predicates (paper Fig. 6 lines 5-7)."""

    entity: str
    chains: list["ChainPlan"]
    entity_conds: list[ConstCond] = field(default_factory=list)


@dataclass
class RelHop:
    """One ⋈ (or ⋉ when ``semijoin``) through I_{table.src_key}."""

    table: str
    src_key: str
    dst_key: str
    src_entity: str
    dst_entity: str
    var: str
    measure_expr: Expr | None = None  # per-edge factor, refs only this var
    semijoin: bool = False  # binarize incoming weights (dedup, paper §6.1)
    degree_filter: bool = False  # project src entity itself (mask ∧ degree>0)


@dataclass
class EntityStep:
    """Entity-table variable joined on its ID: per-domain elementwise factor
    and/or predicate mask; may also export seed scalars (e.g. d1.Year)."""

    entity: str
    var: str
    factor_expr: Expr | None = None  # refs this var's attrs + seed scalars
    conds: list[ConstCond] = field(default_factory=list)


@dataclass
class ChainPlan:
    seed: SeedIds | SeedMask
    steps: list[RelHop | EntityStep]
    group_entity: str | None  # None → plan yields a mask/id-set (subquery)
    group_ref: Ref | None
    agg: str | None  # count | sum | min | max | avg | exists (picks the semiring)
    output_ref: Ref | None = None  # projected column for mask-producing plans

    def domains(self) -> list[str]:
        doms = [self.seed.entity]
        for s in self.steps:
            if isinstance(s, RelHop) and not s.degree_filter:
                doms.append(s.dst_entity)
        return doms
