"""RQNA normalizer + physical planner (paper §3 "RQNA Normalizer", §6.1, Appendix 9.2).

Transforms the SQL AST into the left-deep normalized chain plan:
seed (σ on a key constant, or an intersection mask) → alternating relationship
hops / entity factor steps → single-key γ. Also the *verifier*: raises
``NotRelationshipQuery`` when the input falls outside the class (paper: the
normalizer "verifies whether an input SQL query is a relationship query").
"""
from __future__ import annotations

from dataclasses import dataclass

from .algebra import (
    BinOp,
    ChainPlan,
    Const,
    ConstCond,
    EntityStep,
    Expr,
    JoinCond,
    Param,
    Query,
    Ref,
    RelHop,
    SeedIds,
    SeedMask,
    SelectItem,
    Subquery,
    expr_refs,
    multiplicative_factors,
)
from ..robust.errors import PlanError
from .schema import Schema


class NotRelationshipQuery(PlanError):
    """The input falls outside the relationship-query class (or references
    unknown tables/columns/variables). A :class:`repro.robust.errors.PlanError`
    — and therefore still the ``ValueError`` it has always been."""


@dataclass
class _VarInfo:
    var: str
    table: str  # canonical schema name
    is_rel: bool


def _resolve_table(schema: Schema, name: str) -> str:
    for t in list(schema.entities) + list(schema.relationships):
        if t.lower() == name.lower():
            return t
    raise NotRelationshipQuery(
        f"unknown table {name}", table=name,
        known=sorted(list(schema.entities) + list(schema.relationships)),
    )


def plan_query(schema: Schema, q: Query) -> ChainPlan:
    vars: dict[str, _VarInfo] = {}
    for t in q.tables:
        tname = _resolve_table(schema, t.table)
        if t.var in vars:
            raise NotRelationshipQuery(f"duplicate variable {t.var}")
        vars[t.var] = _VarInfo(t.var, tname, schema.is_relationship(tname))

    def key_entity(ref: Ref) -> str:
        info = vars.get(ref.var)
        if info is None:
            raise NotRelationshipQuery(
                f"unknown variable {ref.var} (in {ref.var}.{ref.attr})",
                var=ref.var, attr=ref.attr, known=sorted(vars),
            )
        try:
            return schema.entity_of(info.table, ref.attr)
        except KeyError:
            raise NotRelationshipQuery(
                f"{ref.var}.{ref.attr} is not a key attribute of {info.table}",
                var=ref.var, attr=ref.attr, table=info.table,
            )

    # ---- classify constant conditions --------------------------------------
    seed_eq: list[ConstCond] = []  # key = const/param
    in_conds: list[ConstCond] = []
    attr_conds: list[ConstCond] = []  # entity attribute predicates
    for c in q.const_conds:
        info = vars.get(c.ref.var)
        if info is None:
            raise NotRelationshipQuery(
                f"unknown variable {c.ref.var} in WHERE predicate",
                var=c.ref.var, known=sorted(vars),
            )
        is_key = _is_key_attr(schema, info, c.ref.attr)
        if c.op == "in" and is_key:
            in_conds.append(c)
        elif c.op == "=" and is_key:
            seed_eq.append(c)
        elif not info.is_rel:
            attr_conds.append(c)
        else:
            raise NotRelationshipQuery(f"unsupported predicate {c}")

    # ---- find seed ----------------------------------------------------------
    steps: list[RelHop | EntityStep] = []
    bound: set[str] = set()
    domain: str  # current entity domain of the chain
    seed: SeedIds | SeedMask
    seed_var: str | None = None

    if seed_eq:
        c0 = seed_eq[0]
        ids = c0.value if len(seed_eq) == 1 else [cc.value for cc in seed_eq]
        if len(seed_eq) > 1 and any(cc.ref != c0.ref for cc in seed_eq):
            raise NotRelationshipQuery("multiple seeds on different attributes")
        ent = key_entity(c0.ref)
        seed = SeedIds(ent, ids, c0.ref.var)
        # only an entity-table seed exports per-seed scalar attributes (d1.Year);
        # a relationship-var seed's measures are per-edge, never scalars
        seed_var = c0.ref.var if not vars[c0.ref.var].is_rel else None
        domain = ent
        info = vars[c0.ref.var]
        if info.is_rel:
            # σ on a relationship FK: the seeded var itself is the first hop
            rel = schema.relationships[info.table]
            steps.append(
                RelHop(info.table, c0.ref.attr, rel.other_fk(c0.ref.attr), ent,
                       schema.entity_of(info.table, rel.other_fk(c0.ref.attr)),
                       c0.ref.var)
            )
            domain = steps[-1].dst_entity
        bound.add(c0.ref.var)
    elif in_conds:
        c0 = in_conds[0]
        ent = key_entity(c0.ref)
        chains, econds = _plan_subquery(schema, c0.value, ent)
        seed = SeedMask(ent, chains, econds)
        domain = ent
        info = vars[c0.ref.var]
        if not info.is_rel:
            raise NotRelationshipQuery("IN on entity variables not supported")
        rel = schema.relationships[info.table]
        steps.append(
            RelHop(info.table, c0.ref.attr, rel.other_fk(c0.ref.attr), ent,
                   schema.entity_of(info.table, rel.other_fk(c0.ref.attr)),
                   c0.ref.var, semijoin=True)
        )
        domain = steps[-1].dst_entity
        bound.add(c0.ref.var)
        in_conds = in_conds[1:]
    elif attr_conds and len(vars) == 1 and not q.join_conds:
        # pure entity predicate subquery, e.g. SELECT d.ID FROM Document d WHERE ...
        v = next(iter(vars.values()))
        if v.is_rel:
            raise NotRelationshipQuery("predicate on relationship measure")
        seed = SeedMask(v.table, [], attr_conds)
        domain = v.table
        bound.add(v.var)
        attr_conds = []
        seed_var = v.var
    else:
        raise NotRelationshipQuery("no seed selection found")

    if in_conds:
        raise NotRelationshipQuery("only one IN context supported per block")

    # ---- walk join conditions left-deep (fixpoint over SQL order) ----------
    remaining = list(q.join_conds)
    while remaining:
        progressed = False
        for jc in list(remaining):
            lb, rb = jc.left.var in bound, jc.right.var in bound
            if lb and rb:
                remaining.remove(jc)  # redundant/cycle edge: already navigated
                progressed = True
                continue
            if not (lb or rb):
                continue
            old, new = (jc.left, jc.right) if lb else (jc.right, jc.left)
            ent = key_entity(old)
            if key_entity(new) != ent:
                raise NotRelationshipQuery(f"join on mismatched domains {jc}")
            if ent != domain:
                raise NotRelationshipQuery(
                    f"non-left-deep join via {old.var}.{old.attr} (domain {domain}, need {ent})"
                )
            info = vars[new.var]
            if info.is_rel:
                rel = schema.relationships[info.table]
                dst = rel.other_fk(new.attr)
                steps.append(
                    RelHop(info.table, new.attr, dst, ent,
                           schema.entity_of(info.table, dst), new.var)
                )
                domain = steps[-1].dst_entity
            else:
                if new.attr.lower() != "id":
                    raise NotRelationshipQuery(f"entity join must be on ID: {jc}")
                steps.append(EntityStep(info.table, new.var))
            bound.add(new.var)
            remaining.remove(jc)
            progressed = True
        if not progressed:
            raise NotRelationshipQuery(f"disconnected join graph: {remaining}")

    # remaining entity-attribute predicates attach to the matching entity step
    for c in attr_conds:
        step = next(
            (s for s in steps
             if isinstance(s, EntityStep) and s.var == c.ref.var), None
        )
        if step is None:
            raise NotRelationshipQuery(f"predicate on unjoined variable {c}")
        step.conds.append(c)

    # ---- output / group ----------------------------------------------------
    group_ref = q.group_by
    plain_refs = [s.ref for s in q.select if s.ref is not None]
    aggs = [s for s in q.select if s.agg]
    if group_ref is not None:
        group_ref = _resolve_group_ref(schema, vars, group_ref, plain_refs)
        if len(aggs) != 1:
            raise NotRelationshipQuery("exactly one aggregate required with GROUP BY")
        agg_item = aggs[0]
        out_entity = key_entity(group_ref)
        _maybe_degree_filter(steps, group_ref, domain, out_entity, schema, vars)
        _attach_factors(schema, vars, steps, seed_var, agg_item)
        return ChainPlan(seed, steps, out_entity, group_ref, agg_item.agg)
    # mask-producing plan (subquery or non-aggregating top level)
    if len(plain_refs) != 1 or aggs:
        raise NotRelationshipQuery("subquery must project exactly one key column")
    out = plain_refs[0]
    out_entity = key_entity(out)
    _maybe_degree_filter(steps, out, domain, out_entity, schema, vars)
    return ChainPlan(seed, steps, None, None, None, output_ref=out)


def _is_key_attr(schema: Schema, info: _VarInfo, attr: str) -> bool:
    try:
        schema.entity_of(info.table, attr)
        return True
    except KeyError:
        return False


def _resolve_group_ref(schema, vars, group_ref: Ref, plain_refs: list[Ref]) -> Ref:
    """Handle the paper's loose GROUP BY forms: unqualified attr (CS: GROUP BY CID)
    and ``var.ID`` on a relationship variable (AS: GROUP BY da2.ID)."""
    if group_ref.var == "":
        cands = [r for r in plain_refs if r.attr.lower() == group_ref.attr.lower()]
        if len(cands) != 1:
            cands = [
                Ref(v.var, group_ref.attr) for v in vars.values()
                if _is_key_attr(schema, v, group_ref.attr)
            ]
        if len(cands) != 1:
            raise NotRelationshipQuery(
                f"ambiguous GROUP BY {group_ref.attr}", attr=group_ref.attr
            )
        return cands[0]
    info = vars.get(group_ref.var)
    if info is None:
        raise NotRelationshipQuery(
            f"GROUP BY references unknown variable {group_ref.var}",
            var=group_ref.var, known=sorted(vars),
        )
    if info.is_rel and not _is_key_attr(schema, info, group_ref.attr):
        cands = [r for r in plain_refs if r.var == group_ref.var]
        if len(cands) != 1:
            raise NotRelationshipQuery(f"cannot resolve GROUP BY {group_ref}")
        return cands[0]
    return group_ref


def _maybe_degree_filter(steps, out_ref: Ref, domain: str, out_entity: str,
                         schema, vars) -> None:
    """If the projected/group key is the *source* side of the variable's hop
    (e.g. ``SELECT da.Doc FROM DA da JOIN DT dt ON da.Doc = dt.Doc``), the hop
    is an existence filter: mask ∧ degree>0 (paper's semijoin-as-join)."""
    if not steps:
        return
    last = steps[-1]
    if (
        isinstance(last, RelHop)
        and last.var == out_ref.var
        and out_ref.attr == last.src_key
        and out_entity == last.src_entity
    ):
        last.degree_filter = True


def _attach_factors(schema, vars, steps, seed_var, agg_item: SelectItem) -> None:
    # COUNT(*) / EXISTS(*) carry no score expression: every path weighs 1̄
    if agg_item.agg in ("count", "exists") or agg_item.expr is None:
        return
    factors = multiplicative_factors(agg_item.expr)
    for f, inverted in factors:
        expr: Expr = BinOp("/", Const(1.0), f) if inverted else f
        fvars = {r.var for r in expr_refs(f)}
        non_seed = fvars - ({seed_var} if seed_var else set())
        if not fvars or not non_seed:
            # constant (or seed-only) factor: fold into the first hop
            target = next(s for s in steps if isinstance(s, RelHop))
            target.measure_expr = _mul(target.measure_expr, expr)
            continue
        if len(non_seed) != 1:
            raise NotRelationshipQuery(
                f"score factor mixes variables {non_seed}: not multiplicative per hop"
            )
        v = next(iter(non_seed))
        target = next((s for s in steps if s.var == v), None)
        if target is None:
            raise NotRelationshipQuery(f"score references unjoined variable {v}")
        if isinstance(target, RelHop):
            target.measure_expr = _mul(target.measure_expr, expr)
        else:
            target.factor_expr = _mul(target.factor_expr, expr)


def _mul(a: Expr | None, b: Expr) -> Expr:
    return b if a is None else BinOp("*", a, b)


def _plan_subquery(schema: Schema, sub: Subquery, expect_entity: str):
    chains: list[ChainPlan] = []
    econds: list[ConstCond] = []
    for qq in [sub.query] + sub.intersect:
        p = plan_query(schema, qq)
        if p.group_entity is not None:
            raise NotRelationshipQuery("aggregating subquery in IN context")
        ent = p.seed.entity if not p.steps else _chain_out_entity(p)
        if ent != expect_entity:
            raise NotRelationshipQuery(
                f"IN subquery domain {ent} != {expect_entity}"
            )
        if isinstance(p.seed, SeedMask) and not p.steps and not p.seed.chains:
            econds.extend(p.seed.entity_conds)  # pure predicate child
        else:
            chains.append(p)
    return chains, econds


def _chain_out_entity(p: ChainPlan) -> str:
    last_rel = [s for s in p.steps if isinstance(s, RelHop)]
    if not last_rel:
        return p.seed.entity
    h = last_rel[-1]
    return h.src_entity if h.degree_filter else h.dst_entity
