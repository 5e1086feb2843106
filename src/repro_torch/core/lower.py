"""Lowering: ChainPlan → linear physical IR (DESIGN.md §2).

The normalized chain plan is *logical*: its expressions hold symbolic
``Ref(var, attr)`` nodes and its predicate conditions name entity attributes.
Every execution strategy used to re-resolve those against the device DB inside
the traced function — measure-column lookups, seed-scalar capture and constant
condition-mask construction all re-ran on every prepare/trace. This pass does
that binding exactly once, producing a :class:`PhysicalPlan`:

  * a flat tuple of typed ops — ``SeedOp → (HopOp | EntityFilterOp |
    DegreeFilterOp)* → GroupOp`` — with device tensors (edge lists, measure
    columns, attribute columns, degree vectors) attached to the op that needs
    them;
  * expressions rewritten into *lowered* form (:data:`LExpr`): every Ref is
    replaced by an :class:`LCol` bound to its concrete column (plus a symbolic
    key, the column's address) or an :class:`LSeedScalar`;
  * predicate masks over entity domains split into a prebuilt constant mask
    (all non-parameter conditions, evaluated here, once) and a residual list
    of parameter-dependent :class:`LCond` rows evaluated per execute.

The strategies in :mod:`repro_torch.core.executor` are thin interpreters over
this IR; none of them touches :class:`repro_torch.core.algebra.ChainPlan`
again.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Union

import torch

from ..robust.errors import ExecutionError, PlanError
from ..storage import DenseColumn
from .algebra import (
    BinOp,
    Call,
    ChainPlan,
    Const,
    ConstCond,
    EntityStep,
    Expr,
    Param,
    Ref,
    RelHop,
    SeedIds,
    SeedMask,
    expr_refs,
)

# ---------------------------------------------------------------------------
# Lowered expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LConst:
    value: float


@dataclass(frozen=True)
class LParam:
    name: str


@dataclass(eq=False)
class LCol:
    """A concrete column: per-edge measure or per-entity attribute.

    ``key`` is the symbolic address — ``('edge', table, src_key, attr)`` or
    ``('attr', entity, attr)``.

    ``col`` is the bound :class:`repro_torch.storage.DeviceColumn`; consumers
    read ``array``, which decodes on demand (free for dense columns)."""

    key: tuple
    col: Any  # repro_torch.storage.DeviceColumn

    @property
    def array(self):
        return self.col.materialize()


@dataclass(eq=False)
class LSeedScalar:
    """Seed-entity attribute (e.g. d1.Year): a scalar once the seed id is
    known. Carries the full attribute column; execute gathers ``array[sid]``."""

    key: tuple  # ('attr', entity, attr)
    array: Any


@dataclass(frozen=True)
class LBin:
    op: str  # + - * /
    left: "LExpr"
    right: "LExpr"


@dataclass(frozen=True)
class LCall:
    fn: str  # abs
    args: tuple


LExpr = Union[LConst, LParam, LCol, LSeedScalar, LBin, LCall]


def eval_lexpr(e: LExpr, params: dict, scalars: dict, col):
    """Evaluate a lowered expression. ``col(LCol)`` supplies the column values
    (whole array for vector strategies, one element for the scalar strategy);
    ``scalars`` maps LSeedScalar keys to captured per-execution scalars. Only
    the selected binary op is evaluated (no wasted division by zero)."""
    if isinstance(e, LConst):
        return e.value
    if isinstance(e, LParam):
        return params[e.name]
    if isinstance(e, LCol):
        return col(e)
    if isinstance(e, LSeedScalar):
        return scalars[e.key]
    if isinstance(e, LBin):
        l = eval_lexpr(e.left, params, scalars, col)
        r = eval_lexpr(e.right, params, scalars, col)
        if e.op == "+":
            return l + r
        if e.op == "-":
            return l - r
        if e.op == "*":
            return l * r
        if e.op == "/":
            return l / r
        raise ExecutionError(
            f"unknown binary op {e.op} in lowered expression",
            retryable=False, op=e.op,
        )
    if isinstance(e, LCall):
        args = [eval_lexpr(a, params, scalars, col) for a in e.args]
        if e.fn == "abs":
            return abs(args[0])  # tensors and Python numbers alike
        raise ExecutionError(
            f"unknown function {e.fn} in lowered expression",
            retryable=False, fn=e.fn,
        )
    raise ExecutionError(
        f"unknown lowered expression node {type(e).__name__}",
        retryable=False, node=type(e).__name__,
    )


@dataclass(eq=False)
class LCond:
    """One parameter-dependent predicate row: col ⟨op⟩ value."""

    key: tuple  # ('attr', entity, attr)
    array: Any  # the attribute column
    op: str  # = > < >= <=
    value: Any  # LParam | number

    def mask(self, params: dict, col) -> torch.Tensor:
        c = col(self)
        v = params[self.value.name] if isinstance(self.value, LParam) else self.value
        return {
            "=": c == v, ">": c > v, "<": c < v, ">=": c >= v, "<=": c <= v,
        }[self.op]


# ---------------------------------------------------------------------------
# Physical ops
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class SeedOp:
    """Establish the initial frontier over ``entity``'s domain: either explicit
    ids (constants / parameters) or the ∧ of lowered sub-programs and entity
    predicates (IN-INTERSECT context mask). Also owns the seed-scalar capture:
    attribute columns whose ``[seed_id]`` element feeds downstream exprs."""

    entity: str
    dom: int
    var: str | None = None
    ids: tuple | None = None  # elements: int | LParam — None ⇒ mask seed
    programs: tuple = ()  # lowered sub-chain PhysicalPlans (bool semiring)
    const_mask: Any | None = None  # prebuilt ∧ of non-param entity conds
    param_conds: tuple = ()  # LCond, evaluated per execute
    scalars: dict = field(default_factory=dict)  # (var, attr) → LSeedScalar


@dataclass(eq=False)
class HopOp:
    """One ⋈/⋉ through I_{table.src_key}: gather ⊗ measure → scatter-⊕.

    ``dst_col`` is the index's device dst column (a
    :class:`repro_torch.storage.DeviceColumn`); ``dst_ids`` decodes on demand
    (free for dense columns)."""

    table: str
    src_key: str
    dst_entity: str
    dom_dst: int
    indptr: Any
    src_ids: Any
    dst_col: Any  # repro_torch.storage.DeviceColumn
    measure: LExpr | None = None
    semijoin: bool = False
    # per-block [src_min, src_max] skip metadata (DeviceIndex.block_src_*);
    # None when the index was built without it → hop always full-scans
    block_src_min: Any = None
    block_src_max: Any = None
    # the dst column's host values (the FragmentIndex column), read by the
    # fusion pass's reach matrix; None when the database has no host index
    host_dst: Any = None
    # DeviceIndex.hot_share: the packed hop aggregates per CTA from
    # kernels.params.HOP_TABLE_HOT_SHARE up (keyword only, no default)
    hot_share: float = field(kw_only=True)

    @property
    def dst_ids(self):
        return self.dst_col.materialize()


@dataclass(eq=False)
class DegreeFilterOp:
    """Existence projection of the hop's *source* side: frontier ∧ degree>0."""

    table: str
    src_key: str
    degrees: Any


@dataclass(eq=False)
class EntityFilterOp:
    """Per-domain elementwise ⊗-factor and/or predicate mask on an entity."""

    entity: str
    factor: LExpr | None = None
    const_mask: Any | None = None
    param_conds: tuple = ()


@dataclass(eq=False)
class GroupOp:
    """Final γ: dense accumulator over ``entity`` (None ⇒ membership mask)."""

    entity: str | None
    dom: int


@dataclass(eq=False)
class FusedHopOp:
    """A pipelined region: up to two adjacent HopOps plus any interleaved
    constant-mask EntityFilterOps and the trailing GroupOp, executed as ONE
    kernel launch (:mod:`repro_torch.kernels.fragment_spmv_fused`). The first
    hop accumulates the intermediate frontier ``u[n_mid]`` in a global-memory
    scratch buffer (L2-resident at the path's sizes); after a grid-wide
    barrier the second hop gathers from ``u``, applying the mid filter mask
    and a semijoin's binarize in registers — the intermediate is never read
    back by a second launch. A degenerate region (one hop and its filters)
    applies the mask at the hop's scatter.

    ``members`` is the original op sub-sequence (order preserved), so any
    interpreter without a fused kernel path replays them one by one and gets
    the same result. ``reach`` is an optional host-precomputed
    ``bool[nb1, nb2]`` block-to-block reachability matrix: hop2's active block
    list is derived from hop1's by OR-ing the rows of hop1's active blocks
    (conservative: a skipped hop2 block provably reads only ⊕-identity)."""

    members: tuple  # (HopOp | EntityFilterOp | GroupOp, ...)
    n_mid: int  # intermediate entity domain (hop1.dom_dst)
    reach: Any = None  # np.bool_[nb1, nb2] | None

    @property
    def hops(self) -> tuple:
        return tuple(m for m in self.members if isinstance(m, HopOp))

    @property
    def mid_filters(self) -> tuple:
        """Constant-mask EntityFilterOps between hop1 and hop2 (or after the
        sole hop of a degenerate 1-hop region)."""
        return tuple(m for m in self.members if isinstance(m, EntityFilterOp))

    @property
    def group(self):
        last = self.members[-1]
        return last if isinstance(last, GroupOp) else None


Op = Union[SeedOp, HopOp, DegreeFilterOp, EntityFilterOp, GroupOp, FusedHopOp]


def iter_flat_ops(phys: "PhysicalPlan"):
    """Yield the plan's ops with FusedHopOp regions expanded to their members
    (top level only — SeedOp sub-programs are separate plans)."""
    for op in phys.ops:
        if isinstance(op, FusedHopOp):
            yield from op.members
        else:
            yield op


@dataclass(eq=False)
class PhysicalPlan:
    ops: tuple
    param_names: tuple
    agg: str | None  # sum | count | min | max | avg | exists | None (mask)
    out_dom: int
    source: ChainPlan  # the logical plan this was lowered from

    def op_signature(self) -> list[str]:
        """Golden-test helper: compact one-line-per-op description."""

        def sig(op: Op) -> str:
            if isinstance(op, SeedOp):
                kind = "ids" if op.ids is not None else f"mask[{len(op.programs)}]"
                return f"Seed({op.entity}, {kind})"
            if isinstance(op, HopOp):
                flags = "".join(
                    f for f, c in ((";semijoin", op.semijoin), (";measure", op.measure))
                    if c
                )
                return f"Hop({op.table}.{op.src_key}->{op.dst_entity}{flags})"
            if isinstance(op, DegreeFilterOp):
                return f"DegreeFilter({op.table}.{op.src_key})"
            if isinstance(op, EntityFilterOp):
                flags = "".join(
                    f for f, c in (
                        (";factor", op.factor),
                        (";const_mask", op.const_mask is not None),
                        (";param_conds", op.param_conds),
                    ) if c
                )
                return f"EntityFilter({op.entity}{flags})"
            if isinstance(op, FusedHopOp):
                return "Fused[" + "+".join(sig(m) for m in op.members) + "]"
            return f"Group({op.entity})"

        return [sig(op) for op in self.ops]


# ---------------------------------------------------------------------------
# The lowering pass
# ---------------------------------------------------------------------------


def lower(db, plan: ChainPlan) -> PhysicalPlan:
    """Compile a normalized chain plan against a DeviceDB. ``db`` is
    :class:`repro_torch.core.executor.DeviceDB` (duck-typed: needs ``schema``,
    ``index()`` and ``entity_attrs``)."""
    from .executor import collect_params  # avoid import cycle at module load

    ops: list[Op] = [_lower_seed(db, plan)]
    for s in plan.steps:
        if isinstance(s, RelHop):
            di = db.index(s.table, s.src_key)
            if s.degree_filter:
                ops.append(DegreeFilterOp(s.table, s.src_key, di.degrees))
                continue
            measure = (
                _lower_expr(db, s.measure_expr, s, plan)
                if s.measure_expr is not None else None
            )
            hidx = (getattr(db, "host_indexes", None) or {}).get((s.table, s.src_key))
            ops.append(HopOp(
                s.table, s.src_key, s.dst_entity,
                db.schema.domain_size(s.dst_entity),
                di.indptr, di.src_ids, di.dst_col,
                measure=measure, semijoin=s.semijoin,
                block_src_min=getattr(di, "block_src_min", None),
                block_src_max=getattr(di, "block_src_max", None),
                hot_share=di.hot_share,
                host_dst=hidx.columns[s.dst_key].values if hidx is not None else None,
            ))
        else:  # EntityStep
            factor = (
                _lower_expr(db, s.factor_expr, s, plan)
                if s.factor_expr is not None else None
            )
            const_mask, pconds = _lower_conds(db, s.entity, s.conds)
            ops.append(EntityFilterOp(s.entity, factor, const_mask, pconds))

    out_entity = plan.group_entity
    if out_entity is None:
        out_dom = db.schema.domain_size(_final_entity(plan))
        ops.append(GroupOp(None, out_dom))
    else:
        out_dom = db.schema.domain_size(out_entity)
        ops.append(GroupOp(out_entity, out_dom))
    return PhysicalPlan(
        tuple(ops), tuple(collect_params(plan)), plan.agg, out_dom, plan
    )


def _lower_seed(db, plan: ChainPlan) -> SeedOp:
    seed = plan.seed
    if isinstance(seed, SeedIds):
        raw = seed.ids if isinstance(seed.ids, list) else [seed.ids]
        ids = tuple(LParam(i.name) if isinstance(i, Param) else int(i) for i in raw)
        scalars = (
            _seed_scalar_capture(db, plan, seed) if len(ids) == 1 else {}
        )
        return SeedOp(
            seed.entity, db.schema.domain_size(seed.entity),
            var=seed.var, ids=ids, scalars=scalars,
        )
    # SeedMask: lower each sub-chain into its own program (run under the
    # boolean semiring by the walker) + split the entity conditions
    programs = tuple(lower(db, chain) for chain in seed.chains)
    const_mask, pconds = _lower_conds(db, seed.entity, seed.entity_conds)
    return SeedOp(
        seed.entity, db.schema.domain_size(seed.entity),
        programs=programs, const_mask=const_mask, param_conds=pconds,
    )


def _seed_scalar_capture(db, plan: ChainPlan, seed: SeedIds) -> dict:
    """Columns whose [seed_id] element downstream expressions reference.
    A relationship-variable seed is itself the first hop, so refs to it are
    per-edge measures bound by that step — never scalars."""
    bound = {s.var for s in plan.steps}
    scalars: dict[tuple, LSeedScalar] = {}
    for s in plan.steps:
        e = s.measure_expr if isinstance(s, RelHop) else s.factor_expr
        if e is None:
            continue
        for r in expr_refs(e):
            if r.var == seed.var and r.var not in bound and (r.var, r.attr) not in scalars:
                scalars[(r.var, r.attr)] = LSeedScalar(
                    ("attr", seed.entity, r.attr),
                    db.entity_attrs[(seed.entity, r.attr)],
                )
    return scalars


def _lower_expr(db, e: Expr, step, plan: ChainPlan) -> LExpr:
    """Bind every Ref: step-local refs to the step's columns, seed refs to
    seed-scalar slots. Anything else was rejected by the planner."""
    if isinstance(e, Const):
        return LConst(float(e.value))
    if isinstance(e, Param):
        return LParam(e.name)
    if isinstance(e, Ref):
        if e.var == step.var:
            if isinstance(step, RelHop):
                di = db.index(step.table, step.src_key)
                return LCol(
                    ("edge", step.table, step.src_key, e.attr),
                    di.measure_cols[e.attr],
                )
            return LCol(
                ("attr", step.entity, e.attr),
                DenseColumn(db.entity_attrs[(step.entity, e.attr)]),
            )
        seed = plan.seed
        if isinstance(seed, SeedIds) and e.var == seed.var:
            return LSeedScalar(
                ("attr", seed.entity, e.attr),
                db.entity_attrs[(seed.entity, e.attr)],
            )
        raise PlanError(
            f"unresolvable reference {e.var}.{e.attr} while lowering",
            var=e.var, attr=e.attr, step=type(step).__name__,
        )
    if isinstance(e, BinOp):
        return LBin(e.op, _lower_expr(db, e.left, step, plan),
                    _lower_expr(db, e.right, step, plan))
    if isinstance(e, Call):
        return LCall(e.fn, tuple(_lower_expr(db, a, step, plan) for a in e.args))
    raise PlanError(
        f"unknown expression node {type(e).__name__} while lowering",
        node=type(e).__name__,
    )


def _lower_conds(db, entity: str, conds: list[ConstCond]):
    """Fold all constant-valued conditions into one prebuilt 0/1 mask (this is
    the work that used to rerun inside every traced call); parameter-valued
    conditions stay as LCond rows."""
    const_mask = None
    pconds: list[LCond] = []
    for c in conds:
        col = db.entity_attrs[(entity, c.ref.attr)]
        key = ("attr", entity, c.ref.attr)
        if isinstance(c.value, Param):
            pconds.append(LCond(key, col, c.op, LParam(c.value.name)))
            continue
        m = {
            "=": col == c.value, ">": col > c.value, "<": col < c.value,
            ">=": col >= c.value, "<=": col <= c.value,
        }[c.op].to(torch.float32)
        const_mask = m if const_mask is None else const_mask * m
    return const_mask, tuple(pconds)


def _final_entity(plan: ChainPlan) -> str:
    hops = [s for s in plan.steps if isinstance(s, RelHop) and not s.degree_filter]
    return hops[-1].dst_entity if hops else plan.seed.entity
