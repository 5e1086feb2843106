"""Plan execution over the lowered physical IR, on torch tensors.

Every strategy is a *thin interpreter* over the IR built by
:mod:`repro_torch.core.lower`: one continuation-passing walker
(:func:`walk_ir`) folds the op sequence, and a strategy chooses the primitive
each op maps to. The ``frontier`` strategy is bottom-up, fully pipelined
execution over dense per-entity-domain frontier vectors, where each HopOp is
one call of :func:`repro_torch.kernels.ops.fragment_spmv` or, when
the index's columns are stored bit-packed by the device column store
(:mod:`repro_torch.storage`), of the decode-fused
:func:`repro_torch.kernels.ops.fragment_spmv_packed`, which decodes dst ids and
measures inside the hop (the paper's compression-inside-the-operator design)
— hand-written CUDA kernels on the card, their plain PyTorch versions on the
CPU. With block skipping engaged each hop runs the ``*_active`` variant over
the blocks its frontier reaches. A pipelined region of the plan (a
:class:`repro_torch.core.lower.FusedHopOp`, formed at prepare by
:mod:`repro_torch.core.fuse`) runs as one launch of
:func:`repro_torch.kernels.ops.fragment_spmv_fused`. Intermediates are
vectors, never materialized join tables. PyTorch runs eagerly, so a compiled
query is a plain Python closure over the lowered plan. The batched form
(:func:`compile_frontier_batched`, behind ``PreparedQuery.execute_batch``)
carries ``[B, dom]`` frontier matrices through the same walker, and each
HopOp becomes one batched hop (:func:`repro_torch.kernels.ops.fragment_spmm`
and its decode-fused and fused-region forms) that reads the edges once for
all B parameter bindings. The ``fragment_loop`` strategy
(:func:`compile_fragment_loop`) is the paper's fragment-at-a-time walk,
vectorised over the paths it holds: each hop expands every path over its
source's fragment and reads only the reached fragments' edges. The
``distributed`` strategy (:func:`compile_frontier_distributed`) runs one
process a rank over ``torch.distributed``: edges sharded across the ranks of
a mesh, frontiers replicated, each hop this rank's hop kernel over its shard
and one all_reduce.

Aggregation semantics are pluggable: the walker is parameterized by a
:class:`repro_torch.core.semiring.Semiring`, so SUM/COUNT, MIN/MAX, EXISTS and
the fused AVG pair all execute through the same code path. The result is the
dense γ accumulator ℛ over the group-by entity domain (the paper's
aggregation array; size = domain of the group key).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import ops as K
from ..kernels import params as KP
from ..kernels.active import active_flags, block_ranges
from ..kernels.cuda_build import KernelError
from ..obs import trace as T
from ..robust.errors import DeadlineExceeded, ExecutionError, ResourceError, ValidationError
from ..robust.runner import check_deadline, current_deadline, deadline_scope
from ..storage import (
    DenseColumn,
    DeviceColumn,
    DictPackedColumn,
    PackedColumn,
    build_device_column,
    column_uniques,
    resolve_device_encoding,
)
from .algebra import ChainPlan, EntityStep, Param, SeedIds
from .fragments import FragmentIndex
from .lower import (
    DegreeFilterOp,
    EntityFilterOp,
    FusedHopOp,
    GroupOp,
    HopOp,
    LBin,
    LCall,
    LCol,
    LParam,
    PhysicalPlan,
    SeedOp,
    eval_lexpr,
    iter_flat_ops,
    lower,
)
from .schema import Schema
from .semiring import BOOL_OR_AND, Semiring, semiring_for

#: The global device-encoding modes (a per-column dict is the other form),
#: block-skipping modes and fusion modes this port runs.
DEVICE_ENCODING_MODES = ("auto", "dense", "packed")
BLOCK_SKIPPING_MODES = K.BLOCK_SKIPPING_MODES
FUSION_MODES = K.FUSION_MODES


def require_supported(option: str, value, supported: tuple) -> None:
    """Raise unless ``value`` is one of ``supported``."""
    if value in supported:
        return
    raise ValidationError(
        f"{option} must be one of {supported}, got {value!r}",
        **{option: value, "valid": supported},
    )


@dataclass
class DeviceIndex:
    """Device-resident form of one FragmentIndex: CSR structure tensors plus
    the co-stored columns as :class:`repro_torch.storage.DeviceColumn`s.
    ``dst_ids`` / ``measures`` decode on demand (free for dense columns)."""

    indptr: torch.Tensor  # int32[h+1]
    src_ids: torch.Tensor  # int32[E]  (CSR row ids expanded; sorted)
    dst_col: DeviceColumn  # int32[E]
    degrees: torch.Tensor | None = None
    measure_cols: dict[str, DeviceColumn] = field(default_factory=dict)
    # per-EDGE_BLOCK [src_min, src_max] over the CSR-ordered edge arrays
    # (kernels/active.py), int32 on the index's device — the block-skipping
    # metadata; None disables skipping for this index
    block_src_min: torch.Tensor | None = None
    block_src_max: torch.Tensor | None = None
    # the hottest destination's share of the edges (largest dst degree / E),
    # from the host dst column where the index is built: the packed hop
    # aggregates per CTA from kernels.params.HOP_TABLE_HOT_SHARE up
    hot_share: float = field(kw_only=True)

    @property
    def dst_ids(self) -> torch.Tensor:
        return self.dst_col.materialize()

    @property
    def measures(self) -> dict[str, torch.Tensor]:
        return {m: c.materialize() for m, c in self.measure_cols.items()}


@dataclass
class DeviceDB:
    schema: Schema
    indexes: dict[tuple[str, str], DeviceIndex]
    entity_attrs: dict[tuple[str, str], torch.Tensor]
    host_indexes: dict[tuple[str, str], FragmentIndex]
    # the attached integrity manifest (storage/integrity.py), None until one
    # is attached
    integrity: dict | None = None

    def index(self, table: str, key: str) -> DeviceIndex:
        return self.indexes[(table, key)]

    @property
    def device(self) -> torch.device:
        """Where the tensors live (the CPU for a database without any)."""
        for di in self.indexes.values():
            return di.src_ids.device
        for a in self.entity_attrs.values():
            return a.device
        return torch.device("cpu")


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array → a device tensor of ``dtype`` that owns its memory (the
    caller's array may be read-only or shared)."""
    np_dtype = {torch.int32: np.int32, torch.float32: np.float32}[dtype]
    return torch.tensor(np.asarray(a, dtype=np_dtype), device=device)


def dst_hot_share(dst_values) -> float:
    """The largest destination degree over the edge count of a host dst
    column (0.0 for an empty one)."""
    d = np.asarray(dst_values)
    return float(np.bincount(d.astype(np.int64)).max()) / d.shape[0] if d.shape[0] else 0.0


def make_device_index(indptr, src_ids, dst_col: DeviceColumn,
                      measure_cols: dict[str, DeviceColumn], device,
                      dst_values) -> DeviceIndex:
    """One index on ``device`` from host structure arrays and its columns
    (already on ``device``): int32 structure and the block-range metadata,
    moved to the device once here, and the hot share of ``dst_values`` (the
    host dst column)."""
    src = np.asarray(src_ids)
    bmin, bmax = block_ranges(src)
    indptr = np.asarray(indptr)
    return DeviceIndex(
        indptr=to_device(indptr, torch.int32, device),
        src_ids=to_device(src, torch.int32, device),
        dst_col=dst_col,
        degrees=to_device(np.diff(indptr), torch.int32, device),
        measure_cols=dict(measure_cols),
        block_src_min=to_device(bmin, torch.int32, device),
        block_src_max=to_device(bmax, torch.int32, device),
        hot_share=dst_hot_share(dst_values),
    )


def check_device_encodings(device_encodings) -> None:
    """A global mode of :data:`DEVICE_ENCODING_MODES` or a per-column dict."""
    if not isinstance(device_encodings, dict):
        require_supported("device_encodings", device_encodings, DEVICE_ENCODING_MODES)


def build_device_db(
    schema: Schema,
    host_indexes: dict[tuple[str, str], FragmentIndex],
    device_encodings: str | dict = "auto",
    device="cuda",
) -> DeviceDB:
    """Ship every fragment index to ``device`` under the storage policy.

    ``device_encodings``: ``"auto"`` (§5-style chooser, the default) |
    ``"dense"`` (decoded-CSR baseline) | ``"packed"`` (force BCA wherever it
    fits) | a per-column dict ``{(table, key, column): encoding}`` with
    ``"auto"`` filling unspecified columns. Every key of a per-column dict
    must name a real (table, key, column) address — a typo'd override would
    otherwise be silently ignored."""
    check_device_encodings(device_encodings)
    dev: dict[tuple[str, str], DeviceIndex] = {}
    seen_addrs: set[tuple[str, str, str]] = set()
    for (table, key), idx in host_indexes.items():
        other = next(c for c in idx.columns if c != key and _is_fk(schema, table, c))
        cf = cf_dst = idx.columns[other]
        seen_addrs.add((table, key, other))
        enc = resolve_device_encoding(
            device_encodings, (table, key, other), cf.values, cf.domain, is_key=True
        )
        dst_col = build_device_column(cf, enc, torch.int32, device)
        measure_cols = {}
        for m, cf in idx.columns.items():
            if m == other:
                continue
            seen_addrs.add((table, key, m))
            uq = column_uniques(cf.values)  # one scan shared by chooser and encoder
            enc = resolve_device_encoding(
                device_encodings, (table, key, m), cf.values, cf.domain,
                is_key=False, uniques=uq,
            )
            measure_cols[m] = build_device_column(cf, enc, torch.float32, device,
                                                  uniques=uq)
        dev[(table, key)] = make_device_index(
            idx.indptr, idx.src_ids(), dst_col, measure_cols, device, cf_dst.values,
        )
    if isinstance(device_encodings, dict):
        unknown = set(device_encodings) - seen_addrs
        if unknown:
            raise ValidationError(
                f"device_encodings keys match no index column: {sorted(unknown)}; "
                f"valid addresses: {sorted(seen_addrs)}",
                unknown=sorted(unknown),
            )
    attrs = {
        (e.name, a): to_device(col, torch.float32, device)
        for e in schema.entities.values()
        for a, col in e.attributes.items()
    }
    return DeviceDB(schema, dev, attrs, host_indexes)


def _is_fk(schema: Schema, table: str, attr: str) -> bool:
    rel = schema.relationships[table]
    return attr in (rel.fk1, rel.fk2)


# ---------------------------------------------------------------------------
# Parameter handling
# ---------------------------------------------------------------------------


def collect_params(plan: ChainPlan) -> list[str]:
    names: list[str] = []

    def add(v):
        if isinstance(v, Param) and v.name not in names:
            names.append(v.name)

    def walk(p: ChainPlan):
        if isinstance(p.seed, SeedIds):
            ids = p.seed.ids if isinstance(p.seed.ids, list) else [p.seed.ids]
            for i in ids:
                add(i)
        else:
            for c in p.seed.chains:
                walk(c)
            for cc in p.seed.entity_conds:
                add(cc.value)
        for s in p.steps:
            if isinstance(s, EntityStep):
                for cc in s.conds:
                    add(cc.value)

    walk(plan)
    return names


def ensure_lowered(db: DeviceDB, plan: ChainPlan | PhysicalPlan) -> PhysicalPlan:
    return plan if isinstance(plan, PhysicalPlan) else lower(db, plan)


def densify_plan(phys: PhysicalPlan) -> PhysicalPlan:
    """Materialize every packed column bound in the IR, once, producing an
    all-dense twin of the plan — the path for a caller that needs decoded
    columns (the reference's fragment_loop and distributed strategies take
    it; the port's fragment_loop reads packed columns by ``gather``
    instead)."""

    def dcol(col: DeviceColumn) -> DeviceColumn:
        return col if isinstance(col, DenseColumn) else DenseColumn(col.materialize())

    def dexpr(e):
        if isinstance(e, LCol) and not isinstance(e.col, DenseColumn):
            return LCol(e.key, dcol(e.col))
        if isinstance(e, LBin):
            return LBin(e.op, dexpr(e.left), dexpr(e.right))
        if isinstance(e, LCall):
            return LCall(e.fn, tuple(dexpr(a) for a in e.args))
        return e

    def dop(op):
        if isinstance(op, HopOp):
            return dataclasses.replace(
                op, dst_col=dcol(op.dst_col),
                measure=dexpr(op.measure) if op.measure is not None else None,
            )
        if isinstance(op, SeedOp) and op.programs:
            return dataclasses.replace(
                op, programs=tuple(densify_plan(p) for p in op.programs)
            )
        if isinstance(op, EntityFilterOp) and op.factor is not None:
            return dataclasses.replace(op, factor=dexpr(op.factor))
        return op

    return PhysicalPlan(
        tuple(dop(op) for op in phys.ops), phys.param_names, phys.agg,
        phys.out_dom, phys.source,
    )


def _host_scalar(v):
    """numpy scalars and 0-d arrays → Python numbers, so that parameter
    arithmetic with device tensors stays in torch (numpy would try to pull a
    CUDA tensor to the host)."""
    if isinstance(v, (np.generic, np.ndarray)):
        return np.asarray(v).item()
    return v


# ---------------------------------------------------------------------------
# The shared lowered-IR walker
# ---------------------------------------------------------------------------


def walk_ir(phys: PhysicalPlan, interp: "_Interp", stop: int | None = None):
    """Fold the op sequence through ``interp``. Continuation-passing so the
    scalar strategy carries its paths through the rest of the plan from
    inside each hop.

    ``stop`` truncates the walk to the first ``stop`` ops and returns the raw
    interpreter state (no finalize): the profiling prefix entry.

    While an observability tracer is recording (``obs.trace``) every op runs
    in a span of its own, fenced, with its hop metadata: the per-op
    breakdown behind ``PreparedQuery.profile()``. With no tracer the walk is
    the plain fold. Both read the ambient query deadline
    (``robust.runner.check_deadline``: one ContextVar read when none is set)
    at each op's entry."""
    ops = phys.ops if stop is None else phys.ops[:stop]
    if T.current() is not None:
        return _walk_ir_recorded(phys, ops, interp)

    def go(i: int, state):
        if i == len(ops):
            return state
        op = ops[i]
        check_deadline(type(op).__name__)
        return interp.apply(op, state, lambda st: go(i + 1, st))

    return go(0, None)


def _annotate_op_span(sp, op, state, interp) -> None:
    """Static and observed metadata for one op span: shapes, the skipping
    mode and, for a HopOp with a frontier vector coming in, the observed
    support and active-block count (computed on the frontier's device; only
    the counts reach the host). A FusedHopOp region reports one span
    annotated with its member ops and its first hop's frontier metadata. The
    scalar walk's state is a set of paths, not a frontier: its hops carry
    only the static part."""
    if isinstance(op, FusedHopOp):
        sp.annotate(
            fused=True,
            members=[
                f"Hop({m.table}.{m.src_key}->{m.dst_entity})"
                if isinstance(m, HopOp) else type(m).__name__
                for m in op.members
            ],
        )
        _annotate_op_span(sp, op.hops[0], state, interp)
        return
    if not isinstance(op, HopOp):
        return
    E = int(op.src_ids.shape[0])
    sp.annotate(
        table=op.table, src_key=op.src_key, E=E, dom_dst=int(op.dom_dst),
        block_skipping=getattr(interp, "block_skipping", None),
    )
    if not isinstance(state, torch.Tensor):
        return
    sup = state != interp.sr.zero
    if sup.dim() == 2:
        sup = sup.any(dim=0)
    if sup.shape[0] != op.indptr.shape[0] - 1:
        return
    touched = int(((op.indptr[1:] - op.indptr[:-1]) * sup).sum())
    sp.annotate(
        frontier_nnz=int(sup.sum()),
        observed_active_fraction=round(touched / max(E, 1), 6),
    )
    if op.block_src_min is not None:
        n_blocks = int(op.block_src_min.shape[0])
        active = int(active_flags(sup, op.block_src_min, op.block_src_max).sum())
        sp.annotate(active_blocks=active, n_blocks=n_blocks,
                    active_block_fraction=round(active / n_blocks, 6))


def _walk_ir_recorded(phys: PhysicalPlan, ops, interp: "_Interp"):
    """The instrumented fold: one span per op, nested along the continuation
    chain (op k's span contains ops k+1..n, so self time = wall − children).
    The card is synchronised at each op's entry, and the span's
    ``kernel_ms`` is the fenced time from its entry to the op's own output
    being done (the first time its continuation runs). An op whose
    continuation runs several times (a chunked scalar hop) counts them in
    ``calls``; one whose continuation never ran is closed after ``apply``
    returns and flagged ``fused_tail``."""
    labels = phys.op_signature()
    plan_key = id(phys.ops)

    def go(i: int, state):
        if i == len(ops):
            return state
        op = ops[i]
        check_deadline(labels[i])
        with T.span(labels[i], op_index=i, plan=plan_key) as sp:
            T.sync()
            _annotate_op_span(sp, op, state, interp)
            t0 = time.perf_counter()
            seen = [0]

            def cont(st):
                seen[0] += 1
                if seen[0] == 1:
                    sp.annotate(dispatch_ms=round((time.perf_counter() - t0) * 1e3, 4))
                    sp.fence(st)
                return go(i + 1, st)

            out = interp.apply(op, state, cont)
            if seen[0] == 0:
                sp.annotate(dispatch_ms=round((time.perf_counter() - t0) * 1e3, 4),
                            fused_tail=True)
                sp.fence(out)
            sp.annotate(calls=max(seen[0], 1))
        return out

    return go(0, None)


def execute_ir(phys: PhysicalPlan, make_interp) -> torch.Tensor:
    """Strategy-independent top level: pick the semiring for the plan's
    aggregate, run the walker (twice for AVG's fused SUM+COUNT pair), and
    apply the output convention."""
    sr = semiring_for(phys.agg)
    if phys.agg == "avg":
        s = walk_ir(phys, make_interp(sr, True))
        c = walk_ir(phys, make_interp(sr, False))
        return torch.where(c > 0, s / c, 0.0)
    return sr.finalize(walk_ir(phys, make_interp(sr, True)))


class _Interp:
    """Op dispatch + parameter/seed-scalar environment shared by strategies."""

    def __init__(self, params: dict[str, Any], sr: Semiring, use_measures: bool = True):
        self.params = params
        self.sr = sr
        self.use_measures = use_measures
        self.scalars: dict[tuple, Any] = {}

    def apply(self, op, state, cont):
        if isinstance(op, SeedOp):
            return self.seed(op, state, cont)
        if isinstance(op, HopOp):
            return self.hop(op, state, cont)
        if isinstance(op, DegreeFilterOp):
            return self.degree_filter(op, state, cont)
        if isinstance(op, EntityFilterOp):
            return self.entity_filter(op, state, cont)
        if isinstance(op, GroupOp):
            return self.group(op, state, cont)
        if isinstance(op, FusedHopOp):
            return self.fused_hop(op, state, cont)
        raise ExecutionError(
            f"no interpreter rule for op {type(op).__name__}",
            retryable=False, op=type(op).__name__,
            strategy=type(self).__name__,
        )

    def fused_hop(self, op: FusedHopOp, state, cont):
        """Default semantics of a fused region: replay its member ops through
        the ordinary per-op rules. The frontier strategy overrides this with
        the single-launch kernel."""
        members = op.members

        def go(i: int, st):
            if i == len(members):
                return cont(st)
            return self.apply(members[i], st, lambda s2: go(i + 1, s2))

        return go(0, state)

    def resolve(self, v):
        return self.params[v.name] if isinstance(v, LParam) else v

    def capture_scalars(self, op: SeedOp, sid):
        self.scalars = {
            s.key: self.attr_col(s)[sid] for s in op.scalars.values()
        }

    def col(self, c):
        return c.array

    def attr_col(self, c):
        return c.array


# ---------------------------------------------------------------------------
# Frontier strategy
# ---------------------------------------------------------------------------


class _FrontierInterp(_Interp):
    """Dense frontier vectors; each hop is one fused gather⊗measure→scatter-⊕
    kernel call.

    Frontier sparsity: each hop passes the index's per-block src-range
    metadata to the kernel dispatch, so with ``block_skipping`` 'on' or
    'auto' the blocks the support cannot reach are never streamed. There is
    no per-hop test for an all-zero frontier: with a frontier of
    ⊕-identities the kernel's result is already the identity vector under
    every op (and the block list is empty), and a test on the host would
    cost one device sync per hop. A fused region gets none either.

    Fused regions (``fusion`` 'on' or 'auto'): one launch per region, its
    reach matrix taken from ``reach`` (the device copies made once per
    compiled plan, keyed by the region's ``id``)."""

    def __init__(self, params: dict[str, Any], sr: Semiring,
                 use_measures: bool = True, use_kernel: bool = True,
                 device="cuda", block_skipping: str = "auto",
                 fusion: str = "auto", reach: dict | None = None):
        super().__init__(params, sr, use_measures)
        self.use_kernel = use_kernel
        self.device = torch.device(device)
        self.block_skipping = block_skipping
        self.fusion = fusion
        self.reach = reach or {}

    def spawn(self) -> "_FrontierInterp":
        """Interpreter for a mask sub-program (always the boolean semiring)."""
        return _FrontierInterp(
            self.params, BOOL_OR_AND, use_kernel=self.use_kernel,
            device=self.device, block_skipping=self.block_skipping,
            fusion=self.fusion, reach=self.reach,
        )

    def col(self, c):
        """Column values for an expression: a packed column decodes whole
        (``bitunpack``), with the plain version when the kernels are off."""
        return c.col.materialize(self.use_kernel)

    def blocks_for(self, op: HopOp):
        """The hop's (src_min, src_max) skip metadata, or None when absent or
        skipping is off — kernel dispatch treats both as 'full scan'."""
        if self.block_skipping == "off" or op.block_src_min is None:
            return None
        return (op.block_src_min, op.block_src_max)

    def seed(self, op: SeedOp, state, cont):
        sr = self.sr
        if op.ids is not None:
            # scatter-⊕, not set: duplicate seed ids must accumulate
            # multiplicity under the sum semiring (matches the oracle)
            ids = [int(self.resolve(i)) for i in op.ids]
            w = torch.full((op.dom,), sr.zero, dtype=torch.float32, device=self.device)
            w = sr.scatter(w, _seed_index(ids, op.dom, self.device), sr.one)
            if op.scalars:
                self.capture_scalars(op, int(self.resolve(op.ids[0])))
            return cont(w)
        m = torch.ones(op.dom, dtype=torch.float32, device=self.device)
        for prog in op.programs:
            m = m * walk_ir(prog, self.spawn())
        if op.const_mask is not None:
            m = m * op.const_mask
        for c in op.param_conds:
            m = m * c.mask(self.params, self.attr_col).to(torch.float32)
        return cont(sr.from_mask(m))

    def hop(self, op: HopOp, state, cont):
        w = self.sr.binarize(state) if op.semijoin else state
        return cont(self._hop_body(w, op))

    def _hop_body(self, w, op: HopOp):
        """One hop: the decode-fused kernel when a column is packed, else the
        dense one."""
        out = self.spmv_fused(w, op)
        if out is not None:
            return out
        return K.fragment_spmv(
            w, op.src_ids, op.dst_ids, self._dense_measure(op), n_dst=op.dom_dst,
            op=self.sr.name, use_kernel=self.use_kernel,
            blocks=self.blocks_for(op), block_skipping=self.block_skipping,
            hot_share=op.hot_share,
        )

    def _dense_measure(self, op: HopOp):
        """The hop's measure expression evaluated to float32[E] (decoding any
        packed column it reads), or None for a measure-free hop (the kernel
        reads measure 1)."""
        if op.measure is None or not self.use_measures:
            return None
        mv = eval_lexpr(op.measure, self.params, self.scalars, self.col)
        mv = torch.as_tensor(mv, dtype=torch.float32, device=self.device)
        return mv.expand(op.src_ids.shape[0]).contiguous()  # no copy when already [E]

    def _packed_layout(self, op: HopOp):
        """Classify the hop's physical layout for the decode-fused kernel:
        None when nothing is packed (all-dense hop), else ``(dst_packed,
        m_mode, m_operand, m_width, mdict)``. A ``dense`` m_mode leaves
        ``m_operand`` None: the caller evaluates the measure expression."""
        dst_packed = isinstance(op.dst_col, PackedColumn)
        m = op.measure if self.use_measures else None
        if m is None:
            m_mode, m_operand, m_width, mdict = "none", None, 0, None
        elif isinstance(m, LCol) and isinstance(m.col, PackedColumn):
            m_mode, m_operand, m_width, mdict = "packed", m.col.words, m.col.width, None
        elif isinstance(m, LCol) and isinstance(m.col, DictPackedColumn):
            m_mode, m_operand, m_width, mdict = (
                "dict", m.col.words, m.col.width, m.col.dictionary,
            )
        else:
            m_mode, m_operand, m_width, mdict = "dense", None, 0, None
        if not (dst_packed or m_mode in ("packed", "dict")):
            return None
        return dst_packed, m_mode, m_operand, m_width, mdict

    def spmv_fused(self, w, op: HopOp):
        """Decode-fused hop: stream packed columns straight into the kernel.
        Engaged when the dst column is bit-packed and/or the measure is a
        single packed column; None when there is nothing to fuse (all-dense
        hop) and the dense kernel runs instead."""
        layout = self._packed_layout(op)
        if layout is None:
            return None
        dst_packed, m_mode, m_operand, m_width, mdict = layout
        if m_mode == "dense":
            # a measure expression over a packed index: evaluate it (decoding
            # any packed column it reads) and stream it dense; dst still
            # decodes inside the hop
            m_operand = self._dense_measure(op)
        return K.fragment_spmv_packed(
            w, op.src_ids,
            op.dst_col.words if dst_packed else op.dst_col.materialize(),
            m_operand, mdict,
            n_dst=op.dom_dst,
            dst_width=op.dst_col.width if dst_packed else 0,
            m_mode=m_mode, m_width=m_width, op=self.sr.name,
            use_kernel=self.use_kernel,
            blocks=self.blocks_for(op), block_skipping=self.block_skipping,
            hot_share=op.hot_share,
        )

    # -- pipelined fused regions ---------------------------------------------

    def _hop_operands(self, op: HopOp, reach=None) -> K.FusedHopOperands | None:
        """One HopOp → the fused entry's operand bundle (packed columns stream
        as words; a measure expression is evaluated to float32[E]), or None
        when the hop's measure differs from row to row of a batch (the fused
        kernels take one shared measure stream)."""
        layout = self._packed_layout(op)
        if layout is None:
            dst_packed, m_operand, m_width, mdict = False, None, 0, None
            m_mode = "dense" if op.measure is not None and self.use_measures else "none"
        else:
            dst_packed, m_mode, m_operand, m_width, mdict = layout
        if m_mode == "dense":
            m_operand = self._dense_measure(op)
            if m_operand.dim() == 2:
                return None
        return K.FusedHopOperands(
            src_ids=op.src_ids,
            dst=op.dst_col.words if dst_packed else op.dst_col.materialize(),
            measure=m_operand, mdict=mdict, n_dst=op.dom_dst,
            dst_width=op.dst_col.width if dst_packed else 0,
            m_mode=m_mode, m_width=m_width,
            blocks=self.blocks_for(op), reach=reach, hot_share=op.hot_share,
        )

    def _fused_region_args(self, op: FusedHopOp):
        """The region's kernel arguments: the two hop bundles, the product of
        the member filters' constant masks, and whether hop2's semijoin entry
        binarizes the intermediate. None when a hop has no bundle: the region
        then replays its members."""
        hops = op.hops
        h1_op = hops[0]
        h2_op = hops[1] if len(hops) > 1 else None
        hop1 = self._hop_operands(h1_op)
        hop2 = (self._hop_operands(h2_op, reach=self.reach.get(id(op)))
                if h2_op is not None else None)
        if hop1 is None or (h2_op is not None and hop2 is None):
            return None
        mid_mask = None
        for f in op.mid_filters:
            if f.const_mask is None:
                continue
            m = torch.as_tensor(f.const_mask, dtype=torch.float32, device=self.device)
            mid_mask = m if mid_mask is None else mid_mask * m
        mid_binarize = bool(h2_op.semijoin) if h2_op is not None else False
        return h1_op, hop1, hop2, mid_mask, mid_binarize

    def fused_hop(self, op: FusedHopOp, state, cont):
        """A fused region in one launch: hop1 accumulates into the kernel's
        scratch frontier, hop2 gathers from it through the member filters'
        constant mask (binarized for a semijoin); a degenerate region masks
        at its hop's scatter. A region whose group has no entity ends in the
        membership mask."""
        if self.fusion == "off":
            return super().fused_hop(op, state, cont)
        args = self._fused_region_args(op)
        if args is None:
            return super().fused_hop(op, state, cont)
        h1_op, hop1, hop2, mid_mask, mid_binarize = args
        w = self.sr.binarize(state) if h1_op.semijoin else state
        out = self._fused_call(w, hop1, hop2, mid_mask, mid_binarize)
        g = op.group
        if g is not None and g.entity is None:
            out = self.sr.to_mask(out)
        return cont(out)

    def _fused_call(self, w, hop1, hop2, mid_mask, mid_binarize):
        return K.fragment_spmv_fused(
            w, hop1, hop2, mid_mask, op=self.sr.name, mid_binarize=mid_binarize,
            use_kernel=self.use_kernel, fusion=self.fusion,
            block_skipping=self.block_skipping,
        )

    def degree_filter(self, op: DegreeFilterOp, state, cont):
        return cont(self.sr.mask(state, op.degrees > 0))

    def entity_filter(self, op: EntityFilterOp, state, cont):
        w = state
        if op.factor is not None and self.use_measures:
            f = eval_lexpr(op.factor, self.params, self.scalars, self.col)
            w = self.sr.extend(w, torch.as_tensor(f, dtype=torch.float32, device=self.device))
        if op.const_mask is not None:
            w = self.sr.mask(w, op.const_mask)
        for c in op.param_conds:
            w = self.sr.mask(w, c.mask(self.params, self.attr_col))
        return cont(w)

    def group(self, op: GroupOp, state, cont):
        if op.entity is None:
            return cont(self.sr.to_mask(state))
        return cont(state)


def _seed_index(ids: list[int], dom: int, device) -> torch.Tensor:
    """Seed ids as a device index, with the reference's scatter semantics:
    a negative id counts from the end of the domain, and an id outside the
    domain is dropped (it seeds nothing)."""
    kept = [i + dom if -dom <= i < 0 else i for i in ids]
    kept = [i for i in kept if 0 <= i < dom]
    return torch.tensor(kept, dtype=torch.int64).to(device)


def device_reach(phys: PhysicalPlan, device) -> dict[int, torch.Tensor]:
    """Every fused region's reach matrix (mask sub-programs included) copied
    to ``device`` once, keyed by the region's ``id``."""
    out: dict[int, torch.Tensor] = {}
    for op in phys.ops:
        if isinstance(op, FusedHopOp) and op.reach is not None:
            out[id(op)] = torch.as_tensor(np.asarray(op.reach, dtype=bool), device=device)
        elif isinstance(op, SeedOp):
            for p in op.programs:
                out.update(device_reach(p, device))
    return out


def compile_frontier(
    db: DeviceDB, plan: ChainPlan | PhysicalPlan, block_skipping: str = "auto",
    use_kernel: bool = True, fusion: str = "auto",
) -> Callable[..., torch.Tensor]:
    """Lower once; return ``run(*args)`` that executes the plan with the
    parameters bound positionally (in ``phys.param_names`` order) and returns
    the result tensor on the database's device, without synchronising.
    ``use_kernel=False`` runs every hop (and every whole-column decode)
    through the plain versions instead of the CUDA kernels (the on-card
    comparison). The plan's fused regions (made by
    :func:`repro_torch.core.fuse.fuse_plan`) run in one launch each unless
    ``fusion`` is 'off'; their reach matrices reach the device here, once
    (``run.reach`` holds the copies)."""
    require_supported("block_skipping", block_skipping, BLOCK_SKIPPING_MODES)
    require_supported("fusion", fusion, FUSION_MODES)
    phys = ensure_lowered(db, plan)
    names = list(phys.param_names)
    device = db.device
    reach = device_reach(phys, device) if fusion != "off" else {}

    def run(*args):
        params = {n: _host_scalar(a) for n, a in zip(names, args)}
        return execute_ir(
            phys,
            lambda sr, um: _FrontierInterp(
                params, sr, um, use_kernel=use_kernel, device=device,
                block_skipping=block_skipping, fusion=fusion, reach=reach,
            ),
        )

    run.reach = reach
    return run


# ---------------------------------------------------------------------------
# Batched frontier strategy (the multi-query SpMM serving path)
# ---------------------------------------------------------------------------


def _seed_rows(ids: np.ndarray, dom: int) -> tuple[np.ndarray, np.ndarray]:
    """``[B, k]`` seed ids → ``(index, kept)``, :func:`_seed_index`'s rules
    row by row: a negative id counts from the end of the domain and an id
    outside it is dropped. A dropped slot keeps index 0 with ``kept`` False,
    so it scatters the ⊕-identity and the array stays rectangular."""
    ids = np.where((ids < 0) & (ids >= -dom), ids + dom, ids)
    kept = (ids >= 0) & (ids < dom)
    return np.where(kept, ids, 0), kept


class _BatchedFrontierInterp(_FrontierInterp):
    """Frontier semantics with a leading batch axis: frontiers are ``[B,
    dom]`` matrices, and each HopOp is one batched hop
    (:func:`repro_torch.kernels.ops.fragment_spmm` or its decode-fused form),
    which streams the index's edges once for all B rows — not a loop over
    rows, so the kernel sees the batch as a unit. Parameters arrive as ``[B,
    1]`` device columns, so expressions over per-entity ``[dom]`` or
    per-edge ``[E]`` arrays broadcast to ``[B, ·]``; the seed ids come from
    the same parameters on the host (``host_params``). Per-op rules:

      * SeedOp — one 2-D scatter for the B rows' seed ids; mask seeds run
        their sub-programs batched; seed scalars are ``[B, 1]`` columns;
      * HopOp — the block list is the union of the rows' supports; a measure
        that depends on the row (a parameter or a seed scalar) is a ``[B,
        E]`` stream for the dense kernel's row stride;
      * FusedHopOp — one launch of the region's SpMM form, unless a hop's
        measure depends on the row (the members replay then);
      * EntityFilter / DegreeFilter / GroupOp — masks and factors are
        ``[dom]`` or ``[B, dom]`` and broadcast over the rows.
    """

    def __init__(self, params: dict[str, Any], sr: Semiring, use_measures: bool = True,
                 *, batch: int, host_params: dict[str, np.ndarray], **kw):
        super().__init__(params, sr, use_measures, **kw)
        self.batch = batch
        self.host_params = host_params

    def spawn(self) -> "_BatchedFrontierInterp":
        return _BatchedFrontierInterp(
            self.params, BOOL_OR_AND, batch=self.batch, host_params=self.host_params,
            use_kernel=self.use_kernel, device=self.device,
            block_skipping=self.block_skipping, fusion=self.fusion, reach=self.reach,
        )

    def capture_scalars(self, op: SeedOp, sid):
        """Seed scalars as ``[B, 1]`` columns (:func:`_row_scalars`)."""
        self.scalars = {k: v[:, None] for k, v in _row_scalars(op, sid, self.device).items()}

    def seed(self, op: SeedOp, state, cont):
        sr, B = self.sr, self.batch
        if op.ids is not None:
            cols = [_seed_column(i, self.host_params, B) for i in op.ids]
            idx, kept = _seed_rows(np.stack(cols, axis=1), op.dom)
            val = np.where(kept, sr.one, sr.zero).astype(np.float32)
            w = torch.full((B, op.dom), sr.zero, dtype=torch.float32, device=self.device)
            w = sr.scatter(w, torch.from_numpy(idx).to(self.device),
                           torch.from_numpy(val).to(self.device))
            if op.scalars:
                self.capture_scalars(op, cols[0])
            return cont(w)
        m = torch.ones((B, op.dom), dtype=torch.float32, device=self.device)
        for prog in op.programs:
            m = m * walk_ir(prog, self.spawn())
        if op.const_mask is not None:
            m = m * op.const_mask
        for c in op.param_conds:
            m = m * c.mask(self.params, self.attr_col).to(torch.float32)
        return cont(sr.from_mask(m))

    def _dense_measure(self, op: HopOp):
        """The hop's measure as float32 ``[E]`` when the rows share it, or
        ``[B, E]`` when it depends on the row; None for a measure-free hop."""
        if op.measure is None or not self.use_measures:
            return None
        mv = eval_lexpr(op.measure, self.params, self.scalars, self.col)
        mv = torch.as_tensor(mv, dtype=torch.float32, device=self.device)
        E = op.src_ids.shape[0]
        if mv.dim() >= 2:
            return mv.expand(self.batch, E).contiguous()
        return mv.expand(E).contiguous()

    def _hop_body(self, w, op: HopOp):
        out = self.spmm_fused(w, op)
        if out is not None:
            return out
        return K.fragment_spmm(
            w, op.src_ids, op.dst_ids, self._dense_measure(op), n_dst=op.dom_dst,
            op=self.sr.name, use_kernel=self.use_kernel,
            blocks=self.blocks_for(op), block_skipping=self.block_skipping,
            hot_share=op.hot_share,
        )

    def spmm_fused(self, w, op: HopOp):
        """Batched decode-fused hop: packed columns stream into the SpMM
        kernel and decode once an edge for all rows (``_packed_layout``'s
        classification). None for an all-dense hop, and for a measure that
        depends on the row: the dense kernel takes that stream."""
        layout = self._packed_layout(op)
        if layout is None:
            return None
        dst_packed, m_mode, m_operand, m_width, mdict = layout
        if m_mode == "dense":
            m_operand = self._dense_measure(op)
            if m_operand.dim() == 2:
                return None
        return K.fragment_spmm_packed(
            w, op.src_ids,
            op.dst_col.words if dst_packed else op.dst_col.materialize(),
            m_operand, mdict,
            n_dst=op.dom_dst,
            dst_width=op.dst_col.width if dst_packed else 0,
            m_mode=m_mode, m_width=m_width, op=self.sr.name,
            use_kernel=self.use_kernel,
            blocks=self.blocks_for(op), block_skipping=self.block_skipping,
            hot_share=op.hot_share,
        )

    def _fused_call(self, w, hop1, hop2, mid_mask, mid_binarize):
        return K.fragment_spmm_fused(
            w, hop1, hop2, mid_mask, op=self.sr.name, mid_binarize=mid_binarize,
            use_kernel=self.use_kernel, fusion=self.fusion,
            block_skipping=self.block_skipping,
        )


def _seed_column(i, host_params: dict[str, np.ndarray], batch: int) -> np.ndarray:
    """One seed slot of a batch → int64[B] on the host (a constant for every
    row)."""
    v = host_params[i.name] if isinstance(i, LParam) else i
    return np.broadcast_to(np.asarray(v).astype(np.int64), (batch,))


def _row_scalars(op: SeedOp, sid: np.ndarray, device) -> dict:
    """Seed scalars of a batch, ``[B]`` each: row b reads the attribute at its
    first seed id ``sid[b]``, indexed as the single query indexes it (a
    negative id counts from the end; an id outside the domain raises)."""
    out = {}
    for s in op.scalars.values():
        col = s.array
        n = col.shape[0]
        if ((sid < -n) | (sid >= n)).any():
            raise IndexError(f"seed id outside the domain of size {n}: {sid.tolist()}")
        out[s.key] = col[torch.from_numpy(np.where(sid < 0, sid + n, sid)).to(device)]
    return out


def _param_column(a: np.ndarray, device) -> torch.Tensor:
    """One parameter's ``[B]`` values as a ``[B, 1]`` device column: float32
    for floats (a Python float meets a float32 column as float32 in the
    single query), int64 otherwise."""
    dtype = torch.float32 if np.issubdtype(a.dtype, np.floating) else torch.int64
    return torch.as_tensor(a, dtype=dtype).to(device)[:, None]


def compile_frontier_batched(
    db: DeviceDB, plan: ChainPlan | PhysicalPlan, block_skipping: str = "auto",
    use_kernel: bool = True, fusion: str = "auto", reach: dict | None = None,
) -> Callable[..., torch.Tensor]:
    """The batched serving entry: ``run(*arrays)`` takes one ``[B]`` array
    per query parameter (in ``phys.param_names`` order) and returns the
    ``[B, out_dom]`` result on the database's device, without synchronising:
    every HopOp is one batched hop that streams the edges once for the whole
    batch, and a fused region one launch of its SpMM form. ``reach``: the
    single-query entry's device copies of the reach matrices (made here when
    None). A plan without parameters raises :class:`ValidationError`."""
    require_supported("block_skipping", block_skipping, BLOCK_SKIPPING_MODES)
    require_supported("fusion", fusion, FUSION_MODES)
    phys = ensure_lowered(db, plan)
    names = list(phys.param_names)
    if not names:
        raise ValidationError("batched execution needs at least one query parameter")
    device = db.device
    if reach is None:
        reach = device_reach(phys, device) if fusion != "off" else {}

    def run(*arrays):
        host = {n: np.asarray(a) for n, a in zip(names, arrays)}
        B = host[names[0]].shape[0]
        params = {n: _param_column(a, device) for n, a in host.items()}
        return execute_ir(
            phys,
            lambda sr, um: _BatchedFrontierInterp(
                params, sr, um, batch=B, host_params=host, use_kernel=use_kernel,
                device=device, block_skipping=block_skipping, fusion=fusion, reach=reach,
            ),
        )

    run.reach = reach
    return run


# ---------------------------------------------------------------------------
# The fragment-at-a-time strategy (paper Fig. 3), vectorised over paths
# ---------------------------------------------------------------------------


class _AtRows(dict):
    """Per-row values (``[B]`` tensors) read at each path's row, gathered the
    first time an expression asks for a name."""

    def __init__(self, cols: dict, row: torch.Tensor):
        super().__init__()
        self.cols, self.row = cols, row

    def __missing__(self, key):
        v = self[key] = self.cols[key][self.row]
        return v


class _FragmentLoopInterp(_Interp):
    """The paper's generated code walks one join path at a time: nested loops
    over one fragment a hop, one ⊕-update of ℛ a finished path. This
    interpreter walks the same path set with every path it holds at once, as
    tensors on the database's device: the state is ``(cur, weight, row, R)``
    — each path's current entity id, its ⊗-weight, its batch row (None for a
    single query) and the accumulator ℛ.

      * SeedOp — one path a seed id, of weight 1̄ (duplicates stay separate
        paths, so they accumulate multiplicity); seed scalars come from the
        first seed id;
      * HopOp — every path expands over its source's fragment: the degrees'
        inclusive scan sizes the expansion (one host read of the new path
        count a hop), and the destinations and the measure are read at the
        reached edge positions through each column's ``gather`` (a packed
        column decodes only those positions; no dense copy is made). A path
        whose weight is 0̄ is not expanded: it could only scatter 0̄. When
        the new paths would exceed ``params.FRAGMENT_LOOP_MAX_PATHS`` the
        expansion runs in chunks of that many edges, each carried through
        the rest of the plan before the next (depth first), the query's
        deadline read before each chunk;
      * DegreeFilterOp / EntityFilterOp — a per-path factor and mask;
      * GroupOp — one scatter-⊕ of every path into ℛ (``[B · out_dom]``
        for a batch, at ``row · out_dom + cur``). Under the sum semiring ℛ
        holds float64 and each destination's sum rounds to float32 once, at
        the end: a destination sums one term a path, and the paths are far
        more than the edges into it, which bound the frontier's sums.

    It reads only the fragments the seeds reach and never merges paths at an
    intermediate vertex, which the frontier does."""

    def __init__(self, params: dict[str, Any], sr: Semiring, use_measures: bool = True,
                 *, out_dom: int, device, batch: int | None = None,
                 host_params: dict[str, np.ndarray] | None = None):
        super().__init__(params, sr, use_measures)
        self.out_dom = out_dom
        self.device = torch.device(device)
        self.batch = batch
        self.host_params = host_params

    def _accumulator(self, n: int) -> torch.Tensor:
        dtype = torch.float64 if self.sr.name == "sum" else torch.float32
        return torch.full((n,), self.sr.zero, dtype=dtype, device=self.device)

    def _env(self, row):
        """(params, seed scalars) at the paths' rows; the query's own for a
        single query."""
        if row is None:
            return self.params, self.scalars
        return _AtRows(self.params, row), _AtRows(self.scalars, row)

    def seed(self, op: SeedOp, state, cont):
        sr = self.sr
        if self.batch is None:
            ids = [int(self.resolve(i)) for i in op.ids]
            cur, row = _seed_index(ids, op.dom, self.device), None
            if op.scalars:
                self.capture_scalars(op, ids[0])
            R = self._accumulator(self.out_dom)
        else:
            cols = [_seed_column(i, self.host_params, self.batch) for i in op.ids]
            idx, kept = _seed_rows(np.stack(cols, axis=1), op.dom)
            rows, _ = np.nonzero(kept)
            cur = torch.from_numpy(idx[kept]).to(self.device)
            row = torch.from_numpy(rows).to(self.device)
            if op.scalars:
                self.scalars = _row_scalars(op, cols[0], self.device)
            R = self._accumulator(self.batch * self.out_dom)
        wgt = torch.full(cur.shape, sr.one, dtype=torch.float32, device=self.device)
        return cont((cur, wgt, row, R))

    def hop(self, op: HopOp, state, cont):
        cur, wgt, row, R = state
        start = op.indptr[cur].to(torch.int64)
        deg = op.indptr[cur + 1].to(torch.int64) - start
        deg = torch.where(wgt != self.sr.zero, deg, 0)
        ends = torch.cumsum(deg, 0)
        total = int(ends[-1]) if ends.numel() else 0
        base = start - (ends - deg)  # edge position = base[path] + output position
        cap = KP.FRAGMENT_LOOP_MAX_PATHS
        for a in range(0, total, cap) or (0,):
            check_deadline("fragment_loop chunk")
            b = min(a + cap, total)
            pos = torch.arange(a, b, device=self.device)
            if b - a == total:
                k = torch.repeat_interleave(deg, output_size=total)
            else:
                k = torch.searchsorted(ends, pos, right=True)
            e = base[k] + pos
            w = wgt[k]
            r = None if row is None else row[k]
            if op.measure is not None and self.use_measures:
                params, scalars = self._env(r)
                m = eval_lexpr(op.measure, params, scalars, lambda c: c.col.gather(e))
                w = self.sr.extend(w, torch.as_tensor(m, dtype=torch.float32,
                                                      device=self.device))
            R = cont((op.dst_col.gather(e).to(torch.int64), w, r, R))
        return R

    def degree_filter(self, op: DegreeFilterOp, state, cont):
        cur, wgt, row, R = state
        return cont((cur, self.sr.mask(wgt, op.degrees[cur] > 0), row, R))

    def entity_filter(self, op: EntityFilterOp, state, cont):
        cur, wgt, row, R = state
        params, scalars = self._env(row)
        if op.factor is not None and self.use_measures:
            f = eval_lexpr(op.factor, params, scalars, lambda c: c.col.gather(cur))
            wgt = self.sr.extend(wgt, torch.as_tensor(f, dtype=torch.float32,
                                                      device=self.device))
        keep = None
        if op.const_mask is not None:
            keep = op.const_mask[cur] > 0
        for c in op.param_conds:
            k = c.mask(params, lambda cc: cc.array[cur])
            keep = k if keep is None else keep & k
        if keep is not None:
            wgt = self.sr.mask(wgt, keep)
        return cont((cur, wgt, row, R))

    def group(self, op: GroupOp, state, cont):
        cur, wgt, row, R = state
        idx = cur if row is None else row * self.out_dom + cur
        if R.dtype == torch.float64:
            return cont(R.index_add_(0, idx, wgt.to(torch.float64)))
        return cont(self.sr.scatter(R, idx, wgt))


def walks_scalar(phys: PhysicalPlan) -> bool:
    """Whether ``fragment_loop`` walks ``phys`` path by path: an id seed and
    no semijoin hop. A mask seed or a semijoin runs the frontier, as in the
    reference."""
    return phys.ops[0].ids is not None and not any(
        isinstance(op, HopOp) and op.semijoin for op in iter_flat_ops(phys)
    )


def compile_fragment_loop(
    db: DeviceDB, plan: ChainPlan | PhysicalPlan, block_skipping: str = "auto",
    use_kernel: bool = True,
) -> Callable[..., torch.Tensor]:
    """The ``fragment_loop`` strategy: ``run(*args)`` as
    :func:`compile_frontier`'s, walking the plan path by path
    (:class:`_FragmentLoopInterp`, which launches no kernel) where
    :func:`walks_scalar` allows, and through :func:`compile_frontier`
    (unfused, ``block_skipping`` and ``use_kernel`` passed on) where it does
    not."""
    phys = ensure_lowered(db, plan)
    if not walks_scalar(phys):
        return compile_frontier(db, phys, block_skipping=block_skipping,
                                use_kernel=use_kernel, fusion="off")
    names = list(phys.param_names)
    device = db.device

    def run(*args):
        params = {n: _host_scalar(a) for n, a in zip(names, args)}
        return execute_ir(
            phys,
            lambda sr, um: _FragmentLoopInterp(params, sr, um, out_dom=phys.out_dom,
                                               device=device),
        ).to(torch.float32)

    return run


def compile_fragment_loop_batched(
    db: DeviceDB, plan: ChainPlan | PhysicalPlan, block_skipping: str = "auto",
    use_kernel: bool = True,
) -> Callable[..., torch.Tensor]:
    """The batched ``fragment_loop`` entry, ``run(*arrays)`` as
    :func:`compile_frontier_batched`'s: one scalar walk for the whole batch,
    every path carrying its row, scattering into ``[B · out_dom]``; a plan
    that falls back to the frontier runs :func:`compile_frontier_batched`
    (``use_kernel`` passed on)."""
    phys = ensure_lowered(db, plan)
    if not walks_scalar(phys):
        return compile_frontier_batched(db, phys, block_skipping=block_skipping,
                                        use_kernel=use_kernel, fusion="off")
    names = list(phys.param_names)
    if not names:
        raise ValidationError("batched execution needs at least one query parameter")
    device = db.device

    def run(*arrays):
        host = {n: np.asarray(a) for n, a in zip(names, arrays)}
        B = host[names[0]].shape[0]
        params = {n: _param_column(a, device)[:, 0] for n, a in host.items()}
        out = execute_ir(
            phys,
            lambda sr, um: _FragmentLoopInterp(params, sr, um, out_dom=phys.out_dom,
                                               device=device, batch=B, host_params=host),
        )
        return out.to(torch.float32).reshape(B, phys.out_dom)

    return run


# ---------------------------------------------------------------------------
# Distributed (edge-sharded, one all_reduce a hop)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardSpec:
    """This rank's place in the shard axes of a mesh: the process group over
    those axes, the shard index ``shard`` (the rank's coordinate on the
    axes, row-major: the reference's shard order) and the shard count."""

    group: Any
    shard: int
    nshards: int
    device_type: str

    def bounds(self, E: int) -> tuple[int, int]:
        """Rows ``[r·S, min((r+1)·S, E))`` of an E-edge index, ``S =
        ceil(E / n)``: the reference's shard boundaries."""
        S = -(-E // self.nshards)
        return min(self.shard * S, E), min((self.shard + 1) * S, E)


def shard_spec(mesh, axes: tuple[str, ...], device=None) -> ShardSpec:
    """Validate ``mesh`` (a ``torch.distributed`` DeviceMesh whose device
    type is ``device``'s) and ``axes`` (names of its dimensions), and find
    this rank's shard. Collective: with more than one axis every rank makes
    the groups of the axes' sub-meshes (``dist.new_group``), in the same
    order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValidationError(
            f"mesh must be a torch.distributed DeviceMesh (repro_torch.launch.mesh."
            f"make_mesh), got {type(mesh).__name__}", mesh=type(mesh).__name__,
        )
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValidationError(
            f"a {mesh.device_type!r} mesh cannot run a database on {str(device)!r}",
            mesh=mesh.device_type, device=str(device),
        )
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(axes)
    if not axes or any(a not in names for a in axes) or len(set(axes)) != len(axes):
        raise ValidationError(f"shard axes {axes} must name distinct dimensions of the"
                              f" mesh {names}", axes=axes, mesh_axes=names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValidationError("this rank is not in the mesh", rank=dist.get_rank())
    dims = [names.index(a) for a in axes]
    sizes = [mesh.size(d) for d in dims]
    shard = int(np.ravel_multi_index([coord[d] for d in dims], sizes))
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:  # the shard axes last: each row of the rest is one group
        rest = [d for d in range(mesh.ndim) if d not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(-1, int(np.prod(sizes)))
        me = dist.get_rank()
        group = None
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                group = g
    return ShardSpec(group, shard, int(np.prod(sizes)), mesh.device_type)


@dataclass
class ShardedDB(DeviceDB):
    """One rank's shard of a :class:`DeviceDB`: every index's edge rows
    ``spec.bounds(E)``, dense, with their own hot share; indptr, degrees
    and entity attributes are the full DB's tensors (replicated)."""

    spec: ShardSpec | None = None


def _decoded_rows(col: DeviceColumn, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of a column, decoded (a packed column through
    ``ops.bitunpack``, once) and copied, so that no decoded copy of the
    whole column stays pinned where none was before."""
    memo = getattr(col, "_dense", None)
    rows = col.materialize()[lo:hi].clone()
    if hasattr(col, "_dense"):
        col._dense = memo
    return rows


def shard_edges(db: DeviceDB, mesh, axes: tuple[str, ...] = ("data",),
                spec: ShardSpec | None = None) -> ShardedDB:
    """This rank's shard of every index (rows ``spec.bounds(E)``, shard r of
    the reference's ``shard_edges`` without its padding): a shard is simply
    shorter, so no ``__valid__`` column. Packed columns decode once here.
    Each shard's hop gets the hot share of the shard's own destinations,
    which chooses its per-CTA table (``ops.uses_table``)."""
    spec = spec if spec is not None else shard_spec(mesh, axes, db.device)
    out: dict[tuple[str, str], DeviceIndex] = {}
    for key, di in db.indexes.items():
        lo, hi = spec.bounds(int(di.src_ids.shape[0]))
        dst = _decoded_rows(di.dst_col, lo, hi)
        top = int(torch.bincount(dst.to(torch.int64)).max()) if dst.numel() else 0
        out[key] = DeviceIndex(
            indptr=di.indptr, src_ids=di.src_ids[lo:hi].clone(), dst_col=DenseColumn(dst),
            degrees=di.degrees,
            measure_cols={m: DenseColumn(_decoded_rows(c, lo, hi))
                          for m, c in di.measure_cols.items()},
            hot_share=top / dst.numel() if dst.numel() else 0.0,
        )
    return ShardedDB(db.schema, out, db.entity_attrs, db.host_indexes, spec=spec)


def shard_bytes(sdb: ShardedDB) -> int:
    """Device bytes this rank's shard holds beyond the full DB: its edge
    rows (the replicated tensors are the full DB's own)."""
    return sum(t.numel() * t.element_size()
               for di in sdb.indexes.values()
               for t in (di.src_ids, di.dst_ids, *di.measures.values()))


#: The error kinds a distributed walk agrees on, in the order one wins when
#: ranks fail differently.
AGREED_KINDS = ("KERNEL", "DEADLINE", "RESOURCE", "EXECUTION")


def _kind_of(e: BaseException) -> str:
    if isinstance(e, KernelError):
        return "KERNEL"
    if isinstance(e, DeadlineExceeded):
        return "DEADLINE"
    if isinstance(e, ResourceError):
        return "RESOURCE"
    return "EXECUTION"


def _agreed_error(kind: str, own: BaseException | None) -> Exception:
    """The error every rank raises for ``kind``: the same class and code on
    every rank (the failing rank's own error is its cause)."""
    where = "on this rank" if own is not None else "on another rank of the group"
    msg = f"distributed walk ended: {kind} {where}" + (f": {own}" if own is not None else "")
    if kind == "KERNEL":
        return KernelError(msg)
    if kind == "DEADLINE":
        return DeadlineExceeded(msg, where="distributed hop")
    if kind == "RESOURCE":
        return ResourceError(msg)
    return ExecutionError(msg, strategy="distributed")


class _CollectiveWalk:
    """One distributed run's agreement: a rank never leaves a walk the others
    are still in. A hop that fails on this rank (a fault site, a kernel, the
    query's deadline, read before each hop) marks the rank failed; from then
    on it skips its own work and contributes the ⊕-identity, so every rank
    makes the same collectives. Each hop's all_reduce carries one flag a
    kind (:data:`AGREED_KINDS`) after the frontier; :meth:`finish` reads
    the flags once, at the end, and every rank raises the same error."""

    def __init__(self, spec: ShardSpec, device, frontier_dtype, deadline, failed=None):
        self.spec = spec
        self.device = device
        self.dtype = frontier_dtype
        self.deadline = deadline
        self.error = failed
        self.seen = None  # OR of the reduced flags (a device tensor)

    def _flags(self, sr: Semiring) -> torch.Tensor:
        """This rank's flags, set where ⊕ keeps them set: 1 under sum, max
        and bool, −1 under min."""
        f = torch.zeros(len(AGREED_KINDS), dtype=torch.float32, device=self.device)
        if self.error is not None:
            f[AGREED_KINDS.index(_kind_of(self.error))] = -1.0 if sr.name == "min" else 1.0
        return f

    def _reduce(self, buf: torch.Tensor, sr: Semiring) -> None:
        try:
            sr.preduce(buf, self.spec.group)
        except RuntimeError as e:
            if buf.dtype == torch.float32:
                raise
            import torch.distributed as dist

            backend = dist.get_backend(self.spec.group)
            raise ValidationError(
                f"backend {backend!r} cannot all-reduce {buf.dtype}: {e}",
                backend=backend, frontier_dtype=str(buf.dtype),
            ) from e
        hit = buf[-len(AGREED_KINDS):] != 0
        self.seen = hit if self.seen is None else self.seen | hit

    def hop(self, local, shape: tuple, sr: Semiring) -> torch.Tensor:
        """This rank's part of a hop (``local()``, or the identity once the
        rank failed), ⊕-reduced over the group with the flags."""
        part = None
        if self.error is None:
            try:
                if self.deadline is not None:
                    self.deadline.check("distributed hop")
                part = local()
            except Exception as e:  # noqa: BLE001 — agreed on at finish()
                self.error = e
        if part is None:
            part = torch.full(shape, sr.zero, dtype=torch.float32, device=self.device)
        buf = torch.cat([part.reshape(-1).to(self.dtype), self._flags(sr).to(self.dtype)])
        self._reduce(buf, sr)
        return buf[:-len(AGREED_KINDS)].reshape(shape).to(torch.float32)

    def finish(self) -> None:
        """Read the agreed flags (a walk with no hop agrees here) and raise
        the winning kind's error on every rank."""
        if self.seen is None:
            from .semiring import SUM_PRODUCT

            self._reduce(self._flags(SUM_PRODUCT), SUM_PRODUCT)
        hits = self.seen.tolist()
        if not any(hits):
            return
        kind = AGREED_KINDS[hits.index(True)]
        own = self.error if self.error is not None and _kind_of(self.error) == kind else None
        raise _agreed_error(kind, own) from self.error


def agree(sdb: ShardedDB, flag: bool) -> bool:
    """Whether ``flag`` holds on any rank of the shard group: one small
    all_reduce, for a decision that must be the same on every rank (a
    deadline read on each rank's clock)."""
    import torch.distributed as dist

    t = torch.tensor([1.0 if flag else 0.0], device=sdb.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=sdb.spec.group)
    return bool(t.item() > 0)


class _ShardRouting:
    """The distributed interpreters' column routing and hop: edge columns by
    ``c.key`` from this rank's shard, entity attributes from the replicated
    tables; a hop runs the port's hop kernel over the shard and ⊕-reduces
    its part (:class:`_CollectiveWalk`). Block skipping and fusion are off
    (a fused region replays its members)."""

    def col(self, c):
        if c.key[0] == "edge":
            _, table, key, attr = c.key
            return self.sdb.index(table, key).measure_cols[attr].materialize()
        _, entity, attr = c.key
        return self.sdb.entity_attrs[(entity, attr)]

    attr_col = col

    def _dense_measure(self, op: HopOp):
        """The hop's measure over the shard's edges: ``[E_shard]``, or ``[B,
        E_shard]`` when it depends on the row; None for a measure-free hop."""
        if op.measure is None or not self.use_measures:
            return None
        mv = eval_lexpr(op.measure, self.params, self.scalars, self.col)
        mv = torch.as_tensor(mv, dtype=torch.float32, device=self.device)
        E = self.sdb.index(op.table, op.src_key).src_ids.shape[0]
        if mv.dim() >= 2:
            return mv.expand(self.batch, E).contiguous()
        return mv.expand(E).contiguous()

    def _hop_body(self, w, op: HopOp):
        di = self.sdb.index(op.table, op.src_key)
        entry = K.fragment_spmm if w.dim() == 2 else K.fragment_spmv

        def local():
            return entry(w, di.src_ids, di.dst_ids, self._dense_measure(op),
                         n_dst=op.dom_dst, op=self.sr.name, use_kernel=self.use_kernel,
                         hot_share=di.hot_share)

        return self.walk.hop(local, tuple(w.shape[:-1]) + (op.dom_dst,), self.sr)


class _DistributedInterp(_ShardRouting, _FrontierInterp):
    """Frontier semantics over this rank's shard, one ⊕-collective a hop
    (``ops.fragment_spmv`` over the shard, then ``Semiring.preduce``)."""

    def __init__(self, params, sr, use_measures=True, *, sdb: ShardedDB,
                 walk: _CollectiveWalk, use_kernel: bool = True, device="cuda"):
        super().__init__(params, sr, use_measures, use_kernel=use_kernel, device=device,
                         block_skipping="off", fusion="off")
        self.sdb, self.walk = sdb, walk

    def spawn(self) -> "_DistributedInterp":
        return _DistributedInterp(self.params, BOOL_OR_AND, sdb=self.sdb, walk=self.walk,
                                  use_kernel=self.use_kernel, device=self.device)


class _DistributedBatchedInterp(_ShardRouting, _BatchedFrontierInterp):
    """The batched form: ``[B, dom]`` frontiers, each hop one
    ``ops.fragment_spmm`` over the shard and one all_reduce of ``[B,
    n_dst]``."""

    def __init__(self, params, sr, use_measures=True, *, batch: int, host_params,
                 sdb: ShardedDB, walk: _CollectiveWalk, use_kernel: bool = True,
                 device="cuda"):
        super().__init__(params, sr, use_measures, batch=batch, host_params=host_params,
                         use_kernel=use_kernel, device=device, block_skipping="off",
                         fusion="off")
        self.sdb, self.walk = sdb, walk

    def spawn(self) -> "_DistributedBatchedInterp":
        return _DistributedBatchedInterp(
            self.params, BOOL_OR_AND, batch=self.batch, host_params=self.host_params,
            sdb=self.sdb, walk=self.walk, use_kernel=self.use_kernel, device=self.device)


#: The frontier dtypes a distributed hop can all-reduce in.
FRONTIER_DTYPES = (torch.float32, torch.bfloat16)


def compile_frontier_distributed(
    db: DeviceDB, plan: ChainPlan | PhysicalPlan, mesh, axes: tuple[str, ...] = ("data",),
    batched: bool = False, frontier_dtype=torch.float32,
    sharded_db: ShardedDB | None = None, prefix: int | None = None,
    use_kernel: bool = True,
) -> Callable[..., torch.Tensor]:
    """The paper's parallel design on ``torch.distributed``: every rank runs
    ``run(*args)`` with the same arguments; frontiers are replicated, edges
    sharded (``shard_edges``, or ``sharded_db`` shared by the engine's
    prepares), and each hop computes this rank's part over its shard and
    ⊕-reduces it with one all_reduce (SUM, MIN or MAX). ``batched`` takes
    one ``[B]`` array a parameter, as :func:`compile_frontier_batched`, and
    hops with ``ops.fragment_spmm``. ``frontier_dtype=torch.bfloat16``
    halves every all_reduce (a backend that cannot reduce it raises
    :class:`ValidationError`). ``prefix=k`` runs only the plan's first k ops
    and returns the raw state (no finalize): the profile's prefix-delta
    entry. The query's deadline is read before each hop, and a hop that
    fails on one rank ends the run on every rank with the same error
    (:class:`_CollectiveWalk`); ``run(*args, failed=e)`` enters the walk
    already failed with ``e``, so a rank that failed before it still takes
    part."""
    require_supported("frontier_dtype", frontier_dtype, FRONTIER_DTYPES)
    phys = ensure_lowered(db, plan)
    names = list(phys.param_names)
    if batched and not names:
        raise ValidationError("batched execution needs at least one query parameter")
    sdb = sharded_db if sharded_db is not None else shard_edges(db, mesh, axes)
    device = db.device

    def run(*args, failed: BaseException | None = None):
        walk = _CollectiveWalk(sdb.spec, device, frontier_dtype, current_deadline(), failed)
        kw = dict(sdb=sdb, walk=walk, use_kernel=use_kernel, device=device)
        if batched:
            host = {n: np.asarray(a) for n, a in zip(names, args)}
            B = host[names[0]].shape[0]
            params = {n: _param_column(a, device) for n, a in host.items()}
            mk = lambda sr, um: _DistributedBatchedInterp(  # noqa: E731
                params, sr, um, batch=B, host_params=host, **kw)
        else:
            params = {n: _host_scalar(a) for n, a in zip(names, args)}
            mk = lambda sr, um: _DistributedInterp(params, sr, um, **kw)  # noqa: E731
        # the walk's own reads of the deadline are this rank's clock alone:
        # the walk reads it before each hop and agrees instead
        with deadline_scope(None):
            if prefix is not None:
                out = walk_ir(phys, mk(semiring_for(phys.agg), True), stop=prefix)
            else:
                out = execute_ir(phys, mk)
        walk.finish()
        return out

    run.sharded_db = sdb
    return run


#: The strategies' compilers: (single query, batched).
STRATEGIES = {
    "frontier": (compile_frontier, compile_frontier_batched),
    "fragment_loop": (compile_fragment_loop, compile_fragment_loop_batched),
}
