"""Plan execution over the lowered physical IR, on torch tensors.

Every strategy is a *thin interpreter* over the IR built by
:mod:`repro_torch.core.lower`: one continuation-passing walker
(:func:`walk_ir`) folds the op sequence, and a strategy chooses the primitive
each op maps to. This port has the ``frontier`` strategy: bottom-up, fully
pipelined execution over dense per-entity-domain frontier vectors, where each
HopOp is one call of :func:`repro_torch.kernels.ops.fragment_spmv` — the
hand-written CUDA kernel on the card, its plain PyTorch version on the CPU.
Intermediates are vectors, never materialized join tables. PyTorch runs
eagerly, so a compiled query is a plain Python closure over the lowered plan.

Aggregation semantics are pluggable: the walker is parameterized by a
:class:`repro_torch.core.semiring.Semiring`, so SUM/COUNT, MIN/MAX, EXISTS and
the fused AVG pair all execute through the same code path. The result is the
dense γ accumulator ℛ over the group-by entity domain (the paper's
aggregation array; size = domain of the group key).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import ops as K
from ..kernels.active import block_ranges
from ..robust.errors import ExecutionError, ValidationError
from ..storage import DenseColumn, DeviceColumn
from .algebra import ChainPlan, EntityStep, Param, SeedIds
from .fragments import FragmentIndex
from .lower import (
    DegreeFilterOp,
    EntityFilterOp,
    GroupOp,
    HopOp,
    LParam,
    PhysicalPlan,
    SeedOp,
    eval_lexpr,
    lower,
)
from .schema import Schema
from .semiring import BOOL_OR_AND, Semiring, semiring_for

#: The device encodings, block-skipping and fusion modes this port runs. The
#: reference's other settings arrive with the ROADMAP items named here; until
#: then they raise instead of quietly running something else.
DEVICE_ENCODINGS = ("dense",)
BLOCK_SKIPPING_MODES = ("off",)
FUSION_MODES = ("off",)
_NOT_YET = {
    "device_encodings": "4 (compressed device storage)",
    "block_skipping": "5 (frontier-sparsity block skipping)",
    "fusion": "6 (pipelined fusion)",
}


def not_ported(what: str, item: str) -> ValidationError:
    """The error for a setting or entry point this port does not run yet,
    naming the ROADMAP Queue 1 item that brings it."""
    return ValidationError(
        f"{what} is not supported by the PyTorch port yet; it comes with "
        f"ROADMAP Queue 1 item {item}",
        unsupported=what,
    )


def require_supported(option: str, value, supported: tuple) -> None:
    if value not in supported:
        raise not_ported(f"{option}={value!r}", _NOT_YET[option])


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
    # (kernels/active.py), host numpy — the block-skipping metadata later
    # slices read
    block_src_min: np.ndarray | None = None
    block_src_max: np.ndarray | None = None

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


def make_device_index(indptr, src_ids, dst_ids, measures: dict, device) -> DeviceIndex:
    """One index on ``device`` from host arrays: int32 structure, float32
    measures, host block-range metadata."""
    src = np.asarray(src_ids)
    bmin, bmax = block_ranges(src)
    indptr = np.asarray(indptr)
    return DeviceIndex(
        indptr=to_device(indptr, torch.int32, device),
        src_ids=to_device(src, torch.int32, device),
        dst_col=DenseColumn(to_device(dst_ids, torch.int32, device)),
        degrees=to_device(np.diff(indptr), torch.int32, device),
        measure_cols={
            m: DenseColumn(to_device(v, torch.float32, device))
            for m, v in measures.items()
        },
        block_src_min=bmin,
        block_src_max=bmax,
    )


def build_device_db(
    schema: Schema,
    host_indexes: dict[tuple[str, str], FragmentIndex],
    device_encodings: str = "dense",
    device="cuda",
) -> DeviceDB:
    """Ship every fragment index to ``device`` as dense int32/float32 CSR."""
    require_supported("device_encodings", device_encodings, DEVICE_ENCODINGS)
    dev: dict[tuple[str, str], DeviceIndex] = {}
    for (table, key), idx in host_indexes.items():
        other = next(c for c in idx.columns if c != key and _is_fk(schema, table, c))
        dev[(table, key)] = make_device_index(
            idx.indptr, idx.src_ids(), idx.columns[other].values,
            {m: cf.values for m, cf in idx.columns.items() if m != other},
            device,
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


def walk_ir(phys: PhysicalPlan, interp: "_Interp"):
    """Fold the op sequence through ``interp``. Continuation-passing so a
    scalar strategy can emit nested fragment loops from the same walk."""
    ops = phys.ops

    def go(i: int, state):
        if i == len(ops):
            return state
        return interp.apply(ops[i], state, lambda st: go(i + 1, st))

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
        raise ExecutionError(
            f"no interpreter rule for op {type(op).__name__}",
            retryable=False, op=type(op).__name__,
            strategy=type(self).__name__,
        )

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

    There is no per-hop test for an all-zero frontier: with a frontier of
    ⊕-identities the kernel's result is already the identity vector under
    every op, and a test on the host would cost one device sync per hop."""

    def __init__(self, params: dict[str, Any], sr: Semiring,
                 use_measures: bool = True, use_kernel: bool = True,
                 device="cuda"):
        super().__init__(params, sr, use_measures)
        self.use_kernel = use_kernel
        self.device = torch.device(device)

    def spawn(self) -> "_FrontierInterp":
        """Interpreter for a mask sub-program (always the boolean semiring)."""
        return _FrontierInterp(
            self.params, BOOL_OR_AND, use_kernel=self.use_kernel,
            device=self.device,
        )

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
        m = None  # measure-free hop: the kernel reads measure 1
        if op.measure is not None and self.use_measures:
            mv = eval_lexpr(op.measure, self.params, self.scalars, self.col)
            mv = torch.as_tensor(mv, dtype=torch.float32, device=self.device)
            m = mv.expand(op.src_ids.shape[0]).contiguous()  # no copy when already [E]
        return cont(K.fragment_spmv(
            w, op.src_ids, op.dst_ids, m, n_dst=op.dom_dst, op=self.sr.name,
            use_kernel=self.use_kernel,
        ))

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


def compile_frontier(
    db: DeviceDB, plan: ChainPlan | PhysicalPlan, use_kernel: bool = True,
) -> Callable[..., torch.Tensor]:
    """Lower once; return ``run(*args)`` that executes the plan with the
    parameters bound positionally (in ``phys.param_names`` order) and returns
    the result tensor on the database's device, without synchronising.
    ``use_kernel=False`` runs every hop through the plain version instead of
    the CUDA kernel (the on-card comparison)."""
    phys = ensure_lowered(db, plan)
    names = list(phys.param_names)
    device = db.device

    def run(*args):
        params = {n: _host_scalar(a) for n, a in zip(names, args)}
        return execute_ir(
            phys,
            lambda sr, um: _FrontierInterp(
                params, sr, um, use_kernel=use_kernel, device=device,
            ),
        )

    return run
