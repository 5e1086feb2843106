"""Admission control: reject (or demote) queries before they exhaust device
memory, and the prepared-query cache.

The estimator combines two models the engine already maintains, with the
reference's formula (``repro.robust.admission``), so that frontier plans get
the reference's numbers byte for byte:

  * the **resident** term — real device bytes the column store holds,
    from :func:`repro_torch.storage.device_space_report`;
  * the **working** term — what executing this plan allocates on top:
    per-op frontier vectors over entity domains (×batch for the SpMM path,
    ×2 for AVG's fused SUM+COUNT walk) plus the expected edge-stream traffic
    from the engine's ``_hop_fractions`` cardinality model
    (est_active_fraction × E × bytes/edge).

The port replaces the reference's frontier term by its own where that is
larger, and adds one term the reference lacks, so that the estimate bounds
what the port allocates on the card:

  * **the live walk** (:func:`_walk_live_bytes`) — the executor's walk is
    continuation-passing, so every frontier an op makes (a seed, a hop's
    output, a semijoin's binarized input, a filter's factor and its
    product, a mask) stays live until the walk ends, not only the peak
    pair; on top of them the largest transient of one op: a factor or
    measure expression's temporaries (a vector a node), a mask seed's
    sub-walks, a batched hop's row-chunk scratch, a block list;
  * **the walk's chunk** — a plan that the ``fragment_loop`` strategy walks
    path by path holds up to ``params.FRAGMENT_LOOP_MAX_PATHS`` paths a
    chunk, at :data:`FRAGMENT_LOOP_PATH_BYTES` each (×batch).

``reference_working_bytes`` keeps the reference's own working term, for
comparison with it.

``AdmissionController.decide`` compares predicted peak bytes against a
:class:`MemoryBudget` and returns one of three actions:

    admit   — run as requested.
    demote  — the batched footprint exceeds budget but a single query fits:
              serve the bucket serially (degraded, but alive). The runner /
              serve loop implements the demotion.
    reject  — even one query at B=1 is predicted over budget → raise
              :class:`repro_torch.robust.errors.ResourceError` (never submit work
              the device cannot hold).

This module also owns :class:`PreparedCache` — the fixed-size LRU that
bounds the engine's prepared-query cache under many distinct query shapes;
evictions are counted on the shared metrics registry.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

from ..obs.metrics import REGISTRY, MetricsRegistry
from .errors import ResourceError

#: Bytes per edge the frontier hop streams in the worst (all-dense) case:
#: src id + dst id + measure, 4 bytes each.
EDGE_STREAM_BYTES = 12

#: f32 accumulator cell.
CELL_BYTES = 4

#: Device bytes a path of the ``fragment_loop`` walk holds in one chunk: its
#: entity id, weight, edge position, source path and the expansion's
#: temporaries (``params.FRAGMENT_LOOP_MAX_PATHS``' note: about 60).
FRAGMENT_LOOP_PATH_BYTES = 60


@dataclass(frozen=True)
class MemoryBudget:
    """``limit_bytes`` is the hard ceiling for resident + working bytes;
    ``headroom`` (fraction of the limit) is reserved for allocator slack and
    temporaries, so the effective budget is ``limit × (1 − headroom)``.
    ``limit_bytes=None`` disables admission (everything admits)."""

    limit_bytes: int | None = None
    headroom: float = 0.1

    @property
    def effective_bytes(self) -> float | None:
        if self.limit_bytes is None:
            return None
        return self.limit_bytes * (1.0 - self.headroom)


@dataclass
class AdmissionDecision:
    action: str  # admit | demote | reject
    predicted_bytes: int
    single_bytes: int  # the B=1 prediction (the demotion target)
    limit_bytes: int | None
    reason: str = ""

    @property
    def admitted(self) -> bool:
        return self.action == "admit"


def _plan_working_bytes(phys, batch: int, hop_estimates=None) -> int:
    """Working-set model for one execution of ``phys`` at batch B: the peak
    pair of live frontier vectors (walker state + the hop it feeds) plus the
    expected touched edge stream. AVG runs the walk twice in one program
    (fused SUM+COUNT) → double the frontier term. Mask-seed sub-programs
    recurse with the boolean semiring (same widths)."""
    return sum(_plan_terms(phys, batch, hop_estimates))


def _plan_terms(phys, batch: int, hop_estimates=None) -> tuple[int, int]:
    """:func:`_plan_working_bytes`' two terms: ``(pair, edges)``, the top
    level's frontier pair and the rest (edge streams, and a mask seed's
    sub-programs whole)."""
    from ..core.lower import GroupOp, HopOp, SeedOp, iter_flat_ops

    doms: list[int] = []
    edge_bytes = 0
    est = {
        (h["table"], h["src_key"]): h["est_active_fraction"]
        for h in (hop_estimates or [])
    }
    # flattened walk: a FusedHopOp's member hops still stream their edges and
    # hold a live intermediate (the region's scratch), so the model charges
    # them exactly as it charges the unfused plan
    for op in iter_flat_ops(phys):
        if isinstance(op, SeedOp):
            doms.append(op.dom)
            for prog in op.programs:
                edge_bytes += _plan_working_bytes(prog, batch)
        elif isinstance(op, HopOp):
            doms.append(op.dom_dst)
            E = int(op.src_ids.shape[0])
            frac = est.get((op.table, op.src_key), 1.0)
            edge_bytes += int(frac * E) * EDGE_STREAM_BYTES
        elif isinstance(op, GroupOp):
            doms.append(op.dom)
    doms.sort(reverse=True)
    peak_frontier = sum(doms[:2]) * CELL_BYTES * batch
    if getattr(phys, "agg", None) == "avg":
        peak_frontier *= 2
    return peak_frontier, edge_bytes


def _vector_nodes(e) -> int:
    """Vectors that evaluating the expression ``e`` over a domain allocates:
    one an operator node, one a column that is not already float32 (a
    decode or a cast); constants, parameters and seed scalars none."""
    from ..core.lower import LBin, LCall, LCol
    from ..storage.columns import DenseColumn

    if isinstance(e, LBin):
        return 1 + _vector_nodes(e.left) + _vector_nodes(e.right)
    if isinstance(e, LCall):
        return 1 + sum(_vector_nodes(a) for a in e.args)
    if isinstance(e, LCol):
        c = e.col
        return 0 if isinstance(c, DenseColumn) and c.array.dtype.is_floating_point \
            and c.array.element_size() == CELL_BYTES else 1
    return 0


def _per_row(e) -> bool:
    """Whether ``e`` differs from row to row of a batch (reads a parameter
    or a seed scalar)."""
    from ..core.lower import LBin, LCall, LParam, LSeedScalar

    if isinstance(e, (LParam, LSeedScalar)):
        return True
    if isinstance(e, LBin):
        return _per_row(e.left) or _per_row(e.right)
    if isinstance(e, LCall):
        return any(_per_row(a) for a in e.args)
    return False


def _hop_measure_bytes(op, batch: int) -> int:
    """The float32 stream a hop's measure is evaluated to, with its
    temporaries: none for no measure or one packed column (the kernel
    decodes it), else a vector of E a node (a row each when it differs from
    row to row)."""
    from ..core.lower import LCol
    from ..storage.columns import DictPackedColumn, PackedColumn

    m = op.measure
    if m is None or (isinstance(m, LCol) and isinstance(m.col, (PackedColumn,
                                                               DictPackedColumn))):
        return 0
    rows = batch if _per_row(m) else 1
    return _vector_nodes(m) * int(op.src_ids.shape[0]) * CELL_BYTES * rows


def _walk_live_bytes(phys, batch: int) -> int:
    """The port's frontier term: the peak of what one walk of ``phys`` at
    batch B holds (every op's output stays live to the walk's end) plus the
    largest transient of one op, plus the result's conversion."""
    from ..core.lower import (
        DegreeFilterOp,
        EntityFilterOp,
        GroupOp,
        HopOp,
        SeedOp,
        iter_flat_ops,
    )
    from ..kernels.fragment_spmm import row_chunk
    from ..kernels.params import EDGE_BLOCK

    vec = CELL_BYTES * batch  # one [B, dom] frontier cell
    live = peak = 0
    dom = 0
    for op in iter_flat_ops(phys):
        held = transient = 0
        if isinstance(op, SeedOp):
            dom = op.dom
            if op.ids is not None:
                held, transient = dom * vec, dom * vec
            else:  # m, its products and from_mask's result
                sub = max((_walk_live_bytes(p, batch) for p in op.programs), default=0)
                held = 2 * dom * vec
                transient = sub + dom * vec + len(op.param_conds) * dom * (vec + batch)
        elif isinstance(op, HopOp):
            if op.semijoin:
                held += dom * vec  # the binarized input
            held += op.dom_dst * vec
            E = int(op.src_ids.shape[0])
            transient = _hop_measure_bytes(op, batch) + 2 * (-(-E // EDGE_BLOCK)) * 8
            if batch > 1:
                rb = row_chunk(batch)
                transient += -(-batch // rb) * rb * op.dom_dst * CELL_BYTES
            dom = op.dom_dst
        elif isinstance(op, EntityFilterOp):
            if op.factor is not None:
                rows = batch if _per_row(op.factor) else 1
                transient = _vector_nodes(op.factor) * dom * CELL_BYTES * rows
                held += dom * CELL_BYTES * rows
            n_masks = (op.const_mask is not None) + len(op.param_conds)
            if op.factor is not None or n_masks:
                held += dom * vec
                transient = max(transient, n_masks * dom * (vec + batch))
        elif isinstance(op, DegreeFilterOp):
            held, transient = dom * vec, dom
        elif isinstance(op, GroupOp):
            dom = op.dom
            if op.entity is None:
                held = dom * vec
        peak = max(peak, live + held + transient)
        live += held
    out = phys.out_dom * vec
    if getattr(phys, "agg", None) == "avg":  # two walks, then s / c
        return peak + 3 * out
    return max(peak, live + out)


def _loop_chunk_bytes(prepared, batch: int) -> int:
    """The port's term: the paths a ``fragment_loop`` chunk holds, when the
    prepared plan is walked path by path (else 0)."""
    from ..core.executor import walks_scalar
    from ..kernels import params as KP

    if prepared.strategy != "fragment_loop" or not walks_scalar(prepared.phys):
        return 0
    return KP.FRAGMENT_LOOP_MAX_PATHS * FRAGMENT_LOOP_PATH_BYTES * batch


def estimate_query_bytes(prepared, batch: int = 1) -> dict[str, int]:
    """Predicted device footprint of executing ``prepared`` at batch B:
    ``resident`` (column store) + ``working`` (the larger of the reference's
    frontier pair and the port's live walk, the edge streams, and a walked
    plan's chunk of paths); ``reference_working_bytes`` is the reference's
    working term alone. Pure host arithmetic — never allocates on device."""
    from ..storage import device_space_report

    resident = 0
    if prepared.device_db is not None:
        rep = device_space_report(prepared.device_db)
        resident = int(rep["total_bytes"]) + int(rep.get("materialized_bytes", 0))
    reference = working = 0
    if prepared.phys is not None:
        pair, edges = _plan_terms(prepared.phys, batch, prepared.hop_estimates)
        reference = pair + edges
        working = (max(pair, _walk_live_bytes(prepared.phys, batch)) + edges
                   + _loop_chunk_bytes(prepared, batch))
    return {
        "resident_bytes": resident,
        "working_bytes": working,
        "reference_working_bytes": reference,
        "total_bytes": resident + working,
    }


class AdmissionController:
    """Pre-execute gate. ``decide`` never raises; ``admit`` raises
    :class:`ResourceError` on reject (and on demote when ``allow_demote``
    is False) — the one-call form for callers without a serial fallback."""

    def __init__(self, budget: MemoryBudget,
                 registry: MetricsRegistry | None = None):
        self.budget = budget
        self.registry = registry if registry is not None else REGISTRY

    def decide(self, prepared, batch: int = 1) -> AdmissionDecision:
        limit = self.budget.effective_bytes
        if limit is None:
            est = estimate_query_bytes(prepared, batch)
            return AdmissionDecision(
                "admit", est["total_bytes"], est["total_bytes"], None,
                reason="no budget configured",
            )
        est = estimate_query_bytes(prepared, batch)
        single = estimate_query_bytes(prepared, 1) if batch > 1 else est
        if est["total_bytes"] <= limit:
            return AdmissionDecision(
                "admit", est["total_bytes"], single["total_bytes"],
                self.budget.limit_bytes,
            )
        self.registry.counter("robust.admission_over_budget").inc()
        if batch > 1 and single["total_bytes"] <= limit:
            self.registry.counter("robust.admission_demotions").inc()
            return AdmissionDecision(
                "demote", est["total_bytes"], single["total_bytes"],
                self.budget.limit_bytes,
                reason=f"batch={batch} over budget; single-query fits",
            )
        self.registry.counter("robust.admission_rejections").inc()
        return AdmissionDecision(
            "reject", est["total_bytes"], single["total_bytes"],
            self.budget.limit_bytes,
            reason="predicted footprint exceeds budget even at batch=1",
        )

    def admit(self, prepared, batch: int = 1,
              allow_demote: bool = False) -> AdmissionDecision:
        d = self.decide(prepared, batch)
        if d.action == "reject" or (d.action == "demote" and not allow_demote):
            raise ResourceError(
                f"admission rejected: predicted {d.predicted_bytes} bytes"
                f" > budget {self.budget.limit_bytes}",
                code="ADMISSION",
                predicted_bytes=d.predicted_bytes,
                limit_bytes=self.budget.limit_bytes,
                batch=batch, action=d.action,
            )
        return d


class PreparedCache:
    """Fixed-capacity LRU for prepared queries: bounds cache growth under
    many distinct query shapes (each entry pins a lowered plan bound to
    device tensors). Eviction order is least-recently-*used* — ``get``
    refreshes.

    Thread-safe: concurrent callers touch one cache; an unguarded
    ``move_to_end`` during ``popitem`` corrupts the OrderedDict."""

    def __init__(self, capacity: int = 64,
                 registry: MetricsRegistry | None = None):
        if capacity < 1:
            raise ValueError(f"PreparedCache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.registry = registry if registry is not None else REGISTRY
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.RLock()

    def get(self, key):
        with self._lock:
            v = self._data.get(key)
            if v is not None:
                self._data.move_to_end(key)
        if v is not None:
            self.registry.counter("engine.prepared_cache_hits").inc()
        return v

    def put(self, key, value) -> None:
        evictions = 0
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evictions += 1
        if evictions:
            self.registry.counter("engine.prepared_cache_evictions").inc(evictions)

    def clear(self) -> int:
        """Drop every entry (device arrays were swapped under the prepared
        executables — a heal or generation reload). Returns entries dropped."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
        if n:
            self.registry.counter("engine.prepared_cache_invalidations").inc(n)
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data
