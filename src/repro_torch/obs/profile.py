"""Query profiling: per-IR-op timings and predicted against observed hop
fractions.

:func:`profile_prepared` turns runs of a prepared query into a
:class:`QueryProfile`, the payload behind ``PreparedQuery.profile()`` and
``explain(analyze=True)``:

  * **result** — from the query's own executable (``pq.fn``) with the
    arguments ``__call__`` passes. On the CPU it equals ``__call__``'s bit
    for bit; on the card a float sum may differ in its last bits from one
    call to the next, because the hop kernels' atomics add in whatever order
    they land.
  * **total_wall_ms** — the median fenced end-to-end time of ``reps`` runs.
  * **ops** — per-IR-op self wall and fenced time from one recorded run of
    the same executable (``executor.walk_ir`` opens a span an op while a
    tracer records, and synchronises the card at each op's entry), rescaled
    so that the self walls sum to ``total_wall_ms`` (``timing_method:
    "eager-span-scaled"``; the raw walls stay in each op's meta): the
    recorded run's syncs make its absolute times too large, its shares
    stand. An op with no span is marked ``fused``.
  * **hops** — the engine's estimates (``_hop_fractions``) against the
    fractions observed by a support propagation over the plan on the
    database's device (structural reachability: the quantity the estimate
    predicts; measures do not move it). A hop off by more than
    :data:`MISPREDICT_FACTOR` either way adds one to the
    ``strategy_mispredict`` counter of :data:`repro_torch.obs.metrics.
    REGISTRY`; the observed fractions go to the engine's calibration store.
  * **memory** — ``storage.device_space_report`` of the query's device DB.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import trace as T
from .metrics import REGISTRY

#: observed/estimated active-fraction ratio beyond which (either direction)
#: a hop counts as a strategy-model mispredict
MISPREDICT_FACTOR = 2.0


@dataclass
class OpProfile:
    index: int
    name: str  # op_signature label, e.g. "Hop(DT.Term->Doc;measure)"
    wall_ms: float | None = None  # self wall (minus child ops); None if fused
    kernel_ms: float | None = None  # fenced own time
    calls: int = 1
    fused: bool = False  # no span: time charged to an enclosing op
    meta: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"index": self.index, "name": self.name, "calls": self.calls}
        if self.wall_ms is not None:
            d["wall_ms"] = round(self.wall_ms, 4)
        if self.kernel_ms is not None:
            d["kernel_ms"] = round(self.kernel_ms, 4)
        if self.fused:
            d["fused"] = True
        if self.meta:
            d["meta"] = self.meta
        return d


@dataclass
class HopProfile:
    table: str
    src_key: str
    est_active_fraction: float | None
    observed_active_fraction: float | None
    mispredict: bool = False
    meta: dict = field(default_factory=dict)

    @property
    def ratio(self) -> float | None:
        if not self.est_active_fraction or self.observed_active_fraction is None:
            return None
        return self.observed_active_fraction / self.est_active_fraction

    def to_dict(self) -> dict:
        d: dict = {
            "table": self.table, "src_key": self.src_key,
            "est_active_fraction": self.est_active_fraction,
            "observed_active_fraction": self.observed_active_fraction,
            "mispredict": self.mispredict,
        }
        if self.ratio is not None:
            d["ratio"] = round(self.ratio, 4)
        d.update(self.meta)
        return d


@dataclass
class QueryProfile:
    sql: str
    strategy: str
    block_skipping: str
    agg: str | None
    params: dict
    total_wall_ms: float
    reps: int
    result: np.ndarray
    ops: list[OpProfile]
    hops: list[HopProfile]
    memory: dict | None = None
    spans: dict | None = None  # raw span tree of the recorded run
    timing_method: str = "eager-span"  # | "eager-span-scaled"

    def to_dict(self) -> dict:
        return {
            "sql": " ".join(self.sql.split()),
            "strategy": self.strategy,
            "block_skipping": self.block_skipping,
            "agg": self.agg,
            "params": {k: _jsonable(v) for k, v in self.params.items()},
            "total_wall_ms": round(self.total_wall_ms, 4),
            "reps": self.reps,
            "timing_method": self.timing_method,
            "result_shape": list(self.result.shape),
            "result_nnz": int(np.count_nonzero(self.result)),
            "ops": [o.to_dict() for o in self.ops],
            "hops": [h.to_dict() for h in self.hops],
            "memory": self.memory,
            "spans": self.spans,
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **kw)

    def phase_summary(self) -> dict[str, float]:
        """op label → self wall ms (fused ops omitted): the compact per-phase
        breakdown to keep beside a headline number."""
        return {
            f"[{o.index}] {o.name}": round(o.wall_ms, 4)
            for o in self.ops if o.wall_ms is not None
        }

    def render(self) -> str:
        """The EXPLAIN ANALYZE text block (appended to ``explain()``)."""
        out = [
            f"analyze: total {self.total_wall_ms:.3f} ms fenced "
            f"(median of {self.reps}; result shape {list(self.result.shape)}, "
            f"nnz {int(np.count_nonzero(self.result))}; "
            f"per-op via {self.timing_method})",
        ]
        for o in self.ops:
            if o.fused or o.wall_ms is None:
                timing = "(fused into enclosing op)" if o.fused else "(not measured)"
            else:
                timing = f"wall {o.wall_ms:8.3f} ms  kernel {o.kernel_ms or 0.0:8.3f} ms"
                if o.calls > 1:
                    timing += f"  calls={o.calls}"
            extras = "".join(
                f" {k}={o.meta[k]}"
                for k in ("active_blocks", "n_blocks", "skip_tier") if k in o.meta
            )
            out.append(f"  [{o.index}] {o.name:40s} {timing}{extras}")
        if self.hops:
            out.append("hops (predicted vs observed active fraction):")
            for h in self.hops:
                est = "n/a" if h.est_active_fraction is None else f"{h.est_active_fraction:.4g}"
                obs = ("n/a" if h.observed_active_fraction is None
                       else f"{h.observed_active_fraction:.4g}")
                line = f"  I_{h.table}.{h.src_key}: est={est} obs={obs}"
                if h.ratio is not None:
                    line += f" ratio={h.ratio:.2f}"
                if h.mispredict:
                    line += f"  MISPREDICT(>{MISPREDICT_FACTOR:g}x)"
                out.append(line)
        if self.memory:
            tot, dense = self.memory.get("total_bytes"), self.memory.get("dense_bytes")
            if tot:
                out.append(
                    f"memory: device {tot/2**20:.2f} MiB"
                    + (f" (decoded-CSR baseline {dense/2**20:.2f} MiB, "
                       f"ratio {dense/tot:.2f})" if dense else "")
                )
        return "\n".join(out)


def _jsonable(v):
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()


def mispredicted(est: float | None, obs: float | None,
                 factor: float = MISPREDICT_FACTOR) -> bool:
    """Is the observed active fraction off by more than ``factor`` in either
    direction from the estimate? (Both ~0 agree: a correctly-predicted dead
    hop is not a mispredict.)"""
    if est is None or obs is None:
        return False
    if est < 1e-12 and obs < 1e-12:
        return False
    if est <= 0.0:
        return True
    return not (est / factor <= obs <= est * factor)


# ---------------------------------------------------------------------------
# Observed hop fractions: support propagation over the physical IR
# ---------------------------------------------------------------------------


def observed_hop_fractions(phys, params: dict) -> list[dict]:
    """Walk the lowered IR with a boolean support vector on the database's
    device and record, for every top-level HopOp (a fused region's member
    hops one by one), the fraction of its edges whose source is in the
    incoming support: the observed counterpart of the engine's
    ``_hop_fractions`` estimate. Only the counts reach the host."""
    from ..core.executor import _host_scalar

    hops: list[dict] = []
    _support_walk(phys, {n: _host_scalar(v) for n, v in params.items()}, hops)
    return hops


def _support_walk(phys, params: dict, hops_out: list[dict] | None) -> torch.Tensor:
    from ..core.executor import _seed_index
    from ..core.lower import (
        DegreeFilterOp, EntityFilterOp, GroupOp, HopOp, LParam, SeedOp, iter_flat_ops,
    )
    from ..kernels.active import active_flags

    array = lambda c: c.array
    device = _plan_device(phys)
    sup: torch.Tensor | None = None
    for op in iter_flat_ops(phys):
        if isinstance(op, SeedOp):
            if op.ids is not None:
                ids = [int(params[i.name]) if isinstance(i, LParam) else int(i)
                       for i in op.ids]
                sup = torch.zeros(op.dom, dtype=torch.bool, device=device)
                sup[_seed_index(ids, op.dom, sup.device)] = True
            else:
                sup = torch.ones(op.dom, dtype=torch.bool, device=device)
                for prog in op.programs:  # sub-chain hops are not top-level
                    sup &= _support_walk(prog, params, None)
                if op.const_mask is not None:
                    sup &= op.const_mask > 0
                for c in op.param_conds:
                    sup &= c.mask(params, array)
        elif isinstance(op, HopOp):
            E = int(op.src_ids.shape[0])
            edge_active = sup.index_select(0, op.src_ids)
            pos = edge_active.nonzero().squeeze(1)  # the active edges' positions
            reached = torch.zeros(op.dom_dst, dtype=torch.bool, device=sup.device)
            reached[op.dst_col.gather(pos).to(torch.int64)] = True
            if hops_out is not None:
                touched = int(pos.shape[0])
                rec = {
                    "table": op.table, "src_key": op.src_key,
                    "observed_active_fraction": touched / max(E, 1),
                    "touched_edges": touched, "E": E,
                    "frontier_nnz": int(sup.sum()),
                    "reached": int(reached.sum()),
                }
                if op.block_src_min is not None:
                    n_blocks = int(op.block_src_min.shape[0])
                    active = int(active_flags(sup, op.block_src_min, op.block_src_max).sum())
                    rec["active_blocks"] = active
                    rec["n_blocks"] = n_blocks
                    rec["active_block_fraction"] = round(active / n_blocks, 6)
                hops_out.append(rec)
            sup = reached
        elif isinstance(op, DegreeFilterOp):
            sup = sup & (op.degrees > 0)
        elif isinstance(op, EntityFilterOp):
            if op.const_mask is not None:
                sup = sup & (op.const_mask > 0)
            for c in op.param_conds:
                sup = sup & c.mask(params, array)
        elif isinstance(op, GroupOp):
            pass
        else:  # pragma: no cover - new op kinds must be taught here
            raise TypeError(op)
    return sup


def _plan_device(phys) -> torch.device:
    """Where the plan's tensors live: its first hop's (a sub-program's
    included), else the CPU."""
    from ..core.lower import HopOp, SeedOp, iter_flat_ops

    for op in iter_flat_ops(phys):
        if isinstance(op, HopOp):
            return op.src_ids.device
        if isinstance(op, SeedOp):
            for prog in op.programs:
                return _plan_device(prog)
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# Per-op timing
# ---------------------------------------------------------------------------


def _records_from_tracer(tracer: T.Tracer, phys) -> list[OpProfile]:
    """Aggregate the recorded run's op spans (matched to ``phys`` by the plan
    key) into one OpProfile per IR op; an op with no span is ``fused``."""
    labels = phys.op_signature()
    plan_key = id(phys.ops)
    agg: dict[int, OpProfile] = {}
    for sp in tracer.iter_spans():
        if sp.meta.get("plan") != plan_key or "op_index" not in sp.meta:
            continue
        i = sp.meta["op_index"]
        rec = agg.get(i)
        if rec is None:
            rec = agg[i] = OpProfile(index=i, name=labels[i], wall_ms=0.0,
                                     kernel_ms=0.0, calls=0)
            rec.meta = {
                k: v for k, v in sp.meta.items() if k not in ("plan", "op_index")
            }
        # self time subtracts only same-plan op children: a mask seed's
        # sub-program walks are children too, but their cost belongs to the
        # seed op that evaluated them
        w = sp.wall_ms or 0.0
        for c in sp.children:
            if c.meta.get("plan") == plan_key and "op_index" in c.meta:
                w -= c.wall_ms or 0.0
        rec.wall_ms += max(w, 0.0)
        rec.kernel_ms += sp.kernel_ms or 0.0
        rec.calls += sp.meta.get("calls", 1)
        if sp.meta.get("fused_tail"):
            rec.meta["fused_tail"] = True
    return [agg[i] if i in agg else OpProfile(index=i, name=labels[i], fused=True)
            for i in range(len(phys.ops))]


def _op_records_eager(pq, args: list):
    """One recorded run of the query's own executable, after one to warm it
    (results discarded: only the plain runs' output is returned)."""
    with T.recording():
        pq.fn(*args)
    with T.recording() as tr:
        pq.fn(*args)
    return _records_from_tracer(tr, pq.phys), tr.to_dict()


def _rescale_eager_ops(ops: list[OpProfile], total_ms: float) -> list[OpProfile]:
    """Reconcile the recorded run's per-op times with the plain end-to-end
    measurement: every measured op's wall scales by one factor so that the
    self walls sum to ``total_ms`` exactly (the recorded run synchronises the
    card at every op, so its absolute walls run long); the raw measurements
    stay in each op's meta as ``eager_wall_ms`` / ``eager_kernel_ms``."""
    walls = [o.wall_ms for o in ops if o.wall_ms is not None]
    tot = float(sum(walls))
    if tot <= 0.0 or total_ms <= 0.0:
        return ops
    scale = total_ms / tot
    for o in ops:
        if o.wall_ms is None:
            continue
        o.meta["eager_wall_ms"] = round(o.wall_ms, 4)
        o.wall_ms = o.wall_ms * scale
        if o.kernel_ms is not None:
            o.meta["eager_kernel_ms"] = round(o.kernel_ms, 4)
            o.kernel_ms = min(o.kernel_ms * scale, o.wall_ms)
    return ops


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def profile_prepared(pq, params: dict, reps: int = 3) -> QueryProfile:
    """Build a :class:`QueryProfile` for one parameter binding of a
    ``PreparedQuery`` (the implementation behind ``PreparedQuery.profile``)."""
    from ..core.lower import FusedHopOp, HopOp
    from ..storage import device_space_report

    pq.validate_params(params)
    phys = pq.phys
    args = [params[n] for n in pq.param_names]

    # result and end-to-end time: the query's own executable, same args
    result = pq.fn(*args).cpu().numpy()
    ts = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        pq.fn(*args)
        T.sync()
        ts.append(time.perf_counter() - t0)
    total_ms = float(np.median(ts)) * 1e3

    # predicted against observed hop fractions (whatever the strategy)
    estimates = pq.hop_estimates or []
    hops: list[HopProfile] = []
    for i, obs in enumerate(observed_hop_fractions(phys, params)):
        est_f = (estimates[i] if i < len(estimates) else {}).get("est_active_fraction")
        obs_f = obs["observed_active_fraction"]
        mis = mispredicted(est_f, obs_f)
        if mis:
            REGISTRY.counter("strategy_mispredict").inc()
        hops.append(HopProfile(
            table=obs["table"], src_key=obs["src_key"],
            est_active_fraction=est_f, observed_active_fraction=obs_f,
            mispredict=mis,
            meta={k: v for k, v in obs.items()
                  if k not in ("table", "src_key", "observed_active_fraction")},
        ))
    REGISTRY.counter("profile_runs").inc()

    # the next prepare of the same plan shape picks its strategy from what
    # this run touched
    if pq.calibration is not None and pq.plan_sig:
        pq.calibration.record(pq.plan_sig, [h.observed_active_fraction for h in hops])

    ops, spans = _op_records_eager(pq, args)
    ops = _rescale_eager_ops(ops, total_ms)
    method = ("eager-span-scaled" if any("eager_wall_ms" in o.meta for o in ops)
              else "eager-span")

    # the observed fractions onto the matching op records: a HopOp takes one
    # HopProfile, a FusedHopOp one a member hop (its span shows the first's)
    hop_iter = iter(hops)
    for i, op in enumerate(phys.ops):
        if isinstance(op, FusedHopOp):
            member_hops = op.hops
        elif isinstance(op, HopOp):
            member_hops = (op,)
        else:
            continue
        h = [next(hop_iter, None) for _ in member_hops][0]
        if h is not None:
            ops[i].meta.setdefault("est_active_fraction", h.est_active_fraction)
            ops[i].meta.setdefault("observed_active_fraction", h.observed_active_fraction)
            for k in ("active_blocks", "n_blocks"):
                if k in h.meta:
                    ops[i].meta.setdefault(k, h.meta[k])

    memory = device_space_report(pq.device_db) if pq.device_db is not None else None
    return QueryProfile(
        sql=pq.sql, strategy=pq.strategy, block_skipping=pq.block_skipping,
        agg=phys.agg, params=dict(params), total_wall_ms=total_ms,
        reps=max(reps, 1), result=result, ops=ops, hops=hops,
        memory=memory, spans=spans, timing_method=method,
    )
