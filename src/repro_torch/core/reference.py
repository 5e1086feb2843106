"""Materializing numpy engine: correctness oracle + the paper's baselines.

Executes the same chain plan by *enumerating join paths* (materialized id/weight
arrays per hop) — the MonetDB/OMC/PMC execution model the paper compares against:

  * lookup='index'  — dense-ID direct offset lookup  (OMC-denseID / GQ-Fast-UA)
  * lookup='binary' — binary search on the sorted key (OMC / GQ-Fast-UA(Binary), Table 5)
  * lookup='scan'   — whole-column scan per hop       (PMC, Appendix 9.3)
  * agg='dense'     — γ¹ dense array                  (paper §6.1)
  * agg='hash'      — hash-style grouping             (GQ-Fast-UA(Map), Table 6)

``stats`` records materialized-intermediate sizes (paper Fig. 14 ablation).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .algebra import (
    ChainPlan,
    EntityStep,
    Param,
    RelHop,
    SeedIds,
    SeedMask,
    eval_expr,
    expr_refs,
)
from .schema import Schema


@dataclass
class _SortedCopy:
    key_sorted: np.ndarray  # the sorted key column
    indptr: np.ndarray  # offsets per dense key id (for lookup='index')
    other: np.ndarray  # co-sorted other-FK column
    measures: dict[str, np.ndarray]
    key_raw: np.ndarray  # unsorted (for lookup='scan')
    other_raw: np.ndarray
    measures_raw: dict[str, np.ndarray]


@dataclass
class ExecStats:
    materialized_elements: int = 0
    lookups: int = 0
    hops: int = 0


class NumpyQueryEngine:
    def __init__(self, schema: Schema, lookup: str = "index", agg: str = "dense"):
        assert lookup in ("index", "binary", "scan") and agg in ("dense", "hash")
        self.schema = schema
        self.lookup = lookup
        self.agg = agg
        self.copies: dict[tuple[str, str], _SortedCopy] = {}
        for rel in schema.relationships.values():
            for key in (rel.fk1, rel.fk2):
                kcol = rel.columns[key].astype(np.int64)
                other = rel.other_fk(key)
                ocol = rel.columns[other].astype(np.int64)
                order = np.lexsort((ocol, kcol))
                h = schema.domain_size(rel.fk_entity(key))
                indptr = np.zeros(h + 1, dtype=np.int64)
                np.cumsum(np.bincount(kcol, minlength=h), out=indptr[1:])
                self.copies[(rel.name, key)] = _SortedCopy(
                    kcol[order], indptr, ocol[order],
                    {m: rel.columns[m].astype(np.float64)[order] for m in rel.measures},
                    kcol, ocol,
                    {m: rel.columns[m].astype(np.float64) for m in rel.measures},
                )
        self.stats = ExecStats()

    # ------------------------------------------------------------------
    def execute_plan(self, plan: ChainPlan, params: dict[str, Any]) -> np.ndarray:
        self.stats = ExecStats()
        ids, w, scalars = self._seed(plan, params)
        for s in plan.steps:
            if isinstance(s, RelHop):
                ids, w = self._hop(s, ids, w, params, scalars)
            else:
                ids, w = self._entity_step(s, ids, w, params, scalars)
            self.stats.materialized_elements += ids.shape[0]
        dom = self.schema.domain_size(
            plan.group_entity if plan.group_entity else _final_entity(plan)
        )
        if plan.group_entity is None:
            out = np.zeros(dom)
            out[ids[w > 0]] = 1.0
            return out
        if self.agg == "dense":
            return _gamma_dense(plan.agg, ids, w, dom)
        # hash-style grouping: γ over the compact id set, scattered to dom
        uniq, inv = np.unique(ids, return_inverse=True)
        acc = _gamma_dense(plan.agg, inv, w, uniq.shape[0])
        out = np.zeros(dom)
        out[uniq] = acc
        return out

    # ------------------------------------------------------------------
    def _seed(self, plan: ChainPlan, params):
        scalars: dict[tuple[str, str], float] = {}
        if isinstance(plan.seed, SeedIds):
            raw = plan.seed.ids if isinstance(plan.seed.ids, list) else [plan.seed.ids]
            ids = np.asarray([_res(i, params) for i in raw], dtype=np.int64)
            ent = self.schema.entities[plan.seed.entity]
            if len(ids) == 1:
                for a, col in ent.attributes.items():
                    scalars[(plan.seed.var, a)] = float(col[ids[0]])
            return ids, np.ones(ids.shape[0]), scalars
        mask = np.ones(self.schema.domain_size(plan.seed.entity), dtype=bool)
        for chain in plan.seed.chains:
            mask &= self.execute_plan(chain, params) > 0
        for c in plan.seed.entity_conds:
            col = self.schema.entities[plan.seed.entity].attributes[c.ref.attr]
            v = _res(c.value, params)
            mask &= {
                "=": col == v, ">": col > v, "<": col < v,
                ">=": col >= v, "<=": col <= v,
            }[c.op]
        ids = np.nonzero(mask)[0].astype(np.int64)
        return ids, np.ones(ids.shape[0]), scalars

    def _hop(self, s: RelHop, ids, w, params, scalars):
        cp = self.copies[(s.table, s.src_key)]
        self.stats.hops += 1
        if s.semijoin:
            keep = w > 0
            ids = np.unique(ids[keep])
            w = np.ones(ids.shape[0])
        if s.degree_filter:
            deg = np.diff(cp.indptr)
            keep = deg[ids] > 0
            return ids[keep], w[keep]
        self.stats.lookups += ids.shape[0]
        if self.lookup == "scan":
            # one whole-column scan per hop (vectorized PMC)
            sel = np.isin(cp.key_raw, ids)
            pos = np.nonzero(sel)[0]
            # map each matched row back to the weight of its source id
            wmap = np.zeros(self.schema.domain_size(s.src_entity))
            np.add.at(wmap, ids, w)  # duplicate source ids accumulate
            new_w = wmap[cp.key_raw[pos]]
            dst = cp.other_raw[pos]
            meas = {m: v[pos] for m, v in cp.measures_raw.items()}
        else:
            if self.lookup == "binary":
                starts = np.searchsorted(cp.key_sorted, ids, side="left")
                ends = np.searchsorted(cp.key_sorted, ids, side="right")
            else:
                starts = cp.indptr[ids]
                ends = cp.indptr[ids + 1]
            counts = ends - starts
            total = int(counts.sum())
            rep = np.repeat(np.arange(ids.shape[0]), counts)
            offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
            pos = np.repeat(starts, counts) + offs
            dst = cp.other[pos]
            new_w = w[rep]
            meas = {m: v[pos] for m, v in cp.measures.items()}
        if s.measure_expr is not None:
            env: dict = dict(scalars)
            for r in expr_refs(s.measure_expr):
                if r.var == s.var:
                    env[(r.var, r.attr)] = meas[r.attr]
            new_w = new_w * eval_expr(s.measure_expr, env, params, np)
        self.stats.materialized_elements += int(dst.shape[0])
        return dst.astype(np.int64), new_w

    def _entity_step(self, s: EntityStep, ids, w, params, scalars):
        ent = self.schema.entities[s.entity]
        if s.factor_expr is not None:
            env: dict = dict(scalars)
            for r in expr_refs(s.factor_expr):
                if r.var == s.var:
                    env[(r.var, r.attr)] = ent.attributes[r.attr][ids]
            w = w * eval_expr(s.factor_expr, env, params, np)
        for c in s.conds:
            col = ent.attributes[c.ref.attr][ids]
            v = _res(c.value, params)
            keep = {
                "=": col == v, ">": col > v, "<": col < v,
                ">=": col >= v, "<=": col <= v,
            }[c.op]
            ids, w = ids[keep], w[keep]
        return ids, w


def _gamma_dense(agg: str, ids: np.ndarray, w: np.ndarray, dom: int) -> np.ndarray:
    """Dense γ over [0, dom) for every supported aggregate; empty groups
    report 0 (the engine's output convention)."""
    if agg in ("count", "sum"):
        return np.bincount(ids, weights=w, minlength=dom).astype(np.float64)
    if agg == "exists":
        return (np.bincount(ids, minlength=dom) > 0).astype(np.float64)
    if agg == "avg":
        s = np.bincount(ids, weights=w, minlength=dom)
        c = np.bincount(ids, minlength=dom)
        return np.divide(s, c, out=np.zeros(dom), where=c > 0)
    if agg in ("min", "max"):
        ident = np.inf if agg == "min" else -np.inf
        acc = np.full(dom, ident)
        (np.minimum if agg == "min" else np.maximum).at(acc, ids, w)
        return np.where(acc == ident, 0.0, acc)
    raise ValueError(f"unsupported aggregate {agg}")


def _res(v, params):
    return params[v.name] if isinstance(v, Param) else v


def _final_entity(plan: ChainPlan) -> str:
    hops = [s for s in plan.steps if isinstance(s, RelHop) and not s.degree_filter]
    return hops[-1].dst_entity if hops else plan.seed.entity


def run_sql(schema: Schema, sql: str, params: dict[str, Any] | None = None,
            lookup: str = "index", agg: str = "dense") -> np.ndarray:
    from .planner import plan_query
    from .sql import parse

    eng = NumpyQueryEngine(schema, lookup, agg)
    return eng.execute_plan(plan_query(schema, parse(sql)), params or {})
