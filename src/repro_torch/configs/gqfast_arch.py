"""The paper's own workload as an architecture: relationship queries on
PubMed-M-scale data (Table 1: DT 901M rows, DA 61M rows, 23.3M docs, 27.9k
MeSH terms, 6.3M authors). ``smoke`` runs AS through the port's engine and
holds it to the numpy oracle.

``make_cell`` lays a shape out on a production mesh for the dry run: the
edge columns at full scale (``FULL``, padded to the shard count) as meta
DTensors sharded over ``EDGE_AXES`` (over 'data' alone for the 'data_only'
variant), the index pointers replicated. The chain plan is lowered from a
tiny instance with the full entity domains (plans depend on the schema and
the domain sizes, not on edge values). The distributed walk
(``executor.compile_frontier_distributed``) launches its hop kernels
through ``ctypes``, which cannot run on meta tensors, so the cell's hops are
counted, not launched: each hop's work on the local shard by
``roofline.analysis.hop_work`` (the count ``chip_smoke.py``'s hop bounds
use) and one all_reduce of its ``[B,] n_dst`` frontier and the walk's four
flags, as ``_DistributedInterp`` issues (in bfloat16 for the
'bf16_frontier' variant).
"""
from __future__ import annotations

import numpy as np

from .base import ArchConfig, Cell

# PubMed-M full-scale statistics (paper Table 1)
FULL = dict(
    n_docs=23_326_299,
    n_terms=27_883,
    n_authors=6_301_521,
    dt_edges=901_388_401,
    da_edges=61_329_130,
)

EDGE_AXES = ("data", "model")


def _pad(n: int, shards: int) -> int:
    return -(-n // shards) * shards


GQFAST_SHAPES = {
    "as_b1": dict(query="AS", batch=0),
    "as_b8": dict(query="AS", batch=8),
    "ad_b8": dict(query="AD", batch=8),
    "fad_b8": dict(query="FAD", batch=8),
}


class GQFastArch(ArchConfig):
    kind = "gqfast"
    shape_ids = list(GQFAST_SHAPES)

    def __init__(self):
        self.arch_id = "gqfast-pubmed"
        self._tiny = None

    def _tiny_db(self):
        if self._tiny is None:
            from ..core.engine import GQFastDatabase
            from ..data import synth_graph as SG

            # tiny edge sets, FULL entity domain sizes (plans bake domain sizes)
            schema = SG.make_pubmed(
                n_docs=FULL["n_docs"], n_terms=FULL["n_terms"],
                n_authors=FULL["n_authors"],
                avg_terms_per_doc=3e-4, avg_authors_per_doc=1e-4, seed=0,
            )
            self._tiny = GQFastDatabase(schema, account_space=False, device="cpu")
        return self._tiny

    def make_cell(self, shape_id: str, mesh, variant: str = "") -> Cell:
        import torch

        from ..core.lower import HopOp, iter_flat_ops, lower
        from ..core.planner import plan_query
        from ..core.sql import parse
        from ..data import synth_graph as SG
        from ..dist.sharding import distribute_tree, named
        from ..roofline.analysis import count_work, hop_work

        sh = GQFAST_SHAPES[shape_id]
        db = self._tiny_db()
        phys = lower(db.device, plan_query(db.schema, parse(getattr(SG, "QUERY_" + sh["query"]))))
        B = sh["batch"]
        axes = ("data",) if variant == "data_only" else EDGE_AXES
        frontier_bytes = 2 if variant == "bf16_frontier" else 4
        names = tuple(mesh.mesh_dim_names)
        nshards = int(np.prod([tuple(mesh.shape)[names.index(a)] for a in axes]))

        def hops(p):
            for op in iter_flat_ops(p):
                if isinstance(op, HopOp):
                    yield op
                for sub in getattr(op, "programs", None) or ():
                    yield from hops(sub)

        plan_hops = list(hops(phys)) * (2 if phys.agg == "avg" else 1)
        meta = dict(device="meta")
        edges_abs, side_abs = {}, {}
        for op in plan_hops:
            key = f"{op.table}::{op.src_key}"
            E = _pad(FULL["dt_edges" if op.table == "DT" else "da_edges"], nshards)
            cols = {"src_ids": torch.empty((E,), dtype=torch.int32, **meta),
                    "dst_ids": torch.empty((E,), dtype=torch.int32, **meta)}
            if op.measure is not None:
                cols["measure"] = torch.empty((E,), dtype=torch.float32, **meta)
            edges_abs[key] = {**edges_abs.get(key, {}), **cols}
            side_abs[key] = {"indptr": torch.empty(tuple(op.indptr.shape), dtype=op.indptr.dtype,
                                                   **meta)}
        p_abs = tuple(torch.empty((B,) if B else (), dtype=torch.int32, **meta)
                      for _ in phys.param_names)
        edge_sh = {k: {c: named(mesh, (axes,), v.shape) for c, v in cols.items()}
                   for k, cols in edges_abs.items()}
        side_sh = {k: {"indptr": named(mesh, ())} for k in side_abs}
        p_sh = tuple(named(mesh, ()) for _ in p_abs)

        def fn(edges, side, *params):
            rows = max(B, 1)
            for op in plan_hops:
                cols = edges[f"{op.table}::{op.src_key}"]
                E = int(cols["src_ids"].to_local().shape[0])
                n_src = int(side[f"{op.table}::{op.src_key}"]["indptr"].shape[0]) - 1
                m_bytes = 4 * E if "measure" in cols and op.measure is not None else 0
                nbytes, ops = hop_work(E, n_src, op.dom_dst, 4 * E, m_bytes, batch=rows)
                count_work(ops, nbytes,
                           {"all-reduce": (rows * op.dom_dst + 4) * frontier_bytes})
            return None

        mf = 2.0 * (FULL["dt_edges"] * 2 + FULL["da_edges"] * 2) * max(B, 1)
        return Cell(self.arch_id, shape_id, fn,
                    (distribute_tree(edges_abs, edge_sh, mesh),
                     distribute_tree(side_abs, side_sh, mesh))
                    + tuple(distribute_tree(p, s, mesh) for p, s in zip(p_abs, p_sh)),
                    (edge_sh, side_sh) + p_sh, "serve", mf,
                    notes=f"query={sh['query']} frontier-SpMV chain")

    def smoke(self, device="cuda") -> dict:
        from ..core.engine import GQFastDatabase, GQFastEngine
        from ..core.reference import run_sql
        from ..data import synth_graph as SG

        schema = SG.make_pubmed(n_docs=500, n_terms=50, n_authors=200)
        eng = GQFastEngine(GQFastDatabase(schema, account_space=False, device=device))
        got = eng.query(SG.QUERY_AS, a0=7)
        ref = run_sql(schema, SG.QUERY_AS, {"a0": 7})
        return {
            "match": bool(np.allclose(got, ref, rtol=1e-4, atol=1e-4)),
            "nnz": int((got != 0).sum()),
            "finite": bool(np.isfinite(got).all()),
        }


GQFAST = GQFastArch()
