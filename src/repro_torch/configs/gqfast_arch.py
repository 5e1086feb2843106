"""The paper's own workload as an architecture: relationship queries on
PubMed-M-scale data (Table 1: DT 901M rows, DA 61M rows, 23.3M docs, 27.9k
MeSH terms, 6.3M authors). Its shapes lower onto a production mesh with
ROADMAP Queue 1 item 15c; ``smoke`` runs AS through the port's engine and
holds it to the numpy oracle."""
from __future__ import annotations

import numpy as np

from .base import ArchConfig

# PubMed-M full-scale statistics (paper Table 1)
FULL = dict(
    n_docs=23_326_299,
    n_terms=27_883,
    n_authors=6_301_521,
    dt_edges=901_388_401,
    da_edges=61_329_130,
)

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
