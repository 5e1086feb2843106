"""Quickstart on the PyTorch port: build a synthetic PubMed-like graph
database on the card, run the paper's relationship queries through the port's
engine, and check them against the numpy oracle.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""
import argparse

import numpy as np

from repro_torch.core.engine import GQFastDatabase, GQFastEngine
from repro_torch.core.reference import run_sql
from repro_torch.data import synth_graph as SG


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    print(f"== GQ-Fast quickstart (PyTorch port, {args.device}) ==")
    schema = SG.make_pubmed(n_docs=20_000, n_terms=800, n_authors=5_000, seed=7)
    db = GQFastDatabase(schema, account_space=True, device=args.device)
    rep = db.space_report()
    print(f"loaded: DT={schema.relationships['DT'].num_rows} rows, "
          f"DA={schema.relationships['DA'].num_rows} rows; "
          f"GQ-Fast indices: {rep['total_bytes']/1e6:.1f} MB on the host, "
          f"{rep['device']['total_bytes']/1e6:.1f} MB on {args.device}")
    for iname, idx in rep["indexes"].items():
        encs = {c: v["encoding"] for c, v in idx["columns"].items()}
        print(f"  {iname}: {encs}")

    eng = GQFastEngine(db)

    print("\n-- AS query (author similarity, author 17) --")
    for a, s in eng.query_topk(SG.QUERY_AS, k=5, a0=17):
        print(f"  author {a:6d}  score {s:10.2f}")

    print("\n-- AD query (authors publishing on terms 3 ∧ 9) --")
    for a, s in eng.query_topk(SG.QUERY_AD, k=5, t1=3, t2=9):
        print(f"  author {a:6d}  papers {int(s)}")

    print("\n-- engine == numpy oracle on the paper's queries --")
    checks = [("SD", SG.QUERY_SD, {"d0": 5}), ("FSD", SG.QUERY_FSD, {"d0": 5}),
              ("AS", SG.QUERY_AS, {"a0": 17}), ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
              ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
              ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005})]
    ok = True
    for name, sql, params in checks:
        got = eng.query(sql, **params)
        want = run_sql(schema, sql, params)
        match = np.allclose(got, want, rtol=1e-4, atol=1e-4)
        ok &= match
        print(f"  {name:7s} match: {match}")

    print("\n-- prepared statement, executed for 4 different authors --")
    pq = eng.prepare(SG.QUERY_AS)
    batch = pq.execute_batch(a0=np.asarray([3, 5, 17, 40]))
    print("  batch result:", batch.shape, "rows nonzero:",
          [int((batch[i] != 0).sum()) for i in range(4)])
    for i, a0 in enumerate([3, 5, 17, 40]):
        ok &= np.allclose(batch[i], run_sql(schema, SG.QUERY_AS, {"a0": a0}),
                          rtol=1e-4, atol=1e-4)
    if not ok:
        raise SystemExit("quickstart: an answer differs from the numpy oracle")
    print("  every answer matches the oracle")


if __name__ == "__main__":
    main()
