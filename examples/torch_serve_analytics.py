"""End-to-end serving example on the PyTorch port (the paper's kind: OLAP
serving): load a PubMed-shaped synthetic database on the card, prepare the
dashboard queries once, then serve interactive requests and one batched
dashboard refresh, and report latency percentiles and throughput.

    PYTHONPATH=src python examples/torch_serve_analytics.py [--requests 120] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.engine import GQFastDatabase, GQFastEngine
from repro_torch.data import synth_graph as SG


class AnalyticsServer:
    """Prepared-query server (paper §3: prepare once / execute many)."""

    def __init__(self, engine: GQFastEngine, queries: dict[str, str]):
        self.engine = engine
        self.prepared = {name: engine.prepare(sql) for name, sql in queries.items()}
        self.latencies: dict[str, list[float]] = {n: [] for n in queries}

    def serve(self, name: str, **params) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.prepared[name](**params)  # host numpy: waits for the device
        self.latencies[name].append(time.perf_counter() - t0)
        return out

    def serve_batch(self, name: str, **param_arrays) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.prepared[name].execute_batch(**param_arrays)
        self.latencies[name].append(time.perf_counter() - t0)
        return out

    def report(self) -> None:
        print(f"\n{'query':10s} {'n':>5s} {'p50 ms':>9s} {'p99 ms':>9s} {'qps':>9s}")
        for name, ls in self.latencies.items():
            if not ls:
                continue
            arr = np.asarray(ls) * 1e3
            print(f"{name:10s} {len(ls):5d} {np.percentile(arr,50):9.2f} "
                  f"{np.percentile(arr,99):9.2f} {1000.0/arr.mean():9.1f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--docs", type=int, default=40_000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    print(f"loading database on {args.device}…")
    t0 = time.time()
    schema = SG.make_pubmed(n_docs=args.docs, n_terms=1_200, n_authors=9_000, seed=5)
    db = GQFastDatabase(schema, account_space=False, device=args.device)
    eng = GQFastEngine(db)
    print(f"  {time.time()-t0:.1f}s "
          f"(DT {schema.relationships['DT'].num_rows} rows, "
          f"DA {schema.relationships['DA'].num_rows} rows)")

    server = AnalyticsServer(eng, {
        "AS": SG.QUERY_AS, "SD": SG.QUERY_SD, "FSD": SG.QUERY_FSD,
        "AD": SG.QUERY_AD, "FAD": SG.QUERY_FAD,
    })

    print("warmup (kernel builds and first launches)…")
    server.serve("AS", a0=1)
    server.serve("SD", d0=1)
    server.serve("FSD", d0=1)
    server.serve("AD", t1=1, t2=2)
    server.serve("FAD", t1=1, t2=2)
    server.serve_batch("AS", a0=np.arange(32))
    for ls in server.latencies.values():
        ls.clear()

    # sample bindings from the loaded graph's actual id domains
    n_authors = schema.entities["Author"].size
    n_docs = schema.entities["Document"].size
    n_terms = schema.entities["Term"].size

    print(f"serving {args.requests} mixed requests…")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        kind = ["AS", "SD", "FSD", "AD", "FAD"][i % 5]
        if kind == "AS":
            server.serve("AS", a0=int(rng.integers(0, n_authors)))
        elif kind in ("SD", "FSD"):
            server.serve(kind, d0=int(rng.integers(0, n_docs)))
        else:
            server.serve(kind, t1=int(rng.integers(0, n_terms)),
                         t2=int(rng.integers(0, n_terms)))

    # batched dashboard refresh: 32 author panels in one call — every hop
    # streams its edges once for the whole batch (the SpMM kernels)
    server.serve_batch("AS", a0=rng.integers(0, n_authors, size=32))
    server.report()
    bt = server.latencies["AS"][-1]
    print(f"\nbatched AS ×32: {bt*1e3:.1f} ms total = {bt/32*1e3:.2f} ms/query "
          f"(amortized, batched frontier SpMM)")


if __name__ == "__main__":
    main()
