"""The control of the comparison that decides ``correct``: the reference put
in the program's place and computed in bfloat16, the precision below the
float32 that the configurations state, read by the same number against the
float64 reference. It has to read above the limit.

    python3 gqbench/control.py --workload <cell> --seeds 11,12,13

For each seed the cell's graph is drawn at its own size and as many
requests of each shape as a run compares are drawn from the cell's stream;
one JSON line a seed. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def read_control(cell, seed: int, device, dtype=None) -> dict:
    """The control's number on ``seed``, with the float64 reference's own
    (0 by construction) as a sanity line."""
    import numpy as np
    import torch

    from gqbench import compare, gen, loop
    from gqbench import reference as R
    from gqbench.reference.graph import Graph

    dtype = dtype or torch.bfloat16
    dev = torch.device(device)
    host = gen.to_host(cell.generator.generate(cell.manifest, seed, dev))
    g = Graph(host, dev)
    stream = loop.Stream(cell.traffic, host, seed, stream=0)
    n = int(cell.traffic["compared_per_shape"])
    out = {"seed": seed, "by_shape": {}}
    for q in cell.sql:
        params = stream.arrays(stream.batch_of(q, n))
        ref = R.query(q).run(g, params, torch.float64)
        low = R.query(q).run(g, params, dtype)
        rows = [np.asarray(r.to(torch.float32).cpu()) for r in low]
        out["by_shape"][q] = compare.max_rel_err(rows, ref)
    out["control_max_rel_err"] = max(out["by_shape"].values())
    out["limit"] = float(cell.manifest["check"]["max_rel_err"])
    out["fails"] = out["control_max_rel_err"] > out["limit"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    from gqbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(bench, a.workload, False)
    for s in a.seeds.split(","):
        t = time.time()
        out = read_control(cell, int(s), a.device)
        out["seconds"] = time.time() - t
        out["workload"] = a.workload
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
