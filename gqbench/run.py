"""The benchmark of ``repro_torch`` on one cell.

    python3 gqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints progress on standard error, the
numbers compared beside their limits as its last lines there, and the result
as one JSON object on the last line of standard output. Exits nonzero, with
no result, where the cell's cards are missing or where JAX or the JAX
package is loaded after the window.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's own caches, at fixed paths; nothing of the port's JAX side.
os.environ["USE_FLAX"] = "0"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".gqbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".gqbench_cache" / "torch_extensions")
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from gqbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(bench, a.workload, bool(a.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gqbench: {a.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda:0", T_START)
    found = harness.banned_modules()
    if found:
        print(f"gqbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
