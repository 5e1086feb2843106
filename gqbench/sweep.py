"""A sweep of a closed-loop cell's clients on one set-up: the knee that sets
the ``clients`` of the cell's traffic mix.

    python3 gqbench/sweep.py --workload <cell> --seed <n> --seconds 6 \\
        --clients 1,2,4,8,16,32,64,128 --passes 2

One set-up, warmed up to the mix's ``max_batch``, then one window at each
count of clients, ascending, then descending on the second pass, so that a
host that drifts shows as two readings of one count that differ. One JSON
line a window (clients, qps, p95_ms, requests a batch), then the knee. A
count's rate is the lower of its passes; the knee is the fewest clients
whose rate reaches four fifths of the highest rate. Past the knee more
clients mostly lengthen the queue.
The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".gqbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".gqbench_cache" / "torch_extensions")
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: The knee's share of the highest qps.
KNEE_SHARE = 0.8


def knee(readings: dict) -> int:
    """The fewest clients whose lowest qps reaches ``KNEE_SHARE`` of the
    highest such qps; ``readings`` maps clients to their qps readings."""
    top = max(min(v) for v in readings.values())
    return min(c for c, v in readings.items() if min(v) >= KNEE_SHARE * top)


def sweep(cell, seed: int, seconds: float, clients: list, passes: int, device: str,
          t_start: float, err=sys.stderr, out=sys.stdout) -> int:
    import torch

    from gqbench import harness

    dev = torch.device(device)

    def log(msg):
        print(f"[gqbench {time.time() - t_start:8.2f}s] {msg}", file=err, flush=True)

    tr = cell.traffic
    max_batch = int(tr["max_batch"])
    su = harness.set_up(cell, seed, dev, t_start, log, top=max_batch)
    p95 = harness.load_module(harness.HERE / "metrics" / "p95_ms.py", "gqbench.metrics.p95_ms")
    readings: dict = {}
    for k in range(passes):
        for c in (clients if k % 2 == 0 else clients[::-1]):
            ctx = harness.Ctx(dev)
            harness.window(su, ctx, seed, c, max_batch, seconds, False, 0)
            qps = ctx.answered / ctx.window_s
            readings.setdefault(c, []).append(qps)
            print(json.dumps({"workload": cell.name, "pass": k, "clients": c, "qps": qps,
                              "p95_ms": p95.read(ctx), "per_batch": ctx.answered / len(ctx.batch_log),
                              "failed": ctx.failed, "degraded": ctx.degraded}), file=out, flush=True)
    k_clients = knee(readings)
    print(json.dumps({"workload": cell.name, "knee_clients": k_clients, "knee_share": KNEE_SHARE,
                      "setup_s": su.ctx.setup_s}), file=out, flush=True)
    return k_clients


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--clients", default="1,2,4,8,16,32,64,128")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    from gqbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(bench, a.workload, False)
    sweep(cell, a.seed, a.seconds, [int(c) for c in a.clients.split(",")], a.passes, a.device,
          T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
