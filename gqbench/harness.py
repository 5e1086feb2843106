"""One run of one cell: set-up, the measured window, the check, the result.

Everything of a cell is found by name from ``BENCHMARK.json``: the
configuration's manifest (``configs/<config>.json``, the file the entry
names) and generator (``configs/<config>.py``), the traffic mix
(``traffic/<traffic>.json``), each shape's frozen SQL (``queries/<Q>.sql``)
and plain semantics (``reference/<Q>.py``), and each metric's reader
(``metrics/<name>.py``, whose ``read(ctx)`` returns a number or None when
it finds nothing to read).

Set-up: the graph is drawn on the device from the seed, handed as numpy
columns to the program's ``Schema`` and ``GQFastDatabase`` (defaults), the
shapes are prepared (``GQFastEngine.prepare``, defaults), and one batch of
every bucket size the loop can reach is answered. The window then drives
``repro_torch.robust.run_batch_with_policy`` in the closed loop of
``loop.py``. After it, the program's state is freed and a sample of the
answered requests, drawn from the seed, is worked out again by the
reference and compared (``compare.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from gqbench import compare, devtrace, gen, loop
from gqbench import reference as R
from gqbench.reference.graph import Graph

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that no run may hold: JAX and the JAX package.
BANNED = ("jax", "jaxlib", "flax", "repro")
#: Batches of the traced window whose hops are counted for ``hop_roofline``.
COUNTED_BATCHES = 16


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclass
class Cell:
    name: str
    chips: int
    manifest: dict
    generator: object
    traffic: dict
    sql: dict
    metrics: list  # (entry, reader module)

    @classmethod
    def find(cls, bench: dict, name: str, trace: bool, root: Path = ROOT) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
        w = cells[name]
        cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
        manifest = json.loads((root / cfg["file"]).read_text())
        generator = load_module(HERE / "configs" / f"{w['config']}.py",
                                f"gqbench.configs.{w['config']}")
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        if traffic.get("loop") != "closed":
            raise SystemExit(f"traffic {w['traffic']!r}: only the closed loop is built")
        sql = {s["query"]: (HERE / "queries" / f"{s['query']}.sql").read_text()
               for s in traffic["shapes"]}
        kind = "per_layer" if trace else "end_to_end"
        metrics = [
            (m, load_module(HERE / "metrics" / f"{m['name']}.py", f"gqbench.metrics.{m['name']}"))
            for m in bench[kind] if name in m.get("workloads", [name])
        ]
        return cls(name, int(w["chips"]), manifest, generator, traffic, sql, metrics)


@dataclass
class Ctx:
    """What the metric readers read."""
    device: torch.device
    phases: dict = field(default_factory=dict)
    setup_s: float = 0.0
    store_bytes: int = 0
    user_bytes: int = 0
    latencies_ms: list = field(default_factory=list)
    answered: int = 0
    failed: int = 0
    degraded: int = 0
    window_s: float = 0.0
    batch_log: list = field(default_factory=list)  # (shape, ordinals) of each batch
    stream: loop.Stream | None = None
    trace: devtrace.Trace | None = None
    graph: Graph | None = None
    counted_batches: list = field(default_factory=list)
    peaks: dict | None = None
    device_kind: str = ""


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Setup:
    """What set-up leaves for the window: the call the window drives, which
    holds the program's prepared shapes and database."""
    ctx: Ctx
    host: dict
    traffic: dict
    answer: object  # answer(shape, params) -> one outcome a request
    shapes: list
    log: object


def set_up(cell: Cell, seed: int, dev: torch.device, t_start: float, log, top: int) -> Setup:
    """Kernels, graph, database, prepares, and one warm-up batch of every
    bucket size up to ``top`` requests."""
    from repro_torch.core.engine import GQFastDatabase, GQFastEngine, batch_bucket
    from repro_torch.core.schema import EntityTable, RelationshipTable, Schema
    from repro_torch.robust import runner
    from repro_torch.robust.runner import RetryPolicy, RobustPolicy

    ctx = Ctx(dev)
    ph = ctx.phases
    ph["start_s"] = time.time() - t_start

    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_build

        cuda_build.build_all()
    ph["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    graph = cell.generator.generate(cell.manifest, seed, dev)
    sync(dev)
    host = gen.to_host(graph)
    del graph
    ph["gen_s"] = time.perf_counter() - t
    ctx.user_bytes = gen.user_bytes(host)
    log(f"graph drawn in {ph['gen_s']:.2f}s: " + ", ".join(
        f"{k} {len(next(iter(r['columns'].values())))} rows"
        for k, r in host["relationships"].items()))

    schema = Schema(
        entities={k: EntityTable(k, e["size"], dict(e["attributes"]))
                  for k, e in host["entities"].items()},
        relationships={k: RelationshipTable(k, r["fk1"], r["fk2"], r["entity1"], r["entity2"],
                                            dict(r["columns"]))
                       for k, r in host["relationships"].items()},
    )
    gc.collect()
    mem0 = 0
    if dev.type == "cuda":
        # the peak is the program's: its build, prepares, warm-up and window
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    db = GQFastDatabase(schema, device=dev)
    sync(dev)
    ph["build_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        ctx.store_bytes = torch.cuda.memory_allocated(dev) - mem0
    log(f"database built in {ph['build_s']:.2f}s, {ctx.store_bytes} B on the device")

    t = time.perf_counter()
    engine = GQFastEngine(db)
    prepared = {q: engine.prepare(s) for q, s in cell.sql.items()}
    sync(dev)
    ph["prepare_s"] = time.perf_counter() - t

    policy = RobustPolicy(retry=RetryPolicy(max_attempts=2, base_ms=2.0))

    def answer(shape, params):
        return runner.run_batch_with_policy(prepared[shape], params, policy=policy)

    t = time.perf_counter()
    warm = loop.Stream(cell.traffic, host, seed, stream=1)
    buckets = sorted({batch_bucket(b) for b in range(1, top + 1)})
    for q in prepared:
        for b in buckets:
            answer(q, warm.arrays(warm.batch_of(q, min(b, top))))
    sync(dev)
    ph["warm_s"] = time.perf_counter() - t
    ctx.setup_s = time.time() - t_start
    log("set-up " + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()) + f"; setup_s {ctx.setup_s:.3f}")
    return Setup(ctx, host, cell.traffic, answer, list(prepared), log)


def window(su: Setup, ctx: Ctx, seed: int, clients: int, max_batch: int, seconds: float,
           trace: bool, per_shape: int) -> dict:
    """One measured window of the closed loop into ``ctx``; returns the
    compared sample, ``(ordinal, row)`` pairs of each shape drawn uniformly
    from the seed over the window's answers."""
    dev = ctx.device
    rng = np.random.default_rng([int(seed), 2])
    kept: dict = {q: [] for q in su.shapes}
    seen: dict = {q: 0 for q in su.shapes}
    requests = ctx.stream = loop.Stream(su.traffic, su.host, seed, stream=0)
    lat_parts = []

    def on_batch(shape, batch, outcomes, t_done):
        ctx.batch_log.append((shape, batch))
        lat_parts.append(t_done - np.asarray([requests.issued[i] for i in batch]))
        ok = [(i, oc) for i, oc in zip(batch, outcomes) if oc.status != "error"]
        ctx.failed += len(batch) - len(ok)
        ctx.answered += len(ok)
        ctx.degraded += sum(oc.status == "degraded" for _, oc in ok)
        # a uniform sample of each shape's answers, kept as they come
        res, n0 = kept[shape], seen[shape]
        seen[shape] += len(ok)
        slot = np.arange(n0, n0 + len(ok))
        late = slot >= per_shape
        slot[late] = rng.integers(0, slot[late] + 1)
        for (i, oc), j in zip(ok, slot):
            if j < per_shape:
                row = (i, np.array(oc.value))
                if j < len(res):
                    res[j] = row
                else:
                    res.append(row)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function("gq.window"):
            t0, t1, n_batches = loop.closed_loop(su.answer, requests, clients, max_batch,
                                                 seconds, on_batch, sync=lambda: sync(dev))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    ctx.window_s = t1 - t0
    ctx.latencies_ms = (np.concatenate(lat_parts) * 1e3).tolist() if lat_parts else []
    su.log(f"window {ctx.window_s:.3f}s at {clients} clients: {n_batches} batches, "
           f"{ctx.answered} answered, {ctx.failed} failed, {ctx.degraded} degraded")
    if prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="gqbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            ctx.trace = devtrace.read(path)
        finally:
            os.unlink(path)
        del prof
        n = len(ctx.trace.batches)
        pick = np.random.default_rng([int(seed), 3]).choice(n, size=min(COUNTED_BATCHES, n),
                                                             replace=False)
        ctx.counted_batches = sorted(int(i) for i in pick)
    return kept


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, err=sys.stderr) -> dict:
    """One run; returns the result object (the last line's)."""
    dev = torch.device(device)

    def log(msg):
        print(f"[gqbench {time.time() - t_start:8.2f}s] {msg}", file=err, flush=True)

    tr = cell.traffic
    clients, max_batch = int(tr["clients"]), int(tr["max_batch"])
    # a batch never holds more requests than there are clients
    su = set_up(cell, seed, dev, t_start, log, top=min(max_batch, clients))
    ctx = su.ctx
    kept = window(su, ctx, seed, clients, max_batch, seconds, trace,
                  int(tr["compared_per_shape"]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    requests, host = ctx.stream, su.host
    del su
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ctx.graph = Graph(host, dev)
    worst, compared = 0.0, 0
    for q, rows in kept.items():
        if not rows:
            continue
        params = requests.arrays([i for i, _ in rows])
        ref = R.query(q).run(ctx.graph, params, torch.float64)
        worst = max(worst, compare.max_rel_err([v for _, v in rows], ref))
        compared += len(rows)
        del ref
    ref_s = time.perf_counter() - t
    log(f"reference: {compared} rows compared in {ref_s:.2f}s")

    peaks = json.loads((HERE / "peaks.json").read_text())
    ctx.device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx.peaks = peaks.get(ctx.device_kind)
    metrics = {}
    for m, reader in cell.metrics:
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    limit = float(cell.manifest["check"]["max_rel_err"])
    checks = {
        "max_rel_err": {"value": worst, "limit": limit},
        "failed": {"value": ctx.failed, "limit": 0},
        # answered by a retry or a lower rung of the policy's ladder, not the main path
        "degraded": {"value": ctx.degraded, "limit": 0},
        "compared": {"value": compared, "limit": 1},
    }
    correct = worst <= limit and ctx.failed == 0 and ctx.degraded == 0 and compared >= 1
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": ctx.device_kind,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": bool(correct),
        "attempted": ctx.answered + ctx.failed,
        "failed": ctx.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = checks
    print(f"check max_rel_err {worst!r} <= {limit!r}", file=err)
    print(f"check failed {ctx.failed} <= 0", file=err)
    print(f"check degraded {ctx.degraded} <= 0", file=err)
    print(f"check compared {compared} >= 1", file=err, flush=True)
    return result
