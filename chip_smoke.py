#!/usr/bin/env python3
"""Drive the PyTorch port of GQ-Fast on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure exits non-zero; nothing is caught while the run goes on):

 1. Card, power limit, torch/CUDA versions; build the CUDA kernel from
    ``src/repro_torch/kernels/csrc`` with nvcc and report the build time.
 2. Load a PubMed-shaped graph (4M documents, 27,000 terms, 2M authors) on the
    card with dense device encodings, and a SemMedDB-shaped graph at 10× the
    generator's defaults.
 3. The kernel against its plain PyTorch version on the card, for every op, at
    E ∈ {0, 1, 4097} and at the main path's hop shapes (I_DT.Term with its
    measure, I_DA.Doc measure-free). sum within rtol=atol=1e-4, min/max/bool
    equal.
 4. The main path: the paper's seven queries through ``GQFastEngine.query`` /
    ``query_topk``. The kernel's launch counter is set to 0 just before and
    read just after; it must equal the number of HopOps executed. Each result
    is compared with the same lowered plan run through the plain version on
    the card, SD with the numpy oracle ``run_sql`` at full scale, and all
    seven with ``run_sql`` at the quickstart scale.
 5. Times: per query the median wall time of 20 runs (each ends with the copy
    of the result to the host) and, from torch.profiler, the device's busy
    time by kind and its idle share; per hop shape the kernel's CUDA-event time
    beside its bytes bound, the plain version's time and one library call
    computing the same function (a cuSPARSE CSR matrix-vector product through
    ``torch.mv`` on a prebuilt matrix, for sum) — the port never calls it.

Output: progress lines, then the card line, the ``{"kernels": [...]}`` line and
last ``{"ok": true, "device": {...}}``. Everything measured is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Full-scale configuration (see PERF.md "Cells")
PUBMED = dict(n_docs=4_000_000, n_terms=27_000, n_authors=2_000_000, seed=0)
SEMMED = dict(n_concepts=40_000, n_csemtypes=50_000, n_predications=80_000,
              n_sentences=300_000)
QUICKSTART_PUBMED = dict(n_docs=20_000, n_terms=800, n_authors=5_000, seed=7)
QUERY_REPS = 20
KERNEL_REPS = 20
PROFILE_REPS = 5

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

OPS = ("sum", "min", "max", "bool")
EXACT_QUERIES = ("SD", "AD", "RECENT", "CS")  # counts and memberships


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def time_device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(E: int, n_src: int, n_dst: int, has_m: bool) -> tuple[float, str]:
    """Least time for one hop: each input read once (src, dst, m per edge, the
    frontier), the output written once, against the card's memory rate; and
    the per-edge multiply plus combine against the fp32 rate."""
    nbytes = (12 if has_m else 8) * E + 4 * n_src + 4 * n_dst
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * E / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, exact: bool, what: str) -> float:
    """Fail unless ``got`` matches ``want``; returns the max abs error over
    the finite entries."""
    import torch

    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if exact:
        if not torch.equal(got, want):
            n = int((got != want).sum())
            raise AssertionError(f"{what}: {n} entries differ (exact comparison)")
    elif not torch.allclose(got, want, rtol=1e-4, atol=1e-4, equal_nan=False):
        diff = (got.double() - want.double()).abs()
        raise AssertionError(f"{what}: max abs err {float(diff.max())} beyond rtol=atol=1e-4")
    fin = torch.isfinite(got) & torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{what}: non-finite entries differ")
    return float((got[fin].double() - want[fin].double()).abs().max()) if fin.any() else 0.0


def frontier(n: int, op: str, gen, device):
    """A dense random frontier for ``op``: values in (0, 2], 0/1 for bool, and
    for min/max a fifth of the entries at the ⊕-identity."""
    import torch

    w = torch.rand(n, generator=gen, device=device) * 2 + 1e-3
    if op == "bool":
        w = (w > 1).to(torch.float32)
    elif op in ("min", "max"):
        w[torch.rand(n, generator=gen, device=device) < 0.2] = (
            float("inf") if op == "min" else float("-inf")
        )
    return w


def check_kernel(db, device) -> tuple[float, list[dict]]:
    """Phase 3: kernel vs plain version at small and main-path shapes."""
    import torch

    from repro_torch.kernels import fragment_spmv as kernel
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for E in (0, 1, 4097):
        n_src, n_dst = 5000, 300
        src = torch.sort(torch.randint(0, n_src, (E,), generator=gen, device=device)).values
        dst = torch.randint(0, n_dst, (E,), generator=gen, device=device)
        m = torch.rand(E, generator=gen, device=device)
        cases.append((f"E={E}", n_src, src.to(torch.int32), dst.to(torch.int32), m, n_dst))
    dt = db.device.index("DT", "Term")
    da = db.device.index("DA", "Doc")
    cases.append(("I_DT.Term", dt.indptr.shape[0] - 1, dt.src_ids, dt.dst_ids,
                  dt.measures["Fre"], db.schema.domain_size("Document")))
    cases.append(("I_DA.Doc", da.indptr.shape[0] - 1, da.src_ids, da.dst_ids,
                  None, db.schema.domain_size("Author")))
    worst, rows = 0.0, []
    for name, n_src, src, dst, m, n_dst in cases:
        for op in OPS:
            w = frontier(n_src, op, gen, device)
            got = kernel.fragment_spmv(w, src, dst, m, n_dst, op=op)
            want = ref.fragment_spmv_ref(w, src, dst, m, n_dst, op=op)
            sync()
            err = compare(got, want, exact=op != "sum", what=f"kernel {name} {op}")
            worst = max(worst, err)
            rows.append({"shape": name, "op": op, "E": int(src.shape[0]),
                         "max_abs_err": err})
            log(f"  kernel {name:10s} E={int(src.shape[0]):>9d} {op:4s} ok"
                f" (max abs err {err:.3g})")
    return worst, rows


def hop_count(phys) -> int:
    """HopOps one execution of ``phys`` runs, mask sub-programs included;
    AVG walks the plan twice."""
    from repro_torch.core.lower import HopOp, SeedOp

    n = 0
    for op in phys.ops:
        if isinstance(op, HopOp):
            n += 1
        elif isinstance(op, SeedOp):
            n += sum(hop_count(p) for p in op.programs)
    return 2 * n if phys.agg == "avg" else n


def cases(SG, c0: int):
    """The seven queries and their parameters; ``c0`` is a concept of the
    SemMedDB graph at hand (see :func:`busy_concept`)."""
    return [
        ("SD", SG.QUERY_SD, {"d0": 5}),
        ("FSD", SG.QUERY_FSD, {"d0": 5}),
        ("AS", SG.QUERY_AS, {"a0": 7}),
        ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
        ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
        ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
        ("CS", SG.QUERY_CS, {"c0": c0}),
    ]


def busy_concept(sem) -> int:
    """The concept owning ConceptSemtype 0, the most-linked semtype under the
    generator's Zipf draw, so CS has a non-empty answer at any scale."""
    return int(sem.relationships["CS"].columns["CID"][0])


def drive_main_path(engines, SG, c0) -> tuple[dict, int, int]:
    """Phase 4a: the seven queries through the engine's entry points, with
    the launch counter set to 0 just before and read just after."""
    from repro_torch.kernels import fragment_spmv as kernel

    prepared = {n: engines[n].prepare(q) for n, q, _ in cases(SG, c0)}
    expected = sum(hop_count(prepared[n].phys) for n, _, _ in cases(SG, c0))
    expected += hop_count(prepared["AS"].phys)  # query_topk runs AS once more
    results = {}
    kernel.LAUNCHES = 0
    for name, q, params in cases(SG, c0):
        results[name] = engines[name].query(q, **params)
    top = engines["AS"].query_topk(SG.QUERY_AS, k=10, a0=7)
    launches = kernel.LAUNCHES
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != HopOps executed {expected}")
    # atomics reorder the float sums from run to run: same ids, values within
    # the sum tolerance
    want = engines["AS"]._topk(results["AS"], 10)
    if not top or [i for i, _ in top] != [i for i, _ in want]:
        raise AssertionError(f"query_topk ids {top} != query's {want}")
    compare(np.asarray([v for _, v in top]), np.asarray([v for _, v in want]), False,
            "query_topk scores")
    return results, launches, expected


def check_results(results, engines, schemas, SG, c0, run_sql) -> dict:
    """Phase 4b: each result against the plain version on the card (same
    lowered plan), finite and of the domain's shape; SD against the oracle."""
    from repro_torch.core import executor as X

    errs = {}
    for name, q, params in cases(SG, c0):
        got = results[name]
        pq = engines[name].prepare(q)
        if got.shape != (pq.phys.out_dom,) or not np.isfinite(got).all():
            raise AssertionError(f"{name}: shape {got.shape} or non-finite values")
        if not (got != 0).any():
            raise AssertionError(f"{name}: empty result")
        plain = X.compile_frontier(engines[name].db.device, pq.phys, use_kernel=False)
        want = plain(*[params[n] for n in pq.param_names]).cpu().numpy()
        errs[name] = compare(got, want, name in EXACT_QUERIES, f"{name} vs plain")
        log(f"  {name:6s} nnz={int((got != 0).sum()):>9d} matches the plain version"
            f" (max abs err {errs[name]:.3g})")
    t0 = time.perf_counter()
    ref = run_sql(schemas["SD"], SG.QUERY_SD, {"d0": 5})
    compare(results["SD"], ref.astype(np.float32), True, "SD vs run_sql (full scale)")
    log(f"  SD matches run_sql at full scale ({time.perf_counter() - t0:.1f} s oracle)")
    return errs


def check_quickstart(SG, run_sql, GQFastDatabase, GQFastEngine, device) -> None:
    """Phase 4c: all seven queries against run_sql at the quickstart scale."""
    pub = SG.make_pubmed(**QUICKSTART_PUBMED)
    sem = SG.make_semmeddb()  # the generator's defaults
    c0 = busy_concept(sem)
    eng_p = GQFastEngine(GQFastDatabase(pub, account_space=False, device=device))
    eng_s = GQFastEngine(GQFastDatabase(sem, account_space=False, device=device))
    for name, q, params in cases(SG, c0):
        schema, eng = (sem, eng_s) if name == "CS" else (pub, eng_p)
        got = eng.query(q, **params)
        ref = run_sql(schema, q, params)
        err = compare(got, ref.astype(np.float32), name in EXACT_QUERIES,
                      f"{name} vs run_sql (quickstart)")
        if not (got != 0).any():
            raise AssertionError(f"{name}: empty result at quickstart scale")
        log(f"  {name:6s} matches run_sql at quickstart scale (max abs err {err:.3g})")


def time_queries(engines, SG, c0) -> dict:
    """Phase 5a: median wall ms of QUERY_REPS executions per query."""
    out = {}
    for name, q, params in cases(SG, c0):
        pq = engines[name].prepare(q)
        pq(**params)
        ts = []
        for _ in range(QUERY_REPS):
            t0 = time.perf_counter()
            pq(**params)  # returns host numpy: waits for the device
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"median_ms": statistics.median(ts), "min_ms": min(ts),
                     "max_ms": max(ts), "hops": hop_count(pq.phys)}
        log(f"  {name:6s} median {out[name]['median_ms']:.3f} ms over {QUERY_REPS}"
            f" runs (min {out[name]['min_ms']:.3f}, hops {out[name]['hops']})")
    return out


def breakdown(engines, SG, c0) -> dict:
    """Phase 5b: where a query's time goes. torch.profiler over PROFILE_REPS
    runs gives the device's busy time per run, split into the fragment_spmv
    kernel, copies (the result to the host) and everything else (fills,
    seeds, masks); the idle share is 1 − busy / the wall time of the same
    profiled runs (profiling slows them, so both sides carry its cost).
    ``None`` where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, q, params in cases(SG, c0):
        pq = engines[name].prepare(q)
        pq(**params)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_REPS):
                pq(**params)  # returns host numpy: waits for the device
            wall = (time.perf_counter() - t0) * 1e3 / PROFILE_REPS
        split = {"fragment_spmv": 0.0, "copy": 0.0, "other": 0.0}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            kind = ("fragment_spmv" if "fragment_spmv" in ev.key
                    else "copy" if "Memcpy" in ev.key else "other")
            split[kind] += ev.self_device_time_total / 1e3 / PROFILE_REPS
        busy = sum(split.values())
        if busy == 0.0:
            out[name] = None
            log(f"  {name:6s} device time not measured (profiler saw no device events)")
            continue
        out[name] = {"busy_ms": busy, **{f"{k}_ms": v for k, v in split.items()},
                     "profiled_wall_ms": wall, "idle_share": max(0.0, 1.0 - busy / wall)}
        log(f"  {name:6s} device busy {busy:.3f} ms of {wall:.3f} ms profiled wall"
            f" (fragment_spmv {split['fragment_spmv']:.3f}, copy {split['copy']:.3f},"
            f" other {split['other']:.3f}; idle share {out[name]['idle_share']:.3f})")
    return out


def time_kernel(db, device) -> list[dict]:
    """Phase 5c: kernel vs bound vs plain vs library at the main path's hop
    shapes, sum over a dense random frontier (every edge live)."""
    import torch

    from repro_torch.kernels import fragment_spmv as kernel
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for name, (table, key), meas, dst_ent in (
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
    ):
        di = db.device.index(table, key)
        n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size(dst_ent)
        src, dst = di.src_ids, di.dst_ids
        m = di.measures[meas] if meas else None
        E = int(src.shape[0])
        w = frontier(n_src, "sum", gen, device)
        ms = time_device_ms(lambda: kernel.fragment_spmv(w, src, dst, m, n_dst), KERNEL_REPS)
        plain_ms = time_device_ms(lambda: ref.fragment_spmv_ref(w, src, dst, m, n_dst), KERNEL_REPS)
        vals = m if m is not None else torch.ones(E, device=device)
        A = torch.sparse_coo_tensor(
            torch.stack([dst.to(torch.int64), src.to(torch.int64)]), vals, (n_dst, n_src),
            check_invariants=False,
        ).coalesce().to_sparse_csr()
        lib = torch.mv(A, w)
        compare(kernel.fragment_spmv(w, src, dst, m, n_dst), lib, False,
                f"library yardstick {name}")
        library_ms = time_device_ms(lambda: torch.mv(A, w), KERNEL_REPS)
        del A, lib
        b_ms, b_by = bound(E, n_src, n_dst, m is not None)
        rows.append({"shape": name, "op": "sum", "E": E, "n_src": n_src, "n_dst": n_dst,
                     "measure": meas is not None, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
        log(f"  {name:10s} E={E} kernel {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
            f"  plain {plain_ms:.4f} ms  torch.mv(CSR) {library_ms:.4f} ms")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a"
              " checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
    run(torch.device("cuda"))
    return 0


def run(device) -> None:
    """All phases on ``device``; raises on the first failure."""
    import torch

    from repro_torch.core.engine import GQFastDatabase, GQFastEngine
    from repro_torch.core.reference import run_sql
    from repro_torch.data import synth_graph as SG
    from repro_torch.kernels import fragment_spmv as kernel

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # phase 1: build
    t0 = time.perf_counter()
    kernel.build()
    log(f"[1] built fragment_spmv in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {kernel.BUILD_SECONDS if kernel.BUILD_SECONDS is not None else 'cached'})")
    for line in (kernel.BUILD_LOG or "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    # phase 2: data
    t0 = time.perf_counter()
    pub = SG.make_pubmed(**PUBMED)
    sem = SG.make_semmeddb(**SEMMED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = GQFastDatabase(pub, account_space=False, keep_packed=False, device=device)
    db_sem = GQFastDatabase(sem, account_space=False, keep_packed=False, device=device)
    sync()
    t_load = time.perf_counter() - t0
    dev_bytes = sum(
        t.numel() * t.element_size()
        for d in (db.device, db_sem.device)
        for di in d.indexes.values()
        for t in (di.indptr, di.src_ids, di.dst_ids, di.degrees, *di.measures.values())
    )
    log(f"[2] PubMed DT={pub.relationships['DT'].num_rows} DA={pub.relationships['DA'].num_rows}"
        f" rows, SemMedDB SP={sem.relationships['SP'].num_rows}; generated in {t_gen:.1f} s,"
        f" indexed and loaded in {t_load:.1f} s; {dev_bytes / 1e9:.3f} GB of index tensors")

    # phase 3: kernel vs plain on the card
    log("[3] kernel against its plain version")
    worst_err, checks = check_kernel(db, device)

    # phase 4: the main path
    c0 = busy_concept(sem)
    eng_pub, eng_sem = GQFastEngine(db), GQFastEngine(db_sem)
    engines = {n: (eng_sem if n == "CS" else eng_pub) for n, _, _ in cases(SG, c0)}
    log("[4] main path: seven queries through GQFastEngine.query / query_topk")
    results, launches, expected = drive_main_path(engines, SG, c0)
    log(f"  fragment_spmv launches on the main path: {launches} (HopOps executed {expected})")
    schemas = {n: (sem if n == "CS" else pub) for n, _, _ in cases(SG, c0)}
    errs = check_results(results, engines, schemas, SG, c0, run_sql)
    check_quickstart(SG, run_sql, GQFastDatabase, GQFastEngine, device)

    # phase 5: times
    log("[5] times")
    qtimes = time_queries(engines, SG, c0)
    split = breakdown(engines, SG, c0)
    ktimes = time_kernel(db, device)
    state = card_state()
    log(f"  card state after timing (clocks.sm, power.draw, power.limit, temp): {state}")

    primary = ktimes[0]
    entry = {
        "name": "fragment_spmv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fragment_spmv.cu",
        "replaces": "src/repro/kernels/fragment_spmv.py:103",
        "launches": launches, "max_abs_err": worst_err,
        "ms": primary["ms"], "plain_ms": primary["plain_ms"],
        "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"],
        "library_ms": primary["library_ms"],
        "library_call": "torch.mv on a prebuilt sparse CSR matrix (cuSPARSE SpMV), sum only",
        "timed_shape": f"{primary['shape']} sum, E={primary['E']}",
        "check": "ok", "per_shape": ktimes,
    }
    record = {
        "card": card, "card_state": state, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_seconds": kernel.BUILD_SECONDS,
        "config": {"pubmed": PUBMED, "semmed": SEMMED,
                   "dt_rows": int(pub.relationships["DT"].num_rows),
                   "da_rows": int(pub.relationships["DA"].num_rows),
                   "index_tensor_bytes": dev_bytes},
        "setup_seconds": {"generate": t_gen, "index_and_load": t_load},
        "kernel_checks": checks, "main_path": {"launches": launches, "hop_ops": expected},
        "query_max_abs_err_vs_plain": errs, "queries": qtimes,
        "query_device_breakdown": split, "kernels": [entry],
        "total_seconds": time.perf_counter() - t_start,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=2))
    log(f"done in {record['total_seconds']:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
