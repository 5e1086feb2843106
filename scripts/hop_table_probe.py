#!/usr/bin/env python3
"""Size and place the packed hop's per-CTA aggregation table on one NVIDIA GPU.

    python3 scripts/hop_table_probe.py          # from the repository root, on a card
    python3 scripts/hop_table_probe.py 4 5      # only the parts named

Prints the card's name and power limit first and writes
``hop_table_probe.json`` into the output directory ``chip_smoke.py`` writes
to. Five parts, each timed with CUDA events (sum over the frontier given;
the kernels alone, block lists built beforehand):

1. Table shape. At the full PubMed scale of ``chip_smoke.py``, over a dense
   random frontier, on I_DA.Doc (Zipf-hot authors) and I_DT.Term
   (destinations spread over 4M documents): the dense ``fragment_spmv`` /
   ``fragment_spmv_active`` (one atomic an edge), the packed pair without the
   table, and the packed pair built (``csrc/hop.cuh``'s ``-DHOP_TABLE_BITS`` /
   ``-DHOP_TABLE_PROBES``) at 1,024, 2,048 and 4,096 slots × probe limits 1,
   2, 4, 8 and 16, then the dense kernels again. For each shape the
   co-resident CTAs per SM (the occupancy the table's shared memory allows)
   and the capture: the share of writing edges combined in shared memory,
   and the global atomics issued (overflow edges + flushed slots), counted by
   builds instrumented with counters (never timed). Beside each time the
   float32 sums against float64: the relative error on the hottest
   destination and the largest over all destinations.
2. The hot-share threshold. Synthetic indexes of I_DA.Doc's size (E =
   11,779,672 edges from 4M sources in CSR order, 2M destinations, 21-bit
   packed dst): a share h of the edges, spread over the index, go to one
   destination and the rest uniformly to all, for h from 0 to 0.08. The
   packed scan and active kernels with the table and without it.
3. Sparse frontiers. The first hop of SD and FSD (one document's terms on
   I_DT.Doc, a hot index: the table is on there) with the table and without
   it, the active kernel over the hop's block list (its device time from
   ``torch.profiler``: a kernel this short is host-bound under CUDA
   events); and the queries' hop device time under the defaults with the
   threshold as built and with the table off everywhere.
4. The float sums that ``chip_smoke.py`` holds to the plain versions'
   float64 sums: for the float queries (FSD, AS, FAD, AS-recent) the relative
   difference of each main path (a dense/off, b auto/auto fusion off, c
   auto/off, d dense/auto, f the defaults, g fusion on) and of
   ``execute_batch``'s rows at B = 8 (the defaults and fusion on, the
   parameters ``chip_smoke.py`` draws), and the gate ratios
   ``max |x - y| / (1e-4 + 1e-4 |y|)`` of the comparisons it reports for
   AS and AS-recent.
5. The dense pair and the list kernel. On I_DA.Doc and I_DT.Term over a
   dense random frontier, the dense scan and active kernels with the table
   and without it, beside the packed pair with the table, each timed twice
   in turns, with the float32 sums against float64. The card's rate of
   float reductions to distinct addresses (``scripts/csrc/red_rate.cu``:
   29M reductions over a 16 MB array, with and without an L2::evict_last
   hint, and on consecutive words), the scatter's second floor beside the
   bytes bound. SD's and FSD's first hop (one document's blocks of
   I_DT.Doc) through the dense active kernel with the table and without
   (the per-edge form's one wave of CTAs), by device time, and the queries'
   hop device time under dense storage with skipping 'auto'. The list kernel against the plain build (14 calls) on
   I_DT.Term and I_DT.Doc at one seed and 100% support, single and B = 8:
   device ms and device operations from the profiler, and host ms a call
   (the enqueue, without a synchronise).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SLOTS = (1024, 2048, 4096)
PROBES = (1, 2, 4, 8, 16)
SWEEP_E = 11_779_672  # I_DA.Doc's edges
HOT_SHARES = (0.0, 0.0005, 0.001, 0.002, 0.003, 0.004, 0.005, 0.0075, 0.01, 0.015, 0.02,
              0.03, 0.05, 0.08)

# The instrumented header: three device counters (shared-memory combines,
# edges that found no slot, flushed slots) bumped beside the table's writes.
COUNT_SUBS = [
    ("namespace hop {\n", "namespace hop {\n\n__device__ unsigned long long g_probe_counts[3];\n"),
    ("      if (k == d) {\n        combine<OP>(vals + h, v);",
     "      if (k == d) {\n        atomicAdd(&g_probe_counts[0], 1ull);\n"
     "        combine<OP>(vals + h, v);"),
    ("    combine<OP>(y + d, v);  // no slot within the probe limit",
     "    atomicAdd(&g_probe_counts[1], 1ull);\n"
     "    combine<OP>(y + d, v);  // no slot within the probe limit"),
    ("    if (v != identity<OP>()) combine<OP>(t.y + k, v);",
     "    if (v != identity<OP>()) {\n      atomicAdd(&g_probe_counts[2], 1ull);\n"
     "      combine<OP>(t.y + k, v);\n    }"),
]
COUNT_FN = """
extern "C" int probe_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, hop::g_probe_counts, 3 * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[3] = {0, 0, 0};
  return (int)cudaMemcpyToSymbol(hop::g_probe_counts, zero, sizeof(zero));
}
"""
OCC_FN = """
extern "C" int probe_coresident(int active_kernel, int packed_measure, int* per_sm) {
  const size_t smem = hop::kTableBytes;
  cudaError_t err;
  if (packed_measure) {
    err = active_kernel
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
              fragment_spmv_packed_active_kernel<hop::kSum, hop::PackedDst, hop::PackedMeasure>,
              hop::kThreads, smem)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
              fragment_spmv_packed_kernel<hop::kSum, hop::PackedDst, hop::PackedMeasure>,
              hop::kThreads, smem);
  } else {
    err = active_kernel
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
              fragment_spmv_packed_active_kernel<hop::kSum, hop::PackedDst, hop::NoMeasure>,
              hop::kThreads, smem)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
              fragment_spmv_packed_kernel<hop::kSum, hop::PackedDst, hop::NoMeasure>,
              hop::kThreads, smem);
  }
  return (int)err;
}
"""


def variants():
    """Per table shape, two builds of the packed kernels with the shape's
    -D overrides: one with an occupancy query appended (timed), one with the
    counting header beside it (never timed)."""
    import ctypes

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import fragment_spmv_packed as pk

    P, I32 = ctypes.c_void_p, ctypes.c_int
    src = pk.LIB.source.read_text()
    hop = (cuda_build.CSRC / "hop.cuh").read_text()
    for old, new in COUNT_SUBS:
        if old not in hop:
            raise AssertionError(f"hop.cuh no longer holds {old!r}")
        hop = hop.replace(old, new)
    out = {}
    for name, header, extra, fns in (
        ("occupancy", None, OCC_FN, {"probe_coresident": [I32, I32, P]}),
        ("count", hop, COUNT_FN, {"probe_counts": [P]}),
    ):
        d = cuda_build.BUILD_DIR / f"probe_{name}"
        d.mkdir(parents=True, exist_ok=True)
        if header is not None:
            (d / "hop.cuh").write_text(header)  # found before -I csrc by "hop.cuh"
        source = d / f"fragment_spmv_packed_{name}.cu"
        source.write_text(src + extra)
        for slots in SLOTS:
            for probes in PROBES:
                lib = cuda_build.CudaLibrary(
                    f"fragment_spmv_packed_{name}", {**pk.LIB.functions, **fns},
                    defines=(f"HOP_TABLE_BITS={slots.bit_length() - 1}",
                             f"HOP_TABLE_PROBES={probes}"))
                lib.source = source
                out[(name, slots, probes)] = lib
    return out


def gate_ratio(a, b) -> float:
    """max |a - b| / (1e-4 + 1e-4 |b|): at most 1 passes rtol = atol = 1e-4."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))).max())


class table_threshold:
    """Within the block the engine's packed hops use ``thr`` as the hot-share
    threshold (inf: no table anywhere)."""

    def __init__(self, thr: float):
        self.thr = thr

    def __enter__(self):
        from repro_torch.kernels import params

        self.saved, params.HOP_TABLE_HOT_SHARE = params.HOP_TABLE_HOT_SHARE, self.thr

    def __exit__(self, *exc):
        from repro_torch.kernels import params

        params.HOP_TABLE_HOT_SHARE = self.saved


def table_shapes(C, db, db_dense, libs, dev, record) -> None:
    """Part 1."""
    import ctypes

    import torch

    from repro_torch.kernels import active, cuda_build
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk

    for (name, slots, probes), lib in libs.items():
        if name != "occupancy":
            continue
        row = {}
        for act in (0, 1):
            for pm in (0, 1):
                n = ctypes.c_int(0)
                cuda_build.raise_on(lib.load().probe_coresident(act, pm, ctypes.addressof(n)),
                                    "occupancy")
                row[f"{'active' if act else 'scan'}_{'packed_m' if pm else 'no_m'}"] = n.value
        record["occupancy"][f"{slots}x{probes}"] = row
        if probes == PROBES[0]:
            print(f"  table {slots:5d} slots: co-resident CTAs per SM {row}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(1)
    for name, (table, key), meas, dst_ent in (
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
    ):
        di, pi = db_dense.device.index(table, key), db.device.index(table, key)
        n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size(dst_ent)
        src, dst = di.src_ids, di.dst_ids
        m = di.measures[meas] if meas else None
        E = int(src.shape[0])
        w = C.frontier(n_src, "sum", gen, dev)
        pm = pi.measure_cols[meas] if meas else None
        mw, m_mode = (pm.words, "packed") if pm is not None else (None, "none")
        kwp = dict(dst_width=pi.dst_col.width, m_mode=m_mode,
                   m_width=pm.width if pm is not None else 0)
        dwords = pi.dst_col.words
        nb = active.n_edge_blocks(E)
        bi = torch.arange(nb, dtype=torch.int32, device=dev)
        na = torch.full((1,), nb, dtype=torch.int32, device=dev)
        prod = w.double()[src.long()] * (m.double() if m is not None else 1.0)
        truth = torch.zeros(n_dst, dtype=torch.float64, device=dev).index_add_(
            0, dst.long(), prod)
        hot = int(torch.argmax(truth))
        deg = torch.bincount(dst.long(), minlength=n_dst)
        hop = {"E": E, "n_dst": n_dst, "hottest": hot, "hottest_degree": int(deg[hot]),
               "max_degree_over_E": float(deg.max()) / E, "hot_share": pi.hot_share,
               "configs": []}
        print(f"{name}: E={E}, hottest destination {hot} takes {int(deg[hot])} edges,"
              f" hot share {pi.hot_share:.5f}", flush=True)

        def errs(y):
            rel = (y.double() - truth).abs() / truth.abs().clamp_min(1e-30)
            rel[truth == 0] = 0
            return float(rel[hot]), float(rel.max())

        configs = ([("dense", None), ("packed", None)]
                   + [("packed", (s, p)) for s in SLOTS for p in PROBES] + [("dense", None)])
        for kind, shape in configs:
            if kind == "dense":
                scan = lambda: dk.fragment_spmv(w, src, dst, m, n_dst, table=False)  # noqa: E731
                act = lambda: dk.fragment_spmv_active(w, src, dst, m, bi, na, n_dst,  # noqa: E731
                                                      scan_above=nb, table=False)
                label = "dense (atomic an edge)"
            else:
                table = shape is not None
                scan = lambda t=table: pk.fragment_spmv_packed(  # noqa: E731
                    w, src, dwords, mw, None, n_dst, table=t, **kwp)
                act = lambda t=table: pk.fragment_spmv_packed_active(  # noqa: E731
                    w, src, dwords, mw, None, bi, na, n_dst, scan_above=nb, table=t, **kwp)
                label = (f"packed {shape[0]} slots, {shape[1]} probes" if table
                         else "packed no table (atomic an edge)")
            row = {"kind": kind, "slots": shape[0] if shape else None,
                   "probes": shape[1] if shape else None}
            saved = pk.LIB
            try:
                for part in (("occupancy", "count") if shape else (None,)):
                    if part is not None:
                        pk.LIB = libs[(part, *shape)]
                    if part == "count":
                        cnt = (ctypes.c_ulonglong * 3)()
                        pk.LIB.load().probe_counts(ctypes.addressof(cnt))  # reset
                    for sched, fn in (("scan", scan), ("active", act)):
                        if part == "count":
                            fn()
                            torch.cuda.synchronize()
                            cuda_build.raise_on(pk.LIB.load().probe_counts(
                                ctypes.addressof(cnt)), "probe_counts")
                            combined, overflow, flushed = (int(v) for v in cnt)
                            row[sched].update(
                                capture=combined / max(combined + overflow, 1),
                                global_atomics=overflow + flushed, overflow=overflow,
                                flushed=flushed)
                            continue
                        y = fn()
                        torch.cuda.synchronize()
                        e_hot, e_max = errs(y)
                        row[sched] = {"ms": C.time_device_ms(fn, C.KERNEL_REPS),
                                      "rel_err_hottest": e_hot, "rel_err_max": e_max}
            finally:
                pk.LIB = saved
            hop["configs"].append(row)
            s, a = row["scan"], row["active"]
            extra = ""
            if "capture" in s:
                extra = (f"; capture scan {s['capture']:.4f} active {a['capture']:.4f},"
                         f" global atomics scan {s['global_atomics']} active"
                         f" {a['global_atomics']}")
            print(f"  {label:36s} scan {s['ms']:.4f} ms, active {a['ms']:.4f} ms; float32 vs"
                  f" float64 hottest {s['rel_err_hottest']:.3g}/{a['rel_err_hottest']:.3g},"
                  f" max {s['rel_err_max']:.3g}/{a['rel_err_max']:.3g}{extra}", flush=True)
        record["hops"][name] = hop
        del truth, prod


def hot_share_sweep(C, dev, record) -> None:
    """Part 2."""
    import torch

    from repro_torch.core.fragments import _pack_words
    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmv_packed as pk

    E, n_src, n_dst, width = SWEEP_E, 4_000_000, 2_000_000, 21
    rng = np.random.default_rng(5)
    src = torch.from_numpy(np.sort(rng.integers(0, n_src, E)).astype(np.int32)).to(dev)
    w = C.frontier(n_src, "sum", torch.Generator(device=dev).manual_seed(6), dev)
    nb = active.n_edge_blocks(E)
    bi = torch.arange(nb, dtype=torch.int32, device=dev)
    na = torch.full((1,), nb, dtype=torch.int32, device=dev)
    rows = []
    for h in HOT_SHARES:
        dst = rng.integers(0, n_dst, E)
        dst[rng.random(E) < h] = 0
        share = float(np.bincount(dst).max()) / E
        words = torch.from_numpy(_pack_words(dst, width).view(np.int32)).to(dev)
        row = {"h": h, "hot_share": share}
        for table in (False, True):
            scan = lambda t=table: pk.fragment_spmv_packed(  # noqa: E731
                w, src, words, None, None, n_dst, dst_width=width, table=t)
            act = lambda t=table: pk.fragment_spmv_packed_active(  # noqa: E731
                w, src, words, None, None, bi, na, n_dst, dst_width=width, scan_above=nb,
                table=t)
            torch.testing.assert_close(scan(), act(), rtol=1e-4, atol=1e-4)
            key = "table" if table else "no_table"
            row[f"{key}_scan_ms"] = C.time_device_ms(scan, C.KERNEL_REPS)
            row[f"{key}_active_ms"] = C.time_device_ms(act, C.KERNEL_REPS)
        rows.append(row)
        print(f"  hot share {share:.5f}: scan {row['no_table_scan_ms']:.4f} → table"
              f" {row['table_scan_ms']:.4f} ms, active {row['no_table_active_ms']:.4f} →"
              f" table {row['table_active_ms']:.4f} ms", flush=True)
        del words
    # the smallest sampled share from which the table is no slower in both
    # schedules at every larger sampled share
    cross = None
    for r in reversed(rows):
        if r["table_scan_ms"] <= r["no_table_scan_ms"] and \
                r["table_active_ms"] <= r["no_table_active_ms"]:
            cross = r["hot_share"]
        else:
            break
    record["hot_share_sweep"] = {"E": E, "n_src": n_src, "n_dst": n_dst, "rows": rows,
                                 "crossover": cross}
    print(f"  the table is no slower from hot share {cross} up (both schedules)", flush=True)


def sparse_frontiers(C, SG, c0, engines, db, dev, record) -> None:
    """Part 3."""
    import torch

    from repro_torch.kernels import active, params
    from repro_torch.kernels import fragment_spmv_packed as pk

    pi = db.device.index("DT", "Doc")
    n_src, n_dst = pi.indptr.shape[0] - 1, db.schema.domain_size("Term")
    fre = pi.measure_cols["Fre"]
    out = {"I_DT.Doc hot_share": pi.hot_share, "hops": {}, "queries": {}}
    w = torch.zeros(n_src, dtype=torch.float32, device=dev)
    w[5] = 1.0  # d0 = 5, SD's and FSD's seed
    bi, na = active.active_block_list(w, 0.0, pi.block_src_min, pi.block_src_max)
    nb = active.n_edge_blocks(int(pi.src_ids.shape[0]))
    if fre.kind == "dense":
        fre_ops = (fre.array, None, dict(m_mode="dense"))
    else:
        fre_ops = (fre.words, getattr(fre, "dictionary", None),
                   dict(m_mode=fre.kind, m_width=fre.width))
    for label, m, md, kw in (
        ("SD first hop (no measure)", None, None, {}),
        ("FSD first hop (Fre)", *fre_ops),
    ):
        kw = dict(dst_width=pi.dst_col.width, **kw)
        r = {"n_active": int(na[0]), "n_blocks": nb, "measure": kw.get("m_mode", "none")}
        for table in (False, True):
            fn = lambda t=table: pk.fragment_spmv_packed_active(  # noqa: E731
                w, pi.src_ids, pi.dst_col.words, m, md, bi, na, n_dst, scan_above=nb,
                table=t, **kw)
            key = "table" if table else "no_table"
            r[f"{key}_ms"] = C.time_device_ms(fn, C.KERNEL_REPS)
            r[f"{key}_device_ms"] = C.device_busy(fn)[0]
        out["hops"][label] = r
        print(f"  {label}: {r['n_active']}/{nb} blocks listed; active kernel device time"
              f" {r['no_table_device_ms']:.4f} ms without the table,"
              f" {r['table_device_ms']:.4f} ms with it (CUDA events, host-bound at this size:"
              f" {r['no_table_ms']:.4f} / {r['table_ms']:.4f} ms)", flush=True)
    for thr_label, thr in (("as built", params.HOP_TABLE_HOT_SHARE), ("off", float("inf"))):
        with table_threshold(thr):
            split = C.breakdown(f"table {thr_label}", engines["auto"], SG, c0, "auto", "auto",
                                nine=False)
        out["queries"][thr_label] = split
    record["sparse_frontiers"] = out


def float_sums(C, SG, c0, engines, db, dbs, record) -> None:
    """Part 4."""
    from repro_torch.core import executor as X

    truth = C.truth_single(engines["auto"], SG, c0)
    res = {}
    for lbl, enc, bs, fusion in (("a", "dense", "off", "off"), ("b", "auto", "auto", "off"),
                                 ("c", "auto", "off", "off"), ("d", "dense", "auto", "off"),
                                 ("f", "auto", "auto", "auto"), ("g", "auto", "auto", "on")):
        res[lbl] = {name: engines[enc][name].prepare(q, block_skipping=bs, fusion=fusion)(**p)
                    for name, q, p in C.float_queries(SG, c0)}
    out = {"single": {lbl: {n: C.rel_to_f64(r[n], truth[n]) for n in truth}
                      for lbl, r in res.items()}}
    plain = {}
    for name, q, params in C.float_queries(SG, c0):
        pq = engines["auto"][name].prepare(q, block_skipping="auto", fusion="off")
        plain[name] = X.compile_frontier(engines["auto"][name].db.device, pq.phys,
                                         block_skipping="auto", use_kernel=False,
                                         fusion="off")(
            *[params[n] for n in pq.param_names]).cpu().numpy()
    out["plain_scatter"] = {n: C.rel_to_f64(plain[n], truth[n]) for n in truth}
    out["gates"] = {n: {"b vs a": gate_ratio(res["b"][n], res["a"][n]),
                        "b vs d": gate_ratio(res["b"][n], res["d"][n]),
                        "b vs plain": gate_ratio(res["b"][n], plain[n]),
                        "f vs plain": gate_ratio(res["f"][n], plain[n]),
                        "a vs plain": gate_ratio(res["a"][n], plain[n])} for n in truth}
    draws = C.draw_params(SG, c0, C.param_pools(db, dbs),
                          tuple(sorted(set(C.BATCHES + C.TIME_BATCHES + (8,)))), 41)
    out["batched"], out["rows_vs_single"] = {}, {}
    for lbl, fusion in (("h", "auto"), ("i", "on")):
        results = {}
        worst = {}
        for name, q, _ in C.float_queries(SG, c0):
            params = draws[name][8]
            pq = engines["auto"][name].prepare(q, block_skipping="auto", fusion=fusion)
            batch = pq.execute_batch(**params)
            results[(name, 8)] = (params, batch)
            worst[name] = max(gate_ratio(batch[i], pq(**{k: int(v[i]) for k, v in params.items()}))
                              for i in range(8))
        if lbl == "h":
            truth8 = C.truth_batched(engines["auto"], SG, c0, results)
        out["batched"][lbl] = {n: C.rel_to_f64(results[(n, 8)][1], truth8[n]) for n in truth8}
        out["rows_vs_single"][lbl] = worst
    record["float_sums"] = out
    for k, v in out.items():
        print(f"  {k}: {json.dumps(v)}", flush=True)


RED_N = 1 << 22  # 16 MB of float32: I_DT.Term's 4M documents
RED_COUNT = 28_991_945  # I_DT.Term's edges


def host_ms(fn, reps: int = 200) -> float:
    """Host ms a call: the enqueue of ``reps`` calls without a synchronise
    between them (the device catches up after)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def dense_pair(C, SG, c0, engines, db, db_dense, dev, record) -> None:
    """Part 5."""
    import ctypes

    import torch

    from repro_torch.kernels import active, cuda_build
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ops as K

    out = {"hops": {}}
    gen = torch.Generator(device=dev).manual_seed(31)
    for name, (table, key), meas, dst_ent in (
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
    ):
        di, pi = db_dense.device.index(table, key), db.device.index(table, key)
        n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size(dst_ent)
        src, dst = di.src_ids, di.dst_ids
        m = di.measures[meas] if meas else None
        E = int(src.shape[0])
        w = C.frontier(n_src, "sum", gen, dev)
        nb = active.n_edge_blocks(E)
        bi = torch.arange(nb, dtype=torch.int32, device=dev)
        na = torch.full((1,), nb, dtype=torch.int32, device=dev)
        pm = pi.measure_cols[meas] if meas else None
        kwp = dict(dst_width=pi.dst_col.width, m_mode="packed" if pm is not None else "none",
                   m_width=pm.width if pm is not None else 0)
        mw = pm.words if pm is not None else None
        truth = torch.zeros(n_dst, dtype=torch.float64, device=dev).index_add_(
            0, dst.long(), w.double()[src.long()] * (m.double() if m is not None else 1.0))
        hot = int(torch.argmax(torch.bincount(dst.long(), minlength=n_dst)))
        b_bytes, _ = C.hop_bound(E, n_src, n_dst, 4 * E, 4 * E if m is not None else 0)

        def dense(t):
            return (lambda: dk.fragment_spmv(w, src, dst, m, n_dst, table=t),
                    lambda: dk.fragment_spmv_active(w, src, dst, m, bi, na, n_dst,
                                                    scan_above=nb, table=t))

        packed = (lambda: pk.fragment_spmv_packed(w, src, pi.dst_col.words, mw, None, n_dst,
                                                  table=True, **kwp),
                  lambda: pk.fragment_spmv_packed_active(w, src, pi.dst_col.words, mw, None,
                                                         bi, na, n_dst, scan_above=nb,
                                                         table=True, **kwp))
        hop = {"E": E, "hot_share": di.hot_share, "bound_ms": b_bytes, "rows": []}
        plan = [("dense table", dense(True)), ("dense per edge", dense(False)),
                ("packed table", packed)] * 2  # in turns
        for form, (scan, act) in plan:
            row = {"form": form}
            for sched, fn in (("scan", scan), ("active", act)):
                y = fn().double()
                torch.cuda.synchronize()
                rel = (y - truth).abs() / truth.abs().clamp_min(1e-30)
                rel[truth == 0] = 0
                row[sched] = {"ms": C.time_device_ms(fn, C.KERNEL_REPS),
                              "rel_err_hottest": float(rel[hot]),
                              "rel_err_max": float(rel.max())}
            hop["rows"].append(row)
            print(f"  {name:9s} {form:15s} scan {row['scan']['ms']:.4f} ms,"
                  f" active {row['active']['ms']:.4f} ms (bound {b_bytes:.4f}); float32 vs"
                  f" float64 hottest {row['scan']['rel_err_hottest']:.3g}, max"
                  f" {row['scan']['rel_err_max']:.3g}", flush=True)
        out["hops"][name] = hop
        del truth

    # the card's rate of float reductions to distinct addresses
    red = cuda_build.CudaLibrary(
        "red_rate", {"red_rate_launch": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_void_p]},
        source=ROOT / "scripts" / "csrc" / "red_rate.cu")
    lib = red.load()
    y = torch.zeros(RED_N, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for mode, label in ((0, "distinct addresses"), (1, "distinct addresses, evict_last"),
                        (2, "consecutive words")):
        def launch(mode=mode):
            cuda_build.raise_on(lib.red_rate_launch(y.data_ptr(), RED_N, RED_COUNT, mode, stream),
                                "red_rate")
        ms = C.time_device_ms(launch, C.KERNEL_REPS)
        rates[label] = {"ms": ms, "per_s": RED_COUNT / (ms * 1e-3)}
        print(f"  float reductions, {label}: {RED_COUNT} in {ms:.4f} ms ="
              f" {RED_COUNT / (ms * 1e-3):.4g} a second", flush=True)
    out["red_rate"] = {"n": RED_N, "count": RED_COUNT, **rates}
    out["scatter_floor_ms"] = {n: h["E"] / rates["distinct addresses"]["per_s"] * 1e3
                               for n, h in out["hops"].items()}
    print(f"  the scatter's floor (E / the distinct-address rate): {out['scatter_floor_ms']}",
          flush=True)
    del y

    # SD's and FSD's first hop under dense storage
    di = db_dense.device.index("DT", "Doc")
    n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size("Term")
    w = torch.zeros(n_src, dtype=torch.float32, device=dev)
    w[5] = 1.0  # d0 = 5
    bi, na = active.active_block_list(w, 0.0, di.block_src_min, di.block_src_max)
    nb = active.n_edge_blocks(int(di.src_ids.shape[0]))
    first = {"n_active": int(na[0]), "n_blocks": nb, "hot_share": di.hot_share}
    for label, m in (("SD (no measure)", None), ("FSD (Fre)", di.measures["Fre"])):
        for t in (True, False):
            fn = lambda t=t: dk.fragment_spmv_active(  # noqa: E731
                w, di.src_ids, di.dst_ids, m, bi, na, n_dst, scan_above=nb, table=t)
            first[f"{label} table={'on' if t else 'off'}"] = C.device_busy(fn)[0]
        print(f"  first hop {label}: {first['n_active']}/{nb} blocks; device ms table on"
              f" {first[f'{label} table=on']:.4f} / off {first[f'{label} table=off']:.4f}",
              flush=True)
    out["first_hop"] = first
    out["dense_auto_queries"] = C.breakdown("dense/auto", engines["dense"], SG, c0, "auto",
                                            "off")

    # the list kernel against the plain build
    lists = []
    for key in (("DT", "Term"), ("DT", "Doc")):
        pi = db.device.index(*key)
        n_src = pi.indptr.shape[0] - 1
        blocks = (pi.block_src_min, pi.block_src_max)
        for support in ("one_seed", 1.0):
            for B in (1, 8):
                ws = [C.sparse_frontier(C.frontier(n_src, "sum", gen, dev), pi.degrees, support,
                                        "sum", 40 + b) for b in range(B)]
                w = ws[0] if B == 1 else torch.stack(ws).contiguous()
                row = {"index": f"I_{key[0]}.{key[1]}", "support": support, "B": B,
                       "n_blocks": int(blocks[0].shape[0])}
                for label, fn in (("kernel", lambda: K.active_block_list(w, 0.0, *blocks)),
                                  ("plain", lambda: active.active_block_list(w, 0.0, *blocks))):
                    busy, ops = C.device_busy(fn)
                    row[label] = {"device_ms": busy, "device_ops": ops, "host_ms": host_ms(fn),
                                  "ms": C.time_device_ms(fn, C.KERNEL_REPS)}
                lists.append(row)
                k, p = row["kernel"], row["plain"]
                print(f"  list I_{key[0]}.{key[1]} {support} B={B}: kernel device"
                      f" {k['device_ms']:.4f} ms ({k['device_ops']:.0f} ops), host"
                      f" {k['host_ms']:.4f} ms, a call {k['ms']:.4f}; plain device"
                      f" {p['device_ms']:.4f} ms ({p['device_ops']:.0f} ops), host"
                      f" {p['host_ms']:.4f} ms, a call {p['ms']:.4f}", flush=True)
    out["lists"] = lists
    record["dense_pair"] = out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hop_table_probe: no CUDA device", file=sys.stderr)
        return 2
    run(torch.device("cuda"), {int(a) for a in sys.argv[1:]} or {1, 2, 3, 4, 5})
    return 0


def run(dev, parts) -> None:
    """The parts named on ``dev``."""
    import torch

    import chip_smoke as C
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase, GQFastEngine
    from repro_torch.data import synth_graph as SG
    from repro_torch.kernels import cuda_build

    t_start = time.perf_counter()
    card = C.card_line()
    print(card, flush=True)
    libs = variants() if 1 in parts else {}
    cuda_build.build_all()  # the package's libraries
    cuda_build.build_all(list(libs.values()))
    print(f"built {len(libs)} table variants at"
          f" {time.perf_counter() - t_start:.1f} s", flush=True)
    record = {"card": card, "parts": sorted(parts), "occupancy": {}, "hops": {}}

    pub = SG.make_pubmed(**C.PUBMED)
    sem = SG.make_semmeddb(**C.SEMMED)
    kw = dict(account_space=False, keep_packed=True, device=dev, device_encodings="dense")
    db_dense = GQFastDatabase(pub, **kw)
    dbs_dense = GQFastDatabase(sem, **kw)
    db = GQFastDatabase.from_parts(pub, db_dense.host_indexes, X.build_device_db(
        pub, db_dense.host_indexes, "auto", device=dev))
    dbs = GQFastDatabase.from_parts(sem, dbs_dense.host_indexes, X.build_device_db(
        sem, dbs_dense.host_indexes, "auto", device=dev))
    print(f"data loaded at {time.perf_counter() - t_start:.1f} s", flush=True)
    record["hot_shares"] = {f"{lbl} I_{t}.{k}": di.hot_share
                            for lbl, d in (("pubmed", db), ("semmed", dbs))
                            for (t, k), di in d.device.indexes.items()}
    print(f"  hot shares: {record['hot_shares']}", flush=True)

    if 1 in parts:
        print("[1] table shapes", flush=True)
        table_shapes(C, db, db_dense, libs, dev, record)
    if 2 in parts:
        print(f"[2] hot-share sweep at {time.perf_counter() - t_start:.1f} s", flush=True)
        hot_share_sweep(C, dev, record)
    c0 = C.busy_concept(sem)
    engines = {}
    for label, (p, s) in {"dense": (db_dense, dbs_dense), "auto": (db, dbs)}.items():
        ep, es = GQFastEngine(p), GQFastEngine(s)
        engines[label] = {n: (es if n == "CS" else ep) for n, _, _ in C.cases(SG, c0, True)}
    if 3 in parts:
        print(f"[3] sparse frontiers at {time.perf_counter() - t_start:.1f} s", flush=True)
        sparse_frontiers(C, SG, c0, engines, db, dev, record)
    if 4 in parts:
        print(f"[4] float sums at {time.perf_counter() - t_start:.1f} s", flush=True)
        float_sums(C, SG, c0, engines, db, dbs, record)
    if 5 in parts:
        print(f"[5] the dense pair and the list kernel at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        dense_pair(C, SG, c0, engines, db, db_dense, dev, record)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "hop_table_probe.json").write_text(json.dumps(record, indent=1))
    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
