#!/usr/bin/env python3
"""Size and check the batched hops' row-chunk body on one NVIDIA GPU.

    python3 scripts/spmm_probe.py          # from the repository root, on a card
    python3 scripts/spmm_probe.py 1 4      # only the parts named
    python3 scripts/spmm_probe.py 3 --parent DIR   # part 3 against a checkout

Prints the card's name and power limit first and writes ``spmm_probe.json``
into the output directory ``chip_smoke.py`` writes to. At the full PubMed
scale of ``chip_smoke.py`` (the packed indexes of the defaults), sum over
dense random frontier rows, each time by CUDA events (the kernels alone,
block lists built beforehand), every comparison in turns within the call:

1. The card's reduction rates (``scripts/csrc/red_rate.cu``) at I_DT.Term's
   edge count: one float reduction to a distinct address; one
   ``red.global.add.v4.f32`` into a distinct 32-byte sector; two of them
   filling the sector (an 8-row chunk). The batched hop's floor is its
   edges × chunks over the sector rate.
2. The batched table's shape: ``fragment_spmm_packed`` / ``_active`` built
   with ``-DSPMM_TABLE_BITS`` = 10, 11, 12 (1,024 / 2,048 / 4,096 slots of a
   key and rb values at every rb), on I_DA.Doc (hot authors) at B = 2, 4
   (rb = 2, 4), 8 and 64, beside the per-edge form, each shape timed twice
   in turns; the co-resident CTAs follow from the shared memory (4 + 4·rb
   bytes a slot).
3. The four SpMM kernels against those of another checkout (``--parent
   DIR``, whose ``fragment_spmm_launch`` / ``fragment_spmm_packed_launch``
   take no scratch: the per-edge body before the row-chunk one) at
   I_DT.Term and I_DA.Doc and B = 1, 8 and 64, in turns (the checkout's,
   this tree's, this tree's, the checkout's), this tree's in the form the
   hot share chooses, each result's gate ratio against the checkout's scan.
4. The epilogue's share: the device time of one call split by kernel
   (``torch.profiler``): the scratch fill, the hop and the epilogue
   (``rows_from_chunks``), for all four SpMM kernels at both shapes and B =
   8, 64.
5. The hot-share threshold of the batched table: synthetic indexes of
   I_DA.Doc's size (11.8M edges from 4M sources, 2M destinations, 21-bit
   packed dst), a share h of the edges on one destination, the packed
   scan and active kernels at B = 8 with the table and without.
"""
from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BITS = (10, 11, 12)
BATCHES = (8, 64)
TABLE_BATCHES = (2, 4, 8, 64)
PARENT_BATCHES = (1, 8, 64)
REPS = 10
RED_N = 1 << 25  # 128 MB of float32: an 8-row chunk over 4M documents
RED_COUNT = 28_991_945  # I_DT.Term's edges
SWEEP_E = 11_779_672  # I_DA.Doc's edges
HOT_SHARES = (0.0, 0.0005, 0.001, 0.002, 0.003, 0.005, 0.01, 0.03, 0.08)


def shapes(db):
    """The main path's two batched hop shapes on the packed indexes:
    (name, index, n_dst, kwargs of the packed kernels, measure words)."""
    out = []
    for name, (table, key), meas, dst_ent in (
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
    ):
        pi = db.device.index(table, key)
        pm = pi.measure_cols[meas] if meas else None
        kw = dict(dst_width=pi.dst_col.width, m_mode="packed" if pm is not None else "none",
                  m_width=pm.width if pm is not None else 0)
        out.append((name, pi, db.schema.domain_size(dst_ent), kw,
                    pm.words if pm is not None else None))
    return out


def packed_calls(spk, W, pi, n_dst, kw, mw, table):
    """The packed scan and active kernels over every block."""
    import torch

    from repro_torch.kernels import active

    E = int(pi.src_ids.shape[0])
    nb = active.n_edge_blocks(E)
    bi = torch.arange(nb, dtype=torch.int32, device=W.device)
    na = torch.full((1,), nb, dtype=torch.int32, device=W.device)
    return {
        "scan": lambda: spk.fragment_spmm_packed(W, pi.src_ids, pi.dst_col.words, mw, None,
                                                 n_dst, table=table, **kw),
        "active": lambda: spk.fragment_spmm_packed_active(
            W, pi.src_ids, pi.dst_col.words, mw, None, bi, na, n_dst, scan_above=nb,
            table=table, **kw),
    }


def gate(C, got, want, what: str) -> float:
    """The gate ratio of ``got`` against ``want`` (chip_smoke's rtol = atol =
    1e-4 passes at 1), recorded rather than enforced: the per-edge form's
    float32 sums drift on hot destinations. Fails on a shape or a
    non-finite value."""
    a, b = got.cpu().numpy(), want.cpu().numpy()
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}, or non-finite values")
    return C.gate_ratio(a, b)


def variant(spk, defines):
    from repro_torch.kernels.cuda_build import CudaLibrary

    return CudaLibrary(spk.LIB.name, spk.LIB.functions, defines=defines)


def red_rates(C, dev, record) -> None:
    """Part 1."""
    import torch

    from repro_torch.kernels import cuda_build

    lib = cuda_build.CudaLibrary(
        "red_rate", {"red_rate_launch": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_void_p]},
        source=ROOT / "scripts" / "csrc" / "red_rate.cu").load()
    y = torch.zeros(RED_N, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for mode, label in ((0, "scalar, distinct addresses"), (3, "v4, distinct sectors"),
                        (4, "2 x v4, a whole sector"), (0, "scalar, distinct addresses")):
        def launch(mode=mode):
            cuda_build.raise_on(lib.red_rate_launch(y.data_ptr(), RED_N, RED_COUNT, mode, stream),
                                "red_rate")
        ms = C.time_device_ms(launch, C.KERNEL_REPS)
        rates.setdefault(label, []).append({"ms": ms, "per_s": RED_COUNT / (ms * 1e-3)})
        print(f"  {label}: {RED_COUNT} in {ms:.4f} ms = {RED_COUNT / (ms * 1e-3):.4g} a second",
              flush=True)
    record["red_rate"] = {"n": RED_N, "count": RED_COUNT, **rates}


def table_shapes(C, db, dev, record) -> None:
    """Part 2."""
    import torch

    from repro_torch.kernels import fragment_spmm_packed as spk

    name, pi, n_dst, kw, mw = shapes(db)[0]  # I_DA.Doc
    n_src = pi.indptr.shape[0] - 1
    gen = torch.Generator(device=dev).manual_seed(41)
    libs = {b: variant(spk, (f"SPMM_TABLE_BITS={b}",)) for b in BITS}
    from repro_torch.kernels.cuda_build import build_all

    build_all(list(libs.values()))
    out = []
    built = spk.LIB
    for B in TABLE_BATCHES:
        W = C.frontier_rows(n_src, B, "sum", gen, dev)
        want = None
        for turn in (0, 1):
            for bits in BITS + ("per edge",):
                spk.LIB = built if bits == "per edge" else libs[bits]
                calls = packed_calls(spk, W, pi, n_dst, kw, mw, bits != "per edge")
                if want is None:
                    want = calls["scan"]()
                row = {"B": B, "turn": turn, "slots": bits if bits == "per edge" else 1 << bits}
                for sched, fn in calls.items():
                    row[f"{sched}_gate_ratio"] = gate(C, fn(), want, f"{name} B={B} {bits}")
                    row[sched] = C.time_device_ms(fn, REPS)
                out.append(row)
                print(f"  {name} B={B} turn {turn} {row['slots']}: scan {row['scan']:.4f} ms,"
                      f" active {row['active']:.4f} ms", flush=True)
        spk.LIB = built
        del W, want
    record["table_shapes"] = {"shape": name, "E": int(pi.src_ids.shape[0]), "rows": out}


# The entry points of a checkout whose batched hops take no scratch.
P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
PARENT_FUNCTIONS = {
    "fragment_spmm": {"fragment_spmm_launch": [
        P, I32, I32, P, P, P, I64, I64, P, I32, I32, P, I32, P, I32, P]},
    "fragment_spmm_packed": {"fragment_spmm_packed_launch": [
        P, I32, I32, P, I64, P, I32, I64, I32, P, I32, I64, P, I32, P, I32, I32, P, I32, P,
        I32, P]},
}


def against_parent(C, db, db_dense, dev, record, parent: Path) -> None:
    """Part 3."""
    import torch

    from repro_torch.kernels import active, cuda_build
    from repro_torch.kernels import fragment_spmm as sk
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.fragment_spmv_packed import M_MODES

    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    libs = {name: cuda_build.CudaLibrary(f"parent_{name}", fns, source=csrc / f"{name}.cu")
            for name, fns in PARENT_FUNCTIONS.items()}
    cuda_build.build_all(list(libs.values()))
    dense_lib, packed_lib = (libs[k].load() for k in ("fragment_spmm", "fragment_spmm_packed"))
    stream = cuda_build.stream_of(dev)
    gen = torch.Generator(device=dev).manual_seed(44)
    out = []
    for (name, pi, n_dst, kw, mw), (table, key) in zip(shapes(db),
                                                       (("DA", "Doc"), ("DT", "Term"))):
        di = db_dense.device.index(table, key)
        m = di.measures["Fre"] if key == "Term" else None
        n_src = pi.indptr.shape[0] - 1
        E = int(pi.src_ids.shape[0])
        nb = active.n_edge_blocks(E)
        bi = torch.arange(nb, dtype=torch.int32, device=dev)
        na = torch.full((1,), nb, dtype=torch.int32, device=dev)
        t = K.uses_table(pi.hot_share)
        for B in PARENT_BATCHES:
            W = C.frontier_rows(n_src, B, "sum", gen, dev)

            def old_dense(blocks, W=W):
                y = torch.zeros((B, n_dst), dtype=torch.float32, device=dev)
                cuda_build.raise_on(dense_lib.fragment_spmm_launch(
                    W.data_ptr(), n_src, B, di.src_ids.data_ptr(), di.dst_ids.data_ptr(),
                    m.data_ptr() if m is not None else None, 0, E, y.data_ptr(), n_dst, 0,
                    bi.data_ptr() if blocks else None, nb if blocks else 0,
                    na.data_ptr() if blocks else None, nb, stream), "parent fragment_spmm")
                return y

            def old_packed(blocks, W=W):
                y = torch.zeros((B, n_dst), dtype=torch.float32, device=dev)
                cuda_build.raise_on(packed_lib.fragment_spmm_packed_launch(
                    W.data_ptr(), n_src, B, pi.src_ids.data_ptr(), E, pi.dst_col.words.data_ptr(),
                    kw["dst_width"], pi.dst_col.words.shape[0] if kw["dst_width"] else 0,
                    M_MODES[kw["m_mode"]],
                    mw.data_ptr() if mw is not None else None, kw["m_width"],
                    mw.shape[0] if mw is not None else 0, None, 0, y.data_ptr(), n_dst, 0,
                    bi.data_ptr() if blocks else None, nb if blocks else 0,
                    na.data_ptr() if blocks else None, nb, stream),
                    "parent fragment_spmm_packed")
                return y

            new = {
                "fragment_spmm": lambda W=W: sk.fragment_spmm(W, di.src_ids, di.dst_ids, m,
                                                              n_dst, table=t),
                "fragment_spmm_active": lambda W=W: sk.fragment_spmm_active(
                    W, di.src_ids, di.dst_ids, m, bi, na, n_dst, scan_above=nb, table=t),
                **{f"fragment_spmm_packed{'' if k == 'scan' else '_active'}": f
                   for k, f in packed_calls(spk, W, pi, n_dst, kw, mw, t).items()},
            }
            old = {"fragment_spmm": lambda: old_dense(False),
                   "fragment_spmm_active": lambda: old_dense(True),
                   "fragment_spmm_packed": lambda: old_packed(False),
                   "fragment_spmm_packed_active": lambda: old_packed(True)}
            want = old["fragment_spmm_packed"]()
            for k in new:
                row = {"kernel": k, "shape": name, "B": B, "table": t,
                       "gate_ratio": gate(C, new[k](), want, f"{k} {name} B={B}"),
                       "parent_gate_ratio": gate(C, old[k](), want, f"parent {k} {name} B={B}")}
                for label, fn in (("parent", old[k]), ("this", new[k]), ("this", new[k]),
                                  ("parent", old[k])):
                    row.setdefault(f"{label}_ms", []).append(C.time_device_ms(fn, REPS))
                out.append(row)
                print(f"  {k:28s} {name:9s} B={B:2d} table={t}: parent {row['parent_ms']} ms,"
                      f" this tree {row['this_ms']} ms (gate ratio against the parent's scan"
                      f" {row['gate_ratio']:.3g})", flush=True)
            del W, want
    record["against_parent"] = {"parent": str(parent), "rows": out}


def epilogue_share(C, db, db_dense, dev, record) -> None:
    """Part 4."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmm as sk
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import ops as K

    gen = torch.Generator(device=dev).manual_seed(43)
    out = []
    for (name, pi, n_dst, kw, mw), (table, key) in zip(shapes(db),
                                                       (("DA", "Doc"), ("DT", "Term"))):
        di = db_dense.device.index(table, key)
        m = di.measures["Fre"] if key == "Term" else None
        n_src = pi.indptr.shape[0] - 1
        E = int(pi.src_ids.shape[0])
        nb = active.n_edge_blocks(E)
        bi = torch.arange(nb, dtype=torch.int32, device=dev)
        na = torch.full((1,), nb, dtype=torch.int32, device=dev)
        t = K.uses_table(pi.hot_share)
        for B in BATCHES:
            W = C.frontier_rows(n_src, B, "sum", gen, dev)
            calls = {
                "fragment_spmm": lambda: sk.fragment_spmm(W, di.src_ids, di.dst_ids, m, n_dst,
                                                          table=t),
                "fragment_spmm_active": lambda: sk.fragment_spmm_active(
                    W, di.src_ids, di.dst_ids, m, bi, na, n_dst, scan_above=nb, table=t),
                **{f"fragment_spmm_packed{'' if k == 'scan' else '_active'}": f
                   for k, f in packed_calls(spk, W, pi, n_dst, kw, mw, t).items()},
            }
            for k, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                split = {"epilogue": 0.0, "hop": 0.0, "fill": 0.0}
                for ev in prof.key_averages():
                    if ev.device_type != DeviceType.CUDA:
                        continue
                    kind = ("epilogue" if "rows_from_chunks" in ev.key
                            else "hop" if "fragment_spmm" in ev.key else "fill")
                    split[kind] += ev.self_device_time_total / 1e3 / 3
                total = sum(split.values())
                row = {"kernel": k, "shape": name, "B": B, "table": t, **split,
                       "epilogue_share": split["epilogue"] / total if total else None}
                out.append(row)
                print(f"  {k:28s} {name:9s} B={B:2d} table={t}: hop {split['hop']:.4f} ms,"
                      f" epilogue {split['epilogue']:.4f} ms, fill {split['fill']:.4f} ms"
                      f" (epilogue share {row['epilogue_share']:.3f})", flush=True)
                del prof
            del W
    record["epilogue"] = out


def hot_share_sweep(C, dev, record) -> None:
    """Part 5."""
    import torch

    from repro_torch.core.fragments import _pack_words
    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmm_packed as spk

    E, n_src, n_dst, width, B = SWEEP_E, 4_000_000, 2_000_000, 21, 8
    rng = np.random.default_rng(5)
    src = torch.from_numpy(np.sort(rng.integers(0, n_src, E)).astype(np.int32)).to(dev)
    W = C.frontier_rows(n_src, B, "sum", torch.Generator(device=dev).manual_seed(6), dev)
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
        for table in (False, True, False, True):
            scan = lambda t=table: spk.fragment_spmm_packed(  # noqa: E731
                W, src, words, None, None, n_dst, dst_width=width, table=t)
            act = lambda t=table: spk.fragment_spmm_packed_active(  # noqa: E731
                W, src, words, None, None, bi, na, n_dst, dst_width=width, scan_above=nb,
                table=t)
            key = "table" if table else "per_edge"
            row[f"{key}_gate_ratio"] = gate(C, act(), scan(), f"sweep h={h}")
            row.setdefault(f"{key}_scan_ms", []).append(C.time_device_ms(scan, REPS))
            row.setdefault(f"{key}_active_ms", []).append(C.time_device_ms(act, REPS))
        rows.append(row)
        print(f"  hot share {share:.5f}: scan per edge {row['per_edge_scan_ms']} / table"
              f" {row['table_scan_ms']} ms, active per edge {row['per_edge_active_ms']} /"
              f" table {row['table_active_ms']} ms", flush=True)
        del words
    cross = None
    for r in reversed(rows):
        if max(r["table_scan_ms"]) <= min(r["per_edge_scan_ms"]) and \
                max(r["table_active_ms"]) <= min(r["per_edge_active_ms"]):
            cross = r["hot_share"]
        else:
            break
    record["hot_share_sweep"] = {"E": E, "B": B, "rows": rows, "crossover": cross}
    print(f"  the batched table is no slower in both runs from hot share {cross} up",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spmm_probe: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    parts = {int(a) for a in args} or ({1, 2, 3, 4, 5} if parent else {1, 2, 4, 5})
    if 3 in parts and parent is None:
        print("spmm_probe: part 3 needs --parent DIR", file=sys.stderr)
        return 2
    run(torch.device("cuda"), parts, parent)
    return 0


def run(dev, parts, parent=None) -> None:
    """The parts named on ``dev``."""
    import chip_smoke as C
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase
    from repro_torch.data import synth_graph as SG
    from repro_torch.kernels import cuda_build

    t_start = time.perf_counter()
    card = C.card_line()
    print(card, flush=True)
    cuda_build.build_all()
    record = {"card": card, "parts": sorted(parts)}
    if 1 in parts:
        print("[1] reduction rates", flush=True)
        red_rates(C, dev, record)
    if parts & {2, 3, 4}:
        pub = SG.make_pubmed(**C.PUBMED)
        kw = dict(account_space=False, keep_packed=True, device=dev, device_encodings="dense")
        db_dense = GQFastDatabase(pub, **kw)
        db = GQFastDatabase.from_parts(pub, db_dense.host_indexes, X.build_device_db(
            pub, db_dense.host_indexes, "auto", device=dev))
        print(f"data loaded at {time.perf_counter() - t_start:.1f} s", flush=True)
        if 2 in parts:
            print("[2] the batched table's shape", flush=True)
            table_shapes(C, db, dev, record)
        if 3 in parts:
            print(f"[3] against {parent} at {time.perf_counter() - t_start:.1f} s", flush=True)
            against_parent(C, db, db_dense, dev, record, parent)
        if 4 in parts:
            print(f"[4] the epilogue's share at {time.perf_counter() - t_start:.1f} s", flush=True)
            epilogue_share(C, db, db_dense, dev, record)
        del db, db_dense
    if 5 in parts:
        print(f"[5] hot-share sweep at {time.perf_counter() - t_start:.1f} s", flush=True)
        hot_share_sweep(C, dev, record)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "spmm_probe.json").write_text(json.dumps(record, indent=1))
    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
