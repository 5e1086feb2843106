#!/usr/bin/env python3
"""Time the fused-region kernels on one NVIDIA GPU against another
checkout's.

    python3 scripts/fused_probe.py --parent DIR   # from the repository root, on a card

``DIR`` is a checkout unpacked by ``git archive`` into a git-ignored
directory such as ``_archive/``, whose fused entry points take no table flags
and whose SpMM form accumulates row by row into [B, n]. Its own wrapper
module (``kernels/fragment_spmv_fused.py``) is loaded over this tree's
helpers and its ``.cu`` built beside this tree's, so both sides run through
their own wrapper on every call: the same host work (argument checks, the
streams' struct, the scratch, the launch), as the engine calls them.

Prints the card's name and power limit first and writes ``fused_probe.json``
into the output directory ``chip_smoke.py`` writes to. At the full PubMed
scale of ``chip_smoke.py`` (the packed indexes of the defaults) and its three
fused regions (SD's two-hop I_DT.Doc → I_DT.Term, AS-recent's I_DT.Term +
mask + I_DA.Doc, SD-recent's degenerate I_DT.Term + mask), sum, block lists
built beforehand: each region's kernel in the SpMV form over
``chip_smoke``'s frontiers of phase 5 (one seed and every source;
AS-recent's every source) and in the SpMM form at B = 1, 8 and 64 over its
sparse rows of phase 5h, in turns: the checkout's, this tree's, this tree's,
the checkout's, this tree's in every form (``chip_smoke.region_forms``: the
table where a hop's hot share asks for it, per edge, the table in every
hop). Each turn reads two times a call: CUDA events around the calls (``ms``,
which takes the host's time between launches where the host is slower than
the card) and ``torch.profiler``'s device time (``device_ms``: the fused
kernel and the epilogue, ``chip_smoke.is_hop_kernel``; ``other_ms``: the
fills and copies the wrapper launches). Each result's gate ratio is taken
against the checkout's.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

REPS = 10
BATCHES = (1, 8, 64)
SUPPORTS = (("one_seed", 1.0), (1.0,), ("one_seed", 1.0))  # SD, AS-recent, SD-recent


def parent_wrapper(parent: Path):
    """The checkout's ``kernels/fragment_spmv_fused.py``, loaded as a module
    of this tree's kernel package, its library built from the checkout's
    ``.cu`` under a name of its own."""
    from repro_torch.kernels import cuda_build

    path = parent / "src" / "repro_torch" / "kernels" / "fragment_spmv_fused.py"
    spec = importlib.util.spec_from_file_location("repro_torch.kernels.parent_fused", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cuda_build.LIBRARIES.remove(mod.LIB)
    mod.LIB = cuda_build.CudaLibrary("parent_fragment_spmv_fused", mod.LIB.functions,
                                     source=path.parent / "csrc" / "fragment_spmv_fused.cu")
    cuda_build.LIBRARIES.remove(mod.LIB)
    cuda_build.build_all([mod.LIB])
    return mod


def parent_call(pk, spec, w, lists, dev):
    """The checkout's fused kernel of ``spec``'s region over ``lists``, sum,
    through its wrapper: the SpMV form for a ``[n]`` frontier, the SpMM form
    for ``[B, n]`` rows."""
    from repro_torch.kernels import ops as K

    rows = w.dim() == 2
    s1 = K._streams(spec["hop1"], dev)
    n_mid = spec["hop1"].n_dst
    if spec["hop2"] is None:
        f1 = pk.fragment_spmm_fused1 if rows else pk.fragment_spmv_fused1
        return lambda: f1(w, s1, spec["mask"], *lists[:2], n_mid, op="sum")
    s2 = K._streams(spec["hop2"], dev)
    f2 = pk.fragment_spmm_fused2 if rows else pk.fragment_spmv_fused2
    return lambda: f2(w, s1, s2, spec["mask"], *lists, n_mid, spec["hop2"].n_dst, op="sum",
                      mid_binarize=spec["binarize"])


def profiled_ms(C, fn, reps: int) -> tuple[float, float]:
    """``(device_ms, other_ms)`` a call of ``fn`` by ``torch.profiler``: the
    hop kernels' device time and every other kernel's, after warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hop = other = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or "Memcpy" in ev.key:
            continue
        t = ev.self_device_time_total / 1e3 / reps
        if C.is_hop_kernel(ev.key):
            hop += t
        else:
            other += t
    return hop, other


def inputs(C, spec, supports, dev, gen):
    """(label, frontier) pairs: phase 5's frontiers at ``supports``, then
    phase 5h's rows at each of BATCHES."""
    out = []
    for support in supports:
        w = C.sparse_frontier(C.frontier(spec["n_src"], "sum", gen, dev), spec["degrees"],
                              support, "sum", 17)
        out.append((f"spmv {support}", w))
    for B in BATCHES:
        out.append((f"B={B}", C.frontier_rows(spec["n_src"], B, "sum", gen, dev,
                                              degrees=spec["degrees"])))
    return out


def against_parent(C, specs, dev, record, parent: Path) -> None:
    import torch

    from repro_torch.kernels import ops as K

    pk = parent_wrapper(parent)
    gen = torch.Generator(device=dev).manual_seed(61)
    rows = []
    for spec, supports in zip(specs, SUPPORTS):
        h1, h2 = spec["hop1"], spec["hop2"]
        E1 = int(h1.src_ids.shape[0])
        E2 = int(h2.src_ids.shape[0]) if h2 is not None else 0
        forms = C.region_forms(spec)
        for label, w in inputs(C, spec, supports, dev, gen):
            lists = K._fused_block_lists(w, "sum", h1, h2, E1, E2, "on")
            old = parent_call(pk, spec, w, lists, dev)
            new = {f: C.region_call(spec, w, "sum", lists, dev, f) for f in forms}
            want = old().cpu().numpy()
            row = {"region": spec["name"], "input": label, "forms": forms,
                   "n_active": [int(lists[1][0])] + ([int(lists[3][0])] if h2 is not None
                                                     else []),
                   "gate_ratio": {f: C.gate_ratio(new[f]().cpu().numpy(), want) for f in forms}}
            for f in forms:
                times = {who: {"ms": [], "device_ms": [], "other_ms": []}
                         for who in ("parent", "this")}
                for who, fn in (("parent", old), ("this", new[f]), ("this", new[f]),
                                ("parent", old)):
                    t = times[who]
                    t["ms"].append(C.time_device_ms(fn, REPS))
                    hop, other = profiled_ms(C, fn, REPS)
                    t["device_ms"].append(hop)
                    t["other_ms"].append(other)
                row[f] = times
            rows.append(row)
            print(f"  {spec['name']:34s} {label:13s} lists {row['n_active']}: " + "; ".join(
                f"{f} {forms[f]} parent {row[f]['parent']} this {row[f]['this']}"
                f" (gate ratio {row['gate_ratio'][f]:.3g})" for f in forms), flush=True)
            del w, lists, old, new
            torch.cuda.empty_cache()
    record["against_parent"] = {"parent": str(parent), "rows": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_probe: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if len(args) != 2 or args[0] != "--parent":
        print("usage: fused_probe.py --parent DIR", file=sys.stderr)
        return 2
    run(torch.device("cuda"), Path(args[1]).resolve())
    return 0


def run(dev, parent: Path) -> None:
    """Every region and input on ``dev``, against ``parent``'s kernels."""
    import chip_smoke as C
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase
    from repro_torch.data import synth_graph as SG
    from repro_torch.kernels import cuda_build

    t_start = time.perf_counter()
    card = C.card_line()
    print(card, flush=True)
    cuda_build.build_all()
    record = {"card": card}
    pub = SG.make_pubmed(**C.PUBMED)
    kw = dict(account_space=False, keep_packed=True, device=dev, device_encodings="dense")
    db_dense = GQFastDatabase(pub, **kw)
    db = GQFastDatabase.from_parts(pub, db_dense.host_indexes, X.build_device_db(
        pub, db_dense.host_indexes, "auto", device=dev))
    del db_dense
    specs = C.region_specs(db, SG, dev)
    print(f"data loaded at {time.perf_counter() - t_start:.1f} s; against {parent}", flush=True)
    against_parent(C, specs, dev, record, parent)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fused_probe.json").write_text(json.dumps(record, indent=1))
    print(f"done in {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
