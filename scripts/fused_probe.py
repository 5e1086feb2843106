#!/usr/bin/env python3
"""Split the two-hop fused kernel's time on one NVIDIA GPU by phase and by
where the mid mask is applied.

    python3 scripts/fused_probe.py      # from the repository root, on a card

Builds three variants of ``csrc/fragment_spmv_fused.cu`` into the kernel
build directory: ``gather`` (the kernel as committed: the mid mask at hop2's
gather), ``scatter`` (the mask at hop1's scatter: an edge whose dst has
keep ≤ 0 issues no atomic) and ``none`` (no mask: a timing yardstick whose
result differs). For SD's region (I_DT.Doc → I_DT.Term) and AS-recent's
(I_DT.Term + mask + I_DA.Doc) at the full PubMed scale of ``chip_smoke.py``,
every source live, it prints the CUDA-event time of each variant whole and
with hop2's list emptied (the fill and hop1 phases only), beside the unfused
pieces through the port's packed hop kernel: hop1, the mask, hop2 over its
own list and over the fused kernel's reach list. Prints the card's name and
power limit first. Writes nothing.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "gather": [],
    "scatter": [("h1, u, n_mid, KeepAll{}", "h1, u, n_mid, KeepMask{keep}"),
                ("MidGather<OP>{u, keep,", "MidGather<OP>{u, nullptr,")],
    "none": [("MidGather<OP>{u, keep,", "MidGather<OP>{u, nullptr,")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase
    from repro_torch.data import synth_graph as SG
    from repro_torch.kernels import active, cuda_build, ref
    from repro_torch.kernels import fragment_spmv_fused as fk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ops as K

    print(C.card_line(), flush=True)
    text = fk.LIB.source.read_text()
    libs = {}
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, subs in VARIANTS.items():
        v = text
        for old, new in subs:
            if old not in v:
                raise AssertionError(f"variant {name}: {old!r} not in the kernel source")
            v = v.replace(old, new)
        lib = cuda_build.CudaLibrary(f"fragment_spmv_fused_{name}", fk.LIB.functions)
        lib.source = cuda_build.BUILD_DIR / f"fragment_spmv_fused_{name}.cu"
        lib.source.write_text(v)
        libs[name] = lib
    cuda_build.build_all(list(libs.values()))
    dev = torch.device("cuda")
    pub = SG.make_pubmed(**C.PUBMED)
    host = GQFastDatabase(pub, account_space=False, device=dev, device_encodings="dense")
    db = GQFastDatabase.from_parts(pub, host.host_indexes, X.build_device_db(
        pub, host.host_indexes, "auto", device=dev))
    del host
    gen = torch.Generator(device=dev).manual_seed(16)
    for spec in C.region_specs(db, SG, dev)[:2]:
        h1, h2, mask = spec["hop1"], spec["hop2"], spec["mask"]
        E1, E2 = int(h1.src_ids.shape[0]), int(h2.src_ids.shape[0])
        w = C.sparse_frontier(C.frontier(spec["n_src"], "sum", gen, dev), spec["degrees"], 1.0,
                              "sum", 17)
        lists = K._fused_block_lists(w, "sum", h1, h2, E1, E2, "on")
        none2 = torch.zeros(1, dtype=torch.int32, device=dev)
        s1, s2 = K._streams(h1, dev), K._streams(h2, dev)
        n_mid, n_dst = h1.n_dst, h2.n_dst
        print(f"{spec['name']}: lists {int(lists[1][0])}, {int(lists[3][0])} blocks", flush=True)
        want = None
        for name, lib in libs.items():
            fk.LIB = lib
            def full():
                return fk.fragment_spmv_fused2(w, s1, s2, mask, *lists, n_mid, n_dst)

            def hop1():  # hop2's list emptied: the fill and hop1 phases
                return fk.fragment_spmv_fused2(w, s1, s2, mask, *lists[:3], none2, n_mid,
                                               n_dst)

            got = full()
            if name == "gather":
                want = got
            elif name == "scatter":
                C.compare(got, want, False, "scatter variant vs gather")
            print(f"  {name:8s} whole {C.time_device_ms(full, C.KERNEL_REPS):.4f} ms,"
                  f" fill + hop1 {C.time_device_ms(hop1, C.KERNEL_REPS):.4f} ms", flush=True)
        u = C.unfused_region(w, s1, None, None, None, n_mid, n_dst, "sum", False)
        um = ref.apply_mask(u, mask, "sum") if mask is not None else u
        own = active.active_block_list(um, 0.0, *(torch.as_tensor(b, device=dev)
                                                  for b in h2.blocks))
        kw1 = dict(dst_width=s1.dst_width, m_mode=s1.m_mode, m_width=s1.m_width)
        kw2 = dict(dst_width=s2.dst_width, m_mode=s2.m_mode, m_width=s2.m_width)
        t1 = C.time_device_ms(lambda: pk.fragment_spmv_packed_active(
            w, s1.src, s1.dst, s1.measure, s1.mdict, *lists[:2], n_mid, **kw1), C.KERNEL_REPS)
        tm = C.time_device_ms(lambda: ref.apply_mask(u, mask, "sum") if mask is not None
                              else u, C.KERNEL_REPS)
        t2 = [C.time_device_ms(lambda bl=bl: pk.fragment_spmv_packed_active(
            um, s2.src, s2.dst, s2.measure, s2.mdict, *bl, n_dst, **kw2), C.KERNEL_REPS)
            for bl in (own, lists[2:])]
        print(f"  unfused  hop1 {t1:.4f} ms, mask {tm:.4f} ms, hop2 {t2[0]:.4f} ms over its"
              f" own list ({int(own[1][0])} blocks), {t2[1]:.4f} ms over the reach list",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
