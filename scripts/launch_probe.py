#!/usr/bin/env python3
"""Host cost of the kernel wrappers' launch path on one NVIDIA GPU, and the
bitmap kernels' times, against another checkout's.

    python3 scripts/launch_probe.py [--parent DIR] [parts]   # repository root, on a card

Parts (default: all of them):

  * ``micro``: the pieces of a launch, each in µs a call over back-to-back
    calls: the ``torch.cuda.device`` switch, the current stream
    (``torch.cuda.current_stream(dev).cuda_stream`` and the raw stream
    lookup), the current device, ``cuda_build.check_tensor``, a
    ``torch.as_tensor`` of a tensor already of the asked type and device,
    the allocations a wrapper makes, and the ``ctypes`` call of a small
    launch;
  * ``wrappers``: ``chip_smoke.time_wrappers``' cases (host µs a call of
    each wrapper on the single-query path at CS's smallest index, the
    bitmap pair on 125,000-word bitmaps: path j's length) at
    ``chip_smoke``'s SemMedDB scale;
  * ``bitmaps``: the bitmap kernels by CUDA events at path j's 125,000
    words and at 2^26 words (the popcount at 2^26 - 1), beside
    ``torch.bitwise_and``, and the popcount's device operations a call by
    the profiler;
  * ``variants``: the AND's other schedules (``scripts/csrc/bitmap_variants.cu``:
    one wave with and without evict-first hints, a CTA a chunk with and
    without them, a TMA bulk-copy ring) beside the package's kernel and
    ``torch.bitwise_and``, each checked equal to ``torch.bitwise_and`` and
    timed by CUDA events (an output allocated a call, as the wrapper does),
    in two rounds of opposite order, at path j's 125,000 words and at 2^26;
  * ``threshold``: ``chip_smoke.time_list_threshold`` at its full PubMed
    scale;
  * ``queries``: the nine queries of ``chip_smoke.py`` at its full scale,
    median wall of 20 runs under six settings in turns, and a ``cProfile`` of
    CS and FAD under the defaults and the dense path (the functions with the
    most own time, µs a call).

With ``--parent DIR`` (a checkout unpacked by ``git archive`` into a
git-ignored directory such as ``_archive/``) every part runs in child
processes in turns, the checkout's package first on the path in one and
this tree's in the other: parent, this, this, parent. Each side builds and
calls its own wrappers and kernels. Prints the card's name and power limit
first; writes ``launch_probe.json`` into the output directory ``chip_smoke.py``
writes to.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PARTS = ("micro", "wrappers", "bitmaps", "variants", "threshold", "queries")
CALLS = 1000
PROFILED_CALLS = 200
QUERY_REPS = 20
PROFILE_CALLS = 300
SETTINGS = {"defaults": ("auto", "auto", "auto"), "dense": ("dense", "off", "off"),
            "auto_off_off": ("auto", "off", "off"), "auto_auto_off": ("auto", "auto", "off"),
            "auto_off_auto": ("auto", "off", "auto"), "dense_auto_off": ("dense", "auto", "off")}


def sync():
    import torch

    torch.cuda.synchronize()


def smoke():
    """``chip_smoke`` of this tree (its helpers call the package first on
    the path: the side's own)."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    return chip_smoke


def host_us(fn, calls: int = CALLS) -> dict:
    return smoke().host_us(fn, calls)


_DATA: dict = {}


def data(dev, pubmed: bool):
    """The SemMedDB graph at ``chip_smoke``'s scale (and PubMed's with
    ``pubmed``), dense and ``"auto"`` storage, built once a process."""
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase
    from repro_torch.data import synth_graph as SG

    C = smoke()
    todo = [("sem", SG.make_semmeddb, C.SEMMED)] + (
        [("pub", SG.make_pubmed, C.PUBMED)] if pubmed else [])
    for k, make, kw in todo:
        if k in _DATA:
            continue
        schema = make(**kw)
        dense = GQFastDatabase(schema, account_space=False, keep_packed=True, device=dev,
                               device_encodings="dense")
        auto = GQFastDatabase.from_parts(schema, dense.host_indexes, X.build_device_db(
            schema, dense.host_indexes, "auto", device=dev))
        _DATA[k] = (schema, dense, auto)
    return _DATA


def event_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    sync()
    return a.elapsed_time(b) / reps


def part_micro(dev) -> dict:
    import torch

    from repro_torch.kernels import bitmap_ops as bm
    from repro_torch.kernels.cuda_build import check_tensor

    t = torch.zeros(16, dtype=torch.int32, device=dev)
    a, b, out = (torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(3))
    lib = bm.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    z = torch.zeros((), dtype=torch.int64, device=dev)

    def switch():
        with torch.cuda.device(dev):
            pass

    cases = {
        "torch.cuda.device switch": switch,
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "_cuda_getDevice": torch._C._cuda_getDevice,
        "torch.cuda.current_device": torch.cuda.current_device,
        "tensor.device": lambda: t.device,
        "tensor.get_device": t.get_device,
        "check_tensor": lambda: check_tensor(t, "t", torch.int32, dev),
        "as_tensor(t, dtype, device)": lambda: torch.as_tensor(t, dtype=torch.int32, device=dev),
        "torch.full(65536)": lambda: torch.full((65536,), 0.0, dtype=torch.float32, device=dev),
        "torch.empty(65536)": lambda: torch.empty(65536, dtype=torch.float32, device=dev),
        "torch.empty(65537).split((65536, 1))": lambda: torch.empty(
            65537, dtype=torch.int32, device=dev).split((65536, 1)),
        "t.new_empty(65536)": lambda: t.new_empty(65536),
        "torch.zeros(()) int64": lambda: torch.zeros((), dtype=torch.int64, device=dev),
        "0-d .to(int32)": lambda: z.to(torch.int32),
        "data_ptr": t.data_ptr,
        "ctypes bitmap_and_launch (4 words)": lambda: lib.bitmap_and_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), 4, stream),
    }
    return {"rows": {k: host_us(fn, 5000) for k, fn in cases.items()}}


def part_wrappers(dev) -> dict:
    import torch

    C = smoke()
    _, dense, auto = data(dev, False)["sem"]
    key, di, ddi = C.smallest_index(auto, dense)
    gen = torch.Generator(device=dev).manual_seed(3)
    masks = tuple(torch.randint(-2**31, 2**31, (125_000,), dtype=torch.int32, generator=gen,
                                device=dev) for _ in range(2))
    return {"index": f"I_{key[0]}.{key[1]}",
            "rows": {k: host_us(fn) for k, fn in C.wrapper_cases(di, ddi, masks, dev).items()}}


def part_variants(dev) -> dict:
    import torch

    from repro_torch.kernels import bitmap_ops as bm
    from repro_torch.kernels import cuda_build

    lib = cuda_build.CudaLibrary(
        "bitmap_variants", {"bitmap_and_variant_launch": [cuda_build.I32, cuda_build.P,
                                                          cuda_build.P, cuda_build.P,
                                                          cuda_build.I64, cuda_build.P]},
        source=ROOT / "scripts" / "csrc" / "bitmap_variants.cu")
    cuda_build.LIBRARIES.remove(lib)
    try:  # a variant that does not build is a result of the probe, not its end
        fn = lib.load().bitmap_and_variant_launch
    except RuntimeError as e:
        return {"build_error": str(e)[-4000:]}
    out = {"ptxas": [ln.strip() for ln in (lib.build_log or "").splitlines()
                     if "registers" in ln or "spill" in ln]}
    gen = torch.Generator(device=dev).manual_seed(27)
    for label, n in (("path j", 125_000), ("2^26", 2**26)):
        a, b = (torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, generator=gen, device=dev)
                for _ in range(2))
        want = torch.bitwise_and(a, b)

        def variant(v, a=a, b=b, n=n):
            o = torch.empty(n, dtype=torch.int32, device=dev)
            cuda_build.launch(fn, f"bitmap_and variant {v}", dev, v, a.data_ptr(), b.data_ptr(),
                              o.data_ptr(), n, cuda_build.stream_of(dev))
            return o

        calls = {f"variant {v}": (lambda v=v: variant(v)) for v in range(5)}
        calls["package"] = lambda a=a, b=b: bm.bitmap_and(a, b)
        calls["torch.bitwise_and"] = lambda a=a, b=b: torch.bitwise_and(a, b)
        for k, call in calls.items():
            if not torch.equal(call(), want):
                raise AssertionError(f"bitmap_and {k} at {n} words differs from torch.bitwise_and")
        times = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                times[k].append(event_ms(calls[k]))
        out[label] = {"words": n, "ms": times}
        print(f"  variants {label}: " + ", ".join(
            f"{k} {min(v):.4f}-{max(v):.4f}" for k, v in times.items()), flush=True)
        del a, b, want
    return out


def part_threshold(dev) -> dict:
    rows, measured = smoke().time_list_threshold(data(dev, True)["pub"][2], dev)
    return {"rows": rows, "measured": measured}


def part_bitmaps(dev) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bitmap_ops as bm

    gen = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for label, n in (("path j", 125_000), ("2^26", 2**26)):
        a, b = (torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, generator=gen, device=dev)
                for _ in range(2))
        out[f"bitmap_and {label}"] = {
            "words": n, "ms": event_ms(lambda: bm.bitmap_and(a, b)),
            "library_ms": event_ms(lambda: torch.bitwise_and(a, b))}
        a, b = a[:bm.MAX_POPCOUNT_WORDS], b[:bm.MAX_POPCOUNT_WORDS]
        pc = lambda: bm.bitmap_and_popcount(a, b)  # noqa: E731
        pc()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                pc()
            sync()
        ops = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        out[f"bitmap_and_popcount {label}"] = {"words": int(a.shape[0]), "ms": event_ms(pc),
                                               "device_ops_a_call": ops / 10}
        del a, b
    return out


def part_queries(dev) -> dict:
    import cProfile
    import pstats
    import statistics

    from repro_torch.core.engine import GQFastEngine
    from repro_torch.data import synth_graph as SG

    C = smoke()
    d = data(dev, True)
    sem = d["sem"][0]
    engines = {st: {k: GQFastEngine(d[k][i]) for k in ("pub", "sem")}
               for st, i in (("dense", 1), ("auto", 2))}
    c0 = C.busy_concept(sem)
    walls, prof = {}, {}
    labels = list(SETTINGS)
    for name, q, params in C.cases(SG, c0, nine=True):
        g = "sem" if name == "CS" else "pub"
        pqs = {lb: engines[st][g].prepare(q, block_skipping=bs, fusion=fu)
               for lb, (st, bs, fu) in SETTINGS.items()}
        for pq in pqs.values():
            pq(**params)
        ts = {lb: [] for lb in labels}
        for i in range(QUERY_REPS):
            for lb in labels[i % len(labels):] + labels[:i % len(labels)]:
                t0 = time.perf_counter()
                pqs[lb](**params)
                ts[lb].append((time.perf_counter() - t0) * 1e3)
        walls[name] = {lb: statistics.median(v) for lb, v in ts.items()}
        print(f"  {name:10s} " + ", ".join(f"{lb} {v:.4f}" for lb, v in walls[name].items()),
              flush=True)
        if name in ("CS", "FAD"):
            for lb in ("defaults", "dense"):
                p = cProfile.Profile()
                p.enable()
                for _ in range(PROFILE_CALLS):
                    pqs[lb](**params)
                p.disable()
                st = pstats.Stats(p)
                rows = sorted(((v[2], v[3], v[0], f"{Path(k[0]).name}:{k[1]}:{k[2]}")
                               for k, v in st.stats.items()), reverse=True)[:30]
                prof[f"{name} {lb}"] = [
                    {"fn": f, "tottime_us_a_run": tt / PROFILE_CALLS * 1e6,
                     "cumtime_us_a_run": ct / PROFILE_CALLS * 1e6, "calls_a_run": nc / PROFILE_CALLS}
                    for tt, ct, nc, f in rows]
    return {"walls_ms": walls, "cprofile": prof}


def side(parts) -> dict:
    import torch

    dev = torch.device("cuda", 0)
    from repro_torch.kernels.cuda_build import build_all

    t0 = time.perf_counter()
    libs = build_all()
    out = {"build_s": time.perf_counter() - t0}
    for lib in libs:
        if lib.name == "bitmap_ops":
            for line in (lib.build_log or "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas bitmap_ops: {line.strip()}", flush=True)
    for p in parts:
        out[p] = globals()[f"part_{p}"](dev)
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def run_side(src: Path, parts) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", str(src),
                           *parts], env=env, capture_output=True, text=True, timeout=1500)
    sys.stdout.write("".join(proc.stdout.splitlines(keepends=True)[:-1])[-20000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-20000:])
        raise RuntimeError(f"side {src} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--side"]:
        sys.path.insert(0, args[1])
        print(json.dumps(side(args[2:])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 2
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    parts = [p for p in args if p in PARTS] or list(PARTS)
    print(card_line(), flush=True)
    record = {"card": card_line(), "parts": parts, "parent": str(parent) if parent else None,
              "turns": []}
    order = [("this", ROOT / "src")] if parent is None else [
        ("parent", parent / "src"), ("this", ROOT / "src"), ("this", ROOT / "src"),
        ("parent", parent / "src")]
    for who, src in order:
        print(f"== {who} ({src})", flush=True)
        res = run_side(src, parts)
        record["turns"].append({"side": who, **res})
        for p in ("micro", "wrappers"):
            for k, v in res.get(p, {}).get("rows", {}).items():
                print(f"  {who:6s} {p:8s} {k:50s} {v['us']:8.2f} us (with drain"
                      f" {v['us_with_drain']:8.2f}, profiler {v['profiler_cpu_us']:8.2f})",
                      flush=True)
        for k, v in res.get("bitmaps", {}).items():
            print(f"  {who:6s} {k:28s} {json.dumps(v)}", flush=True)
        for k, rows in res.get("queries", {}).get("cprofile", {}).items():
            print(f"  {who:6s} cProfile {k}:", flush=True)
            for r in rows[:20]:
                print(f"      {r['tottime_us_a_run']:8.2f} us own, {r['cumtime_us_a_run']:8.2f}"
                      f" cum, {r['calls_a_run']:5.1f} calls  {r['fn']}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "launch_probe.json").write_text(json.dumps(record, indent=1))
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
