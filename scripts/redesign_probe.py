#!/usr/bin/env python3
"""The list kernel, CRC-32C and the transformer's attention on one NVIDIA GPU,
against another checkout's, each side in its own process, in turns.

    python3 scripts/redesign_probe.py [--parent DIR] [parts]   # repository root, on a card

Parts (default: all of them):

  * ``list``: ``block_list.block_list`` on the PubMed cell of ``chip_smoke.py``
    (its ``PUBMED`` scale, the default storage) at SD's real frontiers — hop
    1 on I_DT.Doc from document 5 alone, hop 2 on I_DT.Term from hop 1's
    output — and with every source live on both: ms a call by CUDA events
    over back-to-back calls, device ms and operations a call by the
    profiler, ``chip_smoke.list_bound`` beside them, the lists held equal to
    the plain list;
  * ``crc``: ``chip_smoke.time_crc`` on the same store (I_DT.Term's packed
    words, every encoded part, every decoded view, the whole store), each
    part's value held to the plain version's; on this tree also the two
    measurement builds of ``csrc/crc32c.cu`` (``-DCRC32C_SHARED_TABLES``:
    entry e read from the copy in bank e mod 32, a plain table's bank
    conflicts; ``-DCRC32C_NO_STEP``: no carry) on I_DT.Term's words and the
    whole store's encoded parts; and the device time of one pass over the
    store by the profiler;
  * ``attention``: ``models.transformer.chunked_attention``, forward and
    backward, at path q's train shape (Qwen2.5-3B: B = 2, 512 tokens, 16
    heads, 2 KV heads, 128 wide, bf16, causal) and with 4 KV chunks of 128,
    ms by CUDA events, and the device time by kernel from the profiler;
  * ``train``: ``chip_smoke.time_lm_train`` (path q3's train step: Qwen2.5-3B
    at full width cut to 2 layers, 2 × 512 tokens, AdamW), then one step
    under the profiler (device time by kernel, busy share).

With ``--parent DIR`` (a checkout unpacked by ``git archive`` into a
git-ignored directory such as ``_archive/``) every part runs in child
processes in turns: parent, this, this, parent, each with its own package
and kernels. Prints the card's name and power limit first and last; writes
``redesign_probe.json`` into ``chiprun_out/``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PARTS = ("list", "crc", "attention", "train")
REPS = 50
ATTN = dict(B=2, S=512, H=16, Hkv=2, hd=128)


def smoke():
    """``chip_smoke`` of this tree (its helpers call the package first on
    the path: the side's own)."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    return chip_smoke


_DB: dict = {}


def pubmed(dev):
    """The PubMed cell at chip_smoke's scale in the default storage, built
    once a process."""
    if "db" not in _DB:
        from repro_torch.core.engine import GQFastDatabase
        from repro_torch.data import synth_graph as SG

        t0 = time.perf_counter()
        _DB["db"] = GQFastDatabase(SG.make_pubmed(**smoke().PUBMED), device=dev)
        print(f"  PubMed built in {time.perf_counter() - t0:.1f} s", flush=True)
    return _DB["db"]


def top_kernels(prof, calls: int, n: int = 12) -> list[dict]:
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    return [{"kernel": k[:120], "ms_a_call": t / 1e3 / calls, "launches_a_call": c / calls}
            for t, c, k in rows[:n]]


def part_list(dev) -> dict:
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import block_list as lk
    from repro_torch.kernels import ops as K

    C = smoke()
    db = pubmed(dev)
    doc, term = db.device.index("DT", "Doc"), db.device.index("DT", "Term")
    n_docs = doc.indptr.shape[0] - 1
    w1 = torch.zeros(n_docs, dtype=torch.float32, device=dev)
    w1[5] = 1.0  # SD's d0
    # hop 1's output over the terms: its support is hop 2's frontier's
    w2 = K.fragment_spmv_packed(w1, doc.src_ids, doc.dst_col.words,
                                n_dst=term.indptr.shape[0] - 1, dst_width=doc.dst_col.width,
                                blocks=(doc.block_src_min, doc.block_src_max),
                                block_skipping="on", hot_share=doc.hot_share)
    out = {}
    for label, di, w in (("SD hop 1, I_DT.Doc from document 5", doc, w1),
                         ("SD hop 2, I_DT.Term from hop 1", term, w2),
                         ("I_DT.Doc, every source", doc, torch.ones_like(w1)),
                         ("I_DT.Term, every source", term, torch.ones_like(w2))):
        blocks = (di.block_src_min, di.block_src_max)
        want = active.active_block_list(w, 0.0, *blocks)
        bi, na = lk.block_list(w, 0.0, *blocks)
        C.sync()
        if not (torch.equal(bi, want[0]) and torch.equal(na, want[1])):
            raise AssertionError(f"list {label}: the kernel's list differs from the plain list")
        call = lambda w=w, blocks=blocks: lk.block_list(w, 0.0, *blocks)  # noqa: E731
        busy, ops = C.device_busy(call)
        b, by = C.list_bound(w, 0.0, *blocks)
        out[label] = {"n_blocks": int(blocks[0].shape[0]), "n_active": int(na[0]),
                      "ms": C.time_device_ms(call, REPS), "device_ms": busy,
                      "device_ops": ops, "bound_ms": b, "bound_by": by,
                      "plain_ms": C.time_device_ms(
                          lambda w=w, blocks=blocks: active.active_block_list(w, 0.0, *blocks),
                          REPS)}
        r = out[label]
        print(f"  list {label}: {r['n_active']}/{r['n_blocks']} listed, {r['ms']:.4f} ms a call"
              f" ({r['device_ms']:.4f} device, {r['device_ops']:.1f} ops), bound"
              f" {r['bound_ms']:.6f} ({by}), plain {r['plain_ms']:.4f}", flush=True)
    return out


def part_crc(dev, this: bool) -> dict:
    import torch

    from repro_torch.kernels import crc32c as ck
    from repro_torch.kernels import cuda_build, ref

    C = smoke()
    db = pubmed(dev)
    parts = [(label, ck.as_bytes(t)) for label, t in C.crc_parts(db)]
    for label, b in parts:
        if int(ck.crc32c(b)) != int(ref.crc32c_ref(b)):
            raise AssertionError(f"crc32c {label}: the kernel differs from the plain version")
    out = {"rows": C.time_crc(db, dev)}
    # the device's own time for one pass over every part (the event times of
    # the small parts are the host's enqueue)
    out["store_device_ms"], out["store_device_ops"] = C.device_busy(
        lambda: [ck.crc32c(b) for _, b in parts])
    print(f"  crc32c the whole store, {len(parts)} parts: device {out['store_device_ms']:.4f} ms"
          f" ({out['store_device_ops']:.1f} ops)", flush=True)
    if not this:
        return out
    encoded = [b for label, b in parts if "encoded" in label]
    big = max(encoded, key=lambda b: b.shape[0])
    reps = C.KERNEL_REPS

    def timed(call) -> dict:
        return {"big_ms": C.time_device_ms(lambda: call(big), reps),
                "encoded_ms": sum(C.time_device_ms(lambda b=b: call(b), reps) for b in encoded)}

    variants = {"package": timed(ck.crc32c)}
    for define in ("CRC32C_SHARED_TABLES", "CRC32C_NO_STEP"):
        lib = cuda_build.CudaLibrary(
            "crc32c", {"crc32c_launch": ck.LIB.functions["crc32c_launch"]}, defines=(define,))
        cuda_build.LIBRARIES.remove(lib)
        fn = lib.load().crc32c_launch

        def call(b, fn=fn):
            o = torch.empty((), dtype=torch.int64, device=dev)
            stream = cuda_build.stream_of(dev)
            scratch = cuda_build.stream_scratch("crc32c", 2, torch.int32, dev, stream)
            cuda_build.launch(fn, "crc32c variant", dev, b.data_ptr(), b.shape[0], 0,
                              scratch.data_ptr(), o.data_ptr(), stream)
            return o

        if define == "CRC32C_SHARED_TABLES" and int(call(big)) != int(ck.crc32c(big)):
            raise AssertionError("crc32c with shared tables gives another value")
        variants[define] = timed(call)
        variants[define]["ptxas"] = [ln.strip() for ln in (lib.build_log or "").splitlines()
                                     if "registers" in ln or "spill" in ln]
        v, base = variants[define], variants["package"]
        print(f"  crc32c -D{define}: I_DT.Term words {v['big_ms']:.4f} ms (package"
              f" {base['big_ms']:.4f}), encoded parts {v['encoded_ms']:.4f} ms (package"
              f" {base['encoded_ms']:.4f}); {v['ptxas']}", flush=True)
    out["variants"] = variants
    return out


def part_attention(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    C = smoke()
    B, S, H, Hkv, hd = (ATTN[k] for k in ("B", "S", "H", "Hkv", "hd"))
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device=dev, dtype=torch.bfloat16)
               for h in (H, Hkv, Hkv))
    g = torch.randn((B, S, H, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    out = {}
    for chunk in (2048, 128):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]

        def fwd(ts=ts, chunk=chunk):
            return T.chunked_attention(*ts, causal=True, kv_chunk=chunk)

        def fwd_bwd(ts=ts, chunk=chunk):
            fwd(ts, chunk).backward(g)

        fwd_bwd()
        C.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd_bwd()
            C.sync()
        with torch.no_grad():
            f_ms = C.time_device_ms(fwd, REPS)
        from torch.autograd import DeviceType

        ka = prof.key_averages()
        row = {"fwd_ms": f_ms, "fwd_bwd_ms": C.time_device_ms(fwd_bwd, REPS),
               "device_ms": sum(e.self_device_time_total for e in ka
                                if e.device_type == DeviceType.CUDA) / 1e3 / 5,
               "aten_ops": sum(e.count for e in ka if e.device_type == DeviceType.CPU
                               and e.key.startswith("aten::")) / 5,
               "kernels": top_kernels(prof, 5)}
        out[f"kv_chunk {min(chunk, S)}"] = row
        print(f"  attention kv_chunk {min(chunk, S)}: forward {row['fwd_ms']:.4f} ms,"
              f" forward+backward {row['fwd_bwd_ms']:.4f} ms (device {row['device_ms']:.4f},"
              f" {row['aten_ops']:.0f} aten ops); top: " + "; ".join(
                  f"{r['kernel'][:60]} {r['ms_a_call']:.4f}" for r in row["kernels"][:6]),
              flush=True)
    return out


def part_train(dev, card: str) -> dict:
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.lm_archs import QWEN25_3B
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import make_train_step

    C = smoke()
    rec = C.time_lm_train(card, dev)
    model = dataclasses.replace(QWEN25_3B.full, n_layers=C.LM_TRAIN_LAYERS)
    params = T.init_params(model, torch.Generator(dev).manual_seed(4))
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, model), opt)
    batch = lm_batch(0, *C.LM_TRAIN_BATCH, model.vocab, seed=0, device=dev)
    params, state, _ = step(params, state, batch)
    C.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            params, state, _ = step(params, state, batch)
        C.sync()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    ka = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e3 / 2
    # the host's work: the aten ops a step dispatches, and their own CPU time
    cpu = [e for e in ka if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    aten = sum(e.count for e in cpu) / 2
    cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    rec.update({"profiled_wall_ms": wall, "device_busy_ms": busy, "aten_ops_a_step": aten,
                "aten_self_cpu_ms_a_step": sum(e.self_cpu_time_total for e in cpu) / 1e3 / 2,
                "top_cpu": [{"op": e.key, "calls_a_step": e.count / 2,
                             "self_cpu_ms_a_step": e.self_cpu_time_total / 1e3 / 2}
                            for e in cpu[:10]],
                "kernels": top_kernels(prof, 2, 15)})
    print(f"  train step {rec['step_ms']:.2f} ms median; profiled {wall:.2f} ms wall, device"
          f" {busy:.2f} ms, {aten:.0f} aten ops; top: " + "; ".join(
              f"{r['kernel'][:50]} {r['ms_a_call']:.3f}" for r in rec["kernels"][:8]),
          flush=True)
    return rec


def side(parts, this: bool) -> dict:
    import torch

    from repro_torch.kernels import block_list, crc32c
    from repro_torch.kernels.cuda_build import build_all

    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    libs = build_all([block_list.LIB, crc32c.LIB])
    out = {"build_s": time.perf_counter() - t0,
           "ptxas": {lib.name: [ln.strip() for ln in (lib.build_log or "").splitlines()
                                if "registers" in ln or "spill" in ln] for lib in libs}}
    for p in parts:
        if p == "crc":
            out[p] = part_crc(dev, this)
        elif p == "train":
            out[p] = part_train(dev, card)
        else:
            out[p] = globals()[f"part_{p}"](dev)
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def run_side(src: Path, parts, this: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", str(src),
                           "this" if this else "parent", *parts], env=env,
                          capture_output=True, text=True, timeout=1800)
    sys.stdout.write("".join(proc.stdout.splitlines(keepends=True)[:-1])[-20000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-20000:])
        raise RuntimeError(f"side {src} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--side"]:
        sys.path.insert(0, args[1])
        print(json.dumps(side(args[3:], args[2] == "this")), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("redesign_probe: no CUDA device", file=sys.stderr)
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
    for i, (who, src) in enumerate(order):
        print(f"== {who} ({src})", flush=True)
        # the measurement builds run on this tree's first turn only
        res = run_side(src, parts, who == "this" and i < 2)
        record["turns"].append({"side": who, **res})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "redesign_probe.json").write_text(json.dumps(record, indent=1))
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
