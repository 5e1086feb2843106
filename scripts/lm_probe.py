#!/usr/bin/env python3
"""Where the transformer family's time goes on the card: Qwen2.5-3B at full
width, one prefill of 4×32 tokens and decode steps into a 128-slot cache
(the reference server's shape), and a float32 value-and-grad of two layers,
each timed first and warm, then the decode step under ``torch.profiler``
(the ops by device time and by host time, the device's busy share).

    python3 scripts/lm_probe.py            # from the repository root, on a card
"""
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.lm_archs import QWEN25_3B
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import value_and_grad

    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)

    def timed(fn, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
        return out

    cfg = dataclasses.replace(QWEN25_3B.full, n_layers=2, compute_dtype=torch.float32)
    p = T.init_params(cfg, torch.Generator(dev).manual_seed(2))
    b = lm_batch(0, 2, 64, cfg.vocab, device=dev)
    for i in range(3):
        timed(lambda: value_and_grad(lambda q, bb: T.loss_fn(q, bb, cfg), p, b),
              f"f32 value_and_grad, 2 layers, 2x64 tokens, call {i}")
    del p

    cfg = QWEN25_3B.full
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 32), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    for i in range(3):
        logits, cache, pos = timed(lambda: T.prefill(params, toks, cfg, 128), f"prefill call {i}")
    cur = torch.argmax(logits, -1)
    for i in range(5):
        logits, cache = timed(lambda: T.decode_step(params, cache, cur, pos + i, cfg),
                              f"decode step {i}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            logits, cache = T.decode_step(params, cache, cur, pos + 5 + i, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # the kernels' own events (an op's row repeats its kernels' time)
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"3 decode steps under the profiler: wall {wall:.2f} ms, device busy"
          f" {dev_us / 1e3:.2f} ms ({dev_us / 1e3 / wall:.3f})")
    print(ka.table(sort_by="self_device_time_total", row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
