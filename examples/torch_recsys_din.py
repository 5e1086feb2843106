"""DIN recsys with the PyTorch port: train on a synthetic click stream, then
run the retrieval shape (one user scored against many candidates), on the
card unless asked for the CPU.

    PYTHONPATH=src python examples/torch_recsys_din.py [--device cuda|cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.data.recsys import make_din_batch
from repro_torch.models.common import count_params
from repro_torch.models.din import DINConfig, din_init, din_loss, din_retrieval_scores
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_din_ckpt"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = DINConfig(n_items=100_000, n_users=10_000, n_cates=1_000, seq_len=50)
    params = din_init(cfg, torch.Generator(device).manual_seed(0))
    print(f"DIN: {count_params(params)/1e6:.1f}M params on {device} (embedding tables dominate)")

    params, res = train(
        params,
        lambda p, b: din_loss(p, b, cfg),
        lambda step: make_din_batch(256, seq_len=50, n_items=cfg.n_items,
                                    n_users=cfg.n_users, seed=step % 16, device=device),
        TrainLoopConfig(total_steps=args.steps, ckpt_every=1000, ckpt_dir=args.ckpt_dir),
        AdamWConfig(lr=3e-3, weight_decay=0.0),
        resume=False,
    )
    hist = res.history
    for rec in hist[::8]:
        print(f"  step {rec['step']:3d} loss {rec['loss']:.4f}")

    # retrieval: 1 user × 100k candidates, scored in chunks of candidates
    rb = make_din_batch(1, seq_len=50, n_items=cfg.n_items, n_users=cfg.n_users,
                        n_candidates=100_000, seed=99, device=device)
    with torch.no_grad():
        din_retrieval_scores(params, rb, cfg)  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        scores = din_retrieval_scores(params, rb, cfg).cpu()
        dt = time.perf_counter() - t0
    top = torch.argsort(-scores)[:5]
    print(f"retrieval: scored 100k candidates in {dt*1e3:.1f} ms "
          f"({1e5/dt/1e6:.1f}M cand/s); top-5 items: {top.tolist()}")


if __name__ == "__main__":
    main()
