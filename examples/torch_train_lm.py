"""Train a small LM for a few hundred steps with the PyTorch port's
fault-tolerant loop (checkpoints, resume, straggler telemetry), on the card
unless asked for the CPU.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--moe] [--device cuda|cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.data.lm_data import lm_batch
from repro_torch.models.common import count_params
from repro_torch.models.transformer import MoEConfig, TransformerConfig, init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, cosine_warmup
from repro_torch.train.loop import TrainLoopConfig, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    moe = MoEConfig(n_experts=8, top_k=2, d_ff_expert=128, dense_residual=False) if args.moe else None
    cfg = TransformerConfig(
        "lm-small", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        d_ff=512, vocab=2048, d_head=32, remat=False, attn_kv_chunk=128, moe=moe,
    )
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    print(f"model: {count_params(params)/1e6:.1f}M params "
          f"({'MoE' if args.moe else 'dense'}) on {device}")

    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir, ckpt_keep=2,
    )
    opt_cfg = AdamWConfig(lr=cosine_warmup(3e-3, 20, args.steps), weight_decay=0.01)

    def data(step: int):
        return lm_batch(step, batch=16, seq=128, vocab=cfg.vocab, seed=42, device=device)

    params, res = train(
        params, lambda p, b: loss_fn(p, b, cfg), data, loop_cfg, opt_cfg, resume=True,
    )
    if res.resumed_from:
        print(f"resumed from checkpoint at step {res.resumed_from}")
    hist = res.history
    for rec in hist[:: max(1, len(hist) // 10)]:
        print(f"  step {rec['step']:4d} loss {rec['loss']:.4f} "
              f"({rec['step_time']*1e3:.0f} ms{' STRAGGLER' if rec['straggler'] else ''})")
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
