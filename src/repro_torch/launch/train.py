"""Training launcher of the PyTorch port: --arch <id> at the arch's smoke
config through the fault-tolerant loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50 --device cpu

The JAX package's launcher (``repro.launch.train``) with the same data
(LM: ``lm_batch(step, 8, 64, vocab, seed=0)``; GNN: four
``make_molecule_batch(8, 10, 24, seed=s)`` batches in turn; DIN:
``make_din_batch(64, seed=step % 8)``), loss, optimizer (AdamW, lr 1e-3)
and checkpoint cadence (every ``max(10, steps // 4)`` steps, and a final
one) into ``<ckpt-dir>/<arch>``; ``--resume`` continues from the latest
checkpoint there. ``--device`` is the port's own (default ``cuda``: without
a card the launcher refuses to start unless ``--device cpu`` is given). The
dry run of a cell on a production mesh is ``python -m
repro_torch.launch.dryrun``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..core.engine import resolve_device
from ..robust.errors import ValidationError


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (default cuda; without a card "
                         "the launcher refuses to start unless --device cpu is given)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None):
    """Train ``--arch`` for ``--steps`` steps; returns the loop's
    ``TrainResult``. A device that is not there, or an arch the port does not
    train yet, ends the program with the typed error's message."""
    args = parse_args(argv)
    from ..configs.registry import get_arch

    try:
        device = resolve_device(args.device)
        arch = get_arch(args.arch)
    except ValidationError as e:
        raise SystemExit(f"train: {e}") from e
    if arch.kind not in ("lm", "gnn", "recsys"):
        raise SystemExit(f"{args.arch} is a serving workload; use repro_torch.launch.serve")

    import torch

    from ..optim.adamw import AdamWConfig
    from ..train.loop import TrainLoopConfig, train

    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=max(10, args.steps // 4),
        ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
    )
    cfg = arch.smoke_cfg
    gen = torch.Generator(device).manual_seed(0)
    if arch.kind == "lm":
        from ..data.lm_data import lm_batch
        from ..models.transformer import init_params, loss_fn

        params, lf = init_params(cfg, gen), (lambda p, b: loss_fn(p, b, cfg))

        def data(s):
            return lm_batch(s, 8, 64, cfg.vocab, seed=0, device=device)
    elif arch.kind == "gnn":
        from ..data.graphs import make_molecule_batch
        from ..models.gnn.models import gnn_init, gnn_loss

        params, lf = gnn_init(cfg, gen), (lambda p, b: gnn_loss(p, b, cfg, 8))
        batches = [make_molecule_batch(8, 10, 24, seed=s, device=device).as_inputs()
                   for s in range(4)]

        def data(s):
            return batches[s % 4]
    else:
        from ..data.recsys import make_din_batch
        from ..models.din import din_init, din_loss

        params, lf = din_init(cfg, gen), (lambda p, b: din_loss(p, b, cfg))

        def data(s):
            return make_din_batch(64, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                  n_users=cfg.n_users, seed=s % 8, device=device)
    _, res = train(params, lf, data, loop_cfg, AdamWConfig(lr=1e-3), resume=args.resume)
    h = res.history
    resumed = f" (resumed from {res.resumed_from})" if res.resumed_from else ""
    if not h:
        print(f"[train] {args.arch}: 0 steps, nothing left before step {args.steps}{resumed}")
        return res
    print(f"[train] {args.arch}: {len(h)} steps, "
          f"loss {h[0]['loss']:.4f} → {h[-1]['loss']:.4f}{resumed}")
    return res


if __name__ == "__main__":
    main()
