"""Train EGNN (or any assigned GNN) on synthetic molecule energies with the
PyTorch port, on the card unless asked for the CPU.

    PYTHONPATH=src python examples/torch_gnn_molecules.py [--arch egnn|schnet|mace|equiformer_v2] [--device cuda|cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.data.graphs import make_molecule_batch
from repro_torch.models.common import count_params
from repro_torch.models.gnn.models import GNNConfig, gnn_init, gnn_loss
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train

CFGS = {
    "egnn": GNNConfig("egnn", "egnn", n_layers=4, d_hidden=64),
    "schnet": GNNConfig("schnet", "schnet", n_layers=3, d_hidden=64, n_rbf=32, cutoff=8.0),
    "mace": GNNConfig("mace", "mace", n_layers=2, d_hidden=32, l_max=2,
                      correlation=3, n_rbf=8, cutoff=6.0),
    "equiformer_v2": GNNConfig("eqv2", "equiformer_v2", n_layers=2, d_hidden=32,
                               l_max=3, m_max=2, n_heads=4, n_rbf=8, cutoff=6.0),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="egnn", choices=list(CFGS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_gnn_ckpt"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = CFGS[args.arch]
    params = gnn_init(cfg, torch.Generator(device).manual_seed(0))
    print(f"{args.arch}: {count_params(params)/1e3:.0f}k params on {device}")

    batches = [make_molecule_batch(batch=16, n_nodes=12, n_edges=32, seed=s,
                                   device=device).as_inputs() for s in range(8)]

    params, res = train(
        params,
        lambda p, b: gnn_loss(p, b, cfg, 16),
        lambda step: batches[step % len(batches)],
        TrainLoopConfig(total_steps=args.steps, ckpt_every=1000, ckpt_dir=args.ckpt_dir),
        AdamWConfig(lr=3e-3, weight_decay=0.0),
        resume=False,
    )
    hist = res.history
    for rec in hist[:: max(1, len(hist) // 8)]:
        print(f"  step {rec['step']:3d} loss {rec['loss']:.4f}")
    print(f"final {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
