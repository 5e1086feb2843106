"""DIN recsys arch config × the four assigned serving/training shapes (the
JAX package's ``repro.configs.din_arch``). ``smoke`` runs the reduced config
through a train step and a retrieval on ``device``; ``make_cell`` (a dry-run
cell on a production mesh) comes with ROADMAP Queue 1 item 15c."""
from __future__ import annotations

import torch

from ..models.din import DINConfig, din_init, din_loss, din_retrieval_scores
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..train.loop import value_and_grad
from ..tree import tree_leaves
from .base import ArchConfig


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


DIN_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, candidates=_pad512(1_000_000), kind="retrieval"),
}


class DINArch(ArchConfig):
    kind = "recsys"
    shape_ids = list(DIN_SHAPES)

    def __init__(self):
        self.arch_id = "din"
        self.full = DINConfig()  # embed_dim 18, seq 100, 80-40 attn, 200-80 mlp
        self.smoke_cfg = DINConfig(n_items=5000, n_users=500, n_cates=50, seq_len=16)
        self.opt = AdamWConfig(lr=1e-3, weight_decay=0.0)

    def smoke(self, device="cuda") -> dict:
        from ..data.recsys import make_din_batch

        cfg = self.smoke_cfg
        params = din_init(cfg, torch.Generator(device).manual_seed(0))
        b = make_din_batch(16, seq_len=cfg.seq_len, n_items=cfg.n_items, n_users=cfg.n_users,
                           device=device)
        opt = adamw_init(params, self.opt)
        (loss, _), grads = value_and_grad(lambda p, bb: din_loss(p, bb, cfg), params, b)
        params2, _, om = adamw_update(grads, opt, params, self.opt)
        rb = make_din_batch(1, seq_len=cfg.seq_len, n_items=cfg.n_items,
                            n_users=cfg.n_users, n_candidates=256, device=device)
        with torch.no_grad():
            scores = din_retrieval_scores(params, rb, cfg)
        return {
            "loss": float(loss),
            "scores_shape": tuple(scores.shape),
            "finite": bool(torch.isfinite(loss)) and bool(torch.isfinite(scores).all())
            and all(bool(torch.isfinite(x).all()) for x in tree_leaves(params2)),
        }


DIN = DINArch()
