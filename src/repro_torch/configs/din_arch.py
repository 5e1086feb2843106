"""DIN recsys arch config × the four assigned serving/training shapes (the
JAX package's ``repro.configs.din_arch``). ``make_cell`` lays a shape out on
a production mesh for the dry run (tables row-sharded over 'model', requests
over (pod, data), candidates over (data, model)); ``smoke`` runs the reduced
config through a train step and a retrieval on ``device``."""
from __future__ import annotations

import torch

from ..dist.sharding import distribute_tree, recsys_batch_shardings, recsys_state_shardings
from ..models.common import MetaGenerator
from ..models.din import DINConfig, din_forward, din_init, din_loss, din_retrieval_scores
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..train.loop import value_and_grad
from ..tree import tree_leaves
from .base import ArchConfig, Cell


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

    def make_cell(self, shape_id: str, mesh, variant: str = "") -> Cell:
        sh = DIN_SHAPES[shape_id]
        cfg = self.full
        B, T = sh["batch"], cfg.seq_len

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        params_abs = din_init(cfg, MetaGenerator())

        def cell(fn, state_abs, batch_abs, kind, flops):
            state_sh = recsys_state_shardings(state_abs, mesh)
            batch_sh = recsys_batch_shardings(batch_abs, mesh)
            return Cell(self.arch_id, shape_id, fn,
                        (distribute_tree(state_abs, state_sh, mesh),
                         distribute_tree(batch_abs, batch_sh, mesh)),
                        (state_sh, batch_sh), kind, flops)

        if sh["kind"] == "train":
            batch_abs = {"user": meta((B,)), "hist_items": meta((B, T)),
                         "hist_mask": meta((B, T), torch.float32), "cand_item": meta((B,)),
                         "label": meta((B,))}

            def fn(state, batch):
                params, opt_state = state
                (_, metrics), grads = value_and_grad(
                    lambda p, b: din_loss(p, b, cfg), params, batch)
                params, opt_state, om = adamw_update(grads, opt_state, params, self.opt)
                return (params, opt_state), {**metrics, **om}

            return cell(fn, (params_abs, adamw_init(params_abs, self.opt)), batch_abs,
                        "train", 6.0 * cfg.active_param_count() * B)

        if sh["kind"] == "serve":
            batch_abs = {"user": meta((B,)), "hist_items": meta((B, T)),
                         "hist_mask": meta((B, T), torch.float32), "cand_item": meta((B,))}

            @torch.no_grad()
            def fn(params, batch):
                return din_forward(params, batch, cfg)

            return cell(fn, params_abs, batch_abs, "serve", 2.0 * cfg.active_param_count() * B)

        NC = sh["candidates"]
        batch_abs = {"user": meta((1,)), "hist_items": meta((1, T)),
                     "hist_mask": meta((1, T), torch.float32), "cand_items": meta((NC,))}

        @torch.no_grad()
        def fn(params, batch):
            return din_retrieval_scores(params, batch, cfg)

        return cell(fn, params_abs, batch_abs, "serve", 2.0 * cfg.active_param_count() * NC)

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
