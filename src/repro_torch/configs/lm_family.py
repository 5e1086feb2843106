"""LM-family arch configs: one class covers the five transformers.

Shapes: train_4k (train_step), prefill_32k (prefill), decode_32k (one token
against a 32k KV cache), long_500k (skipped: all five LM archs are pure full
attention). ``make_cell`` lays a shape out on a production mesh for the dry
run (the JAX package's cells: same shapes, formulas and variants); ``smoke``
runs the reduced config through a train step, prefill and a decode step on
``device``."""
from __future__ import annotations

import dataclasses

import torch

from ..dist.sharding import (
    distribute_tree,
    kv_cache_shardings,
    lm_batch_shardings,
    lm_state_shardings,
    named,
)
from ..models import transformer as T
from ..models.common import MetaGenerator
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..train.loop import value_and_grad
from ..tree import tree_leaves, tree_map
from .base import ArchConfig, Cell

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train", micro=8),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


class LMArch(ArchConfig):
    kind = "lm"
    shape_ids = list(LM_SHAPES)

    def __init__(self, arch_id: str, full: T.TransformerConfig,
                 smoke_cfg: T.TransformerConfig, opt: AdamWConfig | None = None):
        self.arch_id = arch_id
        self.full = full
        self.smoke_cfg = smoke_cfg
        self.opt = opt or AdamWConfig(lr=1e-4)

    def skip_reason(self, shape_id: str) -> str | None:
        if shape_id == "long_500k":
            return ("pure full-attention architecture: 500k-token decode requires "
                    "sub-quadratic attention; skipped per shape directive (DESIGN.md §5)")
        return None

    def make_cell(self, shape_id: str, mesh, variant: str = "") -> Cell:
        sh = LM_SHAPES[shape_id]
        names = tuple(mesh.mesh_dim_names)
        tp = tuple(mesh.shape)[names.index("model")] if "model" in names else 1
        naive = variant == "naive"
        cfg = dataclasses.replace(self.full.pad_heads(tp), seq_shard=not naive)
        S, B, kind = sh["seq"], sh["batch"], sh["kind"]
        micro = 1 if naive else sh.get("micro", 8)  # grad-accum microbatches
        if variant == "micro16":
            micro = 16
        meta = dict(dtype=torch.int32, device="meta")
        params_abs = T.init_params(cfg, MetaGenerator())
        param_sh = lm_state_shardings(params_abs, mesh, cfg.n_kv_heads)

        if kind == "train":
            opt_abs = adamw_init(params_abs, self.opt)
            state_abs = (params_abs, opt_abs)
            batch_abs = {"tokens": torch.empty((B, S), **meta),
                         "labels": torch.empty((B, S), **meta)}

            def constrain_like_params(tree):
                # keep the float32 grad accumulators in the FSDP layout
                return tree_map(lambda g, pl: g.redistribute(mesh, pl), tree, param_sh)

            def fn(state, batch):
                params, opt_state = state
                # microbatch i is rows i, i + micro, …: each rank's rows split
                # into micro parts, so no batch row leaves its rank
                tb = batch["tokens"].reshape(B // micro, micro, S)
                lb = batch["labels"].reshape(B // micro, micro, S)
                gacc, lsum, asum = None, 0.0, 0.0
                for i in range(micro):
                    (_, metrics), g = value_and_grad(
                        lambda p, b: T.loss_fn(p, b, cfg), params,
                        {"tokens": tb[:, i], "labels": lb[:, i]})
                    g = constrain_like_params(tree_map(lambda x: x.float(), g))
                    gacc = g if gacc is None else constrain_like_params(
                        tree_map(torch.add, gacc, g))
                    lsum = lsum + metrics["loss"]
                    asum = asum + metrics["moe_aux"]
                grads = tree_map(lambda g: g / micro, gacc)
                metrics = {"loss": lsum / micro, "moe_aux": asum / micro}
                params, opt_state, om = adamw_update(
                    grads, opt_state, params, self.opt, param_shardings=param_sh)
                return (params, opt_state), {**metrics, **om}

            state_sh = lm_state_shardings(state_abs, mesh, cfg.n_kv_heads)
            batch_sh = lm_batch_shardings(batch_abs, mesh)
            return Cell(self.arch_id, shape_id, fn,
                        (distribute_tree(state_abs, state_sh, mesh),
                         distribute_tree(batch_abs, batch_sh, mesh)),
                        (state_sh, batch_sh), "train",
                        6.0 * cfg.active_param_count() * B * S,
                        notes=f"micro={micro} seq_shard={cfg.seq_shard}")

        if kind == "prefill":
            batch_abs = {"tokens": torch.empty((B, S), **meta)}

            def fn(params, batch):
                logits, cache, _ = T.prefill(params, batch["tokens"], cfg, S)
                return logits, cache

            batch_sh = lm_batch_shardings(batch_abs, mesh)
            return Cell(self.arch_id, shape_id, fn,
                        (distribute_tree(params_abs, param_sh, mesh),
                         distribute_tree(batch_abs, batch_sh, mesh)),
                        (param_sh, batch_sh), "prefill",
                        2.0 * cfg.active_param_count() * B * S)

        # decode: one token at position S - 1, against a KV cache of length S
        cache_abs = T.init_kv_cache(cfg, B, S, "meta")
        tok_abs = torch.empty((B,), **meta)

        def fn(params, cache, tokens, pos):
            return T.decode_step(params, cache, tokens, pos, cfg)

        cache_sh = kv_cache_shardings(cache_abs, mesh, cfg.n_kv_heads)
        tok_sh = lm_batch_shardings({"t": tok_abs}, mesh)["t"]
        return Cell(self.arch_id, shape_id, fn,
                    (distribute_tree(params_abs, param_sh, mesh),
                     distribute_tree(cache_abs, cache_sh, mesh),
                     distribute_tree(tok_abs, tok_sh, mesh), S - 1),
                    (param_sh, cache_sh, tok_sh, named(mesh, ())), "decode",
                    2.0 * cfg.active_param_count() * B)

    def smoke(self, device="cuda") -> dict:
        cfg = self.smoke_cfg
        params = T.init_params(cfg, torch.Generator(device).manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (2, 64), device=device,
                             generator=torch.Generator(device).manual_seed(1))
        batch = {"tokens": toks, "labels": toks}
        opt = adamw_init(params, self.opt)
        (loss, _), grads = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), params, batch)
        params2, _, om = adamw_update(grads, opt, params, self.opt)
        logits, cache, _ = T.prefill(params, toks, cfg, 96)
        dl, _ = T.decode_step(params, cache, torch.argmax(logits, -1), 64, cfg)
        return {
            "loss": float(loss),
            "grad_norm": float(om["grad_norm"]),
            "logits_shape": tuple(dl.shape),
            "finite": bool(torch.isfinite(loss))
            and bool(torch.isfinite(dl).all())
            and all(bool(torch.isfinite(x).all()) for x in tree_leaves(params2)),
        }


def _smoke_of(full: T.TransformerConfig) -> T.TransformerConfig:
    moe = full.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=8, top_k=min(moe.top_k, 2), d_ff_expert=64)
    return dataclasses.replace(
        full, n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=max(1, min(4, 4 * full.n_kv_heads // max(full.n_heads, 1)) or 1),
        d_ff=256, vocab=512, d_head=32, moe=moe, remat=False,
        attn_q_chunk=32, attn_kv_chunk=32,
    )


def make_lm_arch(arch_id: str, full: T.TransformerConfig, **kw) -> LMArch:
    return LMArch(arch_id, full, _smoke_of(full), **kw)
