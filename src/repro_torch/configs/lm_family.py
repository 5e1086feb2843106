"""LM-family arch configs: one class covers the five transformers.

Shapes: train_4k (train_step), prefill_32k (prefill), decode_32k (one token
against a 32k KV cache), long_500k (skipped: all five LM archs are pure full
attention). ``smoke`` runs the reduced config through a train step, prefill
and a decode step on ``device``."""
from __future__ import annotations

import dataclasses

import torch

from ..models import transformer as T
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..train.loop import value_and_grad
from ..tree import tree_leaves
from .base import ArchConfig

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
