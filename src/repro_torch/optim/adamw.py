"""AdamW with optional int8-quantized moments (8-bit-Adam-style, blockwise
absmax scales), over trees of tensors: the JAX package's optimizer
(``repro.optim.adamw``) on the same state tree ``{"step", "m", "v"}``.

Over a production mesh the params, moments and gradients are DTensors;
``param_shardings`` (a tree of placements matching the params,
``dist.sharding``) lays the moments and the new params out as the params
are, the reference's sharding constraints.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_moments: bool = False  # int8 m/v with blockwise scales
    moment_dtype: torch.dtype = torch.float32  # bf16 halves the moments' bytes


_QBLOCK = 256


def _q8(x: torch.Tensor, sqrt_domain: bool = False) -> dict:
    """Blockwise int8 quantization (256-value blocks, absmax scales). The
    second moment is stored in the sqrt domain to halve its dynamic range,
    the 8-bit-Adam recipe (Dettmers et al.). ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    if sqrt_domain:
        flat = torch.sqrt(torch.clamp_min(flat, 0.0))
    flat = F.pad(flat, (0, (-flat.shape[0]) % _QBLOCK))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = torch.clamp_min(blocks.abs().amax(1), 1e-12) / 127.0
    return {"q": torch.round(blocks / scale[:, None]).to(torch.int8), "s": scale}


def _dq8(q: dict, shape: tuple, sqrt_domain: bool = False) -> torch.Tensor:
    flat = (q["q"].float() * q["s"][:, None]).reshape(-1)
    flat = flat[:math.prod(shape)].reshape(shape)
    return flat * flat if sqrt_domain else flat


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def adamw_init(params, cfg: AdamWConfig) -> dict:
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    if cfg.quantize_moments:
        def zf(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        m = tree_map(lambda p: _q8(zf(p)), params)
        v = tree_map(lambda p: _q8(zf(p), sqrt_domain=True), params)
    else:
        def zeros(p):
            return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

        m, v = tree_map(zeros, params), tree_map(zeros, params)
    return {"step": step, "m": m, "v": v}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def _constrain(tree, param_shardings):
    """``tree``'s DTensor leaves redistributed to ``param_shardings``."""
    if param_shardings is None:
        return tree
    return tree_map(lambda x, pl: x.redistribute(x.device_mesh, pl), tree, param_shardings)


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig, param_shardings=None):
    """One step: clip by global norm, bias correction, decoupled weight
    decay. Returns (new params, new state, {"grad_norm"}); nothing is
    updated in place. ``param_shardings``: an optional tree of DTensor
    placements matching params; the dequantized and new moments and the
    new params are laid out by it (without it, over a mesh, the int8
    moments' blocked reshape leaves them as the reshape's layout)."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)

    is_q = cfg.quantize_moments
    if is_q:
        m_f = _constrain(tree_map(lambda q, g: _dq8(q, g.shape), state["m"], grads,
                                  is_leaf=_is_q8), param_shardings)
        v_f = _constrain(tree_map(lambda q, g: _dq8(q, g.shape, sqrt_domain=True), state["v"],
                                  grads, is_leaf=_is_q8), param_shardings)
    else:
        m_f = tree_map(lambda m: m.float(), state["m"])
        v_f = tree_map(lambda v: v.float(), state["v"])

    m_new = _constrain(tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, m_f, grads),
                       param_shardings)
    v_new = _constrain(tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, v_f, grads),
                       param_shardings)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr

    def upd(p, m, v):
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new_params = _constrain(tree_map(upd, params, m_new, v_new), param_shardings)
    if is_q:
        m_new = tree_map(_q8, m_new)
        v_new = tree_map(lambda v: _q8(v, sqrt_domain=True), v_new)
    else:
        m_new = tree_map(lambda m: m.to(cfg.moment_dtype), m_new)
        v_new = tree_map(lambda v: v.to(cfg.moment_dtype), v_new)
    return new_params, {"step": step, "m": m_new, "v": v_new}, {"grad_norm": gn}


def cosine_warmup(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup, warm, cos)

    return sched
