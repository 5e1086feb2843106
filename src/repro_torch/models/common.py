"""Shared model substrate: norms, RoPE, init, losses.

The JAX package's ``shard_hint`` (a sharding constraint on the production
mesh) has no counterpart here yet: the model runs on one device, and the
hint drops out at every call site. It comes with ROADMAP Queue 1 item 15c.
"""
from __future__ import annotations

import math

import torch

from ..tree import tree_leaves


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]. The
    half-split rotation."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [d/2]
    ang = positions[..., None].float() * freqs  # [..., S, d/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in) on ``gen``'s device."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits [..., V] softmaxed in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
