"""Shared model substrate: norms, RoPE, sharding hints, init, losses.

``shard_hint`` is the JAX package's sharding constraint on DTensor: under
``use_mesh(mesh)`` (the reference's ``jax.set_mesh``) a hint redistributes a
DTensor to the hinted layout, filtered to the mesh as the sharding rules are
(``dist.sharding._filter``). With no current mesh, or on a plain tensor, it
is the identity, so the same model code runs on one device and over a
production mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from ..tree import tree_leaves

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the current mesh of ``shard_hint``
    inside the block (the reference's ``jax.set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _MESH.get()


def shard_hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to ``spec`` (one entry a dim: None,
    an axis name or a tuple of them; missing trailing entries are None),
    dropping the axes the current mesh lacks or that do not divide the dim.
    The identity with no current mesh or when ``x`` is not a DTensor. An
    error is raised, never swallowed: a hint that fails over a mesh is a
    fault to report."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from ..dist.sharding import named

    full = (tuple(spec) + (None,) * x.ndim)[: x.ndim]
    # redistributed even when already so laid out: the backward pass then
    # lays the gradient out as ``x`` was (the reference's constraint holds
    # for the cotangent too)
    return x.redistribute(mesh, named(mesh, full, tuple(x.shape)))


def pin(x: torch.Tensor) -> torch.Tensor:
    """Over a mesh, ``x`` redistributed to its own layout: nothing moves
    forward, and the backward pass lays ``x``'s gradient out as ``x`` is
    (a reshape's backward then finds its gradient splittable). The
    identity otherwise."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    return x.redistribute(mesh, x.placements) if isinstance(x, DTensor) else x


def split_hint(x: torch.Tensor, sizes: tuple, *spec) -> torch.Tensor:
    """``x`` with its last dim split into ``sizes``, laid out as ``spec``
    over the result's dims (filtered as ``shard_hint`` filters). DTensor
    cannot split a dim sharded over more ranks than its first part has
    rows, so over a mesh ``x`` is first redistributed to the layout whose
    last dim carries the first part's axes; then the split keeps it. On
    one device, a reshape."""
    shape = tuple(x.shape[:-1]) + tuple(sizes)
    mesh = _MESH.get()
    if mesh is not None:
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            from ..dist.sharding import _filter, placements

            full = (tuple(spec) + (None,) * len(shape))[: len(shape)]
            kept = _filter(mesh, full, shape)
            flat = kept[: x.ndim]
            return x.redistribute(mesh, placements(mesh, flat)).reshape(shape)
    return x.reshape(shape)


def sharded_zeros(shape: tuple, dtype, device, *spec) -> torch.Tensor:
    """Zeros of ``shape``; over a mesh, a DTensor laid out as ``spec``
    (filtered), each rank allocating only its shard on ``device``."""
    shape = tuple(shape)
    mesh = _MESH.get()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from ..dist.sharding import from_local, local_shape, named

    pl = named(mesh, (tuple(spec) + (None,) * len(shape))[: len(shape)], shape)
    local = torch.zeros(local_shape(mesh, shape, pl), dtype=dtype, device=device)
    return from_local(local, mesh, pl, shape)


class MetaGenerator:
    """Stands for a ``torch.Generator`` where only a tree's shapes and dtypes
    are wanted (a dry run): the init functions draw meta tensors from it,
    which hold no values and allocate nothing."""

    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` on its device
    (a meta tensor from a :class:`MetaGenerator`)."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


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
    w = randn(gen, shape)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits [..., V] softmaxed in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the gathered column keeps its dim until the subtraction: over a mesh a
    # vocab-sharded gather is a masked partial sum, reduced in that shape
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)
    nll = (logz[..., None] - gold)[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
