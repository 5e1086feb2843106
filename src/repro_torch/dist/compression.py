"""Compressed collectives: error-feedback int8 all-reduce (DESIGN.md §6), on
``torch.distributed``.

``compressed_psum`` quantizes the local contribution to int8 with a
per-tensor absmax scale before the all-reduce, and returns the quantization
residual as carry-over *error feedback* (Seide et al. / EF-SGD): adding the
residual into the next step's contribution makes the long-run bias vanish.
The JAX package's ``repro.dist.compression``, step for step; the wire here
carries the dequantized float tensor (one ``all_reduce``), the int8 values
being what a compressed transport would send."""
from __future__ import annotations

import torch


def compressed_psum(grad: torch.Tensor, err: torch.Tensor, group=None):
    """One EF-int8 mean-all-reduce step over ``group`` (the default group
    when None), on every rank of it.

    Returns ``(mean, new_err)``: the mean over the group's ranks of the
    dequantized contributions, and this rank's residual
    ``(grad + err) − dequant`` to feed back next step. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    import torch.distributed as dist

    x = grad + err
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    deq = q * scale
    total = deq.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    # the residual x − q·scale rounded once, as the reference's compiled
    # program computes it (a fused multiply-add): q·scale is exact in float64
    resid = (x.double() - q.double() * scale.double()).to(x.dtype)
    return total / dist.get_world_size(group), resid
