"""Frontier-sparsity metadata: per-block src ranges and active-block lists.

GQ-Fast's selective-query win (paper §4-5) comes from touching only the index
*fragments* reachable from the active sources. The hop kernels scan every
``EDGE_BLOCK``-edge block; this module restores fragment-level selectivity at
block granularity:

  * :func:`block_ranges` — build time (host, numpy): each block's
    ``[src_min, src_max]`` over the CSR-ordered (src-sorted) edge arrays, a
    monotone partition of the CSR offsets. ``build_device_db`` moves it to the
    device once.
  * :func:`active_flags` / :func:`compact_blocks` — per hop, on the device:
    from the frontier's support, mark the blocks whose src range meets it and
    compact their ids into a **fixed-capacity list + count**
    (``block_idx[n_blocks]``, ``n_active[1]``), the tail repeating the last
    active id. Both stay on the device: the active kernels read ``n_active``
    there, so a hop never waits for the host. :func:`active_block_list` is
    the plain version (the CPU path, and the yardstick) of the CUDA kernel
    :mod:`.block_list`, which builds the same list in one launch; the
    dispatch ``ops.active_block_list`` chooses between them.
  * :func:`reach_flags` — a fused region's hop2 flags from hop1's, through
    the fuse-time reach matrix, on the device;
  * :func:`active_block_list_np` — the host twin for a concrete frontier, with
    its capacity bucketed to a power of two (:func:`bucket_capacity`); the
    lists are equal to the reference's for the same frontier.

Skipping gives the scan's result for every combine op: a skipped block's
sources all carry the ⊕-identity, so its contribution is the ⊕-identity.
"""
from __future__ import annotations

import numpy as np
import torch

from .params import EDGE_BLOCK

#: ``block_skipping="auto"``: the active kernels follow the list while at most
#: this fraction of the blocks survives, and take every block in scan order
#: above it. Measured on an H100 80GB HBM3 at 700 W by ``chip_smoke.py``
#: (I_DT.Term, 7,079 blocks): with the list built, following it was no slower
#: than scan order (within 5%) at every active fraction up to 100% — 1.0
#: (the reference's TPU value is 0.25). The list's own cost (one launch of
#: the list kernel) is paid before the choice, whichever way it goes.
SKIP_BLOCK_FRACTION = 1.0


def n_edge_blocks(E: int) -> int:
    """Blocks of EDGE_BLOCK edges covering an E-edge index (≥ 1)."""
    return max(1, -(-E // EDGE_BLOCK))


def block_ranges(src_ids) -> tuple[np.ndarray, np.ndarray]:
    """Per-block ``[src_min, src_max]`` over EDGE_BLOCK-sized blocks of the
    CSR-ordered (src-sorted) edge array. Host/numpy — runs once at
    ``build_device_db`` time. An empty relation gets the 1-entry sentinel
    ``([0], [-1])`` whose range intersects no support."""
    src = np.asarray(src_ids)
    E = src.shape[0]
    if E == 0:
        return np.zeros(1, np.int32), np.full(1, -1, np.int32)
    nb = n_edge_blocks(E)
    starts = np.arange(nb, dtype=np.int64) * EDGE_BLOCK
    ends = np.minimum(starts + EDGE_BLOCK, E) - 1
    return src[starts].astype(np.int32), src[ends].astype(np.int32)


def support_mask(w: torch.Tensor, zero: float) -> torch.Tensor:
    """Nonzero support of a frontier over the source domain: ``w != 0̄`` for
    ``[n_src]``; a batched ``[B, n_src]`` matrix reduces with ∨ over rows."""
    nz = w != zero
    if nz.dim() == 2:
        nz = nz.any(dim=0)
    return nz


def active_flags(support: torch.Tensor, src_min: torch.Tensor,
                 src_max: torch.Tensor) -> torch.Tensor:
    """bool[n_blocks]: does any supported source fall in ``[src_min,
    src_max]``? One exclusive prefix count over the source domain turns each
    block test into two gathers (``index_select`` takes the int32 metadata
    as it is: every hop runs this, and each launch costs host time)."""
    cs = torch.zeros(support.shape[0] + 1, dtype=torch.int32, device=support.device)
    torch.cumsum(support, 0, dtype=torch.int32, out=cs[1:])
    return cs[1:].index_select(0, src_max) > cs.index_select(0, src_min)


def compact_blocks(flags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity compaction: ``(block_idx int32[n_blocks], n_active
    int32[1])`` with the surviving ids first, ascending (a stable sort on
    the inactive flag), and the tail repeating the last active id. The sorted
    flags mark the tail, so no position vector is built. No value leaves the
    device."""
    inactive, order = torch.sort(~flags, stable=True)
    order = order.to(torch.int32)
    n_active = flags.sum(dtype=torch.int32).reshape(1)
    last = order.index_select(0, (n_active - 1).clamp_(min=0))
    return torch.where(inactive, last, order), n_active


def reach_flags(reach: torch.Tensor, flags1: torch.Tensor) -> torch.Tensor:
    """bool[nb2]: the hop2 blocks a fused region's hop1 can reach from its
    active blocks — the OR of the rows of ``reach[nb1, nb2]`` (the fuse-time
    block reachability matrix) where ``flags1`` is set. On the device, with
    no host read."""
    return (reach & flags1[:, None]).any(dim=0)


def active_block_list(w: torch.Tensor, zero: float, src_min: torch.Tensor,
                      src_max: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Frontier → ``(block_idx[n_blocks], n_active[1])``, on w's device."""
    return compact_blocks(active_flags(support_mask(w, zero), src_min, src_max))


def bucket_capacity(n: int, nb: int) -> int:
    """Smallest power of two ≥ n, capped at nb (and ≥ 1)."""
    if n >= nb:
        return nb
    return max(1, min(nb, 1 << (max(1, n) - 1).bit_length()))


def active_block_list_np(support, src_min, src_max):
    """Host twin of :func:`active_block_list` for a concrete frontier:
    ``(block_idx int32[C], n_active int32[1], active_fraction float)`` with
    ``C = bucket_capacity(n_active, n_blocks)``."""
    sup = np.asarray(support).astype(np.int64)
    cs = np.concatenate([np.zeros(1, np.int64), np.cumsum(sup)])
    flags = cs[np.asarray(src_max) + 1] > cs[np.asarray(src_min)]
    act = np.flatnonzero(flags).astype(np.int32)
    nb = int(flags.shape[0])
    C = bucket_capacity(int(act.shape[0]), nb)
    idx = np.full(C, act[-1] if act.size else 0, np.int32)
    idx[: act.shape[0]] = act
    n_active = np.asarray([act.shape[0]], np.int32)
    return idx, n_active, act.shape[0] / nb
