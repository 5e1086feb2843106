"""IR fusion pass: group adjacent HopOp chains into pipelined regions.

GQ-Fast's execution model is *fully pipelined* — intermediate results never
materialize between operators. The physical IR from :mod:`.lower` is a flat op
list, and the frontier interpreter writes a full ``[n_entity]`` frontier
vector after every HopOp and launches the next hop against it. This pass
rewrites the plan so that adjacent hops (plus any interleaved constant-mask
EntityFilterOps and the trailing GroupOp) become one
:class:`repro_torch.core.lower.FusedHopOp` region, which the frontier
interpreter executes in a single kernel launch
(:mod:`repro_torch.kernels.fragment_spmv_fused`).

Region formation rules (the reference's, DESIGN.md §Pipelined fusion):

  * a region opens at a HopOp and absorbs at most TWO hops (the kernel has two
    hop phases; longer chains become back-to-back regions);
  * EntityFilterOps join only if they are pure constant masks — a ``factor``
    expression or parameter-dependent conditions end the region (their values
    are not known at fuse time);
  * DegreeFilterOp always ends a region (it reads the *pre-hop* frontier);
  * the final GroupOp joins when it immediately follows the region;
  * a region must contain either two hops or one hop plus at least one filter
    (a bare single hop gains nothing from fusion and stays as-is);
  * SeedOp sub-programs (mask seeds) are fused recursively;
  * under ``mode='auto'`` a two-hop region only forms when its reach matrix
    is sparse enough (``REACH_DENSITY_MAX``); ``mode='on'`` fuses
    unconditionally.

For two-hop regions the pass also builds a host-side block-to-block
reachability matrix ``reach[nb1, nb2]``: hop1's edge block ``b1`` reaches
hop2's edge block ``b2`` iff some dst produced by ``b1`` falls inside
``b2``'s ``[src_min, src_max]`` range. At dispatch time hop2's active block
list is the OR of the reach rows of hop1's active blocks — conservative (a
skipped hop2 block provably contributes only the ⊕-identity), so block
skipping composes with fusion without reading the intermediate frontier.
Numpy and IR only: the matrix is built from host arrays (the FragmentIndex
dst column and the few block-range entries), equal bit for bit to the
reference's, and the executor copies it to the device once per prepared
plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels.params import EDGE_BLOCK
from .lower import (
    EntityFilterOp,
    FusedHopOp,
    GroupOp,
    HopOp,
    PhysicalPlan,
    SeedOp,
)

#: 'auto' fuses a two-hop region only when the mean reach density is below
#: this — above it the reach-derived hop2 block list approaches a full scan
#: and the unfused support-planned composition wins (the reference's value;
#: a property of the plan's shape, not of the device).
REACH_DENSITY_MAX = 0.5

#: hop1 blocks per difference-array chunk of :func:`_block_reach` (bounds its
#: host memory at ``8 · 256 · (nb2 + 1)`` bytes).
_REACH_CHUNK = 256


def _pure_mask_filter(op) -> bool:
    return (
        isinstance(op, EntityFilterOp)
        and op.factor is None
        and not op.param_conds
    )


def _host(a) -> np.ndarray:
    """A host numpy view of an index array (a tensor is copied off its
    device; the block ranges are one entry per 4096 edges)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _block_reach(hop1: HopOp, hop2: HopOp):
    """``bool[nb1, nb2]``: which hop2 edge blocks can hop1 block b1 touch.

    hop2's blocks are CSR-ordered, so their ``[src_min, src_max]`` ranges are
    monotone: the blocks containing a given src value form one contiguous run,
    found with two searchsorteds; runs are accumulated per hop1 block with a
    difference array, ``_REACH_CHUNK`` hop1 blocks at a time (one bincount
    each instead of the reference's per-block ``np.add.at``; the same
    matrix). hop1's dst values come from the host index column
    (``HopOp.host_dst``) when the database has one, else from the device
    column, decoded and copied once."""
    if hop2.block_src_min is None or hop2.block_src_max is None:
        return None
    dst1 = _host(hop1.host_dst if hop1.host_dst is not None else hop1.dst_ids)
    smin2 = _host(hop2.block_src_min)
    smax2 = _host(hop2.block_src_max)
    nb2 = int(smin2.shape[0])
    e1 = int(dst1.shape[0])
    nb1 = max(1, -(-e1 // EDGE_BLOCK))
    reach = np.zeros((nb1, nb2), dtype=bool)
    if e1 == 0:
        return reach
    starts = np.searchsorted(smax2, dst1, side="left")
    ends = np.searchsorted(smin2, dst1, side="right")
    width = nb2 + 1
    for c0 in range(0, nb1, _REACH_CHUNK):
        c1 = min(nb1, c0 + _REACH_CHUNK)
        e_lo, e_hi = c0 * EDGE_BLOCK, min(e1, c1 * EDGE_BLOCK)
        row = (np.arange(e_lo, e_hi, dtype=np.int64) // EDGE_BLOCK - c0) * width
        n = (c1 - c0) * width
        diff = (np.bincount(row + starts[e_lo:e_hi], minlength=n)
                - np.bincount(row + ends[e_lo:e_hi], minlength=n))
        reach[c0:c1] = np.cumsum(diff.reshape(c1 - c0, width)[:, :nb2], axis=1) > 0
    return reach


def _form_regions(ops: tuple, mode: str) -> tuple:
    out: list = []
    i = 0
    n = len(ops)
    while i < n:
        op = ops[i]
        if not isinstance(op, HopOp):
            out.append(op)
            i += 1
            continue
        members: list = [op]
        j = i + 1
        while j < n and _pure_mask_filter(ops[j]):
            members.append(ops[j])
            j += 1
        second = None
        if j < n and isinstance(ops[j], HopOp):
            second = ops[j]
            members.append(second)
            j += 1
        if len(members) == 1:  # bare hop: nothing to pipeline
            out.append(op)
            i += 1
            continue
        reach = _block_reach(op, second) if second is not None else None
        if (
            mode == "auto"
            and second is not None
            and (reach is None or reach.mean() > REACH_DENSITY_MAX)
        ):
            # dense (or unknown) reach: the fused hop2 phase would touch
            # ~every block; keep the support-planned unfused composition
            out.append(op)
            i += 1
            continue
        if j < n and isinstance(ops[j], GroupOp) and j == n - 1:
            members.append(ops[j])
            j += 1
        out.append(FusedHopOp(tuple(members), op.dom_dst, reach))
        i = j
    return tuple(out)


def fuse_plan(phys: PhysicalPlan, mode: str = "on") -> PhysicalPlan:
    """Return a plan with fusable op runs collapsed into FusedHopOp regions
    (idempotent; plans with no fusable run come back unchanged). ``mode``:
    'on' fuses every eligible region; 'auto' additionally applies the reach
    density guard (see module docstring)."""
    ops = []
    for op in phys.ops:
        if isinstance(op, SeedOp) and op.programs:
            op = dataclasses.replace(
                op, programs=tuple(fuse_plan(p, mode) for p in op.programs)
            )
        ops.append(op)
    return dataclasses.replace(phys, ops=_form_regions(tuple(ops), mode))


def unfuse_plan(phys: PhysicalPlan) -> PhysicalPlan:
    """Inverse of :func:`fuse_plan`: expand every region back to its member
    ops."""
    ops: list = []
    for op in phys.ops:
        if isinstance(op, SeedOp) and op.programs:
            op = dataclasses.replace(
                op, programs=tuple(unfuse_plan(p) for p in op.programs)
            )
        if isinstance(op, FusedHopOp):
            ops.extend(op.members)
        else:
            ops.append(op)
    return dataclasses.replace(phys, ops=tuple(ops))


def has_fused(phys: PhysicalPlan) -> bool:
    return any(isinstance(op, FusedHopOp) for op in phys.ops) or any(
        isinstance(op, SeedOp) and any(has_fused(p) for p in op.programs)
        for op in phys.ops
    )


def fusion_groups(phys: PhysicalPlan) -> list[str]:
    """One line per fused region, for ``explain()``."""
    groups = []
    for op in phys.ops:
        if isinstance(op, FusedHopOp):
            sigs = dataclasses.replace(phys, ops=op.members).op_signature()
            groups.append(" + ".join(sigs))
    return groups
