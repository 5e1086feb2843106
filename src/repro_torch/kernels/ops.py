"""Kernel dispatch: the one entry the executor and the storage layer call.

  * CPU tensors take the plain PyTorch versions (:mod:`.ref`);
  * CUDA tensors with ``use_kernel=True`` launch the CUDA kernels
    (:mod:`.fragment_spmv`, :mod:`.fragment_spmv_packed`,
    :mod:`.fragment_spmv_fused`, :mod:`.bitunpack`, :mod:`.bitmap_ops`,
    :mod:`.block_list`, :mod:`.crc32c`, and for a batch of B frontier rows
    :mod:`.fragment_spmm`, :mod:`.fragment_spmm_packed` and the fused
    regions' SpMM form).
    A kernel that fails to build or launch raises: there is no quiet fallback;
  * ``use_kernel=False`` is the explicit plain-version path on any device —
    what the tests and the on-card check compare the kernels with.

Fault sites (:mod:`repro_torch.robust.faults`): the four hop entries and a
fused region that really fuses fire ``ops.<entry>`` whenever the caller asked
for the kernel (``use_kernel=True``), before the dispatch decides where it
runs, so a chaos plan poisons the kernel path on the CPU as on the card.
With no plan active each costs one ContextVar read.

Frontier-sparsity dispatch (:mod:`.active`): the hop entries take
``blocks=(src_min, src_max)`` per-block metadata (device tensors) and a
``block_skipping`` mode ('off' | 'on' | 'auto'). With metadata present and
skipping engaged, the hop builds the active-block list on the device
(:func:`active_block_list`: one launch of :mod:`.block_list` on the card)
and runs the ``*_active`` kernel over it. 'auto' builds the list only on an
index of at least ``params.SKIP_MIN_BLOCKS`` blocks (a choice from the
index's size, made before any launch); past that it never asks the host: the
kernel reads ``n_active`` and takes every block in scan order when more than
``SKIP_BLOCK_FRACTION`` of them survive (the reference's runtime
``lax.cond``). Every choice gives the scan's result.

Pipelined fusion (:func:`fragment_spmv_fused`): a fused region of the plan
runs as one launch of :mod:`.fragment_spmv_fused` — hop1's block list from
the frontier's support, hop2's from the fuse-time reach matrix, both built
on the device, and each hop's table flag from its index's hot share
(:func:`uses_table`), as for the unfused hops. ``fusion`` 'off' (or 'auto' over the scratch budget, or an
empty relation) runs the region as the unfused composition of the hop
kernels instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..robust import faults as _faults
from ..robust.errors import ValidationError
from . import active as _active
from . import bitmap_ops as _bitmaps
from . import bitunpack as _bitunpack
from . import block_list as _block_list
from . import crc32c as _crc32c
from . import fragment_spmm as _dense_rows
from . import fragment_spmm_packed as _packed_rows
from . import fragment_spmv as _dense
from . import fragment_spmv_fused as _fused
from . import fragment_spmv_packed as _packed
from . import params as _params
from . import ref
from .params import FUSED_SCRATCH_BUDGET_BYTES
from .ref import IDENTITY, HopStreams

BLOCK_SKIPPING_MODES = ("off", "on", "auto")
#: 'on' runs every fused region in one launch; 'auto' a two-hop region only
#: while its intermediate (4 · n_mid · B bytes for B rows) fits
#: FUSED_SCRATCH_BUDGET_BYTES; 'off' replays regions hop by hop.
FUSION_MODES = ("off", "on", "auto")


def _as(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, returning ``x``
    itself without a call into PyTorch when it is already such a tensor
    (the executor's ``DeviceIndex`` tensors on every hop). ``device=None``
    keeps a tensor's device and puts anything else on the CPU."""
    if isinstance(x, torch.Tensor) and x.dtype == dtype and (
            device is None or x.device == device):
        return x
    return torch.as_tensor(x, dtype=dtype, device=device)


def _plain(t: torch.Tensor, use_kernel: bool) -> bool:
    """Plain version for CPU tensors or on request; the kernel for CUDA."""
    if not use_kernel or t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValidationError(
        f"no kernel for device {t.device}; use 'cuda' or 'cpu'", device=str(t.device),
    )


def active_block_list(w, zero: float, src_min, src_max, use_kernel: bool = True,
                      flags: bool = False):
    """Frontier (``[n_src]``, or ``[B, n_src]``: the OR of the rows' supports)
    → ``(block_idx[n_blocks], n_active[1])`` on w's device, and with
    ``flags`` each block's test ``bool[n_blocks]`` too. A CUDA frontier takes
    one launch of the list kernel; the plain version (:mod:`.active`, the
    same lists) runs on the CPU or with ``use_kernel=False``."""
    if _plain(w, use_kernel):
        f = _active.active_flags(_active.support_mask(w, zero), src_min, src_max)
        bi, na = _active.compact_blocks(f)
        return (bi, na, f) if flags else (bi, na)
    return _block_list.block_list(w, zero, src_min, src_max, flags=flags)


def _lists(nb: int, block_skipping: str) -> bool:
    """Whether a hop over an ``nb``-block index with block metadata builds
    its list (decided before any launch, from the index's size alone): 'on'
    at every size, so that small shapes exercise the active kernels; 'auto'
    from ``params.SKIP_MIN_BLOCKS`` blocks up (below it the list's launch
    costs more than the blocks it could skip), and never on a 1-block index
    (nothing to skip, as in the reference); 'off' never."""
    if block_skipping == "on":
        return True
    return block_skipping == "auto" and nb > 1 and nb >= _params.SKIP_MIN_BLOCKS


def _check_skipping(block_skipping: str) -> None:
    if block_skipping not in BLOCK_SKIPPING_MODES:
        raise ValidationError(
            f"unknown block_skipping mode {block_skipping!r}",
            block_skipping=block_skipping, valid=BLOCK_SKIPPING_MODES,
        )


def _plan_skip(w, op: str, E: int, blocks, block_skipping: str, use_kernel: bool = True):
    """Scan or skip for one hop, decided without the host seeing the frontier
    (:func:`_lists`). ``None`` → scan; otherwise ``(block_idx, n_active,
    scan_above)``, the device-resident list and the count above which the
    kernel scans."""
    _check_skipping(block_skipping)
    if blocks is None or E == 0:
        return None
    nb = _active.n_edge_blocks(E)
    if not _lists(nb, block_skipping):
        return None
    src_min, src_max = (_as(b, torch.int32, w.device) for b in blocks)
    bi, na = active_block_list(w, IDENTITY[op], src_min, src_max, use_kernel)
    if block_skipping == "on":
        return bi, na, nb
    return bi, na, max(1, int(_active.SKIP_BLOCK_FRACTION * nb))


def _words(a, device=None) -> torch.Tensor:
    """A word stream as the int32 tensor the kernels take (numpy uint32 words
    are reinterpreted, not converted)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, dtype=torch.int32, device=device)


def _hop_streams(src_ids, dst, measure, mdict, dst_width: int, m_mode: str,
                 m_width: int, device) -> HopStreams:
    """A hop's streams as ``device`` tensors of the kernels' types: word
    streams stay words, the measure follows ``m_mode``."""
    s = _as(src_ids, torch.int32, device)
    d = _words(dst, device) if dst_width else _as(dst, torch.int32, device)
    m, md = None, None
    if m_mode == "dense":
        m = _as(measure, torch.float32, device)
    elif m_mode in ("packed", "dict"):
        m = _words(measure, device)
        if m_mode == "dict":
            md = _as(mdict, torch.float32, device)
    elif m_mode != "none":
        raise ValidationError(f"unknown measure mode {m_mode!r}", m_mode=m_mode)
    return HopStreams(s, d, m, md, dst_width, m_mode, m_width)


def bitunpack(words, width: int, count: int, use_kernel: bool = True) -> torch.Tensor:
    """Decode ``count`` ``width``-bit values from a word stream; int32."""
    wt = _words(words)
    if _plain(wt, use_kernel):
        return ref.bitunpack_ref(wt, width, count)
    return _bitunpack.bitunpack(wt, width, count)


def crc32c(data: torch.Tensor, value: int = 0, use_kernel: bool = True) -> torch.Tensor:
    """CRC-32C of the bytes of the contiguous tensor ``data`` continuing from
    ``value``: a 0-d int64 tensor on data's device holding the unsigned
    32-bit value (the CUDA kernel on the card, ``ref.crc32c_ref`` on the CPU
    or with ``use_kernel=False``)."""
    b = _crc32c.as_bytes(data)
    if _plain(b, use_kernel):
        return ref.crc32c_ref(b, value)
    return _crc32c.crc32c(b, value)


def fragment_spmv(weights, src_ids, dst_ids, measures, n_dst: int,
                  op: str = "sum", use_kernel: bool = True,
                  blocks=None, block_skipping: str = "off",
                  hot_share: float = 0.0) -> torch.Tensor:
    """y[dst] ⊕= w[src] ⊗ m. ``measures=None`` means measure 1 on every
    edge. Arrays that are not tensors (numpy, lists) land on the CPU.
    ``hot_share`` (the index's ``DeviceIndex.hot_share``; 0.0: no hot
    destination) chooses the kernel's per-CTA aggregation table
    (:func:`uses_table`)."""
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = _as(weights, torch.float32)
    s = _as(src_ids, torch.int32, w.device)
    d = _as(dst_ids, torch.int32, w.device)
    m = None if measures is None else _as(measures, torch.float32, w.device)
    table = uses_table(hot_share)
    if use_kernel:
        _faults.fire("ops.fragment_spmv", op=op, n_dst=n_dst)
    plain = _plain(w, use_kernel)
    plan = _plan_skip(w, op, s.shape[0], blocks, block_skipping, use_kernel)
    if plan is None:
        if plain:
            return ref.fragment_spmv_ref(w, s, d, m, n_dst, op=op)
        return _dense.fragment_spmv(w, s, d, m, n_dst, op=op, table=table)
    bi, na, scan_above = plan
    if plain:
        return ref.fragment_spmv_active_ref(w, s, d, m, bi, na, n_dst, op=op,
                                            scan_above=scan_above)
    return _dense.fragment_spmv_active(w, s, d, m, bi, na, n_dst, op=op,
                                       scan_above=scan_above, table=table)


def uses_table(hot_share: float) -> bool:
    """Whether a hop (dense or packed, single or batched, alone or in a fused
    region) aggregates per CTA: on an index whose hottest destination takes
    at least ``params.HOP_TABLE_HOT_SHARE`` of its edges
    (``DeviceIndex.hot_share``)."""
    return hot_share >= _params.HOP_TABLE_HOT_SHARE


def fragment_spmv_packed(weights, src_ids, dst, measure=None, mdict=None, *,
                         n_dst: int, dst_width: int = 0, m_mode: str = "none",
                         m_width: int = 0, op: str = "sum",
                         use_kernel: bool = True,
                         blocks=None, block_skipping: str = "off",
                         hot_share: float = 0.0) -> torch.Tensor:
    """Decode-fused hop: ``dst``/``measure`` may be BCA word streams, decoded
    inside the hop (see fragment_spmv_packed.py). ``hot_share`` (the index's
    ``DeviceIndex.hot_share``; 0.0: no hot destination) chooses the kernel's
    per-CTA aggregation table (:func:`uses_table`)."""
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = _as(weights, torch.float32)
    s, d, m, md, *_ = _hop_streams(src_ids, dst, measure, mdict, dst_width, m_mode,
                                   m_width, w.device)
    kw = dict(dst_width=dst_width, m_mode=m_mode, m_width=m_width, op=op)
    table = uses_table(hot_share)
    if use_kernel:
        _faults.fire("ops.fragment_spmv_packed", op=op, n_dst=n_dst)
    plain = _plain(w, use_kernel)
    plan = _plan_skip(w, op, s.shape[0], blocks, block_skipping, use_kernel)
    if plan is None:
        if plain:
            return ref.fragment_spmv_packed_ref(w, s, d, m, md, n_dst, **kw)
        return _packed.fragment_spmv_packed(w, s, d, m, md, n_dst, table=table, **kw)
    bi, na, scan_above = plan
    if plain:
        return ref.fragment_spmv_packed_active_ref(w, s, d, m, md, bi, na, n_dst,
                                                   scan_above=scan_above, **kw)
    return _packed.fragment_spmv_packed_active(w, s, d, m, md, bi, na, n_dst,
                                               scan_above=scan_above, table=table, **kw)


# ---------------------------------------------------------------------------
# Batched hops (fragment_spmm.py, fragment_spmm_packed.py): B frontier rows,
# one pass over the edges; the block list is the union of the rows' supports
# (active.support_mask ORs the rows of a [B, n_src] frontier)
# ---------------------------------------------------------------------------


def _frontier_rows(weights) -> torch.Tensor:
    w = _as(weights, torch.float32)
    if w.dim() != 2:
        raise ValidationError(f"a batched hop takes a [B, n_src] frontier, got shape "
                              f"{tuple(w.shape)}", shape=tuple(w.shape))
    return w


def fragment_spmm(weights, src_ids, dst_ids, measures, n_dst: int,
                  op: str = "sum", use_kernel: bool = True,
                  blocks=None, block_skipping: str = "off",
                  hot_share: float = 0.0) -> torch.Tensor:
    """Batched hop ``Y[b, dst] ⊕= W[b, src] ⊗ m`` with one edge stream for
    all B rows; ``f32[B, n_dst]``. ``measures``: None (measure 1), ``[E]``
    shared by the rows, or ``[B, E]`` per row — the kernel takes both
    streams through a row stride (the reference sends the per-row one to its
    XLA fallback; on the card no plain version runs). ``hot_share`` (the
    index's ``DeviceIndex.hot_share``) chooses the kernel's per-CTA table
    (:func:`uses_table`), as for the single hops."""
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = _frontier_rows(weights)
    s = _as(src_ids, torch.int32, w.device)
    d = _as(dst_ids, torch.int32, w.device)
    m = None if measures is None else _as(measures, torch.float32, w.device)
    table = uses_table(hot_share)
    if use_kernel:
        _faults.fire("ops.fragment_spmm", op=op, n_dst=n_dst)
    plain = _plain(w, use_kernel)
    plan = _plan_skip(w, op, s.shape[0], blocks, block_skipping, use_kernel)
    if plan is None:
        if plain:
            return ref.fragment_spmm_ref(w, s, d, m, n_dst, op=op)
        return _dense_rows.fragment_spmm(w, s, d, m, n_dst, op=op, table=table)
    bi, na, scan_above = plan
    if plain:
        return ref.fragment_spmm_active_ref(w, s, d, m, bi, na, n_dst, op=op,
                                            scan_above=scan_above)
    return _dense_rows.fragment_spmm_active(w, s, d, m, bi, na, n_dst, op=op,
                                            scan_above=scan_above, table=table)


def fragment_spmm_packed(weights, src_ids, dst, measure=None, mdict=None, *,
                         n_dst: int, dst_width: int = 0, m_mode: str = "none",
                         m_width: int = 0, op: str = "sum",
                         use_kernel: bool = True,
                         blocks=None, block_skipping: str = "off",
                         hot_share: float = 0.0) -> torch.Tensor:
    """Decode-fused batched hop: packed dst/measure words decode once an edge
    for all B rows. The measure is shared by the rows. ``hot_share`` chooses
    the kernel's per-CTA table (:func:`uses_table`)."""
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = _frontier_rows(weights)
    s, d, m, md, *_ = _hop_streams(src_ids, dst, measure, mdict, dst_width, m_mode,
                                   m_width, w.device)
    kw = dict(dst_width=dst_width, m_mode=m_mode, m_width=m_width, op=op)
    table = uses_table(hot_share)
    if use_kernel:
        _faults.fire("ops.fragment_spmm_packed", op=op, n_dst=n_dst)
    plain = _plain(w, use_kernel)
    plan = _plan_skip(w, op, s.shape[0], blocks, block_skipping, use_kernel)
    if plan is None:
        if plain:
            return ref.fragment_spmm_packed_ref(w, s, d, m, md, n_dst, **kw)
        return _packed_rows.fragment_spmm_packed(w, s, d, m, md, n_dst, table=table, **kw)
    bi, na, scan_above = plan
    if plain:
        return ref.fragment_spmm_packed_active_ref(w, s, d, m, md, bi, na, n_dst,
                                                   scan_above=scan_above, **kw)
    return _packed_rows.fragment_spmm_packed_active(w, s, d, m, md, bi, na, n_dst,
                                                    scan_above=scan_above, table=table,
                                                    **kw)


# ---------------------------------------------------------------------------
# Pipelined fused regions (fragment_spmv_fused.py)
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class FusedHopOperands:
    """One hop's streams for the fused entry. The frontier is *not* here:
    hop1 reads the caller's ``weights``, hop2 the kernel's scratch. ``reach``
    (hop2 only) is the fuse-time block reachability matrix ``bool[nb1, nb2]``,
    on the device, that derives hop2's active block list from hop1's."""

    src_ids: Any
    dst: Any
    measure: Any = None
    mdict: Any = None
    n_dst: int = 0
    dst_width: int = 0
    m_mode: str = "none"
    m_width: int = 0
    blocks: Any = None  # (src_min, src_max) | None
    reach: Any = None
    # the index's DeviceIndex.hot_share (keyword only, no default: every
    # hop's operands come from an index that has one)
    hot_share: float = field(kw_only=True)


def _streams(h: FusedHopOperands, device) -> HopStreams:
    return _hop_streams(h.src_ids, h.dst, h.measure, h.mdict, h.dst_width, h.m_mode,
                        h.m_width, device)


def _fusion_unfusable(fusion: str, n_mid: int, two_hop: bool = True,
                      batch: int = 1) -> bool:
    """Whether a region runs as the unfused composition. Only the two-hop
    kernel keeps an intermediate (``4 · n_mid · batch`` bytes of scratch for
    ``batch`` frontier rows, as the reference budgets it); the degenerate
    region writes its output directly, so no budget applies."""
    if fusion not in FUSION_MODES:
        raise ValidationError(
            f"unknown fusion mode {fusion!r}", fusion=fusion, valid=FUSION_MODES,
        )
    if fusion == "off":
        return True
    if fusion == "on" or not two_hop:
        return False
    return 4 * n_mid * max(batch, 1) > FUSED_SCRATCH_BUDGET_BYTES


def _full_blocks(nb: int, device):
    return (torch.arange(nb, dtype=torch.int32, device=device),
            torch.full((1,), nb, dtype=torch.int32, device=device))


def _fused_block_lists(w, op: str, h1: FusedHopOperands, h2: FusedHopOperands | None,
                       E1: int, E2: int, block_skipping: str, use_kernel: bool = True):
    """The region's two block lists, built on the device; no value is read
    on the host. hop1's comes from the incoming frontier's support, as in
    the unfused active hops (:func:`active_block_list`, which also gives the
    flags hop2 needs); hop2's is derived WITHOUT reading the
    intermediate, by OR-ing the reach rows of hop1's active blocks
    (:func:`.active.reach_flags` — a conservative superset, so the result is
    the scan's). Skipping off, unavailable or not worth a list on hop1's
    index (:func:`_lists`) passes full lists: one kernel body serves every
    mode."""
    _check_skipping(block_skipping)
    dev = w.device
    nb1 = _active.n_edge_blocks(E1)
    flags1 = None
    if h1.blocks is not None and _lists(nb1, block_skipping):
        smin1, smax1 = (_as(b, torch.int32, dev) for b in h1.blocks)
        lists1 = active_block_list(w, IDENTITY[op], smin1, smax1, use_kernel,
                                   flags=h2 is not None)
        bi1, na1 = lists1[:2]
        flags1 = lists1[2] if h2 is not None else None
    else:
        bi1, na1 = _full_blocks(nb1, dev)
    if h2 is None:
        return bi1, na1, None, None
    nb2 = _active.n_edge_blocks(E2)
    reach = h2.reach
    if flags1 is not None and reach is not None and tuple(reach.shape) == (nb1, nb2):
        reach = torch.as_tensor(reach, dtype=torch.bool, device=dev)
        bi2, na2 = _active.compact_blocks(_active.reach_flags(reach, flags1))
    else:
        bi2, na2 = _full_blocks(nb2, dev)
    return bi1, na1, bi2, na2


def _compose_unfused(w, hop1: FusedHopOperands, hop2: FusedHopOperands | None,
                     mid_mask, mid_binarize: bool, op: str, use_kernel: bool,
                     block_skipping: str) -> torch.Tensor:
    """The member hops through the unfused hop kernels (fusion off, over the
    scratch budget, or an empty relation): the semantics the fused kernels
    must match. A ``[B, n]`` frontier takes the batched hops, the mask
    broadcast over the rows."""
    packed = fragment_spmm_packed if w.dim() == 2 else fragment_spmv_packed

    def hop(x, h):
        return packed(
            x, h.src_ids, h.dst, h.measure, h.mdict, n_dst=h.n_dst,
            dst_width=h.dst_width, m_mode=h.m_mode, m_width=h.m_width, op=op,
            use_kernel=use_kernel, blocks=h.blocks, block_skipping=block_skipping,
            hot_share=h.hot_share,
        )

    u = hop(w, hop1)
    if mid_mask is not None:
        u = ref.apply_mask(u, mid_mask, op)
    if hop2 is None:
        return u
    if mid_binarize:
        u = ref.binarize(u, op)
    return hop(u, hop2)


def fragment_spmv_fused(weights, hop1: FusedHopOperands,
                        hop2: FusedHopOperands | None = None, mid_mask=None, *,
                        op: str = "sum", mid_binarize: bool = False,
                        use_kernel: bool = True, fusion: str = "auto",
                        block_skipping: str = "off") -> torch.Tensor:
    """A pipelined region: hop1 → mask → binarize → hop2 in one kernel
    launch (``hop2=None`` ⇒ the degenerate 1-hop+filter region, whose mask
    applies to the output). Equal to the unfused composition: exactly for
    min/max/bool, within float reordering for sum."""
    return _fused_dispatch(False, weights, hop1, hop2, mid_mask, op=op,
                           mid_binarize=mid_binarize, use_kernel=use_kernel,
                           fusion=fusion, block_skipping=block_skipping)


def fragment_spmm_fused(weights, hop1: FusedHopOperands,
                        hop2: FusedHopOperands | None = None, mid_mask=None, *,
                        op: str = "sum", mid_binarize: bool = False,
                        use_kernel: bool = True, fusion: str = "auto",
                        block_skipping: str = "off") -> torch.Tensor:
    """The batched region: B frontier rows ``[B, n_src]`` through one launch
    of the region's SpMM form (one read of each listed edge for every row,
    the intermediate ``[B, n_mid]``, the mask shared by the rows);
    ``f32[B, n_dst]``. ``fusion='auto'`` budgets the scratch of B rows."""
    return _fused_dispatch(True, weights, hop1, hop2, mid_mask, op=op,
                           mid_binarize=mid_binarize, use_kernel=use_kernel,
                           fusion=fusion, block_skipping=block_skipping)


def _fused_dispatch(batched: bool, weights, hop1, hop2, mid_mask, *, op, mid_binarize,
                    use_kernel, fusion, block_skipping) -> torch.Tensor:
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = _frontier_rows(weights) if batched else _as(weights, torch.float32)
    mm = None if mid_mask is None else _as(mid_mask, torch.float32, w.device)
    E1 = hop1.src_ids.shape[0]
    E2 = hop2.src_ids.shape[0] if hop2 is not None else 0
    n_mid = hop1.n_dst
    n_dst = hop2.n_dst if hop2 is not None else hop1.n_dst
    mid_binarize = mid_binarize and hop2 is not None
    batch = w.shape[0] if batched else 1
    if (_fusion_unfusable(fusion, n_mid, hop2 is not None, batch) or E1 == 0
            or (hop2 is not None and E2 == 0)):
        return _compose_unfused(w, hop1, hop2, mm, mid_binarize, op, use_kernel,
                                block_skipping)
    if use_kernel:
        _faults.fire("ops.fragment_spmm_fused" if batched else "ops.fragment_spmv_fused",
                     op=op, n_dst=n_dst)
    s1 = _streams(hop1, w.device)
    s2 = _streams(hop2, w.device) if hop2 is not None else None
    bi1, na1, bi2, na2 = _fused_block_lists(w, op, hop1, hop2, E1, E2, block_skipping,
                                            use_kernel)
    if _plain(w, use_kernel):
        plain_fn = ref.fragment_spmm_fused_ref if batched else ref.fragment_spmv_fused_ref
        return plain_fn(w, s1, s2, mm, n_mid, n_dst, op=op, mid_binarize=mid_binarize,
                        lists=(bi1, na1, bi2, na2))
    if mm is not None:
        mm = mm.contiguous()
    # each hop aggregates per CTA on an index with a hot destination, as the
    # unfused hops do
    table1 = uses_table(hop1.hot_share)
    if s2 is None:
        fn1 = _fused.fragment_spmm_fused1 if batched else _fused.fragment_spmv_fused1
        return fn1(w, s1, mm, bi1, na1, n_dst, op=op, table=table1)
    fn2 = _fused.fragment_spmm_fused2 if batched else _fused.fragment_spmv_fused2
    return fn2(w, s1, s2, mm, bi1, na1, bi2, na2, n_mid, n_dst, op=op,
               mid_binarize=mid_binarize, table1=table1, table2=uses_table(hop2.hot_share))


# ---------------------------------------------------------------------------
# Bitmap intersection (bitmap_ops.py): the paper's §6.1 merge-intersection
# over sets held as bitmaps, 32 ids to a word
# ---------------------------------------------------------------------------


def _bitmap_words(a) -> torch.Tensor:
    """A bitmap as int32 words: a tensor as given; a numpy array or a list
    as uint32 words (the reference's ``jnp.asarray(a, jnp.uint32)``),
    reinterpreted, on the CPU."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype != np.uint32:
        a = a.astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def membership_bitmap(ids, n: int) -> torch.Tensor:
    """The set ``ids`` (ints in ``[0, n)``, repeats allowed) as a bitmap of
    ``ceil(n / 32)`` int32 words on the ids' device: bit ``i % 32`` of word
    ``i // 32`` is set for each id ``i``."""
    ids = torch.as_tensor(ids).to(torch.int64)
    n_words = -(-int(n) // 32)
    bits = torch.zeros(n_words * 32, dtype=torch.bool, device=ids.device)
    bits[ids] = True
    shifts = torch.arange(32, dtype=torch.int64, device=ids.device)
    words = (bits.view(n_words, 32).to(torch.int64) << shifts).sum(1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def bitmap_and(a, b, use_kernel: bool = True) -> torch.Tensor:
    """Word-wise AND of two bitmaps; int32 words holding the uint32 bits."""
    ta, tb = _bitmap_words(a), _bitmap_words(b)
    _bitmaps.check_pair(ta, tb)
    if _plain(ta, use_kernel):
        return ref.bitmap_and_ref(ta, tb)
    return _bitmaps.bitmap_and(ta, tb)


def bitmap_and_popcount(a, b, use_kernel: bool = True) -> torch.Tensor:
    """Total set bits of ``a & b`` (the intersection's cardinality) as a 0-d
    int32 tensor on the operands' device. Raises past
    ``bitmap_ops.MAX_POPCOUNT_WORDS`` words, where the count could pass
    int32 (the reference's sum wraps there)."""
    ta, tb = _bitmap_words(a), _bitmap_words(b)
    _bitmaps.check_popcount_words(_bitmaps.check_pair(ta, tb))
    if _plain(ta, use_kernel):
        return ref.bitmap_and_popcount_ref(ta, tb)
    return _bitmaps.bitmap_and_popcount(ta, tb)
