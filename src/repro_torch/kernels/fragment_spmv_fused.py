"""CUDA kernels for Hopper: a pipelined region of the plan in one launch.

A :class:`repro_torch.core.lower.FusedHopOp` region — hop1 → the mid filter
mask → hop2's semijoin binarize → hop2, or the degenerate hop + output mask —
runs as one kernel (``csrc/fragment_spmv_fused.cu``; its header says what
bounds it, how the TPU's VMEM-resident intermediate maps onto Hopper and
which schedule each phase runs):

  * :func:`fragment_spmv_fused2`, the two-hop region: one cooperative,
    persistent launch; the intermediate ``u[n_mid]`` is global-memory scratch
    this wrapper allocates, filled, accumulated and read inside the launch
    between grid-wide barriers. In each hop phase the CTAs draw listed blocks
    from a counter;
  * :func:`fragment_spmv_fused1`, the degenerate 1-hop+filter region: one
    wave of CTAs over the block list, the mask applied before the scatter,
    writing the output directly (no scratch);
  * :func:`fragment_spmm_fused1` / :func:`fragment_spmm_fused2`, the same two
    regions for B frontier rows at once (the batched serving path) on the
    batched hops' row-chunk body: fused2's intermediate and both forms'
    output accumulate in scratch laid out ``[ceil(B / rb), n, rb]``
    (:func:`.fragment_spmm.row_scratch`'s layout; an edge's chunk of rb rows
    in one 32-byte sector), allocated here, and the launch writes the
    ``[B, n_dst]`` result from it; at B = 1 they run the SpMV form.

A table flag for each hop (``table`` of fused1, ``table1`` / ``table2`` of
fused2; :func:`.ops.fragment_spmv_fused` passes ``ops.uses_table`` of each
hop's hot share) makes the hop combine each CTA's products per destination in
a shared-memory table first, flushed once a CTA, as the unfused hops do on an
index with a hot destination. The masks reach the kernels as one byte an
entry: a float32 mask is converted (``mask > 0``) once a tensor, so a plan's
constant mask costs one conversion, not one a launch. Every function takes
each hop's streams as a :class:`repro_torch.kernels.ref.HopStreams` (dst as
int32 ids or BCA words, the measure in any of the packed hop's modes) and
device-resident block lists whose counts the kernels read on the card. A
kernel that fails to build or launch raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .cuda_build import (
    I32,
    P,
    CudaLibrary,
    KernelError,
    check_tensor,
    cuda_device,
    launch,
    stream_of,
)
from .fragment_spmm import ROW_CHUNK, check_rows, row_chunk, row_scratch
from .fragment_spmv import OP_CODE, check_block_list
from .fragment_spmv_packed import M_MODES, check_streams
from .ref import IDENTITY, HopStreams


class HopArgs(ctypes.Structure):
    """One hop's streams, laid out as ``struct HopArgs`` in the .cu file."""

    _fields_ = [
        ("src", ctypes.c_void_p), ("E", ctypes.c_int64),
        ("dst", ctypes.c_void_p), ("dst_words", ctypes.c_int64),
        ("dst_width", ctypes.c_int32), ("m_mode", ctypes.c_int32),
        ("m", ctypes.c_void_p), ("m_words", ctypes.c_int64),
        ("m_width", ctypes.c_int32), ("n_dict", ctypes.c_int32),
        ("mdict", ctypes.c_void_p),
    ]


LIB = CudaLibrary("fragment_spmv_fused", {
    "fragment_spmv_fused1_launch": [P, I32, P, P, P, I32, I32, P, I32, P, I32, P],
    "fragment_spmv_fused2_launch": [P, I32, P, P, P, I32, P, I32, P, I32, I32, P, I32, P,
                                    P, I32, P, P, I32, I32, P],
    "fragment_spmv_fused2_max_grid": [I32, I32],
    "fragment_spmm_fused1_launch": [P, I32, I32, P, P, P, I32, I32, P, I32, P, P, I32, I32,
                                    P],
    "fragment_spmm_fused2_launch": [P, I32, I32, P, P, P, I32, P, I32, P, I32, I32, P, I32,
                                    P, P, I32, P, P, P, I32, I32, I32, P],
    "fragment_spmm_fused2_max_grid": [I32, I32, I32],
})

#: Launches of each kernel since import (or since a caller reset them).
FUSED1_LAUNCHES = 0  # the degenerate 1-hop+filter region
FUSED2_LAUNCHES = 0  # the two-hop region
SPMM_FUSED1_LAUNCHES = 0  # the degenerate region, B rows
SPMM_FUSED2_LAUNCHES = 0  # the two-hop region, B rows
#: Of those, the launches with a table in at least one hop, by kernel.
TABLE_LAUNCHES = dict.fromkeys(("fragment_spmv_fused1", "fragment_spmv_fused2",
                                "fragment_spmm_fused1", "fragment_spmm_fused2"), 0)


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def max_grid(op: str = "sum", batched: bool = False, table: bool = False,
             rows: int = ROW_CHUNK) -> int:
    """The CTAs of the two-hop kernel (``batched``: its SpMM form at ``rows``
    rows a chunk of the scratch, 1, 2, 4 or 8) that can be resident at once,
    with the table's shared memory (``table``) or without: the largest grid
    its launch takes."""
    if batched and rows not in (1, 2, 4, ROW_CHUNK):
        raise ValueError(f"rows a chunk must be 1, 2, 4 or {ROW_CHUNK}, got {rows}")
    lib = build()
    if batched:
        g = lib.fragment_spmm_fused2_max_grid(OP_CODE[op], rows, int(table))
    else:
        g = lib.fragment_spmv_fused2_max_grid(OP_CODE[op], int(table))
    if g <= 0:
        raise KernelError(f"fragment_spmv_fused2: no co-resident grid (CUDA error {-g})")
    return g


def _hop_args(h: HopStreams, n: str, dev) -> HopArgs:
    """Check one hop's streams and lay them out for the kernel."""
    check_tensor(h.src, f"{n}.src", torch.int32, dev)
    E = h.src.shape[0]
    n_dict = check_streams(h.dst, h.measure, h.mdict, E, h.dst_width, h.m_mode, h.m_width,
                           dev, name=f"{n}.")
    return HopArgs(
        h.src.data_ptr(), E, h.dst.data_ptr(), h.dst.shape[0] if h.dst_width else 0,
        int(h.dst_width), M_MODES[h.m_mode],
        h.measure.data_ptr() if h.m_mode != "none" else None,
        h.measure.shape[0] if h.m_mode in ("packed", "dict") else 0, int(h.m_width), n_dict,
        h.mdict.data_ptr() if h.m_mode == "dict" else None,
    )


def _check_domain(n: int, what: str) -> int:
    n = int(n)
    if n < 0 or n >= 2**31:
        raise ValueError(f"{what} must fit int32, got {n}")
    return n


#: The byte form of each float32 mask the kernels were given, by tensor (an
#: entry goes with its tensor): a plan's constant mask is converted once, and
#: again only after an in-place change (its version counter moved).
_BYTE_MASKS = WeakIdKeyDictionary()


def _keep(mask, n: int, dev):
    """The float32 mask as the kernels read it, one byte an entry, nonzero
    where ``mask > 0`` (converted once a tensor); None for no mask."""
    if mask is None:
        return None
    check_tensor(mask, "mid_mask", torch.float32, dev)
    if mask.shape[0] != n:
        raise ValueError(f"mid_mask has {mask.shape[0]} entries, the domain {n}")
    version, keep = _BYTE_MASKS.get(mask, (None, None))
    if version != mask._version:
        keep = (mask > 0).to(torch.uint8)
        _BYTE_MASKS[mask] = (mask._version, keep)
    return keep


def _ptr(t):
    return None if t is None else t.data_ptr()


def _frontier(weights, n_dst: int, dev, rows: bool) -> tuple[int, int, int, tuple]:
    """The region's frontier ``f32[n_src]`` (``rows``: ``f32[B, n_src]``) and
    sizes: ``(B, n_src, n_dst, output shape)``, B = 1 for the SpMV form."""
    if rows:
        B, n_src, n_dst = check_rows(weights, n_dst, dev)
        return B, n_src, n_dst, (B, n_dst)
    check_tensor(weights, "weights", torch.float32, dev)
    n_src = _check_domain(weights.shape[0], "n_src")
    n_dst = _check_domain(n_dst, "n_dst")
    return 1, n_src, n_dst, (n_dst,)


def _fused1(kernel: str, rows: bool, weights, hop1, mid_mask, block_idx1, n_active1,
            n_dst, op, table):
    """Launch the degenerate region (SpMV or SpMM form); ``(out, launched)``."""
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, kernel)
    B, n_src, n_dst, shape = _frontier(weights, n_dst, dev, rows)
    h1 = _hop_args(hop1, "hop1", dev)
    keep = _ptr(_keep(mid_mask, n_dst, dev))
    if h1.E == 0 or n_dst == 0 or B == 0:  # a grid of 0 blocks is an invalid launch
        return torch.full(shape, IDENTITY[op], dtype=torch.float32, device=dev), False
    check_block_list(block_idx1, n_active1, h1.E, dev)
    lib = build()
    lists = (block_idx1.data_ptr(), block_idx1.shape[0], n_active1.data_ptr())
    if rows:
        out, s, rb = row_scratch(B, n_dst, op, dev)  # rb = 1: s is out, filled
        launch(lib.fragment_spmm_fused1_launch, kernel, dev,
               weights.data_ptr(), n_src, B, ctypes.byref(h1), keep, out.data_ptr(), n_dst,
               OP_CODE[op], *lists, s.data_ptr(), rb, int(bool(table)), stream_of(dev))
    else:
        out = torch.full(shape, IDENTITY[op], dtype=torch.float32, device=dev)
        launch(lib.fragment_spmv_fused1_launch, kernel, dev,
               weights.data_ptr(), n_src, ctypes.byref(h1), keep, out.data_ptr(), n_dst,
               OP_CODE[op], *lists, int(bool(table)), stream_of(dev))
    return out, True


def _fused2(kernel: str, rows: bool, weights, hop1, hop2, mid_mask, block_idx1, n_active1,
            block_idx2, n_active2, n_mid, n_dst, op, mid_binarize, table1, table2):
    """Launch the two-hop region (SpMV or SpMM form); ``(out, launched)``.
    The kernel fills its scratch: u, and for the SpMM form at rb > 1 the
    output's row-chunk scratch, both ``[ceil(B / rb), n, rb]``."""
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, kernel)
    B, n_src, n_dst, shape = _frontier(weights, n_dst, dev, rows)
    n_mid = _check_domain(n_mid, "n_mid")
    h1 = _hop_args(hop1, "hop1", dev)
    h2 = _hop_args(hop2, "hop2", dev)
    keep = _ptr(_keep(mid_mask, n_mid, dev))
    if h1.E == 0 or h2.E == 0 or n_mid == 0 or n_dst == 0 or B == 0:
        # nothing reaches the output: no launch
        return torch.full(shape, IDENTITY[op], dtype=torch.float32, device=dev), False
    check_block_list(block_idx1, n_active1, h1.E, dev)
    check_block_list(block_idx2, n_active2, h2.E, dev)
    rb = row_chunk(B) if rows else 1
    chunks = -(-B // rb)
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.empty((chunks, n_mid, rb) if rb > 1 else (n_mid,), **f32)
    s = torch.empty((chunks, n_dst, rb), **f32) if rb > 1 else None
    out = torch.empty(shape, **f32)
    counters = torch.empty(2 * chunks, dtype=torch.int32, device=dev)  # zeroed by the kernel
    lib = build()
    args = (ctypes.byref(h1), ctypes.byref(h2), keep, int(bool(mid_binarize)), u.data_ptr(),
            n_mid, out.data_ptr(), n_dst, OP_CODE[op],
            block_idx1.data_ptr(), block_idx1.shape[0], n_active1.data_ptr(),
            block_idx2.data_ptr(), block_idx2.shape[0], n_active2.data_ptr(),
            counters.data_ptr())
    flags = (int(bool(table1)), int(bool(table2)))
    if rows:
        launch(lib.fragment_spmm_fused2_launch, kernel, dev,
               weights.data_ptr(), n_src, B, *args, s.data_ptr() if s is not None else None,
               rb, *flags, stream_of(dev))
    else:
        launch(lib.fragment_spmv_fused2_launch, kernel, dev,
               weights.data_ptr(), n_src, *args, *flags, stream_of(dev))
    return out, True


def fragment_spmv_fused1(
    weights: torch.Tensor,  # f32[n_src], CUDA
    hop1: HopStreams,
    mid_mask: torch.Tensor | None,  # f32[n_dst] | None
    block_idx1: torch.Tensor,  # i32[C1], device-resident
    n_active1: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    op: str = "sum",
    *,
    table: bool = False,
) -> torch.Tensor:
    """The degenerate region in one launch: ``out[d] ⊕= w[src] ⊗ m`` over
    the listed blocks, ⊕-identity wherever ``mid_mask[d] ≤ 0``. ``table``:
    aggregate per CTA (else an atomic an edge)."""
    global FUSED1_LAUNCHES
    out, launched = _fused1("fragment_spmv_fused1", False, weights, hop1, mid_mask,
                            block_idx1, n_active1, n_dst, op, table)
    FUSED1_LAUNCHES += launched
    TABLE_LAUNCHES["fragment_spmv_fused1"] += bool(launched and table)
    return out


def fragment_spmv_fused2(
    weights: torch.Tensor,  # f32[n_src], CUDA
    hop1: HopStreams,
    hop2: HopStreams,
    mid_mask: torch.Tensor | None,  # f32[n_mid] | None
    block_idx1: torch.Tensor, n_active1: torch.Tensor,  # hop1's list, device-resident
    block_idx2: torch.Tensor, n_active2: torch.Tensor,  # hop2's list, device-resident
    n_mid: int,
    n_dst: int,
    op: str = "sum",
    mid_binarize: bool = False,
    *,
    table1: bool = False,
    table2: bool = False,
) -> torch.Tensor:
    """The two-hop region in one cooperative launch; f32[n_dst]. The
    intermediate is ``4 · n_mid`` bytes of scratch allocated here (and two
    block counters). ``table1`` / ``table2``: that hop aggregates per CTA.
    Raises on anything the kernel does not take, and when the launch is
    refused (a grid that cannot be co-resident included)."""
    global FUSED2_LAUNCHES
    out, launched = _fused2("fragment_spmv_fused2", False, weights, hop1, hop2, mid_mask,
                            block_idx1, n_active1, block_idx2, n_active2, n_mid, n_dst, op,
                            mid_binarize, table1, table2)
    FUSED2_LAUNCHES += launched
    TABLE_LAUNCHES["fragment_spmv_fused2"] += bool(launched and (table1 or table2))
    return out


def fragment_spmm_fused1(
    weights: torch.Tensor,  # f32[B, n_src], CUDA
    hop1: HopStreams,
    mid_mask: torch.Tensor | None,  # f32[n_dst] | None, shared by the rows
    block_idx1: torch.Tensor,  # i32[C1], the union of the rows' active blocks
    n_active1: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    op: str = "sum",
    *,
    table: bool = False,
) -> torch.Tensor:
    """The batched degenerate region in one launch call: ``out[b, d] ⊕=
    w[b, src] ⊗ m`` over the listed blocks, each edge read once a row chunk
    into the row-chunk scratch, then the epilogue; ⊕-identity wherever
    ``mid_mask[d] ≤ 0``. f32[B, n_dst]. ``table``: aggregate per CTA."""
    global SPMM_FUSED1_LAUNCHES
    out, launched = _fused1("fragment_spmm_fused1", True, weights, hop1, mid_mask,
                            block_idx1, n_active1, n_dst, op, table)
    SPMM_FUSED1_LAUNCHES += launched
    TABLE_LAUNCHES["fragment_spmm_fused1"] += bool(launched and table)
    return out


def fragment_spmm_fused2(
    weights: torch.Tensor,  # f32[B, n_src], CUDA
    hop1: HopStreams,
    hop2: HopStreams,
    mid_mask: torch.Tensor | None,  # f32[n_mid] | None, shared by the rows
    block_idx1: torch.Tensor, n_active1: torch.Tensor,  # hop1's list, device-resident
    block_idx2: torch.Tensor, n_active2: torch.Tensor,  # hop2's list, device-resident
    n_mid: int,
    n_dst: int,
    op: str = "sum",
    mid_binarize: bool = False,
    *,
    table1: bool = False,
    table2: bool = False,
) -> torch.Tensor:
    """The batched two-hop region in one cooperative launch; f32[B, n_dst].
    The intermediate is ``4 · B · n_mid`` bytes of scratch allocated here
    (rounded up to whole row chunks), and so is the output's row-chunk
    scratch. ``table1`` / ``table2``: that hop aggregates per CTA in a table
    of row chunks. Raises on anything the kernel does not take, and when the
    launch is refused (a grid that cannot be co-resident included)."""
    global SPMM_FUSED2_LAUNCHES
    out, launched = _fused2("fragment_spmm_fused2", True, weights, hop1, hop2, mid_mask,
                            block_idx1, n_active1, block_idx2, n_active2, n_mid, n_dst, op,
                            mid_binarize, table1, table2)
    SPMM_FUSED2_LAUNCHES += launched
    TABLE_LAUNCHES["fragment_spmm_fused2"] += bool(launched and (table1 or table2))
    return out
