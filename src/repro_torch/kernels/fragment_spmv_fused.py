"""CUDA kernels for Hopper: a pipelined region of the plan in one launch.

A :class:`repro_torch.core.lower.FusedHopOp` region — hop1 → the mid filter
mask → hop2's semijoin binarize → hop2, or the degenerate hop + output mask —
runs as one kernel (``csrc/fragment_spmv_fused.cu``; its header says what
bounds it and how the TPU's VMEM-resident intermediate maps onto Hopper):

  * :func:`fragment_spmv_fused2`, the two-hop region: one cooperative,
    persistent launch; the intermediate ``u[n_mid]`` is global-memory scratch
    this wrapper allocates, filled, accumulated and read inside the launch
    between grid-wide barriers;
  * :func:`fragment_spmv_fused1`, the degenerate 1-hop+filter region: one hop
    with the mask applied at its scatter, writing the output directly (no
    scratch);
  * :func:`fragment_spmm_fused1` / :func:`fragment_spmm_fused2`, the same two
    regions for B frontier rows at once (the batched serving path): each
    listed edge is read and decoded once for every row, the mask is shared
    by the rows, and fused2's intermediate is ``u[B, n_mid]``.

Both take each hop's streams as a :class:`repro_torch.kernels.ref.HopStreams`
(dst as int32 ids or BCA words, the measure in any of the packed hop's
modes) and device-resident block lists whose counts the kernels read on the
card. A kernel that fails to build or launch raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import I32, P, CudaLibrary, check_tensor, cuda_device, raise_on, stream_of
from .fragment_spmm import check_rows
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
    "fragment_spmv_fused1_launch": [P, I32, P, P, P, I32, I32, P, I32, P, P],
    "fragment_spmv_fused2_launch": [P, I32, P, P, P, I32, P, I32, P, I32, I32, P, I32, P,
                                    P, I32, P, P, P],
    "fragment_spmv_fused2_max_grid": [I32],
    "fragment_spmm_fused1_launch": [P, I32, I32, P, P, P, I32, I32, P, I32, P, P],
    "fragment_spmm_fused2_launch": [P, I32, I32, P, P, P, I32, P, I32, P, I32, I32, P, I32,
                                    P, P, I32, P, P, P],
    "fragment_spmm_fused2_max_grid": [I32],
})

#: Launches of each kernel since import (or since a caller reset them).
FUSED1_LAUNCHES = 0  # the degenerate 1-hop+filter region
FUSED2_LAUNCHES = 0  # the two-hop region
SPMM_FUSED1_LAUNCHES = 0  # the degenerate region, B rows
SPMM_FUSED2_LAUNCHES = 0  # the two-hop region, B rows


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def max_grid(op: str = "sum", batched: bool = False) -> int:
    """The CTAs of the two-hop kernel (``batched``: its SpMM form) that can
    be resident at once."""
    lib = build()
    fn = lib.fragment_spmm_fused2_max_grid if batched else lib.fragment_spmv_fused2_max_grid
    g = fn(OP_CODE[op])
    if g <= 0:
        raise RuntimeError(f"fragment_spmv_fused2: no co-resident grid (CUDA error {-g})")
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


def _keep(mask, n: int, dev):
    if mask is None:
        return None
    check_tensor(mask, "mid_mask", torch.float32, dev)
    if mask.shape[0] != n:
        raise ValueError(f"mid_mask has {mask.shape[0]} entries, the domain {n}")
    return mask.data_ptr()


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
            n_dst, op):
    """Launch the degenerate region (SpMV or SpMM form); ``(out, launched)``."""
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, kernel)
    B, n_src, n_dst, shape = _frontier(weights, n_dst, dev, rows)
    h1 = _hop_args(hop1, "hop1", dev)
    keep = _keep(mid_mask, n_dst, dev)
    out = torch.full(shape, IDENTITY[op], dtype=torch.float32, device=dev)
    if h1.E == 0 or n_dst == 0 or B == 0:  # a grid of 0 blocks is an invalid launch
        return out, False
    check_block_list(block_idx1, n_active1, h1.E, dev)
    lib = build()
    head = (weights.data_ptr(), n_src) + ((B,) if rows else ())
    launch = lib.fragment_spmm_fused1_launch if rows else lib.fragment_spmv_fused1_launch
    with torch.cuda.device(dev):
        err = launch(*head, ctypes.byref(h1), keep, out.data_ptr(), n_dst, OP_CODE[op],
                     block_idx1.data_ptr(), block_idx1.shape[0], n_active1.data_ptr(),
                     stream_of(dev))
    raise_on(err, kernel)
    return out, True


def _fused2(kernel: str, rows: bool, weights, hop1, hop2, mid_mask, block_idx1, n_active1,
            block_idx2, n_active2, n_mid, n_dst, op, mid_binarize):
    """Launch the two-hop region (SpMV or SpMM form); ``(out, launched)``."""
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, kernel)
    B, n_src, n_dst, shape = _frontier(weights, n_dst, dev, rows)
    n_mid = _check_domain(n_mid, "n_mid")
    h1 = _hop_args(hop1, "hop1", dev)
    h2 = _hop_args(hop2, "hop2", dev)
    keep = _keep(mid_mask, n_mid, dev)
    if h1.E == 0 or h2.E == 0 or n_mid == 0 or n_dst == 0 or B == 0:
        # nothing reaches the output: no launch
        return torch.full(shape, IDENTITY[op], dtype=torch.float32, device=dev), False
    check_block_list(block_idx1, n_active1, h1.E, dev)
    check_block_list(block_idx2, n_active2, h2.E, dev)
    u = torch.empty(shape[:-1] + (n_mid,), dtype=torch.float32, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)  # zeroed by the kernel
    lib = build()
    head = (weights.data_ptr(), n_src) + ((B,) if rows else ())
    launch = lib.fragment_spmm_fused2_launch if rows else lib.fragment_spmv_fused2_launch
    with torch.cuda.device(dev):
        err = launch(
            *head, ctypes.byref(h1), ctypes.byref(h2), keep, int(bool(mid_binarize)),
            u.data_ptr(), n_mid, out.data_ptr(), n_dst, OP_CODE[op],
            block_idx1.data_ptr(), block_idx1.shape[0], n_active1.data_ptr(),
            block_idx2.data_ptr(), block_idx2.shape[0], n_active2.data_ptr(),
            counters.data_ptr(), stream_of(dev),
        )
    raise_on(err, kernel)
    return out, True


def fragment_spmv_fused1(
    weights: torch.Tensor,  # f32[n_src], CUDA
    hop1: HopStreams,
    mid_mask: torch.Tensor | None,  # f32[n_dst] | None
    block_idx1: torch.Tensor,  # i32[C1], device-resident
    n_active1: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    op: str = "sum",
) -> torch.Tensor:
    """The degenerate region in one launch: ``out[d] ⊕= w[src] ⊗ m`` over
    the listed blocks, ⊕-identity wherever ``mid_mask[d] ≤ 0``."""
    global FUSED1_LAUNCHES
    out, launched = _fused1("fragment_spmv_fused1", False, weights, hop1, mid_mask,
                            block_idx1, n_active1, n_dst, op)
    FUSED1_LAUNCHES += launched
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
) -> torch.Tensor:
    """The two-hop region in one cooperative launch; f32[n_dst]. The
    intermediate is ``4 · n_mid`` bytes of scratch allocated here (and two
    block counters). Raises on anything the kernel does not take, and when
    the launch is refused (a grid that cannot be co-resident included)."""
    global FUSED2_LAUNCHES
    out, launched = _fused2("fragment_spmv_fused2", False, weights, hop1, hop2, mid_mask,
                            block_idx1, n_active1, block_idx2, n_active2, n_mid, n_dst, op,
                            mid_binarize)
    FUSED2_LAUNCHES += launched
    return out


def fragment_spmm_fused1(
    weights: torch.Tensor,  # f32[B, n_src], CUDA
    hop1: HopStreams,
    mid_mask: torch.Tensor | None,  # f32[n_dst] | None, shared by the rows
    block_idx1: torch.Tensor,  # i32[C1], the union of the rows' active blocks
    n_active1: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    op: str = "sum",
) -> torch.Tensor:
    """The batched degenerate region in one launch: ``out[b, d] ⊕= w[b, src]
    ⊗ m`` over the listed blocks, each edge read once for all rows;
    ⊕-identity wherever ``mid_mask[d] ≤ 0``. f32[B, n_dst]."""
    global SPMM_FUSED1_LAUNCHES
    out, launched = _fused1("fragment_spmm_fused1", True, weights, hop1, mid_mask,
                            block_idx1, n_active1, n_dst, op)
    SPMM_FUSED1_LAUNCHES += launched
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
) -> torch.Tensor:
    """The batched two-hop region in one cooperative launch; f32[B, n_dst].
    The intermediate is ``4 · B · n_mid`` bytes of scratch allocated here.
    Raises on anything the kernel does not take, and when the launch is
    refused (a grid that cannot be co-resident included)."""
    global SPMM_FUSED2_LAUNCHES
    out, launched = _fused2("fragment_spmm_fused2", True, weights, hop1, hop2, mid_mask,
                            block_idx1, n_active1, block_idx2, n_active2, n_mid, n_dst, op,
                            mid_binarize)
    SPMM_FUSED2_LAUNCHES += launched
    return out
