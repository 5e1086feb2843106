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
    scratch).

Both take each hop's streams as a :class:`repro_torch.kernels.ref.HopStreams`
(dst as int32 ids or BCA words, the measure in any of the packed hop's
modes) and device-resident block lists whose counts the kernels read on the
card. A kernel that fails to build or launch raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import I32, P, CudaLibrary, check_tensor, cuda_device, raise_on, stream_of
from .fragment_spmv import OP_CODE, check_block_list
from .fragment_spmv_packed import M_MODES, _check_words
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
})

#: Launches of each kernel since import (or since a caller reset them).
FUSED1_LAUNCHES = 0  # the degenerate 1-hop+filter region
FUSED2_LAUNCHES = 0  # the two-hop region


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def max_grid(op: str = "sum") -> int:
    """The CTAs of the two-hop kernel that can be resident at once."""
    g = build().fragment_spmv_fused2_max_grid(OP_CODE[op])
    if g <= 0:
        raise RuntimeError(f"fragment_spmv_fused2: no co-resident grid (CUDA error {-g})")
    return g


def _hop_args(h: HopStreams, n: str, dev) -> HopArgs:
    """Check one hop's streams and lay them out for the kernel."""
    check_tensor(h.src, f"{n}.src", torch.int32, dev)
    E = h.src.shape[0]
    if h.dst_width:
        _check_words(h.dst, f"{n}.dst", h.dst_width, E, dev)
    else:
        check_tensor(h.dst, f"{n}.dst", torch.int32, dev)
        if h.dst.shape[0] != E:
            raise ValueError(f"{n}.dst has {h.dst.shape[0]} edges, src {E}")
    if h.m_mode not in M_MODES:
        raise ValueError(f"unknown measure mode {h.m_mode!r}")
    n_dict = 0
    if h.m_mode == "dense":
        check_tensor(h.measure, f"{n}.measure", torch.float32, dev)
        if h.measure.shape[0] != E:
            raise ValueError(f"{n}.measure has {h.measure.shape[0]} edges, src {E}")
    elif h.m_mode in ("packed", "dict"):
        _check_words(h.measure, f"{n}.measure", h.m_width, E, dev)
        if h.m_mode == "dict":
            check_tensor(h.mdict, f"{n}.mdict", torch.float32, dev)
            n_dict = h.mdict.shape[0]
            if n_dict == 0:
                raise ValueError(f"{n}.mdict is empty")
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
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, "fragment_spmv_fused1")
    check_tensor(weights, "weights", torch.float32, dev)
    _check_domain(weights.shape[0], "n_src")
    n_dst = _check_domain(n_dst, "n_dst")
    h1 = _hop_args(hop1, "hop1", dev)
    keep = _keep(mid_mask, n_dst, dev)
    out = torch.full((n_dst,), IDENTITY[op], dtype=torch.float32, device=dev)
    if h1.E == 0 or n_dst == 0:  # a grid of 0 blocks is an invalid launch
        return out
    check_block_list(block_idx1, n_active1, h1.E, dev)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.fragment_spmv_fused1_launch(
            weights.data_ptr(), weights.shape[0], ctypes.byref(h1), keep, out.data_ptr(),
            n_dst, OP_CODE[op], block_idx1.data_ptr(), block_idx1.shape[0],
            n_active1.data_ptr(), stream_of(dev),
        )
    raise_on(err, "fragment_spmv_fused1")
    FUSED1_LAUNCHES += 1
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
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, "fragment_spmv_fused2")
    check_tensor(weights, "weights", torch.float32, dev)
    _check_domain(weights.shape[0], "n_src")
    n_mid = _check_domain(n_mid, "n_mid")
    n_dst = _check_domain(n_dst, "n_dst")
    h1 = _hop_args(hop1, "hop1", dev)
    h2 = _hop_args(hop2, "hop2", dev)
    keep = _keep(mid_mask, n_mid, dev)
    if h1.E == 0 or h2.E == 0 or n_mid == 0 or n_dst == 0:
        # nothing reaches the output: no launch
        return torch.full((n_dst,), IDENTITY[op], dtype=torch.float32, device=dev)
    check_block_list(block_idx1, n_active1, h1.E, dev)
    check_block_list(block_idx2, n_active2, h2.E, dev)
    u = torch.empty(n_mid, dtype=torch.float32, device=dev)
    out = torch.empty(n_dst, dtype=torch.float32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)  # zeroed by the kernel
    lib = build()
    with torch.cuda.device(dev):
        err = lib.fragment_spmv_fused2_launch(
            weights.data_ptr(), weights.shape[0], ctypes.byref(h1), ctypes.byref(h2), keep,
            int(bool(mid_binarize)), u.data_ptr(), n_mid, out.data_ptr(), n_dst, OP_CODE[op],
            block_idx1.data_ptr(), block_idx1.shape[0], n_active1.data_ptr(),
            block_idx2.data_ptr(), block_idx2.shape[0], n_active2.data_ptr(),
            counters.data_ptr(), stream_of(dev),
        )
    raise_on(err, "fragment_spmv_fused2")
    FUSED2_LAUNCHES += 1
    return out
