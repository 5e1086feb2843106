"""CUDA kernels for Hopper: the decode-fused batched hop and its
block-skipping variant.

The batched counterpart of :mod:`.fragment_spmv_packed`: ``dst`` and/or the
measure arrive as BCA word streams (int32 tensors holding the uint32 words)
and each edge is decoded once, in registers, for all B frontier rows — one
decode serves the batch. The measure modes are the SpMV's (``none``,
``dense`` float32[E], ``packed``, ``dict``), shared by the rows; a per-row
measure stream goes to :mod:`.fragment_spmm` instead. The kernels are
``csrc/fragment_spmm_packed.cu``, which shares its body with the dense SpMM
through ``csrc/hop.cuh``: the row-chunk scratch (:func:`.fragment_spmm.row_scratch`)
and its epilogue, and with ``table=True`` the per-CTA table on a hot index.
"""
from __future__ import annotations

import torch

from .cuda_build import I32, I64, P, CudaLibrary, check_tensor, cuda_device, launch, stream_of
from .fragment_spmm import check_rows, row_scratch
from .fragment_spmv import OP_CODE, check_block_list
from .fragment_spmv_packed import M_MODES, check_streams
from .ref import IDENTITY

LIB = CudaLibrary("fragment_spmm_packed", {
    "fragment_spmm_packed_launch": [
        P, I32, I32, P, I64, P, I32, I64, I32, P, I32, I64, P, I32, P, I32, I32,
        P, I32, P, I32, P, I32, I32, P,
    ],
})

#: Launches of each kernel since import (or since a caller reset them).
LAUNCHES = 0  # fragment_spmm_packed
ACTIVE_LAUNCHES = 0  # fragment_spmm_packed_active


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def _launch(weights, src_ids, dst, measure, mdict, n_dst, dst_width, m_mode,
            m_width, op, blocks, scan_above, table, kernel):
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    if m_mode not in M_MODES:
        raise ValueError(f"unknown measure mode {m_mode!r}")
    dev = cuda_device(weights, kernel)
    B, n_src, n_dst = check_rows(weights, n_dst, dev)
    check_tensor(src_ids, "src_ids", torch.int32, dev)
    E = src_ids.shape[0]
    n_dict = check_streams(dst, measure, mdict, E, dst_width, m_mode, m_width, dev)
    if E == 0 or n_dst == 0 or B == 0:  # a grid of 0 blocks is an invalid launch
        return torch.full((B, n_dst), IDENTITY[op], dtype=torch.float32, device=dev), False
    block_idx = n_active = None
    if blocks is not None:
        block_idx, n_active = blocks
        check_block_list(block_idx, n_active, E, dev)
    y, s, rb = row_scratch(B, n_dst, op, dev)
    launch(
        build().fragment_spmm_packed_launch, kernel, dev,
        weights.data_ptr(), n_src, B, src_ids.data_ptr(), E,
        dst.data_ptr(), int(dst_width), dst.shape[0] if dst_width else 0,
        M_MODES[m_mode],
        measure.data_ptr() if m_mode != "none" else None, int(m_width),
        measure.shape[0] if m_mode in ("packed", "dict") else 0,
        mdict.data_ptr() if m_mode == "dict" else None, n_dict,
        y.data_ptr(), n_dst, OP_CODE[op],
        block_idx.data_ptr() if blocks is not None else None,
        block_idx.shape[0] if blocks is not None else 0,
        n_active.data_ptr() if blocks is not None else None,
        2**31 - 1 if scan_above is None else int(scan_above),
        s.data_ptr(), rb, int(bool(table)), stream_of(dev),
    )
    return y, True


def fragment_spmm_packed(
    weights: torch.Tensor,  # f32[B, n_src], CUDA
    src_ids: torch.Tensor,  # i32[E]
    dst: torch.Tensor,  # word stream if dst_width else i32[E]
    measure: torch.Tensor | None,  # per m_mode, shared by the rows
    mdict: torch.Tensor | None,  # f32[u], m_mode == 'dict' only
    n_dst: int,
    dst_width: int = 0,
    m_mode: str = "none",
    m_width: int = 0,
    op: str = "sum",
    table: bool = True,
) -> torch.Tensor:
    """Launch the decode-fused batched scan hop; f32[B, n_dst] from the
    ⊕-identity. ``table``: aggregate per CTA. Raises on anything the kernel
    does not take."""
    global LAUNCHES
    y, launched = _launch(weights, src_ids, dst, measure, mdict, n_dst, dst_width,
                          m_mode, m_width, op, None, None, table, "fragment_spmm_packed")
    LAUNCHES += launched
    return y


def fragment_spmm_packed_active(
    weights: torch.Tensor,
    src_ids: torch.Tensor,
    dst: torch.Tensor,
    measure: torch.Tensor | None,
    mdict: torch.Tensor | None,
    block_idx: torch.Tensor,  # i32[C], the union of the rows' active blocks
    n_active: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    dst_width: int = 0,
    m_mode: str = "none",
    m_width: int = 0,
    op: str = "sum",
    scan_above: int | None = None,
    table: bool = True,
) -> torch.Tensor:
    """Launch the decode-fused batched block-skipping hop: only the listed
    blocks are streamed and decoded, once a row chunk, or every block in
    scan order when ``n_active > scan_above``, by one wave of CTAs."""
    global ACTIVE_LAUNCHES
    y, launched = _launch(weights, src_ids, dst, measure, mdict, n_dst, dst_width,
                          m_mode, m_width, op, (block_idx, n_active), scan_above, table,
                          "fragment_spmm_packed_active")
    ACTIVE_LAUNCHES += launched
    return y
