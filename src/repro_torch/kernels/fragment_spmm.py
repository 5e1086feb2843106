"""CUDA kernels for Hopper: the batched hop (the multi-query SpMM) over dense
columns, and its block-skipping variant.

``Y[b, dst] ⊕= W[b, src] ⊗ m`` over the edge list of a GQ-Fast index for all
B frontier rows at once: the serving path's hop, where B queries that differ
only in their parameters share one pass over the edges. The combine op ⊕ is
``op`` ('sum' | 'min' | 'max' | 'bool'), as in :mod:`.fragment_spmv`. The
measure is shared by the rows (``[E]``), absent (measure 1), or per row
(``[B, E]``: a measure that depends on the row's parameters), passed to the
kernel as a row stride. The kernels are ``csrc/fragment_spmm.cu`` (its header
says what bounds them and how they are built around that), compiled at first
use by :mod:`.cuda_build` and launched on the current stream. They accumulate
into a row-chunk-minor scratch ``[ceil(B / rb), n_dst, rb]`` (an edge's rb
rows in one 32-byte sector; :func:`row_scratch` allocates it), which an
epilogue kernel of the same launch transposes into the returned
``f32[B, n_dst]``; at B = 1 the launch runs the single hop's body into the
result. ``table=True`` combines each CTA's products per
destination in a shared-memory table first (an index with a hot
destination); :func:`.ops.fragment_spmm` chooses by the index's hot share
(``ops.uses_table``).
"""
from __future__ import annotations

import torch

from .cuda_build import I32, I64, P, CudaLibrary, check_tensor, cuda_device, launch, stream_of
from .fragment_spmv import OP_CODE, check_block_list
from .ref import IDENTITY

LIB = CudaLibrary("fragment_spmm", {
    "fragment_spmm_launch": [P, I32, I32, P, P, P, I64, I64, P, I32, I32, P, I32, P, I32, P,
                             I32, I32, P],
})

#: Rows a chunk of the kernels' scratch holds at most: 8 float32 values, one
#: 32-byte sector (``csrc/hop.cuh`` kRowChunk).
ROW_CHUNK = 8

#: Launches of each kernel since import (or since a caller reset them): one
#: per launch, counted nowhere else.
LAUNCHES = 0  # fragment_spmm
ACTIVE_LAUNCHES = 0  # fragment_spmm_active


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def check_rows(weights, n_dst, dev) -> tuple[int, int, int]:
    """A batched hop's frontier ``f32[B, n_src]`` on ``dev`` and its domain
    sizes: ``(B, n_src, n_dst)``, each within int32 (the row offsets the
    kernels form from them are int64)."""
    check_tensor(weights, "weights", torch.float32, dev, ndim=2)
    B, n_src = weights.shape
    n_dst = int(n_dst)
    if n_dst < 0 or n_dst >= 2**31 or n_src >= 2**31 or B >= 2**31:
        raise ValueError(f"sizes must fit int32: B={B}, n_src={n_src}, n_dst={n_dst}")
    return B, n_src, n_dst


def row_chunk(B: int) -> int:
    """Rows a chunk of the scratch: ROW_CHUNK, or B rounded up to 1, 2 or 4
    below 5 rows (the kernels' vector reduction is 4 or 2 values wide; at
    one row they run the single hop's body)."""
    return 1 if B <= 1 else 2 if B == 2 else 4 if B <= 4 else ROW_CHUNK


def row_scratch(B: int, n_dst: int, op: str, dev) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(y, s, rb)`` for a batched launch: ``y = f32[B, n_dst]`` the result
    and ``s = f32[ceil(B / rb), n_dst, rb]`` the scratch the kernel
    accumulates into, filled with the ⊕-identity. At rb = 1 the scratch is
    ``y`` itself (filled), else ``y`` is left for the epilogue to write
    whole."""
    rb = row_chunk(B)
    if rb == 1:
        y = torch.full((B, n_dst), IDENTITY[op], dtype=torch.float32, device=dev)
        return y, y, rb
    s = torch.empty((-(-B // rb), n_dst, rb), dtype=torch.float32, device=dev)
    s.fill_(IDENTITY[op])
    return torch.empty((B, n_dst), dtype=torch.float32, device=dev), s, rb


def measure_stride(measures, B: int, E: int, dev) -> int:
    """The kernel's row stride of a dense measure: 0 for one ``[E]`` column
    shared by the rows, E for a per-row ``[B, E]`` stream."""
    if measures.dim() == 1:
        check_tensor(measures, "measures", torch.float32, dev)
        if measures.shape[0] != E:
            raise ValueError(f"measures has {measures.shape[0]} edges, src_ids {E}")
        return 0
    check_tensor(measures, "measures", torch.float32, dev, ndim=2)
    if tuple(measures.shape) != (B, E):
        raise ValueError(f"per-row measures must be [B, E] = [{B}, {E}], got "
                         f"{tuple(measures.shape)}")
    return E


def _launch(weights, src_ids, dst_ids, measures, n_dst, op, blocks, scan_above, table,
            kernel):
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, kernel)
    B, n_src, n_dst = check_rows(weights, n_dst, dev)
    check_tensor(src_ids, "src_ids", torch.int32, dev)
    check_tensor(dst_ids, "dst_ids", torch.int32, dev)
    E = src_ids.shape[0]
    if dst_ids.shape[0] != E:
        raise ValueError(f"dst_ids has {dst_ids.shape[0]} edges, src_ids {E}")
    stride = 0 if measures is None else measure_stride(measures, B, E, dev)
    if E == 0 or n_dst == 0 or B == 0:  # a grid of 0 blocks is an invalid launch
        return torch.full((B, n_dst), IDENTITY[op], dtype=torch.float32, device=dev), False
    block_idx = n_active = None
    if blocks is not None:
        block_idx, n_active = blocks
        check_block_list(block_idx, n_active, E, dev)
    y, s, rb = row_scratch(B, n_dst, op, dev)
    launch(
        build().fragment_spmm_launch, kernel, dev,
        weights.data_ptr(), n_src, B, src_ids.data_ptr(), dst_ids.data_ptr(),
        measures.data_ptr() if measures is not None else None, stride, E,
        y.data_ptr(), n_dst, OP_CODE[op],
        block_idx.data_ptr() if blocks is not None else None,
        block_idx.shape[0] if blocks is not None else 0,
        n_active.data_ptr() if blocks is not None else None,
        2**31 - 1 if scan_above is None else int(scan_above), s.data_ptr(), rb,
        int(bool(table)), stream_of(dev),
    )
    return y, True


def fragment_spmm(
    weights: torch.Tensor,  # f32[B, n_src], CUDA
    src_ids: torch.Tensor,  # i32[E], src-sorted CSR order
    dst_ids: torch.Tensor,  # i32[E]
    measures: torch.Tensor | None,  # f32[E] shared | f32[B, E] per row | None
    n_dst: int,
    op: str = "sum",
    table: bool = True,
) -> torch.Tensor:
    """Launch the batched scan hop; f32[B, n_dst] from the ⊕-identity.
    ``table``: aggregate per CTA (else each edge's chunk straight to the
    scratch). Raises on anything the kernel does not take (no plain
    fallback)."""
    global LAUNCHES
    y, launched = _launch(weights, src_ids, dst_ids, measures, n_dst, op, None, None, table,
                          "fragment_spmm")
    LAUNCHES += launched
    return y


def fragment_spmm_active(
    weights: torch.Tensor,
    src_ids: torch.Tensor,
    dst_ids: torch.Tensor,
    measures: torch.Tensor | None,
    block_idx: torch.Tensor,  # i32[C], the union of the rows' active blocks
    n_active: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    op: str = "sum",
    scan_above: int | None = None,
    table: bool = True,
) -> torch.Tensor:
    """Launch the batched block-skipping hop: only the blocks
    ``block_idx[:n_active]`` are streamed, each once a row chunk, or every
    block in scan order when ``n_active > scan_above``, by one wave of CTAs.
    ``n_active`` is read by the kernel, never by the host."""
    global ACTIVE_LAUNCHES
    y, launched = _launch(weights, src_ids, dst_ids, measures, n_dst, op,
                          (block_idx, n_active), scan_above, table, "fragment_spmm_active")
    ACTIVE_LAUNCHES += launched
    return y
