"""CUDA kernels for Hopper: fused fragment join-aggregate (one relationship
hop) over dense columns, and its block-skipping variant.

y[dst] ⊕= w[src] ⊗ m over the edge list of a GQ-Fast index — the frontier SpMV
that every ⋈/⋉+γ hop lowers to. The combine op ⊕ is a parameter (``op``:
'sum' | 'min' | 'max' | 'bool'), matching the executor's semiring plug-in
point. The kernels are ``csrc/fragment_spmv.cu`` (its header says what bounds
them and how they are built around that), compiled at first use by
:mod:`.cuda_build` and launched on the current stream. ``table=True``
combines each CTA's products per destination in a shared-memory table before
they touch y (an index with a hot destination); ``table=False`` issues an
atomic an edge (destinations spread). :func:`.ops.fragment_spmv`
chooses by the index's hot share (``ops.uses_table``).
"""
from __future__ import annotations

import torch

from .active import n_edge_blocks
from .cuda_build import I32, I64, P, CudaLibrary, check_tensor, cuda_device, launch, stream_of
from .ref import IDENTITY

OP_CODE = {"sum": 0, "min": 1, "max": 2, "bool": 3}

LIB = CudaLibrary("fragment_spmv", {
    "fragment_spmv_launch": [P, I32, P, P, P, I64, P, I32, I32, I32, P],
    "fragment_spmv_active_launch": [P, I32, P, P, P, I64, P, I32, I32, P, I32, P, I32, I32, P],
})

#: Launches of each kernel since import (or since a caller reset them): one
#: per launch, counted nowhere else — the evidence that a run went through it.
LAUNCHES = 0  # fragment_spmv
ACTIVE_LAUNCHES = 0  # fragment_spmv_active


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def check_block_list(block_idx, n_active, E: int, dev) -> None:
    """A block list for an E-edge index: ``block_idx`` int32 with at most
    ceil(E / EDGE_BLOCK) entries, ``n_active`` int32[1], both on ``dev``."""
    check_tensor(block_idx, "block_idx", torch.int32, dev)
    check_tensor(n_active, "n_active", torch.int32, dev)
    if n_active.shape[0] != 1:
        raise ValueError(f"n_active must have one entry, got {n_active.shape[0]}")
    if not 1 <= block_idx.shape[0] <= n_edge_blocks(E):
        raise ValueError(
            f"block_idx has {block_idx.shape[0]} entries; an index of {E} edges "
            f"has {n_edge_blocks(E)} blocks"
        )


def _hop_args(weights, src_ids, dst_ids, measures, n_dst, op, kernel):
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = cuda_device(weights, kernel)
    check_tensor(weights, "weights", torch.float32, dev)
    check_tensor(src_ids, "src_ids", torch.int32, dev)
    check_tensor(dst_ids, "dst_ids", torch.int32, dev)
    E = src_ids.shape[0]
    if dst_ids.shape[0] != E:
        raise ValueError(f"dst_ids has {dst_ids.shape[0]} edges, src_ids {E}")
    if measures is not None:
        check_tensor(measures, "measures", torch.float32, dev)
        if measures.shape[0] != E:
            raise ValueError(f"measures has {measures.shape[0]} edges, src_ids {E}")
    n_dst = int(n_dst)
    if n_dst < 0 or n_dst >= 2**31 or weights.shape[0] >= 2**31:
        raise ValueError(f"domain sizes must fit int32: n_src={weights.shape[0]}, n_dst={n_dst}")
    y = torch.full((n_dst,), IDENTITY[op], dtype=torch.float32, device=dev)
    return dev, E, n_dst, y


def fragment_spmv(
    weights: torch.Tensor,  # f32[n_src], CUDA
    src_ids: torch.Tensor,  # i32[E], src-sorted CSR order
    dst_ids: torch.Tensor,  # i32[E]
    measures: torch.Tensor | None,  # f32[E] | None (measure 1 on every edge)
    n_dst: int,
    op: str = "sum",
    table: bool = True,
) -> torch.Tensor:
    """Launch the scan hop kernel; returns f32[n_dst] starting from the
    ⊕-identity. ``table``: aggregate per CTA (else an atomic an edge).
    Raises on anything the kernel does not take — it never falls back to the
    plain version."""
    global LAUNCHES
    dev, E, n_dst, y = _hop_args(weights, src_ids, dst_ids, measures, n_dst, op,
                                 "fragment_spmv")
    if E == 0 or n_dst == 0:  # a grid of 0 blocks is an invalid launch
        return y
    launch(
        build().fragment_spmv_launch, "fragment_spmv", dev,
        weights.data_ptr(), weights.shape[0], src_ids.data_ptr(),
        dst_ids.data_ptr(), measures.data_ptr() if measures is not None else None,
        E, y.data_ptr(), n_dst, OP_CODE[op], int(bool(table)), stream_of(dev),
    )
    LAUNCHES += 1
    return y


def fragment_spmv_active(
    weights: torch.Tensor,
    src_ids: torch.Tensor,
    dst_ids: torch.Tensor,
    measures: torch.Tensor | None,
    block_idx: torch.Tensor,  # i32[C], device-resident block list
    n_active: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    op: str = "sum",
    scan_above: int | None = None,
    table: bool = True,
) -> torch.Tensor:
    """Launch the block-skipping hop kernel: only the blocks
    ``block_idx[:n_active]`` are streamed, or every block in scan order when
    ``n_active > scan_above`` (``None``: never), by one wave of CTAs striding
    over the list. ``n_active`` is read by the kernel, never by the host."""
    global ACTIVE_LAUNCHES
    dev, E, n_dst, y = _hop_args(weights, src_ids, dst_ids, measures, n_dst, op,
                                 "fragment_spmv_active")
    if E == 0 or n_dst == 0:
        return y
    check_block_list(block_idx, n_active, E, dev)
    launch(
        build().fragment_spmv_active_launch, "fragment_spmv_active", dev,
        weights.data_ptr(), weights.shape[0], src_ids.data_ptr(),
        dst_ids.data_ptr(), measures.data_ptr() if measures is not None else None,
        E, y.data_ptr(), n_dst, OP_CODE[op], block_idx.data_ptr(),
        block_idx.shape[0], n_active.data_ptr(),
        2**31 - 1 if scan_above is None else int(scan_above), int(bool(table)),
        stream_of(dev),
    )
    ACTIVE_LAUNCHES += 1
    return y
