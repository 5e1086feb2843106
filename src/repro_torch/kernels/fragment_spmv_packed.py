"""CUDA kernels for Hopper: the decode-fused hop (paper §5-6) and its
block-skipping variant.

The packed-aware counterpart of :mod:`.fragment_spmv`: ``dst`` and/or the
measure arrive as BCA word streams (int32 tensors holding the uint32 words)
and are decoded inside the hop, edge by edge in registers — the
fused-decompression design that is GQ-Fast's headline result. The decoded
columns never reach device memory. Measure modes:

  * ``none``   — no measure operand; ⊗-factor 1 (COUNT/EXISTS hops);
  * ``dense``  — float32[E] (a measure expression that is not one packed
    column);
  * ``packed`` — BCA words; the decoded integers are the measures;
  * ``dict``   — BCA words of dictionary indices + the float32 dictionary.

The kernels are ``csrc/fragment_spmv_packed.cu``, which shares its per-edge
rules with the dense hop through ``csrc/hop.cuh``. Unlike the dense hop, they
combine each CTA's products per destination in a shared-memory table
(its shape fixed at build time in ``csrc/hop.cuh``) and issue one global
atomic per distinct destination a CTA: a Zipf-hot destination then costs an
atomic a CTA, not an atomic an edge. ``table=False`` keeps the atomic an
edge, which :func:`.ops.fragment_spmv_packed` chooses for an index without a
hot destination (``ops.uses_table``).
"""
from __future__ import annotations

import torch

from .cuda_build import I32, I64, P, CudaLibrary, check_tensor, cuda_device, launch, stream_of
from .fragment_spmv import OP_CODE, check_block_list
from .ref import IDENTITY

M_MODES = {"none": 0, "dense": 1, "packed": 2, "dict": 3}

LIB = CudaLibrary("fragment_spmv_packed", {
    "fragment_spmv_packed_launch": [
        P, I32, P, I64, P, I32, I64, I32, P, I32, I64, P, I32, P, I32, I32,
        P, I32, P, I32, I32, P,
    ],
})

#: Launches of each kernel since import (or since a caller reset them).
LAUNCHES = 0  # fragment_spmv_packed
ACTIVE_LAUNCHES = 0  # fragment_spmv_packed_active


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def words_needed(count: int, width: int) -> int:
    """Words of a ``count``-value ``width``-bit stream (``_pack_words`` pads
    to whole words only)."""
    return -(-count * width // 32)


def _check_words(words, name: str, width: int, E: int, dev) -> None:
    check_tensor(words, name, torch.int32, dev)
    if not 1 <= width <= 32:
        raise ValueError(f"{name} width must be in 1..32, got {width}")
    if words.shape[0] < words_needed(E, width):
        raise ValueError(
            f"{name} holds {words.shape[0]} words; {E} values of {width} bits "
            f"need {words_needed(E, width)}"
        )


def check_streams(dst, measure, mdict, E: int, dst_width: int, m_mode: str,
                  m_width: int, dev, name: str = "") -> int:
    """An E-edge hop's dst (int32 ids, or words when ``dst_width``) and
    measure (per ``m_mode``) on ``dev``; returns the dictionary's length (0
    outside the dict mode). ``name`` prefixes the argument names."""
    if dst_width:
        _check_words(dst, f"{name}dst", dst_width, E, dev)
    else:
        check_tensor(dst, f"{name}dst", torch.int32, dev)
        if dst.shape[0] != E:
            raise ValueError(f"{name}dst has {dst.shape[0]} edges, src {E}")
    if m_mode not in M_MODES:
        raise ValueError(f"unknown measure mode {m_mode!r}")
    if m_mode == "dense":
        check_tensor(measure, f"{name}measure", torch.float32, dev)
        if measure.shape[0] != E:
            raise ValueError(f"{name}measure has {measure.shape[0]} edges, src {E}")
    elif m_mode in ("packed", "dict"):
        _check_words(measure, f"{name}measure", m_width, E, dev)
        if m_mode == "dict":
            check_tensor(mdict, f"{name}mdict", torch.float32, dev)
            if mdict.shape[0] == 0:
                raise ValueError(f"{name}mdict is empty")
            return mdict.shape[0]
    return 0


def _launch(weights, src_ids, dst, measure, mdict, n_dst, dst_width, m_mode,
            m_width, op, blocks, scan_above, kernel, table):
    if op not in OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    if m_mode not in M_MODES:
        raise ValueError(f"unknown measure mode {m_mode!r}")
    dev = cuda_device(weights, kernel)
    check_tensor(weights, "weights", torch.float32, dev)
    check_tensor(src_ids, "src_ids", torch.int32, dev)
    E = src_ids.shape[0]
    n_dict = check_streams(dst, measure, mdict, E, dst_width, m_mode, m_width, dev)
    n_dst = int(n_dst)
    if n_dst < 0 or n_dst >= 2**31 or weights.shape[0] >= 2**31:
        raise ValueError(f"domain sizes must fit int32: n_src={weights.shape[0]}, n_dst={n_dst}")
    y = torch.full((n_dst,), IDENTITY[op], dtype=torch.float32, device=dev)
    if E == 0 or n_dst == 0:  # a grid of 0 blocks is an invalid launch
        return y, False
    block_idx = n_active = None
    if blocks is not None:
        block_idx, n_active = blocks
        check_block_list(block_idx, n_active, E, dev)
    launch(
        build().fragment_spmv_packed_launch, kernel, dev,
        weights.data_ptr(), weights.shape[0], src_ids.data_ptr(), E,
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
        int(bool(table)), stream_of(dev),
    )
    return y, True


def fragment_spmv_packed(
    weights: torch.Tensor,  # f32[n_src], CUDA
    src_ids: torch.Tensor,  # i32[E]
    dst: torch.Tensor,  # word stream if dst_width else i32[E]
    measure: torch.Tensor | None,  # per m_mode
    mdict: torch.Tensor | None,  # f32[u], m_mode == 'dict' only
    n_dst: int,
    dst_width: int = 0,
    m_mode: str = "none",
    m_width: int = 0,
    op: str = "sum",
    table: bool = True,
) -> torch.Tensor:
    """Launch the decode-fused scan hop; f32[n_dst] from the ⊕-identity.
    ``table``: aggregate per CTA (else an atomic an edge). Raises on
    anything the kernel does not take (no plain fallback)."""
    global LAUNCHES
    y, launched = _launch(weights, src_ids, dst, measure, mdict, n_dst, dst_width,
                          m_mode, m_width, op, None, None, "fragment_spmv_packed", table)
    LAUNCHES += launched
    return y


def fragment_spmv_packed_active(
    weights: torch.Tensor,
    src_ids: torch.Tensor,
    dst: torch.Tensor,
    measure: torch.Tensor | None,
    mdict: torch.Tensor | None,
    block_idx: torch.Tensor,  # i32[C], device-resident block list
    n_active: torch.Tensor,  # i32[1], device-resident
    n_dst: int,
    dst_width: int = 0,
    m_mode: str = "none",
    m_width: int = 0,
    op: str = "sum",
    scan_above: int | None = None,
    table: bool = True,
) -> torch.Tensor:
    """Launch the decode-fused block-skipping hop: only the listed blocks are
    streamed and decoded, or every block in scan order when ``n_active >
    scan_above``. ``n_active`` is read by the kernel, never by the host."""
    global ACTIVE_LAUNCHES
    y, launched = _launch(weights, src_ids, dst, measure, mdict, n_dst, dst_width,
                          m_mode, m_width, op, (block_idx, n_active), scan_above,
                          "fragment_spmv_packed_active", table)
    ACTIVE_LAUNCHES += launched
    return y
