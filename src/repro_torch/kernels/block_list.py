"""CUDA kernel for Hopper: a hop's active-block list in one launch.

From a frontier ``w`` (``[n_src]``, or ``[B, n_src]`` whose support is the OR
over the rows), the combine op's ⊕-identity and an index's per-block source
ranges ``[src_min, src_max]``, the kernel ``csrc/block_list.cu`` (its header
says what bounds it and how it is built around that: one pass, each CTA a tile
of blocks placing its ids by decoupled look-back) writes the fixed-capacity
list ``(block_idx int32[n_blocks], n_active int32[1])`` that the active hop
kernels follow: the listed ids ascending, the tail repeating the last one,
position 0 when none is listed — the lists of
:func:`.active.active_block_list`, the plain version, id for id. It replaces
that version's 14 eager calls a hop with one launch; ``n_active`` stays on
the card. Compiled at first use by :mod:`.cuda_build`, launched on the current
stream.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import (
    I32,
    I64,
    P,
    CudaLibrary,
    check_tensor,
    cuda_device,
    launch,
    stream_of,
    stream_scratch,
)

LIB = CudaLibrary("block_list", {
    "block_list_launch": [P, I32, I64, ctypes.c_float, P, P, I32, P, P, P, P, P],
})

#: Launches since import (or since a caller reset it): one per launch,
#: counted nowhere else.
LAUNCHES = 0

#: Blocks a CTA of the kernel tests (its tile; ``kWarps`` in the source).
TILE = 32
#: The most blocks a list takes (a tile's ids and counts stay under 2^31).
MAX_BLOCKS = 2**31 - 1 - TILE


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def scratch_tiles(nb: int) -> int:
    """The status words kept for a list of ``nb`` blocks: its tiles rounded
    up to a power of two (at least 1,024), so that a stream keeps a few
    buffers however many index sizes it lists."""
    return max(1024, 1 << (-(-nb // TILE) - 1).bit_length())


def block_list(w: torch.Tensor, zero: float, src_min: torch.Tensor, src_max: torch.Tensor,
               flags: bool = False):
    """Launch the list kernel: ``(block_idx, n_active)``, and with ``flags``
    also ``bool[n_blocks]``, each block's test (what a fused region's reach
    matrix reads). Allocates its outputs with ``torch.empty`` only; raises on
    anything the kernel does not take (no plain fallback). The first launch
    on a stream at a size class also makes that stream's status buffer (one
    ``torch.zeros``), which every launch leaves zero."""
    global LAUNCHES
    dev = cuda_device(w, "block_list")
    if w.dim() not in (1, 2):
        raise ValueError(f"w must be [n_src] or [B, n_src], got shape {tuple(w.shape)}")
    check_tensor(w, "w", torch.float32, dev, ndim=w.dim())
    check_tensor(src_min, "src_min", torch.int32, dev)
    check_tensor(src_max, "src_max", torch.int32, dev)
    nb = src_min.shape[0]
    if src_max.shape[0] != nb or nb == 0:
        raise ValueError(f"src_min and src_max must have one entry a block (got {nb} and "
                         f"{src_max.shape[0]}, at least 1)")
    B, n_src = (1, w.shape[0]) if w.dim() == 1 else tuple(w.shape)
    if n_src >= 2**31 or B >= 2**31 or nb > MAX_BLOCKS:
        raise ValueError(f"sizes must fit int32: B={B}, n_src={n_src}, n_blocks={nb} (at most"
                         f" {MAX_BLOCKS} blocks)")
    block_idx = torch.empty(nb, dtype=torch.int32, device=dev)
    n_active = torch.empty(1, dtype=torch.int32, device=dev)
    fl = torch.empty(nb, dtype=torch.bool, device=dev) if flags else None
    stream = stream_of(dev)
    cap = scratch_tiles(nb)
    # 16 bytes of counter and ticket, then a status word a tile
    scratch = stream_scratch(f"block_list/{cap}", 2 + cap, torch.int64, dev, stream)
    launch(
        build().block_list_launch, "block_list", dev,
        w.data_ptr(), B, n_src, float(zero), src_min.data_ptr(), src_max.data_ptr(), nb,
        block_idx.data_ptr(), n_active.data_ptr(),
        fl.data_ptr() if flags else None, scratch.data_ptr(), stream,
    )
    LAUNCHES += 1
    return (block_idx, n_active, fl) if flags else (block_idx, n_active)
