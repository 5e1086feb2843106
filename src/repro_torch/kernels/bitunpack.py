"""CUDA kernel for Hopper: BCA decode (paper §5 bit-aligned compressed array).

Layout contract (written by ``core.fragments._pack_words``): values are packed
little-endian at ``width`` bits each into a uint32 word stream, held here as an
int32 tensor of the same bits. :func:`bitunpack` decodes ``count`` of them into
int32 on the card; the kernel is ``csrc/bitunpack.cu``. Callers:
``PackedColumn`` / ``DictPackedColumn.materialize`` (whole-column decode for a
measure expression over a packed column, and the storage round trip).
"""
from __future__ import annotations

import torch

from .cuda_build import I32, I64, P, CudaLibrary, check_tensor, cuda_device, launch, stream_of
from .fragment_spmv_packed import words_needed

LIB = CudaLibrary("bitunpack", {"bitunpack_launch": [P, I64, I32, I64, P, P]})

#: Launches since import (or since a caller reset it): one per launch.
LAUNCHES = 0


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def bitunpack(words: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Decode ``count`` ``width``-bit values (1–32) on the card; int32[count].
    Raises on anything the kernel does not take (no plain fallback)."""
    global LAUNCHES
    dev = cuda_device(words, "bitunpack")
    check_tensor(words, "words", torch.int32, dev)
    width, count = int(width), int(count)
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in 1..32, got {width}")
    if count < 0 or words.shape[0] < words_needed(count, width):
        raise ValueError(
            f"{words.shape[0]} words cannot hold {count} values of {width} bits"
        )
    out = torch.empty(count, dtype=torch.int32, device=dev)
    if count == 0:
        return out
    launch(build().bitunpack_launch, "bitunpack", dev, words.data_ptr(), words.shape[0], width,
           count, out.data_ptr(), stream_of(dev))
    LAUNCHES += 1
    return out
