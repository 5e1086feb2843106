"""CUDA kernels for Hopper: bitmap intersection (paper §6.1 merge-intersection).

Word-wise AND of two uint32 bitmaps, and the popcount of the AND: the
cardinality of the intersection of two sets held as bitmaps, 32 ids to a word.
Words are int32 tensors holding the uint32 bits, as the BCA word streams are.
The kernels are ``csrc/bitmap_ops.cu``: 16-byte vector loads where the
operands share their alignment, and for the popcount one 64-bit atomic a CTA.
"""
from __future__ import annotations

import torch

from .cuda_build import I64, P, CudaLibrary, check_tensor, cuda_device, raise_on, stream_of

LIB = CudaLibrary("bitmap_ops", {
    "bitmap_and_launch": [P, P, P, I64, P],
    "bitmap_and_popcount_launch": [P, P, I64, P, P],
})

#: Launches of each kernel since import (or since a caller reset them).
AND_LAUNCHES = 0  # bitmap_and
POPCOUNT_LAUNCHES = 0  # bitmap_and_popcount

#: The most words a popcount takes: from 2^26 words on, the count of set bits
#: can pass 2^31 - 1, where the reference's int32 sum wraps; the port refuses.
MAX_POPCOUNT_WORDS = 2**26 - 1


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def check_pair(a, b, dev=None) -> int:
    """Two 1-D int32 word tensors of one length (on ``dev`` when given);
    returns the length."""
    dev = a.device if dev is None else dev
    check_tensor(a, "a", torch.int32, dev)
    check_tensor(b, "b", torch.int32, dev)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"bitmaps differ in length: {a.shape[0]} and {b.shape[0]} words")
    return a.shape[0]


def check_popcount_words(n: int) -> None:
    if n > MAX_POPCOUNT_WORDS:
        raise ValueError(
            f"{n} words can hold more than 2^31 - 1 set bits, past an int32 count; "
            f"at most {MAX_POPCOUNT_WORDS} words"
        )


def bitmap_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & b`` word by word on the card; int32[n]. Raises on anything the
    kernel does not take (no plain fallback)."""
    global AND_LAUNCHES
    dev = cuda_device(a, "bitmap_and")
    n = check_pair(a, b, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(dev):
        err = lib.bitmap_and_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                    stream_of(dev))
    raise_on(err, "bitmap_and")
    AND_LAUNCHES += 1
    return out


def bitmap_and_popcount(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The set bits of ``a & b`` counted on the card; a 0-d int32 tensor there
    (the host does not wait for it). Raises on anything the kernel does not
    take, and past :data:`MAX_POPCOUNT_WORDS` words."""
    global POPCOUNT_LAUNCHES
    dev = cuda_device(a, "bitmap_and_popcount")
    n = check_pair(a, b, dev)
    check_popcount_words(n)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        return count.to(torch.int32)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.bitmap_and_popcount_launch(a.data_ptr(), b.data_ptr(), n, count.data_ptr(),
                                             stream_of(dev))
    raise_on(err, "bitmap_and_popcount")
    POPCOUNT_LAUNCHES += 1
    return count.to(torch.int32)
