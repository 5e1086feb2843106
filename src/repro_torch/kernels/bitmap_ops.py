"""CUDA kernels for Hopper: bitmap intersection (paper §6.1 merge-intersection).

Word-wise AND of two uint32 bitmaps, and the popcount of the AND: the
cardinality of the intersection of two sets held as bitmaps, 32 ids to a word.
Words are int32 tensors holding the uint32 bits, as the BCA word streams are.
The kernels are ``csrc/bitmap_ops.cu`` (its header says what bounds them and
how they are built around that): one wave of CTAs streaming 16-byte words
with evict-first loads where the operands share their alignment, and the
popcount in one launch that writes its int32 count itself, its last CTA
leaving the stream's scratch at zero.
"""
from __future__ import annotations

import torch

from .cuda_build import (
    I64,
    P,
    CudaLibrary,
    check_tensor,
    cuda_device,
    launch,
    stream_of,
    stream_scratch,
)

LIB = CudaLibrary("bitmap_ops", {
    "bitmap_and_launch": [P, P, P, I64, P],
    "bitmap_and_popcount_launch": [P, P, I64, P, P, P],
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
    launch(build().bitmap_and_launch, "bitmap_and", dev, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), n, stream_of(dev))
    AND_LAUNCHES += 1
    return out


def bitmap_and_popcount(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The set bits of ``a & b`` counted on the card in one kernel launch; a
    0-d int32 tensor there (the host does not wait for it). Raises on
    anything the kernel does not take, and past :data:`MAX_POPCOUNT_WORDS`
    words. The first launch on a stream also makes that stream's scratch
    (one ``torch.zeros``)."""
    global POPCOUNT_LAUNCHES
    dev = cuda_device(a, "bitmap_and_popcount")
    n = check_pair(a, b, dev)
    check_popcount_words(n)
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    stream = stream_of(dev)
    # 16 bytes: the CTAs' 64-bit sum and the last-CTA ticket
    scratch = stream_scratch("bitmap_and_popcount", 2, torch.int64, dev, stream)
    launch(build().bitmap_and_popcount_launch, "bitmap_and_popcount", dev, a.data_ptr(),
           b.data_ptr(), n, scratch.data_ptr(), count.data_ptr(), stream)
    POPCOUNT_LAUNCHES += 1
    return count
