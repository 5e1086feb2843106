"""CUDA kernel for Hopper: CRC-32C (Castagnoli) of a byte stream, chainable.

Not a TPU kernel: the reference hashes its column store on the host
(``repro.storage.integrity.crc32c``). The port hashes the device column store
where it lives — manifests, verified reads, snapshots and the scrubber
(``storage/integrity.py``) — with the same 32-bit values. The kernel is
``csrc/crc32c.cu`` (its header says how the stream is split and combined);
its plain version is ``ref.crc32c_ref``, the same chunked algorithm in
PyTorch. :func:`crc32c` hashes a contiguous tensor of any type as its bytes,
in one launch that writes the value itself, its last CTA leaving the stream's
scratch at zero.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import I64, P, CudaLibrary, check_tensor, cuda_device, launch, stream_of, stream_scratch

LIB = CudaLibrary("crc32c", {"crc32c_launch": [P, I64, ctypes.c_uint32, P, P, P]})

#: Launches since import (or since a caller reset it): one per launch.
LAUNCHES = 0


def build():
    """Compile (if needed) and load the kernel library; idempotent."""
    return LIB.load()


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a 1-D uint8 view (no copy)."""
    if not t.is_contiguous():
        raise ValueError("crc32c hashes a contiguous tensor (materialise views first)")
    if t.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.reshape(-1).view(torch.uint8)


def crc32c(data: torch.Tensor, value: int = 0) -> torch.Tensor:
    """CRC-32C of the bytes of ``data`` (a contiguous CUDA tensor of any
    type) continuing from ``value``, computed on the card: a 0-d int64
    tensor there holding the unsigned 32-bit value (the host does not wait
    for it). Empty data gives ``value`` without a launch. Raises on anything
    the kernel does not take (no plain fallback)."""
    global LAUNCHES
    dev = cuda_device(data, "crc32c")
    b = as_bytes(data)
    check_tensor(b, "data", torch.uint8, dev)
    value = int(value) & 0xFFFFFFFF
    out = torch.empty((), dtype=torch.int64, device=dev)
    if b.shape[0] == 0:
        return out.fill_(value)
    stream = stream_of(dev)
    # 8 bytes: the CTAs' XOR and the last-CTA ticket
    scratch = stream_scratch("crc32c", 2, torch.int32, dev, stream)
    launch(build().crc32c_launch, "crc32c", dev, b.data_ptr(), b.shape[0], value,
           scratch.data_ptr(), out.data_ptr(), stream)
    LAUNCHES += 1
    return out
