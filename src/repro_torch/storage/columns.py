"""Device column store (paper §5-6): per-column physical representation.

GQ-Fast's central claim is that heavyweight compression and fully pipelined
execution coexist: dense encodings (BCA / the dictionary substitute for
Huffman) have no random access, so decompression happens inside the operator,
never as a load-time pass. Whether a column lives decoded or packed is a
per-column physical property the rest of the engine is agnostic to:

  * :class:`DenseColumn`      — full-width int32/float32 device tensor;
  * :class:`PackedColumn`     — BCA on device: little-endian ``width``-bit
    values in a word stream (``core.fragments._pack_words`` layout, held as
    an int32 tensor of the uint32 words' bits). The hop kernel decodes it
    edge by edge; ``materialize()`` decodes it whole;
  * :class:`DictPackedColumn` — a frequency-sorted dictionary plus packed
    dictionary indices (index width = ⌈log2 #distinct⌉).

Contract every kind honours:

  * ``materialize()`` — the full decoded device tensor (through
    ``kernels.ops.bitunpack``: the CUDA kernel on the card);
  * ``gather(ids)``   — decoded values at ``ids`` without materialising;
  * ``device_nbytes`` — bytes the column occupies in device memory;
  * ``materialized_nbytes`` — bytes of the decoded copy the materialise memo
    pins (0 until something decoded the column whole).

The memo keeps one decoded copy per column, shared by every caller. The
reference's fault-injection site and integrity-verified reads around it come
with the robustness and durability slices (ROADMAP Queue 1 items 10 and 11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..kernels.ref import bitgather_ref as _gather_packed


def _memo_materialize(col, decode, use_kernel: bool):
    """Decode a column whole once and keep the copy (``col._dense``).
    ``use_kernel=False`` decodes with the plain version and bypasses the memo,
    so an on-card comparison never reads the kernel's decode."""
    if not use_kernel:
        return decode(False)
    if col._dense is None:
        col._dense = decode(True)
    return col._dense


class DeviceColumn:
    """Abstract device-resident column; see the module docstring."""

    kind: str = "abstract"
    count: int

    def materialize(self, use_kernel: bool = True) -> torch.Tensor:
        raise NotImplementedError

    def gather(self, ids) -> torch.Tensor:
        raise NotImplementedError

    @property
    def device_nbytes(self) -> int:
        raise NotImplementedError

    @property
    def materialized_nbytes(self) -> int:
        """Bytes of the decoded copy the ``materialize()`` memo pins,
        reported apart from ``device_nbytes``: while it is held a packed
        column occupies packed + dense bytes."""
        d = getattr(self, "_dense", None)
        return d.numel() * d.element_size() if d is not None else 0


@dataclass(eq=False)
class DenseColumn(DeviceColumn):
    """Fully decoded device tensor — zero-cost materialize."""

    array: Any  # torch.Tensor

    kind = "dense"

    @property
    def count(self) -> int:
        return int(self.array.shape[0])

    def materialize(self, use_kernel: bool = True) -> torch.Tensor:
        return self.array

    def gather(self, ids) -> torch.Tensor:
        return self.array[torch.as_tensor(ids, device=self.array.device).to(torch.int64)]

    @property
    def device_nbytes(self) -> int:
        return self.array.numel() * self.array.element_size()


@dataclass(eq=False)
class PackedColumn(DeviceColumn):
    """BCA device layout: ``count`` values at ``width`` bits in a word stream."""

    words: Any  # torch.Tensor int32 (the uint32 words' bits)
    width: int
    count: int
    out_dtype: Any = torch.int32
    _dense: Any = field(default=None, repr=False)  # materialize() memo

    kind = "packed"

    def materialize(self, use_kernel: bool = True) -> torch.Tensor:
        from ..kernels import ops as K

        return _memo_materialize(
            self,
            lambda uk: K.bitunpack(self.words, self.width, self.count,
                                   use_kernel=uk).to(self.out_dtype),
            use_kernel,
        )

    def gather(self, ids) -> torch.Tensor:
        return _gather_packed(self.words, self.width, ids).to(self.out_dtype)

    @property
    def device_nbytes(self) -> int:
        return self.words.numel() * 4


@dataclass(eq=False)
class DictPackedColumn(DeviceColumn):
    """Dictionary + packed indices: value[i] = dictionary[unpack(words)[i]].

    ``dictionary`` is frequency-sorted (popular values get small indices); the
    hop kernel reads it through the read-only cache path."""

    words: Any  # torch.Tensor int32 — packed dictionary indices
    width: int  # ⌈log2 #distinct⌉
    count: int
    dictionary: Any  # torch.Tensor float32 — index → value
    _dense: Any = field(default=None, repr=False)  # materialize() memo

    kind = "dict"

    def materialize(self, use_kernel: bool = True) -> torch.Tensor:
        from ..kernels import ops as K

        return _memo_materialize(
            self,
            lambda uk: self.dictionary[
                K.bitunpack(self.words, self.width, self.count, use_kernel=uk).to(torch.int64)
            ],
            use_kernel,
        )

    def gather(self, ids) -> torch.Tensor:
        return self.dictionary[_gather_packed(self.words, self.width, ids).to(torch.int64)]

    @property
    def device_nbytes(self) -> int:
        return self.words.numel() * 4 + self.dictionary.numel() * self.dictionary.element_size()
