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

The memo keeps one decoded copy per column, shared by every caller. Around
it sit the reference's fault site ``storage.materialize`` and, once an
integrity manifest is attached (``storage/integrity.py``), verified reads:
every decoded value a read returns is hashed (CRC-32C, on the card for a
column there) against the manifest's digest, a transient mismatch heals from
the memo, a persistent one raises :class:`~repro_torch.robust.errors.
IntegrityError`, and a column the scrubber quarantined raises on every read.
With no manifest attached a read costs nothing more.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..kernels.ref import bitgather_ref as _gather_packed
from ..robust import faults as _faults

#: Re-reads a verified materialize attempts before declaring the corruption
#: persistent and raising IntegrityError (a transient flip heals from the
#: memo; repeated mismatches mean the stored state itself is bad).
READ_HEAL_RETRIES = 2


def _quarantine_check(col) -> None:
    if col._quarantined:
        from ..obs.metrics import REGISTRY
        from ..robust.errors import IntegrityError

        t, k, name = col._addr or ("?", "?", "?")
        REGISTRY.counter("robust.integrity.quarantined_reads").inc()
        raise IntegrityError(
            f"column I_{t}.{k}/{name} is quarantined pending repair",
            table=t, key=k, column=name, quarantined=True,
        )


def _verify_read(col, value, reread):
    """Integrity-verified read (active only once a manifest is attached):
    hash the decoded bytes against the recorded digest. On mismatch, re-read
    up to :data:`READ_HEAL_RETRIES` times — the memo holds the true decode,
    so a *transient* corruption (a fault-injected flipped read) heals
    silently (``robust.integrity.read_heals``); a mismatch that survives
    every re-read is persistent and raises
    :class:`~repro_torch.robust.errors.IntegrityError` rather than letting
    the bad bytes reach a hop."""
    from .integrity import crc32c

    if crc32c(value) == col._expected_crc:
        return value
    from ..obs.metrics import REGISTRY
    from ..robust.errors import IntegrityError

    REGISTRY.counter("robust.integrity.read_failures").inc()
    actual = None
    for _ in range(READ_HEAL_RETRIES):
        value = reread()
        actual = crc32c(value)
        if actual == col._expected_crc:
            REGISTRY.counter("robust.integrity.read_heals").inc()
            return value
    t, k, name = col._addr or ("?", "?", "?")
    raise IntegrityError(
        f"decoded column I_{t}.{k}/{name} failed checksum verification",
        table=t, key=k, column=name,
        expected_crc=col._expected_crc, actual_crc=actual,
    )


def _memo_materialize(col, decode, use_kernel: bool):
    """Decode a column whole once and keep the copy (``col._dense``).
    ``use_kernel=False`` decodes with the plain version and bypasses the memo,
    so an on-card comparison never reads the kernel's decode.

    Fault site ``storage.materialize``: fires before the decode;
    corrupt-mode specs transform only the *returned* value, after the memo
    read/write, so the memo always holds the true decode
    (corrupt-then-restore). With an integrity manifest attached every
    returned value is checksum-verified (:func:`_verify_read`)."""
    _faults.fire("storage.materialize", kind=col.kind)
    verified = col._expected_crc is not None or col._quarantined
    if verified:
        _quarantine_check(col)
    if use_kernel:
        if col._dense is None:
            col._dense = decode(True)

        def read():
            return _faults.corrupt("storage.materialize", col._dense)
    else:
        def read():
            return _faults.corrupt("storage.materialize", decode(False))
    return _verify_read(col, read(), read) if verified else read()


class DeviceColumn:
    """Abstract device-resident column; see the module docstring."""

    kind: str = "abstract"
    count: int

    # integrity state (class-level defaults = zero-cost until a manifest is
    # attached via storage/integrity.py; attach sets instance attributes)
    _expected_crc: int | None = None  # decoded-view CRC-32C to verify reads
    _addr: tuple | None = None  # (table, key, column) for error context
    _quarantined: bool = False  # scrubber-detected, pending repair

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
        if self._expected_crc is not None or self._quarantined:
            # a dense column IS its own storage: there is no memo to heal a
            # mismatch from, so a failed verification is always persistent
            _quarantine_check(self)
            return _verify_read(self, self.array, lambda: self.array)
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
