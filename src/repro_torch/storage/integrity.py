"""Column integrity: CRC-32C digests over the device column store.

The engine's value rests on carefully encoded device columns (§5 dense IDs,
BCA/dictionary-packed words); a flipped bit in one packed word silently
poisons every query that streams it. This module gives every device-resident
column a verifiable identity, with the reference's values
(``repro.storage.integrity``) digest for digest:

  * :func:`crc32c` — CRC-32C (Castagnoli), the storage-industry checksum
    (iSCSI, ext4, Parquet pages). A tensor is hashed where it lies: on the
    card by the CUDA kernel (``kernels/csrc/crc32c.cu``), with no copy to
    the host; on the CPU by its plain PyTorch version. Host data (bytes,
    numpy arrays) is hashed on ``device``, the card unless the caller asks
    for the CPU.
  * :func:`column_digest` — per-column digest of both physical layers:
    ``encoded_crc`` over the stored device tensors exactly as device memory
    holds them (packed words / dense array / dictionary), and
    ``decoded_crc`` over the decoded view ``materialize()`` serves.
  * :func:`build_manifest` / :func:`attach_manifest` — the host-side
    manifest mapping ``I_<table>.<key>/<column>`` → digest, and its
    attachment to a live DB: once attached, ``materialize()`` verifies every
    decode against ``decoded_crc`` (storage/columns.py) and the scrubber
    (robust/scrub.py) re-hashes encoded bytes against ``encoded_crc`` a few
    columns per tick.

Packed words are int32 tensors holding the uint32 words' bits, so their bytes
— and digests — equal the reference's.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from .columns import DenseColumn, DeviceColumn, DictPackedColumn, PackedColumn


def _byte_tensor(data: Any, device) -> torch.Tensor:
    """``data`` as a contiguous tensor whose bytes are hashed: a tensor as it
    lies, host data (bytes, numpy arrays, lists) on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.contiguous()
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.ascontiguousarray(np.asarray(data)).reshape(-1).view(np.uint8)
    if not arr.flags.writeable:  # torch.from_numpy shares memory it may write
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def crc32c(data: Any, value: int = 0, device="cuda") -> int:
    """CRC-32C of ``data`` (bytes, an array or a tensor), continuing from
    ``value`` so multi-part digests (packed words + dictionary) chain one
    checksum. A tensor is hashed on its own device; host data on
    ``device``."""
    from ..kernels import ops as K

    return int(K.crc32c(_byte_tensor(data, device), value))


def crc32c_parts(parts: Iterable[Any], device="cuda") -> int:
    """One chained CRC over an ordered sequence of buffers/arrays/tensors."""
    crc = 0
    for p in parts:
        crc = crc32c(p, crc, device)
    return crc


# ---------------------------------------------------------------------------
# Column digests
# ---------------------------------------------------------------------------


def encoded_parts(col: DeviceColumn) -> list[torch.Tensor]:
    """The stored device tensors of ``col`` in digest order — exactly what
    device memory holds, no decode. The scrubber re-reads these."""
    if isinstance(col, DenseColumn):
        return [col.array]
    if isinstance(col, DictPackedColumn):
        return [col.words, col.dictionary]
    if isinstance(col, PackedColumn):
        return [col.words]
    raise TypeError(f"not a device column: {type(col).__name__}")


def decode_fresh(col: DeviceColumn) -> torch.Tensor:
    """The decoded view of ``col`` computed directly from the encoded tensors
    (``ops.bitunpack``: the CUDA kernel on the card) — byte-identical to
    ``materialize()`` but bypassing the memo and the ``storage.materialize``
    fault site, so it is the trusted baseline while a corrupt-mode fault plan
    is live."""
    from ..kernels import ops as K

    if isinstance(col, DenseColumn):
        return col.array
    if isinstance(col, DictPackedColumn):
        return col.dictionary[K.bitunpack(col.words, col.width, col.count).to(torch.int64)]
    if isinstance(col, PackedColumn):
        return K.bitunpack(col.words, col.width, col.count).to(col.out_dtype)
    raise TypeError(f"not a device column: {type(col).__name__}")


def column_digest(col: DeviceColumn) -> dict[str, Any]:
    """Both-layer digest of one column: the encoded bytes as stored and the
    decoded view as served."""
    return {
        "kind": col.kind,
        "count": int(col.count),
        "encoded_crc": crc32c_parts(encoded_parts(col)),
        "decoded_crc": crc32c(decode_fresh(col)),
    }


def iter_columns(device_db) -> list[tuple[str, tuple[str, str], str, DeviceColumn]]:
    """Every device column as ``(addr, (table, key), column_name, col)``;
    ``addr`` is the manifest key ``I_<t>.<k>/<col>``."""
    out = []
    for (t, k), di in device_db.indexes.items():
        for name, col in [("__dst__", di.dst_col), *di.measure_cols.items()]:
            out.append((f"I_{t}.{k}/{name}", (t, k), name, col))
    return out


def build_manifest(device_db) -> dict[str, dict[str, Any]]:
    """Digest every device column of a (trusted, freshly built or freshly
    verified) DB. This is the host-side source of truth the verified-read
    path and the scrubber check against."""
    return {addr: column_digest(col) for addr, _, _, col in iter_columns(device_db)}


def attach_manifest(device_db, manifest: dict[str, dict[str, Any]] | None = None,
                    verify_reads: bool = True) -> dict[str, dict[str, Any]]:
    """Install ``manifest`` (built fresh when None) on ``device_db`` and on
    each column. With ``verify_reads`` every subsequent ``materialize()`` of
    a packed/dict/dense column checks its decoded bytes against the digest
    (storage/columns.py) — corruption is detected at the read that would
    otherwise poison a hop, healed from the memo when transient, raised as
    :class:`repro_torch.robust.errors.IntegrityError` when persistent."""
    if manifest is None:
        manifest = build_manifest(device_db)
    device_db.integrity = manifest
    for addr, (t, k), name, col in iter_columns(device_db):
        dig = manifest.get(addr)
        if dig is None:
            continue
        col._addr = (t, k, name)
        col._expected_crc = int(dig["decoded_crc"]) if verify_reads else None
    return manifest


def detach_manifest(device_db) -> None:
    """Remove integrity state — columns return to zero-overhead reads."""
    if getattr(device_db, "integrity", None) is not None:
        device_db.integrity = None
    for _, _, _, col in iter_columns(device_db):
        col._expected_crc = None
        col._addr = None
        col._quarantined = False
