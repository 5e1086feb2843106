"""Device storage policy: per-column encoding choice + real device-byte report.

Extends the paper's §5 space model from the host byte-array encodings to the
*device* representations the kernels read. Candidate layouts per column
(sizes in device bytes, uint32-word granularity):

  dense   4·E                          (full-width int32/float32 CSR tensor)
  packed  4·⌈E·w/32⌉                   w = ⌈log2 D⌉        (BCA on device)
  dict    4·⌈E·w_u/32⌉ + 4·u           w_u = ⌈log2 u⌉, u = #distinct values

The chooser picks the minimum — the Fig. 12 decision procedure evaluated on
the device layouts. Keys (the hop's dst column) never take ``dict``: the hop
kernel decodes them straight to entity ids, and FK domains are already dense.
Columns needing ≥ 32 bits stay dense, and signed columns never bit-pack (the
bit layouts are unsigned, codecs §5 contract) though ``dict`` still applies.

``resolve_device_encoding`` layers the user-facing override surface
(``GQFastDatabase(device_encodings=...)``) on top: a global mode
(``"auto" | "dense" | "packed"``) or a per-column dict keyed by
``(table, key, column)`` with ``"auto"`` filling the gaps. The choices, words
and dictionaries equal the reference's (``repro.storage.policy``) for the same
data.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..robust.errors import ValidationError
from .columns import DenseColumn, DeviceColumn, DictPackedColumn, PackedColumn

DEVICE_ENCODINGS = ("dense", "packed", "dict")

# the reference keeps the whole dictionary VMEM-resident in its fused hop, so
# it caps the size at 64k fp32 slots = 256 KB; the port keeps the cap, so that
# encodings and device bytes stay equal to the reference's (the CUDA hop reads
# the dictionary through the read-only cache path, csrc/fragment_spmv_packed.cu)
DICT_MAX_ENTRIES = 1 << 16


def _codec_utils():
    """Deferred import: ``repro_torch.core.__init__`` imports the engine,
    which imports this package — a module-level ``from ..core...`` import
    would cycle whenever ``repro_torch.storage`` loads first."""
    from ..core.codecs import bits_needed
    from ..core.fragments import _pack_words

    return bits_needed, _pack_words


def column_uniques(values: np.ndarray):
    """Zero-arg memo of ``np.unique(values, return_counts=True)`` — the
    chooser and the dict encoder share one O(E log E) scan."""
    memo: list = []

    def get():
        if not memo:
            memo.append(np.unique(values, return_counts=True))
        return memo[0]

    return get


def _candidate_bytes(
    values: np.ndarray, domain: int, is_key: bool, uniques=None
) -> dict[str, int]:
    bits_needed, _ = _codec_utils()
    E = int(values.shape[0])
    w = bits_needed(domain)
    cand = {"dense": 4 * E}
    signed = bool(E) and int(values.min()) < 0
    if w < 32 and not signed:  # bit packing is unsigned (codecs contract)
        cand["packed"] = 4 * math.ceil(E * w / 32)
    if not is_key and E:
        # dict stores original values, so signed columns are fine here
        u = int((uniques or column_uniques(values))()[0].shape[0])
        wu = bits_needed(u)
        if wu < 32 and u <= DICT_MAX_ENTRIES:
            cand["dict"] = 4 * math.ceil(E * wu / 32) + 4 * u
    return cand


def choose_device_encoding(
    values: np.ndarray, domain: int, is_key: bool, uniques=None
) -> str:
    """§5-style chooser over the device layouts: minimum candidate bytes
    (ties go to the less exotic layout: dense < packed < dict)."""
    cand = _candidate_bytes(values, domain, is_key, uniques)
    return min(DEVICE_ENCODINGS,
               key=lambda e: (cand.get(e, math.inf), DEVICE_ENCODINGS.index(e)))


def resolve_device_encoding(
    spec: str | dict | None,
    addr: tuple[str, str, str],
    values: np.ndarray,
    domain: int,
    is_key: bool,
    uniques=None,
) -> str:
    """Resolve the user-facing ``device_encodings`` surface for one column.
    ``addr`` = (table, key, column) — the index-qualified column address."""
    enc = spec.get(addr, "auto") if isinstance(spec, dict) else (spec or "auto")
    if enc == "auto":
        return choose_device_encoding(values, domain, is_key, uniques)
    if enc not in DEVICE_ENCODINGS:
        raise ValidationError(
            f"unknown device encoding {enc!r} for {addr}",
            encoding=enc, column=addr, valid=("auto",) + DEVICE_ENCODINGS,
        )
    if enc == "dict" and is_key:
        raise ValidationError(
            f"dict encoding is measure-only; {addr} is a key column",
            encoding=enc, column=addr,
        )
    # requested packing that cannot apply (≥ 32-bit or signed values — bit
    # packing is unsigned) degrades to dense
    bits_needed, _ = _codec_utils()
    if enc == "packed" and (
        bits_needed(domain) >= 32
        or (values.shape[0] and int(values.min()) < 0)
    ):
        return "dense"
    return enc


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words → the int32 tensor of the same bits on ``device``."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32)
    return torch.tensor(w, device=device)


def build_device_column(cf, enc: str, out_dtype: torch.dtype, device,
                        uniques=None) -> DeviceColumn:
    """Ship one :class:`~repro_torch.core.fragments.ColumnFragments` to
    ``device`` under ``enc``. Reuses the loader's bit-packed words when it
    kept them."""
    bits_needed, _pack_words = _codec_utils()
    np_dtype = {torch.int32: np.int32, torch.float32: np.float32}[out_dtype]

    def dense():
        return DenseColumn(torch.tensor(np.asarray(cf.values, dtype=np_dtype), device=device))

    if enc == "dense":
        return dense()
    if enc == "packed":
        width = cf.packed_width or bits_needed(cf.domain)
        words = cf.packed if cf.packed is not None else _pack_words(cf.values, width)
        return PackedColumn(words_tensor(words, device), width,
                            int(cf.values.shape[0]), out_dtype)
    if enc == "dict":
        vals, counts = (uniques or column_uniques(cf.values))()
        width = bits_needed(len(vals))
        # degenerate (indices as wide as the data) or over the dictionary
        # cap: stay dense
        if width >= 32 or len(vals) > DICT_MAX_ENTRIES:
            return dense()
        order = np.argsort(-counts, kind="stable")
        dictionary = vals[order]
        # frequency rank per sorted-unique slot; O(E log u) via searchsorted,
        # never sized by the value *range* (values may be huge or negative)
        rank = np.empty(len(vals), dtype=np.int64)
        rank[order] = np.arange(len(vals))
        words = _pack_words(rank[np.searchsorted(vals, cf.values)], width)
        return DictPackedColumn(
            words_tensor(words, device), width, int(cf.values.shape[0]),
            torch.tensor(np.asarray(dictionary, dtype=np_dtype), device=device),
        )
    raise ValidationError(f"unknown device encoding {enc!r}", encoding=enc)


def device_space_report(device_db) -> dict[str, Any]:
    """Real device bytes, per index per column — what device memory holds,
    as opposed to the host byte-array accounting of
    ``FragmentIndex.total_bytes``. ``dense_bytes`` is the decoded-CSR baseline
    for the same data, so ``ratio`` is the compression factor on the device.
    ``materialized_bytes`` counts decoded copies the ``materialize()`` memo
    pins; the ratio holds only while it is 0. The block-skipping metadata
    (8 bytes per 4096 edges) is not counted, as in the reference."""
    rep: dict[str, Any] = {
        "indexes": {}, "total_bytes": 0, "dense_bytes": 0, "materialized_bytes": 0,
    }

    def arr_bytes(a) -> int:
        return a.numel() * a.element_size() if a is not None else 0

    for (t, k), di in device_db.indexes.items():
        cols = {}
        struct = arr_bytes(di.indptr) + arr_bytes(di.src_ids) + arr_bytes(di.degrees)
        total = struct
        dense_total = struct
        mat_total = 0
        for name, col in [("__dst__", di.dst_col), *di.measure_cols.items()]:
            b, db_ = col.device_nbytes, 4 * col.count
            cols[name] = {"kind": col.kind, "device_bytes": b, "dense_bytes": db_}
            if col.materialized_nbytes:
                cols[name]["materialized_bytes"] = col.materialized_nbytes
            total += b
            dense_total += db_
            mat_total += col.materialized_nbytes
        rep["indexes"][f"I_{t}.{k}"] = {
            "columns": cols, "struct_bytes": struct,
            "device_bytes": total, "dense_bytes": dense_total,
        }
        rep["total_bytes"] += total
        rep["dense_bytes"] += dense_total
        rep["materialized_bytes"] += mat_total
    rep["ratio"] = rep["dense_bytes"] / max(rep["total_bytes"], 1)
    return rep
