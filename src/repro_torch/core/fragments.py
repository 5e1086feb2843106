"""GQ-Fast index (paper §5): per-direction fragment storage.

``FragmentIndex(R, F1)`` materializes, for key attribute F1 with domain size h:
  * ``indptr`` — the offset lookup table 𝒫 (h+1 int32 entries). Fragment c of any
    co-stored column spans [indptr[c], indptr[c+1]). Because sizes come from
    consecutive offsets, none are stored (paper §5).
  * per co-attribute value arrays holding the fragments consecutively, built from
    R lexsorted by (F1, F2) so FK fragments are internally sorted (bitmap-codec
    safe) and measure fragments stay aligned.

This is a CSR/CSC pair when both directions are built — the TPU-native layout of
the paper's byte-array + lookup-table design (DESIGN.md §2). Device arrays are
int32/float32; the encoded byte streams are kept (optionally) for space accounting
and for the bitunpack kernel path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import codecs as C
from .schema import RelationshipTable, Schema


@dataclass
class ColumnFragments:
    name: str
    values: np.ndarray  # int64 host values, fragment-concatenated order
    domain: int
    encoding: str
    encoded_bytes: int  # total space of the encoded byte array (bits/8)
    packed: np.ndarray | None = None  # bit-packed words for kernel path (BCA only)
    packed_width: int = 0


@dataclass
class FragmentIndex:
    table: str
    key: str  # the F_i this index is keyed on
    key_entity: str
    indptr: np.ndarray  # int64[h+1]
    columns: dict[str, ColumnFragments] = field(default_factory=dict)

    @property
    def num_edges(self) -> int:
        return int(self.indptr[-1])

    def fragment(self, c: int, col: str) -> np.ndarray:
        s, e = int(self.indptr[c]), int(self.indptr[c + 1])
        return self.columns[col].values[s:e]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def src_ids(self) -> np.ndarray:
        """Expand the indptr back to one key id per edge (CSR row indices)."""
        h = self.indptr.shape[0] - 1
        return np.repeat(np.arange(h, dtype=np.int64), np.diff(self.indptr))

    def lookup_bytes(self) -> int:
        """Space of the offset lookup table with minimum-width offsets (paper §5):
        ⌈log256 b_A⌉ bytes per offset per co-stored column."""
        total = 0
        for cf in self.columns.values():
            b = max(cf.encoded_bytes, 1)
            obytes = max(1, int(np.ceil(np.log(b + 1) / np.log(256))))
            total += (self.indptr.shape[0]) * obytes
        return total

    def total_bytes(self) -> int:
        return self.lookup_bytes() + sum(cf.encoded_bytes for cf in self.columns.values())


def build_index(
    schema: Schema,
    rel: RelationshipTable,
    key: str,
    encodings: dict[str, str] | None = None,
    keep_packed: bool = True,
    account_space: bool = True,
) -> FragmentIndex:
    """Build I_{R.key}. ``encodings`` overrides the Fig.-12 chooser per column.

    ``keep_packed=True`` is the repo-wide default (``GQFastDatabase`` threads
    the same value): the bit-packed words are the device column store's wire
    layout, so keeping them costs host memory only and saves a re-pack when
    the storage policy ships a column packed (storage/policy.py)."""
    other = rel.other_fk(key)
    kcol = rel.columns[key].astype(np.int64)
    ocol = rel.columns[other].astype(np.int64)
    h = schema.domain_size(rel.fk_entity(key))
    order = np.lexsort((ocol, kcol))  # sort by key, then other FK (paper §5)
    counts = np.bincount(kcol, minlength=h)
    indptr = np.zeros(h + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    idx = FragmentIndex(rel.name, key, rel.fk_entity(key), indptr)
    avg = rel.num_rows / max(1, int((counts > 0).sum()))

    cols = {other: ocol[order]}
    for m in rel.measures:
        cols[m] = rel.columns[m].astype(np.int64)[order]

    for cname, cvals in cols.items():
        if cname == other:
            dom = schema.domain_size(rel.fk_entity(other))
            enc = (encodings or {}).get(cname) or C.choose_key_encoding(avg, dom)
        else:
            dom = int(cvals.max(initial=0)) + 1
            ent = C.column_entropy(cvals) if account_space else float(C.bits_needed(dom))
            enc = (encodings or {}).get(cname) or C.choose_measure_encoding(avg, dom, ent)
        nbytes = _encoded_size(cvals, indptr, dom, enc) if account_space else cvals.nbytes
        cf = ColumnFragments(cname, cvals, dom, enc, nbytes)
        if keep_packed:
            cf.packed_width = C.bits_needed(dom)
            cf.packed = _pack_words(cvals, cf.packed_width)
        idx.columns[cname] = cf
    return idx


def _pack_words(values: np.ndarray, width: int) -> np.ndarray:
    """Whole-column little-endian bit packing into uint32 words (kernel layout —
    per-column contiguous, not per-fragment padded; offsets are value indices)."""
    buf = C.pack_bits(values, width)
    pad = (-buf.shape[0]) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return buf.view(np.uint32)


def _encoded_size(values: np.ndarray, indptr: np.ndarray, domain: int, enc: str) -> int:
    """Exact encoded byte-array size, fragment by fragment (analytic forms for the
    per-fragment codecs; real Huffman lengths via the global code table)."""
    sizes = np.diff(indptr)
    nz = sizes[sizes > 0]
    if enc == "UA":
        w = C.bits_needed(domain)
        item = 1 if w <= 8 else 2 if w <= 16 else 4 if w <= 32 else 8
        return int(values.shape[0] * item)
    if enc == "BCA":
        w = C.bits_needed(domain)
        return int(np.ceil(nz * w / 8).sum())
    if enc == "UB":
        return int(len(nz) * np.ceil(domain / 8))
    if enc == "BB":
        # varint-7 gap encoding; exact size needs the gaps — estimate with the
        # paper's uniform-gap bound per fragment (cheap, matches §5 analysis)
        gaps = np.maximum((domain - nz) / nz, 1.0)
        nb = np.maximum(1, np.ceil(np.log(gaps) / np.log(128)))
        return int((nz * nb).sum())
    if enc in ("Huffman", "DictBCA"):
        cod = C.make_codec(enc, domain, values)
        if enc == "DictBCA":
            idx = cod.to_index[values]
            esc_bits = (idx >= cod.cap).astype(np.int64) * 32
            starts = indptr[:-1][sizes > 0]
            ends = indptr[1:][sizes > 0]
            cs = np.concatenate([[0], np.cumsum(esc_bits)])
            frag_bits = (ends - starts) * cod.width + (cs[ends] - cs[starts])
            return int(np.ceil(frag_bits / 8).sum())
        # Huffman: sum of per-value code lengths, fragment byte-padded
        lens = np.zeros(int(values.max(initial=0)) + 1, dtype=np.int64)
        lens[cod.sym] = cod.len_sorted
        per_val = lens[values]
        starts = indptr[:-1][sizes > 0]
        ends = indptr[1:][sizes > 0]
        cs = np.concatenate([[0], np.cumsum(per_val)])
        frag_bits = cs[ends] - cs[starts]
        return int(np.ceil(frag_bits / 8).sum())
    raise ValueError(enc)


def build_both_indexes(
    schema: Schema, rel: RelationshipTable, **kw
) -> tuple[FragmentIndex, FragmentIndex]:
    return build_index(schema, rel, rel.fk1, **kw), build_index(schema, rel, rel.fk2, **kw)
