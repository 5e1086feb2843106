"""Fragment encodings (paper §5): UA, BCA, UB, BB, Huffman, and the DictBCA
TPU substitute for Huffman.

Two layers:
  * storage codecs — host-side numpy encode/decode of one fragment to/from bytes,
    used by the loader for space accounting (reproduces paper Tables 4/8/9/10) and
    as the oracle for the Pallas ``bitunpack`` kernel.
  * analytic space model — the paper's closed-form sizes (§5 table + Fig. 12) and
    the per-column encoding chooser.

All codecs operate on non-negative integer arrays (dictionary encoding of strings
happens upstream at load time, as in the paper).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np

# ---------------------------------------------------------------------------
# Bit I/O helpers (little-endian bit order within the byte stream, paper §5 BB)
# ---------------------------------------------------------------------------


def pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """Pack ``values`` at ``width`` bits each (little-endian) into a uint8 array,
    padded to whole bytes. Vectorized: explode to a bit matrix then ``packbits``.
    """
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    if width <= 0:
        raise ValueError(f"width must be >= 1, got {width}")
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((values[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    flat = bits.reshape(-1)  # bit i*width+j = bit j of value i
    return np.packbits(flat, bitorder="little")


def unpack_bits(buf: np.ndarray, width: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns int64 array of ``count`` values."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    flat = np.unpackbits(np.asarray(buf, dtype=np.uint8), bitorder="little")
    flat = flat[: count * width].reshape(count, width).astype(np.uint64)
    shifts = np.arange(width, dtype=np.uint64)
    return (flat << shifts[None, :]).sum(axis=1).astype(np.int64)


def bits_needed(domain: int) -> int:
    """⌈log2 D⌉ with the paper's convention (at least 1 bit)."""
    return max(1, int(math.ceil(math.log2(max(int(domain), 2)))))


# ---------------------------------------------------------------------------
# Storage codecs
# ---------------------------------------------------------------------------


class Codec:
    name: str = "abstract"

    def encode(self, values: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        raise NotImplementedError


class UACodec(Codec):
    """Uncompressed array in the narrowest of {8,16,32,64}-bit unsigned types."""

    name = "UA"

    def __init__(self, domain: int):
        self.domain = int(domain)
        w = bits_needed(domain)
        self.itemsize = 1 if w <= 8 else 2 if w <= 16 else 4 if w <= 32 else 8
        self.dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[self.itemsize]

    def encode(self, values: np.ndarray) -> bytes:
        return np.asarray(values, dtype=self.dtype).tobytes()

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        return np.frombuffer(buf, dtype=self.dtype, count=count).astype(np.int64)


class BCACodec(Codec):
    """Bit-aligned compressed array: ⌈log2 D⌉ bits/value, fragment byte-padded."""

    name = "BCA"

    def __init__(self, domain: int):
        self.domain = int(domain)
        self.width = bits_needed(domain)

    def encode(self, values: np.ndarray) -> bytes:
        return pack_bits(values, self.width).tobytes()

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        return unpack_bits(np.frombuffer(buf, dtype=np.uint8), self.width, count)


class UBCodec(Codec):
    """Uncompressed bitmap over the domain; values must be unique & sortable.

    Decode returns the *sorted* values (bitmaps are order-destroying; the loader
    only assigns bitmap codecs to columns whose fragments are stored sorted —
    guaranteed by the (F1, F2) lexsort at index build, paper §5).
    """

    name = "UB"

    def __init__(self, domain: int):
        self.domain = int(domain)
        self.nbytes = (self.domain + 7) // 8

    def encode(self, values: np.ndarray) -> bytes:
        bits = np.zeros(self.domain, dtype=np.uint8)
        bits[np.asarray(values, dtype=np.int64)] = 1
        return np.packbits(bits, bitorder="little").tobytes()

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), bitorder="little")
        vals = np.nonzero(bits[: self.domain])[0].astype(np.int64)
        assert vals.shape[0] == count, (vals.shape[0], count)
        return vals


class BBCodec(Codec):
    """Byte-aligned compressed bitmap (paper §5 BB): zero-run lengths between the
    set bits, each length written as 7-bit groups, MSB of each byte = continuation
    flag, little-endian groups. Unique sorted values only.
    """

    name = "BB"

    def encode(self, values: np.ndarray) -> bytes:
        values = np.sort(np.asarray(values, dtype=np.int64))
        runs = np.diff(values, prepend=-1) - 1  # zeros before each set bit
        out = bytearray()
        for r in runs.tolist():
            while True:
                group = r & 0x7F
                r >>= 7
                out.append(group | (0x80 if r else 0x00))
                if not r:
                    break
        return bytes(out)

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        vals = np.empty(count, dtype=np.int64)
        pos = -1
        i = 0
        for k in range(count):
            run = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                run |= (b & 0x7F) << shift
                shift += 7
                if not (b & 0x80):
                    break
            pos += run + 1
            vals[k] = pos
        return vals


class HuffmanCodec(Codec):
    """Canonical Huffman with a *global* code table per column (paper §5) but each
    fragment encoded separately. Decode is array/table-based (no tree walk).

    Host-side only — see DESIGN.md §2 for why bit-serial Huffman decode has no TPU
    analogue and what replaces it on device (DictBCA).
    """

    name = "Huffman"

    def __init__(self, column_values: np.ndarray):
        vals, counts = np.unique(np.asarray(column_values, dtype=np.int64), return_counts=True)
        self.lengths = _huffman_code_lengths(counts)
        # canonical codes: sort by (length, value)
        order = np.lexsort((vals, self.lengths))
        self.sym = vals[order]
        self.len_sorted = self.lengths[order]
        codes = np.zeros(len(vals), dtype=np.uint64)
        code = 0
        prev_len = int(self.len_sorted[0]) if len(vals) else 0
        for i in range(len(vals)):
            li = int(self.len_sorted[i])
            code <<= li - prev_len
            prev_len = li
            codes[i] = code
            code += 1
        self.codes = codes
        self.code_of = dict(zip(self.sym.tolist(), zip(codes.tolist(), self.len_sorted.tolist())))
        self.max_len = int(self.len_sorted.max()) if len(vals) else 0
        # table-based decoder: index by the next max_len bits
        if self.max_len and self.max_len <= 20:
            tbl_sym = np.zeros(1 << self.max_len, dtype=np.int64)
            tbl_len = np.zeros(1 << self.max_len, dtype=np.int32)
            for s, c, li in zip(self.sym.tolist(), codes.tolist(), self.len_sorted.tolist()):
                li = int(li)
                base = c << (self.max_len - li)
                span = 1 << (self.max_len - li)
                tbl_sym[base : base + span] = s
                tbl_len[base : base + span] = li
            self.tbl_sym, self.tbl_len = tbl_sym, tbl_len
        else:
            self.tbl_sym = self.tbl_len = None

    def encode(self, values: np.ndarray) -> bytes:
        bits: list[int] = []
        for v in np.asarray(values, dtype=np.int64).tolist():
            code, li = self.code_of[v]
            for j in range(li - 1, -1, -1):  # MSB-first within the code
                bits.append((code >> j) & 1)
        arr = np.array(bits, dtype=np.uint8)
        return np.packbits(arr, bitorder="big").tobytes()

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), bitorder="big")
        out = np.empty(count, dtype=np.int64)
        pos = 0
        ml = self.max_len
        padded = np.concatenate([bits, np.zeros(ml, dtype=np.uint8)])
        weights = (1 << np.arange(ml - 1, -1, -1)).astype(np.int64)
        for k in range(count):
            window = int(padded[pos : pos + ml] @ weights)
            out[k] = self.tbl_sym[window]
            pos += int(self.tbl_len[window])
        return out

    def encoded_bits(self, values: np.ndarray) -> int:
        vals = np.asarray(values, dtype=np.int64)
        return int(sum(self.code_of[v][1] for v in vals.tolist()))


class DictBCACodec(Codec):
    """TPU substitute for Huffman (DESIGN.md §2): global frequency-sorted
    dictionary + fixed-width packing with *adaptive escape coding* — the top
    2^k−1 values are coded inline at k bits, the heavy tail escapes to a 32-bit
    side array; k minimizes total bits over the column. Decode is fully
    vectorizable (bitunpack + two gathers + cumsum over escape flags), never
    worse than plain fixed-width, and approaches entropy on skewed columns.
    """

    name = "DictBCA"

    def __init__(self, column_values: np.ndarray):
        col = np.asarray(column_values, dtype=np.int64)
        vals, counts = np.unique(col, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        self.dictionary = vals[order]  # index -> value
        self.to_index = np.zeros(int(vals.max()) + 1 if len(vals) else 1, dtype=np.int64)
        self.to_index[self.dictionary] = np.arange(len(vals))
        # choose k: N·k inline bits + 32 bits per escaped value
        csorted = counts[order]
        cum = np.concatenate([[0], np.cumsum(csorted)])
        N = col.shape[0]
        full = bits_needed(len(vals))
        best_k, best_cost = full, N * full  # no-escape baseline
        for k in range(1, full):
            cap = (1 << k) - 1
            covered = cum[min(cap, len(vals))]
            cost = N * k + (N - covered) * 32
            if cost < best_cost:
                best_k, best_cost = k, cost
        self.width = best_k
        self.cap = (1 << best_k) - 1 if best_k < full else (1 << full)

    def encode(self, values: np.ndarray) -> bytes:
        idx = self.to_index[np.asarray(values, dtype=np.int64)]
        esc = idx >= self.cap
        codes = np.where(esc, self.cap, idx)
        head = pack_bits(codes, self.width).tobytes()
        side = idx[esc].astype(np.uint32).tobytes()
        return head + side

    def decode(self, buf: bytes, count: int) -> np.ndarray:
        head_bytes = (count * self.width + 7) // 8
        codes = unpack_bits(np.frombuffer(buf[:head_bytes], dtype=np.uint8),
                            self.width, count)
        esc = codes >= self.cap
        side = np.frombuffer(buf[head_bytes:], dtype=np.uint32)
        slot = np.cumsum(esc) - 1  # j-th escape → side[j]
        idx = np.where(esc, side[np.minimum(slot, max(len(side) - 1, 0))] if len(side) else 0, codes)
        return self.dictionary[idx]

    def encoded_bits(self, values: np.ndarray) -> int:
        idx = self.to_index[np.asarray(values, dtype=np.int64)]
        return int(values.shape[0] * self.width + (idx >= self.cap).sum() * 32)


def _huffman_code_lengths(counts: np.ndarray) -> np.ndarray:
    """Code length per symbol via the standard heap construction."""
    n = len(counts)
    if n == 1:
        return np.ones(1, dtype=np.int64)
    heap: list[tuple[int, int, list[int]]] = [
        (int(c), i, [i]) for i, c in enumerate(counts)
    ]
    heapq.heapify(heap)
    lengths = np.zeros(n, dtype=np.int64)
    uid = n
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, uid, s1 + s2))
        uid += 1
    return lengths


# ---------------------------------------------------------------------------
# Analytic space model (paper §5 table + Appendix 9.1) — sizes in BITS
# ---------------------------------------------------------------------------


def space_ua(n: int, domain: int) -> int:
    return 32 * n * max(1, math.ceil(math.log(max(domain, 2), 2**32)))


def space_ub(n: int, domain: int) -> int:
    return 8 * math.ceil(domain / 8)


def space_bca(n: int, domain: int) -> int:
    return 8 * math.ceil(n * bits_needed(domain) / 8)


def space_bb(n: int, domain: int) -> int:
    if n == 0:
        return 0
    gap = max((domain - n) / n, 1.0)
    return n * 8 * max(1, math.ceil(math.log(gap, 128)))


def space_huffman(n: int, domain: int, entropy_bits: float) -> int:
    return 8 * math.ceil((n * entropy_bits + domain) / 8)


def column_entropy(values: np.ndarray) -> float:
    _, counts = np.unique(values, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


@dataclass
class EncodingChoice:
    name: str
    bits_per_fragment: float


def choose_key_encoding(avg_fragment_size: float, domain: int) -> str:
    """Fig. 12 chooser for key/FK columns (fragments hold unique values):
    evaluate the closed forms at the average fragment size, take the min.
    UA is never minimal (Case 1)."""
    n = max(1, int(round(avg_fragment_size)))
    costs = {
        "BCA": space_bca(n, domain),
        "BB": space_bb(n, domain),
        "UB": space_ub(n, domain),
    }
    return min(costs, key=costs.__getitem__)


def choose_measure_encoding(
    avg_fragment_size: float, domain: int, entropy_bits: float
) -> str:
    """Measure columns (duplicates allowed): bitmaps inapplicable; Huffman wins
    on skewed distributions (Table 8), BCA otherwise. The global code table is
    shared across fragments (paper §5 "global Huffman tree"), so the chooser
    compares per-value costs with only the per-fragment byte-padding overhead
    (~4 bits), not the +D tree term."""
    n = max(1, int(round(avg_fragment_size)))
    costs = {
        "BCA": space_bca(n, domain),
        "Huffman": n * entropy_bits + 4.0,
    }
    return min(costs, key=costs.__getitem__)


def make_codec(name: str, domain: int, column_values: np.ndarray | None = None) -> Codec:
    if name == "UA":
        return UACodec(domain)
    if name == "BCA":
        return BCACodec(domain)
    if name == "UB":
        return UBCodec(domain)
    if name == "BB":
        return BBCodec()
    if name == "Huffman":
        assert column_values is not None
        return HuffmanCodec(column_values)
    if name == "DictBCA":
        assert column_values is not None
        return DictBCACodec(column_values)
    raise ValueError(f"unknown codec {name}")
