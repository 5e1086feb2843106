"""Plain PyTorch versions of the kernels: the CPU path, and the yardstick
every CUDA kernel is compared with on the card.

BCA word streams are ``int32`` tensors holding the bit patterns of the
reference's little-endian ``uint32`` words (``core.fragments._pack_words``):
torch's unsigned 32-bit type has too few operations for the decode, and the
CUDA kernels read the same bytes as ``uint32``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .params import EDGE_BLOCK

# ⊕-identity per combine op ("no path reaches this entity")
IDENTITY = {
    "sum": 0.0,
    "min": float("inf"),
    "max": float("-inf"),
    "bool": 0.0,
}

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax", "bool": "amax"}


def _edge_product(weights, src_ids, measures, op: str):
    """w[src] ⊗ m per edge with the identity guard non-sum lattices need
    (∞·0 = NaN); an out-of-range src reads the ⊕-identity. ``measures=None``
    means measure 1 on every edge."""
    zero = IDENTITY[op]
    src = src_ids.to(torch.int64)
    n_src = weights.shape[0]
    valid = (src >= 0) & (src < n_src)
    if n_src:
        ws = torch.where(valid, weights[src.clamp(0, n_src - 1)], zero)
    else:
        ws = torch.full(src.shape, zero, dtype=torch.float32, device=weights.device)
    m = 1.0 if measures is None else measures
    if op == "sum":
        return ws * m
    if op == "bool":
        return ((ws > 0) & (torch.as_tensor(m, device=ws.device) != 0)).to(torch.float32)
    return torch.where(ws == zero, zero, ws * m)


def fragment_spmv_ref(
    weights: torch.Tensor,  # f32[n_src]
    src_ids: torch.Tensor,  # i32[E]
    dst_ids: torch.Tensor,  # i32[E]
    measures: torch.Tensor | None,  # f32[E] | None (measure 1)
    n_dst: int,
    op: str = "sum",
) -> torch.Tensor:
    """One relationship hop: y[dst] = ⊕_edges w[src] ⊗ m (the frontier SpMV),
    with the combine op ⊕ selected by the aggregation semiring. The output
    starts at the ⊕-identity, so an unreached dst reads 0 / +∞ / −∞ / 0 —
    for bool that is ``max(segment_max, 0)``."""
    out = torch.full((n_dst,), IDENTITY[op], dtype=torch.float32,
                     device=weights.device)
    prod = _edge_product(weights, src_ids, measures, op)
    return out.scatter_reduce_(0, dst_ids.to(torch.int64), prod,
                               reduce=_REDUCE[op])


def bitgather_ref(packed: torch.Tensor, width: int, ids) -> torch.Tensor:
    """Decode the little-endian ``width``-bit values at positions ``ids`` from
    a word stream (int32 bit patterns) — the point decode behind
    ``storage.DeviceColumn.gather``. Returns int32 (a 32-bit value with its
    top bit set wraps, as the reference's uint32 → int32 cast does)."""
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in 1..32, got {width}")
    idx = torch.as_tensor(ids, device=packed.device).to(torch.int64)
    if idx.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.int32, device=packed.device)
    # the reference's split of the bit offset, 32·q·width + r·width with
    # q = idx // 32: no intermediate passes the word count, where a plain
    # idx * width wraps a 32-bit offset past 2^32 bits (int64 here does not
    # wrap, but the split keeps the two decodes step for step alike)
    q, r = idx >> 5, idx & 31
    bitr = r * width
    w0 = q * width + (bitr >> 5)
    off = bitr & 31
    # only the words asked for widen to int64, never the whole stream
    lo = packed[w0].to(torch.int64) & 0xFFFFFFFF
    hi = packed[torch.clamp(w0 + 1, max=packed.shape[0] - 1)].to(torch.int64) & 0xFFFFFFFF
    val = ((lo | (hi << 32)) >> off) & ((1 << width) - 1)
    return torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)


def bitunpack_ref(packed: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Decode ``count`` little-endian ``width``-bit values from a word stream.
    Value i occupies bits [i*width, (i+1)*width); a value may straddle two
    words. Returns int32[count]."""
    return bitgather_ref(
        packed, width, torch.arange(count, dtype=torch.int64, device=packed.device)
    )


def _measure_values(measure, mdict, m_mode: str, m_width: int, ids, E: int):
    """The float32 measure of the edges ``ids`` (``None`` = measure 1) under
    ``m_mode``: none / dense (float32[E]) / packed (the decoded integers) /
    dict (decoded indices into ``mdict``)."""
    if m_mode == "none":
        return None
    if m_mode == "dense":
        return measure if ids is None else measure[ids]
    if m_mode not in ("packed", "dict"):
        raise ValueError(f"unknown measure mode {m_mode!r}")
    if ids is None:
        idx = bitunpack_ref(measure, m_width, E)
    else:
        idx = bitgather_ref(measure, m_width, ids)
    if m_mode == "dict":
        return mdict[idx.to(torch.int64)]
    return idx.to(torch.float32)


def fragment_spmv_packed_ref(
    weights: torch.Tensor,
    src_ids: torch.Tensor,
    dst,  # words if dst_width else int32[E]
    measure,  # words | float32[E] | None, per m_mode
    mdict,  # float32[u] | None
    n_dst: int,
    dst_width: int = 0,
    m_mode: str = "none",
    m_width: int = 0,
    op: str = "sum",
) -> torch.Tensor:
    """Decode-then-hop: whole-column decode of the packed streams, then the
    plain hop — the same function as the decode-fused kernel."""
    E = src_ids.shape[0]
    d = bitunpack_ref(dst, dst_width, E) if dst_width else dst
    m = _measure_values(measure, mdict, m_mode, m_width, None, E)
    return fragment_spmv_ref(weights, src_ids, d, m, n_dst, op=op)


def listed_edges(block_idx, n_active, E: int, scan_above: int | None = None):
    """Edge ids of the blocks ``block_idx[:n_active]`` (every block, in scan
    order, when ``n_active > scan_above``), clipped to E — what the active
    kernels stream. Reads ``n_active`` on the host: this is the plain version,
    never the card's hop path."""
    na = int(torch.as_tensor(n_active).reshape(-1)[0])
    nb = max(1, -(-E // EDGE_BLOCK))
    if scan_above is not None and na > scan_above:
        blocks = torch.arange(nb, dtype=torch.int64, device=block_idx.device)
    else:
        blocks = block_idx[: min(na, block_idx.shape[0])].to(torch.int64)
    ids = (blocks[:, None] * EDGE_BLOCK
           + torch.arange(EDGE_BLOCK, device=block_idx.device)).reshape(-1)
    return ids[ids < E]


def fragment_spmv_active_ref(
    weights, src_ids, dst_ids, measures, block_idx, n_active, n_dst: int,
    op: str = "sum", scan_above: int | None = None,
) -> torch.Tensor:
    """The hop over the listed blocks only: edges outside ``block_idx
    [:n_active]`` are left out. Equal to :func:`fragment_spmv_ref` whenever
    the list holds every block the frontier's support reaches."""
    ids = listed_edges(block_idx, n_active, src_ids.shape[0], scan_above)
    m = None if measures is None else measures[ids]
    return fragment_spmv_ref(weights, src_ids[ids], dst_ids[ids], m, n_dst, op=op)


def fragment_spmv_packed_active_ref(
    weights, src_ids, dst, measure, mdict, block_idx, n_active, n_dst: int,
    dst_width: int = 0, m_mode: str = "none", m_width: int = 0,
    op: str = "sum", scan_above: int | None = None,
) -> torch.Tensor:
    """The decode-fused hop over the listed blocks only: just their edges
    are decoded (point decodes at the listed edge ids)."""
    E = src_ids.shape[0]
    ids = listed_edges(block_idx, n_active, E, scan_above)
    d = bitgather_ref(dst, dst_width, ids) if dst_width else dst[ids]
    m = _measure_values(measure, mdict, m_mode, m_width, ids, E)
    return fragment_spmv_ref(weights, src_ids[ids], d, m, n_dst, op=op)


# ---------------------------------------------------------------------------
# Batched hops (the multi-query SpMM): B frontier rows over one edge list
# ---------------------------------------------------------------------------


def _row_measure(measures, b: int):
    """Row ``b``'s measure: a shared ``[E]`` stream (or None) is every row's;
    a per-row ``[B, E]`` stream gives its row."""
    if measures is None or measures.dim() < 2:
        return measures
    return measures[b]


def _rows(weights, hop) -> torch.Tensor:
    """``[B, n_dst]`` from one SpMV per row: ``hop(row_weights, b)``. Row by
    row, so no ``[B, E]`` temporary is built (at B = 64 over 29M edges one
    such tensor is 7.4 GB)."""
    return torch.stack([hop(weights[b], b) for b in range(weights.shape[0])])


def fragment_spmm_ref(
    weights: torch.Tensor,  # f32[B, n_src]
    src_ids: torch.Tensor,  # i32[E]
    dst_ids: torch.Tensor,  # i32[E]
    measures: torch.Tensor | None,  # f32[E] shared | f32[B, E] per row | None
    n_dst: int,
    op: str = "sum",
) -> torch.Tensor:
    """The batched hop ``Y[b, dst] ⊕= W[b, src] ⊗ m``: B independent SpMVs,
    each row through :func:`fragment_spmv_ref`. ``f32[B, n_dst]``."""
    return _rows(weights, lambda w, b: fragment_spmv_ref(
        w, src_ids, dst_ids, _row_measure(measures, b), n_dst, op=op))


def fragment_spmm_active_ref(
    weights, src_ids, dst_ids, measures, block_idx, n_active, n_dst: int,
    op: str = "sum", scan_above: int | None = None,
) -> torch.Tensor:
    """The batched hop over the listed blocks only (one list for all rows:
    the union of the rows' supports)."""
    ids = listed_edges(block_idx, n_active, src_ids.shape[0], scan_above)
    s, d = src_ids[ids], dst_ids[ids]
    return _rows(weights, lambda w, b: fragment_spmv_ref(
        w, s, d, None if measures is None else _row_measure(measures, b)[..., ids],
        n_dst, op=op))


def fragment_spmm_packed_ref(
    weights, src_ids, dst, measure, mdict, n_dst: int,
    dst_width: int = 0, m_mode: str = "none", m_width: int = 0,
    op: str = "sum",
) -> torch.Tensor:
    """Decode-then-hop for B rows: the packed streams decode once, then the
    rows go through the plain hop. The measure is shared by the rows."""
    E = src_ids.shape[0]
    d = bitunpack_ref(dst, dst_width, E) if dst_width else dst
    m = _measure_values(measure, mdict, m_mode, m_width, None, E)
    return fragment_spmm_ref(weights, src_ids, d, m, n_dst, op=op)


def fragment_spmm_packed_active_ref(
    weights, src_ids, dst, measure, mdict, block_idx, n_active, n_dst: int,
    dst_width: int = 0, m_mode: str = "none", m_width: int = 0,
    op: str = "sum", scan_above: int | None = None,
) -> torch.Tensor:
    """The decode-fused batched hop over the listed blocks only: just their
    edges are decoded, once for all rows."""
    E = src_ids.shape[0]
    ids = listed_edges(block_idx, n_active, E, scan_above)
    d = bitgather_ref(dst, dst_width, ids) if dst_width else dst[ids]
    m = _measure_values(measure, mdict, m_mode, m_width, ids, E)
    return fragment_spmm_ref(weights, src_ids[ids], d, m, n_dst, op=op)


class HopStreams(NamedTuple):
    """One hop's edge streams as the fused kernels take them: src ids, dst
    (int32 ids, or BCA words when ``dst_width``) and the measure in ``m_mode``
    (none / dense float32[E] / packed words / dict words + ``mdict``)."""

    src: torch.Tensor
    dst: torch.Tensor
    measure: torch.Tensor | None = None
    mdict: torch.Tensor | None = None
    dst_width: int = 0
    m_mode: str = "none"
    m_width: int = 0


def apply_mask(u: torch.Tensor, keep: torch.Tensor, op: str) -> torch.Tensor:
    """The fused region's filter: keep where ``keep > 0``, else the
    ⊕-identity (``Semiring.mask``)."""
    return torch.where(keep > 0, u, IDENTITY[op])


def binarize(u: torch.Tensor, op: str) -> torch.Tensor:
    """hop2's semijoin entry on the intermediate (``Semiring.binarize``):
    ``u > 0`` for sum; ``u ≠ 0̄ → 1``, else 0̄, for the others."""
    if op == "sum":
        return (u > 0).to(torch.float32)
    zero = IDENTITY[op]
    return torch.where(u != zero, 1.0, zero)


def _listed_hop_ref(w, h: HopStreams, n_dst: int, op: str, block_idx, n_active):
    """One region hop through the plain packed hop: the SpMV for a ``[n]``
    frontier, the SpMM for ``[B, n]``."""
    kw = dict(dst_width=h.dst_width, m_mode=h.m_mode, m_width=h.m_width, op=op)
    batched = w.dim() == 2
    if block_idx is None:
        fn = fragment_spmm_packed_ref if batched else fragment_spmv_packed_ref
        return fn(w, h.src, h.dst, h.measure, h.mdict, n_dst, **kw)
    fn = fragment_spmm_packed_active_ref if batched else fragment_spmv_packed_active_ref
    return fn(w, h.src, h.dst, h.measure, h.mdict, block_idx, n_active, n_dst, **kw)


def fragment_spmv_fused_ref(
    weights: torch.Tensor,
    hop1: HopStreams,
    hop2: HopStreams | None,  # None ⇒ the degenerate 1-hop+filter region
    mid_mask: torch.Tensor | None,
    n_mid: int,
    n_dst: int,
    op: str = "sum",
    mid_binarize: bool = False,
    lists=None,  # (block_idx1, n_active1, block_idx2, n_active2) | None: scan
) -> torch.Tensor:
    """A fused region as its plain composition: hop1 → mask → binarize →
    hop2, each hop through the plain packed hop (over the block lists when
    given). In the degenerate region the mask applies to the output."""
    bi1, na1, bi2, na2 = lists if lists is not None else (None,) * 4
    u = _listed_hop_ref(weights, hop1, n_mid, op, bi1, na1)
    if mid_mask is not None:
        u = apply_mask(u, mid_mask, op)
    if hop2 is None:
        return u
    if mid_binarize:
        u = binarize(u, op)
    return _listed_hop_ref(u, hop2, n_dst, op, bi2, na2)


def fragment_spmm_fused_ref(
    weights: torch.Tensor,  # f32[B, n_src]
    hop1: HopStreams,
    hop2: HopStreams | None,
    mid_mask: torch.Tensor | None,  # f32[n_mid], shared by the rows
    n_mid: int,
    n_dst: int,
    op: str = "sum",
    mid_binarize: bool = False,
    lists=None,
) -> torch.Tensor:
    """The batched fused region as its plain composition: B rows through
    :func:`fragment_spmv_fused_ref`'s steps (the mask broadcast over the
    rows). ``f32[B, n_dst]``."""
    return fragment_spmv_fused_ref(weights, hop1, hop2, mid_mask, n_mid, n_dst, op=op,
                                   mid_binarize=mid_binarize, lists=lists)


def bitmap_and_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-wise AND of two bitmaps (int32 words holding the uint32 bits)."""
    return torch.bitwise_and(a, b)


def bitmap_and_popcount_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Total set bits of ``a & b`` — the merge-intersection cardinality (paper
    §6.1) — as a 0-d int32 tensor. SWAR bit counting on the words widened to
    int64, so the sign bit counts, summed in int64."""
    x = torch.bitwise_and(a, b).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli): the integrity digests of the column store
# (storage/integrity.py). Not a TPU kernel: the reference hashes on the host.
# ---------------------------------------------------------------------------

#: CRC-32C's reflected polynomial (iSCSI, ext4, Parquet pages).
CRC32C_POLY = 0x82F63B78
MASK32 = 0xFFFFFFFF


def multmodp(a: int, b: int) -> int:
    """``a · b mod P(x)`` over GF(2), in the reflected representation of a
    CRC register (the coefficient of x^0 is bit 31)."""
    p, m = 0, 1 << 31
    while m:
        if a & m:
            p ^= b
        b = (b >> 1) ^ CRC32C_POLY if b & 1 else b >> 1
        m >>= 1
    return p


def _x2n_table() -> list[int]:
    out = [1 << 30]  # x^1
    for _ in range(63):
        out.append(multmodp(out[-1], out[-1]))
    return out


#: ``X2N[k]`` = x^(2^k) mod P for k < 64; ``csrc/crc32c.cu`` holds the same
#: constants (``kX2n``).
X2N = _x2n_table()


def x8nmodp(n: int) -> int:
    """x^(8n) mod P: multiplying a raw CRC register by it carries the
    register over n zero bytes (zlib's ``x2nmodp(n, 3)``)."""
    p, k = 1 << 31, 3
    while n:
        if n & 1:
            p = multmodp(X2N[k], p)
        n >>= 1
        k += 1
    return p


def _crc32c_table() -> list[int]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ CRC32C_POLY if c & 1 else c >> 1
        out.append(c)
    return out


CRC32C_TABLE = _crc32c_table()


def _mulmod_const(a: int, b: torch.Tensor) -> torch.Tensor:
    """:func:`multmodp` of the constant ``a`` with every entry of ``b``
    (int64 holding uint32): one GF(2) operator applied to a vector."""
    p = torch.zeros_like(b)
    for i in range(31, -1, -1):
        if (a >> i) & 1:
            p = p ^ b
        b = torch.where((b & 1) == 1, (b >> 1) ^ CRC32C_POLY, b >> 1)
    return p


#: The most chunks :func:`crc32c_ref` cuts a stream into (a chunk is at
#: least 16 bytes): many on the card, where each step gathers for every
#: chunk at once, few on the CPU. The value does not depend on it.
CRC_CHUNKS = {"cuda": 1 << 20, "cpu": 1 << 12}


def crc32c_ref(data: torch.Tensor, value: int = 0) -> torch.Tensor:
    """CRC-32C of the bytes ``data`` (uint8, 1-D) continuing from ``value``,
    as a 0-d int64 tensor on ``data``'s device — the chunked algorithm of
    ``csrc/crc32c.cu`` in PyTorch, vectorised over chunks:

      * the stream is zero-padded at the front to ``C`` chunks of ``L`` bytes
        (leading zeros leave a CRC that starts at 0 unchanged);
      * each chunk's raw CRC (register 0, no final XOR) by table gathers, one
        byte position a step for every chunk at once;
      * the chunk CRCs combine pairwise, level k shifting the left one over
        ``L · 2^k`` bytes (the GF(2) operator x^(8 · L · 2^k) mod P, zlib's
        ``crc32_combine``), into the raw CRC of the stream;
      * ``value`` folds in as ``raw ⊕ shift(value ⊕ 0xFFFFFFFF, n) ⊕
        0xFFFFFFFF``.

    C is at most :data:`CRC_CHUNKS` of the device."""
    n = int(data.numel())
    dev = data.device
    if n == 0:
        return torch.tensor(value & MASK32, dtype=torch.int64, device=dev)
    L = max(16, -(-n // CRC_CHUNKS.get(dev.type, CRC_CHUNKS["cpu"])))
    C = -(-n // L)
    padded = torch.cat([torch.zeros(C * L - n, dtype=torch.uint8, device=dev),
                        data.reshape(-1)])
    cols = padded.view(C, L).t().contiguous()  # byte position j of every chunk
    tab = torch.tensor(CRC32C_TABLE, dtype=torch.int64, device=dev)
    crc = torch.zeros(C, dtype=torch.int64, device=dev)
    for j in range(L):
        crc = tab[(crc ^ cols[j].to(torch.int64)) & 255] ^ (crc >> 8)
    span = L
    while crc.numel() > 1:
        if crc.numel() % 2:  # a zero chunk in front changes nothing
            crc = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), crc])
        crc = _mulmod_const(x8nmodp(span), crc[0::2]) ^ crc[1::2]
        span *= 2
    return crc[0] ^ (multmodp(x8nmodp(n), (value & MASK32) ^ MASK32) ^ MASK32)
