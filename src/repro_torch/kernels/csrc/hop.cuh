// hop.cuh: the per-edge body shared by every hop kernel of the port
// (fragment_spmv.cu: dense columns; fragment_spmv_packed.cu: BCA columns
// decoded in registers; fragment_spmv_fused.cu: the fused regions, which
// read their weight through another gather and mask at the scatter), and
// the batched hops' row-chunk body (fragment_spmm.cu, fragment_spmm_packed.cu
// and the fused regions' SpMM form; its own section below), in two
// schedules:
//
//   scan   one thread per edge in a grid-stride loop over all E edges;
//   active a CTA per EDGE_BLOCK-edge block of the list: CTA c takes list
//          positions c, c + gridDim.x, ... below n_active, so a grid of one
//          CTA a block of the index takes one block each and a one-wave grid
//          (wave_grid) strides over the list. n_active is read from device
//          memory, so the host never waits for the block list. When
//          n_active > scan_above (the "auto" threshold) the CTAs take blocks
//          in scan order instead, which gives the same result: a block the
//          list leaves out holds only edges whose source carries the
//          identity.
//
//   y[dst[e]] ⊕= w[src[e]] ⊗ m[e],   ⊕ ∈ {sum, min, max, bool}
//
// y is filled with the ⊕-identity by the wrapper before the launch. The edge
// product follows the reference's _edge_product: an out-of-range src reads
// the identity; for min/max an identity weight stays the identity (no ∞·0);
// for bool the product is (w > 0) & (m != 0). An edge whose product is the
// identity issues no atomic, and for min/max/bool does not load dst or m.
//
// Float min/max atomics use the integer ordering of IEEE-754 floats: for
// max, a value with its sign bit clear orders like a signed int (atomicMax
// on int), one with the sign bit set orders in reverse as an unsigned int
// (atomicMin on unsigned); min is the mirror image. The test is on the sign
// bit, not on v >= 0, so -0.0 against a -inf identity is right.
//
// The packed and dense pairs (fragment_spmv_packed.cu, fragment_spmv.cu) run
// aggregating forms of the two schedules on an index with a hot destination,
// scan_agg and active_agg (below), which combine a CTA's products per
// destination in shared memory before they touch y; elsewhere they run the
// per-edge scan and active.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bca.cuh"

namespace hop {

enum Op { kSum = 0, kMin = 1, kMax = 2, kBool = 3 };

constexpr int kEdgeBlock = 4096;  // kernels/params.py EDGE_BLOCK
constexpr int kThreads = 256;
constexpr int64_t kMaxScanBlocks = 132 * 16;  // 16 CTAs of 256 per SM of an H100

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kMin) return __uint_as_float(0x7f800000u);  // +inf
  if (OP == kMax) return __uint_as_float(0xff800000u);  // -inf
  return 0.0f;                                           // sum, bool
}

__device__ __forceinline__ void atomic_max_float(float* p, float v) {
  if (!(__float_as_uint(v) & 0x80000000u)) {
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_min_float(float* p, float v) {
  if (!(__float_as_uint(v) & 0x80000000u)) {
    atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
  }
}

// -- column accessors: how an edge's dst and measure are read ---------------

struct DenseDst {
  const int32_t* __restrict__ d;
  __device__ __forceinline__ int operator()(int64_t e) const { return d[e]; }
};

struct PackedDst {  // BCA words, decoded in registers
  const uint32_t* __restrict__ words;
  int64_t n_words;
  int width;
  __device__ __forceinline__ int operator()(int64_t e) const {
    return (int)bca::get(words, n_words, width, e);
  }
};

struct NoMeasure {  // measure 1 on every edge: nothing is streamed
  __device__ __forceinline__ float operator()(int64_t) const { return 1.0f; }
};

struct DenseMeasure {
  const float* __restrict__ m;
  __device__ __forceinline__ float operator()(int64_t e) const { return m[e]; }
};

struct PackedMeasure {  // BCA words; the decoded integer is the measure
  const uint32_t* __restrict__ words;
  int64_t n_words;
  int width;
  __device__ __forceinline__ float operator()(int64_t e) const {
    return (float)(int)bca::get(words, n_words, width, e);
  }
};

struct DictMeasure {  // BCA dictionary indices + the dictionary (read-only path)
  const uint32_t* __restrict__ words;
  int64_t n_words;
  int width;
  const float* __restrict__ dict;
  int n_dict;
  __device__ __forceinline__ float operator()(int64_t e) const {
    uint32_t i = bca::get(words, n_words, width, e);
    if (i >= (uint32_t)n_dict) i = (uint32_t)n_dict - 1;  // never read past it
    return __ldg(dict + i);
  }
};

// -- how an edge's source weight is read, and which dst may take a write ----

template <int OP>
struct Frontier {  // the hop's input frontier: read-only for the whole launch
  const float* __restrict__ w;
  int n_src;
  __device__ __forceinline__ float operator()(int s) const {
    return (s >= 0 && s < n_src) ? __ldg(w + s) : identity<OP>();
  }
};

struct KeepAll {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// -- the per-edge body --------------------------------------------------------

// *p ⊕= v by the op's atomic; for bool a plain store of 1 (every writer stores
// the same value, so the race is benign). p may point to global or shared
// memory.
template <int OP>
__device__ __forceinline__ void combine(float* p, float v) {
  if (OP == kSum) {
    atomicAdd(p, v);
  } else if (OP == kBool) {
    *p = 1.0f;
  } else if (OP == kMin) {
    atomic_min_float(p, v);
  } else {
    atomic_max_float(p, v);
  }
}

// The edge's rules, ending in sink(dst(e), product) for an edge that writes:
// weight(src[e]) ⊗ m(e) unless the product is the identity, dst(e) in range
// and kept.
template <int OP, class W, class Dst, class M, class Keep, class Sink>
__device__ __forceinline__ void edge_into(const W& weight, const int32_t* __restrict__ src,
                                          int64_t e, const Dst& dst, const M& m, int n_dst,
                                          const Keep& keep, const Sink& sink) {
  const float zero = identity<OP>();
  const float ws = weight(src[e]);
  if (OP != kSum && ws == zero) return;  // product is the identity
  const float mv = m(e);
  float prod;
  if (OP == kSum) {
    prod = ws * mv;
    if (prod == 0.0f) return;  // adding 0 is the identity
  } else if (OP == kBool) {
    if (!(ws > 0.0f && mv != 0.0f)) return;
    prod = 1.0f;
  } else {
    prod = ws * mv;
  }
  const int d = dst(e);
  if (d < 0 || d >= n_dst || !keep(d)) return;
  sink(d, prod);
}

template <int OP>
struct ToGlobal {  // one global atomic an edge
  float* __restrict__ y;
  __device__ __forceinline__ void operator()(int d, float v) const { combine<OP>(y + d, v); }
};

// y[dst(e)] ⊕= weight(src[e]) ⊗ m(e), unless keep(dst(e)) is false: then no
// write, so y keeps the identity there (the fused region's mask at scatter).
template <int OP, class W, class Dst, class M, class Keep>
__device__ __forceinline__ void edge_with(const W& weight, const int32_t* __restrict__ src,
                                          int64_t e, const Dst& dst, const M& m,
                                          float* __restrict__ y, int n_dst, const Keep& keep) {
  edge_into<OP>(weight, src, e, dst, m, n_dst, keep, ToGlobal<OP>{y});
}

template <int OP, class Dst, class M>
__device__ __forceinline__ void edge(const float* __restrict__ w, int n_src,
                                     const int32_t* __restrict__ src, int64_t e,
                                     const Dst& dst, const M& m,
                                     float* __restrict__ y, int n_dst) {
  edge_with<OP>(Frontier<OP>{w, n_src}, src, e, dst, m, y, n_dst, KeepAll{});
}

// -- the two schedules, over a per-edge body ----------------------------------

template <class Body>
__device__ __forceinline__ void scan_edges(int64_t E, const Body& body) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E; e += stride) {
    body(e);
  }
}

// The blocks a CTA takes under the active schedule: list positions blockIdx.x,
// blockIdx.x + gridDim.x, ... below the count, each calling
// block(e0, e1) on its edge range (uniform across the CTA). block_idx holds
// n_cap ids; any grid size is right, from one CTA to one per block.
// The number of list positions an active kernel takes, and the block at
// position i: the list's, or every block in scan order when n_active >
// scan_above ('auto' above its threshold).
struct Listed {
  const int32_t* __restrict__ block_idx;
  bool scan_order;
  int64_t count;
  __device__ __forceinline__ Listed(int64_t E, const int32_t* __restrict__ bi, int n_cap,
                                    const int32_t* __restrict__ n_active, int scan_above)
      : block_idx(bi) {
    const int na = __ldg(n_active);
    scan_order = na > scan_above;
    count = scan_order ? (E + kEdgeBlock - 1) / kEdgeBlock : (na < n_cap ? na : n_cap);
  }
  __device__ __forceinline__ int64_t first_edge(int64_t i) const {
    return (scan_order ? i : __ldg(block_idx + i)) * kEdgeBlock;
  }
};

template <class Block>
__device__ __forceinline__ void listed_blocks(int64_t E, const int32_t* __restrict__ block_idx,
                                              int n_cap, const int32_t* __restrict__ n_active,
                                              int scan_above, const Block& block) {
  const Listed list(E, block_idx, n_cap, n_active, scan_above);
  for (int64_t i = blockIdx.x; i < list.count; i += gridDim.x) {
    const int64_t e0 = list.first_edge(i);
    block(e0, e0 + kEdgeBlock < E ? e0 + kEdgeBlock : E);
  }
}

template <class Body>
__device__ __forceinline__ void active_edges(int64_t E, const int32_t* __restrict__ block_idx,
                                             int n_cap, const int32_t* __restrict__ n_active,
                                             int scan_above, const Body& body) {
  listed_blocks(E, block_idx, n_cap, n_active, scan_above, [&](int64_t e0, int64_t e1) {
    for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) body(e);
  });
}

template <int OP, class Dst, class M>
__device__ __forceinline__ void scan(const float* __restrict__ w, int n_src,
                                     const int32_t* __restrict__ src, const Dst& dst,
                                     const M& m, int64_t E, float* __restrict__ y,
                                     int n_dst) {
  scan_edges(E, [&](int64_t e) { edge<OP>(w, n_src, src, e, dst, m, y, n_dst); });
}

template <int OP, class Dst, class M>
__device__ __forceinline__ void active(const float* __restrict__ w, int n_src,
                                       const int32_t* __restrict__ src, const Dst& dst,
                                       const M& m, int64_t E, float* __restrict__ y,
                                       int n_dst, const int32_t* __restrict__ block_idx,
                                       int n_cap, const int32_t* __restrict__ n_active,
                                       int scan_above) {
  active_edges(E, block_idx, n_cap, n_active, scan_above,
               [&](int64_t e) { edge<OP>(w, n_src, src, e, dst, m, y, n_dst); });
}

// -- the aggregating schedules (the packed pair; the dense pair on a hot index) -
//
// Under the schedules above every edge that writes issues its own global
// atomic, so a destination that takes many edges serialises them at one L2
// address: I_DA.Doc's Zipf-hot authors (the top one about 9% of 11.8M edges)
// keep the hop at ~75x its bytes bound. Here a CTA first combines its own
// products per destination in a table in shared memory, then issues one
// global combine per distinct destination:
//
//   * the table: kTableSlots keys and values in dynamic shared memory (8
//     bytes a slot), open-addressed by a multiplicative hash of dst with
//     linear probing. A thread claims a free key with atomicCAS; a value
//     starts at the ⊕-identity and takes combine<OP> on shared memory (native
//     float atomicAdd for sum, the integer-ordered min/max, a store of 1 for
//     bool);
//   * a bounded probe: an edge that finds neither its dst nor a free slot
//     within kTableProbes slots combines straight into y, as the per-edge
//     schedules do, so the result does not depend on the table's size;
//   * the flush: after __syncthreads(), one global combine per occupied slot
//     whose value is not the identity;
//   * edge_into's rules are the per-edge schedules' (identity guard, ∞·0,
//     out-of-range src and dst, bool), only the sink differs.
// scan_agg gives each CTA one contiguous range of edges and flushes once;
// active_agg one run of consecutive listed EDGE_BLOCK-edge blocks, also into
// one table flushed once. Both run one wave of CTAs (those co-resident with
// the table's shared memory), so a short list (a sparse frontier: one
// listed block of thousands) costs one wave of CTAs that find no block, not
// a CTA for every block of the index.
//
// The table's shape is fixed at build time: 4,096 slots and two probes were
// the fastest of 1,024 / 2,048 / 4,096 slots × 1-16 probes on I_DA.Doc on
// the H100 (PERF.md). scripts/hop_table_probe.py re-measures other shapes
// by building with -DHOP_TABLE_BITS=... -DHOP_TABLE_PROBES=...

#ifndef HOP_TABLE_BITS
#define HOP_TABLE_BITS 12
#endif
#ifndef HOP_TABLE_PROBES
#define HOP_TABLE_PROBES 2
#endif

constexpr int kTableBits = HOP_TABLE_BITS;
constexpr int kTableSlots = 1 << kTableBits;
constexpr int kTableProbes = HOP_TABLE_PROBES;
constexpr size_t kTableBytes = (size_t)8 * kTableSlots;
static_assert(kTableBits >= 1 && kTableBits <= 12,
              "at most 32 KB of shared memory: a launch gets 48 KB without opting in");
static_assert(kTableProbes >= 1 && kTableProbes <= kTableSlots, "probes in 1..slots");
constexpr int kEmptyKey = -1;  // dst ids reach the table only when >= 0

template <int OP>
struct TableSink {
  int* keys;
  float* vals;
  float* __restrict__ y;
  __device__ __forceinline__ void operator()(int d, float v) const {
    unsigned h = ((unsigned)d * 0x9E3779B1u) >> (32 - kTableBits);
#pragma unroll
    for (int p = 0; p < kTableProbes; ++p) {
      int k = *reinterpret_cast<volatile int*>(keys + h);
      if (k == kEmptyKey) {
        k = atomicCAS(keys + h, kEmptyKey, d);
        if (k == kEmptyKey) k = d;  // claimed here
      }
      if (k == d) {
        combine<OP>(vals + h, v);
        return;
      }
      h = (h + 1) & (kTableSlots - 1);
    }
    combine<OP>(y + d, v);  // no slot within the probe limit
  }
};

// Fill the CTA's table (keys empty, values the identity); every thread of the
// CTA must call it.
template <int OP>
__device__ __forceinline__ TableSink<OP> table_open(float* smem, float* y) {
  __syncthreads();  // a previous block's flush has read the table
  int* keys = reinterpret_cast<int*>(smem);
  float* vals = smem + kTableSlots;
  for (int i = threadIdx.x; i < kTableSlots; i += blockDim.x) {
    keys[i] = kEmptyKey;
    vals[i] = identity<OP>();
  }
  __syncthreads();
  return TableSink<OP>{keys, vals, y};
}

template <int OP>
__device__ __forceinline__ void table_flush(const TableSink<OP>& t) {
  __syncthreads();
  for (int i = threadIdx.x; i < kTableSlots; i += blockDim.x) {
    const int k = t.keys[i];
    if (k == kEmptyKey) continue;
    const float v = t.vals[i];
    if (v != identity<OP>()) combine<OP>(t.y + k, v);
  }
}

// The edges [e0, e1) into the CTA's open table (uniform across the CTA).
template <int OP, class Dst, class M>
__device__ __forceinline__ void table_run(const TableSink<OP>& tab, int64_t e0, int64_t e1,
                                          const float* __restrict__ w, int n_src,
                                          const int32_t* __restrict__ src, const Dst& dst,
                                          const M& m, int n_dst) {
  const Frontier<OP> weight{w, n_src};
  for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    edge_into<OP>(weight, src, e, dst, m, n_dst, KeepAll{}, tab);
  }
}

// CTA c takes edges [c·per, (c+1)·per), per a whole number of warps' edges.
template <int OP, class Dst, class M>
__device__ __forceinline__ void scan_agg(float* smem, const float* __restrict__ w, int n_src,
                                         const int32_t* __restrict__ src, const Dst& dst,
                                         const M& m, int64_t E, float* __restrict__ y,
                                         int n_dst) {
  int64_t per = (E + gridDim.x - 1) / gridDim.x;
  per = (per + 31) & ~(int64_t)31;
  const int64_t e0 = (int64_t)blockIdx.x * per;
  if (e0 >= E) return;  // the whole CTA
  const int64_t e1 = e0 + per < E ? e0 + per : E;
  const TableSink<OP> tab = table_open<OP>(smem, y);
  table_run<OP>(tab, e0, e1, w, n_src, src, dst, m, n_dst);
  table_flush(tab);
}

// CTA c takes a run of consecutive list positions [c·per, (c+1)·per) (per =
// the listed blocks over the grid, rounded up) into one table, flushed once,
// as scan_agg does with its edge range: a full list costs the scan's flushes,
// not one a block; a short list gives one block each to its first CTAs.
template <int OP, class Dst, class M>
__device__ __forceinline__ void active_agg(float* smem, const float* __restrict__ w, int n_src,
                                           const int32_t* __restrict__ src, const Dst& dst,
                                           const M& m, int64_t E, float* __restrict__ y,
                                           int n_dst, const int32_t* __restrict__ block_idx,
                                           int n_cap, const int32_t* __restrict__ n_active,
                                           int scan_above) {
  const Listed list(E, block_idx, n_cap, n_active, scan_above);
  const int64_t per = (list.count + gridDim.x - 1) / gridDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * per;
  const int64_t i1 = i0 + per < list.count ? i0 + per : list.count;
  if (i0 >= i1) return;  // the whole CTA
  const TableSink<OP> tab = table_open<OP>(smem, y);
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t e0 = list.first_edge(i);
    table_run<OP>(tab, e0, e0 + kEdgeBlock < E ? e0 + kEdgeBlock : E, w, n_src, src, dst, m,
                  n_dst);
  }
  table_flush(tab);
}

// -- the batched hops' measure ----------------------------------------------

// The measure of a batched hop: a shared column (every accessor above) read
// once an edge, or a per-row dense stream m[b·stride + e] (stride E: [B, E]).
template <class M>
struct SharedRows {
  M m;
  __device__ __forceinline__ float edge(int64_t e) const { return m(e); }
  __device__ __forceinline__ float row(float shared, int64_t, int) const { return shared; }
};

struct PerRowMeasure {
  const float* __restrict__ m;
  int64_t stride;
  __device__ __forceinline__ float edge(int64_t) const { return 0.0f; }
  __device__ __forceinline__ float row(float, int64_t e, int b) const {
    return m[(int64_t)b * stride + e];
  }
};

// -- the batched hops (fragment_spmm.cu, fragment_spmm_packed.cu; the fused
//    regions' SpMM form in fragment_spmv_fused.cu): a row chunk a sector -----
//
// Y[B, n_dst] for B = 8 over 4M documents is 128 MB, 2.6x the L2, so an edge
// that adds into B rows of Y lays B atomics on B lines 16 MB apart, each a
// miss. The batched hops instead accumulate into a scratch laid out
// row-chunk-minor,
//
//   S[c, d, r] = the partial ⊕ of row c·rb + r at destination d,
//   S: float32[ceil(B / rb), n_dst, rb],  rb = kernels/fragment_spmm.py
//   row_chunk(B): 8 rows (one 32-byte sector), or B rounded up to 2 or 4,
//
// so one edge's rb products land in one sector. At B = 1 (rb = 1) S is Y
// and the launch runs the single hop's kernels instead (scan / scan_agg,
// active / active_agg over one row, in the batched hop's own .cu file),
// which take the same edge rules into the same layout. The launch's grid is (the
// row chunks) × (the edge CTAs); blockIdx.x, the chunk, runs fastest, so the
// CTAs of one edge range and every chunk are dispatched together and each
// chunk after the first reads the edge stream from L2. A thread takes one
// edge for its CTA's chunk: src, the chunk's weights and the measure are
// read, the rb products formed by chunk_products' rules (per row: the identity
// guard, no write for a zero sum product, the ∞·0 guard, bool as (w > 0) &
// (m != 0)); dst is decoded once if any row writes, and an out-of-range dst
// ends the edge for every row. For sum the chunk goes out as one vector
// reduction a 4 rows (red.global.add.v4.f32; .v2 at rb = 2): a row whose product is the identity adds +0.0, which leaves
// every value as it was (a sum starts at +0.0 and never becomes -0.0); for
// min and max the integer-ordered scalar atomics and for bool a store of 1,
// row by row where the row writes, all on the one sector. An epilogue
// (rows_from_chunks, below) writes Y[b, d] = S[b / rb, d, b % rb] through a
// tile in shared memory. Rows past B in
// the last chunk carry the identity and never reach Y. Offsets are int64.
//
// On an index with a hot destination (kernels/ops.py uses_table) a CTA
// first combines its chunk's products per destination in a shared-memory
// table, as scan_agg / active_agg do for one row: slots of a key and rb
// values ([rb][slots], so a warp's atomics on different slots fall in
// different banks), a bounded probe (an edge without a slot goes straight to
// S), and one flush at the end of the CTA's edge range or run of listed
// blocks, a vector reduction a 4 values. With rb values a slot the table
// (4 + 4·rb bytes a slot) may need more than the 48 KB a launch gets
// without opting in: the launch raises the kernel's limit
// (cudaFuncAttributeMaxDynamicSharedMemorySize) and sizes its one wave by
// the occupancy at the table's size. The table's shape is fixed at build
// time (rows_table_bits), the fastest of 1,024 / 2,048 / 4,096 slots on
// I_DA.Doc on the H100 at each rb (scripts/spmm_probe.py, PERF.md): 1,024
// at 8 rows (36 KiB; 4,096 slots, 144 KiB, leave one CTA an SM: 3x slower
// at B = 8 and 64) and at 4 rows, 2,048 at 2 rows; -DSPMM_TABLE_BITS=b
// builds 2^b slots at every rb. The probe limit is HOP_TABLE_PROBES.
//
// The schedules: the per-edge scan runs a grid-stride loop over the edges
// (scan_grid edge CTAs a chunk); the three others run one wave of CTAs
// (those co-resident, with the table's shared memory or without) divided
// among the chunks: the table scan a contiguous edge range a CTA, both
// active forms over the list as active_agg / listed_blocks do (a run of
// consecutive listed blocks a table; every gridDim.y-th listed block per
// edge), in scan order above scan_above.

constexpr int kRowChunk = 8;  // kernels/fragment_spmm.py ROW_CHUNK

// log2 of the batched table's slots at rb = 2, 4 or 8 rows a chunk. On
// I_DA.Doc, 1,024 / 2,048 / 4,096 slots: B = 2 0.306 / 0.250 / 0.285-0.300
// ms; B = 4 0.301 / 0.298-0.300 / 0.533-0.538 (scan), 0.310-0.315 /
// 0.323-0.326 / 0.538-0.540 (active); B = 8 0.434-0.439 / 0.559-0.604 /
// 1.310-1.330.
#ifdef SPMM_TABLE_BITS
static_assert(SPMM_TABLE_BITS >= 1 && SPMM_TABLE_BITS <= 12,
              "at most 4,096 slots: 144 KiB at 8 rows a slot, within a CTA's 227 KB");
__host__ __device__ __forceinline__ int rows_table_bits(int) { return SPMM_TABLE_BITS; }
#else
__host__ __device__ __forceinline__ int rows_table_bits(int rb) { return rb == 2 ? 11 : 10; }
#endif

// Dynamic shared memory of the batched table at rb rows a chunk.
inline size_t rows_table_bytes(int rb) { return ((size_t)4 << rows_table_bits(rb)) * (1 + rb); }

inline size_t rows_table_max_bytes() {
  size_t most = 0;
  for (int rb = 2; rb <= kRowChunk; rb *= 2) {
    most = rows_table_bytes(rb) > most ? rows_table_bytes(rb) : most;
  }
  return most;
}

// The scratch and one row chunk c in it: the batched hops' kernels take
// chunk blockIdx.x (rows_scan, rows_active), the fused regions' SpMM form the
// chunks a CTA is given.
struct RowChunks {
  float* __restrict__ s;  // [ceil(B / rb), n_dst, rb]
  int n_dst;
  int B;
  int rb;
  int c;  // the chunk
  __device__ __forceinline__ RowChunks chunk(int ci) const {
    RowChunks r = *this;
    r.c = ci;
    return r;
  }
  __device__ __forceinline__ int b0() const { return c * rb; }
  __device__ __forceinline__ int rows() const {  // rows of the chunk below B
    const int n = B - b0();
    return n < rb ? n : rb;
  }
  __device__ __forceinline__ float* at(int d) const {
    return s + ((int64_t)c * n_dst + d) * rb;
  }
};

// The chunk's rb weights of source s from W[B, n_src], row-major, a load a
// row (the identity past the chunk's rows and for an out-of-range s).
template <int OP>
struct ChunkFrontier {
  const float* __restrict__ w;
  int n_src;
  __device__ __forceinline__ void operator()(int b0, int nr, int s,
                                             float (&ws)[kRowChunk]) const {
    const bool in = s >= 0 && s < n_src;
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) {
      ws[r] = (in && r < nr) ? __ldg(w + (int64_t)(b0 + r) * n_src + s) : identity<OP>();
    }
  }
};

// One edge's products for chunk y: v[r] is row b0 + r's product where bit r
// of the returned mask is set, the identity elsewhere; *d the edge's dst. 0:
// no row writes, or dst is out of range or not kept. W is ChunkFrontier or
// the fused regions' gather of a chunk of their intermediate: weight(b0, nr,
// s, v) sets v[r] to row b0 + r's weight of source s (the identity past nr).
template <int OP, class W, class Dst, class M, class Keep>
__device__ __forceinline__ unsigned chunk_products(const W& weight,
                                                   const int32_t* __restrict__ src, int64_t e,
                                                   const Dst& dst, const M& m,
                                                   const RowChunks& y, float (&v)[kRowChunk],
                                                   int* d, const Keep& keep) {
  const float zero = identity<OP>();
  const int b0 = y.b0(), nr = y.rows();
  weight(b0, nr, src[e], v);
  float shared = 0.0f;
  bool have_m = false;
  unsigned live = 0;
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) {
    const float ws = v[r];
    v[r] = zero;
    if (r >= nr || (OP != kSum && ws == zero)) continue;  // past B, or the identity
    if (!have_m) {
      shared = m.edge(e);
      have_m = true;
    }
    const float mv = m.row(shared, e, b0 + r);
    float prod;
    if (OP == kSum) {
      prod = ws * mv;
      if (prod == 0.0f) continue;  // adding 0 is the identity
    } else if (OP == kBool) {
      if (!(ws > 0.0f && mv != 0.0f)) continue;
      prod = 1.0f;
    } else {
      prod = ws * mv;
    }
    v[r] = prod;
    live |= 1u << r;
  }
  if (live == 0) return 0;
  *d = dst(e);
  return (*d >= 0 && *d < y.n_dst && keep(*d)) ? live : 0;
}

__device__ __forceinline__ void red_add_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

__device__ __forceinline__ void red_add_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" :: "l"(p), "f"(a), "f"(b) : "memory");
}

// p[0..rb) ⊕= v where the row writes (bit r of live), p one chunk's sector
// of S: for sum a vector reduction a 4 rows with a live row, else the op's
// scalar combine row by row.
template <int OP>
__device__ __forceinline__ void chunk_combine(float* p, const float (&v)[kRowChunk],
                                              unsigned live, int rb) {
  if (OP == kSum) {
    if (rb == 8) {
      if (live & 0x0fu) red_add_v4(p, v[0], v[1], v[2], v[3]);
      if (live & 0xf0u) red_add_v4(p + 4, v[4], v[5], v[6], v[7]);
    } else if (rb == 4) {
      red_add_v4(p, v[0], v[1], v[2], v[3]);
    } else {
      red_add_v2(p, v[0], v[1]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) {
    if (live >> r & 1u) combine<OP>(p + r, v[r]);
  }
}

// The CTA's table in dynamic shared memory: keys[slots], then
// vals[rb][slots], slots = 2^rows_table_bits(rb).
template <int OP>
struct RowsTable {
  int* keys;
  float* vals;
  int bits;  // log2 of the slots
  RowChunks y;

  // Fill the table (keys empty, values the identity); every thread of the
  // CTA must call it.
  __device__ __forceinline__ RowsTable(float* smem, const RowChunks& rows)
      : keys(reinterpret_cast<int*>(smem)),
        vals(smem + (1 << rows_table_bits(rows.rb))),
        bits(rows_table_bits(rows.rb)),
        y(rows) {
    __syncthreads();  // a previous run's flush has read the table
    for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) keys[i] = kEmptyKey;
    for (int i = threadIdx.x; i < (y.rb << bits); i += blockDim.x) {
      vals[i] = identity<OP>();
    }
    __syncthreads();
  }

  // The chunk's products of an edge into dst d's slot; straight to S when
  // neither d nor a free slot lies within kTableProbes slots.
  __device__ __forceinline__ void add(int d, const float (&v)[kRowChunk], unsigned live) const {
    const unsigned mask = (1u << bits) - 1;
    unsigned h = ((unsigned)d * 0x9E3779B1u) >> (32 - bits);
#pragma unroll
    for (int p = 0; p < kTableProbes; ++p) {
      int k = *reinterpret_cast<volatile int*>(keys + h);
      if (k == kEmptyKey) {
        k = atomicCAS(keys + h, kEmptyKey, d);
        if (k == kEmptyKey) k = d;  // claimed here
      }
      if (k == d) {
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) {
          if (live >> r & 1u) combine<OP>(vals + (r << bits) + h, v[r]);
        }
        return;
      }
      h = (h + 1) & mask;
    }
    chunk_combine<OP>(y.at(d), v, live, y.rb);
  }

  // One combine into S per occupied slot, of the values that are not the
  // identity; every thread of the CTA must call it.
  __device__ __forceinline__ void flush() const {
    __syncthreads();
    for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) {
      const int k = keys[i];
      if (k == kEmptyKey) continue;
      float v[kRowChunk];
      unsigned live = 0;
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) {
        v[r] = r < y.rb ? vals[(r << bits) + i] : identity<OP>();
        if (v[r] != identity<OP>()) live |= 1u << r;
      }
      if (live) chunk_combine<OP>(y.at(k), v, live, y.rb);
    }
  }
};

// Edge e for chunk y: straight to S (table == nullptr) or into the table
// (which is y's); an edge whose dst is not kept issues nothing.
template <int OP, class W, class Dst, class M, class Keep = KeepAll>
__device__ __forceinline__ void chunk_edge(int64_t e, const W& w,
                                           const int32_t* __restrict__ src, const Dst& dst,
                                           const M& m, const RowChunks& y,
                                           const RowsTable<OP>* table,
                                           const Keep& keep = Keep{}) {
  float v[kRowChunk];
  int d = 0;
  const unsigned live = chunk_products<OP>(w, src, e, dst, m, y, v, &d, keep);
  if (!live) return;
  if (table != nullptr) {
    table->add(d, v, live);
  } else {
    chunk_combine<OP>(y.at(d), v, live, y.rb);
  }
}

// The batched scan of chunk blockIdx.x: per edge, a grid-stride loop over
// the edges along gridDim.y; with the table (smem != nullptr), CTA
// blockIdx.y takes one contiguous range of edges, a whole number of warps'
// edges.
template <int OP, class Dst, class M>
__device__ __forceinline__ void rows_scan(float* smem, const ChunkFrontier<OP>& w,
                                          const int32_t* __restrict__ src, const Dst& dst,
                                          const M& m, int64_t E, const RowChunks& rows) {
  const RowChunks y = rows.chunk(blockIdx.x);
  if (smem == nullptr) {
    const int64_t stride = (int64_t)gridDim.y * blockDim.x;
    for (int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; e < E; e += stride) {
      chunk_edge<OP>(e, w, src, dst, m, y, nullptr);
    }
    return;
  }
  int64_t per = (E + gridDim.y - 1) / gridDim.y;
  per = (per + 31) & ~(int64_t)31;
  const int64_t e0 = (int64_t)blockIdx.y * per;
  if (e0 >= E) return;  // the whole CTA
  const int64_t e1 = e0 + per < E ? e0 + per : E;
  const RowsTable<OP> tab(smem, y);
  for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    chunk_edge<OP>(e, w, src, dst, m, y, &tab);
  }
  tab.flush();
}

// The batched active hop of chunk blockIdx.x over the union of the rows'
// lists, so each listed block is streamed once a chunk: per edge, CTA
// blockIdx.y takes every gridDim.y-th listed block; with the table, a run of
// consecutive listed blocks into one table, flushed once. keep(d) false:
// the edge issues nothing (the fused degenerate region's output mask).
template <int OP, class Dst, class M, class Keep = KeepAll>
__device__ __forceinline__ void rows_active(float* smem, const ChunkFrontier<OP>& w,
                                            const int32_t* __restrict__ src, const Dst& dst,
                                            const M& m, int64_t E, const RowChunks& rows,
                                            const int32_t* __restrict__ block_idx, int n_cap,
                                            const int32_t* __restrict__ n_active,
                                            int scan_above, const Keep& keep = Keep{}) {
  const RowChunks y = rows.chunk(blockIdx.x);
  const Listed list(E, block_idx, n_cap, n_active, scan_above);
  auto block = [&](int64_t i, const RowsTable<OP>* tab) {
    const int64_t e0 = list.first_edge(i);
    const int64_t e1 = e0 + kEdgeBlock < E ? e0 + kEdgeBlock : E;
    for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      chunk_edge<OP>(e, w, src, dst, m, y, tab, keep);
    }
  };
  if (smem == nullptr) {
    for (int64_t i = blockIdx.y; i < list.count; i += gridDim.y) block(i, nullptr);
    return;
  }
  const int64_t per = (list.count + gridDim.y - 1) / gridDim.y;
  const int64_t i0 = (int64_t)blockIdx.y * per;
  const int64_t i1 = i0 + per < list.count ? i0 + per : list.count;
  if (i0 >= i1) return;  // the whole CTA
  const RowsTable<OP> tab(smem, y);
  for (int64_t i = i0; i < i1; ++i) block(i, &tab);
  tab.flush();
}

// The epilogue: Y[b, d] = S[b / RB, d, b % RB] for b < B, a tile of
// kTileDst destinations × RB rows at a time through shared memory (read
// along S, written along Y's rows; the tile's row stride RB + 1 keeps the
// transposed reads off one bank).
constexpr int kTileDst = 256;

// Bytes of the epilogue's tile at rb rows a chunk.
inline size_t tile_bytes(int rb) { return sizeof(float) * kTileDst * (rb + 1); }

// The epilogue's tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... through
// `tile` (tile_bytes(RB) of shared memory); every thread of the CTA must
// call it.
template <int RB>
__device__ __forceinline__ void chunk_tiles(const float* __restrict__ s, float* __restrict__ y,
                                            int B, int n_dst, float* tile) {
  const int64_t per_chunk = (n_dst + kTileDst - 1) / kTileDst;
  const int64_t n_tiles = per_chunk * ((B + RB - 1) / RB);
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int c = (int)(t / per_chunk);
    const int d0 = (int)(t % per_chunk) * kTileDst;
    const int nd = n_dst - d0 < kTileDst ? n_dst - d0 : kTileDst;
    const float* in = s + ((int64_t)c * n_dst + d0) * RB;
    for (int i = threadIdx.x; i < nd * RB; i += blockDim.x) {
      tile[(i / RB) * (RB + 1) + i % RB] = in[i];
    }
    __syncthreads();
    const int rows = B - c * RB < RB ? B - c * RB : RB;
    for (int i = threadIdx.x; i < rows * kTileDst; i += blockDim.x) {
      const int r = i / kTileDst, dd = i % kTileDst;
      if (dd < nd) y[(int64_t)(c * RB + r) * n_dst + d0 + dd] = tile[dd * (RB + 1) + r];
    }
    __syncthreads();
  }
}

template <int RB>
__global__ void rows_from_chunks(const float* __restrict__ s, float* __restrict__ y, int B,
                                 int n_dst) {
  __shared__ float tile[kTileDst * (RB + 1)];
  chunk_tiles<RB>(s, y, B, n_dst, tile);
}

inline int scan_grid(int64_t E) {
  int64_t blocks = (E + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxScanBlocks ? blocks : kMaxScanBlocks);
}

inline int64_t n_edge_blocks(int64_t E) { return (E + kEdgeBlock - 1) / kEdgeBlock; }

// The CTAs of kThreads that are co-resident on the card for kernel with smem
// bytes of dynamic shared memory each: *wave. Returns a CUDA error code.
template <class K>
int wave_size(K kernel, size_t smem, int* wave) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
  *wave = per_sm * sms;
  return 0;
}

// A one-wave grid for Kernel: the CTAs co-resident with Smem bytes of
// dynamic shared memory each, but no more than the E-edge index has
// EDGE_BLOCK-edge blocks. Returns a CUDA error code (0: *grid is set).
// The occupancy is asked once per (kernel instantiation, Smem).
template <auto Kernel, size_t Smem>
int wave_grid(int64_t E, int* grid) {
  static int cached = 0;
  if (cached == 0) {
    const int err = wave_size(Kernel, Smem, &cached);
    if (err) return err;
  }
  const int64_t nb = n_edge_blocks(E);
  *grid = (int)(nb < cached ? nb : cached);
  return 0;
}

// The grid and dynamic shared memory of a one-row hop's Kernel (the SpMV
// pairs; the batched hops at B = 1): the per-edge scan scan_grid CTAs, the
// other schedules one wave, with the table's shared memory or without.
// Returns a CUDA error code.
template <auto Kernel>
int row_grid(int64_t E, int table, bool active, int* grid, size_t* smem) {
  *smem = table ? kTableBytes : 0;
  *grid = scan_grid(E);
  if (table) return wave_grid<Kernel, kTableBytes>(E, grid);
  return active ? wave_grid<Kernel, 0>(E, grid) : 0;
}

// -- the batched launches' host side -------------------------------------------

// One batched launch (rb = 2, 4 or 8): the scratch S, Y, and the schedule.
struct RowsLaunch {
  int64_t E;
  int B;
  int rb;
  int n_dst;
  float* s;
  float* y;
  int table;
  bool active;
  cudaStream_t stream;
};

// Kernel's grid for launch a (x: the row chunks, y: the edge CTAs) and its
// dynamic shared memory: the per-edge scan scan_grid edge CTAs; the other
// schedules one wave, the CTAs co-resident at the shared memory (asked once
// per kernel instantiation and form: per edge, or the table at rb = 2, 4,
// 8, after raising the kernel's limit to the largest table) divided among
// the chunks, but no more edge CTAs than the index has EDGE_BLOCK-edge
// blocks. Returns a CUDA error code.
template <auto Kernel>
int rows_grid(const RowsLaunch& a, dim3* grid, size_t* smem) {
  const int chunks = (a.B + a.rb - 1) / a.rb;
  *smem = a.table ? rows_table_bytes(a.rb) : 0;
  int64_t ctas = scan_grid(a.E);
  if (a.table || a.active) {
    static bool raised = false;
    static int waves[4];  // per edge, then the table at rb = 2, 4, 8
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_table_max_bytes());
      if (err != cudaSuccess) return (int)err;
      raised = true;
    }
    int& wave = waves[a.table ? (a.rb == 2 ? 1 : a.rb == 4 ? 2 : 3) : 0];
    if (wave == 0) {
      const int err = wave_size(Kernel, *smem, &wave);
      if (err) return err;
    }
    const int64_t nb = n_edge_blocks(a.E);
    ctas = wave / chunks > 1 ? wave / chunks : 1;
    if (ctas > nb) ctas = nb;
  }
  *grid = dim3((unsigned)chunks, (unsigned)ctas);
  return 0;
}

// Launch the epilogue Y[b, d] = S[b / rb, d, b % rb]. Returns a CUDA error
// code.
inline int rows_epilogue(const RowsLaunch& a) {
  const int64_t tiles = (a.n_dst + kTileDst - 1) / kTileDst * ((a.B + a.rb - 1) / a.rb);
  const int grid = (int)(tiles < kMaxScanBlocks ? tiles : kMaxScanBlocks);
  if (a.rb == 8) {
    rows_from_chunks<8><<<grid, kThreads, 0, a.stream>>>(a.s, a.y, a.B, a.n_dst);
  } else if (a.rb == 4) {
    rows_from_chunks<4><<<grid, kThreads, 0, a.stream>>>(a.s, a.y, a.B, a.n_dst);
  } else {
    rows_from_chunks<2><<<grid, kThreads, 0, a.stream>>>(a.s, a.y, a.B, a.n_dst);
  }
  return (int)cudaGetLastError();
}

}  // namespace hop
