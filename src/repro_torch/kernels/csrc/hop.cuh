// hop.cuh: the per-edge body shared by every hop kernel of the port
// (fragment_spmv.cu: dense columns; fragment_spmv_packed.cu: BCA columns
// decoded in registers; fragment_spmv_fused.cu: the fused regions, which
// read their weight through another gather and mask at the scatter), and its
// batched form edge_rows (fragment_spmm.cu, fragment_spmm_packed.cu and the
// fused regions' SpMM form: B frontier rows over one read of the edge), in
// two schedules:
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
template <class Block>
__device__ __forceinline__ void listed_blocks(int64_t E, const int32_t* __restrict__ block_idx,
                                              int n_cap, const int32_t* __restrict__ n_active,
                                              int scan_above, const Block& block) {
  const int na = __ldg(n_active);
  const bool scan_order = na > scan_above;  // 'auto' above its threshold
  const int64_t count =
      scan_order ? (E + kEdgeBlock - 1) / kEdgeBlock : (na < n_cap ? na : n_cap);
  for (int64_t i = blockIdx.x; i < count; i += gridDim.x) {
    const int64_t b = scan_order ? i : __ldg(block_idx + i);
    const int64_t e0 = b * kEdgeBlock;
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
  const int na = __ldg(n_active);
  const bool scan_order = na > scan_above;  // 'auto' above its threshold
  const int64_t count =
      scan_order ? (E + kEdgeBlock - 1) / kEdgeBlock : (na < n_cap ? na : n_cap);
  const int64_t per = (count + gridDim.x - 1) / gridDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * per;
  const int64_t i1 = i0 + per < count ? i0 + per : count;
  if (i0 >= i1) return;  // the whole CTA
  const TableSink<OP> tab = table_open<OP>(smem, y);
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t e0 = (scan_order ? i : __ldg(block_idx + i)) * kEdgeBlock;
    table_run<OP>(tab, e0, e0 + kEdgeBlock < E ? e0 + kEdgeBlock : E, w, n_src, src, dst, m,
                  n_dst);
  }
  table_flush(tab);
}

// -- the batched body (the multi-query SpMM): B frontier rows, one edge stream --
//
//   Y[b·n_dst + dst(e)] ⊕= W[b·n_src + src[e]] ⊗ m_b(e)   for b < B
//
// An edge's src, dst and shared measure are read (and BCA words decoded) once
// for all B rows; each row then applies edge_with's rules: the identity guard
// row by row (a row whose weight is the identity issues no write), the ∞·0
// guard, bool as (w > 0) & (m != 0), no atomic for an identity product, and
// the float min/max atomics. dst is decoded at the first row that writes, and
// an out-of-range or unkept dst ends the edge for every row. Row offsets are
// int64: b·n_dst passes 2^31 at B = 640 over 4M documents.

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

template <int OP>
struct FrontierRows {  // W[B, n_src], read-only for the whole launch
  const float* __restrict__ w;
  int n_src;
  __device__ __forceinline__ float operator()(int b, int s) const {
    return (s >= 0 && s < n_src) ? __ldg(w + (int64_t)b * n_src + s) : identity<OP>();
  }
};

template <int OP, class W, class Dst, class M, class Keep>
__device__ __forceinline__ void edge_rows(const W& weight, const int32_t* __restrict__ src,
                                          int64_t e, const Dst& dst, const M& m,
                                          float* __restrict__ y, int n_dst, int B,
                                          const Keep& keep) {
  const float zero = identity<OP>();
  const int s = src[e];
  float shared = 0.0f;
  bool have_m = false;
  int d = -1;
  for (int b = 0; b < B; ++b) {
    const float ws = weight(b, s);
    if (OP != kSum && ws == zero) continue;  // this row's product is the identity
    if (!have_m) {
      shared = m.edge(e);
      have_m = true;
    }
    const float mv = m.row(shared, e, b);
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
    if (d < 0) {
      d = dst(e);
      if (d < 0 || d >= n_dst || !keep(d)) return;  // no row writes this edge
    }
    float* yb = y + (int64_t)b * n_dst + d;
    if (OP == kSum) {
      atomicAdd(yb, prod);
    } else if (OP == kBool) {
      *yb = 1.0f;
    } else if (OP == kMin) {
      atomic_min_float(yb, prod);
    } else {
      atomic_max_float(yb, prod);
    }
  }
}

template <int OP, class Dst, class M>
__device__ __forceinline__ void scan_rows(const FrontierRows<OP>& w,
                                          const int32_t* __restrict__ src, const Dst& dst,
                                          const M& m, int64_t E, float* __restrict__ y,
                                          int n_dst, int B) {
  scan_edges(E, [&](int64_t e) { edge_rows<OP>(w, src, e, dst, m, y, n_dst, B, KeepAll{}); });
}

// The active schedule over the union of the rows' active blocks, so each
// listed block is streamed once for all B rows.
template <int OP, class Dst, class M>
__device__ __forceinline__ void active_rows(const FrontierRows<OP>& w,
                                            const int32_t* __restrict__ src, const Dst& dst,
                                            const M& m, int64_t E, float* __restrict__ y,
                                            int n_dst, int B,
                                            const int32_t* __restrict__ block_idx, int n_cap,
                                            const int32_t* __restrict__ n_active,
                                            int scan_above) {
  active_edges(E, block_idx, n_cap, n_active, scan_above, [&](int64_t e) {
    edge_rows<OP>(w, src, e, dst, m, y, n_dst, B, KeepAll{});
  });
}

inline int scan_grid(int64_t E) {
  int64_t blocks = (E + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxScanBlocks ? blocks : kMaxScanBlocks);
}

inline int64_t n_edge_blocks(int64_t E) { return (E + kEdgeBlock - 1) / kEdgeBlock; }

// A one-wave grid for Kernel: the CTAs of kThreads co-resident with Smem
// bytes of dynamic shared memory each, but no more than the E-edge index
// has EDGE_BLOCK-edge blocks. Returns a CUDA error code (0: *grid is set).
// The occupancy is asked once per (kernel instantiation, Smem).
template <auto Kernel, size_t Smem>
int wave_grid(int64_t E, int* grid) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, Smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  const int64_t nb = n_edge_blocks(E);
  *grid = (int)(nb < cached ? nb : cached);
  return 0;
}

}  // namespace hop
