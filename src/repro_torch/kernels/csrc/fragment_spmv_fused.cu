// fragment_spmv_fused: a pipelined region of the plan (core/fuse.py's
// FusedHopOp) in ONE launch on Hopper.
//
//   two-hop region (fused2):  u[mid]  ⊕= w[src1] ⊗ m1
//                             out[d2] ⊕= β(κ(u)[src2]) ⊗ m2
//     κ(u)[s] = keep[s] > 0 ? u[s] : 0̄ (the mid mask), β = binarize for a
//     semijoin, else the identity
//   degenerate region (fused1): out[d1] ⊕= w[src1] ⊗ m1   where keep[d1] > 0
//
// ⊕ ∈ {sum, min, max, bool}; each hop's dst is an int32 column or BCA words and
// its measure none / dense / packed / dict, as in fragment_spmv_packed.
//
// Replaces the TPU kernels repro/kernels/fragment_spmv_fused.py::
// _kernel_fused2 (the C1 + 1 + C2 grid: hop1 into a VMEM scratch u, a mask /
// binarize step, hop2 against the resident u) and ::_kernel_fused1 (the
// C1 + 1 grid: hop1 into u, then the mask written once), both reached through
// _fused_call (pallas_calls at :331 and :297).
//
// What bounds them: bytes, as for the unfused hops — the listed blocks' edge
// streams, w, keep and out; u is 4·n_mid bytes that stay in the 50 MB L2 at
// the main path's single-query sizes. What holds a hop back on the H100 is
// not its bytes but its reductions: one float atomic an edge serialises on a
// hot destination (I_DA.Doc's Zipf-hot authors, the top one 961,054 edges),
// and B rows a destination in a row-major [B, n] lay B atomics on lines far
// apart, each an L2 miss. The regions take the unfused hops' cures for both
// (hop.cuh: the per-CTA table, the row-chunk body), inside their one launch.
//
// fused2, one cooperative, persistent launch (cudaLaunchCooperativeKernel,
// grid = the co-resident CTAs at most, counted with the launch's dynamic
// shared memory), phases separated by grid.sync():
//   0. fill u and the output (the SpMM form: its scratch) with the identity,
//      zero the block counters;
//   1. hop1 over bi1[0..n_active1) into u;
//   2. hop2 over bi2[0..n_active2) from u into the output;
//   3. (the SpMM form) the epilogue: out[B, n_dst] from the output scratch.
// Hopper has no grid-wide on-chip buffer, and hop2 may read u[src] only
// after every hop1 edge has landed: hence the barriers. In each hop phase a
// CTA takes listed blocks from the phase's global counter (one atomicAdd a
// block), so a CTA whose blocks contend does not hold the phase back while
// others sit idle. This dynamic draw was kept over active_agg's run of
// consecutive list positions: it balances the phase without a second pass,
// and a CTA's table still flushes once a phase. A grid that cannot be
// co-resident is refused by the launch and the wrapper raises; there is no
// non-cooperative fallback.
//
// Each hop phase has a table flag (table1, table2: kernels/ops.py passes
// uses_table(hot_share) of the hop's index). With the flag set, a CTA that
// draws a block opens one table in dynamic shared memory (hop.cuh TableSink,
// or RowsTable of row chunks for the SpMM form), runs every block it draws
// into it and flushes it once, when the counter is spent, before the
// barrier; a CTA that draws nothing opens no table. The occupancy query, the
// cached co-resident grid (per op, form, rows a chunk and table) and the
// launch all count the table's bytes.
//
// The SpMM form (the reference's fragment_spmm_fused: the same pallas_call
// sites with batched=True) runs B frontier rows w[B, n_src] through one
// region on hop.cuh's row-chunk body, as the unfused SpMM kernels do: u is
// laid out [ceil(B / rb), n_mid, rb] (fragment_spmm.row_scratch's layout, rb =
// row_chunk(B)) and hop2 accumulates into a scratch s[ceil(B / rb), n_dst,
// rb], so an edge's chunk of rb rows lands in one sector (one or two
// red.global.add.v4.f32 for sum, chunk_combine) or in a RowsTable slot.
// Work items are (chunk, listed block) pairs: a CTA serves one chunk (or,
// with fewer CTAs than chunks, every gridDim.x-th) and draws blocks from that
// chunk's counter, so the chunks stream the same blocks at about the same
// time and all but one read them from L2. hop2 gathers a chunk of u as one
// sector (__ldcg: u was written in this launch) and applies the mask and the
// binarize row by row (MidChunk). The last phase writes out[b, d] =
// s[b / rb, d, b % rb] through a tile in shared memory, as rows_epilogue
// does. At B = 1 (rb = 1) the SpMM form runs the SpMV form into out.
//
// fused1 needs no barrier and no scratch beyond the SpMM form's: one wave of
// CTAs (those co-resident, with the table's shared memory or without) over
// the list, as the unfused active hops run: per edge, CTA c takes list
// positions c, c + gridDim.x, ...; with the table, a run of consecutive
// positions into one table, flushed once (hop.cuh Listed). The output mask
// sits before the sink (edge_into's Keep): an edge whose dst has keep ≤ 0
// issues nothing, so out keeps the identity there. The SpMM form is
// hop.cuh's rows_active with the mask, then rows_epilogue, in the same call.
//
// The mid mask and hop2's binarize are applied at hop2's gather, in
// registers: where(keep > 0, u, 0̄) then binarize. hop2's src ids are sorted,
// so its keep reads are coalesced; a mask at hop1's scatter instead reads
// keep at hop1's random dst ids, which on the H100 cost more than the
// atomics it saved (PERF.md). The lists and their counts stay on the card:
// n_active is read here, so the host never waits for them (hop2's list is
// derived from hop1's by the fuse-time reach matrix, on the card, before the
// launch). The per-edge rules (identity guard, ∞·0 guard, out-of-range src
// and dst, bool, float min/max atomics, +0.0 for rows that do not write) are
// hop.cuh's and the decode bca.cuh's, so fused and unfused hops cannot drift
// apart. The operand modes are chosen at run time (a uniform branch) rather
// than by template, which keeps to 4 instantiations a kernel and form.
// Both masks are read as one byte an entry (kept): the wrapper makes the
// bytes from a float32 mask once a tensor, so a plan's constant mask is
// converted once. On the H100 fused1 ran 20% faster with the byte mask
// than with the float32 one at SD-recent's region over every source, 13% at
// B = 8 (PERF.md). This file allocates nothing and does not synchronise.

#include <cooperative_groups.h>
#include <limits.h>

#include "hop.cuh"

namespace cg = cooperative_groups;

// One hop's streams as the wrapper passes them (kernels/fragment_spmv_fused.py
// HopArgs mirrors this layout field for field). Outside the unnamed namespace:
// the C entry points take it, and a type with internal linkage would give
// them internal linkage too.
struct HopArgs {
  const int32_t* src;
  int64_t E;
  const void* dst;  // int32[E] when dst_width == 0, else BCA words
  int64_t dst_words;
  int32_t dst_width;
  int32_t m_mode;   // 0 none, 1 dense, 2 packed, 3 dict
  const void* m;    // float32[E] (dense) or BCA words (packed, dict)
  int64_t m_words;
  int32_t m_width;
  int32_t n_dict;
  const float* mdict;
};

namespace {

using namespace hop;

enum MMode { kNone = 0, kDense = 1, kPacked = 2, kDict = 3 };

// A region's lists are followed whatever their length (no scan order).
constexpr int kFollowList = INT_MAX;

struct AnyDst {
  DenseDst dense;
  PackedDst packed;
  __device__ __forceinline__ int operator()(int64_t e) const {
    return packed.width ? packed(e) : dense(e);
  }
};

struct AnyMeasure {
  int mode;
  DenseMeasure dense;
  PackedMeasure packed;
  DictMeasure dict;
  __device__ __forceinline__ float operator()(int64_t e) const {
    switch (mode) {
      case kDense: return dense(e);
      case kPacked: return packed(e);
      case kDict: return dict(e);
      default: return 1.0f;
    }
  }
};

struct Hop {
  const int32_t* src;
  int64_t E;
  AnyDst dst;
  AnyMeasure m;
};

Hop make_hop(const HopArgs& a) {
  const uint32_t* dw = static_cast<const uint32_t*>(a.dst);
  const uint32_t* mw = static_cast<const uint32_t*>(a.m);
  Hop h;
  h.src = a.src;
  h.E = a.E;
  h.dst.dense = DenseDst{static_cast<const int32_t*>(a.dst)};
  h.dst.packed = PackedDst{dw, a.dst_words, a.dst_width};
  h.m.mode = a.m_mode;
  h.m.dense = DenseMeasure{static_cast<const float*>(a.m)};
  h.m.packed = PackedMeasure{mw, a.m_words, a.m_width};
  h.m.dict = DictMeasure{mw, a.m_words, a.m_width, a.mdict, a.n_dict};
  return h;
}

// The mask's test at entry i: keep is one byte an entry, nonzero where
// kept (the wrapper makes it from a float32 mask, keep > 0, once a tensor).
__device__ __forceinline__ bool kept(const unsigned char* __restrict__ keep, int i) {
  return __ldg(keep + i) != 0;
}

// The semijoin's binarize (Semiring.binarize: sum → u > 0; the others →
// u ≠ 0̄ ? 1 : 0̄); the identity stays the identity.
template <int OP>
__device__ __forceinline__ float binarized(float v) {
  if (OP == kSum) return v > 0.0f ? 1.0f : 0.0f;
  return v != identity<OP>() ? 1.0f : identity<OP>();
}

// hop2's gather from u[n_mid]: the mid mask (keep == nullptr: no mask), then
// the binarize. A src past n_mid reads the identity.
template <int OP>
struct MidGather {
  const float* u;
  const unsigned char* __restrict__ keep;
  int n_mid;
  int binarize;
  __device__ __forceinline__ float operator()(int s) const {
    float v = identity<OP>();
    if (s >= 0 && s < n_mid && (keep == nullptr || kept(keep, s))) v = __ldcg(u + s);
    return binarize ? binarized<OP>(v) : v;
  }
};

// hop2's gather of a row chunk from u[ceil(B / rb), n_mid, rb]: the chunk's
// rb values of source s are one sector, read at once (__ldcg: u was written
// in this launch); the mask, shared by the rows, is read once; the binarize
// applies row by row. Rows past nr, a masked or out-of-range s: the identity.
template <int OP>
struct MidChunk {
  const float* u;
  const unsigned char* __restrict__ keep;
  int n_mid;
  int binarize;
  int rb;
  __device__ __forceinline__ void operator()(int b0, int nr, int s,
                                             float (&ws)[kRowChunk]) const {
    const float zero = identity<OP>();
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) ws[r] = zero;
    if (s < 0 || s >= n_mid || (keep != nullptr && !kept(keep, s))) return;
    // sector (b0 / rb, s) of u starts at ((b0 / rb)·n_mid + s)·rb
    const float* p = u + (int64_t)b0 * n_mid + (int64_t)s * rb;
    if (rb == 8) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
      ws[0] = a.x, ws[1] = a.y, ws[2] = a.z, ws[3] = a.w;
      ws[4] = b.x, ws[5] = b.y, ws[6] = b.z, ws[7] = b.w;
    } else if (rb == 4) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
      ws[0] = a.x, ws[1] = a.y, ws[2] = a.z, ws[3] = a.w;
    } else {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(p));
      ws[0] = a.x, ws[1] = a.y;
    }
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) {
      if (r >= nr) {
        ws[r] = zero;
      } else if (binarize) {
        ws[r] = binarized<OP>(ws[r]);
      }
    }
  }
};

struct KeepMask {  // keep == nullptr: no mask
  const unsigned char* __restrict__ keep;
  __device__ __forceinline__ bool operator()(int d) const {
    return keep == nullptr || kept(keep, d);
  }
};

__device__ __forceinline__ int listed(const int32_t* __restrict__ n_active, int cap) {
  const int na = __ldg(n_active);
  return na < cap ? na : cap;
}

__device__ __forceinline__ int64_t block_end(int64_t e0, int64_t E) {
  return e0 + kEdgeBlock < E ? e0 + kEdgeBlock : E;
}

// The next position of a phase's list from its counter (zero before the
// phase): one atomicAdd a block, read by the whole CTA.
__device__ __forceinline__ int draw(int* next) {
  __shared__ int slot;
  if (threadIdx.x == 0) slot = atomicAdd(next, 1);
  __syncthreads();
  const int t = slot;
  __syncthreads();  // every thread has read slot before it is drawn again
  return t;
}

// Block bi[t] and every block drawn after it until the count n is reached,
// each edge through the edge rules into sink.
template <int OP, class W, class Sink>
__device__ __forceinline__ void drain(int t, int n, const W& weight, const Hop& h, int n_dst,
                                      const Sink& sink, const int32_t* __restrict__ bi,
                                      int* next) {
  for (; t < n; t = draw(next)) {
    const int b = __ldg(bi + t);
    if (b < 0) continue;
    const int64_t e0 = (int64_t)b * kEdgeBlock, e1 = block_end(e0, h.E);
    for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      edge_into<OP>(weight, h.src, e, h.dst, h.m, n_dst, KeepAll{}, sink);
    }
  }
}

// One hop phase of the SpMV form into y[n_dst]: the blocks this CTA draws,
// an atomic an edge (smem == nullptr) or into one table flushed once.
template <int OP, class W>
__device__ __forceinline__ void hop_phase(float* smem, const W& weight, const Hop& h,
                                          float* __restrict__ y, int n_dst,
                                          const int32_t* __restrict__ bi, int cap,
                                          const int32_t* __restrict__ na, int* next) {
  const int n = listed(na, cap);
  const int t = draw(next);
  if (t >= n) return;  // the whole CTA: no table opened
  if (smem == nullptr) {
    drain<OP>(t, n, weight, h, n_dst, ToGlobal<OP>{y}, bi, next);
    return;
  }
  const TableSink<OP> tab = table_open<OP>(smem, y);
  drain<OP>(t, n, weight, h, n_dst, tab, bi, next);
  table_flush(tab);
}

// One hop phase of the SpMM form into the row-chunk scratch `rows`: the CTA
// serves chunk blockIdx.x mod chunks (with fewer CTAs than chunks, chunks
// blockIdx.x, + gridDim.x, ...), drawing blocks from that chunk's counter
// next[c]; per edge, or into one RowsTable a chunk, flushed once.
template <int OP, class W, class M>
__device__ __forceinline__ void rows_phase(float* smem, const W& weight, const Hop& h,
                                           const M& m, const RowChunks& rows, int chunks,
                                           const int32_t* __restrict__ bi, int cap,
                                           const int32_t* __restrict__ na, int* next) {
  const int n = listed(na, cap);
  const bool spread = (int)gridDim.x >= chunks;
  const int step = spread ? chunks : (int)gridDim.x;
  for (int c = spread ? (int)blockIdx.x % chunks : (int)blockIdx.x; c < chunks; c += step) {
    const RowChunks y = rows.chunk(c);
    int t = draw(next + c);
    if (t >= n) continue;
    auto run = [&](const RowsTable<OP>* tab) {
      for (; t < n; t = draw(next + c)) {
        const int b = __ldg(bi + t);
        if (b < 0) continue;
        const int64_t e0 = (int64_t)b * kEdgeBlock, e1 = block_end(e0, h.E);
        for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
          chunk_edge<OP>(e, weight, h.src, h.dst, m, y, tab);
        }
      }
    };
    if (smem == nullptr) {
      run(nullptr);
      continue;
    }
    const RowsTable<OP> tab(smem, y);
    run(&tab);
    tab.flush();
  }
}

// p[0..n) = v by the whole grid, 16 bytes a store (p is 16-byte aligned).
__device__ __forceinline__ void fill(float* p, int64_t n, float v) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nt = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n / 4;
  const float4 v4 = make_float4(v, v, v, v);
  for (int64_t i = tid; i < n4; i += nt) reinterpret_cast<float4*>(p)[i] = v4;
  for (int64_t i = 4 * n4 + tid; i < n; i += nt) p[i] = v;
}

// A region's launch arguments.
struct Region {
  const float* w;  // [n_src], or [B, n_src]
  int n_src;
  int B;
  int rb;  // rows a chunk of the SpMM form's scratch; 1: the SpMV form
  Hop h1, h2;
  const unsigned char* keep;  // the mask, a byte an entry (kept)
  int mid_binarize;
  float* u;  // the intermediate: [n_mid], or [ceil(B / rb), n_mid, rb]
  int n_mid;
  float* s;    // the SpMM form's output scratch [ceil(B / rb), n_dst, rb]
  float* out;  // [n_dst], or [B, n_dst]
  int n_dst;
  const int32_t* bi1;
  int cap1;
  const int32_t* na1;
  const int32_t* bi2;
  int cap2;
  const int32_t* na2;
  int* next;  // the hop phases' block counters: 2, or 2·ceil(B / rb)
};

// fused2's phases (the file header); ROWS: the SpMM form at rb > 1.
template <int OP, bool ROWS>
__global__ void __launch_bounds__(kThreads) fragment_spmv_fused2_kernel(Region r, int table1,
                                                                        int table2) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const float zero = identity<OP>();
  const int chunks = ROWS ? (r.B + r.rb - 1) / r.rb : 1;
  fill(r.u, (int64_t)chunks * r.rb * r.n_mid, zero);
  fill(ROWS ? r.s : r.out, (int64_t)chunks * r.rb * r.n_dst, zero);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < 2 * chunks) r.next[tid] = 0;
  grid.sync();
  if constexpr (ROWS) {
    const RowChunks u{r.u, r.n_mid, r.B, r.rb, 0};
    const RowChunks s{r.s, r.n_dst, r.B, r.rb, 0};
    rows_phase<OP>(table1 ? smem : nullptr, ChunkFrontier<OP>{r.w, r.n_src}, r.h1,
                   SharedRows<AnyMeasure>{r.h1.m}, u, chunks, r.bi1, r.cap1, r.na1, r.next);
    grid.sync();  // every hop1 edge has landed in u
    rows_phase<OP>(table2 ? smem : nullptr,
                   MidChunk<OP>{r.u, r.keep, r.n_mid, r.mid_binarize, r.rb}, r.h2,
                   SharedRows<AnyMeasure>{r.h2.m}, s, chunks, r.bi2, r.cap2, r.na2,
                   r.next + chunks);
    grid.sync();  // every hop2 edge has landed in s
    if (r.rb == 8) {
      chunk_tiles<8>(r.s, r.out, r.B, r.n_dst, smem);
    } else if (r.rb == 4) {
      chunk_tiles<4>(r.s, r.out, r.B, r.n_dst, smem);
    } else {
      chunk_tiles<2>(r.s, r.out, r.B, r.n_dst, smem);
    }
  } else {
    hop_phase<OP>(table1 ? smem : nullptr, Frontier<OP>{r.w, r.n_src}, r.h1, r.u, r.n_mid,
                  r.bi1, r.cap1, r.na1, r.next);
    grid.sync();  // every hop1 edge has landed in u
    hop_phase<OP>(table2 ? smem : nullptr, MidGather<OP>{r.u, r.keep, r.n_mid, r.mid_binarize},
                  r.h2, r.out, r.n_dst, r.bi2, r.cap2, r.na2, r.next + 1);
  }
}

// Dynamic shared memory of fused2: the SpMV form's table; the SpMM form's
// table of row chunks or the epilogue's tile, whichever is larger.
size_t fused2_smem(bool rows, int rb, bool table) {
  if (!rows) return table ? kTableBytes : 0;
  const size_t tab = table ? rows_table_bytes(rb) : 0;
  return tab > tile_bytes(rb) ? tab : tile_bytes(rb);
}

// CTAs of fused2 that can be resident at once on the current device with
// the launch's shared memory, asked once per (op, form, rows a chunk, table).
template <int OP, bool ROWS>
int coresident_grid(int rb, bool table, int* grid) {
  static bool raised = false;
  static int cached[8];  // by log2(rb) and table
  if (ROWS && !raised) {
    const size_t most = rows_table_max_bytes() > tile_bytes(kRowChunk) ? rows_table_max_bytes()
                                                                       : tile_bytes(kRowChunk);
    const cudaError_t err = cudaFuncSetAttribute(
        fragment_spmv_fused2_kernel<OP, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  int& c = cached[2 * (rb == 8 ? 3 : rb == 4 ? 2 : rb == 2 ? 1 : 0) + (table ? 1 : 0)];
  if (c == 0) {
    const int err =
        wave_size(fragment_spmv_fused2_kernel<OP, ROWS>, fused2_smem(ROWS, rb, table), &c);
    if (err) return err;
  }
  *grid = c;
  return 0;
}

template <int OP, bool ROWS>
int launch2(Region r, int table1, int table2, cudaStream_t s) {
  const bool table = table1 || table2;
  int max_grid = 0;
  int err = coresident_grid<OP, ROWS>(r.rb, table, &max_grid);
  if (err != 0) return err;
  // no more CTAs than the chunks' block draws or the fill needs (8 values a
  // thread), and no more than can be co-resident
  const int64_t chunks = (r.B + r.rb - 1) / r.rb;
  const int64_t cells = chunks * r.rb * (r.n_mid > r.n_dst ? r.n_mid : r.n_dst);
  const int64_t fill = (cells + kThreads * 8 - 1) / (kThreads * 8);
  int64_t want = chunks * (r.cap1 > r.cap2 ? r.cap1 : r.cap2);
  if (fill > want) want = fill;
  if (want < 1) want = 1;
  const int grid = (int)(want < max_grid ? want : max_grid);
  void* args[] = {(void*)&r, (void*)&table1, (void*)&table2};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fragment_spmv_fused2_kernel<OP, ROWS>, dim3(grid), dim3(kThreads), args,
      fused2_smem(ROWS, r.rb, table), s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; the wrapper raises
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The listed block at position i into sink, the output mask before it.
template <int OP, class Sink>
__device__ __forceinline__ void masked_block(const Listed& list, int64_t i, const Region& r,
                                             const Sink& sink) {
  const Hop& h = r.h1;
  const Frontier<OP> w{r.w, r.n_src};
  const int64_t e0 = list.first_edge(i), e1 = block_end(e0, h.E);
  for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    edge_into<OP>(w, h.src, e, h.dst, h.m, r.n_dst, KeepMask{r.keep}, sink);
  }
}

// fused1's SpMV form: one wave over the list, per edge (CTA c takes
// positions c, c + gridDim.x, ...) or a run of consecutive positions into
// one table flushed once.
template <int OP>
__global__ void __launch_bounds__(kThreads) fragment_spmv_fused1_kernel(Region r, int table) {
  const Listed list(r.h1.E, r.bi1, r.cap1, r.na1, kFollowList);
  if (!table) {
    for (int64_t i = blockIdx.x; i < list.count; i += gridDim.x) {
      masked_block<OP>(list, i, r, ToGlobal<OP>{r.out});
    }
    return;
  }
  extern __shared__ float smem[];
  const int64_t per = (list.count + gridDim.x - 1) / gridDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * per;
  const int64_t i1 = i0 + per < list.count ? i0 + per : list.count;
  if (i0 >= i1) return;  // the whole CTA
  const TableSink<OP> tab = table_open<OP>(smem, r.out);
  for (int64_t i = i0; i < i1; ++i) masked_block<OP>(list, i, r, tab);
  table_flush(tab);
}

// fused1's SpMM form at rb > 1: the batched active hop of chunk blockIdx.x
// with the output mask, into the scratch r.s.
template <int OP>
__global__ void __launch_bounds__(kThreads) fragment_spmm_fused1_kernel(Region r, int table) {
  extern __shared__ float smem[];
  rows_active<OP>(table ? smem : nullptr, ChunkFrontier<OP>{r.w, r.n_src}, r.h1.src, r.h1.dst,
                  SharedRows<AnyMeasure>{r.h1.m}, r.h1.E, RowChunks{r.s, r.n_dst, r.B, r.rb, 0},
                  r.bi1, r.cap1, r.na1, kFollowList, KeepMask{r.keep});
}

template <int OP>
int launch1(const Region& r, int table, cudaStream_t stream) {
  int err;
  if (r.rb == 1) {
    int grid = 0;
    size_t smem = 0;
    err = row_grid<fragment_spmv_fused1_kernel<OP>>(r.h1.E, table, true, &grid, &smem);
    if (err) return err;
    fragment_spmv_fused1_kernel<OP><<<grid, kThreads, smem, stream>>>(r, table);
    return (int)cudaGetLastError();
  }
  const RowsLaunch a{r.h1.E, r.B, r.rb, r.n_dst, r.s, r.out, table ? 1 : 0, true, stream};
  dim3 grid;
  size_t smem = 0;
  err = rows_grid<fragment_spmm_fused1_kernel<OP>>(a, &grid, &smem);
  if (err) return err;
  fragment_spmm_fused1_kernel<OP><<<grid, kThreads, smem, stream>>>(r, table);
  err = (int)cudaGetLastError();
  return err ? err : rows_epilogue(a);
}

int fused1(const Region& r, int op, int table, cudaStream_t s) {
  switch (op) {
    case kSum: return launch1<kSum>(r, table, s);
    case kMin: return launch1<kMin>(r, table, s);
    case kMax: return launch1<kMax>(r, table, s);
    case kBool: return launch1<kBool>(r, table, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool ROWS>
int fused2(const Region& r, int op, int table1, int table2, cudaStream_t s) {
  switch (op) {
    case kSum: return launch2<kSum, ROWS>(r, table1, table2, s);
    case kMin: return launch2<kMin, ROWS>(r, table1, table2, s);
    case kMax: return launch2<kMax, ROWS>(r, table1, table2, s);
    case kBool: return launch2<kBool, ROWS>(r, table1, table2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool ROWS>
int max_grid(int op, int rb, int table) {
  int grid = 0, err = 0;
  switch (op) {
    case kSum: err = coresident_grid<kSum, ROWS>(rb, table, &grid); break;
    case kMin: err = coresident_grid<kMin, ROWS>(rb, table, &grid); break;
    case kMax: err = coresident_grid<kMax, ROWS>(rb, table, &grid); break;
    case kBool: err = coresident_grid<kBool, ROWS>(rb, table, &grid); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err != 0 ? -err : grid;
}

// rb rows a chunk is valid for B rows: 1 for one row, else 2, 4 or 8.
bool rows_ok(int B, int rb) {
  return (rb == 1 && B == 1) || ((rb == 2 || rb == 4 || rb == 8) && B > 1);
}

Region region(const float* w, int n_src, int B, int rb, const HopArgs* hop1,
              const HopArgs* hop2, const unsigned char* keep, int mid_binarize, float* u,
              int n_mid, float* s, float* out, int n_dst, const int32_t* bi1, int cap1,
              const int32_t* na1, const int32_t* bi2, int cap2, const int32_t* na2,
              int* next) {
  Region r;
  r.w = w;
  r.n_src = n_src;
  r.B = B;
  r.rb = rb;
  r.h1 = make_hop(*hop1);
  r.h2 = hop2 != nullptr ? make_hop(*hop2) : r.h1;
  r.keep = keep;
  r.mid_binarize = mid_binarize;
  r.u = u;
  r.n_mid = n_mid;
  r.s = s;
  r.out = out;
  r.n_dst = n_dst;
  r.bi1 = bi1;
  r.cap1 = cap1;
  r.na1 = na1;
  r.bi2 = bi2;
  r.cap2 = cap2;
  r.na2 = na2;
  r.next = next;
  return r;
}

}  // namespace

// The degenerate region on `stream`: out[d] ⊕= w[src] ⊗ m over the blocks
// bi1[0..n_active1), with no write where keep[d] == 0 (keep: one byte an
// entry; nullptr: no mask). `out` must already hold the ⊕-identity. One
// wave of CTAs over the list; table != 0 aggregates per CTA in hop.cuh's
// table. Returns cudaGetLastError() after the launch. E must be > 0.
extern "C" int fragment_spmv_fused1_launch(const float* w, int n_src, const HopArgs* hop1,
                                           const unsigned char* keep, float* out, int n_dst, int op,
                                           const int32_t* bi1, int cap1, const int32_t* na1,
                                           int table, void* stream) {
  const Region r = region(w, n_src, 1, 1, hop1, nullptr, keep, 0, nullptr, 0, out, out, n_dst,
                          bi1, cap1, na1, nullptr, 0, nullptr, nullptr);
  return fused1(r, op, table, reinterpret_cast<cudaStream_t>(stream));
}

// The two-hop region on `stream`, one cooperative launch: fills u[n_mid] and
// out[n_dst] with the ⊕-identity itself, then hop1 over bi1[0..n_active1)
// into u, then hop2 over bi2[0..n_active2) from u — masked by keep (a byte
// an entry; null: no mask), binarized when mid_binarize — into out. table1 / table2 != 0: that
// hop phase aggregates per CTA in hop.cuh's table. `next` is 2 ints of
// scratch (the phases' block counters, zeroed by the kernel). Returns the
// launch's error code (a grid that cannot be co-resident is
// cudaErrorCooperativeLaunchTooLarge). E1, E2 must be > 0.
extern "C" int fragment_spmv_fused2_launch(const float* w, int n_src, const HopArgs* hop1,
                                           const HopArgs* hop2, const unsigned char* keep,
                                           int mid_binarize, float* u, int n_mid, float* out,
                                           int n_dst, int op, const int32_t* bi1, int cap1,
                                           const int32_t* na1, const int32_t* bi2, int cap2,
                                           const int32_t* na2, int* next, int table1,
                                           int table2, void* stream) {
  const Region r = region(w, n_src, 1, 1, hop1, hop2, keep, mid_binarize, u, n_mid, out, out,
                          n_dst, bi1, cap1, na1, bi2, cap2, na2, next);
  return fused2<false>(r, op, table1, table2, reinterpret_cast<cudaStream_t>(stream));
}

// The co-resident grid of fused2 for `op` on the current device, with the
// table's shared memory (table != 0) or without (> 0), or minus a CUDA
// error code.
extern "C" int fragment_spmv_fused2_max_grid(int op, int table) {
  return max_grid<false>(op, 1, table);
}

// The batched degenerate region (the SpMM form of fused1): w is float32[B,
// n_src] row-major; the mask keep[n_dst] is shared by the rows. s is the
// scratch float32[ceil(B / rb), n_dst, rb] holding the ⊕-identity and y
// float32[B, n_dst], written whole by the epilogue; at rb = 1 (B = 1) s is
// y and the SpMV form runs. table != 0 aggregates per CTA in hop.cuh's table
// of row chunks.
extern "C" int fragment_spmm_fused1_launch(const float* w, int n_src, int B,
                                           const HopArgs* hop1, const unsigned char* keep,
                                           float* y, int n_dst, int op, const int32_t* bi1, int cap1,
                                           const int32_t* na1, float* s, int rb, int table,
                                           void* stream) {
  if (!rows_ok(B, rb)) return (int)cudaErrorInvalidValue;
  const Region r = region(w, n_src, B, rb, hop1, nullptr, keep, 0, nullptr, 0, s, y, n_dst,
                          bi1, cap1, na1, nullptr, 0, nullptr, nullptr);
  return fused1(r, op, table, reinterpret_cast<cudaStream_t>(stream));
}

// The batched two-hop region (the SpMM form of fused2), one cooperative
// launch: w float32[B, n_src]; the scratches u float32[ceil(B / rb), n_mid,
// rb] and s float32[ceil(B / rb), n_dst, rb], filled by the kernel; y
// float32[B, n_dst], written by its last phase; keep[n_mid] is shared by the
// rows; `next` 2·ceil(B / rb) ints. At rb = 1 (B = 1) u is float32[n_mid], s
// is unused and the SpMV form runs into y. As fragment_spmv_fused2_launch
// otherwise.
extern "C" int fragment_spmm_fused2_launch(const float* w, int n_src, int B,
                                           const HopArgs* hop1, const HopArgs* hop2,
                                           const unsigned char* keep, int mid_binarize, float* u,
                                           int n_mid, float* y, int n_dst, int op,
                                           const int32_t* bi1, int cap1, const int32_t* na1,
                                           const int32_t* bi2, int cap2, const int32_t* na2,
                                           int* next, float* s, int rb, int table1, int table2,
                                           void* stream) {
  if (!rows_ok(B, rb)) return (int)cudaErrorInvalidValue;
  const Region r = region(w, n_src, B, rb, hop1, hop2, keep, mid_binarize, u, n_mid,
                          rb == 1 ? y : s, y, n_dst, bi1, cap1, na1, bi2, cap2, na2, next);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return rb == 1 ? fused2<false>(r, op, table1, table2, st)
                 : fused2<true>(r, op, table1, table2, st);
}

// The co-resident grid of the batched fused2 at rb rows a chunk for `op`,
// with the table (table != 0) or without (> 0), or minus a CUDA error code.
extern "C" int fragment_spmm_fused2_max_grid(int op, int rb, int table) {
  if (rb != 1 && rb != 2 && rb != 4 && rb != 8) return -(int)cudaErrorInvalidValue;
  return rb == 1 ? max_grid<false>(op, 1, table) : max_grid<true>(op, rb, table);
}
