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
// the main path's sizes. What the design does about the TPU's resident u:
//   * Hopper has no grid-wide on-chip buffer, and hop2 may read u[src] only
//     after every hop1 edge has landed. fused2 is one cooperative, persistent
//     launch (cudaLaunchCooperativeKernel, grid = the co-resident CTAs at most)
//     with three phases separated by grid.sync(): fill u and out with the
//     identity; hop1 over bi1[0..n_active1) into u; hop2 over bi2[0..n_active2)
//     into out. In each hop phase the CTAs take listed blocks from a global
//     counter (one atomicAdd a block), so a CTA that drew blocks whose atomics
//     contend (Zipf-hot dst ids) does not hold the phase back while others sit
//     idle, as a fixed grid stride would. A grid that cannot be co-resident is
//     refused by the launch and the wrapper raises; there is no
//     non-cooperative fallback.
//   * The mid mask and hop2's binarize are applied at hop2's gather, in
//     registers: where(keep > 0, u, 0̄) then binarize, per edge. hop2's src
//     ids are sorted, so its keep reads are coalesced; a mask at hop1's
//     scatter instead reads keep at hop1's random dst ids, which on the H100
//     cost more than the atomics it saves (AS-recent's region: hop1 phase
//     0.394 against 0.332 ms without the reads; PERF.md). u is read through
//     L2 (ld.global.cg): it was written in this launch, so the read-only path
//     may not hold it.
//   * fused1 needs no barrier and no scratch: one CTA per slot of the block
//     list (the hardware balances them), the output mask at the scatter — an
//     edge whose dst has keep ≤ 0 issues no write, so out keeps the identity
//     there (out is filled with the identity by the wrapper).
//   * The lists and their counts stay on the card: n_active is read here, so
//     the host never waits for them (hop2's list is derived from hop1's by the
//     fuse-time reach matrix, on the card, before the launch).
//   * The per-edge body (identity guard, ∞·0 guard, float min/max atomics) is
//     hop.cuh's edge_with and the decode bca.cuh's, so fused and unfused hops
//     cannot drift apart. The operand modes are chosen at run time (a uniform
//     branch) rather than by template, which keeps to 4 instantiations a kernel.
//
// The batched form (the SpMM form, the reference's fragment_spmm_fused: the
// same two pallas_call sites with batched=True) runs B frontier rows through
// one region: w[B, n_src], u[B, n_mid], out[B, n_dst], row-major, with the
// mask shared by the rows. Each listed edge is read and decoded once and
// applied to every row (hop.cuh's edge_rows), so the streams are read once a
// batch; the row offsets are int64. fused2's scratch is 4·B·n_mid bytes: at
// B = 8 it leaves the 50 MB L2 beyond n_mid ≈ 1.6M, which is one reason
// fusion="auto" budgets 4·n_mid·B (kernels/ops.py) and does not pick it there.
// This file allocates nothing and does not synchronise.

#include <cooperative_groups.h>

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

// hop2's gather from the scratch frontier: the mid mask (keep == nullptr: no
// mask), then the semijoin's binarize (Semiring.binarize: sum → u > 0; the
// others → u ≠ 0̄ ? 1 : 0̄). A src past n_mid reads the identity, which both
// leave the identity.
template <int OP>
__device__ __forceinline__ float mid_value(const float* u, const float* __restrict__ keep,
                                           int n_mid, int binarize, int s, int64_t row) {
  const float zero = identity<OP>();
  float v = zero;
  if (s >= 0 && s < n_mid && (keep == nullptr || __ldg(keep + s) > 0.0f)) {
    v = __ldcg(u + row + s);
  }
  if (binarize) {
    if (OP == kSum) {
      v = v > 0.0f ? 1.0f : 0.0f;
    } else {
      v = v != zero ? 1.0f : zero;
    }
  }
  return v;
}

template <int OP>
struct MidGather {  // u[n_mid]
  const float* u;
  const float* __restrict__ keep;
  int n_mid;
  int binarize;
  __device__ __forceinline__ float operator()(int s) const {
    return mid_value<OP>(u, keep, n_mid, binarize, s, 0);
  }
};

template <int OP>
struct MidGatherRows {  // u[B, n_mid]; the mask is shared by the rows
  const float* u;
  const float* __restrict__ keep;
  int n_mid;
  int binarize;
  __device__ __forceinline__ float operator()(int b, int s) const {
    return mid_value<OP>(u, keep, n_mid, binarize, s, (int64_t)b * n_mid);
  }
};

struct KeepMask {  // keep == nullptr: no mask
  const float* __restrict__ keep;
  __device__ __forceinline__ bool operator()(int d) const {
    return keep == nullptr || __ldg(keep + d) > 0.0f;
  }
};

// The per-edge body of a region: one frontier (the SpMV form) or B rows.
struct One {
  template <int OP, class W, class Keep>
  static __device__ __forceinline__ void edge(const W& weight, const Hop& h, int64_t e,
                                              float* __restrict__ y, int n_dst, int,
                                              const Keep& keep) {
    edge_with<OP>(weight, h.src, e, h.dst, h.m, y, n_dst, keep);
  }
};

struct Rows {
  template <int OP, class W, class Keep>
  static __device__ __forceinline__ void edge(const W& weight, const Hop& h, int64_t e,
                                              float* __restrict__ y, int n_dst, int B,
                                              const Keep& keep) {
    edge_rows<OP>(weight, h.src, e, h.dst, SharedRows<AnyMeasure>{h.m}, y, n_dst, B, keep);
  }
};

// One listed block, streamed by the CTA's threads.
template <int OP, class Body, class W, class Keep>
__device__ __forceinline__ void one_block(const W& weight, const Hop& h, int64_t b,
                                          float* __restrict__ y, int n_dst, int B,
                                          const Keep& keep) {
  if (b < 0) return;
  const int64_t e0 = b * kEdgeBlock;
  const int64_t e1 = e0 + kEdgeBlock < h.E ? e0 + kEdgeBlock : h.E;
  for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    Body::template edge<OP>(weight, h, e, y, n_dst, B, keep);
  }
}

__device__ __forceinline__ int listed(const int32_t* __restrict__ n_active, int cap) {
  const int na = __ldg(n_active);
  return na < cap ? na : cap;
}

// The listed blocks bi[0..n_active), each taken by the next CTA to ask the
// counter `next` (zero before the phase).
template <int OP, class Body, class W, class Keep>
__device__ __forceinline__ void queued_blocks(const W& weight, const Hop& h,
                                              float* __restrict__ y, int n_dst, int B,
                                              const Keep& keep,
                                              const int32_t* __restrict__ bi, int cap,
                                              const int32_t* __restrict__ n_active,
                                              int* next) {
  __shared__ int slot;
  const int na = listed(n_active, cap);
  for (;;) {
    if (threadIdx.x == 0) slot = atomicAdd(next, 1);
    __syncthreads();
    const int t = slot;
    __syncthreads();  // every thread has read slot before it is drawn again
    if (t >= na) return;
    one_block<OP, Body>(weight, h, __ldg(bi + t), y, n_dst, B, keep);
  }
}

// A region's launch arguments (B = 1 for the SpMV form).
struct Region {
  const float* w;
  int n_src;
  int B;
  Hop h1, h2;
  const float* keep;
  int mid_binarize;
  float* u;
  int n_mid;
  float* out;
  int n_dst;
  const int32_t* bi1;
  int cap1;
  const int32_t* na1;
  const int32_t* bi2;
  int cap2;
  const int32_t* na2;
  int* next;
};

template <int OP>
__global__ void __launch_bounds__(kThreads) fragment_spmv_fused1_kernel(Region r) {
  if ((int)blockIdx.x < listed(r.na1, r.cap1)) {
    one_block<OP, One>(Frontier<OP>{r.w, r.n_src}, r.h1, __ldg(r.bi1 + blockIdx.x), r.out,
                       r.n_dst, 1, KeepMask{r.keep});
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads) fragment_spmm_fused1_kernel(Region r) {
  if ((int)blockIdx.x < listed(r.na1, r.cap1)) {
    one_block<OP, Rows>(FrontierRows<OP>{r.w, r.n_src}, r.h1, __ldg(r.bi1 + blockIdx.x), r.out,
                        r.n_dst, r.B, KeepMask{r.keep});
  }
}

// fused2's three phases: fill u[B·n_mid] and out[B·n_dst] with the identity,
// hop1 into u, grid.sync(), hop2 from u (through `mid`) into out.
template <int OP, class Body, class W, class Mid>
__device__ __forceinline__ void fused2_phases(const Region& r, const W& w, const Mid& mid) {
  cg::grid_group grid = cg::this_grid();
  const float zero = identity<OP>();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t nu = (int64_t)r.B * r.n_mid, no = (int64_t)r.B * r.n_dst;
  for (int64_t i = tid; i < nu; i += nthreads) r.u[i] = zero;
  for (int64_t i = tid; i < no; i += nthreads) r.out[i] = zero;
  if (tid < 2) r.next[tid] = 0;  // the two phases' block counters
  grid.sync();
  queued_blocks<OP, Body>(w, r.h1, r.u, r.n_mid, r.B, KeepAll{}, r.bi1, r.cap1, r.na1, r.next);
  grid.sync();  // every hop1 edge has landed in u
  queued_blocks<OP, Body>(mid, r.h2, r.out, r.n_dst, r.B, KeepAll{}, r.bi2, r.cap2, r.na2,
                          r.next + 1);
}

template <int OP>
__global__ void __launch_bounds__(kThreads) fragment_spmv_fused2_kernel(Region r) {
  fused2_phases<OP, One>(r, Frontier<OP>{r.w, r.n_src},
                         MidGather<OP>{r.u, r.keep, r.n_mid, r.mid_binarize});
}

template <int OP>
__global__ void __launch_bounds__(kThreads) fragment_spmm_fused2_kernel(Region r) {
  fused2_phases<OP, Rows>(r, FrontierRows<OP>{r.w, r.n_src},
                          MidGatherRows<OP>{r.u, r.keep, r.n_mid, r.mid_binarize});
}

template <int OP, bool ROWS>
const void* fused2_fn() {
  return ROWS ? (const void*)fragment_spmm_fused2_kernel<OP>
              : (const void*)fragment_spmv_fused2_kernel<OP>;
}

// CTAs of fused2 (ROWS: its batched form) that can be resident at once on the
// current device.
template <int OP, bool ROWS>
int coresident_grid(int* grid) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused2_fn<OP, ROWS>(),
                                                          kThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    cached = per_sm * sms;
  }
  *grid = cached;
  return 0;
}

template <int OP, bool ROWS>
int launch2(Region r, cudaStream_t s) {
  int max_grid = 0;
  int err = coresident_grid<OP, ROWS>(&max_grid);
  if (err != 0) return err;
  if (max_grid <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no more CTAs than the larger block list or the fill needs (8 values a
  // thread), and no more than can be co-resident
  const int64_t cells = (int64_t)r.B * (r.n_mid > r.n_dst ? r.n_mid : r.n_dst);
  const int64_t fill = (cells + kThreads * 8 - 1) / (kThreads * 8);
  int64_t want = r.cap1 > r.cap2 ? r.cap1 : r.cap2;
  if (fill > want) want = fill;
  if (want < 1) want = 1;
  const int grid = (int)(want < max_grid ? want : max_grid);
  void* args[] = {(void*)&r};
  cudaError_t e = cudaLaunchCooperativeKernel(fused2_fn<OP, ROWS>(), dim3(grid), dim3(kThreads),
                                              args, 0, s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; the wrapper raises
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <bool ROWS>
int fused1(const Region& r, int op, cudaStream_t s) {
  switch (op) {
#define FUSED1_CASE(OPV)                                                                  \
  case OPV:                                                                               \
    if (ROWS) {                                                                           \
      fragment_spmm_fused1_kernel<OPV><<<r.cap1, kThreads, 0, s>>>(r);                    \
    } else {                                                                              \
      fragment_spmv_fused1_kernel<OPV><<<r.cap1, kThreads, 0, s>>>(r);                    \
    }                                                                                     \
    break;
    FUSED1_CASE(kSum)
    FUSED1_CASE(kMin)
    FUSED1_CASE(kMax)
    FUSED1_CASE(kBool)
#undef FUSED1_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool ROWS>
int fused2(const Region& r, int op, cudaStream_t s) {
  switch (op) {
    case kSum: return launch2<kSum, ROWS>(r, s);
    case kMin: return launch2<kMin, ROWS>(r, s);
    case kMax: return launch2<kMax, ROWS>(r, s);
    case kBool: return launch2<kBool, ROWS>(r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool ROWS>
int max_grid(int op) {
  int grid = 0, err = 0;
  switch (op) {
    case kSum: err = coresident_grid<kSum, ROWS>(&grid); break;
    case kMin: err = coresident_grid<kMin, ROWS>(&grid); break;
    case kMax: err = coresident_grid<kMax, ROWS>(&grid); break;
    case kBool: err = coresident_grid<kBool, ROWS>(&grid); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err != 0 ? -err : grid;
}

Region region(const float* w, int n_src, int B, const HopArgs* hop1, const HopArgs* hop2,
              const float* keep, int mid_binarize, float* u, int n_mid, float* out, int n_dst,
              const int32_t* bi1, int cap1, const int32_t* na1, const int32_t* bi2, int cap2,
              const int32_t* na2, int* next) {
  Region r;
  r.w = w;
  r.n_src = n_src;
  r.B = B;
  r.h1 = make_hop(*hop1);
  r.h2 = hop2 != nullptr ? make_hop(*hop2) : r.h1;
  r.keep = keep;
  r.mid_binarize = mid_binarize;
  r.u = u;
  r.n_mid = n_mid;
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
// bi1[0..n_active1), with no write where keep[d] ≤ 0 (keep == nullptr: no
// mask). `out` must already hold the ⊕-identity. Grid: one CTA per list slot
// (cap1). Returns cudaGetLastError() after the launch. E must be > 0.
extern "C" int fragment_spmv_fused1_launch(const float* w, int n_src, const HopArgs* hop1,
                                           const float* keep, float* out, int n_dst, int op,
                                           const int32_t* bi1, int cap1, const int32_t* na1,
                                           void* stream) {
  const Region r = region(w, n_src, 1, hop1, nullptr, keep, 0, nullptr, 0, out, n_dst, bi1,
                          cap1, na1, nullptr, 0, nullptr, nullptr);
  return fused1<false>(r, op, reinterpret_cast<cudaStream_t>(stream));
}

// The two-hop region on `stream`, one cooperative launch: fills u[n_mid] and
// out[n_dst] with the ⊕-identity itself, then hop1 over bi1[0..n_active1)
// into u, then hop2 over bi2[0..n_active2) from u — masked by keep (null: no
// mask), binarized when mid_binarize — into out. `next` is 2 ints of scratch (the
// phases' block counters, zeroed by the kernel). Returns the launch's error
// code (a grid that cannot be co-resident is
// cudaErrorCooperativeLaunchTooLarge). E1, E2 must be > 0.
extern "C" int fragment_spmv_fused2_launch(const float* w, int n_src, const HopArgs* hop1,
                                           const HopArgs* hop2, const float* keep,
                                           int mid_binarize, float* u, int n_mid, float* out,
                                           int n_dst, int op, const int32_t* bi1, int cap1,
                                           const int32_t* na1, const int32_t* bi2, int cap2,
                                           const int32_t* na2, int* next, void* stream) {
  const Region r = region(w, n_src, 1, hop1, hop2, keep, mid_binarize, u, n_mid, out, n_dst,
                          bi1, cap1, na1, bi2, cap2, na2, next);
  return fused2<false>(r, op, reinterpret_cast<cudaStream_t>(stream));
}

// The co-resident grid of fused2 for `op` on the current device (> 0), or
// minus a CUDA error code.
extern "C" int fragment_spmv_fused2_max_grid(int op) { return max_grid<false>(op); }

// The batched degenerate region (the SpMM form of fused1): w is float32[B,
// n_src] and out float32[B, n_dst] (holding the ⊕-identity), row-major; the
// mask keep[n_dst] is shared by the rows. Each listed edge is read and
// decoded once for all B rows.
extern "C" int fragment_spmm_fused1_launch(const float* w, int n_src, int B,
                                           const HopArgs* hop1, const float* keep, float* out,
                                           int n_dst, int op, const int32_t* bi1, int cap1,
                                           const int32_t* na1, void* stream) {
  const Region r = region(w, n_src, B, hop1, nullptr, keep, 0, nullptr, 0, out, n_dst, bi1,
                          cap1, na1, nullptr, 0, nullptr, nullptr);
  return fused1<true>(r, op, reinterpret_cast<cudaStream_t>(stream));
}

// The batched two-hop region (the SpMM form of fused2), one cooperative
// launch: w float32[B, n_src], scratch u float32[B, n_mid], out float32[B,
// n_dst], all row-major and filled by the kernel; keep[n_mid] is shared by
// the rows. As fragment_spmv_fused2_launch otherwise.
extern "C" int fragment_spmm_fused2_launch(const float* w, int n_src, int B,
                                           const HopArgs* hop1, const HopArgs* hop2,
                                           const float* keep, int mid_binarize, float* u,
                                           int n_mid, float* out, int n_dst, int op,
                                           const int32_t* bi1, int cap1, const int32_t* na1,
                                           const int32_t* bi2, int cap2, const int32_t* na2,
                                           int* next, void* stream) {
  const Region r = region(w, n_src, B, hop1, hop2, keep, mid_binarize, u, n_mid, out, n_dst,
                          bi1, cap1, na1, bi2, cap2, na2, next);
  return fused2<true>(r, op, reinterpret_cast<cudaStream_t>(stream));
}

// The co-resident grid of the batched fused2 for `op` (> 0), or minus a CUDA
// error code.
extern "C" int fragment_spmm_fused2_max_grid(int op) { return max_grid<true>(op); }
