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
struct MidGather {
  const float* u;
  const float* __restrict__ keep;
  int n_mid;
  int binarize;
  __device__ __forceinline__ float operator()(int s) const {
    const float zero = identity<OP>();
    float v = zero;
    if (s >= 0 && s < n_mid && (keep == nullptr || __ldg(keep + s) > 0.0f)) {
      v = __ldcg(u + s);
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
};

struct KeepMask {  // keep == nullptr: no mask
  const float* __restrict__ keep;
  __device__ __forceinline__ bool operator()(int d) const {
    return keep == nullptr || __ldg(keep + d) > 0.0f;
  }
};

// One listed block, streamed by the CTA's threads.
template <int OP, class W, class Keep>
__device__ __forceinline__ void one_block(const W& weight, const Hop& h, int64_t b,
                                          float* __restrict__ y, int n_dst,
                                          const Keep& keep) {
  if (b < 0) return;
  const int64_t e0 = b * kEdgeBlock;
  const int64_t e1 = e0 + kEdgeBlock < h.E ? e0 + kEdgeBlock : h.E;
  for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    edge_with<OP>(weight, h.src, e, h.dst, h.m, y, n_dst, keep);
  }
}

__device__ __forceinline__ int listed(const int32_t* __restrict__ n_active, int cap) {
  const int na = __ldg(n_active);
  return na < cap ? na : cap;
}

// The listed blocks bi[0..n_active), each taken by the next CTA to ask the
// counter `next` (zero before the phase).
template <int OP, class W, class Keep>
__device__ __forceinline__ void queued_blocks(const W& weight, const Hop& h,
                                              float* __restrict__ y, int n_dst,
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
    one_block<OP>(weight, h, __ldg(bi + t), y, n_dst, keep);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
    fragment_spmv_fused1_kernel(const float* __restrict__ w, int n_src, Hop h1,
                                const float* __restrict__ keep, float* __restrict__ out,
                                int n_dst, const int32_t* __restrict__ bi1, int cap1,
                                const int32_t* __restrict__ na1) {
  if ((int)blockIdx.x < listed(na1, cap1)) {
    one_block<OP>(Frontier<OP>{w, n_src}, h1, __ldg(bi1 + blockIdx.x), out, n_dst,
                  KeepMask{keep});
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
    fragment_spmv_fused2_kernel(const float* __restrict__ w, int n_src, Hop h1, Hop h2,
                                const float* __restrict__ keep, int mid_binarize, float* u,
                                int n_mid, float* __restrict__ out, int n_dst,
                                const int32_t* __restrict__ bi1, int cap1,
                                const int32_t* __restrict__ na1,
                                const int32_t* __restrict__ bi2, int cap2,
                                const int32_t* __restrict__ na2, int* next) {
  cg::grid_group grid = cg::this_grid();
  const float zero = identity<OP>();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < n_mid; i += nthreads) u[i] = zero;
  for (int64_t i = tid; i < n_dst; i += nthreads) out[i] = zero;
  if (tid < 2) next[tid] = 0;  // the two phases' block counters
  grid.sync();
  queued_blocks<OP>(Frontier<OP>{w, n_src}, h1, u, n_mid, KeepAll{}, bi1, cap1, na1, next);
  grid.sync();  // every hop1 edge has landed in u
  queued_blocks<OP>(MidGather<OP>{u, keep, n_mid, mid_binarize}, h2, out, n_dst, KeepAll{},
                    bi2, cap2, na2, next + 1);
}

// CTAs of fused2 that can be resident at once on the current device.
template <int OP>
int coresident_grid(int* grid) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fragment_spmv_fused2_kernel<OP>, kThreads, 0);
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

template <int OP>
int launch2(const float* w, int n_src, const Hop& h1, const Hop& h2, const float* keep,
            int mid_binarize, float* u, int n_mid, float* out, int n_dst,
            const int32_t* bi1, int cap1, const int32_t* na1, const int32_t* bi2, int cap2,
            const int32_t* na2, int* next, cudaStream_t s) {
  int max_grid = 0;
  int err = coresident_grid<OP>(&max_grid);
  if (err != 0) return err;
  if (max_grid <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no more CTAs than the larger block list or the fill needs (8 values a
  // thread), and no more than can be co-resident
  const int64_t fill = ((int64_t)(n_mid > n_dst ? n_mid : n_dst) + kThreads * 8 - 1) /
                       (kThreads * 8);
  int64_t want = cap1 > cap2 ? cap1 : cap2;
  if (fill > want) want = fill;
  if (want < 1) want = 1;
  const int grid = (int)(want < max_grid ? want : max_grid);
  Hop a1 = h1, a2 = h2;
  void* args[] = {(void*)&w,   (void*)&n_src, (void*)&a1,  (void*)&a2,   (void*)&keep,
                  (void*)&mid_binarize, (void*)&u, (void*)&n_mid, (void*)&out, (void*)&n_dst,
                  (void*)&bi1, (void*)&cap1, (void*)&na1, (void*)&bi2, (void*)&cap2,
                  (void*)&na2, (void*)&next};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)fragment_spmv_fused2_kernel<OP>,
                                              dim3(grid), dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; the wrapper raises
    return (int)e;
  }
  return (int)cudaGetLastError();
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
  const Hop h1 = make_hop(*hop1);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      fragment_spmv_fused1_kernel<kSum><<<cap1, kThreads, 0, s>>>(w, n_src, h1, keep, out, n_dst,
                                                                  bi1, cap1, na1);
      break;
    case kMin:
      fragment_spmv_fused1_kernel<kMin><<<cap1, kThreads, 0, s>>>(w, n_src, h1, keep, out, n_dst,
                                                                  bi1, cap1, na1);
      break;
    case kMax:
      fragment_spmv_fused1_kernel<kMax><<<cap1, kThreads, 0, s>>>(w, n_src, h1, keep, out, n_dst,
                                                                  bi1, cap1, na1);
      break;
    case kBool:
      fragment_spmv_fused1_kernel<kBool><<<cap1, kThreads, 0, s>>>(w, n_src, h1, keep, out,
                                                                   n_dst, bi1, cap1, na1);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  const Hop h1 = make_hop(*hop1), h2 = make_hop(*hop2);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      return launch2<kSum>(w, n_src, h1, h2, keep, mid_binarize, u, n_mid, out, n_dst, bi1, cap1,
                           na1, bi2, cap2, na2, next, s);
    case kMin:
      return launch2<kMin>(w, n_src, h1, h2, keep, mid_binarize, u, n_mid, out, n_dst, bi1, cap1,
                           na1, bi2, cap2, na2, next, s);
    case kMax:
      return launch2<kMax>(w, n_src, h1, h2, keep, mid_binarize, u, n_mid, out, n_dst, bi1, cap1,
                           na1, bi2, cap2, na2, next, s);
    case kBool:
      return launch2<kBool>(w, n_src, h1, h2, keep, mid_binarize, u, n_mid, out, n_dst, bi1,
                            cap1, na1, bi2, cap2, na2, next, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The co-resident grid of fused2 for `op` on the current device (> 0), or
// minus a CUDA error code.
extern "C" int fragment_spmv_fused2_max_grid(int op) {
  int grid = 0, err = 0;
  switch (op) {
    case kSum: err = coresident_grid<kSum>(&grid); break;
    case kMin: err = coresident_grid<kMin>(&grid); break;
    case kMax: err = coresident_grid<kMax>(&grid); break;
    case kBool: err = coresident_grid<kBool>(&grid); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err != 0 ? -err : grid;
}
