// fragment_spmv: one relationship hop of the frontier strategy on Hopper.
//
//   y[dst[e]] ⊕= w[src[e]] ⊗ m[e]   for every edge e,  ⊕ ∈ {sum, min, max, bool}
//
// Replaces the TPU kernel repro/kernels/fragment_spmv.py::fragment_spmv
// (_kernel, _edge_product, _segment_combine). There the frontier w and the
// accumulator y sit in VMEM for the whole pass and a sequential grid streams
// 4096-edge blocks through one core. Hopper's blocks run in parallel and in
// no order, and a multi-megabyte y does not fit any on-chip store, so y lives
// in global memory (L2-resident while it fits in 50 MB) and is updated with
// atomics.
//
// What bounds it: bytes. Each edge costs 12 bytes of stream (src, dst, m)
// plus a 4-byte gather of w[src] and one atomic on y[dst]; there is no
// arithmetic to speak of. The design:
//   * one thread per edge in a grid-stride loop, so the src/dst/m loads of a
//     warp are coalesced, and since edges are sorted by src the w[src] gather
//     is near-sequential (through the read-only path);
//   * an edge whose product is the ⊕-identity issues no atomic, and for
//     min/max/bool it does not even load dst and m: a sparse frontier costs
//     little more than the src stream;
//   * measure-free hops pass m == nullptr and read measure 1, so no ones(E)
//     vector is allocated or streamed. Scalar and broadcast measures are
//     materialised (.contiguous()) by the executor before the launch.
// The accumulator is filled with the ⊕-identity on the stream by the wrapper
// before the launch; this file allocates nothing and does not synchronise.
//
// Float min/max atomics use the integer ordering of IEEE-754 floats: for
// max, a value with its sign bit clear orders like a signed int
// (atomicMax on int), one with the sign bit set orders in reverse as an
// unsigned int (atomicMin on unsigned); min is the mirror image. The test is
// on the sign bit, not on v >= 0, so -0.0 against a -inf identity is right.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kSum = 0, kMin = 1, kMax = 2, kBool = 3 };

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

template <int OP, bool HAS_M>
__global__ void fragment_spmv_kernel(const float* __restrict__ w, int n_src,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst,
                                     const float* __restrict__ m,
                                     int64_t E, float* __restrict__ y, int n_dst) {
  const float zero = identity<OP>();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E; e += stride) {
    const int s = src[e];
    // out-of-range src reads the identity (the TPU kernel's gather fill)
    const float ws = (s >= 0 && s < n_src) ? __ldg(w + s) : zero;
    if (OP != kSum && ws == zero) continue;  // product is the identity
    const float mv = HAS_M ? m[e] : 1.0f;
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
    const int d = dst[e];
    if (d < 0 || d >= n_dst) continue;
    if (OP == kSum) {
      atomicAdd(y + d, prod);
    } else if (OP == kBool) {
      y[d] = 1.0f;  // every writer stores the same value: the race is benign
    } else if (OP == kMin) {
      atomic_min_float(y + d, prod);
    } else {
      atomic_max_float(y + d, prod);
    }
  }
}

template <int OP>
void launch(const float* w, int n_src, const int32_t* src, const int32_t* dst,
            const float* m, int64_t E, float* y, int n_dst, int grid, cudaStream_t stream) {
  constexpr int kThreads = 256;
  if (m != nullptr) {
    fragment_spmv_kernel<OP, true><<<grid, kThreads, 0, stream>>>(
        w, n_src, src, dst, m, E, y, n_dst);
  } else {
    fragment_spmv_kernel<OP, false><<<grid, kThreads, 0, stream>>>(
        w, n_src, src, dst, m, E, y, n_dst);
  }
}

}  // namespace

// Launch one hop on `stream`. `y` must already hold the ⊕-identity. Returns
// cudaGetLastError() after the launch (0 = success). E must be > 0.
extern "C" int fragment_spmv_launch(const float* w, int n_src, const int32_t* src,
                                    const int32_t* dst, const float* m, int64_t E,
                                    float* y, int n_dst, int op,
                                    void* stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 per SM of an H100
  int64_t blocks = (E + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int grid = (int)blocks;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum: launch<kSum>(w, n_src, src, dst, m, E, y, n_dst, grid, s); break;
    case kMin: launch<kMin>(w, n_src, src, dst, m, E, y, n_dst, grid, s); break;
    case kMax: launch<kMax>(w, n_src, src, dst, m, E, y, n_dst, grid, s); break;
    case kBool: launch<kBool>(w, n_src, src, dst, m, E, y, n_dst, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
