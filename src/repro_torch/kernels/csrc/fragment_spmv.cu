// fragment_spmv: one relationship hop of the frontier strategy on Hopper,
// over dense (int32 dst, float32 measure) columns, and its block-skipping
// variant fragment_spmv_active.
//
//   y[dst[e]] ⊕= w[src[e]] ⊗ m[e]   for every edge e,  ⊕ ∈ {sum, min, max, bool}
//
// Replaces the TPU kernels repro/kernels/fragment_spmv.py::fragment_spmv
// (_kernel, _edge_product, _segment_combine) and ::fragment_spmv_active
// (_kernel_active). There the frontier w and the accumulator y sit in VMEM
// for the whole pass and a sequential grid streams 4096-edge blocks through
// one core; the active variant's grid walks a block list held in SMEM by
// scalar prefetch. Hopper's blocks run in parallel and in no order, and a
// multi-megabyte y does not fit any on-chip store, so y lives in global
// memory (L2-resident while it fits in 50 MB) and is updated with atomics.
//
// What bounds it: bytes. Each edge costs 12 bytes of stream (src, dst, m)
// plus a 4-byte gather of w[src] and one atomic on y[dst]; there is no
// arithmetic to speak of. The design (the per-edge body is hop.cuh's):
//   * scan: one thread per edge in a grid-stride loop, so the src/dst/m
//     loads of a warp are coalesced, and since edges are sorted by src the
//     w[src] gather is near-sequential (through the read-only path);
//   * active: one CTA per 4096-edge block named in the device-resident list;
//     CTAs past n_active return at once, so a sparse frontier streams only
//     the blocks its support reaches. The list and n_active never visit the
//     host, so a hop costs no device sync (the TPU kernel's lax.cond on
//     n_active becomes the in-kernel choice of hop.cuh's `active`);
//   * an edge whose product is the ⊕-identity issues no atomic, and for
//     min/max/bool it does not even load dst and m;
//   * measure-free hops pass m == nullptr and read measure 1, so no ones(E)
//     vector is allocated or streamed. Scalar and broadcast measures are
//     materialised (.contiguous()) by the executor before the launch.
// This file allocates nothing and does not synchronise.

#include "hop.cuh"

namespace {

using namespace hop;

template <int OP, class M>
__global__ void fragment_spmv_kernel(const float* __restrict__ w, int n_src,
                                     const int32_t* __restrict__ src, DenseDst dst, M m,
                                     int64_t E, float* __restrict__ y, int n_dst) {
  scan<OP, DenseDst, M>(w, n_src, src, dst, m, E, y, n_dst);
}

template <int OP, class M>
__global__ void fragment_spmv_active_kernel(const float* __restrict__ w, int n_src,
                                            const int32_t* __restrict__ src, DenseDst dst,
                                            M m, int64_t E, float* __restrict__ y, int n_dst,
                                            const int32_t* __restrict__ block_idx, int n_cap,
                                            const int32_t* __restrict__ n_active,
                                            int scan_above) {
  active<OP, DenseDst, M>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above);
}

template <int OP, class M>
void launch(const float* w, int n_src, const int32_t* src, DenseDst dst, M m, int64_t E,
            float* y, int n_dst, const int32_t* block_idx, int n_cap,
            const int32_t* n_active, int scan_above, cudaStream_t s) {
  if (block_idx == nullptr) {
    fragment_spmv_kernel<OP, M><<<scan_grid(E), kThreads, 0, s>>>(w, n_src, src, dst, m, E, y,
                                                               n_dst);
  } else {
    fragment_spmv_active_kernel<OP, M><<<(int)n_edge_blocks(E), kThreads, 0, s>>>(
        w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above);
  }
}

template <class M>
int by_op(int op, const float* w, int n_src, const int32_t* src, DenseDst dst, M m,
          int64_t E, float* y, int n_dst, const int32_t* block_idx, int n_cap,
          const int32_t* n_active, int scan_above, cudaStream_t s) {
  switch (op) {
    case kSum: launch<kSum>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above, s); break;
    case kMin: launch<kMin>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above, s); break;
    case kMax: launch<kMax>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above, s); break;
    case kBool: launch<kBool>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dispatch(const float* w, int n_src, const int32_t* src, const int32_t* dst,
             const float* m, int64_t E, float* y, int n_dst, int op,
             const int32_t* block_idx, int n_cap, const int32_t* n_active, int scan_above,
             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (m != nullptr) {
    return by_op(op, w, n_src, src, DenseDst{dst}, DenseMeasure{m}, E, y, n_dst, block_idx,
                 n_cap, n_active, scan_above, s);
  }
  return by_op(op, w, n_src, src, DenseDst{dst}, NoMeasure{}, E, y, n_dst, block_idx, n_cap,
               n_active, scan_above, s);
}

}  // namespace

// Launch one hop on `stream`. `y` must already hold the ⊕-identity. Returns
// cudaGetLastError() after the launch (0 = success). E must be > 0.
extern "C" int fragment_spmv_launch(const float* w, int n_src, const int32_t* src,
                                    const int32_t* dst, const float* m, int64_t E,
                                    float* y, int n_dst, int op, void* stream) {
  return dispatch(w, n_src, src, dst, m, E, y, n_dst, op, nullptr, 0, nullptr, 0, stream);
}

// The block-skipping hop: a grid of ceil(E / 4096) CTAs over the device
// list block_idx[n_cap] and count n_active[1]; scan order when
// n_active > scan_above. E must be > 0.
extern "C" int fragment_spmv_active_launch(const float* w, int n_src, const int32_t* src,
                                           const int32_t* dst, const float* m, int64_t E,
                                           float* y, int n_dst, int op,
                                           const int32_t* block_idx, int n_cap,
                                           const int32_t* n_active, int scan_above,
                                           void* stream) {
  return dispatch(w, n_src, src, dst, m, E, y, n_dst, op, block_idx, n_cap, n_active,
                  scan_above, stream);
}
