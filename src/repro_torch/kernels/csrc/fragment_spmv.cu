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
// memory (L2-resident while it fits in 50 MB) and takes atomics.
//
// What bounds it: bytes and the scatter. Each edge costs 12 bytes of stream
// (src, dst, m) plus a 4-byte gather of w[src] and one combine into y[dst];
// there is no arithmetic to speak of. Where the atomics land decides the
// rest, so the kernel has two forms, chosen per index by the caller
// (table = 1 on an index whose hottest destination takes at least
// params.HOP_TABLE_HOT_SHARE of its edges, kernels/ops.py uses_table):
//   * table = 1 (a hot destination, I_DA.Doc's Zipf authors): hop.cuh's
//     scan_agg / active_agg. A CTA combines its products per destination in
//     a shared-memory table and issues one global atomic per distinct
//     destination, so a hot author costs an atomic a CTA, not one an edge
//     (which serialise at one L2 address), and the sum adds in fewer float32
//     steps (closer to the float64 sum);
//   * table = 0 (destinations spread, I_DT.Term's 4M documents): one
//     atomic an edge, hop.cuh's scan / active. There the scatter runs at
//     the card's rate of distinct-address float reductions (PERF.md), not
//     at the rate of its bytes.
// Both forms:
//   * scan: the table form one contiguous edge range a CTA of a one-wave
//     grid, the per-edge form one thread per edge in a grid-stride loop, so
//     the src/dst/m loads of a warp are coalesced, and since edges are
//     sorted by src the w[src] gather is near-sequential (read-only path);
//   * active: one wave of CTAs (wave_grid: as many as are co-resident) over
//     the device-resident block list — the per-edge form striding over it,
//     the table form each CTA over a run of consecutive listed blocks into
//     one table, flushed once — so a sparse frontier's one listed block
//     costs one wave of CTAs that find nothing, not a CTA for each of the
//     index's thousands of blocks, and a full list costs the scan's flushes,
//     not one a block. The list and n_active
//     never visit the host, so a hop costs no device sync (the TPU kernel's
//     lax.cond on n_active becomes the in-kernel choice of scan order);
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
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst, M m, int64_t E,
                                     float* __restrict__ y, int n_dst, int table) {
  if (!table) {
    scan<OP, DenseDst, M>(w, n_src, src, DenseDst{dst}, m, E, y, n_dst);
    return;
  }
  extern __shared__ float smem[];
  scan_agg<OP, DenseDst, M>(smem, w, n_src, src, DenseDst{dst}, m, E, y, n_dst);
}

template <int OP, class M>
__global__ void fragment_spmv_active_kernel(const float* __restrict__ w, int n_src,
                                            const int32_t* __restrict__ src,
                                            const int32_t* __restrict__ dst, M m, int64_t E,
                                            float* __restrict__ y, int n_dst,
                                            const int32_t* __restrict__ block_idx, int n_cap,
                                            const int32_t* __restrict__ n_active,
                                            int scan_above, int table) {
  if (!table) {
    active<OP, DenseDst, M>(w, n_src, src, DenseDst{dst}, m, E, y, n_dst, block_idx, n_cap,
                            n_active, scan_above);
    return;
  }
  extern __shared__ float smem[];
  active_agg<OP, DenseDst, M>(smem, w, n_src, src, DenseDst{dst}, m, E, y, n_dst, block_idx,
                              n_cap, n_active, scan_above);
}

struct Launch {
  const float* w;
  int n_src;
  const int32_t* src;
  const int32_t* dst;
  int64_t E;
  float* y;
  int n_dst;
  const int32_t* block_idx;  // nullptr: the scan kernel
  int n_cap;
  const int32_t* n_active;
  int scan_above;
  int table;
  cudaStream_t s;
};

template <int OP, class M>
int launch(const Launch& a, M m) {
  int grid = 0;
  size_t smem = 0;
  if (a.block_idx == nullptr) {
    const int err = row_grid<fragment_spmv_kernel<OP, M>>(a.E, a.table, false, &grid, &smem);
    if (err) return err;
    fragment_spmv_kernel<OP, M><<<grid, kThreads, smem, a.s>>>(a.w, a.n_src, a.src, a.dst, m,
                                                              a.E, a.y, a.n_dst, a.table);
  } else {
    const int err =
        row_grid<fragment_spmv_active_kernel<OP, M>>(a.E, a.table, true, &grid, &smem);
    if (err) return err;
    fragment_spmv_active_kernel<OP, M><<<grid, kThreads, smem, a.s>>>(
        a.w, a.n_src, a.src, a.dst, m, a.E, a.y, a.n_dst, a.block_idx, a.n_cap, a.n_active,
        a.scan_above, a.table);
  }
  return 0;
}

template <class M>
int by_op(int op, const Launch& a, M m) {
  int err;
  switch (op) {
    case kSum: err = launch<kSum>(a, m); break;
    case kMin: err = launch<kMin>(a, m); break;
    case kMax: err = launch<kMax>(a, m); break;
    case kBool: err = launch<kBool>(a, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

int dispatch(const Launch& a, int op, const float* m) {
  if (m != nullptr) return by_op(op, a, DenseMeasure{m});
  return by_op(op, a, NoMeasure{});
}

}  // namespace

// Launch one hop on `stream`. `y` must already hold the ⊕-identity. table != 0
// aggregates per CTA in hop.cuh's shared-memory table; 0 issues one global
// atomic an edge. Returns a CUDA error code (0 = success; the
// occupancy query's, or cudaGetLastError() after the launch). E must be > 0.
extern "C" int fragment_spmv_launch(const float* w, int n_src, const int32_t* src,
                                    const int32_t* dst, const float* m, int64_t E,
                                    float* y, int n_dst, int op, int table, void* stream) {
  Launch a{w, n_src, src, dst, E, y, n_dst, nullptr, 0, nullptr, 0, table ? 1 : 0,
           reinterpret_cast<cudaStream_t>(stream)};
  return dispatch(a, op, m);
}

// The block-skipping hop: one wave of CTAs over the device list
// block_idx[n_cap] and count n_active[1]; scan order when
// n_active > scan_above. E must be > 0.
extern "C" int fragment_spmv_active_launch(const float* w, int n_src, const int32_t* src,
                                           const int32_t* dst, const float* m, int64_t E,
                                           float* y, int n_dst, int op,
                                           const int32_t* block_idx, int n_cap,
                                           const int32_t* n_active, int scan_above,
                                           int table, void* stream) {
  Launch a{w, n_src, src, dst, E, y, n_dst, block_idx, n_cap, n_active, scan_above,
           table ? 1 : 0, reinterpret_cast<cudaStream_t>(stream)};
  return dispatch(a, op, m);
}
