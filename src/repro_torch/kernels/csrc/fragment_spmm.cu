// fragment_spmm: the batched hop of the frontier strategy (the multi-query
// SpMM) on Hopper, over dense (int32 dst, float32 measure) columns, and its
// block-skipping variant fragment_spmm_active.
//
//   Y[b, dst[e]] ⊕= W[b, src[e]] ⊗ m_b[e]   for every edge e and row b < B,
//   ⊕ ∈ {sum, min, max, bool}
//
// Replaces the TPU kernels repro/kernels/fragment_spmm.py::fragment_spmm
// (_kernel, _edge_product_batched, _segment_combine_batched) and
// ::fragment_spmm_active (_kernel_active). There W[B, n_src] and Y[B, n_dst]
// sit in VMEM for the whole pass and each 4096-edge block is DMA'd once and
// applied to all B rows; the active grid walks the union of the rows' block
// lists from SMEM. On Hopper Y does not fit any on-chip store at the main
// path's sizes (B = 8 over 4M documents is 128 MB), so it lives in global
// memory and takes atomics, as in the SpMV.
//
// What bounds it on the H100: not the bytes (12 bytes an edge of stream read
// once for B rows, 4·B·(n_src + n_dst) of frontier and output) but the
// reductions into Y. Y[B, n_dst] is 128 MB at B = 8 over 4M documents, 2.6x
// the L2, and one float atomic an edge a row to lines 16 MB apart missed L2
// on every one (9.06 ms on I_DT.Term at B = 8, where the card's rate of
// distinct-address reductions alone gives 2.58 ms; PERF.md); on
// I_DA.Doc the atomics also serialised on the hot authors. The design (the
// body is hop.cuh's batched hop, which says more):
//   * a row-chunk-minor scratch S[ceil(B / rb), n_dst, rb] (rb = 8 rows, a
//     32-byte sector; 2 or 4 below 5 rows): an edge's rb products reach one
//     sector, for sum as one red.global.add.v4.f32 a 4 rows; an epilogue
//     kernel writes Y from S through shared memory;
//   * at B = 1 Y is the scratch and the single hop's kernels run (hop.cuh's
//     scan / scan_agg, active / active_agg over one row), as fast as the
//     SpMV (the row-chunk body at one row was 3-28% slower, PERF.md);
//   * a grid of (row chunks) × (edge CTAs), the chunk fastest, so the CTAs
//     of one edge range run together and the chunks after the first read
//     the edge stream from L2; a thread reads src, the chunk's weights and
//     the measure once for its rb rows;
//   * on an index with a hot destination (table = 1, from kernels/ops.py
//     uses_table) a per-CTA table in shared memory with rb values a slot
//     combines the chunk's products per destination, flushed once per CTA;
//   * the active kernel runs one wave of CTAs over the union of the rows'
//     block lists, whichever form;
//   * rows whose weight is the identity cost a gather and no write;
//   * the measure takes a row stride: 0 means one shared [E] column, E a
//     per-row [B, E] stream (a measure that depends on the row's parameters
//     or seed scalars), read per row; one kernel serves both;
//   * row and chunk offsets are int64 (B·n_dst passes 2^31 at B = 640 over
//     4M documents).
// This file allocates nothing and does not synchronise.

#include "hop.cuh"

namespace {

using namespace hop;

template <int OP, class M>
__global__ void fragment_spmm_kernel(ChunkFrontier<OP> w, const int32_t* __restrict__ src,
                                     DenseDst dst, M m, int64_t E, RowChunks y,
                                     int table) {
  extern __shared__ float smem[];
  rows_scan<OP>(table ? smem : nullptr, w, src, dst, m, E, y);
}

template <int OP, class M>
__global__ void fragment_spmm_active_kernel(ChunkFrontier<OP> w,
                                            const int32_t* __restrict__ src, DenseDst dst,
                                            M m, int64_t E, RowChunks y, int table,
                                            const int32_t* __restrict__ block_idx,
                                            int n_cap, const int32_t* __restrict__ n_active,
                                            int scan_above) {
  extern __shared__ float smem[];
  rows_active<OP>(table ? smem : nullptr, w, src, dst, m, E, y, block_idx, n_cap,
                  n_active, scan_above);
}

// B = 1: the single hop's schedules into Y (the SpMV kernels' bodies).
template <int OP, class M>
__global__ void fragment_spmm_row_kernel(const float* __restrict__ w, int n_src,
                                         const int32_t* __restrict__ src, DenseDst dst, M m,
                                         int64_t E, float* __restrict__ y, int n_dst,
                                         int table) {
  if (!table) {
    scan<OP>(w, n_src, src, dst, m, E, y, n_dst);
    return;
  }
  extern __shared__ float smem[];
  scan_agg<OP>(smem, w, n_src, src, dst, m, E, y, n_dst);
}

template <int OP, class M>
__global__ void fragment_spmm_row_active_kernel(const float* __restrict__ w, int n_src,
                                                const int32_t* __restrict__ src, DenseDst dst,
                                                M m, int64_t E, float* __restrict__ y,
                                                int n_dst, int table,
                                                const int32_t* __restrict__ block_idx,
                                                int n_cap, const int32_t* __restrict__ n_active,
                                                int scan_above) {
  if (!table) {
    active<OP>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active, scan_above);
    return;
  }
  extern __shared__ float smem[];
  active_agg<OP>(smem, w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active,
                 scan_above);
}

struct Launch {
  const float* w;
  int n_src;
  const int32_t* src;
  DenseDst dst;
  RowsLaunch rows;
  const int32_t* block_idx;  // nullptr: the scan kernel
  int n_cap;
  const int32_t* n_active;
  int scan_above;
};

template <int OP, class M>
int launch_row(const Launch& a, M m) {
  const RowsLaunch& r = a.rows;
  int grid = 0;
  size_t smem = 0;
  int err;
  if (a.block_idx == nullptr) {
    err = row_grid<fragment_spmm_row_kernel<OP, M>>(r.E, r.table, false, &grid, &smem);
    if (err) return err;
    fragment_spmm_row_kernel<OP, M><<<grid, kThreads, smem, r.stream>>>(
        a.w, a.n_src, a.src, a.dst, m, r.E, r.y, r.n_dst, r.table);
  } else {
    err = row_grid<fragment_spmm_row_active_kernel<OP, M>>(r.E, r.table, true, &grid, &smem);
    if (err) return err;
    fragment_spmm_row_active_kernel<OP, M><<<grid, kThreads, smem, r.stream>>>(
        a.w, a.n_src, a.src, a.dst, m, r.E, r.y, r.n_dst, r.table, a.block_idx, a.n_cap,
        a.n_active, a.scan_above);
  }
  return (int)cudaGetLastError();
}

template <int OP, class M>
int launch(const Launch& a, M m) {
  const RowsLaunch& r = a.rows;
  const ChunkFrontier<OP> w{a.w, a.n_src};
  const RowChunks y{r.s, r.n_dst, r.B, r.rb};
  dim3 grid;
  size_t smem = 0;
  int err;
  if (a.block_idx == nullptr) {
    err = rows_grid<fragment_spmm_kernel<OP, M>>(r, &grid, &smem);
    if (err) return err;
    fragment_spmm_kernel<OP, M><<<grid, kThreads, smem, r.stream>>>(w, a.src, a.dst, m, r.E,
                                                                    y, r.table);
  } else {
    err = rows_grid<fragment_spmm_active_kernel<OP, M>>(r, &grid, &smem);
    if (err) return err;
    fragment_spmm_active_kernel<OP, M><<<grid, kThreads, smem, r.stream>>>(
        w, a.src, a.dst, m, r.E, y, r.table, a.block_idx, a.n_cap, a.n_active, a.scan_above);
  }
  err = (int)cudaGetLastError();
  return err ? err : rows_epilogue(r);
}

template <class M>
int by_op(int op, const Launch& a, M m) {
  switch (op) {
    case kSum: return launch<kSum>(a, m);
    case kMin: return launch<kMin>(a, m);
    case kMax: return launch<kMax>(a, m);
    case kBool: return launch<kBool>(a, m);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class M>
int by_op_row(int op, const Launch& a, M m) {
  switch (op) {
    case kSum: return launch_row<kSum>(a, m);
    case kMin: return launch_row<kMin>(a, m);
    case kMax: return launch_row<kMax>(a, m);
    case kBool: return launch_row<kBool>(a, m);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch one batched hop on `stream`. W is float32[B, n_src], row-major. s
// is the scratch float32[ceil(B / rb), n_dst, rb], already holding the
// ⊕-identity, rb ∈ {1, 2, 4, 8}; y is Y float32[B, n_dst], written whole by
// the epilogue (at rb = 1, B = 1 and s is y, which the single hop's
// kernels take). m: nullptr (measure 1), or float32 with
// row stride m_stride (0: one [E] column for every row; E: a [B, E]
// stream). With block_idx == nullptr the scan kernel runs; otherwise the
// block-skipping kernel over block_idx[n_cap] and n_active[1] (scan order
// when n_active > scan_above). table != 0 aggregates per CTA in hop.cuh's
// batched table. Returns a CUDA error code (cudaGetLastError() after the
// launches). E and B must be > 0.
extern "C" int fragment_spmm_launch(const float* w, int n_src, int B, const int32_t* src,
                                    const int32_t* dst, const float* m, int64_t m_stride,
                                    int64_t E, float* y, int n_dst, int op,
                                    const int32_t* block_idx, int n_cap,
                                    const int32_t* n_active, int scan_above, float* s, int rb,
                                    int table, void* stream) {
  if ((rb != 1 && rb != 2 && rb != 4 && rb != 8) || (rb == 1 && B != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Launch a{w, n_src, src, DenseDst{dst},
           RowsLaunch{E, B, rb, n_dst, s, y, table ? 1 : 0, block_idx != nullptr,
                      reinterpret_cast<cudaStream_t>(stream)},
           block_idx, n_cap, n_active, scan_above};
  if (rb == 1) {  // row 0 of a per-row stream is m[e]
    return m == nullptr ? by_op_row(op, a, NoMeasure{}) : by_op_row(op, a, DenseMeasure{m});
  }
  if (m == nullptr) return by_op(op, a, SharedRows<NoMeasure>{NoMeasure{}});
  if (m_stride == 0) return by_op(op, a, SharedRows<DenseMeasure>{DenseMeasure{m}});
  return by_op(op, a, PerRowMeasure{m, m_stride});
}
