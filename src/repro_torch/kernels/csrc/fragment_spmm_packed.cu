// fragment_spmm_packed: the decode-fused batched hop on Hopper, and its
// block-skipping variant fragment_spmm_packed_active.
//
//   Y[b, dst[e]] ⊕= W[b, src[e]] ⊗ m[e]   for every edge e and row b < B,
//   ⊕ ∈ {sum, min, max, bool}
//
// where dst is an int32 column or BCA words (dst_width bits a value) and the
// measure, shared by the rows, is absent (m_mode none: measure 1), a float32
// column (dense), BCA words whose integers are the measures (packed), or BCA
// words of indices into a float32 dictionary (dict) — the modes of
// fragment_spmv_packed.
//
// Replaces the TPU kernels repro/kernels/fragment_spmm.py::
// fragment_spmm_packed (_kernel_packed) and ::fragment_spmm_packed_active
// (_kernel_packed_active). There each 4096-edge block's words are DMA'd into
// VMEM and decoded once (bitunpack.decode_groups) for all B rows of the
// VMEM-resident W and Y: one decode serves the batch, which is that kernel's
// point.
//
// What bounds it: as for the dense SpMM (fragment_spmm.cu), the reductions
// into Y rather than the bytes — the packed streams as stored (22-bit dst
// over 4M documents: 2.75 bytes an edge instead of 4) read once for B rows,
// a gather of W[b, src] a row, and where a row is live its product into
// Y[b, dst]. The design keeps the reference's point: each thread decodes
// its edge's dst and measure in registers once (hop.cuh's PackedDst /
// PackedMeasure / DictMeasure over bca.cuh) for its CTA's rows, and runs
// hop.cuh's batched hop, the dense SpMM's body: a row-chunk-minor scratch
// whose rb = 8 rows of one destination share a sector (one vector
// reduction a 4 rows for sum), an epilogue into Y, a grid of row chunks ×
// edge CTAs, the batched per-CTA table with rb values a slot on an index
// with a hot destination (table = 1), and one wave of CTAs over the list
// for the active kernel; at B = 1 the single hop's kernels into Y (the
// packed SpMV's bodies); so packed and dense cannot drift. Offsets are
// int64. The dictionary is read through the read-only path (__ldg), as in
// the SpMV. A per-row measure stream is the dense SpMM's: the executor
// sends a batch-dependent measure there. This file allocates nothing and
// does not synchronise.

#include "hop.cuh"

namespace {

using namespace hop;

enum MMode { kNone = 0, kDense = 1, kPacked = 2, kDict = 3 };

template <int OP, class Dst, class M>
__global__ void fragment_spmm_packed_kernel(ChunkFrontier<OP> w,
                                            const int32_t* __restrict__ src, Dst dst, M m,
                                            int64_t E, RowChunks y, int table) {
  extern __shared__ float smem[];
  rows_scan<OP>(table ? smem : nullptr, w, src, dst, m, E, y);
}

template <int OP, class Dst, class M>
__global__ void fragment_spmm_packed_active_kernel(
    ChunkFrontier<OP> w, const int32_t* __restrict__ src, Dst dst, M m, int64_t E,
    RowChunks y, int table, const int32_t* __restrict__ block_idx, int n_cap,
    const int32_t* __restrict__ n_active, int scan_above) {
  extern __shared__ float smem[];
  rows_active<OP>(table ? smem : nullptr, w, src, dst, m, E, y, block_idx, n_cap,
                  n_active, scan_above);
}

// B = 1: the single hop's schedules into Y (the packed SpMV kernels' bodies).
template <int OP, class Dst, class M>
__global__ void fragment_spmm_packed_row_kernel(const float* __restrict__ w, int n_src,
                                                const int32_t* __restrict__ src, Dst dst, M m,
                                                int64_t E, float* __restrict__ y, int n_dst,
                                                int table) {
  if (!table) {
    scan<OP>(w, n_src, src, dst, m, E, y, n_dst);
    return;
  }
  extern __shared__ float smem[];
  scan_agg<OP>(smem, w, n_src, src, dst, m, E, y, n_dst);
}

template <int OP, class Dst, class M>
__global__ void fragment_spmm_packed_row_active_kernel(
    const float* __restrict__ w, int n_src, const int32_t* __restrict__ src, Dst dst, M m,
    int64_t E, float* __restrict__ y, int n_dst, int table,
    const int32_t* __restrict__ block_idx, int n_cap, const int32_t* __restrict__ n_active,
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
  RowsLaunch rows;
  const int32_t* block_idx;  // nullptr: the scan kernel
  int n_cap;
  const int32_t* n_active;
  int scan_above;
};

template <int OP, class Dst, class M>
int launch_row(const Launch& a, Dst dst, M m) {
  const RowsLaunch& r = a.rows;
  int grid = 0;
  size_t smem = 0;
  int err;
  if (a.block_idx == nullptr) {
    err = row_grid<fragment_spmm_packed_row_kernel<OP, Dst, M>>(r.E, r.table, false, &grid,
                                                                &smem);
    if (err) return err;
    fragment_spmm_packed_row_kernel<OP, Dst, M><<<grid, kThreads, smem, r.stream>>>(
        a.w, a.n_src, a.src, dst, m, r.E, r.y, r.n_dst, r.table);
  } else {
    err = row_grid<fragment_spmm_packed_row_active_kernel<OP, Dst, M>>(r.E, r.table, true,
                                                                       &grid, &smem);
    if (err) return err;
    fragment_spmm_packed_row_active_kernel<OP, Dst, M><<<grid, kThreads, smem, r.stream>>>(
        a.w, a.n_src, a.src, dst, m, r.E, r.y, r.n_dst, r.table, a.block_idx, a.n_cap,
        a.n_active, a.scan_above);
  }
  return (int)cudaGetLastError();
}

template <int OP, class Dst, class M>
int launch(const Launch& a, Dst dst, M m) {
  using Rows = SharedRows<M>;
  const RowsLaunch& r = a.rows;
  if (r.rb == 1) return launch_row<OP>(a, dst, m);
  const ChunkFrontier<OP> w{a.w, a.n_src};
  const RowChunks y{r.s, r.n_dst, r.B, r.rb};
  dim3 grid;
  size_t smem = 0;
  int err;
  if (a.block_idx == nullptr) {
    err = rows_grid<fragment_spmm_packed_kernel<OP, Dst, Rows>>(r, &grid, &smem);
    if (err) return err;
    fragment_spmm_packed_kernel<OP, Dst, Rows><<<grid, kThreads, smem, r.stream>>>(
        w, a.src, dst, Rows{m}, r.E, y, r.table);
  } else {
    err = rows_grid<fragment_spmm_packed_active_kernel<OP, Dst, Rows>>(r, &grid, &smem);
    if (err) return err;
    fragment_spmm_packed_active_kernel<OP, Dst, Rows><<<grid, kThreads, smem, r.stream>>>(
        w, a.src, dst, Rows{m}, r.E, y, r.table, a.block_idx, a.n_cap, a.n_active,
        a.scan_above);
  }
  err = (int)cudaGetLastError();
  return err ? err : rows_epilogue(r);
}

template <class Dst, class M>
int by_op(int op, const Launch& a, Dst dst, M m) {
  switch (op) {
    case kSum: return launch<kSum>(a, dst, m);
    case kMin: return launch<kMin>(a, dst, m);
    case kMax: return launch<kMax>(a, dst, m);
    case kBool: return launch<kBool>(a, dst, m);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Dst>
int by_measure(int op, const Launch& a, Dst dst, int m_mode, const void* m, int m_width,
               int64_t m_words, const float* mdict, int n_dict) {
  const uint32_t* mw = static_cast<const uint32_t*>(m);
  switch (m_mode) {
    case kNone: return by_op(op, a, dst, NoMeasure{});
    case kDense: return by_op(op, a, dst, DenseMeasure{static_cast<const float*>(m)});
    case kPacked: return by_op(op, a, dst, PackedMeasure{mw, m_words, m_width});
    case kDict: return by_op(op, a, dst, DictMeasure{mw, m_words, m_width, mdict, n_dict});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One decode-fused batched hop on `stream`. W is float32[B, n_src],
// row-major. s is the scratch float32[ceil(B / rb), n_dst, rb], already
// holding the ⊕-identity, rb ∈ {1, 2, 4, 8}; y is Y float32[B, n_dst],
// written whole by the epilogue (at rb = 1, B = 1 and s is y, which the
// single hop's kernels take). dst: int32[E] when
// dst_width == 0, else dst_words uint32 words. m: per m_mode (0 none, 1
// dense float32[E], 2 packed words, 3 dict words with mdict[n_dict]), shared
// by the rows. With block_idx == nullptr the scan kernel runs; otherwise the
// block-skipping kernel over block_idx[n_cap] and n_active[1] (scan order
// when n_active > scan_above). table != 0 aggregates per CTA in hop.cuh's
// batched table. Returns a CUDA error code (cudaGetLastError() after the
// launches). E and B must be > 0.
extern "C" int fragment_spmm_packed_launch(
    const float* w, int n_src, int B, const int32_t* src, int64_t E, const void* dst,
    int dst_width, int64_t dst_words, int m_mode, const void* m, int m_width, int64_t m_words,
    const float* mdict, int n_dict, float* y, int n_dst, int op, const int32_t* block_idx,
    int n_cap, const int32_t* n_active, int scan_above, float* s, int rb, int table,
    void* stream) {
  if ((rb != 1 && rb != 2 && rb != 4 && rb != 8) || (rb == 1 && B != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Launch a{w, n_src, src,
           RowsLaunch{E, B, rb, n_dst, s, y, table ? 1 : 0, block_idx != nullptr,
                      reinterpret_cast<cudaStream_t>(stream)},
           block_idx, n_cap, n_active, scan_above};
  if (dst_width > 0) {
    PackedDst d{static_cast<const uint32_t*>(dst), dst_words, dst_width};
    return by_measure(op, a, d, m_mode, m, m_width, m_words, mdict, n_dict);
  }
  DenseDst d{static_cast<const int32_t*>(dst)};
  return by_measure(op, a, d, m_mode, m, m_width, m_words, mdict, n_dict);
}
