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
// What bounds it: bytes once more, but the edge stream is read once for B
// rows: 12 bytes an edge of stream plus, per row, a 4-byte gather of
// W[b, src] and an atomic where the row's product is not the identity. The
// design (the body is hop.cuh's edge_rows):
//   * one thread per edge, in a grid-stride loop (scan) or one CTA per
//     listed 4096-edge block (active); the thread reads src, dst and the
//     shared measure once and loops over the B rows, so the stream is not
//     re-read per row as a loop of SpMV launches would;
//   * rows whose weight is the identity cost one gather and no write, so a
//     batch of sparse frontiers pays atomics only where a row is live;
//   * W[b, src] is gathered through the read-only path; edges are sorted by
//     src, so a warp's 32 gathers of one row hit a few lines;
//   * the measure takes a row stride: 0 means one shared [E] column, E a
//     per-row [B, E] stream (a measure that depends on the row's parameters
//     or seed scalars), read per row; one kernel serves both;
//   * row offsets b·n_src and b·n_dst are int64 (B·n_dst passes 2^31 at
//     B = 640 over 4M documents).
// Simple rather than fast: a warp per edge over an [n_src, B]-major frontier
// would coalesce the row loop; that is later work. This file allocates
// nothing and does not synchronise.

#include "hop.cuh"

namespace {

using namespace hop;

template <int OP, class M>
__global__ void fragment_spmm_kernel(FrontierRows<OP> w, const int32_t* __restrict__ src,
                                     DenseDst dst, M m, int64_t E, float* __restrict__ y,
                                     int n_dst, int B) {
  scan_rows<OP>(w, src, dst, m, E, y, n_dst, B);
}

template <int OP, class M>
__global__ void fragment_spmm_active_kernel(FrontierRows<OP> w,
                                            const int32_t* __restrict__ src, DenseDst dst,
                                            M m, int64_t E, float* __restrict__ y, int n_dst,
                                            int B, const int32_t* __restrict__ block_idx,
                                            int n_cap, const int32_t* __restrict__ n_active,
                                            int scan_above) {
  active_rows<OP>(w, src, dst, m, E, y, n_dst, B, block_idx, n_cap, n_active, scan_above);
}

struct Launch {
  const float* w;
  int n_src;
  int B;
  const int32_t* src;
  DenseDst dst;
  int64_t E;
  float* y;
  int n_dst;
  const int32_t* block_idx;  // nullptr: the scan kernel
  int n_cap;
  const int32_t* n_active;
  int scan_above;
  cudaStream_t s;
};

template <int OP, class M>
void launch(const Launch& a, M m) {
  FrontierRows<OP> w{a.w, a.n_src};
  if (a.block_idx == nullptr) {
    fragment_spmm_kernel<OP, M><<<scan_grid(a.E), kThreads, 0, a.s>>>(w, a.src, a.dst, m, a.E,
                                                                      a.y, a.n_dst, a.B);
  } else {
    fragment_spmm_active_kernel<OP, M><<<(int)n_edge_blocks(a.E), kThreads, 0, a.s>>>(
        w, a.src, a.dst, m, a.E, a.y, a.n_dst, a.B, a.block_idx, a.n_cap, a.n_active,
        a.scan_above);
  }
}

template <class M>
int by_op(int op, const Launch& a, M m) {
  switch (op) {
    case kSum: launch<kSum>(a, m); break;
    case kMin: launch<kMin>(a, m); break;
    case kMax: launch<kMax>(a, m); break;
    case kBool: launch<kBool>(a, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one batched hop on `stream`. W is float32[B, n_src] and Y
// float32[B, n_dst], row-major; Y must already hold the ⊕-identity. m:
// nullptr (measure 1), or float32 with row stride m_stride (0: one [E]
// column for every row; E: a [B, E] stream). With block_idx == nullptr the
// scan kernel runs; otherwise the block-skipping kernel over block_idx[n_cap]
// and n_active[1] (scan order when n_active > scan_above). Returns
// cudaGetLastError() after the launch. E and B must be > 0.
extern "C" int fragment_spmm_launch(const float* w, int n_src, int B, const int32_t* src,
                                    const int32_t* dst, const float* m, int64_t m_stride,
                                    int64_t E, float* y, int n_dst, int op,
                                    const int32_t* block_idx, int n_cap,
                                    const int32_t* n_active, int scan_above, void* stream) {
  Launch a{w, n_src, B, src, DenseDst{dst}, E, y, n_dst, block_idx, n_cap, n_active,
           scan_above, reinterpret_cast<cudaStream_t>(stream)};
  if (m == nullptr) return by_op(op, a, SharedRows<NoMeasure>{NoMeasure{}});
  if (m_stride == 0) return by_op(op, a, SharedRows<DenseMeasure>{DenseMeasure{m}});
  return by_op(op, a, PerRowMeasure{m, m_stride});
}
